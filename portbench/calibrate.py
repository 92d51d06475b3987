"""Readings that the limits of ``checks.py`` are set from, on the card.

    python3 portbench/calibrate.py --workload semantic3d.train \
        --seeds 1,2,3 --seconds 2 [--faults 3] [--float64 3] \
        > readings.jsonl

For each seed, in one process: a run of the cell with a short window (the
program's numbers), then the control, the reference in TF32 put in the
program's place at the cell's own size on the same inputs, and, with
``--faults N``, on the first N seeds of a training cell, its faults
planted in the program: a step that leaves the state unchanged and a step
whose loss leaves out half of the batch. With ``--float64 N``, on the
first N seeds of a training cell, the look at rounding: the checked steps
followed again with the reference in float64, and the numbers of the
program and of the float32 reference each held against it, with their
widest leaves. One JSON line a seed and reading. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def control(cell, seed: int, device, mm: str = "tf32") -> dict:
    """The numbers of a run of ``seed`` with the reference in ``mm`` in the
    program's place, on the run's own inputs and weights: its sampled
    requests, or its checked steps."""
    from portbench import checks, harness

    cfg, mix = cell.cfg, cell.mix
    W = harness.make_weights(cell.ref.param_spec(cfg),
                             harness.subseed(seed, 0), device)
    pool = harness.make_pool(cfg, mix, seed, device)
    if cell.loop.KIND == "serve":
        picked = harness.checked_entries(seed, len(pool),
                                         mix["checked_requests"])
        return checks.serve_control(
            cell, W, [(pool[p][0], pool[p][1], pool[p][3]) for p in picked],
            device, mm)
    steps = [(p, x, y, offs, harness.subseed(seed, 100 + t))
             for t, (p, x, y, offs) in enumerate(pool[:mix["checked_steps"]])]
    return checks.train_control(cell, W, steps, device, mm)


def widest_leaves(got: dict, want: dict, k: int = 3) -> dict:
    """The ``k`` widest leaf gaps of each leaf number, by leaf name."""
    from portbench import checks

    names = checks.compared_leaves(want)
    out = {}
    for key in ("first_grad", "change"):
        gaps = checks.leaf_gaps(got[key], want[key], names)
        out[key] = {n: gaps[n] for n in
                    sorted(gaps, key=gaps.get, reverse=True)[:k]}
    return out


def look_float64(cell, seed: int, program: dict, device) -> dict:
    """The program's checked steps and the float32 reference's, each
    against the reference in float64 on the same pyramid and inputs: which
    side a leaf's gap comes from."""
    import torch

    from portbench import checks, harness
    from portbench.reference.train import follow

    cfg = cell.cfg
    W = harness.make_weights(cell.ref.param_spec(cfg),
                             harness.subseed(seed, 0), device)
    pool = harness.make_pool(cfg, cell.mix, seed, device)
    steps = [(p, x, y, offs, harness.subseed(seed, 100 + t))
             for t, (p, x, y, offs)
             in enumerate(pool[:cell.mix["checked_steps"]])]
    spec = cell.ref.param_spec(cfg)
    harness.free(device)
    harness.reset_peak(device)
    ref32 = follow(cell.ref, W, spec, checks.step_inputs(steps, device), cfg)
    peak32 = harness.peak_bytes(device)
    harness.free(device)
    harness.reset_peak(device)
    try:
        ref64 = follow(cell.ref, W, spec, checks.step_inputs(steps, device),
                       cfg, mm="float64")
    except torch.cuda.OutOfMemoryError:
        return {"oom": True, "peak_gib_float32": peak32 / harness.GIB}
    return {"peak_gib_float32": peak32 / harness.GIB,
            "peak_gib_float64": harness.peak_bytes(device) / harness.GIB,
            "program_vs_float64": checks.train_compare(program, ref64),
            "float32_vs_float64": checks.train_compare(ref32, ref64),
            "program_vs_float32": checks.train_compare(program, ref32),
            "leaves_program_vs_float64": widest_leaves(program, ref64),
            "leaves_float32_vs_float64": widest_leaves(ref32, ref64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", type=int, default=0,
                    help="plant the training faults on the first N seeds")
    ap.add_argument("--float64", type=int, default=0,
                    help="the look at rounding on the first N seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults, harness

    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    harness.set_precision(cell.cfg)
    dev = args.device
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        _, out = harness.measure(args.workload, seed, args.seconds, False,
                                 dev)
        line = {"seed": seed, "reading": "program", "numbers": out["checks"],
                "metrics": out["e2e"],
                "s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        t = time.perf_counter()
        ctl = control(cell, seed, dev)
        print(json.dumps({"seed": seed, "reading": "control_tf32",
                          "numbers": ctl, "s": time.perf_counter() - t}),
              flush=True)
        train = cell.loop.KIND == "train"
        if i < args.float64 and train:
            t = time.perf_counter()
            line = look_float64(cell, seed, out["program"], dev)
            print(json.dumps({"seed": seed, "reading": "float64", **line,
                              "s": time.perf_counter() - t}), flush=True)
        if i < args.faults and train:
            for name in faults.TRAIN:
                t = time.perf_counter()
                with faults.planted(name, cell.loop.KIND):
                    _, out = harness.measure(args.workload, seed, 0.5, False,
                                             dev)
                print(json.dumps({
                    "seed": seed, "reading": "fault_" + name,
                    "numbers": out["checks"],
                    "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""In-call A/B runs of K4's routes and register cap and of K9's loops, on
the calls that the main path makes.

K4 (``crfconv_tpu_torch/csrc/crf_sim.cu``) takes its TABLE route at every K
the main path gives it, at H 32 with at most 64 registers a thread (four
blocks an SM). Against it: ``direct``, the same source with TABLE turned
off, so the same calls take the DIRECT route; ``h32_regs_any`` and
``h32_regs_40``, H 32 with no register cap (one block an SM assured) and
with 40 (six blocks). K9
(``csrc/crf_operator.cu``): ``int4`` is the source as it stands (16-byte
loads and stores of a tile's run of slots, a scalar head up to the first
16-byte boundary and a scalar tail); ``scalar`` takes the run in one
coalesced loop of 4-byte loads and stores instead.

The calls are recorded by driving ``chip_smoke.py``'s flagship and
Semantic3D requests (K4) and its ScanNet and discrete requests (K9) once,
on random weights from its seed. Each variant is a library of its own,
built from the checkout's source with the textual changes listed in
``VARIANTS`` (each asserted to apply once) into
``crfconv_tpu_torch/_build/ab/``. Per call shape the script times the
source as it stands (A) against each variant (B) in turns A, B, B, A, A,
B, B, A, each turn the device ms a call
(``chip_smoke.py::device_ms``: torch.profiler over five runs), and holds
B's outputs against A's: K9 bit-equal, K4 within rtol 1e-4 and atol 1e-5.
It prints one line a call shape and writes ``chiprun_out/ab_k4_k9.json``;
it exits 1 if an output disagrees or a launch fails.

    python3 tools/ab_k4_k9.py      # on one CUDA card
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

_SCALAR_BODY = """\
  for (int e = threadIdx.x; e < len; e += OP_THREADS)
    cb[e] = clamp(ib[e]);
"""
_INT4_BODY = """\
  const int head =
      ((uintptr_t)ib & 15) == ((uintptr_t)cb & 15)
          ? min(len, (int)((16 - ((uintptr_t)ib & 15)) & 15) / 4)
          : len;
  const int quads = (len - head) / 4;
  const int4* iq = reinterpret_cast<const int4*>(ib + head);
  int4* cqd = reinterpret_cast<int4*>(cb + head);
  for (int q = threadIdx.x; q < quads; q += OP_THREADS) {
    const int4 v = __ldg(iq + q);
    cqd[q] = make_int4(clamp(v.x), clamp(v.y), clamp(v.z), clamp(v.w));
  }
  for (int e = threadIdx.x; e < head; e += OP_THREADS) cb[e] = clamp(ib[e]);
  for (int e = head + 4 * quads + threadIdx.x; e < len; e += OP_THREADS)
    cb[e] = clamp(ib[e]);
"""

# kernel -> (source, entry, label A, [(label B, changes), ...]); a change is
# (old, new), old found exactly once in the source
_H32_REGS = "__launch_bounds__(SIM_THREADS, HP < 32 ? 8 : 4)"
VARIANTS = {
    "crf_similarity_message": (
        "crf_sim.cu", "crf_similarity_message_f32", "table", [
            ("direct", (("  if (a.k <= SIM_TABLE_MAX_K)", "  if (false)"),)),
            ("h32_regs_any", ((_H32_REGS, _H32_REGS.replace("4)", "1)")),)),
            ("h32_regs_40", ((_H32_REGS, _H32_REGS.replace("4)", "6)")),)),
        ],
    ),
    "crf_operator": (
        "crf_operator.cu", "crf_operator_i32", "int4", [
            ("scalar", ((_INT4_BODY, _SCALAR_BODY),)),
        ],
    ),
}
TURNS = "ABBAABBA"


def build_variants(out_dir: Path) -> dict:
    """Build every variant's library, one nvcc each, all started together;
    returns {(kernel, label): ctypes entry point}."""
    from crfconv_tpu_torch import cuda_build

    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, (source, entry, base, variants) in VARIANTS.items():
        text = (cuda_build.CSRC / source).read_text()
        for label, changes in [(base, ())] + variants:
            src = text
            for old, new in changes:
                assert src.count(old) == 1, f"{source}: {old!r} not found once"
                src = src.replace(old, new)
            cu = out_dir / f"{Path(source).stem}_{label}.cu"
            cu.write_text(src)
            so = cu.with_suffix(".so")
            cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                   "-I", str(cuda_build.CSRC), "-o", str(so), str(cu)]
            jobs.append((name, label, entry, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for name, label, entry, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        fns[name, label] = fn
    return fns


def record(dev) -> dict:
    """{kernel: [(args, kwargs), ...]}: K4's calls of a flagship and a
    Semantic3D request, K9's of a ScanNet and a discrete request."""
    import chip_smoke as cs
    from crfconv_tpu_torch import PointConvResNet, Predictor
    from crfconv_tpu_torch.train.config import Semantic3DConfig

    rng = np.random.default_rng(cs.SEED)
    k4 = {"crf_similarity_message":
          cs.call_sites()["crf_similarity_message"]}
    calls = {"crf_similarity_message": [], "crf_operator": []}

    def run(sites, model, fn, *inputs):
        predictor = Predictor(model, device=dev, seed=cs.SEED)
        got = cs.record_calls(sites, lambda: fn(predictor, *inputs))
        for name, c in got.items():
            calls[name] += c
        torch.cuda.synchronize()

    def predict(predictor, pos, feats):
        return predictor.predict_logits(pos, feats)

    run(k4, cs.make_model(dev), predict, *cs.request(rng, dev))
    cfg = Semantic3DConfig()
    gen = torch.Generator().manual_seed(cs.SEED + 13)
    model = cs.randomize_batch_norms(PointConvResNet(
        cfg.num_classes, cfg.in_channels, use_crf=True, steps=cfg.steps,
        device=dev, generator=gen), gen)
    b, n = cfg.batch_size, cfg.sample_num
    pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32), device=dev)
    feats = torch.as_tensor(
        rng.random((b, n, cfg.in_channels), dtype=np.float32), device=dev)
    run(k4, model, predict, pos, feats)
    del model, pos, feats
    cfg = cs.scannet_config()
    k9 = {"crf_operator": cs.crf_call_sites()["crf_operator"]}
    run(k9, cs.scannet_model(cfg, dev), predict,
        *cs.scannet_cloud(cfg, rng, dev))
    k9 = {"crf_operator": cs.discrete_call_sites()["crf_operator"]}
    run(k9, cs.discrete_model(cfg, dev), cs.serve_last_head,
        *cs.scannet_cloud(cfg, rng, dev))
    torch.cuda.empty_cache()
    return calls


def packed_calls(name, calls) -> list:
    """Each call's packed arguments as its wrapper passes them to the
    kernel, with the wrapper's outputs (which they point to) kept."""
    from crfconv_tpu_torch.ops import crf_core, crf_sim

    module = crf_sim if name == "crf_similarity_message" else crf_core
    wrapper = getattr(module, name)
    got = []

    def capture(device, kernel, packed):
        got.append(packed)
        kernel(packed)

    saved = module.launch_on
    module.launch_on = capture
    try:
        outs = [wrapper(*a, **k) for a, k in calls]
    finally:
        module.launch_on = saved
    return list(zip(got, outs))


def launch(fn, packed) -> None:
    rc = fn(packed)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from crfconv_tpu_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = cs.smi_line()
    print(card, flush=True)
    cuda_build.build()
    fns = build_variants(cuda_build.BUILD_DIR / "ab")
    with torch.inference_mode():
        calls = record(dev)
    ok = True
    report = {"card": card, "turns": TURNS, "kernels": {}}
    for name, recorded in calls.items():
        _, _, la, variants = VARIANTS[name]
        key_of, label_of, rows_of = cs.WIDTHS[name]
        groups = {}
        for a, k in recorded:
            groups.setdefault(key_of(a), []).append((a, k))
        rows = []
        for (key, group), (lb, _) in [(g, v) for g in sorted(groups.items())
                                      for v in variants]:
            with torch.inference_mode():
                pc = packed_calls(name, group)
            bound = sum(cs.bound_of(name, a, out)[0]
                        for (a, _), (_, out) in zip(group, pc))
            # B's outputs against A's, on the same buffers
            outs = {}
            for label in (la, lb):
                for packed, _ in pc:
                    launch(fns[name, label], packed)
                torch.cuda.synchronize()
                outs[label] = [tuple(t.clone() for t in (
                    o if isinstance(o, tuple) else (o,))) for _, o in pc]
            err, equal = 0.0, True
            for ta, tb in zip(outs[la], outs[lb]):
                for x, y in zip(ta, tb):
                    equal &= bool(torch.equal(x, y))
                    if x.dtype.is_floating_point:
                        err = max(err, float((x - y).abs().max()))
                        ok &= bool(torch.allclose(y, x, rtol=1e-4,
                                                  atol=1e-5))
            if name == "crf_operator":
                ok &= equal
            del outs
            ms = {la: [], lb: []}
            for turn in TURNS:
                label = la if turn == "A" else lb
                fn = fns[name, label]
                ms[label].append(cs.device_ms(
                    lambda: [launch(fn, p) for p, _ in pc])[0])
            mean = {v: statistics.mean(t) for v, t in ms.items()}
            row = {"group": label_of(key), "calls": len(group),
                   "rows": int(rows_of(group[0][0])), "bound_ms": bound,
                   "device_ms": ms, "mean_ms": mean,
                   "spread_ms": {v: max(t) - min(t) for v, t in ms.items()},
                   "b_over_a": mean[lb] / mean[la],
                   "bit_equal": equal, "max_abs_err": err}
            row["b"] = lb
            rows.append(row)
            print(f"# {name} {row['group']} x{len(group)}: {la} "
                  f"{[round(t, 5) for t in ms[la]]}, {lb} "
                  f"{[round(t, 5) for t in ms[lb]]} device ms; {lb}/{la} "
                  f"{row['b_over_a']:.3f}; bound {bound:.5f}; bit-equal "
                  f"{equal}, max |err| {err:.3g}", flush=True)
            del pc
        report["kernels"][name] = {"a": la, "calls": rows}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_k4_k9.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

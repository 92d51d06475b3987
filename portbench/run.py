"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload semantic3d.serve --seed 7 \
        --seconds 20 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared with its limit,
which also end standard error). Exits non-zero, printing no result, where
there is no CUDA device (or fewer than the cell asks for), or where JAX or
the JAX package was loaded by the time the window closed. The port's
kernel libraries are built by nvcc into ``crfconv_tpu_torch/_build/`` on
a checkout's first run; CUDA's JIT cache is kept in
``.portbench_cache/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA "
              "device(s); none or too few found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    from portbench import harness

    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print("loaded after the window: " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    for name, n in res["checks"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

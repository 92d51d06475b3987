#!/usr/bin/env python3
"""Rerun the inputs of tests/test_torch_cuda.py's
``test_crf_similarity_small_and_unaligned[4096]`` and hold K4 and its plain
version against float64.

    python3 tools/k4_rerun_probe.py [trials] [out.json]

Each trial draws the test's inputs (n 4096, B 2, K 15, H 8, 16 and 32,
y and z one float off 16-byte alignment) from a card generator seeded with
the trial's number, and runs the test's check (K4 against its float32
plain version, rtol 1e-4 and atol 1e-5 on msg and s). Every call is also
held against the plain version evaluated in float64: where the check
fails, K4's error and the float32 plain version's are put side by side,
to tell a kernel fault (K4 alone far from float64) from two float32
roundings that part by more than the check allows: on the failing calls,
the median and largest ratio of K4's error to the plain version's. The
test's current msg check, K4 against float64 within
``tests/test_torch_cuda.py::msg_error_bound``, is counted beside it
(``bound_failed_calls``, and the largest error over the bound of K4 and of
the plain version).
Prints one JSON object (and writes it to ``out.json`` where given).
Needs an NVIDIA GPU.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from crfconv_tpu_torch import cuda_build  # noqa: E402
from crfconv_tpu_torch.ops import crf_sim  # noqa: E402

N, K = 4096, 15


def _test_module():
    """tests/test_torch_cuda.py, loaded by its path (a ``tests`` package
    installed elsewhere may shadow the repository's directory)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tests", "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("test_torch_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b, rtol, atol) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _inputs(gen, h, dev):
    buf = torch.randn(2 * (2 * N * h + 1), device=dev, generator=gen)
    y = buf[1:2 * N * h + 1].view(2, N, h)
    z = buf[2 * N * h + 2:].view(2, N, h)
    return y, z


def main(trials: int = 200, out: str = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cuda_build.build([cuda_build.CRF_SIMILARITY_MESSAGE])
    rng = np.random.default_rng(100 + N)       # the test's indices
    idx = torch.as_tensor(
        np.arange(N)[None, :, None] + rng.integers(-40, 40, (2, N, K)),
        dtype=torch.int32, device=dev)
    msg_error_bound = _test_module().msg_error_bound
    failed, worst, over_bound = [], {}, {}
    calls = bound_failed = 0
    for trial in range(trials):
        gen = torch.Generator(device=dev).manual_seed(trial)
        for h in (8, 16, 32):
            y, z = _inputs(gen, h, dev)
            msg, s = crf_sim.crf_similarity_message(y, z, idx)
            msg_p, s_p = crf_sim.crf_similarity_message_plain(y, z, idx)
            msg_d, s_d = crf_sim.crf_similarity_message_plain(
                y.double(), z.double(), idx)
            calls += 1
            bound = msg_error_bound(y, z, idx)
            over = {"kernel": float(((msg.double() - msg_d).abs()
                                     / bound).max()),
                    "plain": float(((msg_p.double() - msg_d).abs()
                                    / bound).max())}
            bound_failed += over["kernel"] > 1
            for k_, v in over.items():
                over_bound[k_] = max(over_bound.get(k_, 0.0), v)
            errs = {
                "msg_kernel_vs_f64": _gap(msg, msg_d),
                "msg_plain_vs_f64": _gap(msg_p, msg_d),
                "msg_kernel_vs_plain": _gap(msg, msg_p),
                "s_kernel_vs_f64": _gap(s, s_d),
                "s_plain_vs_f64": _gap(s_p, s_d),
            }
            for k_, v in errs.items():
                worst[k_] = max(worst.get(k_, 0.0), v)
            ok = (_close(s, s_p, 1e-4, 1e-5)
                  and _close(msg, msg_p, 1e-4, 1e-5))
            if not ok:
                bad = ((msg - msg_p).abs()
                       > 1e-5 + 1e-4 * msg_p.abs())
                at = [int(i) for i in torch.nonzero(bad)[0]] if bool(
                    bad.any()) else None
                failed.append({"trial": trial, "h": h, "at": at,
                               "msg_there": (float(msg_p[tuple(at)])
                                             if at else None), **errs})
    # on the failing calls: K4's error against float64 over the plain
    # version's
    ratio = [f["msg_kernel_vs_f64"] / max(f["msg_plain_vs_f64"], 1e-30)
             for f in failed]
    res = {"trials": trials, "calls": calls, "failed_calls": len(failed),
           "failed_trials": len({f["trial"] for f in failed}),
           "failed_by_h": {h: sum(f["h"] == h for f in failed)
                           for h in (8, 16, 32)},
           "kernel_over_plain": ({
               "median": float(np.median(ratio)), "max": float(max(ratio)),
               "kernel_farther": sum(r > 1 for r in ratio)}
               if ratio else None),
           "failed": failed[:20], "worst": worst,
           "bound_failed_calls": bound_failed,
           "max_err_over_bound": over_bound,
           "card": torch.cuda.get_device_name(0)}
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200,
         sys.argv[2] if len(sys.argv) > 2 else None)

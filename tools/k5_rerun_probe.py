#!/usr/bin/env python3
"""Run the K5 case of tests/test_torch_cuda.py's
``test_point_conv_large_k_and_pad`` (H 32, K 200, R 128, pad 128, two
passes a block, 4,000 points at stride 4) on many seeded inputs and hold
K5 against its plain version evaluated in float64.

    python3 tools/k5_rerun_probe.py [trials] [out.json]

Trial t draws the case's inputs from ``numpy.random.default_rng(t)``
(trial 0 is not the test's own seed, 60 + H + K + R, which is run first)
and checks what the test checks: out within
``tests/test_torch_cuda.py::point_conv_error_bound`` of the float64 plain
version, the rider's max exact, a rerun bit-identical. It reports the
largest share of the bound that K5 and the float32 plain version reached,
and how many trials the check the test had before (K5 against the float32
plain version at rtol 1e-4, atol 1e-4) would have failed. Prints one JSON
object (and writes it to ``out.json`` where given). Needs an NVIDIA GPU.
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
from crfconv_tpu_torch.ops import conv  # noqa: E402

H, K, R, PAD, PASSES, N = 32, 200, 128, 128, 2, 4000


def _test_module():
    """tests/test_torch_cuda.py, loaded by its path (its directory first on
    the path, for the modules it imports beside it)."""
    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tests")
    sys.path.insert(0, tests)
    path = os.path.join(tests, "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("test_torch_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(trials: int = 200, out: str = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build([cuda_build.POINT_CONV_FUSED_STRIDED])
    tc = _test_module()
    conv.block_passes = lambda *_: PASSES
    seeds = [60 + H + K + R] + list(range(trials))
    share, plain_share, failed, old_failed = [], [], [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        inputs = tc.large_k_inputs(rng, H, K, R, PAD, N, dev)
        got, ref_64 = tc.large_k_run(inputs, PAD, R)
        plain_32 = conv.point_conv_fused_strided_plain(
            inputs["x"], inputs["pos"], inputs["sub_pos"], inputs["idx"],
            inputs["res"], *inputs["w"], pad=PAD)
        bound = tc.point_conv_error_bound(inputs, PAD)
        s = float(((got[0].double() - ref_64[0]).abs() / bound).max())
        share.append(s)
        plain_share.append(float(
            ((plain_32[0].double() - ref_64[0]).abs() / bound).max()))
        again = tc.large_k_run(inputs, PAD, R, plain=False)
        if not (s <= 1.0 and torch.equal(got[1], ref_64[1].float())
                and torch.equal(got[0], again[0])):
            failed.append(seed)
        if not bool(((got[0] - plain_32[0]).abs()
                     <= 1e-4 + 1e-4 * plain_32[0].abs()).all()):
            old_failed.append(seed)
    result = {
        "device": torch.cuda.get_device_name(0),
        "case": {"h": H, "k": K, "r": R, "pad": PAD, "passes": PASSES,
                 "n": N},
        "runs": len(seeds),
        "failed_seeds": failed,
        "largest_share_of_bound": max(share),
        "median_share_of_bound": float(np.median(share)),
        "plain_f32_largest_share_of_bound": max(plain_share),
        "test_seed_share_of_bound": share[0],
        "old_check_failed_runs": len(old_failed),
        "old_check_failed_seeds": old_failed[:20],
    }
    text = json.dumps(result)
    print(text, flush=True)
    if out:
        with open(out, "w") as fh:
            fh.write(text + "\n")
    return result


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if args else 200, args[1] if len(args) > 1 else None)

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crfconv_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from crfconv_tpu_torch/csrc/ (nvcc, sm_90a).
2. Serves one warm-up request of the flagship model and records every
   kernel call of that forward (its real inputs).
3. Kernel phases: re-runs each recorded call through the kernel and its
   plain PyTorch version on the card, checks them against each other and
   times both (CUDA events, median of 20 runs after warm-up) beside the
   call's bound and, where one PyTorch call computes the same function,
   that call's time; the kernel's and that call's device time (the sum of
   their kernels in torch.profiler) and the wrapper's host time a call
   (no synchronisation), split for K1 into the wrapper, Kernel.__call__
   and the bare ctypes call.
4. Main path: resets the launch counts, serves REQUESTS requests of
   B8 x 8192 points (S3DIS shape) through Predictor with the full-width
   PointConvResNet(13 classes, use_crf, steps=1) and seeded random
   weights, and checks outputs and launch counts.
5. Runs one forward with the kernels and one with the plain versions on
   the same pyramid and compares the logits.
6. Train: takes one warm-up step of the full-width flagship (B8 x 8192,
   dropout 0.5, SGD lr 0.01) through make_train_step, recording every
   kernel call of that step, and holds each kernel (K1, K2, K7, K8, the
   leaky ReLU's backward) against its plain version on those calls, timed
   as in 3; each K8 call is also run twice (bit-identical) and held
   bit-equal to the plain version on CPU copies of its inputs, as on
   ScanNet's step in 10.
7. Train main path: resets the launch counts, takes TRAIN_STEPS steps and
   checks the loss, that every gradient is finite and not all zero, that
   every parameter and running statistic moved, and the launch counts per
   step; times the step and its phases and profiles one step.
8. From one state, one pyramid and one dropout seed, takes a step with the
   kernels and one through the plain versions, differentiated by autograd
   (not through the port's autograd Functions), and compares loss,
   gradients, parameters and running statistics.
9. One eval step, a checkpoint saved and restored into a fresh state, and
   the same eval step on it: the probabilities must be identical.
10. ScanNet (ScanNetConfig: CRFSegNet(20 classes, steps=10), B16 x 8192,
    label_offset 1): one warm-up request and one warm-up train step,
    recording every kernel call of each (K1, K2, K9, K10 in the request;
    K1, K2, K8, K9-K12 and the leaky ReLU's backward in the step), each
    held against its plain version and timed as in 3 (K2 bit-equal on
    every call of every path); each K11 call (and K14's in 14) is run
    twice (bit-identical) and every tenth, the first reverse step of each
    core, held bit-equal to the plain version on CPU copies; the reverse
    steps' plans (S~^T's structure, built once a backward) are timed.
11. ScanNet serving main path: SCANNET_REQUESTS requests through
    Predictor with seeded weights; outputs and exact launch counts; one
    forward with the kernels against one through the plain versions on the
    same pyramid; a profiled request.
12. ScanNet train main path: TRAIN_STEPS steps through make_train_step with
    ScanNet's settings, checked as in 7 (every CRF's c included); the step,
    its phases and a profile.
13. A ScanNet train step with the kernels against one through the plain
    versions differentiated by autograd, from one state and pyramid, as in
    8, and a second kernel step, which prints whether its gradients are
    bit-identical (K8, K11 and K14 add without atomics).
14. ScanNet-discrete (BaselineDiscreteCRFSegNet(20 classes, steps=10), B16 x
    8192, label_offset 1): a warm-up request (pyramid, forward, the last
    head log q, as the JAX package serves a two-head model) and a warm-up
    train step, recording every kernel call of each (K1, K2, K9, K13 in the
    request; K1, K2, K8, K9, K12, K13, K14 in the step), each held against
    its plain version and timed as in 3; DISCRETE_REQUESTS requests and
    TRAIN_STEPS steps with exact launch counts, checked as in 11-12; a
    forward and a train step with the kernels against the plain versions,
    as in 13; profiles and peak memory.
15. Semantic3D serving (Semantic3DConfig: PointConvResNet(8 classes,
    use_crf, steps=1), B16 x 65536): a recorded warm-up request whose K1-K5
    calls are held against the plain versions; SEMANTIC3D_REQUESTS requests
    through Predictor with exact launch counts (K5 on conv2_1 and
    conv3_1); a kernel-vs-plain forward; a profile and peak memory.
16. Flagship exact serving (the exact neighbour regime, B8 x 8192): a
    recorded warm-up request (build_pyramid_device, then the forward in
    NeighborMode("exact")) whose K6 calls are held bit-equal against the
    plain version, exact and, where the row is at most 1024 wide, packed;
    EXACT_REQUESTS requests with exact launch counts (K6 10, every other
    kernel 0) and column 0 == self on >= 0.999 of every scale's rows;
    request, pyramid and forward times, a profile and peak memory.
17. Flagship exact train step on a pyramid built once: TRAIN_STEPS steps of
    make_train_step(NeighborMode("exact"), windowed=False), no kernel
    launched but the leaky ReLU's backward, a finite loss, every parameter
    moved; step time, phases, train points/s; one exact eval step.
18. Windowed 2-view eval (make_eval_step(eval_views=2), B8 x 8192): K1's
    phase on one eval's recorded calls, launch counts per eval (K1 30, K2
    20, K3 4, K4 2), probabilities finite and normalised, and against the
    same eval with K1, K3 and K4 replaced by their plain versions.
19. ScanNet-discrete exact serving (BaselineDiscreteCRFSegNet(20 classes,
    steps=10), B16 x 8192, ScanNet's kernel sizes, ratios and k_up = 3):
    a recorded warm-up request whose K6 calls are held bit-equal;
    DISCRETE_REQUESTS requests with K6 11 launches each (10 pyramid + the
    CRF's kNN(32)) and no other kernel; a kernel-vs-plain forward; times,
    a profile and peak memory.

Prints the card's name and power limit, one JSON line of kernel results
and, last, {"ok": true, "device": {...}}. Exits non-zero, without that
last line, if any check fails or no GPU is present. Full results go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B, N, C_IN, N_CLASSES = 8, 8192, 6, 13
REQUESTS = 3
TRAIN_STEPS = 5
DROPOUT = 0.5
LR = 0.01
SEED = 0
DEVICE = "cuda:0"
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM float32, outside the tensor cores
# launches of each kernel per B8 x 8192 request (pyramid + forward)
EXPECTED_PER_REQUEST = {
    "windowed_gather": 15,
    "window_knn": 10,
    "point_conv_fused_infer": 2,
    "crf_similarity_message": 1,
    "point_conv_fused_strided": 0,   # conv2_1 has 2048 < 4096 rows
    "crf_operator": 0,          # steps = 1: no fused CRF core
    "crf_iterate": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 0,      # the backward only
}
# launches of each kernel per B8 x 8192 train step (pyramid, forward,
# backward): K8 is the backward of every K1 gather whose source needs a
# gradient (all but the two gathers of pos) and of both K7 calls; the
# leaky ReLU's backward runs once per activation (47, counted in the
# model's code)
EXPECTED_PER_STEP = {
    "windowed_gather": 18,
    "window_knn": 10,
    "point_conv_fused_infer": 0,
    "crf_similarity_message": 0,
    "windowed_weighted_reduce": 2,
    "windowed_gather_bwd": 18,
    "crf_operator": 0,
    "crf_iterate": 0,
    "crf_iterate_bwd": 0,
    "crf_neighbor_dot": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 47,
}
# the flagship's activations per train step, in either regime
FLAGSHIP_LEAKY_PER_STEP = EXPECTED_PER_STEP["leaky_relu_bwd"]
SCANNET_REQUESTS = 3
# launches per B16 x 8192 ScanNet request with CRFSegNet(steps=10): K1 is
# the encoder's 10 gathers of [pos, h], 2 per k-NN interpolation (features
# and positions) and 2 per GuideCRFConv (the radius mask's positions and
# the similarity's guidance), 4 decoders each; each decoder's fused core
# builds its operator once (K9) and iterates 10 times (K10)
SCANNET_PER_REQUEST = {
    "windowed_gather": 10 + 4 * 2 + 4 * 2,
    "window_knn": 10,
    "point_conv_fused_infer": 0,
    "crf_similarity_message": 0,
    "windowed_weighted_reduce": 0,
    "windowed_gather_bwd": 0,
    "crf_operator": 4,
    "crf_iterate": 4 * 10,
    "crf_iterate_bwd": 0,
    "crf_neighbor_dot": 0,
    "select_min_k": 0,
    "leaky_relu_bwd": 0,
}
# per ScanNet train step: the forward's, and in the backward K8 for every
# gather whose source needs a gradient (not the 4 + 4 gathers of
# positions), per core one build of the transpose's structure and 10
# reverse steps (K11) and one neighbour dot (K12), and one leaky-ReLU
# backward per activation
SCANNET_PER_STEP = {
    **SCANNET_PER_REQUEST,
    "windowed_gather_bwd": 10 + 4 + 4,
    "crf_iterate_bwd": 4 * (1 + 10),
    "crf_neighbor_dot": 4,
    "leaky_relu_bwd": 41,
}
# calls of each wrapper per ScanNet step: K11's reverse steps alone (its
# plan is built outside the wrapper)
SCANNET_CALLS_PER_STEP = {**SCANNET_PER_STEP, "crf_iterate_bwd": 4 * 10}
DISCRETE_REQUESTS = 3
# launches per B16 x 8192 ScanNet-discrete request with
# BaselineDiscreteCRFSegNet(steps=10): K1 is the encoder's 10 gathers, 2 per
# k-NN interpolation (4 decoders) and the discrete CRF's 2 (the kernel
# embeddings, F = 5 x 64, and the radius mask's positions); K2 the pyramid's
# 10 searches and the CRF's kNN(32); its fused core builds the operator once
# (K9) and iterates 10 times (K13)
DISCRETE_PER_REQUEST = {
    "windowed_gather": 10 + 4 * 2 + 2,
    "window_knn": 10 + 1,
    "point_conv_fused_infer": 0,
    "crf_similarity_message": 0,
    "point_conv_fused_strided": 0,
    "windowed_weighted_reduce": 0,
    "windowed_gather_bwd": 0,
    "crf_operator": 1,
    "crf_iterate": 0,
    "crf_iterate_bwd": 0,
    "crf_neighbor_dot": 0,
    "discrete_iterate": 10,
    "discrete_iterate_bwd": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 0,
}
# per ScanNet-discrete train step: the forward's, and in the backward K8 for
# every gather whose source needs a gradient (not the 4 + 1 of positions),
# one build of the transpose's structure and 10 reverse steps (K14), one
# neighbour dot (K12) and one leaky-ReLU backward per activation
DISCRETE_PER_STEP = {
    **DISCRETE_PER_REQUEST,
    "windowed_gather_bwd": 10 + 4 + 1,
    "discrete_iterate_bwd": 1 + 10,
    "crf_neighbor_dot": 1,
    "leaky_relu_bwd": 37,
}
DISCRETE_CALLS_PER_STEP = {**DISCRETE_PER_STEP, "discrete_iterate_bwd": 10}
EXACT_REQUESTS = 3
EXACT = None    # NeighborMode("exact"), set in main() after the import check
# launches per exact-regime request: K6 selects every kNN of the pyramid (a
# same-scale and an upsample search per scale), plus the discrete CRF's
# kNN(32); no other kernel runs in the exact regime (its gathers are plain
# index gathers, its CRFs the scans)
EXACT_PER_REQUEST = {"select_min_k": 10}
DISCRETE_EXACT_PER_REQUEST = {"select_min_k": 11}
# per windowed 2-view eval: twice a flagship request's launches
TWO_VIEW_PER_EVAL = {"windowed_gather": 30, "window_knn": 20,
                     "point_conv_fused_infer": 4, "crf_similarity_message": 2}
SEMANTIC3D_REQUESTS = 3
# launches per B16 x 65536 Semantic3D request: every eval PointConv with at
# least 4096 output rows and hidden width <= 32 runs fused, the same-scale
# conv1_1, conv1_2, conv2_2, conv3_2 (K3) and the strided conv2_1 and
# conv3_1 with their residual riders (K5); so does the CRF's similarity and
# first message (K4) of deconv1, deconv2 and deconv3 (hidden 8, 16, 32 on
# 65536, 16384, 4096 rows); K1 takes the other 4 convs' gathers, deconv4's
# CRF gather and the 4 upsamplings
SEMANTIC3D_PER_REQUEST = {
    "windowed_gather": 4 + 1 + 4,
    "window_knn": 10,
    "point_conv_fused_infer": 4,
    "crf_similarity_message": 3,
    "point_conv_fused_strided": 2,
    "windowed_weighted_reduce": 0,
    "windowed_gather_bwd": 0,
    "crf_operator": 0,
    "crf_iterate": 0,
    "discrete_iterate": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 0,
}
REPLACES = {
    "windowed_gather": "crfconv_tpu/ops/windowed_pallas.py:448",
    "window_knn": "crfconv_tpu/ops/windowed_pallas.py:684",
    "point_conv_fused_infer": "crfconv_tpu/ops/conv_pallas.py:380",
    "crf_similarity_message": "crfconv_tpu/ops/crf_sim_pallas.py:146",
    "windowed_weighted_reduce": "crfconv_tpu/ops/windowed_pallas.py:842",
    "windowed_gather_bwd": "crfconv_tpu/ops/windowed_pallas.py:372",
    "crf_operator": "crfconv_tpu/ops/crf_pallas.py:149",
    "crf_iterate": "crfconv_tpu/ops/crf_pallas.py:278",
    "crf_iterate_bwd": "crfconv_tpu/ops/crf_pallas.py:403",
    "crf_neighbor_dot": "crfconv_tpu/ops/crf_pallas.py:1147",
    "point_conv_fused_strided": "crfconv_tpu/ops/conv_pallas.py:258",
    "discrete_iterate": "crfconv_tpu/ops/crf_pallas.py:690",
    "discrete_iterate_bwd": "crfconv_tpu/ops/crf_pallas.py:1383",
    "select_min_k": "crfconv_tpu/ops/windowed_pallas.py:285",
    # flax's leaky-ReLU gradient at 0 in one launch; no TPU kernel
    "leaky_relu_bwd": None,
}


def only(counts: dict) -> dict:
    """Expected launches: ``counts``, and 0 for every other kernel."""
    return {name: counts.get(name, 0) for name in REPLACES}

FAILURES = []
# kernels whose every replayed call was bit-equal to the plain version
BIT_EQUAL = {}
# largest fraction of its rounding bound that a kernel (and its plain
# version) reached, over the calls of one phase: {kernel: [kernel, plain]}
OF_BOUND = {}
# widths of the K6 calls also held in packed mode
PACKED_CHECKED = []
# launches of each kernel in each main path: {kernel: {path: count}}
LAUNCHES = {name: {} for name in REPLACES}


def record_launches(path: str, counts: dict, expected: dict, units: int,
                    unit: str) -> None:
    """Check one main path's launch counts against ``expected`` per
    ``unit`` and keep them."""
    for name, per in expected.items():
        expect(counts[name] == per * units,
               f"{path}: {counts[name]} launches of {name} in {units} "
               f"{unit}, expected {per * units}")
        LAUNCHES[name][path] = counts[name]


def expect(cond: bool, what: str) -> None:
    if not cond:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else (
        f"nvidia-smi failed: {r.stderr.strip()}"
    )


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def patched(pairs):
    """Temporarily rebind module attributes: [(module, name, value)]."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def call_sites():
    """(module, attribute) through which the main path reaches each kernel
    wrapper, with the wrapper and its plain version."""
    from crfconv_tpu_torch.models import crf_conv, point_conv_big
    from crfconv_tpu_torch.ops import conv, crf_sim, neighbors, windowed

    return {
        "windowed_gather": (neighbors, "windowed_gather",
                            windowed.windowed_gather,
                            windowed.windowed_gather_plain),
        "window_knn": (windowed, "window_knn", windowed.window_knn,
                       windowed.window_knn_plain),
        "point_conv_fused_infer": (point_conv_big, "point_conv_fused_infer",
                                   conv.point_conv_fused_infer,
                                   conv.point_conv_fused_infer_plain),
        "crf_similarity_message": (crf_conv, "crf_similarity_message",
                                   crf_sim.crf_similarity_message,
                                   crf_sim.crf_similarity_message_plain),
    }


def train_call_sites():
    """As :func:`call_sites`, for the kernels of the train step: K1 and K7
    are reached inside their autograd Functions, K8 in their backward."""
    from crfconv_tpu_torch.ops import activation, windowed

    return {
        "windowed_gather": (windowed, "_windowed_gather_launch",
                            windowed._windowed_gather_launch,
                            windowed.windowed_gather_plain),
        "window_knn": (windowed, "window_knn", windowed.window_knn,
                       windowed.window_knn_plain),
        "windowed_weighted_reduce": (
            windowed, "windowed_weighted_reduce",
            windowed.windowed_weighted_reduce,
            windowed.windowed_weighted_reduce_plain,
        ),
        "windowed_gather_bwd": (windowed, "windowed_gather_bwd",
                                windowed.windowed_gather_bwd,
                                windowed.windowed_gather_bwd_plain),
        "leaky_relu_bwd": (activation, "leaky_relu_bwd",
                           activation.leaky_relu_bwd,
                           activation.leaky_relu_bwd_plain),
    }


def leaky_plain_pair():
    """The leaky ReLU's backward kernel replaced by its plain version, for
    the steps through the plain versions."""
    from crfconv_tpu_torch.ops import activation

    return (activation, "leaky_relu_bwd", activation.leaky_relu_bwd_plain)


def record_calls(sites, run, snapshot=()):
    """Run ``run()`` and return every call each kernel wrapper received
    (through the site's attribute, whatever the phase replays it with).
    For the kernels named in ``snapshot``, whose inputs are buffers that
    the caller overwrites later (the CRF cores' ping-pong states), the
    tensors are copied as they were and the output buffers dropped, so a
    replay computes the recorded call into fresh outputs; a K13 call that
    saved its message replays with ``with_msg``."""
    calls = {name: [] for name in sites}

    def recorder(name, fn):
        def rec(*args, **kwargs):
            if name in snapshot:
                kw = {k: v for k, v in kwargs.items()
                      if k not in ("out", "dmsg_out", "msg_out")}
                if kwargs.get("msg_out") is not None:
                    kw["with_msg"] = True   # K13 saving the message
                calls[name].append((
                    tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args), kw,
                ))
            else:
                calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return rec

    with patched([(m, a, recorder(name, getattr(m, a)))
                  for name, (m, a, _, _) in sites.items()]):
        run()
    return calls


# --------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once, and the
# operations the function needs on these inputs
# --------------------------------------------------------------------------


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound_of(name, args, out):
    if name == "windowed_gather":
        ops = 0
    elif name == "window_knn":
        pos, k = args[0], args[1]
        q = args[2] if len(args) > 2 and args[2] is not None else pos
        from crfconv_tpu_torch.ops.windowed import window_starts

        _, width, _ = window_starts(q.shape[1], pos.shape[1], *args[3:5])
        # 8 flops per distance and one comparison per candidate
        ops = q.shape[0] * q.shape[1] * width * 9
    elif name == "point_conv_fused_infer":
        x, idx = args[0], args[2]
        b, n, h = x.shape
        ops = b * n * idx.shape[2] * (2 * h * h + 11 * h + 3)
    elif name == "windowed_weighted_reduce":
        ops = 2 * args[1].numel()          # a multiply and an add per u
    elif name == "windowed_gather_bwd":
        ops = args[0].numel()              # an add per element of g
    elif name == "crf_operator":
        ops = 0                            # a clamp per index
    elif name == "leaky_relu_bwd":
        ops = args[0].numel()              # a comparison per element
    elif name in ("crf_iterate", "crf_iterate_bwd"):
        x, s_ = args[0], args[2]
        b, n, h = x.shape
        k = s_.shape[2]
        # the message (2 K H a row) and the apply (2 H^2); the backward
        # adds the scatter (2 K H), dM (2 H^2) and dzp (H)
        per_row = 2 * k * h + 2 * h * h
        ops = b * n * (per_row if name == "crf_iterate"
                       else 2 * per_row + h)
    elif name == "crf_neighbor_dot":
        t, b, n, h = args[1].shape
        ops = 2 * t * b * n * args[2].shape[2] * h
    elif name == "point_conv_fused_strided":
        x, idx, res = args[0], args[3], args[4]
        b, m, k = idx.shape
        h = x.shape[2]
        # the weight MLP and the product per neighbour, the rider's max
        ops = b * m * k * (2 * h * h + 11 * h + 3 + res.shape[2])
    elif name == "select_min_k":
        ops = args[0].numel()              # a comparison per entry
    elif name in ("discrete_iterate", "discrete_iterate_bwd"):
        q, w = args[0], args[3]
        b, n, l = q.shape
        k = w.shape[2]
        # the message (2 K L a row), the L x L product (2 L^2) and the
        # softmax (~5 L); the backward's dot, dz, du (5 L), dmsg and dC
        # (2 L^2 each) and the scatter (2 K L)
        ops = b * n * (2 * k * l + 2 * l * l + 5 * l if name ==
                       "discrete_iterate" else 2 * k * l + 4 * l * l + 5 * l)
    else:  # crf_similarity_message
        y, idx = args[0], args[2]
        b, n, h = y.shape
        ops = b * n * idx.shape[2] * (5 * h + 4)
    outs = out if isinstance(out, tuple) else (out,)
    t_bytes = (nbytes(*args) + nbytes(*outs)) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------


def compare(name, args, got, ref):
    """Max abs error of one call, with the phase's checks."""
    from crfconv_tpu_torch.ops.windowed import check_window_consistency

    if name == "windowed_gather":
        expect(torch.equal(got, ref), "windowed_gather: not bit-equal")
        return float((got - ref).abs().max()) if got.numel() else 0.0
    if name == "window_knn":
        # distinct keys, the same distance rounding: one answer
        pos = args[0]
        same = len(args) < 3 or args[2] is None
        expect(torch.equal(got, ref), "window_knn: not bit-equal")
        g = got.cpu().numpy()
        cons = check_window_consistency(g, pos.shape[1])
        expect(cons == 1.0, f"window_knn: window consistency {cons}")
        if same:
            self_ok = bool((got[:, :, 0] == torch.arange(
                got.shape[1], device=got.device)).all())
            expect(self_ok, "window_knn: column 0 is not self")
        return float((got.long() - ref.long()).abs().max())
    if name == "select_min_k":
        # distinct keys: one order, bit for bit; packed too where the row
        # is at most 1024 wide
        from crfconv_tpu_torch.ops.windowed import (
            PACKED_MAX_WIDTH, select_min_k, select_min_k_plain,
        )
        d, k = args[0], args[1]
        expect(torch.equal(got, ref), "select_min_k: not bit-equal")
        if d.shape[-1] <= PACKED_MAX_WIDTH:
            PACKED_CHECKED.append(d.shape[-1])
            expect(torch.equal(select_min_k(d, k, False),
                               select_min_k_plain(d, k, False)),
                   "select_min_k: packed mode not bit-equal")
        return float((got.long() - ref.long()).abs().max())
    if name == "windowed_weighted_reduce":   # one order of the k-sum
        expect(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
               "windowed_weighted_reduce: out or xg not bit-equal")
    if name == "windowed_gather_bwd":
        # f32 atomics add each row's terms in no fixed order. Any order (or
        # tree) of the n adds into a row lies within g sum|term| of the
        # exact sum, g = (n - 1) u / (1 - (n - 1) u) with u = 2^-24, plus
        # 2^-126 an add that atom.add.f32 flushes when subnormal; the kernel
        # (and, for comparison, the plain version) is held to that around
        # the sum taken in float64. A row of two terms can reach 1 - u of it
        from crfconv_tpu_torch.ops.windowed import windowed_gather_bwd_plain
        g, rest = args[0].double(), args[1:]
        exact = windowed_gather_bwd_plain(g, *rest)
        mass = windowed_gather_bwd_plain(g.abs(), *rest)
        terms = windowed_gather_bwd_plain(torch.ones_like(g[..., :1]), *rest)
        nu = (terms - 1).clamp(min=0) * 2.0 ** -24
        bound = (nu / (1 - nu) * mass
                 + torch.finfo(torch.float32).tiny * terms)
        frac = [float(((t.double() - exact).abs() / bound).nan_to_num(0.0)
                      .max()) for t in (got, ref)]
        OF_BOUND[name] = [max(a, b) for a, b in
                          zip(OF_BOUND.get(name, frac), frac)]
        expect(frac[0] <= 1.0, "windowed_gather_bwd: outside the rounding "
               f"bound of the exact sum ({frac[0]:.7g} of it)")
    if name in ("crf_operator", "crf_iterate", "leaky_relu_bwd"):
        # one clamp; one sum order (k, then h ascending), no fused
        # multiply-add, as the plain version adds
        expect(torch.equal(got, ref), f"{name}: not bit-equal")
        return float((got - ref).abs().max()) if got.numel() else 0.0
    if name == "crf_iterate_bwd":
        from crfconv_tpu_torch.ops.crf_core import _message
        lam, x, s_, col, m = args[:5]
        # dmsg (one order, as the plain version) and dzp + lam: bit-equal
        expect(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
               "crf_iterate_bwd: dmsg or dzp not bit-equal")
        # lam_t: within the rounding bound of the exact sum over the
        # kernel's dmsg (the plain version's index_add_ on the card adds
        # with atomics, which flush subnormals)
        lam_bound(name, got[0], s_, col, got[1])
        # dM: chunk sums added in order into the running sum against one
        # product over every row added to it (B*N terms, 131072 at deconv1:
        # float32 rounding grows with their count in either order, at the
        # scale of the running sum and of the products)
        h = lam.shape[-1]
        dm_mass = args[6].abs() + (_message(x.abs(), s_, col).reshape(-1, h).T
                                   @ lam.abs().reshape(-1, h))
        expect(bool(((got[3] - ref[3]).abs() <= 1e-4 * dm_mass
                     + 1e-6 * float(dm_mass.max())).all()),
               "crf_iterate_bwd: dM outside 1e-4 of its mass")
        return max(float((a - r).abs().max()) for a, r in zip(got, ref))
    if name == "point_conv_fused_strided":
        # the convolution: float32 sums in another order, as K3; the
        # rider's max is exact
        ok = torch.allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)
        expect(ok, f"{name}: out outside rtol 1e-4 atol 1e-5")
        expect(torch.equal(got[1], ref[1]), f"{name}: rider max not equal")
        return float((got[0] - ref[0]).abs().max())
    if name == "discrete_iterate":
        # one sum order (k, then j, then l ascending) in both; expf may round
        # apart from torch.exp
        q_scale = float(ref[0].abs().max())
        d_q = float((got[0] - ref[0]).abs().max())
        BIT_EQUAL.setdefault(name, True)
        BIT_EQUAL[name] &= bool(torch.equal(got[0], ref[0]))
        expect(d_q <= 2e-6 * q_scale, f"{name}: q off by {d_q}")
        if ref[1] is not None:
            expect(got[1] is not None and torch.equal(got[1], ref[1]),
                   f"{name}: msg not bit-equal")
        return d_q
    if name == "discrete_iterate_bwd":
        lam, qn, msg, w_, col, c_, du, dc = args[:8]
        # dmsg and du + dz: one order, as the plain version
        expect(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
               f"{name}: dmsg or du not bit-equal")
        lam_bound(name, got[0], w_, col, got[1])   # as K11's lam_t
        # dC: chunk sums added in order into the running sum, as K11's dM
        l = lam.shape[-1]
        dz = (got[2] - du).abs()
        dc_mass = dc.abs() + msg.abs().reshape(-1, l).T @ dz.reshape(-1, l)
        expect(bool(((got[3] - ref[3]).abs() <= 1e-4 * dc_mass
                     + 1e-6 * float(dc_mass.max())).all()),
               f"{name}: dC outside 1e-4 of its mass")
        return max(float((a - r).abs().max()) for a, r in zip(got, ref))
    if name == "crf_neighbor_dot":
        from crfconv_tpu_torch.ops.crf_core import crf_neighbor_dot_plain
        mass = crf_neighbor_dot_plain(args[0].abs(), args[1].abs(), args[2])
        expect(bool(((got - ref).abs() <= 1e-5 * mass
                     + 1e-6 * float(mass.max())).all()),
               "crf_neighbor_dot: outside 1e-5 of its mass")
        return float((got - ref).abs().max())
    # K3, K4: float32 sums in another order than the plain matmuls and
    # sums; K8 also within the bound above
    err = 0.0
    for a, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        ok = torch.allclose(a, r, rtol=1e-4, atol=1e-5)
        expect(ok, f"{name}: outside rtol 1e-4 atol 1e-5")
        err = max(err, float((a - r).abs().max()))
    return err


# K8's determinism checks per path: [calls, reruns bit-identical, calls
# bit-equal to the plain version on CPU copies (or None where not held)]
BWD_CHECKS = {}
# paths whose K8 calls are held bit-equal to the plain version on CPU
# copies: index_add_ on the CPU adds in index order, as K8 does; the
# discrete step's 5 GB calls keep the rounding bound alone
BWD_CPU_PATHS = ("flagship train", "scannet train")


def check_gather_bwd(kernel, args, kwargs, got, path) -> None:
    """K8 sums each row's terms in ascending slot order: a second launch
    is bit-identical, and on BWD_CPU_PATHS the result is bit-equal to the
    plain version run on CPU copies of the inputs."""
    from crfconv_tpu_torch.ops.windowed import windowed_gather_bwd_plain

    rec = BWD_CHECKS.setdefault(path, [0, 0, None])
    rec[0] += 1
    again = kernel(*args, **kwargs)
    same = torch.equal(got, again)
    rec[1] += same
    expect(same, f"windowed_gather_bwd ({path}): a rerun is not "
           "bit-identical")
    if path in BWD_CPU_PATHS:
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        equal = torch.equal(got.cpu(), windowed_gather_bwd_plain(*cpu,
                                                                 **kwargs))
        rec[2] = (rec[2] or 0) + equal
        expect(equal, f"windowed_gather_bwd ({path}): not bit-equal to the "
               "plain version on the CPU")


def lam_bound(name, lam_t, w, col, dmsg) -> None:
    """lam_t = S~^T dmsg against its exact sum (float64) over the same
    products: any order of a row's n terms w * dmsg, each rounded, lies
    within g sum|term| of it, g = n u / (1 - n u), u = 2^-24, plus 2^-150
    a product that rounds to a subnormal; no allowance for flushed adds.
    Records the kernel's fraction of the bound in OF_BOUND."""
    from crfconv_tpu_torch.ops.crf_core import crf_iterate_bwd_plain

    b, n, h = dmsg.shape
    eye = torch.eye(h, dtype=torch.float64, device=dmsg.device)
    zero = torch.zeros_like(dmsg, dtype=torch.float64)

    def transpose(ws, d):   # S~^T d in float64 (d as dmsg, M = I)
        return crf_iterate_bwd_plain(d, zero, ws, col, eye, zero,
                                     torch.zeros_like(eye))[0]

    exact = transpose(w.double(), dmsg.double())
    mass = transpose(w.double().abs(), dmsg.double().abs())
    ones = torch.ones_like(zero[..., :1])
    terms = crf_iterate_bwd_plain(
        ones, zero[..., :1], torch.ones_like(w, dtype=torch.float64), col,
        eye[:1, :1], zero[..., :1], torch.zeros_like(eye[:1, :1]))[0]
    nu = terms * 2.0 ** -24
    bound = nu / (1 - nu) * mass + terms * 2.0 ** -150
    frac = float(((lam_t.double() - exact).abs() / bound).nan_to_num(0.0)
                 .max())
    OF_BOUND[name] = [max(frac, OF_BOUND.get(name, [0.0])[0]), None]
    expect(frac <= 1.0, f"{name}: lam_t outside the rounding bound of the "
           f"exact sum ({frac:.7g} of it)")


# K11's and K14's determinism checks per path: [calls, reruns
# bit-identical, calls held to the plain version on CPU copies, of those
# bit-equal]. The CPU check takes the first reverse step of each core's
# backward (every REVERSE_CPU_EVERY-th call: 10 steps a core)
REVERSE_CHECKS = {}
REVERSE_CPU_EVERY = 10


def check_reverse(name, kernel, plain, i, args, kwargs, got, path) -> None:
    """A second launch of a reverse step (K11, K14) is bit-identical in
    every output; on every REVERSE_CPU_EVERY-th call the step is bit-equal
    to the plain version run on CPU copies of the inputs (lam_t adds in
    index_add_'s CPU order, dmsg and the running sum of dzp or du in the
    plain version's; dM or dC is held to its bound in compare)."""
    rec = REVERSE_CHECKS.setdefault(f"{name} ({path})", [0, 0, 0, 0])
    rec[0] += 1
    again = kernel(*args, **kwargs)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    rec[1] += same
    expect(same, f"{name} ({path}): a rerun is not bit-identical")
    if i % REVERSE_CPU_EVERY:
        return
    rec[2] += 1
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    ref = plain(*cpu)
    equal = all(torch.equal(a.cpu(), r) for a, r in zip(got[:3], ref[:3]))
    rec[3] += equal
    expect(equal, f"{name} ({path}): lam_t, dmsg or the running sum not "
           "bit-equal to the plain version on the CPU")


def plan_ms(name, calls) -> dict:
    """Build time of the distinct plans (S~^T's structure, W^T, the
    workspaces) that the recorded reverse steps shared: one a core's
    backward, outside the steps' own times."""
    from crfconv_tpu_torch.ops import crf_core, discrete_core

    build = (crf_core.crf_reverse_plan if name == "crf_iterate_bwd"
             else discrete_core.discrete_reverse_plan)
    w_at = 3 if name == "crf_iterate_bwd" else 4   # col, then the matrix
    plans = {}
    for args, kwargs in calls:
        plans.setdefault(id(kwargs["plan"]),
                         (args[w_at], args[w_at + 1],
                          kwargs["plan"].geometry))
    jobs = list(plans.values())

    def run():
        return [build(col, w, *geo) for col, w, geo in jobs]

    return {"plans": len(jobs), "ms": median_ms(run),
            "device_ms": device_ms(run)[0], "host_us": host_us(run, len(jobs))}


def library_call(name, args):
    """One PyTorch call computing the same function, or None. The main
    path's indices are window-consistent, so the clamp is the identity."""
    if name == "windowed_gather":
        x, idx = args[0], args[1]
        b_ix = torch.arange(x.shape[0], device=x.device)[:, None, None]
        gidx = idx.long()
        return lambda: x[b_ix, gidx]
    if name == "select_min_k":
        # the same set; torch.topk's order among ties is not guaranteed
        d, k = args[0], args[1]
        return lambda: torch.topk(d, k, dim=-1, largest=False)
    if name == "windowed_gather_bwd":
        g, idx, n = args[0], args[1], args[2]
        b, f = g.shape[0], g.shape[-1]
        rows = (torch.arange(b, device=g.device)[:, None, None] * n
                + idx.long()).reshape(-1)
        src = g.reshape(-1, f)
        return lambda: torch.zeros(
            (b * n, f), device=g.device
        ).index_add_(0, rows, src)
    return None


def device_ms(fn):
    """Device time of one call of ``fn``: the sum of every CUDA kernel,
    copy and fill it ran (torch.profiler), and those by name."""
    rows = profile_device(fn)
    return sum(r[1] for r in rows), [(k[:60], ms, n) for k, ms, n in rows]


def host_us(fn, calls: int, runs: int = 5) -> float:
    """Host time of one wrapper call: the wall time of ``fn`` (``calls``
    calls, no synchronisation inside) over ``calls``, median of ``runs``."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) / calls * 1e6


def host_split_us(kernel, calls) -> dict:
    """Host time of one K1 call, split: the wrapper as the path calls it,
    ``Kernel.__call__`` on the arguments the wrapper marshalled, and the
    bare ctypes function on them. The outputs stay alive while their
    pointers are relaunched."""
    from crfconv_tpu_torch import cuda_build

    k1 = cuda_build.WINDOWED_GATHER
    fn = k1._fn
    marshalled = []
    k1._fn = lambda *a: marshalled.append(a) or fn(*a)
    try:
        keep = [kernel(*a, **k) for a, k in calls]
    finally:
        k1._fn = fn
    n = len(calls)
    split = {
        "wrapper": host_us(lambda: [kernel(*a, **k) for a, k in calls], n),
        "kernel_call": host_us(lambda: [k1(*a) for a in marshalled], n),
        "ctypes": host_us(lambda: [fn(*a) for a in marshalled], n),
    }
    del keep
    return split


def kernel_phase(name, kernel, plain, calls, path):
    err, bound_ms, by_ops = 0.0, 0.0, {"bytes": 0.0, "operations": 0.0}
    ref_max = 0.0
    for i, (args, kwargs) in enumerate(calls):
        got = kernel(*args, **kwargs)
        ref = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = max(err, compare(name, args, got, ref))
        if name == "windowed_gather_bwd":
            check_gather_bwd(kernel, args, kwargs, got, path)
        if name in ("crf_iterate_bwd", "discrete_iterate_bwd"):
            check_reverse(name, kernel, plain, i, args, kwargs, got, path)
        ref_max = max([ref_max] + [
            float(r.abs().max()) for r in (ref if isinstance(ref, tuple)
                                           else (ref,))
            if isinstance(r, torch.Tensor) and r.is_floating_point()
            and r.numel()
        ])
        b_ms, b_by = bound_of(name, args, got)
        bound_ms += b_ms
        by_ops[b_by] += b_ms
    of_bound = OF_BOUND.pop(name, None)

    def run_kernel():
        for a, k in calls:
            kernel(*a, **k)

    ms = median_ms(run_kernel)
    kernel_device_ms, device_kernels = device_ms(run_kernel)
    kernel_host_us = host_us(run_kernel, len(calls))
    plain_ms = median_ms(lambda: [plain(*a, **k) for a, k in calls])
    libs = [library_call(name, a) for a, _ in calls]
    library_ms = library_device_ms = None
    if all(libs):
        library_ms = median_ms(lambda: [f() for f in libs])
        library_device_ms = device_ms(lambda: [f() for f in libs])[0]
    split = host_split_us(kernel, calls) if name == "windowed_gather" else None
    plans = (plan_ms(name, calls) if name in ("crf_iterate_bwd",
                                              "discrete_iterate_bwd")
             else None)
    return {
        "name": name,
        "route": "cuda",
        "source": f"crfconv_tpu_torch/csrc/{kernel_source(name)}",
        "replaces": REPLACES[name],
        "launches": None,
        "max_abs_err": err,
        "max_abs_ref": ref_max,
        "ms": ms,
        "device_ms": kernel_device_ms,
        "device_kernels": device_kernels,
        "host_us": kernel_host_us,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": max(by_ops, key=by_ops.get),
        "library_ms": library_ms,
        "library_device_ms": library_device_ms,
        "calls": len(calls),
        "of_bound": of_bound,
        "host_split_us": split,
        "plan": plans,
    }


def kernel_source(name):
    from crfconv_tpu_torch import cuda_build

    return {k.name: k.source for k in cuda_build.KERNELS}[name]


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def randomize_batch_norms(model, gen: torch.Generator):
    """Non-trivial batch-norm statistics and affine terms, from ``gen``."""
    from crfconv_tpu_torch.models.common import MaskedBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                f = m.mean.numel()
                m.mean.copy_(0.1 * torch.randn(f, generator=gen))
                m.var.copy_(0.5 + torch.rand(f, generator=gen))
                m.scale.copy_(0.8 + 0.4 * torch.rand(f, generator=gen))
                m.bias.copy_(0.1 * torch.randn(f, generator=gen))
    return model.eval()


def make_model(device):
    from crfconv_tpu_torch import PointConvResNet

    gen = torch.Generator().manual_seed(SEED)
    model = PointConvResNet(
        N_CLASSES, C_IN, use_crf=True, steps=1, device=device, generator=gen,
    )
    return randomize_batch_norms(model, gen)


def request(rng, device):
    pos = torch.as_tensor(rng.random((B, N, 3), dtype=np.float32), device=device)
    feats = torch.as_tensor(rng.random((B, N, C_IN), dtype=np.float32),
                            device=device)
    return pos, feats


def profile_device(fn, path=None):
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    sorted by time; the chrome trace goes to ``path`` if one is given. A
    first call runs as the profiler's warm-up step and is not recorded,
    and each call starts 50 ms into its step: without them the tracer
    missed device work that started at once (the first of a phase's
    calls, on the H100), and a pause after the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    rows = []

    def ready(p):
        for e in p.key_averages():   # device-side events only: the kernels,
            # copies and fills, not the ranges that annotate them on the
            # device (Optimizer.step#SGD.step)
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and not getattr(e, "is_user_annotation", False)):
                rows.append((e.key, e.self_device_time_total / 1e3, e.count))
        if path is not None:
            p.export_chrome_trace(path)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as p:
        for _ in range(2):
            time.sleep(0.05)   # the device work lies well inside the window
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            p.step()
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_phase(label: str, fn, path: str, unit: str, unit_ms: float):
    """Profile one call of ``fn`` (one ``unit`` of ``unit_ms``): prints the
    device's busy time, idle share and top kernels; returns (rows, busy
    ms). A pass that records no device time fails the run."""
    rows = profile_device(fn, path)
    expect(bool(rows), f"{label}: no device time recorded")
    busy = sum(r[1] for r in rows)
    print(f"# {label}: {sum(r[2] for r in rows)} kernel launches, busy "
          f"{busy:.3f} ms in one {unit} of {unit_ms:.3f} ms (idle share "
          f"{1 - busy / unit_ms:.3f}); top:", flush=True)
    for key, ms, cnt in rows[:12]:
        print(f"#   {ms:9.4f} ms  x{cnt:<4d} {key[:90]}", flush=True)
    return rows, busy


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------


def make_train_state(device, seed: int = SEED):
    """A fresh TrainState of the full-width flagship, weights from ``seed``."""
    from crfconv_tpu_torch import PointConvResNet, TrainState

    model = PointConvResNet(
        N_CLASSES, C_IN, use_crf=True, steps=1, dropout_rate=DROPOUT,
        device=device, generator=torch.Generator().manual_seed(seed),
    )
    return TrainState.create(model, lr=LR)


def train_batch(rng, device):
    from crfconv_tpu_torch import RawBatch

    pos, feats = request(rng, device)
    y = torch.as_tensor(rng.integers(0, N_CLASSES, (B, N)), device=device)
    return RawBatch(pos=pos, x=feats, y=y)


def step_generator(device, i: int) -> torch.Generator:
    """The generator of step ``i``: its pyramid offsets, then dropout."""
    return torch.Generator(device=device).manual_seed(SEED + 1 + i)


def snapshot(model) -> dict:
    """Copies of every parameter and buffer, by name."""
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def step_phases_ms(state, raw, gen, label_offset: int = 0, mode=None):
    """One train step in make_train_step's order, with a synchronize after
    each phase: host ms of (pyramid, forward + loss, backward, optimizer).
    The confusion matrix, a few small kernels, is left out. With ``mode``
    (a built pyramid's regime) ``raw`` is that PointBatch and the pyramid
    phase is empty."""
    from crfconv_tpu_torch.train.losses import segmentation_loss
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    torch.cuda.synchronize()
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    state.model.train()
    if mode is None:
        mode = TRAIN_MODE
        batch = build_windowed_batch(raw, gen, mode=TRAIN_MODE)
    else:
        batch = raw
    mark()
    out = state.model(batch, mode, dropout_generator=gen)
    loss = segmentation_loss(out, batch.y - label_offset)
    mark()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mark()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    mark()
    return np.diff(marks) * 1e3


def grad_gap(model_a, model_b):
    """The worst gradient of two models as a fraction of its tolerance:
    1e-4 of its tensor's largest magnitude, plus a floor of 1e-6 of the
    model's largest for the gradients that are zero but for rounding (the
    batch-norm bias of each deconv's unary_nn_1 and pairwise_nn_1: the
    row-stochastic CRF message and the next batch norm remove a constant
    shift of the first, the similarity sees only differences of the
    second). Returns (fraction, its parameter's name, largest |grad|)."""
    grads = [(n, p.grad, q.grad) for (n, p), q in
             zip(model_a.named_parameters(), model_b.parameters())]
    g_max = max(float(r.abs().max()) for _, _, r in grads)
    worst, name = 0.0, None
    for n, g, r in grads:
        frac = float((g - r).abs().max()) / (
            1e-4 * float(r.abs().max()) + 1e-6 * g_max)
        if frac > worst:
            worst, name = frac, n
    return worst, name, g_max


def run_phases(results: dict, path: str, sites, calls) -> None:
    """Kernel phases on one main path's recorded calls: every kernel of
    ``sites`` that the path called is held against its plain version and
    timed; the phase joins the kernel's list in ``results``."""
    for name, (_, _, kernel, plain) in sites.items():
        if not calls[name]:
            continue
        with torch.inference_mode():
            r = kernel_phase(name, kernel, plain, calls[name], path)
        r["path"] = path
        results.setdefault(name, []).append(r)
        print_phase(r)


def print_phase(r) -> None:
    print(f"# {r['name']} ({r['path']}): {r['calls']} calls, kernel "
          f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, host "
          f"{r['host_us']:.1f} us a call), "
          f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us "
          f"({r['bound_by']}), library {r['library_ms']} (device "
          f"{r['library_device_ms']}), max_abs_err "
          f"{r['max_abs_err']:.3g} (max |plain| {r['max_abs_ref']:.3g})"
          + ("" if r["of_bound"] is None else
             f", of rounding bound: kernel {r['of_bound'][0]:.7g}"
             + ("" if r["of_bound"][1] is None else
                f", plain {r['of_bound'][1]:.7g}"))
          + ("" if r["host_split_us"] is None else
             f", host us a call {r['host_split_us']}")
          + ("" if r["plan"] is None else
             f", plans built {r['plan']}"), flush=True)


def leaky_backward_ab(step, rows) -> dict:
    """The flagship step with the leaky-ReLU backward kernel (profiled
    ``rows``) against the same step with torch's own leaky-ReLU backward
    (which takes the slope as the gradient at 0): step ms (events, median
    of 3) in turns kernel, torch, torch, kernel, and profiler launches."""
    import torch.nn.functional as F
    from crfconv_tpu_torch.models import common

    def torch_leaky(x, slope):
        return F.leaky_relu(x, negative_slope=slope)

    ms = {"kernel": [], "torch": []}
    for arm in ("kernel", "torch", "torch", "kernel"):
        pairs = [(common, "leaky_relu", torch_leaky)] if arm == "torch" else []
        with patched(pairs):
            ms[arm].append(median_ms(step, runs=3, warmup=1))
    with patched([(common, "leaky_relu", torch_leaky)]):
        torch_rows = profile_device(step)
    out = {"kernel": {"step_ms": ms["kernel"],
                      "launches": sum(r[2] for r in rows)},
           "torch": {"step_ms": ms["torch"],
                     "launches": sum(r[2] for r in torch_rows)}}
    print(f"# flagship step, leaky-ReLU backward kernel vs torch's: {out}",
          flush=True)
    return out


def train_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 6-9: adds the train step's kernel phases to ``results`` and
    each kernel's launches in the train main path; returns the train
    measurements."""
    from crfconv_tpu_torch import (
        CheckpointManager, cuda_build, make_eval_step, make_train_step,
    )
    from crfconv_tpu_torch.models import point_conv_big
    from crfconv_tpu_torch.ops import neighbors, windowed
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    train_step = make_train_step(TRAIN_MODE)
    state = make_train_state(dev)
    raws = [train_batch(rng, dev) for _ in range(TRAIN_STEPS)]

    # 6. warm-up step, recording every kernel call of a train step
    sites = train_call_sites()
    calls = record_calls(
        sites, lambda: train_step(state, raws[0], step_generator(dev, 0))
    )
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = EXPECTED_PER_STEP[name]
        expect(len(got) == per,
               f"train {name}: {len(got)} calls per step, expected {per}")
    run_phases(results, "flagship train", sites, calls)
    del calls

    # 7. main path: TRAIN_STEPS steps
    params = dict(state.model.named_parameters())
    before = snapshot(state.model)
    gens = [step_generator(dev, 1 + i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    step_s, losses = [], []
    for i, raw in enumerate(raws):
        t0 = time.perf_counter()
        m = train_step(state, raw, gens[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        expect(np.isfinite(losses[-1]), f"train step {i}: loss {losses[-1]}")
        bad = [n for n, p in params.items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.any())]
        expect(not bad, f"train step {i}: no, non-finite or all-zero "
               f"gradient {bad[:4]}")
        expect(tuple(m["confusion"].shape) == (N_CLASSES, N_CLASSES)
               and int(m["confusion"].sum()) == B * N,
               f"train step {i}: confusion matrix does not count {B * N}")
    record_launches("flagship train", cuda_build.launch_counts(),
                    EXPECTED_PER_STEP, TRAIN_STEPS, "steps")
    after = snapshot(state.model)
    still = [n for n in params if torch.equal(before[n], after[n])]
    expect(not still, f"parameters that did not move: {still[:4]}")
    stats = [n for n in before if n not in params]
    same = [n for n in stats if torch.equal(before[n], after[n])]
    expect(stats and not same, f"running statistics unchanged: {same[:4]}")
    pts_s = TRAIN_STEPS * B * N / sum(step_s)
    print(f"# trained {TRAIN_STEPS} steps of {B}x{N}: "
          f"{[round(t * 1e3, 3) for t in step_s]} ms, {pts_s:.1f} points/s, "
          f"loss {[round(v, 5) for v in losses]}", flush=True)

    gen = step_generator(dev, 50)
    step_ms = median_ms(lambda: train_step(state, raws[0], gen), runs=5,
                        warmup=1)
    split = np.median(
        [step_phases_ms(state, raws[0], gen) for _ in range(5)], axis=0
    )
    print(f"# one train step: {step_ms:.3f} ms (events, median of 5); "
          f"phases pyramid {split[0]:.3f}, forward+loss {split[1]:.3f}, "
          f"backward {split[2]:.3f}, optimizer {split[3]:.3f} ms (host "
          f"clock with a synchronize after each, median of 5)", flush=True)
    profile_rows, busy_ms = profile_phase(
        "train profiler", lambda: train_step(state, raws[0], gen),
        os.path.join(out_dir, "chip_smoke_train_trace.json"), "step", step_ms,
    )
    leaky_vs_torch = leaky_backward_ab(
        lambda: train_step(state, raws[0], gen), profile_rows)

    # 8. one state, one pyramid, one dropout seed: kernels vs plain
    # versions, and a second kernel step for K8's run-to-run spread. The
    # plain step replaces the autograd Functions (K1/K8, K7/K8) at their
    # call sites by the plain versions, so autograd differentiates those
    # directly: a gradient the Functions dropped or mis-routed shows here
    batch = build_windowed_batch(raws[0], step_generator(dev, 100),
                                 mode=TRAIN_MODE)
    pb_step = make_train_step(TRAIN_MODE, windowed=False)
    sk, sk2, sp = (make_train_state(dev) for _ in range(3))
    cuda_build.reset_launch_counts()
    mk = pb_step(sk, batch, step_generator(dev, 101))
    k_counts = cuda_build.launch_counts()
    pb_step(sk2, batch, step_generator(dev, 101))
    plain_pairs = [
        (neighbors, "windowed_gather", windowed.windowed_gather_plain),
        (point_conv_big, "weighted_gather_reduce",
         lambda *a: windowed.windowed_weighted_reduce_plain(*a)[0]),
        leaky_plain_pair(),
    ]
    cuda_build.reset_launch_counts()
    with patched(plain_pairs):
        mp = pb_step(sp, batch, step_generator(dev, 101))
    p_counts = cuda_build.launch_counts()
    torch.cuda.synchronize()
    for name in ("windowed_gather", "windowed_weighted_reduce",
                 "windowed_gather_bwd", "leaky_relu_bwd"):
        expect(k_counts[name] == EXPECTED_PER_STEP[name],
               f"kernel step: {k_counts[name]} launches of {name}")
    expect(not any(p_counts.values()), f"plain step launched {p_counts}")
    # K1 and K7 are bit-equal to their plain versions, so the forward and
    # the loss are too. The backward differs only by the order of K8's and
    # autograd's f32 atomics (~1e-7 relative per call; the backward makes
    # no discrete choices that could amplify it)
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    expect(loss_k == loss_p, f"kernel vs plain step: loss {loss_k} vs {loss_p}")
    d_grad, worst, g_max = grad_gap(sk.model, sp.model)
    expect(d_grad <= 1.0, f"kernel vs plain step: gradient of {worst} at "
           f"{d_grad:.3g} of its tolerance")
    d_rerun, worst_rerun, _ = grad_gap(sk.model, sk2.model)
    expect(d_rerun <= 1.0, f"kernel step rerun: gradient of {worst_rerun} "
           f"at {d_rerun:.3g} of its tolerance")
    rerun_bit_equal = all(
        torch.equal(p.grad, q.grad)
        for p, q in zip(sk.model.parameters(), sk2.model.parameters())
    )
    a, b = snapshot(sk.model), snapshot(sp.model)
    off = []
    for n in b:   # the bounds of the JAX package's own train-step test
        atol = 5e-5 if n in params else 1e-5
        if not torch.allclose(a[n], b[n], rtol=1e-3, atol=atol):
            off.append(n)
    expect(not off, f"kernel vs plain step: outside rtol 1e-3 {off[:4]}")
    with patched(plain_pairs):
        plain_step_ms = median_ms(lambda: pb_step(sp, batch, gen), runs=3,
                                  warmup=1)
    kernel_step_ms = median_ms(lambda: pb_step(sk, batch, gen), runs=3,
                               warmup=1)
    print(f"# train step kernels vs plain (one pyramid): loss {loss_k} vs "
          f"{loss_p}, worst gradient {worst} at {d_grad:.3g} of its "
          f"tolerance (largest |grad| {g_max:.3g}); kernel step rerun: "
          f"gradients bit-equal {rerun_bit_equal}, worst {worst_rerun} at "
          f"{d_rerun:.3g}; step on a built pyramid {kernel_step_ms:.3f} ms, "
          f"plain versions {plain_step_ms:.3f} ms", flush=True)

    # 9. eval step, checkpoint round trip
    eval_step = make_eval_step(TRAIN_MODE)
    e1 = eval_step(state, raws[0], step_generator(dev, 200))
    ckpt_dir = os.path.join(out_dir, "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(state, state.step)
    fresh = mgr.restore(make_train_state(dev, seed=SEED + 1))
    e2 = eval_step(fresh, raws[0], step_generator(dev, 200))
    torch.cuda.synchronize()
    shutil.rmtree(ckpt_dir)
    expect(tuple(e1["probs"].shape) == (B, N, N_CLASSES)
           and bool(torch.isfinite(e1["probs"]).all()),
           "eval probabilities not finite or of the wrong shape")
    expect(fresh.step == state.step, f"restored step {fresh.step}")
    expect(torch.equal(e1["probs"], e2["probs"])
           and torch.equal(e1["preds"], e2["preds"]),
           "eval after the checkpoint round trip differs")
    print(f"# eval step and checkpoint round trip: loss "
          f"{float(e1['loss']):.5f} before, {float(e2['loss']):.5f} after",
          flush=True)
    return {
        "train_steps_ms": [t * 1e3 for t in step_s],
        "train_points_per_s": pts_s,
        "train_losses": losses,
        "train_step_ms": step_ms,
        "train_phases_ms": dict(zip(
            ("pyramid", "forward_loss", "backward", "optimizer"),
            map(float, split),
        )),
        "train_kernel_busy_ms": busy_ms,
        "train_profile": profile_rows[:40],
        "leaky_relu_backward": leaky_vs_torch,
        "kernel_vs_plain_step": {
            "loss": [loss_k, loss_p], "grad_of_tolerance": d_grad,
            "grad_worst": worst, "grad_max": g_max,
            "rerun_grad_of_tolerance": d_rerun,
            "rerun_grads_bit_equal": rerun_bit_equal,
            "kernel_step_ms": kernel_step_ms, "plain_step_ms": plain_step_ms,
        },
        "train_calls_per_step": EXPECTED_PER_STEP,
    }


# --------------------------------------------------------------------------
# ScanNet: CRFSegNet(steps=10), the continuous CRF's fused core
# --------------------------------------------------------------------------


def small_train_path(label, state, raws, train_step, dev, cfg, expected,
                     out_dir):
    """The train main path of a small-family net at ScanNet's settings:
    TRAIN_STEPS steps with their checks (a finite loss, every gradient
    finite and nonzero, the confusion matrix counting the labelled points,
    exact launch counts per step, every parameter and running statistic
    moved), then one step's time, its phase split and a profile. Returns
    the parameters (with the gradients of the last step taken) and the
    measurements."""
    from crfconv_tpu_torch import cuda_build

    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    params = dict(state.model.named_parameters())
    before = snapshot(state.model)
    gens = [step_generator(dev, 1 + i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    step_s, losses = [], []
    for i, raw in enumerate(raws):
        t0 = time.perf_counter()
        m = train_step(state, raw, gens[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        expect(np.isfinite(losses[-1]), f"{label} step {i}: loss {losses[-1]}")
        bad = [nm for nm, p in params.items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.any())]
        expect(not bad, f"{label} step {i}: no, non-finite or all-zero "
               f"gradient {bad[:4]}")
        labelled = int((raw.y >= cfg.label_offset).sum())
        expect(tuple(m["confusion"].shape) == (n_cls, n_cls)
               and int(m["confusion"].sum()) == labelled,
               f"{label} step {i}: confusion matrix does not count the "
               f"{labelled} labelled points")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    record_launches(f"{label} train", cuda_build.launch_counts(), expected,
                    TRAIN_STEPS, "steps")
    after = snapshot(state.model)
    still = [nm for nm in params if torch.equal(before[nm], after[nm])]
    expect(not still, f"{label} parameters that did not move: {still[:4]}")
    stats = [nm for nm in before if nm not in params]
    same = [nm for nm in stats if torch.equal(before[nm], after[nm])]
    expect(stats and not same,
           f"{label} running statistics unchanged: {same[:4]}")
    pts_s = TRAIN_STEPS * b * n / sum(step_s)
    print(f"# {label}: trained {TRAIN_STEPS} steps of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in step_s]} ms, {pts_s:.1f} points/s, "
          f"loss {[round(v, 5) for v in losses]}, peak memory "
          f"{peak_gb:.2f} GiB", flush=True)

    gen_t = step_generator(dev, 50)
    step_ms = median_ms(lambda: train_step(state, raws[0], gen_t), runs=3,
                        warmup=1)
    split = np.median([step_phases_ms(state, raws[0], gen_t, cfg.label_offset)
                       for _ in range(3)], axis=0)
    print(f"# {label} one train step: {step_ms:.3f} ms (events, median of "
          f"3); phases pyramid {split[0]:.3f}, forward+loss {split[1]:.3f}, "
          f"backward {split[2]:.3f}, optimizer {split[3]:.3f} ms", flush=True)
    profile, busy = profile_phase(
        f"{label} train profiler", lambda: train_step(state, raws[0], gen_t),
        os.path.join(out_dir, f"chip_smoke_{label}_train_trace.json"), "step",
        step_ms,
    )
    return params, {
        "train_steps_ms": [t * 1e3 for t in step_s],
        "train_points_per_s": pts_s,
        "train_losses": losses,
        "train_step_ms": step_ms,
        "train_phases_ms": dict(zip(
            ("pyramid", "forward_loss", "backward", "optimizer"),
            map(float, split),
        )),
        "train_peak_gib": peak_gb,
        "train_kernel_busy_ms": busy,
        "train_profile": profile[:40],
    }


def small_kernel_vs_plain_step(label, make_state, raw, dev, cfg, plain_pairs,
                               expected, plain_launches, loss_rtol):
    """From one state and one pyramid: a train step through the kernels, a
    second one for the run-to-run spread, and one with
    ``plain_pairs`` patched in, differentiated by autograd. Launch counts
    (``expected`` for the kernel step, ``plain_launches`` for the plain
    one), the losses within ``loss_rtol``, every gradient within its
    tolerance (:func:`grad_gap`), parameters rtol 1e-3 atol 5e-5 and
    running statistics rtol 1e-3 atol 1e-5. Returns the measurements."""
    from crfconv_tpu_torch import cuda_build, make_train_step
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    batch = build_windowed_batch(raw, step_generator(dev, 100),
                                 mode=TRAIN_MODE)
    pb_step = make_train_step(TRAIN_MODE, ignore_index=cfg.ignore_index,
                              label_offset=cfg.label_offset, windowed=False)
    sk, sk2, sp = (make_state() for _ in range(3))
    cuda_build.reset_launch_counts()
    mk = pb_step(sk, batch)
    k_counts = cuda_build.launch_counts()
    pb_step(sk2, batch)
    cuda_build.reset_launch_counts()
    with patched(plain_pairs):
        mp = pb_step(sp, batch)
    p_counts = cuda_build.launch_counts()
    torch.cuda.synchronize()
    for name, per in expected.items():
        expect(k_counts[name] == per, f"{label} kernel step: "
               f"{k_counts[name]} launches of {name}, expected {per}")
    expect(all(c == plain_launches.get(nm, 0) for nm, c in p_counts.items()),
           f"{label} plain step launched {p_counts}")
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    expect(abs(loss_k - loss_p) <= loss_rtol * abs(loss_p),
           f"{label} kernel vs plain step: loss {loss_k} vs {loss_p}")
    d_grad, worst, g_max = grad_gap(sk.model, sp.model)
    expect(d_grad <= 1.0, f"{label} kernel vs plain step: gradient of "
           f"{worst} at {d_grad:.3g} of its tolerance")
    d_rerun, worst_rerun, _ = grad_gap(sk.model, sk2.model)
    expect(d_rerun <= 1.0, f"{label} kernel step rerun: gradient of "
           f"{worst_rerun} at {d_rerun:.3g} of its tolerance")
    rerun_differs = [
        nm for (nm, p), q in zip(sk.model.named_parameters(),
                                 sk2.model.parameters())
        if not torch.equal(p.grad, q.grad)]
    rerun_bit_equal = not rerun_differs
    a_sd, b_sd = snapshot(sk.model), snapshot(sp.model)
    pnames = {nm for nm, _ in sk.model.named_parameters()}
    off = [nm for nm in b_sd if not torch.allclose(
        a_sd[nm], b_sd[nm], rtol=1e-3, atol=5e-5 if nm in pnames else 1e-5)]
    expect(not off, f"{label} kernel vs plain step: outside rtol 1e-3 "
           f"{off[:4]}")
    del sk2
    kernel_step_ms = median_ms(lambda: pb_step(sk, batch), runs=3, warmup=1)
    with patched(plain_pairs):
        plain_step_ms = median_ms(lambda: pb_step(sp, batch), runs=3,
                                  warmup=1)
    print(f"# {label} train step kernels vs plain (one pyramid): loss "
          f"{loss_k} vs {loss_p}, worst gradient {worst} at {d_grad:.3g} of "
          f"its tolerance (largest |grad| {g_max:.3g}); kernel step rerun: "
          f"gradients bit-equal {rerun_bit_equal} ({len(rerun_differs)} "
          f"differ: {rerun_differs[:6]}), worst {worst_rerun} at "
          f"{d_rerun:.3g}; step on a built pyramid {kernel_step_ms:.3f} ms, "
          f"plain versions {plain_step_ms:.3f} ms", flush=True)
    return {
        "loss": [loss_k, loss_p], "grad_of_tolerance": d_grad,
        "grad_worst": worst, "grad_max": g_max,
        "rerun_grad_of_tolerance": d_rerun,
        "rerun_grads_bit_equal": rerun_bit_equal,
        "rerun_grads_differ": rerun_differs,
        "kernel_step_ms": kernel_step_ms, "plain_step_ms": plain_step_ms,
    }


def scannet_config():
    from crfconv_tpu_torch.train.config import ScanNetConfig

    return ScanNetConfig()


def scannet_model(cfg, device, seed: int = SEED):
    from crfconv_tpu_torch import CRFSegNet

    return CRFSegNet(cfg.num_classes, cfg.in_channels, steps=cfg.steps,
                     device=device,
                     generator=torch.Generator().manual_seed(seed))


def scannet_state(cfg, device, seed: int = SEED):
    """A fresh TrainState with ScanNet's optimizer settings."""
    from crfconv_tpu_torch import TrainState

    return TrainState.create(
        scannet_model(cfg, device, seed), lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, gamma=cfg.gamma,
    )


def scannet_cloud(cfg, rng, device, labels: bool = False):
    """A batch of B16 x 8192 random clouds; with ``labels``, a RawBatch
    whose labels are 0 (unlabeled, ignored after the offset) to 20."""
    from crfconv_tpu_torch import RawBatch

    b, n = cfg.batch_size, cfg.sample_num
    pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32),
                          device=device)
    feats = torch.as_tensor(
        rng.random((b, n, cfg.in_channels), dtype=np.float32), device=device)
    if not labels:
        return pos, feats
    y = torch.as_tensor(rng.integers(0, cfg.num_classes + 1, (b, n)),
                        device=device)
    return RawBatch(pos=pos, x=feats, y=y)


def crf_call_sites():
    """As :func:`call_sites`, for the CRF core's kernels, reached from its
    autograd Function."""
    from crfconv_tpu_torch.ops import crf_core

    return {
        name: (crf_core, name, getattr(crf_core, name),
               getattr(crf_core, name + "_plain"))
        for name in ("crf_operator", "crf_iterate", "crf_iterate_bwd",
                     "crf_neighbor_dot")
    }


def scannet_plain_pairs():
    """The ScanNet model's kernels replaced by their plain versions at their
    call sites: K1 (so K8 becomes autograd's) and the whole fused CRF core
    (so K9-K12 become autograd through the plain K9/K10)."""
    from crfconv_tpu_torch.ops import crf, crf_core, neighbors, windowed

    return [(neighbors, "windowed_gather", windowed.windowed_gather_plain),
            (crf, "crf_core", crf_core.crf_core_plain), leaky_plain_pair()]


def scannet_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 10-13: adds the ScanNet request's and step's kernel phases to
    ``results`` and the ScanNet main paths' launches; returns the ScanNet
    measurements."""
    from crfconv_tpu_torch import Predictor, cuda_build, make_train_step
    from crfconv_tpu_torch.serve import SERVING_MODE
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    cfg = scannet_config()
    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(SEED + 7)
    model = randomize_batch_norms(scannet_model(cfg, dev), gen)
    with torch.no_grad():   # compatibilities away from the identity
        for name, p in model.named_parameters():
            if name.endswith(".c"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(dev))
    predictor = Predictor(model, device=dev, seed=SEED)
    crf_sites = crf_call_sites()

    # 10. warm-up request and warm-up train step, recording every kernel
    # call of each; every kernel held against its plain version on them
    serve_sites = {k: v for k, v in call_sites().items()
                   if k in ("windowed_gather", "window_knn")}
    serve_sites.update((k, crf_sites[k]) for k in ("crf_operator",
                                                   "crf_iterate"))
    pos, feats = scannet_cloud(cfg, rng, dev)
    calls = record_calls(serve_sites,
                         lambda: predictor.predict_logits(pos, feats),
                         snapshot=tuple(crf_sites))
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = SCANNET_PER_REQUEST[name]
        expect(len(got) == per,
               f"scannet {name}: {len(got)} calls per request, expected {per}")
    run_phases(results, "scannet serve", serve_sites, calls)
    del calls

    train_step = make_train_step(TRAIN_MODE, ignore_index=cfg.ignore_index,
                                 label_offset=cfg.label_offset)
    state = scannet_state(cfg, dev)
    raws = [scannet_cloud(cfg, rng, dev, labels=True)
            for _ in range(TRAIN_STEPS)]
    train_sites = {**train_call_sites(), **crf_sites}
    calls = record_calls(
        train_sites, lambda: train_step(state, raws[0], step_generator(dev, 0)),
        snapshot=tuple(crf_sites),
    )
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = SCANNET_CALLS_PER_STEP[name]
        expect(len(got) == per,
               f"scannet {name}: {len(got)} calls per step, expected {per}")
    run_phases(results, "scannet train", train_sites, calls)
    del calls
    torch.cuda.empty_cache()

    # 11. serving main path
    reqs = [scannet_cloud(cfg, rng, dev) for _ in range(SCANNET_REQUESTS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat, outs = [], []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        logp = predictor.predict_logits(p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(logp)
    record_launches("scannet serve", cuda_build.launch_counts(),
                    SCANNET_PER_REQUEST, SCANNET_REQUESTS, "requests")
    for logp in outs:
        expect(tuple(logp.shape) == (b, n, n_cls),
               f"scannet log-probs shape {tuple(logp.shape)}")
        expect(bool(torch.isfinite(logp).all()), "scannet: non-finite output")
        norm = float((torch.logsumexp(logp, -1)).abs().max())
        expect(norm <= 1e-4, f"scannet: log-probs off normal by {norm}")
        labels = logp.argmax(-1)
        expect(bool(((labels >= 0) & (labels < n_cls)).all()),
               f"scannet: labels outside [0, {n_cls})")
    del outs
    pts_s = SCANNET_REQUESTS * b * n / sum(lat)
    print(f"# scannet: served {SCANNET_REQUESTS} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s",
          flush=True)

    p_, f_ = reqs[0]

    def pyramid():
        return predictor.prepare(p_, f_)

    batch, _ = pyramid()
    with torch.inference_mode():
        pyramid_ms = median_ms(pyramid, runs=5)
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=5)
        request_ms = median_ms(lambda: predictor.predict_logits(p_, f_),
                               runs=5)
        got = model(batch, SERVING_MODE)
        with patched(scannet_plain_pairs()):
            ref = model(batch, SERVING_MODE)
            plain_forward_ms = median_ms(lambda: model(batch, SERVING_MODE),
                                         runs=3, warmup=1)
    torch.cuda.synchronize()
    d_logp = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    fwd_bit_equal = bool(torch.equal(got, ref))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # K1, K9 and K10 are bit-equal to their plain versions and the rest of
    # the forward is the same torch code: expected bit-equal; the limit
    # leaves room for last-bit differences only
    expect(d_logp <= 1e-5 * max(1.0, scale),
           f"scannet kernel vs plain forward: max |dlogp| {d_logp}")
    expect(agree >= 0.999, f"scannet argmax agreement {agree}")
    print(f"# scannet forward kernels vs plain: max |dlogp| {d_logp:.3g} "
          f"(max |logp| {scale:.3g}), bit-equal {fwd_bit_equal}, argmax "
          f"agreement {agree}", flush=True)
    print(f"# scannet one request: {request_ms:.3f} ms (pyramid "
          f"{pyramid_ms:.3f} ms, forward {forward_ms:.3f} ms; plain-version "
          f"forward {plain_forward_ms:.3f} ms)", flush=True)
    del got, ref
    with torch.inference_mode():
        serve_profile, serve_busy = profile_phase(
            "scannet profiler", lambda: predictor.predict_logits(p_, f_),
            os.path.join(out_dir, "chip_smoke_scannet_trace.json"),
            "request", request_ms,
        )
    del predictor, reqs
    torch.cuda.empty_cache()

    # 12. train main path
    params, train = small_train_path("scannet", state, raws, train_step, dev,
                                     cfg, SCANNET_PER_STEP, out_dir)
    c_grads = {nm: float(p.grad.abs().max()) for nm, p in params.items()
               if nm.endswith(".c")}
    expect(len(c_grads) == 4 and all(v > 0 for v in c_grads.values()),
           f"scannet: CRF compatibility gradients {c_grads}")
    del state, params
    torch.cuda.empty_cache()

    # 13. one state, one pyramid: kernels vs plain versions, and a second
    # kernel step for the run-to-run spread; the forward is bit-equal (K1,
    # K9, K10), so the loss is; the backward differs from the plain one by
    # the order of autograd's atomics and K11's and K12's sums
    step_check = small_kernel_vs_plain_step(
        "scannet", lambda: scannet_state(cfg, dev), raws[0], dev, cfg,
        scannet_plain_pairs(), {**SCANNET_PER_STEP, "window_knn": 0}, {},
        loss_rtol=0.0,
    )
    return {
        "config": {"model": cfg.model_name, "batch": b, "points": n,
                   "classes": n_cls, "steps": cfg.steps,
                   "label_offset": cfg.label_offset},
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogp": d_logp,
        "forward_bit_equal": fwd_bit_equal,
        "argmax_agreement": agree,
        "kernel_busy_ms": serve_busy,
        "profile": serve_profile[:40],
        **train,
        "c_grad_max": c_grads,
        "kernel_vs_plain_step": step_check,
        "calls_per_request": SCANNET_PER_REQUEST,
        "calls_per_step": SCANNET_PER_STEP,
    }


# --------------------------------------------------------------------------
# ScanNet-discrete: BaselineDiscreteCRFSegNet(steps=10), the discrete CRF
# --------------------------------------------------------------------------


def discrete_model(cfg, device, seed: int = SEED):
    from crfconv_tpu_torch import BaselineDiscreteCRFSegNet

    return BaselineDiscreteCRFSegNet(
        cfg.num_classes, cfg.in_channels, steps=cfg.steps, device=device,
        generator=torch.Generator().manual_seed(seed))


def discrete_state(cfg, device, seed: int = SEED):
    """A fresh TrainState of the discrete net with ScanNet's optimizer."""
    from crfconv_tpu_torch import TrainState

    return TrainState.create(
        discrete_model(cfg, device, seed), lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, gamma=cfg.gamma,
    )


def serve_last_head(predictor, pos, feats):
    """A two-head model served as the JAX package serves it: the
    Predictor's pyramid, the forward, the last head (log q), in the input
    order."""
    with torch.inference_mode():
        batch, order = predictor.prepare(pos, feats)
        logq = predictor.model(batch, predictor.mode)[-1]
        return predictor.restore(logq, order)


def _k13(q, u, w, col, C, with_msg=False):
    """K13 as a phase replays it: (q_next, msg_t or None)."""
    from crfconv_tpu_torch.ops import discrete_core

    msg = torch.empty_like(q) if with_msg else None
    return discrete_core.discrete_iterate(q, u, w, col, C, msg_out=msg), msg


def _k13_plain(q, u, w, col, C, with_msg=False):
    from crfconv_tpu_torch.ops import discrete_core

    out, msg = discrete_core._iterate_plain(q, u, w, col, C)
    return out, (msg if with_msg else None)


def discrete_call_sites():
    """As :func:`call_sites`, for the discrete core's kernels, reached from
    its autograd Function (K9 and K12 are the continuous core's)."""
    from crfconv_tpu_torch.ops import crf_core, discrete_core

    return {
        "crf_operator": (discrete_core, "crf_operator", crf_core.crf_operator,
                         crf_core.crf_operator_plain),
        "discrete_iterate": (discrete_core, "discrete_iterate", _k13,
                             _k13_plain),
        "discrete_iterate_bwd": (discrete_core, "discrete_iterate_bwd",
                                 discrete_core.discrete_iterate_bwd,
                                 discrete_core.discrete_iterate_bwd_plain),
        "crf_neighbor_dot": (discrete_core, "crf_neighbor_dot",
                             crf_core.crf_neighbor_dot,
                             crf_core.crf_neighbor_dot_plain),
    }


def discrete_plain_pairs():
    """The discrete net's kernels replaced by their plain versions at their
    call sites: K1 (so K8 becomes autograd's) and the whole discrete core
    (K9, K13, and autograd for K12/K14). K2 (the CRF's kNN) stays: it is
    held against its plain version on its recorded calls, and a last-bit
    distance tie there would move a neighbour, not test the rest."""
    from crfconv_tpu_torch.ops import crf, discrete_core, neighbors, windowed

    return [(neighbors, "windowed_gather", windowed.windowed_gather_plain),
            (crf, "discrete_core", discrete_core.discrete_core_plain),
            leaky_plain_pair()]


def discrete_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 14: adds the ScanNet-discrete request's and step's kernel phases
    to ``results`` and its main paths' launches; returns its
    measurements."""
    from crfconv_tpu_torch import Predictor, cuda_build, make_train_step
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    cfg = scannet_config()
    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(SEED + 11)
    model = randomize_batch_norms(discrete_model(cfg, dev), gen)
    with torch.no_grad():   # compatibilities away from the identity
        model.crf.C.add_(0.1 * torch.randn(model.crf.C.shape,
                                           generator=gen).to(dev))
    predictor = Predictor(model, device=dev, seed=SEED)
    d_sites = discrete_call_sites()

    # warm-up request and train step, recording every kernel call of each
    serve_sites = {k: v for k, v in call_sites().items()
                   if k in ("windowed_gather", "window_knn")}
    serve_sites.update((k, d_sites[k]) for k in ("crf_operator",
                                                 "discrete_iterate"))
    pos, feats = scannet_cloud(cfg, rng, dev)
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(serve_sites,
                         lambda: serve_last_head(predictor, pos, feats),
                         snapshot=tuple(d_sites))
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, got in calls.items():
        per = DISCRETE_PER_REQUEST[name]
        expect(len(got) == per, f"discrete {name}: {len(got)} calls per "
               f"request, expected {per}")
    run_phases(results, "discrete serve", serve_sites, calls)
    del calls
    torch.cuda.empty_cache()

    train_step = make_train_step(TRAIN_MODE, ignore_index=cfg.ignore_index,
                                 label_offset=cfg.label_offset)
    state = discrete_state(cfg, dev)
    raws = [scannet_cloud(cfg, rng, dev, labels=True)
            for _ in range(TRAIN_STEPS)]
    train_sites = {**train_call_sites(), **d_sites}
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(
        train_sites, lambda: train_step(state, raws[0], step_generator(dev, 0)),
        snapshot=tuple(d_sites),
    )
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = DISCRETE_CALLS_PER_STEP[name]
        expect(len(got) == per,
               f"discrete {name}: {len(got)} calls per step, expected {per}")
    run_phases(results, "discrete train", train_sites, calls)
    del calls
    torch.cuda.empty_cache()

    # serving main path
    reqs = [scannet_cloud(cfg, rng, dev) for _ in range(DISCRETE_REQUESTS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat, outs = [], []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        logq = serve_last_head(predictor, p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(logq)
    record_launches("discrete serve", cuda_build.launch_counts(),
                    DISCRETE_PER_REQUEST, DISCRETE_REQUESTS, "requests")
    for logq in outs:
        expect(tuple(logq.shape) == (b, n, n_cls),
               f"discrete log q shape {tuple(logq.shape)}")
        expect(bool(torch.isfinite(logq).all()), "discrete: non-finite log q")
        # q sums to 1; the 1e-12 floor of log q can add up to L * 1e-12
        norm = float(torch.logsumexp(logq, -1).abs().max())
        expect(norm <= 1e-4, f"discrete: log q off normal by {norm}")
    del outs
    pts_s = DISCRETE_REQUESTS * b * n / sum(lat)
    print(f"# discrete: served {DISCRETE_REQUESTS} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s",
          flush=True)

    from crfconv_tpu_torch.serve import SERVING_MODE

    p_, f_ = reqs[0]
    batch, _ = predictor.prepare(p_, f_)
    with torch.inference_mode():
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=5)
        request_ms = median_ms(lambda: serve_last_head(predictor, p_, f_), runs=5)
        got = model(batch, SERVING_MODE)[-1]
        with patched(discrete_plain_pairs()):
            ref = model(batch, SERVING_MODE)[-1]
            plain_forward_ms = median_ms(lambda: model(batch, SERVING_MODE),
                                         runs=3, warmup=1)
    torch.cuda.synchronize()
    d_logq = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    fwd_bit_equal = bool(torch.equal(got, ref))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # K1, K9 are bit-equal to their plain versions, K13 up to expf's
    # rounding; the rest of the forward is the same torch code
    expect(d_logq <= 1e-5 * max(1.0, scale),
           f"discrete kernel vs plain forward: max |dlogq| {d_logq}")
    expect(agree >= 0.999, f"discrete argmax agreement {agree}")
    print(f"# discrete forward kernels vs plain: max |dlogq| {d_logq:.3g} "
          f"(max |logq| {scale:.3g}), bit-equal {fwd_bit_equal}, argmax "
          f"agreement {agree}", flush=True)
    print(f"# discrete one request: {request_ms:.3f} ms (forward "
          f"{forward_ms:.3f} ms; plain-version forward {plain_forward_ms:.3f}"
          f" ms); peak memory of a request {serve_peak:.2f} GiB", flush=True)
    del got, ref, batch
    with torch.inference_mode():
        serve_profile, serve_busy = profile_phase(
            "discrete profiler", lambda: serve_last_head(predictor, p_, f_),
            os.path.join(out_dir, "chip_smoke_discrete_trace.json"),
            "request", request_ms,
        )
    del reqs, model, predictor
    torch.cuda.empty_cache()

    # train main path
    params, train = small_train_path("discrete", state, raws, train_step,
                                     dev, cfg, DISCRETE_PER_STEP, out_dir)
    crf_grads = {nm: float(params[nm].grad.abs().max())
                 for nm in ("crf.F", "crf.W", "crf.C")}
    print(f"# discrete: CRF gradients {crf_grads}", flush=True)
    del state, params
    torch.cuda.empty_cache()

    # one state, one pyramid: kernels vs plain versions, and a second kernel
    # step for the run-to-run spread. The built pyramid leaves one K2
    # launch, the CRF's kNN(32), in both steps. K13 may round its exp apart
    # from torch's, so the losses may part in the last bits; the backward
    # differs from the plain one by the order of autograd's atomics and
    # K14's sums
    step_check = small_kernel_vs_plain_step(
        "discrete", lambda: discrete_state(cfg, dev), raws[0], dev, cfg,
        discrete_plain_pairs(), {**DISCRETE_PER_STEP, "window_knn": 1},
        {"window_knn": 1}, loss_rtol=1e-6,
    )
    torch.cuda.empty_cache()
    return {
        "config": {"model": "BaselineDiscreteCRFSegNet", "batch": b,
                   "points": n, "classes": n_cls, "steps": cfg.steps,
                   "label_offset": cfg.label_offset},
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogq": d_logq,
        "forward_bit_equal": fwd_bit_equal,
        "argmax_agreement": agree,
        "serve_peak_gib": serve_peak,
        "kernel_busy_ms": serve_busy,
        "profile": serve_profile[:40],
        **train,
        "crf_grad_max": crf_grads,
        "kernel_vs_plain_step": step_check,
        "calls_per_request": DISCRETE_PER_REQUEST,
        "calls_per_step": DISCRETE_PER_STEP,
    }


# --------------------------------------------------------------------------
# Semantic3D serving: the flagship at B16 x 65536, the strided fused conv
# --------------------------------------------------------------------------


def semantic3d_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 15: adds the Semantic3D request's kernel phases to ``results``
    and its main path's launches; returns its measurements."""
    from crfconv_tpu_torch import Predictor, PointConvResNet, cuda_build
    from crfconv_tpu_torch.models import point_conv_big
    from crfconv_tpu_torch.ops import conv
    from crfconv_tpu_torch.serve import SERVING_MODE
    from crfconv_tpu_torch.train.config import Semantic3DConfig

    cfg = Semantic3DConfig()
    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(SEED + 13)
    model = randomize_batch_norms(
        PointConvResNet(n_cls, cfg.in_channels, use_crf=True, steps=cfg.steps,
                        device=dev, generator=gen), gen)
    predictor = Predictor(model, device=dev, seed=SEED)

    def cloud():
        pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32),
                              device=dev)
        feats = torch.as_tensor(
            rng.random((b, n, cfg.in_channels), dtype=np.float32),
            device=dev)
        return pos, feats

    sites = {**call_sites(), "point_conv_fused_strided": (
        point_conv_big, "point_conv_fused_strided",
        conv.point_conv_fused_strided, conv.point_conv_fused_strided_plain)}
    pos, feats = cloud()
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(sites, lambda: predictor.predict_logits(pos, feats))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, got in calls.items():
        per = SEMANTIC3D_PER_REQUEST[name]
        expect(len(got) == per, f"semantic3d {name}: {len(got)} calls per "
               f"request, expected {per}")
    strided_rows = sorted((a[3].shape[1], a[0].shape[2], a[4].shape[2])
                          for a, _ in calls["point_conv_fused_strided"])
    run_phases(results, "semantic3d serve", sites, calls)
    del calls
    torch.cuda.empty_cache()

    reqs = [cloud() for _ in range(SEMANTIC3D_REQUESTS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat = []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        logits = predictor.predict_logits(p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        expect(tuple(logits.shape) == (b, n, n_cls),
               f"semantic3d logits shape {tuple(logits.shape)}")
        expect(bool(torch.isfinite(logits).all()),
               "semantic3d: non-finite logits")
        del logits
    record_launches("semantic3d serve", cuda_build.launch_counts(),
                    SEMANTIC3D_PER_REQUEST, SEMANTIC3D_REQUESTS, "requests")
    pts_s = SEMANTIC3D_REQUESTS * b * n / sum(lat)
    print(f"# semantic3d: served {SEMANTIC3D_REQUESTS} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s; "
          f"K5 on (rows, hidden, rider) {strided_rows}", flush=True)

    p_, f_ = reqs[0]

    def pyramid():
        return predictor.prepare(p_, f_)

    batch, _ = pyramid()
    with torch.inference_mode():
        pyramid_ms = median_ms(pyramid, runs=5)
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=5)
        request_ms = median_ms(lambda: predictor.predict_logits(p_, f_),
                               runs=5)
        got = model(batch, SERVING_MODE)
        with patched([(m, a, pl) for m, a, _, pl in sites.values()]):
            ref = model(batch, SERVING_MODE)
            plain_forward_ms = median_ms(lambda: model(batch, SERVING_MODE),
                                         runs=3, warmup=1)
    torch.cuda.synchronize()
    d_logit = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # K3/K4/K5 sum in another order than the plain matmuls (~1e-6 relative
    # per layer), carried through 20 layers: 1e-6 of the largest logit was
    # measured on the H100, so 1e-4 leaves a hundredfold
    expect(d_logit <= 1e-4 * scale,
           f"semantic3d kernel vs plain forward: max |dlogit| {d_logit}")
    expect(agree >= 0.999, f"semantic3d argmax agreement {agree}")
    print(f"# semantic3d forward kernels vs plain: max |dlogit| "
          f"{d_logit:.3g} (max |logit| {scale:.3g}), argmax agreement "
          f"{agree}", flush=True)
    print(f"# semantic3d one request: {request_ms:.3f} ms (pyramid "
          f"{pyramid_ms:.3f} ms, forward {forward_ms:.3f} ms; plain-version "
          f"forward {plain_forward_ms:.3f} ms); peak memory of a request "
          f"{peak:.2f} GiB", flush=True)
    del got, ref, batch
    with torch.inference_mode():
        profile_rows, busy = profile_phase(
            "semantic3d profiler", lambda: predictor.predict_logits(p_, f_),
            os.path.join(out_dir, "chip_smoke_semantic3d_trace.json"),
            "request", request_ms,
        )
    del predictor, model, reqs
    torch.cuda.empty_cache()
    return {
        "config": {"model": "PointConvResNet", "batch": b, "points": n,
                   "classes": n_cls, "steps": cfg.steps},
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogit": d_logit,
        "argmax_agreement": agree,
        "peak_gib": peak,
        "strided_calls": strided_rows,
        "kernel_busy_ms": busy,
        "profile": profile_rows[:40],
        "calls_per_request": SEMANTIC3D_PER_REQUEST,
    }


# --------------------------------------------------------------------------
# the exact regime: K6 under the device kNN; the windowed 2-view eval
# --------------------------------------------------------------------------


def self_share(scales) -> float:
    """The least share, over the scales, of rows whose column 0 is the row
    itself (a TF32 cross term would move the self-distance off 0)."""
    shares = []
    for s in scales:
        rows = torch.arange(s.neighbor_idx.shape[1], device=s.neighbor_idx.device)
        shares.append(float((s.neighbor_idx[:, :, 0] == rows).float().mean()))
    return min(shares)


def exact_serve_path(label, make_request, serve, n_requests, expected,
                     check_out, out_dir):
    """An exact-regime serving path: a recorded warm-up request whose K6
    calls are held against the plain version, then ``n_requests`` requests
    with exact launch counts, column 0 == self, ``check_out`` on each
    output, request / pyramid / forward times, a kernel-vs-plain forward
    (K6 plain in the forward), a profile and the peak memory. ``serve(pos,
    feats)`` returns (output, scales); ``serve(pos, feats, scales)`` runs
    the forward alone."""
    from crfconv_tpu_torch import cuda_build
    from crfconv_tpu_torch.ops import neighbors, windowed

    # the site through which knn_bruteforce reaches K6
    sites = {"select_min_k": (neighbors, "select_min_k", windowed.select_min_k,
                              windowed.select_min_k_plain)}
    pos, feats = make_request()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(sites, lambda: serve(pos, feats))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = len(calls["select_min_k"])
    expect(got == expected["select_min_k"],
           f"{label}: {got} K6 calls per request, expected "
           f"{expected['select_min_k']}")
    results = {}
    PACKED_CHECKED.clear()
    run_phases(results, f"{label} serve", sites, calls)
    packed = sorted(set(PACKED_CHECKED))
    del calls
    torch.cuda.empty_cache()

    reqs = [make_request() for _ in range(n_requests)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat, outs = [], []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        out, scales = serve(p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append((out, self_share(scales)))
        del scales
    record_launches(f"{label} serve", cuda_build.launch_counts(),
                    only(expected), n_requests, "requests")
    shares = [sh for _, sh in outs]
    expect(min(shares) >= 0.999, f"{label}: column 0 is self on only "
           f"{min(shares)} of a scale's rows")
    for out, _ in outs:
        check_out(out)
    del outs
    b, n = reqs[0][0].shape[:2]
    pts_s = n_requests * b * n / sum(lat)
    print(f"# {label}: served {n_requests} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s; "
          f"column 0 == self on >= {min(shares)} of every scale's rows; "
          f"peak memory of a request {peak:.2f} GiB", flush=True)

    p_, f_ = reqs[0]
    _, scales = serve(p_, f_)
    with torch.inference_mode():
        pyramid_ms = median_ms(lambda: serve.pyramid(p_), runs=5)
        forward_ms = median_ms(lambda: serve(p_, f_, scales), runs=5)
        request_ms = median_ms(lambda: serve(p_, f_), runs=5)
        got_out = serve(p_, f_, scales)
        with patched([(neighbors, "select_min_k",
                       windowed.select_min_k_plain)]):
            ref_out = serve(p_, f_, scales)
    torch.cuda.synchronize()
    d_out = float((got_out - ref_out).abs().max())
    scale = float(ref_out.abs().max())
    # the forward's only kernel in the exact regime is K6 (the discrete
    # CRF's kNN(32)), bit-equal to its plain version
    expect(d_out <= 1e-5 * max(1.0, scale),
           f"{label} kernel vs plain forward: max |d| {d_out}")
    print(f"# {label} one request: {request_ms:.3f} ms (pyramid "
          f"{pyramid_ms:.3f} ms, forward {forward_ms:.3f} ms); forward "
          f"kernels vs plain max |d| {d_out:.3g} (max |out| {scale:.3g})",
          flush=True)
    del got_out, ref_out, scales
    with torch.inference_mode():
        profile, busy = profile_phase(
            f"{label} profiler", lambda: serve(p_, f_),
            os.path.join(out_dir, f"chip_smoke_{label}_trace.json"),
            "request", request_ms,
        )
    torch.cuda.empty_cache()
    return results, {
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "max_abs_dforward": d_out,
        "self_share_min": min(shares),
        "packed_checked_widths": packed,
        "peak_gib": peak,
        "kernel_busy_ms": busy,
        "profile": profile[:40],
        "calls_per_request": only(expected),
    }


class ExactServer:
    """A request of the exact regime: build_pyramid_device on the card (its
    subsample drawn from a generator seeded with SEED, as the Predictor
    seeds its own), then the forward in NeighborMode("exact"), under
    inference_mode; ``head`` picks the served output."""

    def __init__(self, model, dev, kernel_sizes=None, ratios=None, k_up=1,
                 head=None):
        self.model, self.dev, self.k_up, self.head = model, dev, k_up, head
        self.pyr_kw = {}
        if kernel_sizes is not None:
            self.pyr_kw = {"kernel_sizes": kernel_sizes, "ratios": ratios}

    def pyramid(self, pos):
        from crfconv_tpu_torch import build_pyramid_device

        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        return build_pyramid_device(pos, k_up=self.k_up, generator=gen,
                                    device=self.dev, **self.pyr_kw)

    def __call__(self, pos, feats, scales=None):
        from crfconv_tpu_torch.data.batch import PointBatch

        with torch.inference_mode():
            built = scales is None
            if built:
                scales = self.pyramid(pos)
            out = self.model(PointBatch(x=feats, y=None, scales=scales),
                             EXACT)
            if self.head is not None:
                out = out[self.head]
            return (out, scales) if built else out


def exact_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 16-17: the flagship's exact serving and train step; adds K6's
    phases to ``results``; returns the measurements."""
    from crfconv_tpu_torch import (
        build_pyramid_device, cuda_build, make_eval_step, make_train_step,
    )
    from crfconv_tpu_torch.data.batch import PointBatch

    model = make_model(dev)

    def check_logits(logits):
        expect(tuple(logits.shape) == (B, N, N_CLASSES),
               f"exact logits shape {tuple(logits.shape)}")
        expect(bool(torch.isfinite(logits).all()), "exact: non-finite logits")

    serve = ExactServer(model, dev)
    phases, serving = exact_serve_path(
        "exact", lambda: request(rng, dev), serve, EXACT_REQUESTS,
        EXACT_PER_REQUEST, check_logits, out_dir)
    for name, r in phases.items():
        results.setdefault(name, []).extend(r)
    del model, serve
    torch.cuda.empty_cache()

    # 17. the train step on a pyramid built once, as the reference's exact
    # train bench builds it
    state = make_train_state(dev)
    raw = train_batch(rng, dev)
    scales = build_pyramid_device(
        raw.pos, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    batch = PointBatch(x=raw.x, y=raw.y, scales=scales)
    train_step = make_train_step(EXACT, windowed=False)
    train_step(state, batch, step_generator(dev, 0))     # warm-up
    params = dict(state.model.named_parameters())
    before = snapshot(state.model)
    gens = [step_generator(dev, 1 + i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    step_s, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = train_step(state, batch, gens[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        expect(np.isfinite(losses[-1]), f"exact step {i}: loss {losses[-1]}")
        bad = [nm for nm, p in params.items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.any())]
        expect(not bad, f"exact step {i}: no, non-finite or all-zero "
               f"gradient {bad[:4]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    record_launches("exact train", cuda_build.launch_counts(),
                    only({"leaky_relu_bwd": FLAGSHIP_LEAKY_PER_STEP}),
                    TRAIN_STEPS, "steps")
    after = snapshot(state.model)
    still = [nm for nm in params if torch.equal(before[nm], after[nm])]
    expect(not still, f"exact: parameters that did not move: {still[:4]}")
    pts_s = TRAIN_STEPS * B * N / sum(step_s)
    gen = step_generator(dev, 50)
    step_ms = median_ms(lambda: train_step(state, batch, gen), runs=3,
                        warmup=1)
    split = np.median([step_phases_ms(state, batch, gen, mode=EXACT)
                       for _ in range(3)], axis=0)
    print(f"# exact: trained {TRAIN_STEPS} steps of {B}x{N} on one pyramid: "
          f"{[round(t * 1e3, 3) for t in step_s]} ms, {pts_s:.1f} points/s, "
          f"loss {[round(v, 5) for v in losses]}, peak memory {peak:.2f} GiB;"
          f" one step {step_ms:.3f} ms (events, median of 3), phases "
          f"forward+loss {split[1]:.3f}, backward {split[2]:.3f}, optimizer "
          f"{split[3]:.3f} ms", flush=True)
    profile, busy = profile_phase(
        "exact train profiler", lambda: train_step(state, batch, gen),
        os.path.join(out_dir, "chip_smoke_exact_train_trace.json"), "step",
        step_ms,
    )
    cuda_build.reset_launch_counts()
    ev = make_eval_step(EXACT, windowed=False)(state, batch)
    torch.cuda.synchronize()
    expect(not any(cuda_build.launch_counts().values()),
           f"exact eval launched {cuda_build.launch_counts()}")
    probs = ev["probs"]
    expect(tuple(probs.shape) == (B, N, N_CLASSES)
           and bool(torch.isfinite(probs).all())
           and float((probs.sum(-1) - 1).abs().max()) <= 1e-5,
           "exact eval: probabilities not finite or not normalised")
    print(f"# exact eval step: loss {float(ev['loss']):.5f}", flush=True)
    del state, batch, scales, ev
    torch.cuda.empty_cache()
    return {
        "config": {"model": "PointConvResNet", "batch": B, "points": N,
                   "classes": N_CLASSES, "steps": 1, "mode": "exact"},
        **serving,
        "train_steps_ms": [t * 1e3 for t in step_s],
        "train_points_per_s": pts_s,
        "train_losses": losses,
        "train_step_ms": step_ms,
        "train_phases_ms": dict(zip(
            ("pyramid", "forward_loss", "backward", "optimizer"),
            map(float, split))),
        "train_peak_gib": peak,
        "train_kernel_busy_ms": busy,
        "train_profile": profile[:40],
    }


def two_view_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 18: the windowed 2-view eval of the flagship at B8 x 8192;
    adds K1's phase on the eval's recorded calls to ``results``."""
    from crfconv_tpu_torch import TrainState, cuda_build, make_eval_step
    from crfconv_tpu_torch.models import crf_conv, point_conv_big
    from crfconv_tpu_torch.ops import conv, crf_sim, neighbors, windowed
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    state = TrainState.create(make_model(dev), lr=LR)
    raw = train_batch(rng, dev)
    eval_step = make_eval_step(TRAIN_MODE, eval_views=2)

    def run():
        return eval_step(state, raw, step_generator(dev, 300))

    # warm-up, recording K1's calls of one eval
    sites = {"windowed_gather": call_sites()["windowed_gather"]}
    calls = record_calls(sites, run)
    torch.cuda.synchronize()
    n_k1 = len(calls["windowed_gather"])
    expect(n_k1 == TWO_VIEW_PER_EVAL["windowed_gather"],
           f"two-view eval: {n_k1} K1 calls, expected "
           f"{TWO_VIEW_PER_EVAL['windowed_gather']}")
    run_phases(results, "two-view eval", sites, calls)
    del calls
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    record_launches("two-view eval", cuda_build.launch_counts(),
                    only(TWO_VIEW_PER_EVAL), 1, "evals")
    probs = got["probs"]
    norm = float((probs.sum(-1) - 1).abs().max())
    expect(tuple(probs.shape) == (B, N, N_CLASSES)
           and bool(torch.isfinite(probs).all()) and norm <= 1e-5,
           f"two-view eval: probabilities not finite or off normal by {norm}")
    # K1, K3 and K4 by their plain versions, on the same pyramids (K2, held
    # on its own calls, stays: a last-bit distance tie would move a
    # neighbour, not test the rest)
    plain = [(neighbors, "windowed_gather", windowed.windowed_gather_plain),
             (point_conv_big, "point_conv_fused_infer",
              conv.point_conv_fused_infer_plain),
             (crf_conv, "crf_similarity_message",
              crf_sim.crf_similarity_message_plain)]
    with patched(plain):
        ref = run()
    torch.cuda.synchronize()
    d_probs = float((probs - ref["probs"]).abs().max())
    # the 1-view forward read 7.45e-8 of max|logit| kernels vs plain
    expect(d_probs <= 1e-5, f"two-view eval kernels vs plain: max |dprobs| "
           f"{d_probs}")
    eval_ms = median_ms(run, runs=5)
    print(f"# two-view eval of {B}x{N}: {eval_ms:.3f} ms (events, median of "
          f"5; host {host_ms:.3f} ms), probabilities off normal by "
          f"{norm:.3g}, kernels vs plain max |dprobs| {d_probs:.3g}, loss "
          f"{float(got['loss']):.5f}", flush=True)
    profile, busy = profile_phase(
        "two-view profiler", run,
        os.path.join(out_dir, "chip_smoke_two_view_trace.json"), "eval",
        eval_ms,
    )
    del state, raw, got, ref
    torch.cuda.empty_cache()
    return {
        "eval_ms": eval_ms,
        "points_per_s": B * N / (eval_ms / 1e3),
        "max_abs_dprobs": d_probs,
        "probs_off_normal": norm,
        "kernel_busy_ms": busy,
        "profile": profile[:40],
        "calls_per_eval": only(TWO_VIEW_PER_EVAL),
    }


def discrete_exact_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 19: ScanNet-discrete served in the exact regime."""
    cfg = scannet_config()
    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(SEED + 17)
    model = randomize_batch_norms(discrete_model(cfg, dev), gen)
    with torch.no_grad():   # compatibilities away from the identity
        model.crf.C.add_(0.1 * torch.randn(model.crf.C.shape,
                                           generator=gen).to(dev))

    def check_logq(logq):
        expect(tuple(logq.shape) == (b, n, n_cls),
               f"discrete exact log q shape {tuple(logq.shape)}")
        expect(bool(torch.isfinite(logq).all()),
               "discrete exact: non-finite log q")
        norm = float(torch.logsumexp(logq, -1).abs().max())
        expect(norm <= 1e-4, f"discrete exact: log q off normal by {norm}")

    serve = ExactServer(model, dev, cfg.kernel_sizes, cfg.ratios, cfg.k_up,
                        head=-1)
    phases, serving = exact_serve_path(
        "discrete_exact", lambda: scannet_cloud(cfg, rng, dev), serve,
        DISCRETE_REQUESTS, DISCRETE_EXACT_PER_REQUEST, check_logq, out_dir)
    for name, r in phases.items():
        results.setdefault(name, []).extend(r)
    del model, serve
    torch.cuda.empty_cache()
    return {
        "config": {"model": "BaselineDiscreteCRFSegNet", "batch": b,
                   "points": n, "classes": n_cls, "steps": cfg.steps,
                   "k_up": cfg.k_up, "mode": "exact"},
        **serving,
    }


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import crfconv_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: crfconv_tpu_torch not importable beside {__file__}: "
              f"{e}", file=sys.stderr)
        return 2
    from crfconv_tpu_torch import NeighborMode, Predictor, cuda_build
    from crfconv_tpu_torch.serve import SERVING_MODE

    global EXACT
    EXACT = NeighborMode("exact")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    smi = smi_line()
    print(smi, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    build_s = cuda_build.build(verbose=True)
    print(f"# kernels built in {build_s:.1f} s", flush=True)

    model = make_model(dev)
    predictor = Predictor(model, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED)

    # warm-up request, recording every kernel call of the main path
    sites = call_sites()
    pos, feats = request(rng, dev)
    calls = record_calls(sites, lambda: predictor.predict_logits(pos, feats))
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = EXPECTED_PER_REQUEST[name]
        expect(len(got) == per,
               f"{name}: {len(got)} calls per request, expected {per}")

    # kernel phases: {kernel: [one phase per main path that calls it]}
    results = {}
    run_phases(results, "flagship serve", sites, calls)

    # K2 in exact selection mode on the same recorded calls (the main path
    # selects with packed keys)
    with torch.inference_mode():
        knn, knn_plain = sites["window_knn"][2:]
        for args, _ in calls["window_knn"]:
            exact_args = args[:5] + (True,)
            compare("window_knn", exact_args, knn(*exact_args),
                    knn_plain(*exact_args))
    torch.cuda.synchronize()
    print("# window_knn exact mode checked on the same calls", flush=True)

    # main path: REQUESTS requests through the Predictor
    reqs = [request(rng, dev) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat = []
    outs = []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        logits = predictor.predict_logits(p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(logits)
    record_launches("flagship serve", cuda_build.launch_counts(),
                    EXPECTED_PER_REQUEST, REQUESTS, "requests")
    for logits in outs:
        expect(tuple(logits.shape) == (B, N, N_CLASSES),
               f"logits shape {tuple(logits.shape)}")
        expect(bool(torch.isfinite(logits).all()), "non-finite logits")
        labels = logits.argmax(-1)
        expect(bool(((labels >= 0) & (labels < N_CLASSES)).all()),
               "labels outside [0, 13)")
    pts_s = REQUESTS * B * N / sum(lat)
    print(f"# served {REQUESTS} requests of {B}x{N}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s",
          flush=True)

    # phases of one request: pyramid and forward, CUDA events
    p_, f_ = reqs[0]

    def pyramid():
        return predictor.prepare(p_, f_)

    batch, _ = pyramid()
    with torch.inference_mode():
        pyramid_ms = median_ms(pyramid, runs=10)
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=10)
        request_ms = median_ms(lambda: predictor.predict_logits(p_, f_),
                               runs=10)
        # the same forward through the plain versions, on the same pyramid
        got = model(batch, SERVING_MODE)
        plain_pairs = [(m, a, pl) for m, a, _, pl in sites.values()]
        with patched(plain_pairs):
            ref = model(batch, SERVING_MODE)
            plain_forward_ms = median_ms(
                lambda: model(batch, SERVING_MODE), runs=5, warmup=1
            )
    torch.cuda.synchronize()
    d_logit = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    argmax_agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # tolerance: K3/K4 sum in another order than the plain matmuls
    # (~1e-6 relative per layer), carried through 20 layers; 4e-7 of the
    # largest logit was measured on the H100, so 1e-4 leaves a hundredfold
    expect(d_logit <= 1e-4 * scale,
           f"kernel vs plain forward: max |dlogit| {d_logit} (scale {scale})")
    expect(argmax_agree >= 0.999, f"argmax agreement {argmax_agree}")
    print(f"# forward kernels vs plain: max |dlogit| {d_logit:.3g} "
          f"(max |logit| {scale:.3g}), argmax agreement {argmax_agree}",
          flush=True)
    print(f"# one request: {request_ms:.3f} ms (pyramid {pyramid_ms:.3f} ms, "
          f"forward {forward_ms:.3f} ms; plain-version forward "
          f"{plain_forward_ms:.3f} ms)", flush=True)

    with torch.inference_mode():
        profile_rows, busy_ms = profile_phase(
            "profiler", lambda: predictor.predict_logits(p_, f_),
            os.path.join(out_dir, "chip_smoke_trace.json"), "request",
            request_ms,
        )

    train = train_phases(dev, rng, out_dir, results)
    torch.cuda.empty_cache()
    scannet = scannet_phases(dev, rng, out_dir, results)
    torch.cuda.empty_cache()
    discrete = discrete_phases(dev, rng, out_dir, results)
    semantic3d = semantic3d_phases(dev, rng, out_dir, results)
    torch.cuda.empty_cache()
    exact = exact_phases(dev, rng, out_dir, results)
    two_view = two_view_phase(dev, rng, out_dir, results)
    discrete_exact = discrete_exact_phase(dev, rng, out_dir, results)

    # launches: the sum over the eleven main paths (flagship serve and
    # train, ScanNet serve and train, ScanNet-discrete serve and train,
    # Semantic3D serve, flagship exact serve and train, the 2-view eval,
    # ScanNet-discrete exact serve). The times are those of the first path
    # whose calls were held against the plain version; every path's are in
    # "phases", and max_abs_err is the largest over them
    kernels = []
    for name in REPLACES:
        phases = results[name]
        r = {k: v for k, v in phases[0].items()
             if k not in ("path", "calls", "max_abs_ref", "of_bound",
                          "host_split_us", "plan", "device_kernels")}
        r["max_abs_err"] = max(p["max_abs_err"] for p in phases)
        r["launches"] = sum(LAUNCHES[name].values())
        r["launches_by_path"] = LAUNCHES[name]
        r["timed_on"] = phases[0]["path"]
        if name in BIT_EQUAL:
            r["bit_equal"] = BIT_EQUAL[name]
        r["calls_per_run"] = phases[0]["calls"]
        r["phases"] = [
            {k: p[k] for k in ("path", "calls", "max_abs_err", "max_abs_ref",
                               "ms", "device_ms", "host_us", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "library_device_ms", "of_bound",
                               "host_split_us", "plan", "device_kernels")}
            for p in phases
        ]
        kernels.append(r)
    summary = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "build_s": build_s,
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogit": d_logit,
        "argmax_agreement": argmax_agree,
        "kernels": kernels,
        "kernel_busy_ms": busy_ms,
        "profile": profile_rows[:40],
        **train,
        "scannet": scannet,
        "discrete": discrete,
        "semantic3d": semantic3d,
        "exact": exact,
        "two_view": two_view,
        "discrete_exact": discrete_exact,
        "gather_bwd_checks": {
            path: {"calls": c, "reruns_bit_identical": r,
                   "bit_equal_to_cpu_plain": e}
            for path, (c, r, e) in BWD_CHECKS.items()},
        "reverse_step_checks": {
            key: {"calls": c, "reruns_bit_identical": r, "cpu_checked": k,
                  "bit_equal_to_cpu_plain": e}
            for key, (c, r, k, e) in REVERSE_CHECKS.items()},
        "failures": FAILURES,
        "script_s": time.perf_counter() - t_start,
    }
    print(f"# chip_smoke.py took {summary['script_s']:.1f} s", flush=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(summary, fh, indent=1)

    if FAILURES:
        print(f"FAIL: {len(FAILURES)} checks failed", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

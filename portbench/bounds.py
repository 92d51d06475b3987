"""The least time of each kernel call: a frozen copy of the port's
``chip_smoke.py::bound_of`` and its peaks.

A call's bound is the larger of its bytes over the card's memory bandwidth
(each input byte read once, each output byte written once) and the
operations its inputs need over the float32 peak, in ms. The shapes come
from the calls the program's kernel wrappers receive: ``WRAPPERS`` names,
for each kernel, the module and attribute of the wrapper whose arguments
``bound_of`` reads (``tracing.KernelRecorder`` wraps them).
"""

from __future__ import annotations

import torch

from portbench.reference.pyramid import window_starts

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM float32, outside the tensor cores

_OPS = "crfconv_tpu_torch.ops."
WRAPPERS = {
    "windowed_gather": (_OPS + "windowed", "_windowed_gather_launch"),
    "window_knn": (_OPS + "windowed", "window_knn"),
    "point_conv_fused_infer": (_OPS + "conv", "point_conv_fused_infer"),
    "point_conv_fused_strided": (_OPS + "conv", "point_conv_fused_strided"),
    "crf_similarity_message": (_OPS + "crf_sim", "crf_similarity_message"),
    "windowed_weighted_reduce": (_OPS + "windowed",
                                 "windowed_weighted_reduce"),
    "windowed_gather_bwd": (_OPS + "windowed", "windowed_gather_bwd"),
    "leaky_relu_bwd": (_OPS + "activation", "leaky_relu_bwd"),
    "crf_operator": (_OPS + "crf_core", "crf_operator"),
    "crf_iterate": (_OPS + "crf_core", "crf_iterate_steps"),
    "crf_iterate_bwd": (_OPS + "crf_core", "crf_iterate_bwd"),
    "crf_neighbor_dot": (_OPS + "crf_core", "crf_neighbor_dot"),
    "select_min_k": (_OPS + "windowed", "select_min_k"),
}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound_of(name, args, out, kwargs=None):
    outs = out if isinstance(out, tuple) else (out,)
    in_bytes = nbytes(*args)
    if name == "windowed_gather":
        ops = 0
    elif name == "window_knn":
        pos, k = args[0], args[1]
        q = args[2] if len(args) > 2 and args[2] is not None else pos
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
        # the message (2 K H a row) and the apply (2 H^2) a step (K10 runs
        # args[5] steps); the backward adds the scatter (2 K H), dM (2 H^2)
        # and dzp (H)
        per_row = 2 * k * h + 2 * h * h
        ops = b * n * (per_row * args[5] if name == "crf_iterate"
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
    elif name == "discrete_iterate":
        # every step's message (2 L a kept slot), L x L product (2 L^2) and
        # softmax (~5 L a row); p, u, w, col, C read, q_steps (and the
        # stacks) written once
        p_, col_, steps = args[0], args[3], args[5]
        b, n, l = p_.shape
        slots = int((col_ >= 0).sum())
        ops = steps * (2 * slots * l + b * n * (2 * l * l + 5 * l))
    elif name == "discrete_iterate_bwd":
        # every reverse step's transpose (2 L a term of the plan), dmsg and
        # dC (2 L^2 each) and dot, dz, du (~5 L a row); g, q_1..q_steps, the
        # msg stack, C and the plan (S~^T by rows, encoding w and col) read,
        # dp, the dmsg stack, du and dC written once
        g_, qs_, plan = args[0], args[1], kwargs.get("plan")
        steps, b, n, l = qs_.shape
        terms = (int(plan.row_ptr[-1]) if plan is not None
                 else int((args[5] >= 0).sum()))
        ops = steps * (2 * terms * l + b * n * (4 * l * l + 5 * l))
        in_bytes = (nbytes(g_, qs_[1:], args[2], args[3], args[6])
                    + 4 * (b * n + 1) + 8 * terms)
    else:  # crf_similarity_message
        y, idx = args[0], args[2]
        b, n, h = y.shape
        ops = b * n * idx.shape[2] * (5 * h + 4)
    t_bytes = (in_bytes + nbytes(*outs)) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

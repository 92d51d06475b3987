"""The discrete CRF's mean-field core at steps >= 2, fused (kernels K13 and
K14, over K9 and K12 of the continuous core).

Counterpart of the discrete half of ``crfconv_tpu/ops/crf_pallas.py``
(``discrete_crf_core``). Each step of the CRF-as-RNN update

    q_{t+1} = softmax(-u - (S~ q_t) C),    q_0 = p,

reads the loop-invariant sparse operator S~ whose row m holds w[m, k] at
column clamp(idx[m, k]) (K9, ``crf_core.crf_operator``: K1's window clamp,
a clamped row outside [0, N) reads zero). :func:`discrete_core` is an
autograd Function over the kernels:

  * K13 ``discrete_iterate``: one step, q_t -> q_{t+1}, optionally writing
    the message msg_t = S~ q_t;
  * K14 ``discrete_iterate_bwd``: one step of the reverse recurrence,
    dz_t = q_{t+1} (lam_{t+1} - <lam_{t+1}, q_{t+1}>), du += dz_t,
    dC += msg_t^T dz_t, dmsg_t = -dz_t C^T, lam_t = S~^T dmsg_t, over
    S~^T's structure built once per backward call (as K11's,
    ``crf_core.ReversePlan``);
  * K12 ``crf_core.crf_neighbor_dot``: dw[m, k] = sum_t <dmsg_t[m],
    q_t[col[m, k]]>, once over the saved stacks.

Each wrapper runs its plain PyTorch version on CPU tensors and its kernel
on CUDA tensors. The plain versions spell out the kernels' sum orders (k,
then j, then l ascending, every product and sum rounded on its own; lam_t's
terms in ascending slot order, as ``index_add_`` adds them on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from crfconv_tpu_torch.cuda_build import DISCRETE_ITERATE, DISCRETE_ITERATE_BWD
from crfconv_tpu_torch.ops._launch import (
    check, check_no_grad, launch_on, on_cuda, ptr, raw_stream, stream,
)
from crfconv_tpu_torch.ops.crf_core import (
    ReversePlan, _apply_rows, _check_operator, _message, _pack25,
    crf_neighbor_dot, crf_operator, crf_operator_plain,
)
from crfconv_tpu_torch.ops.windowed import PAD, TILE

MAX_L = 128   # most classes the kernels take


def _check_rows(name, t, shape):
    check(t, name, torch.float32, len(shape))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_classes(q, w, col, C):
    """The operator's checks of the continuous core, with at most MAX_L
    classes."""
    _check_operator(q, w, col, C)
    if q.shape[-1] > MAX_L:
        raise ValueError(f"{q.shape[-1]} classes > {MAX_L}")


def _row_sum(a: torch.Tensor) -> torch.Tensor:
    """a.sum(-1, keepdim=True), l ascending from zero (the kernels' order)."""
    acc = torch.zeros_like(a[..., :1])
    for l in range(a.shape[-1]):
        acc = acc + a[..., l:l + 1]
    return acc


# ---------------------------------------------------------------------------
# K13: one forward step
# ---------------------------------------------------------------------------


def discrete_iterate(
    q: torch.Tensor, u: torch.Tensor, w: torch.Tensor, col: torch.Tensor,
    C: torch.Tensor, out: torch.Tensor = None, msg_out: torch.Tensor = None,
) -> torch.Tensor:
    """One step q_{t+1} = softmax(-u - (S~ q_t) C): q, u [B, N, L] f32, w
    [B, N, K] f32 (masked slots zero), col [B, N, K] int32
    (``crf_core.crf_operator``), C [L, L] -> [B, N, L], written into ``out``
    when given (never q itself); ``msg_out`` receives msg_t = S~ q_t. Not
    differentiable; the autograd front is :func:`discrete_core`."""
    if not on_cuda(q, u, w, col, C):
        r, msg = _iterate_plain(q, u, w, col, C)
        if msg_out is not None:
            msg_out.copy_(msg)
        return r if out is None else out.copy_(r)
    check_no_grad("discrete_iterate", q, u, w, C)
    check(q, "q", torch.float32, 3)
    _check_rows("u", u, q.shape)
    _check_classes(q, w, col, C)
    if out is None:
        out = torch.empty_like(q)
    else:
        _check_rows("out", out, q.shape)
        if out.data_ptr() == q.data_ptr():
            raise ValueError("out must be a separate tensor from q")
    if msg_out is not None:
        _check_rows("msg_out", msg_out, q.shape)
    B, N, L = q.shape
    msg_ptr = ctypes.c_void_p(None) if msg_out is None else ptr(msg_out)
    with torch.cuda.device(q.device):
        DISCRETE_ITERATE(ptr(q), ptr(u), ptr(w), ptr(col), ptr(C), ptr(out),
                         msg_ptr, B, N, w.shape[2], L, stream(q.device))
    return out


def _iterate_plain(q, u, w, col, C):
    """(q_{t+1}, msg_t) in the kernel's order."""
    msg = _message(q, w, col)
    z = -u - _apply_rows(msg, C)
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return e / _row_sum(e), msg


def discrete_iterate_plain(q, u, w, col, C):
    """Plain PyTorch version of :func:`discrete_iterate` (differentiable by
    autograd in q, u, w and C)."""
    return _iterate_plain(q, u, w, col, C)[0]


# ---------------------------------------------------------------------------
# K14: one step of the reverse recurrence
# ---------------------------------------------------------------------------


def discrete_reverse_plan(col, C, tile: int = TILE,
                          pad: int = PAD) -> ReversePlan:
    """K14's :class:`~crfconv_tpu_torch.ops.crf_core.ReversePlan` for the
    operator's columns ``col`` and C."""
    return ReversePlan(DISCRETE_ITERATE_BWD,
                       "discrete_iterate_bwd_transpose_i32", col, C, tile, pad)


def discrete_iterate_bwd(
    lam: torch.Tensor, qn: torch.Tensor, msg: torch.Tensor, w: torch.Tensor,
    col: torch.Tensor, C: torch.Tensor, du: torch.Tensor, dC: torch.Tensor,
    dmsg_out: torch.Tensor = None, plan: ReversePlan = None,
):
    """The transpose of one :func:`discrete_iterate` step. lam =
    dL/dq_{t+1} [B, N, L], qn = q_{t+1}, msg = msg_t, and the running sums
    du [B, N, L], dC [L, L] -> (lam_t, dmsg_t, du + dz_t, dC + msg_t^T
    dz_t), with dz_t the softmax VJP, dmsg_t = -dz_t C^T and lam_t = S~^T
    dmsg_t. du and dC carry no sign: the gradients into u and C are minus
    their sums. dmsg_t is written into ``dmsg_out`` when given. ``plan``
    (:func:`discrete_reverse_plan` of col and C) is built here when not
    given. The kernel is deterministic: lam_t is bit-equal to the plain
    version run on the CPU, and dC adds its partials in a fixed order."""
    if not on_cuda(lam, qn, msg, w, col, C, du, dC):
        return discrete_iterate_bwd_plain(lam, qn, msg, w, col, C, du, dC,
                                          dmsg_out)
    check_no_grad("discrete_iterate_bwd", lam, qn, msg, w, C, du, dC)
    check(lam, "lam", torch.float32, 3)
    for name, t in (("qn", qn), ("msg", msg), ("du", du)):
        _check_rows(name, t, lam.shape)
    _check_classes(lam, w, col, C)
    L = lam.shape[-1]
    _check_rows("dC", dC, (L, L))
    if dmsg_out is None:
        dmsg_out = torch.empty_like(lam)
    else:
        _check_rows("dmsg_out", dmsg_out, lam.shape)
    if plan is None:
        plan = discrete_reverse_plan(col, C)
    plan.check(lam, col, C)
    B, N, _ = lam.shape
    lam_out = torch.empty_like(lam)
    du_out = torch.empty_like(du)
    dC_out = torch.empty_like(dC)
    dev = lam.device
    launch_on(dev, DISCRETE_ITERATE_BWD, _pack25(
        lam.data_ptr(), qn.data_ptr(), msg.data_ptr(), w.data_ptr(),
        plan.Wt.data_ptr(), du.data_ptr(), dC.data_ptr(),
        lam_out.data_ptr(), dmsg_out.data_ptr(), du_out.data_ptr(),
        dC_out.data_ptr(), plan.starts.data_ptr(), plan.order, plan.runs,
        plan.rows.data_ptr(), plan.part.data_ptr(), B, N, w.shape[2], L,
        plan.tile, plan.width, plan.front, plan.parts, raw_stream(dev)))
    return lam_out, dmsg_out, du_out, dC_out


def discrete_iterate_bwd_plain(lam, qn, msg, w, col, C, du, dC,
                               dmsg_out=None, plan=None):
    """Plain PyTorch version of :func:`discrete_iterate_bwd`: the reverse
    recurrence written out (not autograd of the loop). ``plan`` is
    ignored."""
    B, N, L = lam.shape
    K = col.shape[2]
    dz = qn * (lam - _row_sum(lam * qn))
    dmsg = -_apply_rows(dz, C.T)
    keep = col >= 0
    rows = (torch.arange(B, device=lam.device)[:, None, None] * N
            + torch.where(keep, col, 0).long())
    src = torch.where(keep[..., None], w[..., None] * dmsg[:, :, None, :],
                      torch.zeros((), dtype=lam.dtype, device=lam.device))
    lam_out = torch.zeros((B * N, L), dtype=lam.dtype, device=lam.device)
    lam_out.index_add_(0, rows.reshape(-1), src.reshape(B * N * K, L))
    dC_out = dC + msg.reshape(-1, L).T @ dz.reshape(-1, L)
    if dmsg_out is not None:
        dmsg = dmsg_out.copy_(dmsg)
    return lam_out.reshape(B, N, L), dmsg, du + dz, dC_out


# ---------------------------------------------------------------------------
# the fused core
# ---------------------------------------------------------------------------


def discrete_core(
    p: torch.Tensor, u: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
    C: torch.Tensor, steps: int, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """q_steps of q_{t+1} = softmax(-u - (S~(w, idx) q_t) C), q_0 = p,
    through the kernels (the plain versions on CPU tensors).
    Differentiable in p, u, w and C; idx gets no gradient. Counterpart of
    ``crfconv_tpu/ops/crf_pallas.py::discrete_crf_core``."""
    if steps < 1:
        raise ValueError(f"steps {steps} < 1")
    # ctx.needs_input_grad ignores grad mode: C is a parameter that needs a
    # gradient even under inference_mode, where serving must save nothing
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (p, u, w, C))
    return _DiscreteCore.apply(p.contiguous(), u.contiguous(), w.contiguous(),
                               C.contiguous(), idx, steps, tile, pad, save)


class _DiscreteCore(torch.autograd.Function):
    """Forward: K9 once, K13 ``steps`` times (saving q_0..q_{steps-1} and
    msg_0..msg_{steps-1} when a gradient is taken). Backward: K14's plan
    once, its step ``steps`` times, K12 once."""

    @staticmethod
    def forward(ctx, p, u, w, C, idx, steps, tile, pad, save):
        col = crf_operator(idx, tile, pad)
        qs = msgs = ping = None
        if save:
            qs = p.new_empty((steps,) + tuple(p.shape))
            msgs = torch.empty_like(qs)
            qs[0].copy_(p)
        else:
            ping = (torch.empty_like(p), torch.empty_like(p))
        q = p
        for t in range(steps):
            if t == steps - 1:
                out = torch.empty_like(p)
            else:
                out = qs[t + 1] if save else ping[t % 2]
            q = discrete_iterate(q, u, w, col, C, out=out,
                                 msg_out=msgs[t] if save else None)
        if save:
            ctx.save_for_backward(w, C, col, qs, msgs, q)
            ctx.geometry = (tile, pad)
        return q

    @staticmethod
    def backward(ctx, g):
        w, C, col, qs, msgs, q_last = ctx.saved_tensors
        steps = qs.shape[0]
        lam = g.contiguous()
        du = torch.zeros_like(lam)
        dC = torch.zeros_like(C)
        dmsgs = torch.empty_like(qs)
        # S~^T's structure, C^T and the workspaces, once for all steps
        plan = (discrete_reverse_plan(col, C, *ctx.geometry) if on_cuda(col)
                else None)
        for t in reversed(range(steps)):
            qn = q_last if t == steps - 1 else qs[t + 1]
            lam, _, du, dC = discrete_iterate_bwd(
                lam, qn, msgs[t], w, col, C, du, dC, dmsg_out=dmsgs[t],
                plan=plan,
            )
        dw = crf_neighbor_dot(dmsgs, qs, col)
        return lam, -du, dw, -dC, None, None, None, None, None


def discrete_core_plain(p, u, w, idx, C, steps, tile=TILE, pad=PAD):
    """:func:`discrete_core` through the plain versions, differentiable by
    autograd (the reference the kernels' Function is held to)."""
    col = crf_operator_plain(idx, tile, pad)
    q = p
    for _ in range(steps):
        q = discrete_iterate_plain(q, u, w, col, C)
    return q

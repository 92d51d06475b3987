"""The discrete CRF's mean-field core at steps >= 2, fused (kernels K13 and
K14, over K9 and K12 of the continuous core).

Counterpart of the discrete half of ``crfconv_tpu/ops/crf_pallas.py``
(``discrete_crf_core``). Each step of the CRF-as-RNN update

    q_{t+1} = softmax(-u - (S~ q_t) C),    q_0 = p,

reads the loop-invariant sparse operator S~ whose row m holds w[m, k] at
column clamp(idx[m, k]) (K9, ``crf_core.crf_operator``: K1's window clamp,
a clamped row outside [0, N) reads zero). :func:`discrete_core` is an
autograd Function over the kernels:

  * K13 ``discrete_iterate_steps``: every step of a call in one launch,
    q_0 -> q_steps, filling the stacks q_0..q_{steps-1} and
    msg_0..msg_{steps-1} (msg_t = S~ q_t) when the backward needs them
    (``discrete_iterate``: one step through the same kernel);
  * K14 ``discrete_iterate_bwd_steps``: every step of the reverse
    recurrence in one launch, dz_t = q_{t+1} (lam_{t+1} - <lam_{t+1},
    q_{t+1}>), du += dz_t, dC += msg_t^T dz_t, dmsg_t = -dz_t C^T, lam_t =
    S~^T dmsg_t, over S~^T by rows built once per backward call
    (:class:`DiscretePlan`; ``discrete_iterate_bwd``: one step);
  * K12 ``crf_core.crf_neighbor_dot``: dw[m, k] = sum_t <dmsg_t[m],
    q_t[col[m, k]]>, once over the saved stacks.

Each wrapper runs its plain PyTorch version on CPU tensors and its kernel
on CUDA tensors. The plain versions spell out the kernels' sum orders (k,
then j, then l ascending, every product and sum rounded on its own; lam_t's
terms in ascending slot order, as ``index_add_`` adds them on the CPU).
"""

from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from crfconv_tpu_torch.cuda_build import DISCRETE_ITERATE, DISCRETE_ITERATE_BWD
from crfconv_tpu_torch.ops._launch import (
    check, check_no_grad, float32_io, launch_on, on_cuda, raw_stream,
    sm_count,
)
from crfconv_tpu_torch.ops.crf_core import (
    _aligned, _apply_rows, _check_operator, _message,
    crf_neighbor_dot, crf_operator, crf_operator_plain,
)
from crfconv_tpu_torch.ops.windowed import PAD, TILE, _geometry, window_starts

MAX_L = 128   # most classes the kernels take
ITERATE_ROWS = 128   # rows of a K13 item
# the kernels' arguments, packed as int64s (cuda_build)
_pack15 = struct.Struct("15q").pack
_pack19 = struct.Struct("19q").pack
_pack24 = struct.Struct("24q").pack


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


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# the rows the kernels stage
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def iterate_span(n: int, rows: int = ITERATE_ROWS, tile: int = TILE,
                 pad: int = PAD) -> int:
    """Most rows of q_t that a K13 item (``rows`` rows of a cloud of ``n``)
    stages: K9 clamps each row's columns into its tile's window, so an
    item's columns lie within the windows of its first and last tile. An
    item whose columns span more (columns clamped with another geometry)
    gathers from global memory."""
    starts, width, _ = window_starts(n, n, tile, pad)
    r0 = np.arange(0, n, rows)
    t0 = r0 // tile
    t1 = (np.minimum(r0 + rows, n) - 1) // tile
    return int(min(n, (starts[t1] - starts[t0] + width).max()))


def reverse_rows(L: int) -> int:
    """Rows of a K14 item: 128, 64 or 32 as L grows, so that its [R, L] dz
    and msg rows and the [L, L] C^T and dC partial fit shared memory."""
    return 128 if L <= 32 else (64 if L <= 64 else 32)


@functools.lru_cache(maxsize=256)
def reverse_span(n: int, rows: int, tile: int = TILE,
                 pad: int = PAD) -> int:
    """Most source rows whose slots land on a K14 item (``rows`` output rows
    of a cloud of ``n``), the rows of dmsg it stages: the slots of the tiles
    whose windows meet the item's rows."""
    starts, width, front = window_starts(n, n, tile, pad)
    r0 = np.arange(0, n, rows)
    r1 = np.minimum(r0 + rows, n)
    t_lo = np.searchsorted(starts, r0 + front - width, side="right")
    t_hi = np.searchsorted(starts, r1 - 1 + front, side="right")
    return int(max((np.minimum(t_hi * tile, n) - t_lo * tile).max(), 0))


# ---------------------------------------------------------------------------
# K13: the forward steps
# ---------------------------------------------------------------------------


def _iterate_launch(p, u, w, col, C, steps, out, qs, msgs, ping) -> None:
    """K13's launch: ``steps`` steps from p into out, through qs[1:] or the
    ping-pong buffers ``ping`` [2 or 1, B, N, L] (None where steps is 1 or
    qs is given), the messages into ``msgs`` when given."""
    B, N, L = p.shape
    states = [t for t in (p, u, out, qs, msgs, ping) if t is not None]
    ping_ptr = (0, 0) if ping is None else (
        ping[0].data_ptr(), ping[ping.shape[0] - 1].data_ptr())
    dev = p.device
    launch_on(dev, DISCRETE_ITERATE, _pack19(
        p.data_ptr(), u.data_ptr(), w.data_ptr(), col.data_ptr(),
        C.data_ptr(), _ptr(qs), _ptr(msgs), *ping_ptr, out.data_ptr(), B, N,
        w.shape[2], L, steps, ITERATE_ROWS, iterate_span(N, ITERATE_ROWS),
        int(L % 4 == 0 and _aligned(*states)), raw_stream(dev)))


def discrete_iterate(
    q: torch.Tensor, u: torch.Tensor, w: torch.Tensor, col: torch.Tensor,
    C: torch.Tensor, out: torch.Tensor = None, msg_out: torch.Tensor = None,
) -> torch.Tensor:
    """One step q_{t+1} = softmax(-u - (S~ q_t) C): q, u [B, N, L] f32, w
    [B, N, K] f32 (masked slots zero), col [B, N, K] int32
    (``crf_core.crf_operator``), C [L, L] -> [B, N, L], written into ``out``
    when given (never q itself); ``msg_out`` receives msg_t = S~ q_t. K13 at
    one step (:func:`discrete_iterate_steps`). Not differentiable; the
    autograd front is :func:`discrete_core`."""
    if not on_cuda(q, u, w, col, C):
        r, msg = _iterate_plain(q, u, w, col, C)
        if msg_out is not None:
            msg_out.copy_(msg)
        return r if out is None else out.copy_(r)
    check_no_grad("discrete_iterate", q, u, w, C)
    _check_iterate(q, u, w, col, C)
    if out is None:
        out = torch.empty_like(q)
    else:
        _check_rows("out", out, q.shape)
        if out.data_ptr() == q.data_ptr():
            raise ValueError("out must be a separate tensor from q")
    if msg_out is not None:
        _check_rows("msg_out", msg_out, q.shape)
    _iterate_launch(q, u, w, col, C, 1, out, None, msg_out, None)
    return out


def _check_iterate(q, u, w, col, C) -> None:
    check(q, "q", torch.float32, 3)
    _check_rows("u", u, q.shape)
    _check_classes(q, w, col, C)


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


def discrete_iterate_steps(
    p: torch.Tensor, u: torch.Tensor, w: torch.Tensor, col: torch.Tensor,
    C: torch.Tensor, steps: int, qs: torch.Tensor = None,
    msgs: torch.Tensor = None,
) -> torch.Tensor:
    """q_steps of q_{t+1} = softmax(-u - (S~ q_t) C) from q_0 = p, every
    step in one launch of K13; shapes as :func:`discrete_iterate`. With
    ``qs`` [steps, B, N, L], qs[t] = q_t for t < steps; with ``msgs`` (same
    shape), msgs[t] = msg_t (the stacks the backward reads); otherwise the
    steps ping-pong two buffers. Returns q_steps in a new tensor. Not
    differentiable; the autograd front is :func:`discrete_core`."""
    if steps < 1:
        raise ValueError(f"steps {steps} < 1")
    if not on_cuda(p, u, w, col, C):
        return discrete_iterate_steps_plain(p, u, w, col, C, steps, qs, msgs)
    check_no_grad("discrete_iterate_steps", p, u, w, C)
    _check_iterate(p, u, w, col, C)
    stack = (steps,) + tuple(p.shape)
    for name, t in (("qs", qs), ("msgs", msgs)):
        if t is not None:
            _check_rows(name, t, stack)
    ping = None
    if qs is not None:
        qs[0].copy_(p)
    elif steps > 1:
        ping = torch.empty((min(steps - 1, 2),) + tuple(p.shape),
                           dtype=p.dtype, device=p.device)
    out = torch.empty_like(p)
    _iterate_launch(p, u, w, col, C, steps, out, qs, msgs, ping)
    return out


def discrete_iterate_steps_plain(p, u, w, col, C, steps, qs=None, msgs=None):
    """Plain PyTorch version of :func:`discrete_iterate_steps`: the loop over
    :func:`discrete_iterate_plain` (differentiable by autograd where no
    stack is given)."""
    q = p
    if qs is not None:
        qs[0].copy_(p)
    for t in range(steps):
        q, msg = _iterate_plain(q, u, w, col, C)
        if msgs is not None:
            msgs[t].copy_(msg)
        if qs is not None and t + 1 < steps:
            qs[t + 1].copy_(q)
    return q


# ---------------------------------------------------------------------------
# K14: the reverse steps
# ---------------------------------------------------------------------------


class DiscretePlan:
    """What the reverse steps of one backward call share, built once (one
    launch of K14's plan entry): S~^T by rows for the operator (w, col) —
    each output row's terms (w[m, k], m) over the slots whose column is the
    row, in ascending slot order (K8's tile_inverse over col, a clamped row
    outside [0, N) dropped, then a count, a scan and a fill of the rows) —
    C^T, the rows of an item, the dmsg rows and terms an item stages and
    one [L, L] partial of dC a block."""

    def __init__(self, w, col, C, tile=TILE, pad=PAD):
        check(col, "col", torch.int32, 3)
        check(w, "w", torch.float32, 3)
        B, N, K = col.shape
        L = C.shape[0]
        if B * N * K >= 2 ** 31:
            raise ValueError(f"{B * N * K} slots: the plan counts in int32")
        dev = col.device
        starts, width, front = _geometry(N, N, tile, pad, dev)
        self.geometry = (tile, pad)
        self.shape = (B, N, K, L)
        self.row_ptr = torch.empty(B * N + 1, dtype=torch.int32, device=dev)
        self.terms = torch.empty((B * N * K, 2), dtype=torch.int32,
                                 device=dev)
        self.Ct = C.T.contiguous()
        self.rows = reverse_rows(L)
        self.cap = reverse_span(N, self.rows, tile, pad)
        # terms an item stages at a time: its rows' K slots, the average
        self.tcap = self.rows * K + self.rows * K % 2
        items = B * -(-N // self.rows)
        # a block a item at most, at most 8 blocks of 256 threads an SM
        parts = min(items, 8 * sm_count(dev.index))
        self.part = torch.empty((parts, L, L), dtype=torch.float32,
                                device=dev)
        # tile_inverse's order and runs, and a count a block of 256 rows
        n_order = B * N * K
        n_runs = B * starts.shape[0] * (width + 1)
        scratch = torch.empty(n_order + n_runs + -(-(B * N) // 256),
                              dtype=torch.int32, device=dev)
        order = scratch.data_ptr()
        launch_on(dev, DISCRETE_ITERATE_BWD.call,
                  "discrete_iterate_bwd_plan_i32", _pack15(
                      col.data_ptr(), w.data_ptr(), starts.data_ptr(), order,
                      order + 4 * n_order, order + 4 * (n_order + n_runs),
                      self.row_ptr.data_ptr(), self.terms.data_ptr(), B, N,
                      K, tile, width, front, raw_stream(dev)))

    def check(self, lam, col, C) -> None:
        B, N, L = lam.shape
        if (B, N, col.shape[2], L) != self.shape or C.shape != (L, L):
            raise ValueError(f"plan for {self.shape}, called with lam "
                             f"{tuple(lam.shape)}, col {tuple(col.shape)}")


def discrete_reverse_plan(w, col, C, tile: int = TILE,
                          pad: int = PAD) -> DiscretePlan:
    """K14's :class:`DiscretePlan` for the operator (w, col), with col's
    geometry, and C."""
    return DiscretePlan(w, col, C, tile, pad)


def _bwd_launch(g, qs, q_last, msgs, plan, du_in, dC_in, dmsgs, lam_out,
                du_out, dC_out, steps) -> None:
    B, N, L = g.shape
    states = [t for t in (g, qs, q_last, msgs, du_in, dmsgs, lam_out, du_out)
              if t is not None]
    dev = g.device
    launch_on(dev, DISCRETE_ITERATE_BWD, _pack24(
        g.data_ptr(), _ptr(qs), q_last.data_ptr(), msgs.data_ptr(),
        plan.Ct.data_ptr(), plan.row_ptr.data_ptr(), plan.terms.data_ptr(),
        _ptr(du_in), _ptr(dC_in), dmsgs.data_ptr(), lam_out.data_ptr(),
        du_out.data_ptr(), dC_out.data_ptr(), plan.part.data_ptr(), B, N, L,
        steps, plan.rows, plan.cap, plan.tcap, plan.part.shape[0],
        int(L % 4 == 0 and _aligned(*states)), raw_stream(dev)))


def discrete_iterate_bwd(
    lam: torch.Tensor, qn: torch.Tensor, msg: torch.Tensor, w: torch.Tensor,
    col: torch.Tensor, C: torch.Tensor, du: torch.Tensor, dC: torch.Tensor,
    dmsg_out: torch.Tensor = None, plan: DiscretePlan = None,
):
    """The transpose of one :func:`discrete_iterate` step. lam =
    dL/dq_{t+1} [B, N, L], qn = q_{t+1}, msg = msg_t, and the running sums
    du [B, N, L], dC [L, L] -> (lam_t, dmsg_t, du + dz_t, dC + msg_t^T
    dz_t), with dz_t the softmax VJP, dmsg_t = -dz_t C^T and lam_t = S~^T
    dmsg_t. du and dC carry no sign: the gradients into u and C are minus
    their sums. dmsg_t is written into ``dmsg_out`` when given. ``plan``
    (:func:`discrete_reverse_plan` of w, col and C) is built here when not
    given. K14 at one step (:func:`discrete_iterate_bwd_steps`): lam_t is
    bit-equal to the plain version run on the CPU, and dC adds its
    partials in a fixed order."""
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
        plan = discrete_reverse_plan(w, col, C)
    plan.check(lam, col, C)
    lam_out = torch.empty_like(lam)
    du_out = torch.empty_like(du)
    dC_out = torch.empty_like(dC)
    _bwd_launch(lam, None, qn, msg, plan, du, dC, dmsg_out, lam_out, du_out,
                dC_out, 1)
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


def discrete_iterate_bwd_steps(
    g: torch.Tensor, qs: torch.Tensor, q_last: torch.Tensor,
    msgs: torch.Tensor, w: torch.Tensor, col: torch.Tensor, C: torch.Tensor,
    plan: DiscretePlan = None, dmsgs: torch.Tensor = None,
):
    """The transpose of :func:`discrete_iterate_steps`, every reverse step
    in one launch of K14. g = dL/dq_steps [B, N, L], the forward's stacks qs
    and msgs [steps, B, N, L] and q_last = q_steps -> (dp = lam_0, dmsgs,
    du, dC): dmsgs [steps, B, N, L] holds every dmsg_t (the stack K12
    reads; written into ``dmsgs`` when given), du = sum_t dz_t and dC =
    sum_t msg_t^T dz_t, without their sign. ``plan``
    (:func:`discrete_reverse_plan` of w, col and C) is built here when not
    given.
    Deterministic: dp, dmsgs and du are bit-equal to the plain version run
    on the CPU, dC adds a fixed order of partials."""
    if not on_cuda(g, qs, q_last, msgs, w, col, C):
        return discrete_iterate_bwd_steps_plain(g, qs, q_last, msgs, w, col,
                                                C, dmsgs=dmsgs)
    check_no_grad("discrete_iterate_bwd_steps", g, qs, q_last, msgs, w, C)
    check(g, "g", torch.float32, 3)
    check(qs, "qs", torch.float32, 4)
    steps = qs.shape[0]
    stack = (steps,) + tuple(g.shape)
    _check_rows("qs", qs, stack)
    _check_rows("msgs", msgs, stack)
    _check_rows("q_last", q_last, g.shape)
    _check_classes(g, w, col, C)
    if dmsgs is None:
        dmsgs = torch.empty_like(msgs)
    else:
        _check_rows("dmsgs", dmsgs, stack)
    if plan is None:
        plan = discrete_reverse_plan(w, col, C)
    plan.check(g, col, C)
    dp = torch.empty_like(g)
    du = torch.empty_like(g)
    dC = torch.empty_like(C)
    _bwd_launch(g, qs, q_last, msgs, plan, None, None, dmsgs, dp, du, dC,
                steps)
    return dp, dmsgs, du, dC


def discrete_iterate_bwd_steps_plain(g, qs, q_last, msgs, w, col, C,
                                     plan=None, dmsgs=None):
    """Plain PyTorch version of :func:`discrete_iterate_bwd_steps`: the
    loop of :func:`discrete_iterate_bwd_plain` over t = steps-1 .. 0 from
    du = 0, dC = 0. ``plan`` is ignored."""
    steps = qs.shape[0]
    if dmsgs is None:
        dmsgs = torch.empty_like(msgs)
    lam = g
    du = torch.zeros_like(g)
    dC = torch.zeros_like(C)
    for t in reversed(range(steps)):
        qn = q_last if t == steps - 1 else qs[t + 1]
        lam, _, du, dC = discrete_iterate_bwd_plain(
            lam, qn, msgs[t], w, col, C, du, dC, dmsg_out=dmsgs[t])
    return lam, dmsgs, du, dC


# ---------------------------------------------------------------------------
# the fused core
# ---------------------------------------------------------------------------


@float32_io("p")
def discrete_core(
    p: torch.Tensor, u: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
    C: torch.Tensor, steps: int, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """q_steps of q_{t+1} = softmax(-u - (S~(w, idx) q_t) C), q_0 = p,
    through the kernels (the plain versions on CPU tensors).
    Differentiable in p, u, w and C; idx gets no gradient. Counterpart of
    ``crfconv_tpu/ops/crf_pallas.py::discrete_crf_core``. Narrower floats
    run in float32 and the result takes p's dtype."""
    if steps < 1:
        raise ValueError(f"steps {steps} < 1")
    # ctx.needs_input_grad ignores grad mode: C is a parameter that needs a
    # gradient even under inference_mode, where serving must save nothing
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (p, u, w, C))
    return _DiscreteCore.apply(p.contiguous(), u.contiguous(), w.contiguous(),
                               C.contiguous(), idx, steps, tile, pad, save)


class _DiscreteCore(torch.autograd.Function):
    """Forward: K9 once, K13 once for all ``steps`` steps (saving
    q_0..q_{steps-1} and msg_0..msg_{steps-1} when a gradient is taken).
    Backward: K14's plan once, K14 once for all reverse steps, K12 once."""

    @staticmethod
    def forward(ctx, p, u, w, C, idx, steps, tile, pad, save):
        col = crf_operator(idx, tile, pad)
        qs = msgs = None
        if save:
            qs = p.new_empty((steps,) + tuple(p.shape))
            msgs = torch.empty_like(qs)
        q = discrete_iterate_steps(p, u, w, col, C, steps, qs=qs, msgs=msgs)
        if save:
            ctx.save_for_backward(w, C, col, qs, msgs, q)
            ctx.geometry = (tile, pad)
        return q

    @staticmethod
    def backward(ctx, g):
        w, C, col, qs, msgs, q_last = ctx.saved_tensors
        # S~^T by rows and C^T, once for all steps
        plan = (discrete_reverse_plan(w, col, C, *ctx.geometry)
                if on_cuda(col) else None)
        dp, dmsgs, du, dC = discrete_iterate_bwd_steps(
            g.contiguous(), qs, q_last, msgs, w, col, C, plan=plan)
        dw = crf_neighbor_dot(dmsgs, qs, col, *ctx.geometry)
        return dp, -du, dw, -dC, None, None, None, None, None


@float32_io("p")
def discrete_core_plain(p, u, w, idx, C, steps, tile=TILE, pad=PAD):
    """:func:`discrete_core` through the plain versions, differentiable by
    autograd (the reference the kernels' Function is held to)."""
    col = crf_operator_plain(idx, tile, pad)
    return discrete_iterate_steps_plain(p, u, w, col, C, steps)

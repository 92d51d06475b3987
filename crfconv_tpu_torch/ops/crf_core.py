"""The continuous CRF's mean-field core at steps >= 2, fused (kernels
K9-K12).

Counterpart of the continuous half of ``crfconv_tpu/ops/crf_pallas.py``.
The mean-field step x <- (z + (S x) C)(I + C)^-1 is linear in x:

    x_{t+1} = zp + (S~ x_t) M,    x_0 = z,  zp = z inv,  M = C inv,

with inv = (I + C)^-1 and the loop-invariant sparse operator S~ whose row m
holds s[m, k] at column clamp(idx[m, k]) (K1's window clamp; a clamped row
outside [0, N) reads zero). The small matrices come from
:func:`compat_products`, plain differentiable torch, so the gradient into
c flows by autograd; :func:`crf_core` is an autograd Function over the
kernels:

  * K9  ``crf_operator``: the operator's columns, clamped once per call;
  * K10 ``crf_iterate_steps``: every Jacobi step of a call in one launch,
    x_0 -> x_steps, filling the stack x_0..x_{steps-1} when the backward
    needs it (``crf_iterate``: one step through the same kernel);
  * K11 ``crf_iterate_bwd``: one step of the reverse recurrence,
    dmsg_t = lam_{t+1} M^T, lam_t = S~^T dmsg_t, dzp += lam_{t+1},
    dM += msg_t^T lam_{t+1}, over S~^T's structure built once per backward
    call (:class:`ReversePlan`, K8's tile_inverse over the columns);
  * K12 ``crf_neighbor_dot``: ds[m, k] = sum_t <dmsg_t[m], x_t[col[m, k]]>,
    over the window geometry the operator was clamped with.

Each wrapper runs its plain PyTorch version on CPU tensors and its kernel
on CUDA tensors. The plain versions of K10 and K11 spell out the kernels'
sum orders (k ascending for the message, h ascending for the apply, every
product and sum rounded on its own; lam_t's terms in ascending slot order,
as ``index_add_`` adds them on the CPU), so the two are bit-equal (K11's
lam_t to the plain version run on the CPU).
"""

from __future__ import annotations

import struct

import torch

from crfconv_tpu_torch.cuda_build import (
    CRF_ITERATE, CRF_ITERATE_BWD, CRF_NEIGHBOR_DOT, CRF_OPERATOR,
)
from crfconv_tpu_torch.ops._launch import (
    check, check_no_grad, float32_io, launch_on, on_cuda, raw_stream,
    sm_count,
)
from crfconv_tpu_torch.ops.windowed import (
    PAD, TILE, _clamped_rows, _geometry, window_starts,
)
from crfconv_tpu_torch.utils import profiling

MAX_H = 1024   # widest state the iterate kernels take
# the kernels' arguments, packed as int64s (cuda_build)
_pack10 = struct.Struct("10q").pack
_pack11 = struct.Struct("11q").pack
_pack15 = struct.Struct("15q").pack
_pack16 = struct.Struct("16q").pack
_pack25 = struct.Struct("25q").pack
# blocks of a reverse step's [H, H] partial sums aimed at (four an H100 SM)
_PART_BLOCKS = 528


def spd_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a small SPD matrix via Cholesky, in at least float32."""
    m = m.to(torch.promote_types(m.dtype, torch.float32))
    chol = torch.linalg.cholesky_ex(m).L
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return inv_l.T @ inv_l


def compat_products(c: torch.Tensor):
    """(C, inv, M) = (c^T c, (I + C)^-1, C inv), in at least float32;
    differentiable."""
    c = c.to(torch.promote_types(c.dtype, torch.float32))
    C = c.T @ c
    inv = spd_inverse(torch.eye(C.shape[0], dtype=C.dtype, device=C.device) + C)
    return C, inv, C @ inv


# ---------------------------------------------------------------------------
# K9: the operator's columns
# ---------------------------------------------------------------------------


def crf_operator(
    idx: torch.Tensor, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Same-scale neighbour indices idx [B, N, K] int32 -> the operator's
    columns col [B, N, K] int32: each index clamped into its row's window
    (K1's clamp), -1 where the clamped row lies outside [0, N)."""
    if not on_cuda(idx):
        return crf_operator_plain(idx, tile, pad)
    check(idx, "idx", torch.int32, 3)
    B, N, K = idx.shape
    dev = idx.device
    starts, width, front = _geometry(N, N, tile, pad, dev)
    col = torch.empty_like(idx)
    launch_on(dev, CRF_OPERATOR, _pack10(
        idx.data_ptr(), starts.data_ptr(), col.data_ptr(), B, N, K, tile,
        width, front, raw_stream(dev)))
    return col


def crf_operator_plain(
    idx: torch.Tensor, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`crf_operator`."""
    n = idx.shape[1]
    rows = _clamped_rows(idx, n, tile, pad)
    keep = (rows >= 0) & (rows < n)
    return torch.where(keep, rows, -1).to(torch.int32)


def _gather_cols(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """x [B, N, H] at col [B, N, K] -> [B, N, K, H]; zero where col < 0."""
    B, N, K = col.shape
    keep = col >= 0
    rows = torch.where(keep, col, 0).long().reshape(B, N * K)
    g = x[torch.arange(B, device=x.device)[:, None], rows].reshape(
        B, N, K, x.shape[-1]
    )
    return torch.where(keep[..., None], g, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _message(x: torch.Tensor, s: torch.Tensor, col: torch.Tensor):
    """msg = S~ x, summed k ascending from zero (the kernels' order)."""
    xg = _gather_cols(x, col)
    msg = torch.zeros_like(x)
    for j in range(col.shape[2]):
        msg = msg + s[:, :, j, None] * xg[:, :, j]
    return msg


def _apply_rows(a: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """a @ W, summed h ascending from zero (the kernels' order)."""
    acc = torch.zeros(a.shape[:-1] + W.shape[1:], dtype=a.dtype,
                      device=a.device)
    for h in range(W.shape[0]):
        acc = acc + a[..., h, None] * W[h]
    return acc


# ---------------------------------------------------------------------------
# K10: the forward steps
# ---------------------------------------------------------------------------


def _check_state(name, x, H=None):
    check(x, name, torch.float32, 3)
    if H is not None and x.shape[-1] != H:
        raise ValueError(f"{name}: width {x.shape[-1]} != {H}")


def _check_operator(x, s, col, M):
    B, N, H = x.shape
    check(s, "s", torch.float32, 3)
    check(col, "col", torch.int32, 3)
    check(M, "M", torch.float32, 2)
    if s.shape != col.shape or s.shape[:2] != (B, N):
        raise ValueError(f"x {tuple(x.shape)}, s {tuple(s.shape)}, "
                         f"col {tuple(col.shape)}")
    if M.shape != (H, H):
        raise ValueError(f"M {tuple(M.shape)} for width {H}")
    if not 0 < H <= MAX_H:
        raise ValueError(f"width {H} outside (0, {MAX_H}]")


def _aligned(*ts: torch.Tensor) -> bool:
    """Every tensor starts on a 16-byte boundary (the kernels' float4
    path)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _iterate_launch(z, zp, s, col, M, steps, out, xs, ping) -> None:
    """K10's launch: ``steps`` steps from z into out, through xs[1:] or the
    ping-pong buffers ``ping`` [2 or 1, B, N, H] (None where steps is 1)."""
    B, N, H = z.shape
    states = [z, zp, out] + [t for t in (xs, ping) if t is not None]
    ping_ptr = (0, 0) if ping is None else (
        ping[0].data_ptr(), ping[ping.shape[0] - 1].data_ptr())
    dev = z.device
    launch_on(dev, CRF_ITERATE, _pack16(
        z.data_ptr(), zp.data_ptr(), s.data_ptr(), col.data_ptr(),
        M.data_ptr(), 0 if xs is None else xs.data_ptr(), *ping_ptr,
        out.data_ptr(), B, N, s.shape[2], H, steps, raw_stream(dev),
        int(H % 4 == 0 and _aligned(*states))))


def crf_iterate(
    x: torch.Tensor, zp: torch.Tensor, s: torch.Tensor, col: torch.Tensor,
    M: torch.Tensor, out: torch.Tensor = None,
) -> torch.Tensor:
    """One Jacobi step x_{t+1} = zp + (S~ x_t) M: x, zp [B, N, H] f32,
    s [B, N, K] f32, col [B, N, K] int32 (:func:`crf_operator`), M [H, H]
    -> [B, N, H], written into ``out`` when given (never x itself). K10 at
    one step (:func:`crf_iterate_steps`). Not differentiable; the autograd
    front is :func:`crf_core`."""
    if not on_cuda(x, zp, s, col, M):
        r = crf_iterate_plain(x, zp, s, col, M)
        return r if out is None else out.copy_(r)
    check_no_grad("crf_iterate", x, zp, s, M)
    _check_iterate(x, zp, s, col, M)
    if out is None:
        out = torch.empty_like(x)
    else:
        _check_state("out", out, x.shape[-1])
        if out.shape != x.shape or out.data_ptr() == x.data_ptr():
            raise ValueError("out must be a separate tensor of x's shape")
    _iterate_launch(x, zp, s, col, M, 1, out, None, None)
    return out


def crf_iterate_plain(x, zp, s, col, M):
    """Plain PyTorch version of :func:`crf_iterate` (differentiable by
    autograd in x, zp, s and M)."""
    return zp + _apply_rows(_message(x, s, col), M)


def _check_iterate(x, zp, s, col, M) -> None:
    _check_state("x", x)
    _check_state("zp", zp, x.shape[-1])
    _check_operator(x, s, col, M)
    if zp.shape != x.shape:
        raise ValueError(f"zp {tuple(zp.shape)} != x {tuple(x.shape)}")


def crf_iterate_steps(
    z: torch.Tensor, zp: torch.Tensor, s: torch.Tensor, col: torch.Tensor,
    M: torch.Tensor, steps: int, xs: torch.Tensor = None,
) -> torch.Tensor:
    """x_steps of x_{t+1} = zp + (S~ x_t) M from x_0 = z, every step in one
    launch of K10; shapes as :func:`crf_iterate`. With ``xs`` [steps, B, N,
    H], xs[t] = x_t for t < steps (the stack the backward reads); otherwise
    the steps ping-pong two buffers. Returns x_steps in a new tensor. Not
    differentiable; the autograd front is :func:`crf_core`."""
    if steps < 1:
        raise ValueError(f"steps {steps} < 1")
    if not on_cuda(z, zp, s, col, M):
        return crf_iterate_steps_plain(z, zp, s, col, M, steps, xs)
    check_no_grad("crf_iterate_steps", z, zp, s, M)
    _check_iterate(z, zp, s, col, M)
    ping = None
    if xs is not None:
        check(xs, "xs", torch.float32, 4)
        if xs.shape != (steps,) + tuple(z.shape):
            raise ValueError(f"xs {tuple(xs.shape)} for {steps} steps of "
                             f"{tuple(z.shape)}")
        xs[0].copy_(z)
    elif steps > 1:
        ping = torch.empty((min(steps - 1, 2),) + tuple(z.shape),
                           dtype=z.dtype, device=z.device)
    out = torch.empty_like(z)
    _iterate_launch(z, zp, s, col, M, steps, out, xs, ping)
    return out


def crf_iterate_steps_plain(z, zp, s, col, M, steps, xs=None):
    """Plain PyTorch version of :func:`crf_iterate_steps`: the loop over
    :func:`crf_iterate_plain` (differentiable by autograd where ``xs`` is
    not given)."""
    x = z
    if xs is not None:
        xs[0].copy_(z)
    for t in range(steps):
        x = crf_iterate_plain(x, zp, s, col, M)
        if xs is not None and t + 1 < steps:
            xs[t + 1].copy_(x)
    return x


# ---------------------------------------------------------------------------
# K11: one step of the reverse recurrence
# ---------------------------------------------------------------------------


class ReversePlan:
    """What K11's reverse steps of one backward call share, built once:
    S~^T's structure over the operator's columns col [B, N, K] (K8's
    tile_inverse: each 64-row tile's slots sorted by window row, then by
    slot; a clamped row outside [0, N) is dropped), M^T for M [H, H], a
    workspace row per state row (msg_t) and ``parts`` [H, H] partial sums
    of dM. Its launch counts as one of K11's."""

    def __init__(self, col, W, tile=TILE, pad=PAD):
        check(col, "col", torch.int32, 3)
        B, N, K = col.shape
        H = W.shape[0]
        dev = col.device
        self.starts, self.width, self.front = _geometry(N, N, tile, pad, dev)
        self.tile = tile
        self.geometry = (tile, pad)
        self.shape = (B, N, K, H)
        n_order = B * N * K
        self.index = torch.empty(
            n_order + B * self.starts.shape[0] * (self.width + 1),
            dtype=torch.int32, device=dev)
        self.order = self.index.data_ptr()
        self.runs = self.order + 4 * n_order
        self.Wt = W.T.contiguous()
        self.rows = torch.empty((B * N, H), dtype=torch.float32, device=dev)
        cols = 32 if H <= 32 else (64 if H <= 64 else 128)
        tiles = -(-H // 32) * -(-H // cols)   # outer_partials' output tiles
        self.parts = max(1, min(-(-_PART_BLOCKS // tiles), -(-(B * N) // 64)))
        self.part = torch.empty((self.parts, H, H), dtype=torch.float32,
                                device=dev)
        launch_on(dev, CRF_ITERATE_BWD.call, "crf_iterate_bwd_transpose_i32",
                  _pack11(col.data_ptr(), self.starts.data_ptr(), self.order,
                          self.runs, B, N, K, tile, self.width, self.front,
                          raw_stream(dev)))

    def check(self, lam, col, W) -> None:
        B, N, H = lam.shape
        if (B, N, col.shape[2], H) != self.shape or W.shape != (H, H):
            raise ValueError(f"plan for {self.shape}, called with lam "
                             f"{tuple(lam.shape)}, col {tuple(col.shape)}")


def crf_reverse_plan(col, M, tile: int = TILE, pad: int = PAD) -> ReversePlan:
    """K11's :class:`ReversePlan` for the operator's columns ``col`` and M."""
    return ReversePlan(col, M, tile, pad)


def crf_iterate_bwd(
    lam: torch.Tensor, x: torch.Tensor, s: torch.Tensor, col: torch.Tensor,
    M: torch.Tensor, dzp: torch.Tensor, dM: torch.Tensor,
    dmsg_out: torch.Tensor = None, plan: ReversePlan = None,
):
    """The transpose of one :func:`crf_iterate` step. lam = dL/dx_{t+1}
    [B, N, H], x = x_t, and the running sums dzp [B, N, H], dM [H, H] ->
    (lam_t, dmsg_t, dzp + lam, dM + msg_t^T lam), with dmsg_t = lam M^T,
    lam_t = S~^T dmsg_t and msg_t = S~ x_t. dmsg_t is written into
    ``dmsg_out`` when given. ``plan`` (:func:`crf_reverse_plan` of col and
    M, with col's geometry) is built here when not given. The kernel is
    deterministic: lam_t adds its terms in ascending slot order from +0.0,
    bit-equal to the plain version run on the CPU, and dM its partials in a
    fixed order."""
    if not on_cuda(lam, x, s, col, M, dzp, dM):
        return crf_iterate_bwd_plain(lam, x, s, col, M, dzp, dM, dmsg_out)
    check_no_grad("crf_iterate_bwd", lam, x, s, M, dzp, dM)
    _check_state("lam", lam)
    H = lam.shape[-1]
    for name, t in (("x", x), ("dzp", dzp)):
        _check_state(name, t, H)
        if t.shape != lam.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {tuple(lam.shape)}")
    _check_operator(lam, s, col, M)
    check(dM, "dM", torch.float32, 2)
    if dM.shape != (H, H):
        raise ValueError(f"dM {tuple(dM.shape)} for width {H}")
    if dmsg_out is None:
        dmsg_out = torch.empty_like(lam)
    else:
        _check_state("dmsg_out", dmsg_out, H)
    if plan is None:
        plan = crf_reverse_plan(col, M)
    plan.check(lam, col, M)
    B, N, _ = lam.shape
    lam_out = torch.empty_like(lam)
    dzp_out = torch.empty_like(dzp)
    dM_out = torch.empty_like(dM)
    dev = lam.device
    launch_on(dev, CRF_ITERATE_BWD, _pack25(
        lam.data_ptr(), x.data_ptr(), s.data_ptr(), col.data_ptr(),
        plan.Wt.data_ptr(), dzp.data_ptr(), dM.data_ptr(), lam_out.data_ptr(),
        dmsg_out.data_ptr(), dzp_out.data_ptr(), dM_out.data_ptr(),
        plan.starts.data_ptr(), plan.order, plan.runs, plan.rows.data_ptr(),
        plan.part.data_ptr(), B, N, s.shape[2], H, plan.tile, plan.width,
        plan.front, plan.parts, raw_stream(dev)))
    return lam_out, dmsg_out, dzp_out, dM_out


def crf_iterate_bwd_plain(lam, x, s, col, M, dzp, dM, dmsg_out=None,
                          plan=None):
    """Plain PyTorch version of :func:`crf_iterate_bwd`: the scan's reverse
    recurrence written out (not autograd of the loop). ``plan`` is
    ignored."""
    B, N, H = lam.shape
    K = col.shape[2]
    dmsg = _apply_rows(lam, M.T)
    keep = col >= 0
    rows = (torch.arange(B, device=lam.device)[:, None, None] * N
            + torch.where(keep, col, 0).long())
    src = torch.where(keep[..., None], s[..., None] * dmsg[:, :, None, :],
                      torch.zeros((), dtype=lam.dtype, device=lam.device))
    lam_out = torch.zeros((B * N, H), dtype=lam.dtype, device=lam.device)
    lam_out.index_add_(0, rows.reshape(-1), src.reshape(B * N * K, H))
    msg = _message(x, s, col)
    dM_out = dM + msg.reshape(-1, H).T @ lam.reshape(-1, H)
    if dmsg_out is not None:
        dmsg = dmsg_out.copy_(dmsg)
    return lam_out.reshape(B, N, H), dmsg, dzp + lam, dM_out


def transpose_plain(col: torch.Tensor):
    """S~^T's structure by row, in slot order: (offsets [B*N + 1] int64,
    slots int64), the slots (flat indices into [B, N, K]) whose column is
    row r of batch b lying at slots[offsets[b*N + r]:offsets[b*N + r + 1]],
    ascending; slots with col < 0 are in no row. The CSR that the kernels'
    tile-wise structure (:class:`ReversePlan`) encodes."""
    B, N, K = col.shape
    keep = (col >= 0).reshape(-1)
    dest = (torch.arange(B, device=col.device)[:, None, None] * N
            + col.long()).reshape(-1)[keep]
    slots = torch.arange(B * N * K, device=col.device)[keep]
    order = torch.sort(dest, stable=True).indices
    offsets = torch.zeros(B * N + 1, dtype=torch.int64, device=col.device)
    offsets[1:] = torch.cumsum(torch.bincount(dest, minlength=B * N), 0)
    return offsets, slots[order]


def transpose_sum_plain(offsets, slots, w, dmsg):
    """lam_t = S~^T dmsg over :func:`transpose_plain`'s structure, as the
    kernels sum it: each row's terms w[slot] * dmsg[row of slot], each
    rounded on its own, added in slot order from +0.0. w [B, N, K], dmsg
    [B, N, H] -> [B, N, H]."""
    B, N, K = w.shape
    H = dmsg.shape[-1]
    terms = w.reshape(-1)[slots, None] * dmsg.reshape(B * N, H)[slots // K]
    lengths = offsets[1:] - offsets[:-1]
    out = torch.zeros((B * N, H), dtype=dmsg.dtype, device=dmsg.device)
    for j in range(int(lengths.max()) if lengths.numel() else 0):
        rows = (lengths > j).nonzero()[:, 0]
        out[rows] = out[rows] + terms[offsets[rows] + j]
    return out.reshape(B, N, H)


# ---------------------------------------------------------------------------
# K12: the gradient into the similarity
# ---------------------------------------------------------------------------


def crf_neighbor_dot(
    dmsgs: torch.Tensor, xs: torch.Tensor, col: torch.Tensor,
    tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """ds[b, m, k] = sum_t <dmsgs[t, b, m], xs[t, b, col[b, m, k]]>:
    dmsgs, xs [T, B, N, H] f32, col [B, N, K] int32 -> [B, N, K]; zero where
    col < 0. ``tile`` and ``pad`` are the geometry col was clamped with
    (:func:`crf_operator`): the kernel stages, for each block of
    :func:`neighbor_dot_rows` rows, the xs rows its columns span, at most
    its tiles' windows. Deterministic: every sum runs in one fixed order."""
    if not on_cuda(dmsgs, xs, col):
        return crf_neighbor_dot_plain(dmsgs, xs, col)
    check_no_grad("crf_neighbor_dot", dmsgs, xs)
    check(dmsgs, "dmsgs", torch.float32, 4)
    check(xs, "xs", torch.float32, 4)
    check(col, "col", torch.int32, 3)
    T, B, N, H = xs.shape
    K = col.shape[2]
    if dmsgs.shape != xs.shape or col.shape[:2] != (B, N):
        raise ValueError(f"dmsgs {tuple(dmsgs.shape)}, xs {tuple(xs.shape)}, "
                         f"col {tuple(col.shape)}")
    dev = xs.device
    ds = torch.empty((B, N, K), dtype=xs.dtype, device=dev)
    rows = neighbor_dot_rows(K)
    splits = _neighbor_dot_splits(T, B * -(-N // rows), dev)
    part = (torch.empty((splits, B, N, K), dtype=xs.dtype, device=dev)
            if splits > 1 else None)
    # rows a block's columns may span: the windows of its tiles
    cap = window_starts(N, N, tile, pad)[1] + max(rows - tile, 0)
    launch_on(dev, CRF_NEIGHBOR_DOT, _pack15(
        dmsgs.data_ptr(), xs.data_ptr(), col.data_ptr(), ds.data_ptr(),
        0 if part is None else part.data_ptr(), T, splits, B, N, K, H, cap,
        int(H % 4 == 0 and _aligned(dmsgs, xs)), rows, raw_stream(dev)))
    return ds


def neighbor_dot_rows(k: int) -> int:
    """Rows of a K12 block (csrc/crf_neighbor_dot.cu): 128, four lanes a
    row, where a lane's K sums fit its registers (K <= 16), else 64."""
    return 128 if k <= 16 else 64


def _neighbor_dot_splits(steps: int, blocks: int, device) -> int:
    """Blocks a row tile of K12 splits its steps over: enough for two
    blocks an SM where the clouds have few row tiles (the coarse scales),
    at most one a step."""
    sms = sm_count(device.index)
    return max(1, min(steps, -(-2 * sms // max(blocks, 1))))


def crf_neighbor_dot_plain(dmsgs, xs, col, tile=TILE, pad=PAD):
    """Plain PyTorch version of :func:`crf_neighbor_dot` (the geometry is
    not needed)."""
    ds = torch.zeros(col.shape, dtype=xs.dtype, device=xs.device)
    for t in range(xs.shape[0]):
        ds = ds + (dmsgs[t][:, :, None, :] * _gather_cols(xs[t], col)).sum(-1)
    return ds


# ---------------------------------------------------------------------------
# the fused core
# ---------------------------------------------------------------------------


@float32_io("z")
def crf_core(
    z: torch.Tensor, zp: torch.Tensor, s: torch.Tensor, idx: torch.Tensor,
    M: torch.Tensor, steps: int, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """x_steps of x_{t+1} = zp + (S~(s, idx) x_t) M, x_0 = z, through the
    kernels (the plain versions on CPU tensors). Differentiable in z, zp,
    s and M; idx gets no gradient. Counterpart of
    ``crfconv_tpu/ops/crf_pallas.py::crf_core``. Narrower floats run in
    float32 and the result takes z's dtype. Its steps count in
    ``profiling.crf_steps()`` while spans are on."""
    if steps < 1:
        raise ValueError(f"steps {steps} < 1")
    profiling.count_crf_steps(steps)
    return _CRFCore.apply(z.contiguous(), zp.contiguous(), s.contiguous(),
                          M.contiguous(), idx, steps, tile, pad)


class _CRFCore(torch.autograd.Function):
    """Forward: K9 once, K10 once for all ``steps`` steps (saving
    x_0..x_{steps-1} when a gradient is needed). Backward: K11's plan once,
    its step ``steps`` times, K12 once."""

    @staticmethod
    def forward(ctx, z, zp, s, M, idx, steps, tile, pad):
        col = crf_operator(idx, tile, pad)
        save = any(ctx.needs_input_grad[:4])
        xs = z.new_empty((steps,) + tuple(z.shape)) if save else None
        x = crf_iterate_steps(z, zp, s, col, M, steps, xs=xs)
        if save:
            ctx.save_for_backward(s, M, col, xs)
            ctx.geometry = (tile, pad)
        return x

    @staticmethod
    def backward(ctx, g):
        s, M, col, xs = ctx.saved_tensors
        lam = g.contiguous()
        dzp = torch.zeros_like(lam)
        dM = torch.zeros_like(M)
        dmsgs = torch.empty_like(xs)
        # S~^T's structure, M^T and the workspaces, once for all steps
        plan = crf_reverse_plan(col, M, *ctx.geometry) if on_cuda(col) else None
        for t in reversed(range(xs.shape[0])):
            lam, _, dzp, dM = crf_iterate_bwd(
                lam, xs[t], s, col, M, dzp, dM, dmsg_out=dmsgs[t], plan=plan
            )
        ds = crf_neighbor_dot(dmsgs, xs, col, *ctx.geometry)
        return lam, dzp, ds, dM, None, None, None, None


@float32_io("z")
def crf_core_plain(z, zp, s, idx, M, steps, tile=TILE, pad=PAD):
    """:func:`crf_core` through the plain versions, differentiable by
    autograd (the reference the kernels' Function is held to)."""
    col = crf_operator_plain(idx, tile, pad)
    x = z
    for _ in range(steps):
        x = crf_iterate_plain(x, zp, s, col, M)
    return x

"""The CRF cores' reverse-step transpose and K2's packed key on the CPU.

K11 and K14 form lam_t = S~^T dmsg_t as a segmented sum over S~^T's
structure (the operator's slots grouped by column, in slot order), each
output element written once with its terms added in ascending slot order
from +0.0. Here that structure's plain version (``crf_core.
transpose_plain``, the CSR by row) and its sum (``transpose_sum_plain``)
are held bit-equal to the plain versions' ``index_add_`` on the CPU, over
duplicated indices, clamped rows outside the cloud (column -1), masked
slots, subnormal weights and widths that are no multiple of 4; the cores'
backward through that sum is held to the JAX package's Pallas backward in
interpret mode at the existing tests' tolerances. Last, K2's 32-bit packed
key orders exactly as its 64-bit packed key for windows up to 2048
columns."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.ops import crf_pallas
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu_torch.ops import crf_core, discrete_core, windowed
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _exact_windowed_gather


def _t(a):
    return torch.from_numpy(np.array(a))


def _operator(b, n, k, h, seed, reach, dup=True, masked=True):
    """lam, x, dzp (H wide), s with masked slots, an all-masked row and
    subnormal weights, the operator's columns of indices that reach out of
    their windows (clamped rows outside [0, N) give column -1), and M."""
    rng = np.random.default_rng(seed)
    lam, x, dzp = (rng.standard_normal((b, n, h)).astype(np.float32)
                   for _ in range(3))
    s = rng.random((b, n, k)).astype(np.float32)
    s[:, ::3, k // 2] *= 1e-39                      # subnormal weights
    if masked:
        s[:, :, min(2, k - 1)] = 0.0
        s[:, n // 2] = 0.0
    idx = np.arange(n)[None, :, None] + rng.integers(-reach, reach, (b, n, k))
    if dup:
        idx[:, :, 0] = idx[:, :, -1]
    col = crf_core.crf_operator(_t(idx.astype(np.int32)))
    m = (0.5 * rng.standard_normal((h, h)) / np.sqrt(h)).astype(np.float32)
    return tuple(map(_t, (lam, x, dzp, s))) + (col, _t(m))


OPERATORS = [   # (b, n, k, h, reach): same-scale geometries
    (1, 1, 4, 8, 4),
    (2, 63, 15, 3, 40),        # a partial tile, H = 3
    (1, 200, 9, 20, 500),      # indices far out of their windows
    (2, 300, 16, 32, 300),
    (1, 130, 31, 13, 90),      # K = 31, H = 13
    (1, 257, 15, 256, 90),
]


def test_transpose_structure_is_the_csr_by_row():
    """Each row lists the slots whose column it is, ascending; no slot of
    column -1 appears."""
    *_, col, _ = _operator(2, 150, 7, 4, seed=0, reach=400)
    assert bool((col < 0).any())
    offsets, slots = crf_core.transpose_plain(col)
    flat = col.reshape(-1)
    b_n = col.shape[0] * col.shape[1]
    for row in range(b_n):
        got = slots[offsets[row]:offsets[row + 1]].tolist()
        b, r = divmod(row, col.shape[1])
        want = [int(i) for i in range(flat.numel())
                if i // (col.shape[1] * col.shape[2]) == b and flat[i] == r]
        assert got == want
    assert int(offsets[-1]) == int((col >= 0).sum())


@pytest.mark.parametrize("b,n,k,h,reach", OPERATORS)
def test_transpose_sum_bit_equal_to_index_add(b, n, k, h, reach):
    """K11's lam_t: the segmented sum in slot order is index_add_'s sum on
    the CPU bit for bit (subnormal terms kept)."""
    lam, x, dzp, s, col, m = _operator(b, n, k, h, seed=n + h, reach=reach)
    dM = torch.zeros(h, h)
    lam_t, dmsg, _, _ = crf_core.crf_iterate_bwd_plain(lam, x, s, col, m, dzp,
                                                       dM)
    got = crf_core.transpose_sum_plain(*crf_core.transpose_plain(col), s,
                                       dmsg)
    assert torch.equal(got, lam_t)
    assert bool((got.view(torch.int32) == lam_t.view(torch.int32)).all())


@pytest.mark.parametrize("b,n,k,l,reach", [
    (1, 1, 4, 20, 4), (2, 63, 15, 13, 40), (1, 200, 31, 20, 500),
    (2, 300, 31, 20, 90), (1, 100, 9, 33, 60),
])
def test_discrete_transpose_sum_bit_equal_to_index_add(b, n, k, l, reach):
    """K14's lam_t likewise, with w's zero and subnormal weights."""
    rng = np.random.default_rng(n + l)
    lam, _, _, w, col, _ = _operator(b, n, k, l, seed=n + l, reach=reach)
    q = torch.softmax(_t(2 * rng.standard_normal((b, n, l)).astype(
        np.float32)), -1)
    msg = crf_core._message(q, w, col)
    c = _t((np.eye(l) + 0.1 * rng.standard_normal((l, l))).astype(np.float32))
    du = torch.zeros(b, n, l)
    lam_t, dmsg, _, _ = discrete_core.discrete_iterate_bwd_plain(
        lam, q, msg, w, col, c, du, torch.zeros(l, l))
    got = crf_core.transpose_sum_plain(*crf_core.transpose_plain(col), w,
                                       dmsg)
    assert torch.equal(got, lam_t)


def _via_transpose(plain, w_at):
    """A reverse step whose lam_t is the segmented sum over the transpose
    (the kernels' route) and the rest ``plain``'s; the step's weights and
    columns are its arguments ``w_at`` and ``w_at + 1``."""
    def step(*args, dmsg_out=None, plan=None):
        out = plain(*args, dmsg_out=dmsg_out)
        w, col = args[w_at], args[w_at + 1]
        lam_t = crf_core.transpose_sum_plain(*crf_core.transpose_plain(col),
                                             w, out[1])
        assert torch.equal(lam_t, out[0])
        return (lam_t,) + tuple(out[1:])
    return step


def _continuous_inputs(b, n, h, k, seed):
    rng = np.random.default_rng(seed)
    z, zp = (rng.standard_normal((b, n, h)).astype(np.float32)
             for _ in range(2))
    logits = rng.standard_normal((b, n, k))
    s = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    s[:, :, 2] = 0.0
    s[:, 5] = 0.0
    idx = np.clip(np.arange(n)[None, :, None]
                  + rng.integers(-64, 64, (b, n, k)), 0, n - 1)
    idx[:, :, 1] = idx[:, :, 0]
    m = 0.5 * rng.standard_normal((h, h)) / np.sqrt(h)
    return (z, zp, s.astype(np.float32), idx.astype(np.int32),
            m.astype(np.float32))


def test_crf_core_backward_via_transpose_matches_pallas(monkeypatch):
    """The continuous core's backward with lam_t from the transpose against
    the VJP of the interpret-mode Pallas crf_core (the native backward
    kernels #11 and #12), at tests/test_torch_crf_core.py's tolerance."""
    b, n, h, k, steps = 2, 200, 12, 15, 3
    z, zp, s, idx, m = _continuous_inputs(b, n, h, k, seed=21)
    g = np.random.default_rng(9).standard_normal(z.shape).astype(np.float32)
    monkeypatch.setattr(crf_core, "crf_iterate_bwd",
                        _via_transpose(crf_core.crf_iterate_bwd_plain, 2))
    ts = [_t(a).requires_grad_() for a in (z, zp, s, m)]
    out = crf_core.crf_core(ts[0], ts[1], ts[2], _t(idx), ts[3], steps)
    got = torch.autograd.grad((out * _t(g)).sum(), ts)
    jz, jzp, js, ji, jm = map(jnp.asarray, (z, zp, s, idx, m))
    ref = jax.vjp(lambda a, b_, c, d: crf_pallas.crf_core(
        a, b_, c, ji, d, steps, 64, 128, True), jz, jzp, js, jm)[1](
            jnp.asarray(g))
    for name, a, r in zip(("dz", "dzp", "ds", "dM"), got, ref):
        scale = float(np.abs(np.asarray(r)).max())
        # the hi/lo bfloat16 splits of the Pallas kernel
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_discrete_core_backward_via_transpose_matches_pallas(monkeypatch):
    """The discrete core's backward with lam_t from the transpose against
    the VJP of the interpret-mode Pallas discrete_crf_core (kernel #14), at
    tests/test_torch_discrete.py's tolerance."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    b, n, l, k, steps = 2, 200, 13, 9, 3
    rng = np.random.default_rng(22)
    logits = rng.standard_normal((b, n, l))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    u = -np.log(np.maximum(p, 1e-12))
    w = 0.5 * rng.random((b, n, k))
    w[:, :, 2] = 0.0
    w[:, 5] = 0.0
    idx = np.clip(np.arange(n)[None, :, None]
                  + rng.integers(-64, 64, (b, n, k)), 0, n - 1)
    idx[:, :, 1] = idx[:, :, 0]
    c = np.eye(l) + 0.05 * rng.standard_normal((l, l))
    p, u, w, c = (a.astype(np.float32) for a in (p, u, w, c))
    idx = idx.astype(np.int32)
    g = np.random.default_rng(9).standard_normal(p.shape).astype(np.float32)
    step = _via_transpose(discrete_core.discrete_iterate_bwd_plain, 3)
    calls = []

    def steps_via_transpose(g_, qs, q_last, msgs, w_, col, c_, plan=None,
                            dmsgs=None):
        """K14's reverse steps, each step's lam_t from the transpose."""
        calls.append(qs.shape[0])
        dmsgs = torch.empty_like(msgs)
        lam, du, dC = g_, torch.zeros_like(g_), torch.zeros_like(c_)
        for t in reversed(range(qs.shape[0])):
            qn = q_last if t == qs.shape[0] - 1 else qs[t + 1]
            lam, _, du, dC = step(lam, qn, msgs[t], w_, col, c_, du, dC,
                                  dmsg_out=dmsgs[t])
        return lam, dmsgs, du, dC

    monkeypatch.setattr(discrete_core, "discrete_iterate_bwd_steps",
                        steps_via_transpose)
    ts = [_t(a).requires_grad_() for a in (p, u, w, c)]
    out = discrete_core.discrete_core(ts[0], ts[1], ts[2], _t(idx), ts[3],
                                      steps)
    got = torch.autograd.grad((out * _t(g)).sum(), ts)
    assert calls == [steps]
    jp, ju, jw, ji, jc = map(jnp.asarray, (p, u, w, idx, c))
    ref = jax.vjp(lambda a, b_, c_, d: crf_pallas.discrete_crf_core(
        a, b_, c_, ji, d, steps, 64, 128, True), jp, ju, jw, jc)[1](
            jnp.asarray(g))
    for name, a, r in zip(("dp", "du", "dw", "dC"), got, ref):
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# K2's packed keys
# ---------------------------------------------------------------------------


def _key32(d: torch.Tensor) -> torch.Tensor:
    """K2's packed int32 key (window_knn.cu, Key32): (k32 & ~2047) | column,
    k32 the order-preserving image of d + 0.0."""
    k32 = windowed._order_bits(d + 0.0)
    return (k32 & -2048) | torch.arange(d.shape[-1], dtype=torch.int32)


@pytest.mark.parametrize("width", [1, 128, 320, 1024, 2048])
def test_packed_key32_orders_as_key64(width):
    """Sorting by the 32-bit packed key gives the 64-bit packed key's order
    (both distinct per row) over -0.0 and +0.0, exact and packed ties, the
    2e9 sentinel rows' distances, huge and tiny values and the -inf self
    pin."""
    rng = np.random.default_rng(width)
    rows = []
    d = rng.standard_normal((6, width)).astype(np.float32)
    d[0] = 0.0
    d[0, ::2] = -0.0                                   # signed zeros
    d[1] = np.float32(1.5)                             # all tied
    d[2] = np.float32(1.0) + rng.integers(0, 4, width).astype(np.float32) \
        * np.float32(2.0 ** -22)                       # ties in packed mode
    d[3, ::3] = np.float32(1.2e19)                     # sentinel distances
    d[4] = np.abs(d[4]) * np.float32(1e-38)            # subnormal and tiny
    d[5, width // 2] = -np.inf                         # the self pin
    rows.append(d)
    for d in rows:
        dt = torch.from_numpy(d)
        k64 = windowed._select_key(dt, exact=False)
        k32 = _key32(dt)
        assert len(set(k32[0].tolist())) == width      # distinct
        o64 = torch.argsort(k64, dim=-1)
        o32 = torch.argsort(k32, dim=-1)
        assert torch.equal(o64, o32)
        # every pair compares alike, not only the sorted order
        c64 = k64[:, :, None] < k64[:, None, :]
        c32 = k32[:, :, None] < k32[:, None, :]
        assert torch.equal(c64, c32)
    if width > 1:
        assert int(torch.argsort(_key32(torch.from_numpy(rows[0][5:6])))[0, 0]
                   ) == width // 2                     # self first

"""K13's and K14's steps entry points and the rows they stage, on the CPU,
where each wrapper runs its plain version, against the JAX package.

``discrete_core.discrete_iterate_steps`` runs every step of a discrete CRF
call (one launch of K13 on the card) and ``discrete_iterate_bwd_steps``
every reverse step (one launch of K14). Their plain versions, with the q
and message stacks they fill, are held against ``crf._discrete_scan``, the
Pallas ``discrete_crf_core`` in interpret mode and the VJP of the scan, and
bit for bit against the loops of the one-step plain versions; ``_DiscreteCore``
is checked to go through both. K13 stages, for each item of 128 rows, q_t's
rows from the least to the greatest of the item's operator columns, and K14
the dmsg rows of the slots whose columns are the item's rows: a host check
holds K9's columns within the spans the wrappers size the staging for, on
the discrete net's kNN(32), clouds whose size is not a multiple of 64,
clouds smaller than a window and columns clamped outside the cloud.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.ops import crf as jcrf
from crfconv_tpu.ops import crf_pallas
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu_torch.ops import crf_core, discrete_core, windowed
from crfconv_tpu_torch.ops.neighbors import remove_self_loop
from tests.test_torch_discrete import _inputs
from tests.test_torch_model import _t
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _exact_windowed_gather

SHAPES = [   # (b, n, l, k, steps, dup, masked)
    (1, 256, 20, 31, 10, False, False),   # ScanNet's classes, kNN 32 - self
    (2, 200, 5, 8, 2, True, True),        # n % 64 != 0
    (1, 130, 20, 8, 1, False, True),
    (2, 100, 5, 31, 10, True, False),     # a cloud smaller than a window
]


@pytest.fixture(autouse=True)
def _exact_jax_gather(monkeypatch):
    """The JAX CPU gather selects with a hi/lo bfloat16 one-hot product;
    taken exactly here (the function is the same)."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)


def _steps(p, u, w, idx, c, steps):
    """discrete_iterate_steps' plain version from numpy inputs: (q_steps,
    qs, msgs, col)."""
    col = crf_core.crf_operator(_t(idx))
    qs = torch.full((steps,) + p.shape, float("nan"))
    msgs = torch.full_like(qs, float("nan"))
    out = discrete_core.discrete_iterate_steps(
        _t(p), _t(u), _t(w), col, _t(c), steps, qs=qs, msgs=msgs)
    return out, qs, msgs, col


def _scan(p, u, w, idx, c, steps):
    return np.asarray(jcrf._discrete_scan(
        *map(jnp.asarray, (p, u, w, idx, c)), steps))


@pytest.mark.parametrize("b,n,l,k,steps,dup,masked", SHAPES)
def test_steps_and_stacks_match_discrete_scan(b, n, l, k, steps, dup, masked):
    """q_steps and every q_t of the stack against the scan run t steps;
    every msg_t against the message of the scan's q_t."""
    p, u, w, idx, c = _inputs(b, n, l, k, seed=n + k, dup=dup, masked=masked)
    out, qs, msgs, col = _steps(p, u, w, idx, c, steps)
    np.testing.assert_array_equal(qs[0].numpy(), p)
    for t in range(steps + 1):
        ref = _scan(p, u, w, idx, c, t)
        if t < steps:
            np.testing.assert_allclose(qs[t].numpy(), ref, rtol=1e-5,
                                       atol=1e-6, err_msg=f"q_{t}")
            msg = crf_core._message(_t(ref), _t(w), col).numpy()
            np.testing.assert_allclose(msgs[t].numpy(), msg, rtol=1e-5,
                                       atol=1e-6, err_msg=f"msg_{t}")
        else:
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                                       atol=1e-6, err_msg=f"q_{t}")


@pytest.mark.parametrize("b,n,l,k,steps,dup,masked", SHAPES[:2])
def test_steps_match_pallas_interpret(b, n, l, k, steps, dup, masked):
    p, u, w, idx, c = _inputs(b, n, l, k, seed=n + k, dup=dup, masked=masked)
    out, _, _, _ = _steps(p, u, w, idx, c, steps)
    ref = crf_pallas.discrete_crf_core(*map(jnp.asarray, (p, u, w, idx, c)),
                                       steps, 64, 128, True)
    # the Pallas kernel multiplies hi/lo bfloat16 splits of q and A
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("steps", [1, 2, 10])
def test_steps_are_the_one_step_loop(steps):
    """The steps entry point is discrete_iterate applied steps times, bit
    for bit, with or without the stacks (each msg_t the one-step message),
    and stays differentiable without them."""
    p, u, w, idx, c = _inputs(2, 150, 20, 31, seed=steps, masked=True)
    tp, tu, tw, tc = map(_t, (p, u, w, c))
    col = crf_core.crf_operator(_t(idx))
    q, q_ts, m_ts = tp, [], []
    for _ in range(steps):
        q_ts.append(q)
        m = torch.empty_like(q)
        q = discrete_core.discrete_iterate(q, tu, tw, col, tc, msg_out=m)
        m_ts.append(m)
    assert torch.equal(
        discrete_core.discrete_iterate_steps(tp, tu, tw, col, tc, steps), q)
    qs = torch.empty((steps,) + tuple(tp.shape))
    msgs = torch.empty_like(qs)
    assert torch.equal(discrete_core.discrete_iterate_steps(
        tp, tu, tw, col, tc, steps, qs=qs, msgs=msgs), q)
    assert torch.equal(qs, torch.stack(q_ts))
    assert torch.equal(msgs, torch.stack(m_ts))
    tp.requires_grad_()
    y = discrete_core.discrete_iterate_steps(tp, tu, tw, col, tc, steps)
    assert y.requires_grad
    with pytest.raises(ValueError):
        discrete_core.discrete_iterate_steps(tp, tu, tw, col, tc, 0)


def _forward_stacks(p, u, w, idx, c, steps):
    col = crf_core.crf_operator(_t(idx))
    qs = torch.empty((steps,) + p.shape)
    msgs = torch.empty_like(qs)
    q_last = discrete_core.discrete_iterate_steps(
        _t(p), _t(u), _t(w), col, _t(c), steps, qs=qs, msgs=msgs)
    return col, qs, msgs, q_last


@pytest.mark.parametrize("b,n,l,k,steps,dup,masked", SHAPES)
def test_bwd_steps_are_the_one_step_loop(b, n, l, k, steps, dup, masked):
    """The reverse steps entry point is discrete_iterate_bwd over t =
    steps-1 .. 0 from du = 0 and dC = 0, bit for bit: lam_0, every dmsg_t,
    du and dC."""
    p, u, w, idx, c = _inputs(b, n, l, k, seed=n + l, dup=dup, masked=masked)
    col, qs, msgs, q_last = _forward_stacks(p, u, w, idx, c, steps)
    g = _t(np.random.default_rng(3).standard_normal(p.shape)
           .astype(np.float32))
    tw, tc = _t(w), _t(c)
    lam, du, dC = g, torch.zeros_like(g), torch.zeros_like(tc)
    dmsgs = torch.empty_like(msgs)
    for t in reversed(range(steps)):
        qn = q_last if t == steps - 1 else qs[t + 1]
        lam, _, du, dC = discrete_core.discrete_iterate_bwd(
            lam, qn, msgs[t], tw, col, tc, du, dC, dmsg_out=dmsgs[t])
    got = discrete_core.discrete_iterate_bwd_steps(g, qs, q_last, msgs, tw,
                                                   col, tc)
    for name, a, r in zip(("lam_0", "dmsgs", "du", "dC"), got,
                          (lam, dmsgs, du, dC)):
        assert torch.equal(a, r), name
    into = torch.empty_like(msgs)
    again = discrete_core.discrete_iterate_bwd_steps(g, qs, q_last, msgs, tw,
                                                     col, tc, dmsgs=into)
    assert again[1] is into and torch.equal(into, dmsgs)


@pytest.mark.parametrize("b,n,l,k,steps,dup,masked", [
    SHAPES[0][:4] + (4,) + SHAPES[0][5:], SHAPES[1], SHAPES[3],
])
def test_steps_vjp_matches_jax(b, n, l, k, steps, dup, masked):
    """dp, du, dw and dC from the two steps entry points and K12's plain
    version against the VJP of the scan."""
    p, u, w, idx, c = _inputs(b, n, l, k, seed=n + l + 1, dup=dup,
                              masked=masked)
    g = np.random.default_rng(9).standard_normal(p.shape).astype(np.float32)
    col, qs, msgs, q_last = _forward_stacks(p, u, w, idx, c, steps)
    dp, dmsgs, du, dC = discrete_core.discrete_iterate_bwd_steps(
        _t(g), qs, q_last, msgs, _t(w), col, _t(c))
    dw = crf_core.crf_neighbor_dot(dmsgs, qs, col)
    jp, ju, jw, ji, jc = map(jnp.asarray, (p, u, w, idx, c))
    ref = jax.vjp(lambda a, b_, c_, d: jcrf._discrete_scan(
        a, b_, c_, ji, d, steps), jp, ju, jw, jc)[1](jnp.asarray(g))
    for name, a, r in zip(("dp", "du", "dw", "dC"), (dp, -du, dw, -dC), ref):
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_core_goes_through_the_steps_entries(monkeypatch):
    """_DiscreteCore's forward calls discrete_iterate_steps once (with the
    stacks only when a gradient is taken), its backward
    discrete_iterate_bwd_steps once and K12 with the geometry; forward and
    VJP against the scan."""
    calls = []
    fwd, bwd = (discrete_core.discrete_iterate_steps,
                discrete_core.discrete_iterate_bwd_steps)
    dot = discrete_core.crf_neighbor_dot

    def spy_fwd(*a, **kw):
        calls.append(("steps", a[5], kw.get("qs") is not None))
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls.append(("bwd", a[1].shape[0]))
        return bwd(*a, **kw)

    def spy_dot(*a, **kw):
        calls.append(("dot",) + a[3:])
        return dot(*a, **kw)

    monkeypatch.setattr(discrete_core, "discrete_iterate_steps", spy_fwd)
    monkeypatch.setattr(discrete_core, "discrete_iterate_bwd_steps", spy_bwd)
    monkeypatch.setattr(discrete_core, "crf_neighbor_dot", spy_dot)
    b, n, l, k, steps = 1, 200, 5, 15, 4
    p, u, w, idx, c = _inputs(b, n, l, k, seed=7, masked=True)
    with torch.no_grad():
        discrete_core.discrete_core(*map(_t, (p, u, w, idx, c)), steps)
    assert calls == [("steps", steps, False)]
    calls.clear()
    ts = [_t(a).requires_grad_() for a in (p, u, w, c)]
    out = discrete_core.discrete_core(ts[0], ts[1], ts[2], _t(idx), ts[3],
                                      steps, 64, 128)
    g = np.random.default_rng(8).standard_normal(p.shape).astype(np.float32)
    got = torch.autograd.grad((out * _t(g)).sum(), ts)
    assert calls == [("steps", steps, True), ("bwd", steps), ("dot", 64, 128)]
    jp, ju, jw, ji, jc = map(jnp.asarray, (p, u, w, idx, c))
    ref, vjp = jax.vjp(lambda a, b_, c_, d: jcrf._discrete_scan(
        a, b_, c_, ji, d, steps), jp, ju, jw, jc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    for name, a, r in zip(("dp", "du", "dw", "dC"), got, vjp(jnp.asarray(g))):
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)


# --------------------------------------------------------------------------
# the rows K13 and K14 stage
# --------------------------------------------------------------------------


def _check_iterate_span(col: torch.Tensor) -> float:
    """Every K13 item (ITERATE_ROWS rows of a cloud) has its valid columns
    within iterate_span(n) rows, least to greatest, so it gathers from
    shared memory; returns the widest item's share of that span."""
    b, n, _ = col.shape
    rows = discrete_core.ITERATE_ROWS
    cap = discrete_core.iterate_span(n)
    assert cap <= n
    c = col.numpy()
    worst = 0.0
    for cloud in c:
        assert bool((cloud >= -1).all()) and bool((cloud < n).all())
        for r0 in range(0, n, rows):
            valid = cloud[r0:r0 + rows][cloud[r0:r0 + rows] >= 0]
            if valid.size:
                span = int(valid.max()) - int(valid.min()) + 1
                assert span <= cap
                worst = max(worst, span / cap)
    return worst


def _check_reverse_span(col: torch.Tensor, L: int) -> float:
    """Every K14 item (reverse_rows(L) output rows of a cloud) reads dmsg
    only from source rows within reverse_span(n, rows) rows, least to
    greatest: the rows of the slots whose column is one of the item's rows
    (S~^T by rows, ``crf_core.transpose_plain``). Returns the widest item's
    share of that span."""
    b, n, k = col.shape
    rows = discrete_core.reverse_rows(L)
    cap = discrete_core.reverse_span(n, rows)
    assert cap <= n
    offsets, slots = crf_core.transpose_plain(col)
    src = (slots // k) % n      # the source row within its cloud
    worst = 0.0
    for cloud in range(b):
        for r0 in range(0, n, rows):
            lo = int(offsets[cloud * n + r0])
            hi = int(offsets[cloud * n + min(r0 + rows, n)])
            if hi > lo:
                s = src[lo:hi]
                span = int(s.max()) - int(s.min()) + 1
                assert span <= cap
                worst = max(worst, span / cap)
    return worst


def _morton_cloud(b, n, seed):
    from crfconv_tpu_torch.ops.morton import morton_order

    pos = torch.as_tensor(
        np.random.default_rng(seed).random((b, n, 3), dtype=np.float32))
    return torch.take_along_dim(pos, morton_order(pos)[..., None], dim=1)


@pytest.mark.parametrize("n", [8192, 1000, 300, 100])
def test_staged_rows_discrete_knn(n):
    """The discrete net's kNN(32) (self removed, as its CRF does) on clouds
    of 8192 rows, of sizes not a multiple of 64, and smaller than a window
    (N < 320): both kernels' items stage every row they read, at each of
    K14's item sizes."""
    pos = _morton_cloud(2 if n < 8192 else 1, n, n)
    idx = windowed.window_knn_auto(pos, min(32, n))
    col = crf_core.crf_operator(remove_self_loop(idx))
    assert _check_iterate_span(col) <= 1.0
    for L in (20, 50, 128):
        assert _check_reverse_span(col, L) <= 1.0


def test_staged_rows_clamped_indices():
    """Indices far outside their window are clamped by K9 into it, so they
    too lie in the staged rows; a clamped row outside the cloud is -1 and
    is read by neither kernel."""
    rng = np.random.default_rng(21)
    n = 700
    idx = torch.as_tensor(rng.integers(-300, n + 300, (2, n, 31))
                          .astype(np.int32))
    col = crf_core.crf_operator(idx)
    assert bool((col < 0).any())
    assert _check_iterate_span(col) <= 1.0
    for L in (5, 20, 64):
        assert _check_reverse_span(col, L) <= 1.0


def test_spans_at_the_discrete_shape():
    """At the discrete net's 8192 rows the spans are the default geometry's
    (tile 64, pad 128: 512-row windows): K13's 128-row item reads at most
    its two tiles' windows, 576 rows; K14's the source rows of the 9 tiles
    whose windows meet its 128 rows, 576 too. Both are far below the
    cloud."""
    assert discrete_core.iterate_span(8192) == 128 - 64 + 512
    assert discrete_core.reverse_span(8192, 128) == 9 * 64
    assert discrete_core.iterate_span(100) == 100
    assert discrete_core.reverse_span(100, 128) == 100

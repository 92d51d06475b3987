"""K10's steps entry point and K12's window staging on the CPU, where each
wrapper runs its plain version, against the JAX package.

``crf_core.crf_iterate_steps`` runs every step of a CRF call (one launch of
K10 on the card); its plain version, with the x stack it fills, is held
against ``crf_pallas._core_scan`` and the Pallas ``crf_core`` in interpret
mode, and ``_CRFCore`` is checked to go through it, forward and VJP. K12
(``crf_neighbor_dot``) stages, for each block of 128 rows (64 where K >
16), x_t's rows from the least to the greatest of the block's operator
columns, at most its tiles' windows: a host-side check holds K9's columns to that on ScanNet's
four CRF scales, the discrete net's kNN(32), clouds whose size is not a
multiple of 64 and clouds smaller than a window.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.ops import crf_pallas
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu_torch.ops import crf_core, windowed
from crfconv_tpu_torch.ops.neighbors import remove_self_loop
from tests.test_torch_crf_core import _inputs, _t
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _exact_windowed_gather

STEPS_SHAPES = [   # (b, n, h, k, steps, dup, masked)
    (1, 256, 32, 15, 1, False, False),
    (2, 200, 20, 31, 2, True, True),     # the discrete width, n % 64 != 0
    (1, 130, 18, 9, 4, False, True),     # h % 4 != 0
]


def _steps(z, zp, s, idx, m, steps):
    """crf_iterate_steps' plain version from numpy inputs: (x_steps, xs)."""
    col = crf_core.crf_operator(_t(idx))
    xs = torch.full((steps,) + z.shape, float("nan"))
    out = crf_core.crf_iterate_steps(_t(z), _t(zp), _t(s), col, _t(m), steps,
                                     xs=xs)
    return out, xs


@pytest.mark.parametrize("b,n,h,k,steps,dup,masked", STEPS_SHAPES)
def test_steps_and_stack_match_core_scan(b, n, h, k, steps, dup, masked,
                                         monkeypatch):
    """x_steps, and every x_t of the stack, against the scan run t steps."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    z, zp, s, idx, m = _inputs(b, n, h, k, seed=n + k, dup=dup, masked=masked)
    out, xs = _steps(z, zp, s, idx, m, steps)
    np.testing.assert_array_equal(xs[0].numpy(), z)
    args = tuple(map(jnp.asarray, (z, zp, s, idx, m)))
    for t in range(1, steps + 1):
        ref = np.asarray(crf_pallas._core_scan(*args, t, 64, 128))
        got = (out if t == steps else xs[t]).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                   err_msg=f"x_{t}")


@pytest.mark.parametrize("b,n,h,k,steps,dup,masked", STEPS_SHAPES[:2])
def test_steps_match_pallas_interpret(b, n, h, k, steps, dup, masked):
    z, zp, s, idx, m = _inputs(b, n, h, k, seed=n + k, dup=dup, masked=masked)
    out, _ = _steps(z, zp, s, idx, m, steps)
    ref = crf_pallas.crf_core(*map(jnp.asarray, (z, zp, s, idx, m)), steps,
                              64, 128, True)
    # the Pallas kernel multiplies hi/lo bfloat16 splits of both operands
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_steps_are_the_one_step_loop():
    """The steps entry point is crf_iterate applied steps times, bit for
    bit, with or without the stack, and stays differentiable without it."""
    z, zp, s, idx, m = _inputs(2, 150, 8, 7, seed=6, reach=300, masked=True)
    tz, tzp, ts, tm = map(_t, (z, zp, s, m))
    col = crf_core.crf_operator(_t(idx))
    x = tz
    for _ in range(5):
        x = crf_core.crf_iterate(x, tzp, ts, col, tm)
    assert torch.equal(crf_core.crf_iterate_steps(tz, tzp, ts, col, tm, 5), x)
    xs = torch.empty((5,) + tuple(tz.shape))
    assert torch.equal(
        crf_core.crf_iterate_steps(tz, tzp, ts, col, tm, 5, xs=xs), x)
    tz.requires_grad_()
    y = crf_core.crf_iterate_steps(tz, tzp, ts, col, tm, 2)
    assert y.requires_grad
    with pytest.raises(ValueError):
        crf_core.crf_iterate_steps(tz, tzp, ts, col, tm, 0)


def test_core_goes_through_the_steps_entry(monkeypatch):
    """_CRFCore's forward calls crf_iterate_steps once (saving the stack
    only when a gradient is needed) and its backward passes the geometry
    to K12; forward and VJP against the scan."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    calls = []
    steps_fn, dot_fn = crf_core.crf_iterate_steps, crf_core.crf_neighbor_dot

    def spy_steps(*a, **kw):
        calls.append(("steps", a[5], kw.get("xs") is not None))
        return steps_fn(*a, **kw)

    def spy_dot(*a, **kw):
        calls.append(("dot",) + a[3:])
        return dot_fn(*a, **kw)

    monkeypatch.setattr(crf_core, "crf_iterate_steps", spy_steps)
    monkeypatch.setattr(crf_core, "crf_neighbor_dot", spy_dot)
    b, n, h, k, steps = 1, 200, 16, 15, 4
    z, zp, s, idx, m = _inputs(b, n, h, k, seed=7, masked=True)
    with torch.no_grad():
        crf_core.crf_core(*map(_t, (z, zp, s, idx, m)), steps)
    assert calls == [("steps", steps, False)]
    calls.clear()
    ts = [_t(a).requires_grad_() for a in (z, zp, s, m)]
    out = crf_core.crf_core(ts[0], ts[1], ts[2], _t(idx), ts[3], steps,
                            64, 128)
    g = np.random.default_rng(8).standard_normal(z.shape).astype(np.float32)
    got = torch.autograd.grad((out * _t(g)).sum(), ts)
    assert calls == [("steps", steps, True), ("dot", 64, 128)]
    import jax
    args = tuple(map(jnp.asarray, (z, zp, s, m)))
    ji = jnp.asarray(idx)
    ref, vjp = jax.vjp(lambda a, b_, c, d: crf_pallas._core_scan(
        a, b_, c, ji, d, steps, 64, 128), *args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    for name, a, r in zip(("dz", "dzp", "ds", "dM"), got,
                          vjp(jnp.asarray(g))):
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)


# --------------------------------------------------------------------------
# K12's staged window
# --------------------------------------------------------------------------


def _check_staged(col: torch.Tensor, tile: int = 64, pad: int = 128) -> float:
    """Every valid operator column of every block of K12 (128 rows, two
    window tiles, or 64 where K > 16) lies in the rows it stages, [lo, lo +
    min(cap, hi - lo + 1)) with lo and hi the block's least and greatest
    column and cap = min(window width + rows - 64, N) (as crf_neighbor_dot
    passes it), and inside its tiles' windows; returns the largest span
    over cap."""
    b, n, k = col.shape
    starts, width, front = windowed.window_starts(n, n, tile, pad)
    rows = crf_core.neighbor_dot_rows(k)
    cap = min(width + rows - tile, n)
    c = col.numpy()
    worst = 0.0
    for r0 in range(0, n, rows):
        blk = c[:, r0:r0 + rows].reshape(b, -1)
        tiles = starts[r0 // tile:-(-min(r0 + rows, n) // tile)]
        lo_w, hi_w = tiles[0] - front, tiles[-1] - front + width
        for row in blk:
            valid = row[row >= 0]
            assert bool((row >= -1).all()) and bool((valid < n).all())
            if valid.size == 0:
                continue
            assert bool((valid >= lo_w).all())
            assert bool((valid < hi_w).all())
            span = int(valid.max()) - int(valid.min()) + 1
            assert span <= cap
            worst = max(worst, span / cap)
    return worst


def _morton_cloud(b, n, seed):
    from crfconv_tpu_torch.ops.morton import morton_order

    pos = torch.as_tensor(
        np.random.default_rng(seed).random((b, n, 3), dtype=np.float32))
    return torch.take_along_dim(pos, morton_order(pos)[..., None], dim=1)


def test_neighbor_dot_window_scannet_pyramid():
    """ScanNet's pyramid (B1 x 8192, kNN(16)): the four CRF scales' columns
    (8192, 2048, 512, 128 rows, self removed) lie in K12's staged rows."""
    pos = torch.as_tensor(np.random.default_rng(20).random((1, 8192, 3),
                                                           dtype=np.float32))
    _, scales = windowed.build_pyramid_windowed(
        pos, generator=torch.Generator().manual_seed(0), device="cpu")
    for sc in scales[:4]:
        col = crf_core.crf_operator(remove_self_loop(sc.neighbor_idx))
        assert col.shape[2] == 15
        assert _check_staged(col) <= 1.0


@pytest.mark.parametrize("n", [8192, 1000, 300, 100])
def test_neighbor_dot_window_discrete_knn(n):
    """The discrete net's kNN(32) on clouds of 8192 rows, of sizes not a
    multiple of 64, and smaller than a window (N < 320)."""
    pos = _morton_cloud(1, n, n)
    idx = windowed.window_knn_auto(pos, min(32, n))
    col = crf_core.crf_operator(remove_self_loop(idx))
    assert _check_staged(col) <= 1.0


def test_neighbor_dot_window_clamped_indices():
    """Indices far outside their window are clamped by K9 into it, so they
    too lie in the staged rows; a clamped row outside the cloud is -1."""
    rng = np.random.default_rng(21)
    n = 700
    idx = torch.as_tensor(rng.integers(-200, n + 200, (2, n, 9))
                          .astype(np.int32))
    col = crf_core.crf_operator(idx)
    assert bool((col < 0).any())
    assert _check_staged(col) <= 1.0

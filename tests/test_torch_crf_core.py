"""The fused continuous-CRF core (``crfconv_tpu_torch/ops/crf_core.py``,
kernels K9-K12) on the CPU, where each wrapper runs its plain version,
against the JAX package: the forward against ``crf_pallas._core_scan`` and
the Pallas ``crf_core`` in interpret mode, the backward against ``jax.vjp``
of both (the interpret-mode VJP is the native backward kernels #11 and
#12), and the dispatch of ``crf_mean_field``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.ops import crf as jcrf
from crfconv_tpu.ops import crf_pallas
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu_torch.ops import crf, crf_core, windowed
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from tests.test_torch_train_step import _exact_windowed_gather

WINDOWED = NeighborMode("windowed")


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(b, n, h, k, seed, reach=64, dup=False, masked=False):
    """z, zp, s (row-stochastic, optionally with masked slots and an
    all-zero row), window-consistent idx (optionally duplicated), M."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, n, h)).astype(np.float32)
    zp = rng.standard_normal((b, n, h)).astype(np.float32)
    logits = rng.standard_normal((b, n, k))
    s = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.clip(np.arange(n)[None, :, None]
                  + rng.integers(-reach, reach, (b, n, k)), 0, n - 1)
    if dup:
        idx[:, :, 1] = idx[:, :, 0]
    if masked:
        s[:, :, 2] = 0.0
        s[:, 5] = 0.0                    # an isolated point: all masked
    m = 0.5 * rng.standard_normal((h, h)) / np.sqrt(h)
    return (z, zp, s.astype(np.float32), idx.astype(np.int32),
            m.astype(np.float32))


SHAPES = [   # (b, n, h, k, steps, dup, masked)
    (1, 256, 32, 9, 10, False, False),
    (2, 200, 8, 15, 3, True, True),      # n not a multiple of 64
    (1, 100, 256, 15, 4, False, True),   # the widest decoder
]


@pytest.mark.parametrize("b,n,h,k,steps,dup,masked", SHAPES)
def test_forward_matches_core_scan(b, n, h, k, steps, dup, masked, monkeypatch):
    # the JAX CPU gather selects with a hi/lo bfloat16 one-hot product
    # (~16 mantissa bits); taken exactly here, the two differ by float32
    # sum order alone
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    z, zp, s, idx, m = _inputs(b, n, h, k, seed=h + n, dup=dup, masked=masked)
    ref = crf_pallas._core_scan(*map(jnp.asarray, (z, zp, s, idx, m)), steps,
                                64, 128)
    got = crf_core.crf_core(*map(_t, (z, zp, s, idx, m)), steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    if masked:   # an all-masked row stays at zp
        np.testing.assert_array_equal(got[:, 5].numpy(), zp[:, 5])


@pytest.mark.parametrize("b,n,h,k,steps,dup,masked", SHAPES[:2])
def test_forward_matches_pallas_interpret(b, n, h, k, steps, dup, masked):
    z, zp, s, idx, m = _inputs(b, n, h, k, seed=h + n, dup=dup, masked=masked)
    ref = crf_pallas.crf_core(*map(jnp.asarray, (z, zp, s, idx, m)), steps,
                              64, 128, True)
    got = crf_core.crf_core(*map(_t, (z, zp, s, idx, m)), steps)
    # the Pallas kernel multiplies hi/lo bfloat16 splits of both operands
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def _port_grads(z, zp, s, idx, m, steps, g):
    ts = [_t(a).requires_grad_() for a in (z, zp, s, m)]
    out = crf_core.crf_core(ts[0], ts[1], ts[2], _t(idx), ts[3], steps)
    return [a.numpy() for a in torch.autograd.grad((out * _t(g)).sum(), ts)]


@pytest.mark.parametrize("b,n,h,k,steps,dup,masked", SHAPES[:2])
def test_backward_matches_jax(b, n, h, k, steps, dup, masked, monkeypatch):
    """dz, dzp, ds and dM of the plain reverse recurrence against the VJP
    of the Pallas crf_core in interpret mode (the native backward kernels)
    and of the scan."""
    z, zp, s, idx, m = _inputs(b, n, h, k, seed=h + n + 1, dup=dup,
                               masked=masked)
    g = np.random.default_rng(9).standard_normal(z.shape).astype(np.float32)
    got = _port_grads(z, zp, s, idx, m, steps, g)
    jz, jzp, js, ji, jm = map(jnp.asarray, (z, zp, s, idx, m))

    def vjp(fn):
        return jax.vjp(fn, jz, jzp, js, jm)[1](jnp.asarray(g))

    pallas = vjp(lambda a, b_, c, d: crf_pallas.crf_core(
        a, b_, c, ji, d, steps, 64, 128, True))
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    scan = vjp(lambda a, b_, c, d: crf_pallas._core_scan(
        a, b_, c, ji, d, steps, 64, 128))
    for name, a, p, r in zip(("dz", "dzp", "ds", "dM"), got, pallas, scan):
        scale = float(np.abs(np.asarray(r)).max())
        # float32 sum order (scan) and the hi/lo bfloat16 splits (Pallas)
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(p), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_backward_matches_autograd_f64():
    """The Function's backward (the written-out reverse recurrence) against
    autograd through the plain forward, in float64, with indices out of
    their window (clamped, some rows read zero) and duplicates."""
    z, zp, s, idx, m = _inputs(2, 150, 6, 7, seed=3, reach=400, dup=True,
                               masked=True)
    ts = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
          for a in (z, zp, s, m)]
    i = _t(idx)
    w = torch.randn(2, 150, 6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(
        (crf_core.crf_core(ts[0], ts[1], ts[2], i, ts[3], 5) * w).sum(), ts)
    ref = torch.autograd.grad(
        (crf_core.crf_core_plain(ts[0], ts[1], ts[2], i, ts[3], 5) * w).sum(),
        ts)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


def test_operator_is_the_windowed_gather():
    """Gathering through K9's columns is K1's window-clamped gather, for
    indices in and out of their windows."""
    rng = np.random.default_rng(4)
    n = 300
    x = torch.randn(2, n, 5, generator=torch.Generator().manual_seed(1))
    idx = _t(np.clip(np.arange(n)[None, :, None]
                     + rng.integers(-500, 500, (2, n, 9)), -50, n + 50)
             .astype(np.int32))
    col = crf_core.crf_operator(idx)
    assert col.dtype == torch.int32 and bool((col >= -1).all())
    assert bool((col < 0).any())           # some clamped rows read zero
    assert torch.equal(crf_core._gather_cols(x, col),
                       windowed.windowed_gather_plain(x, idx))


def test_iterate_steps_compose():
    """crf_core is K10 applied steps times from x_0 = z, and K11 is the
    transpose of K10: <K10 x - zp, lam> = <x, lam_t> and dM's pairing."""
    z, zp, s, idx, m = _inputs(1, 130, 8, 5, seed=5, reach=200)
    tz, tzp, ts, tm = map(_t, (z, zp, s, m))
    col = crf_core.crf_operator(_t(idx))
    x = tz
    for _ in range(3):
        x = crf_core.crf_iterate(x, tzp, ts, col, tm)
    assert torch.equal(x, crf_core.crf_core(tz, tzp, ts, _t(idx), tm, 3))
    d = lambda a: a.double()                                  # noqa: E731
    lam = torch.randn(1, 130, 8, generator=torch.Generator().manual_seed(2))
    lam_t, dmsg, dzp, dM = crf_core.crf_iterate_bwd(
        d(lam), d(tz), d(ts), col, d(tm), torch.zeros(1, 130, 8).double(),
        torch.zeros(8, 8).double())
    lin = crf_core.crf_iterate(d(tz), torch.zeros(1, 130, 8).double(), d(ts),
                               col, d(tm))
    torch.testing.assert_close((lin * d(lam)).sum(), (d(tz) * lam_t).sum())
    torch.testing.assert_close((lin * d(lam)).sum(), (dM * d(tm)).sum())
    assert torch.equal(dzp, d(lam))
    torch.testing.assert_close(dmsg, d(lam) @ d(tm).T)


@pytest.mark.parametrize("mode", [WINDOWED, NeighborMode()])
@pytest.mark.parametrize("steps", [2, 10])
def test_crf_mean_field_dispatch(mode, steps, monkeypatch):
    """Windowed at steps >= 2 runs the fused core, every other case the
    scan; both are the JAX package's mean field."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    z, _, s, idx, _ = _inputs(2, 256, 16, 7, seed=steps)
    c = (np.eye(16) + 0.1 * np.random.default_rng(1).standard_normal((16, 16))
         ).astype(np.float32)
    calls = []
    core = crf.crf_core
    monkeypatch.setattr(crf, "crf_core", lambda *a: calls.append(1) or core(*a))
    got = crf.crf_mean_field(*map(_t, (z, s, idx, c)), steps, mode)
    assert len(calls) == (1 if mode.windowed else 0)
    with neighbor_mode(mode.mode):
        ref = jcrf.crf_mean_field(*map(jnp.asarray, (z, s, idx, c)), steps,
                                  allow_fused=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_compat_products_match():
    c = np.random.default_rng(6).standard_normal((12, 12)).astype(np.float32)
    got = crf_core.compat_products(_t(c))
    ref = crf_pallas._compat_products(jnp.asarray(c), 12)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("fused_sim", [False, True])
def test_flagship_block_at_steps_2(fused_sim, monkeypatch):
    """The flagship's ContinuousCRFConv at steps = 2 through the new
    dispatch: the fused core recomputes the first message from (s, idx) and
    ignores msg0 (fused similarity, K4's plain version) or neighbors0; the
    JAX block runs its scan from msg0 (the interpret-mode similarity kernel)
    or neighbors0."""
    from crfconv_tpu.models.crf_conv import ContinuousCRFConv as JCRF
    from crfconv_tpu.ops import crf_sim_pallas
    from crfconv_tpu_torch.models.crf_conv import ContinuousCRFConv
    from crfconv_tpu_torch.ops import crf_sim
    from tests.test_torch_model import (
        _apply, _init, _load, _perturb_stats, _pyramid, _sorted_cloud,
    )

    rng = np.random.default_rng(2)
    n, h_out = 1024, 32
    pos = _sorted_cloud(rng, 1, n)
    _, scales = _pyramid(pos, jax.random.PRNGKey(0))
    s0, s1 = scales[0], scales[1]
    unary = rng.standard_normal((1, s1.pos.shape[1], 64)).astype(np.float32)
    pairwise = rng.standard_normal((1, n, h_out)).astype(np.float32)
    jargs = (jnp.asarray(unary), jnp.asarray(pairwise), s0.up_idx,
             s0.neighbor_idx)
    model = JCRF(out_features=h_out, steps=2)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *jargs)
        params = dict(variables["params"])
        params["c"] = params["c"] + 0.1 * jnp.asarray(
            rng.standard_normal(params["c"].shape).astype(np.float32))
        variables = {"params": params,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        if fused_sim:
            monkeypatch.setattr(crf_sim_pallas, "SIM_INTERPRET", True)
            monkeypatch.setattr(crf_sim_pallas, "SIM_MIN_ROWS", 0)
            monkeypatch.setattr(crf_sim, "SIM_MIN_ROWS", 0)
        ref = np.asarray(_apply(model, variables, *jargs))
    cores = []
    core = crf.crf_core
    monkeypatch.setattr(crf, "crf_core", lambda *a: cores.append(1) or core(*a))
    port = _load(ContinuousCRFConv(64, h_out, h_out, 2, device="cpu"),
                 variables)
    got = port(_t(unary), _t(pairwise), _t(s0.up_idx), _t(s0.neighbor_idx),
               WINDOWED).detach().numpy()
    assert len(cores) == 1
    # the bound of tests/test_torch_model.py's CRF block
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

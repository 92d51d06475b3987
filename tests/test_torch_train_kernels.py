"""The train path's kernels, on the CPU: the plain versions of K7 (the
weighted gather-reduce) and K8 (the gather's transpose) against the JAX
package's Pallas kernels in interpret mode and its custom VJPs, and the
port's two autograd Functions (K1 forward / K8 backward, K7 forward / K8
backward) under ``torch.autograd.gradcheck`` in float64."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.windowed_pallas import (
    windowed_gather_bwd_pallas,
    windowed_weighted_reduce_pallas,
)
from crfconv_tpu_torch.ops import windowed


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_diag(rng, b, m, n, k, spread=48):
    centers = (np.arange(m) * (n / m)).astype(np.int64)
    return np.clip(
        centers[None, :, None] + rng.integers(-spread, spread, (b, m, k)),
        0, n - 1,
    ).astype(np.int32)


@pytest.mark.parametrize("n,k,h", [(512, 16, 8), (300, 8, 5)])
def test_weighted_reduce_plain_vs_pallas(n, k, h):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n, h)).astype(np.float32)
    u = rng.standard_normal((2, n, k, h)).astype(np.float32)
    idx = _near_diag(rng, 2, n, n, k)
    out_j, xg_j = windowed_weighted_reduce_pallas(
        *map(jnp.asarray, (x, u, idx)), interpret=True
    )
    out, xg = windowed.windowed_weighted_reduce_plain(_t(x), _t(u), _t(idx))
    np.testing.assert_array_equal(xg.numpy(), np.asarray(xg_j))
    # the K-sum in another order (the TPU kernel folds k in lane pairs):
    # the bound of the JAX package's own kernel test
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("n,k,f", [(256, 15, 16), (512, 16, 3)])
def test_gather_bwd_plain_vs_pallas_and_vjp(n, k, f):
    rng = np.random.default_rng(1)
    g = rng.standard_normal((2, n, k, f)).astype(np.float32)
    idx = _near_diag(rng, 2, n, n, k, spread=64)
    got = windowed.windowed_gather_bwd_plain(_t(g), _t(idx), n).numpy()
    x0 = jnp.zeros((2, n, f), jnp.float32)
    _, vjp = jax.vjp(lambda x: jwin.windowed_gather(x, jnp.asarray(idx)), x0)
    (ref_vjp,) = vjp(jnp.asarray(g))
    # the XLA scatter-add adds the same terms in another order
    np.testing.assert_allclose(got, np.asarray(ref_vjp), rtol=1e-5, atol=1e-6)
    ref_pl = np.asarray(windowed_gather_bwd_pallas(
        jnp.asarray(g), jnp.asarray(idx), n, interpret=True
    ))
    # the Pallas kernel rounds each summand through a hi/lo bf16 split,
    # |err| <= 2^-16 |g|: rtol 1e-5 plus that split's error summed over
    # the slots that reach each row
    split = 2.0**-16 * windowed.windowed_gather_bwd_plain(
        _t(np.abs(g)), _t(idx), n
    ).numpy()
    assert np.all(np.abs(got - ref_pl) <= 1e-5 * np.abs(ref_pl) + split)


@pytest.mark.parametrize(
    "m,n,k", [(300, 300, 7), (75, 300, 16), (1200, 300, 1)]
)
def test_gather_bwd_is_the_exact_transpose(m, n, k):
    """<K1(x), g> == <x, K8(g)> for arbitrary indices (the clamp decides)
    at same-scale, strided and upsample geometries, in float64."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((2, n, 4)))
    g = torch.as_tensor(rng.standard_normal((2, m, k, 4)))
    idx = torch.as_tensor(rng.integers(-50, n + 50, (2, m, k)).astype(np.int32))
    lhs = (windowed.windowed_gather_plain(x, idx) * g).sum()
    rhs = (x * windowed.windowed_gather_bwd_plain(g, idx, n)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)


def test_weighted_gather_reduce_vjp_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    b, n, k, h = 2, 512, 16, 8
    x = rng.standard_normal((b, n, h)).astype(np.float32)
    u = rng.standard_normal((b, n, k, h)).astype(np.float32)
    idx = _near_diag(rng, b, n, n, k)
    monkeypatch.setattr(jwin, "WGR_INTERPRET", True)

    def f(x, u):
        return jnp.sum(jnp.sin(jwin.weighted_gather_reduce(x, u, jnp.asarray(idx))))

    gx_j, gu_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(u))
    xt = _t(x).requires_grad_()
    ut = _t(u).requires_grad_()
    windowed.weighted_gather_reduce(xt, ut, _t(idx)).sin().sum().backward()
    # the forward's K-sum order differs (~2e-6), which reaches the
    # cotangents: the JAX package's own VJP bound
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu_j), rtol=1e-3,
                               atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-3,
                               atol=2e-5)


@pytest.mark.parametrize("m,k", [(150, 5), (40, 7)])
def test_gradcheck_windowed_gather(m, k):
    rng = np.random.default_rng(4)
    n = 150
    x = torch.as_tensor(rng.standard_normal((1, n, 2))).requires_grad_()
    idx = torch.as_tensor(rng.integers(-20, n + 20, (1, m, k)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda x: windowed.windowed_gather(x, idx, 16, 16), (x,)
    )


def test_gradcheck_weighted_gather_reduce():
    rng = np.random.default_rng(5)
    n, k, h = 100, 4, 3
    x = torch.as_tensor(rng.standard_normal((1, n, h))).requires_grad_()
    u = torch.as_tensor(rng.standard_normal((1, n, k, h))).requires_grad_()
    idx = torch.as_tensor(rng.integers(-10, n + 10, (1, n, k)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda x, u: windowed.weighted_gather_reduce(x, u, idx, 16, 16),
        (x, u),
    )


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the K7/K8 wrappers are their plain versions."""
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((1, 200, 4)).astype(np.float32))
    u = _t(rng.standard_normal((1, 200, 6, 4)).astype(np.float32))
    idx = _t(_near_diag(rng, 1, 200, 200, 6))
    for a, b in zip(windowed.windowed_weighted_reduce(x, u, idx),
                    windowed.windowed_weighted_reduce_plain(x, u, idx)):
        assert torch.equal(a, b)
    assert torch.equal(windowed.windowed_gather_bwd(u, idx, 200),
                       windowed.windowed_gather_bwd_plain(u, idx, 200))

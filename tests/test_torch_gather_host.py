"""The host side of K1 and K8 and the leaky ReLU's gradient, on the CPU,
against the JAX package: the window-clamped gather without its autograd
Function where no gradient is needed, the gather's VJP, the sum order of
K8's plain version (the order the CUDA kernel follows, so that the two are
bit-equal), and the leaky ReLU's gradient at exactly 0, which follows
flax's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.models import common as jcommon
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu_torch.models import common
from crfconv_tpu_torch.ops import activation, windowed
from tests.test_torch_ops import few_torch_threads  # noqa: F401

# same-scale, strided sub_idx (M < N), 1-NN upsample (M > N, K = 1), and
# indices past the windows (the clamp decides)
GEOMETRIES = [(512, 512, 16, 64), (128, 512, 16, 64), (1024, 256, 1, 32),
              (300, 300, 7, 400)]


def _idx(rng, b, m, n, k, spread, lo=0, hi=None):
    """Indices near each row's own position, clipped to [lo, hi]."""
    centers = (np.arange(m) * (n / m)).astype(np.int64)
    idx = centers[None, :, None] + rng.integers(-spread, spread, (b, m, k))
    return np.clip(idx, lo, n - 1 if hi is None else hi).astype(np.int32)


@pytest.mark.parametrize("m,n,k,spread", GEOMETRIES)
def test_windowed_gather_dispatch_matches_jax(m, n, k, spread):
    """Without a gradient to build the gather skips its autograd Function
    (no grad_fn) and returns the Function's values; with one, its VJP is
    the JAX package's on window-consistent indices."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n, 5)).astype(np.float32)
    idx = _idx(rng, 2, m, n, k, spread)
    g = rng.standard_normal((2, m, k, 5)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jwin.windowed_gather(v, jnp.asarray(idx)),
                       jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    it = torch.from_numpy(idx)
    with torch.no_grad():
        cut = windowed.windowed_gather(xt, it)
    plain = windowed.windowed_gather(xt.detach(), it)
    out = windowed.windowed_gather(xt, it)
    assert cut.grad_fn is None and plain.grad_fn is None
    assert out.grad_fn is not None
    assert torch.equal(cut, out) and torch.equal(plain, out)
    # the JAX CPU path selects through a hi/lo bf16 split (~2^-17)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-7)
    out.backward(torch.from_numpy(g))
    if spread > windowed.PAD:
        # the JAX VJP scatters to the unclamped index, the transpose only
        # for window-consistent indices; the port's is the exact transpose
        # (tests/test_torch_train_kernels.py)
        return
    # the XLA scatter-add adds the same terms in another order
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("m,n,k,spread", GEOMETRIES)
def test_gather_bwd_plain_adds_in_slot_order(m, n, k, spread):
    """K8's plain version sums each row's terms in ascending slot order
    from +0.0, bit for bit (index_add_ on the CPU), the order the kernel
    adds in; slots whose clamped row is outside [0, N) add nothing."""
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((2, m, k, 3))
         * np.exp(3 * rng.standard_normal((2, m, k, 1)))).astype(np.float32)
    idx = _idx(rng, 2, m, n, k, spread, lo=-20, hi=n + 20)
    got = windowed.windowed_gather_bwd_plain(torch.from_numpy(g),
                                             torch.from_numpy(idx), n)
    rows = windowed._clamped_rows(torch.from_numpy(idx), n, windowed.TILE,
                                  windowed.PAD).numpy()
    ref = np.zeros((2, n, 3), np.float32)
    for b in range(2):
        for s in range(m * k):
            r = rows[b].reshape(-1)[s]
            if 0 <= r < n:
                ref[b, r] += g[b].reshape(-1, 3)[s]
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fns", [
    (common.leaky_relu01, jcommon.leaky_relu01),
    (common.leaky_relu001, jcommon.leaky_relu001),
])
def test_leaky_relu_gradient_matches_flax(fns):
    """The activations' values and gradients, bit for bit, on inputs
    holding exact zeros of both signs: flax's gradient at 0 is 1."""
    ours, theirs = fns
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000).astype(np.float32)
    x[::5] = 0.0
    x[2::5] = -0.0
    g = rng.standard_normal(1000).astype(np.float32)
    y, vjp = jax.vjp(theirs, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = ours(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy()[x == 0], g[x == 0])
    with torch.no_grad():      # no autograd Function without a gradient
        assert ours(xt).grad_fn is None


def test_leaky_relu_gradcheck_and_plain():
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(64) + 0.05
                        ).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: activation.leaky_relu(v, 0.1),
                                    (x,))
    g = torch.randn(64, dtype=torch.float64)
    z = torch.zeros(64, dtype=torch.float64)
    assert torch.equal(activation.leaky_relu_bwd(z, g, 0.1), g)
    assert torch.equal(activation.leaky_relu_bwd(-z - 1, g, 0.1), g * 0.1)

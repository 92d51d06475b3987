"""The point-validity masks of the port against the JAX package on the
CPU: ``MaskedBatchNorm`` in train mode with a mask (output, running
statistics and gradients), ``DSPointConv``, ``GuideCRFConv`` and
``DiscreteCRFConv`` with a mask over padded clouds, ``max_pool_neighbors``
with a slot mask in both regimes, and the nine names of
``crfconv_tpu_torch.ops``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crfconv_tpu.ops as jops
from crfconv_tpu.models.common import MaskedBatchNorm as JBN
from crfconv_tpu.models.crf_conv import GuideCRFConv as JGuide
from crfconv_tpu.models.discrete_crf import DiscreteCRFConv as JDiscrete
from crfconv_tpu.models.point_conv_small import DSPointConv as JDSConv
from crfconv_tpu.ops import neighbors as jnb
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
import crfconv_tpu_torch.ops as ops
from crfconv_tpu_torch import from_flax
from crfconv_tpu_torch.models.common import MaskedBatchNorm
from crfconv_tpu_torch.models.crf_conv import GuideCRFConv
from crfconv_tpu_torch.models.discrete_crf import DiscreteCRFConv
from crfconv_tpu_torch.models.point_conv_small import DSPointConv
from crfconv_tpu_torch.ops.neighbors import NeighborMode, max_pool_neighbors
from tests.test_torch_model import (
    WINDOWED, _init, _perturb_stats, _pyramid, _sorted_cloud, _t,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _exact_windowed_gather

@pytest.fixture(autouse=True)
def _exact_jax_gather(monkeypatch):
    """The JAX CPU gather keeps ~16 mantissa bits (a hi/lo bfloat16 one-hot
    product); taken exactly here, as in tests/test_torch_small_model.py."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)


def _padded_mask(rng, b, n):
    """[b, n] validity: random drops, and the tail of the last cloud
    padding."""
    mask = rng.random((b, n)) > 0.1
    mask[-1, -n // 5:] = False
    return mask


@pytest.mark.parametrize("shape", [(2, 64, 7), (2, 32, 5, 6)])
def test_masked_batch_norm_matches_jax(shape):
    """Train mode with a mask: the output, the running statistics (the
    unbiased factor of the masked count) and the gradients of a linear
    probe by the input, scale and bias, at rtol 1e-5."""
    rng = np.random.default_rng(0)
    f = shape[-1]
    x = (2.0 + 1.5 * rng.standard_normal(shape)).astype(np.float32)
    mask = rng.random(shape[:-1]) > 0.3
    probe = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(f)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    stats = {"mean": np.zeros(f, np.float32), "var": np.ones(f, np.float32)}

    def loss(params, xj):
        y, upd = JBN().apply({"params": params, "batch_stats": stats}, xj,
                             train=True, mask=jnp.asarray(mask),
                             mutable=["batch_stats"])
        return jnp.sum(y * probe), (y, upd["batch_stats"])

    (_, (ref, upd)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            jnp.asarray(x))
    bn = MaskedBatchNorm(f)
    with torch.no_grad():
        bn.scale.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    xt = _t(x).requires_grad_(True)
    y = bn(xt, _t(mask))
    (y * _t(probe)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(gp["scale"]),
                               **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]),
                               **tol)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_masked_batch_norm_all_valid_is_the_plain_form():
    """A mask of every row gives the statistics of no mask (two sums
    against the mean, to float32 rounding)."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((3, 50, 4)).astype(np.float32))
    a, b = MaskedBatchNorm(4), MaskedBatchNorm(4)
    ya = a(x)
    yb = b(x, torch.ones(3, 50, dtype=torch.bool))
    np.testing.assert_allclose(ya.detach().numpy(), yb.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.var.numpy(), b.var.numpy(), rtol=1e-6)


def test_ds_point_conv_mask_matches_jax():
    """DSPointConv (same scale, 16 -> 32 channels: the residual through
    mlp4) in train mode over padded clouds: its pointwise MLPs' masked
    batch statistics, at rtol 2e-4; the running statistics too."""
    rng = np.random.default_rng(5)
    b, n = 2, 512
    pos = _sorted_cloud(rng, b, n)
    _, scales = _pyramid(pos, jax.random.PRNGKey(0))
    s0 = scales[0]
    x = rng.standard_normal((b, n, 16)).astype(np.float32)
    mask = _padded_mask(rng, b, n)
    jargs = (jnp.asarray(x), s0.pos, s0.neighbor_idx)
    model = JDSConv(features=32)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *jargs)
        stats = _perturb_stats(variables["batch_stats"])
        ref, upd = jax.jit(lambda v, m, *a: model.apply(
            v, *a, mask=m, train=True, mutable=["batch_stats"]))(
                {"params": variables["params"], "batch_stats": stats},
                jnp.asarray(mask), *jargs)
    port = DSPointConv(16, 32, device="cpu")
    port.load_state_dict(from_flax(jax.device_get(variables["params"]),
                                   jax.device_get(stats)))
    port.train()
    got = port(*map(_t, jargs), WINDOWED, mask=_t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)
    ref_sd = from_flax(jax.device_get(variables["params"]),
                       jax.device_get(upd["batch_stats"]))
    for name, t in port.named_buffers():
        np.testing.assert_allclose(t.numpy(), ref_sd[name].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=name)


def test_guide_crf_conv_mask_matches_jax():
    """GuideCRFConv in train mode over padded clouds (radius mask on, three
    mean-field steps): the heads' masked batch statistics and the invalid
    neighbours out of the softmax, at rtol 2e-4; the running statistics
    too."""
    rng = np.random.default_rng(2)
    b, n, h = 2, 512, 16
    pos = _sorted_cloud(rng, b, n)
    _, scales = _pyramid(pos, jax.random.PRNGKey(0))
    s0 = scales[0]
    x = rng.standard_normal((b, n, 24)).astype(np.float32)
    y = rng.standard_normal((b, n, h)).astype(np.float32)
    mask = _padded_mask(rng, b, n)
    jargs = (jnp.asarray(x), jnp.asarray(y), s0.pos, s0.neighbor_idx)
    model = JGuide(out_features=h, steps=3, radius=0.1)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *jargs)
        params = dict(variables["params"])
        params["c"] = params["c"] + 0.1 * jnp.asarray(
            rng.standard_normal((h, h)).astype(np.float32))
        stats = _perturb_stats(variables["batch_stats"])
        ref, upd = jax.jit(lambda v, m, *a: model.apply(
            v, *a, mask=m, train=True, mutable=["batch_stats"]))(
                {"params": params, "batch_stats": stats},
                jnp.asarray(mask), *jargs)
    port = GuideCRFConv(24, h, h, steps=3, radius=0.1, device="cpu")
    port.load_state_dict(from_flax(jax.device_get(params),
                                   jax.device_get(stats)))
    port.train()
    got = port(*map(_t, jargs), WINDOWED, mask=_t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)
    ref_sd = from_flax(jax.device_get(params),
                       jax.device_get(upd["batch_stats"]))
    for name, t in port.named_buffers():
        np.testing.assert_allclose(t.numpy(), ref_sd[name].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=name)
    # the mask matters: without it the output differs
    port.load_state_dict(from_flax(jax.device_get(params),
                                   jax.device_get(stats)))
    free = port(*map(_t, jargs), WINDOWED).detach().numpy()
    assert np.abs(free - np.asarray(ref)).max() > 1e-2


def test_discrete_crf_conv_mask_matches_jax():
    """DiscreteCRFConv (steps 10, perturbed kernels and compatibilities)
    with a point-validity mask: edges from and to invalid points dropped,
    at rtol 2e-4."""
    rng = np.random.default_rng(3)
    b, n = 2, 512
    pos = _sorted_cloud(rng, b, n)
    logits = rng.standard_normal((b, n, 20))
    p = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    f = rng.random((b, n, 6)).astype(np.float32)
    idx = np.asarray(jwin.window_knn(jnp.asarray(pos), 32))
    mask = _padded_mask(rng, b, n)
    jargs = tuple(map(jnp.asarray, (pos, p, f, idx)))
    model = JDiscrete(n_classes=20, feat_features=6, steps=10)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        params = dict(jax.jit(lambda *a: model.init(
            jax.random.PRNGKey(0), *a, train=False))(*jargs)["params"])
        params["C"] = params["C"] + 0.1 * jnp.asarray(
            rng.standard_normal((20, 20)).astype(np.float32))
        ref = np.asarray(jax.jit(lambda v, m, *a: model.apply(
            v, *a, mask=m, train=False))({"params": params},
                                         jnp.asarray(mask), *jargs))
    port = DiscreteCRFConv(20, 6, steps=10, device="cpu")
    port.load_state_dict(from_flax(jax.device_get(params), {}))
    with torch.no_grad():
        got = port(*map(_t, (pos, p, f, idx)), WINDOWED,
                   mask=_t(mask)).numpy()
        free = port(*map(_t, (pos, p, f, idx)), WINDOWED).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert np.abs(free - ref).max() > 1e-3


@pytest.mark.parametrize("regime", ["exact", "windowed"])
@pytest.mark.parametrize("masked", [False, True])
def test_max_pool_neighbors_matches_jax(regime, masked):
    """The strided max-pool over a scale's sub_idx, with and without a slot
    mask (one row fully masked), in both gather regimes."""
    rng = np.random.default_rng(4)
    pos = _sorted_cloud(rng, 2, 1024)
    _, scales = _pyramid(pos, jax.random.PRNGKey(1))
    idx = np.asarray(scales[0].sub_idx)
    x = rng.standard_normal((2, 1024, 12)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random(idx.shape) > 0.3
        mask[0, 0] = False
    with neighbor_mode(regime):
        ref = np.asarray(jnb.max_pool_neighbors(
            jnp.asarray(x), jnp.asarray(idx),
            None if mask is None else jnp.asarray(mask)))
    got = max_pool_neighbors(_t(x), _t(idx), NeighborMode(regime),
                             None if mask is None else _t(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ops_exports_the_jax_names():
    for name in ("gather_neighbors", "upsample_nearest", "max_pool_neighbors",
                 "masked_softmax", "remove_self_loop", "knn_bruteforce",
                 "gaussian_similarity", "crf_mean_field",
                 "discrete_crf_update"):
        assert callable(getattr(ops, name)), name
        assert hasattr(jops, name), name

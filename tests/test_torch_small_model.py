"""The small model family of crfconv_tpu_torch against the JAX package on
the CPU, with the same weights (``from_flax``) and the same pyramid:
knn_interpolate, DSPointConv, GuideCRFConv at steps = 10 with its radius
mask, and the full-width CRFSegNet(steps=10) and BaselineSegNet at B2 x
1024, served through the Predictor."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.models import BaselineSegNet as JBaseline
from crfconv_tpu.models import CRFSegNet as JCRFSegNet
from crfconv_tpu.models.crf_conv import GuideCRFConv as JGuide
from crfconv_tpu.models.point_conv_small import DSPointConv as JDSConv
from crfconv_tpu.ops import neighbors as jnb
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu_torch import BaselineSegNet, CRFSegNet, Predictor, from_flax
from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models.crf_conv import GuideCRFConv
from crfconv_tpu_torch.models.point_conv_small import DSPointConv
from crfconv_tpu_torch.ops.neighbors import NeighborMode, knn_interpolate
from tests.test_torch_model import (
    RNGS, WINDOWED, _apply, _init, _load, _perturb_stats, _pyramid, _scales,
    _sorted_cloud, _t,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_train_step import _exact_windowed_gather

B, N = 2, 1024


@pytest.fixture(autouse=True)
def _exact_jax_gather(monkeypatch):
    """The JAX CPU gather selects with a hi/lo bfloat16 one-hot product (~16
    mantissa bits); the radius mask compares gathered distances with r^2,
    so that rounding could flip a slot. Taken exactly here (the function
    is the same)."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)


def test_knn_interpolate_matches():
    rng = np.random.default_rng(0)
    pos = _sorted_cloud(rng, 2, 512)
    _, scales = _pyramid(pos, jax.random.PRNGKey(0))
    s0, s1 = scales[0], scales[1]
    x = rng.standard_normal((2, s1.pos.shape[1], 24)).astype(np.float32)
    up3 = np.concatenate([np.asarray(s0.up_idx)] * 3, axis=-1)
    up3[..., 1:] = np.clip(up3[..., 1:] + rng.integers(-3, 4, up3[..., 1:].shape),
                           0, s1.pos.shape[1] - 1)
    for up in (np.asarray(s0.up_idx), up3.astype(np.int32)):
        with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
            ref = jnb.knn_interpolate(jnp.asarray(x), s1.pos, s0.pos,
                                      jnp.asarray(up))
        got = knn_interpolate(_t(x), _t(s1.pos), _t(s0.pos), _t(up), WINDOWED)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("strided", [False, True])
def test_ds_point_conv_matches(strided):
    rng = np.random.default_rng(1)
    pos = _sorted_cloud(rng, 1, 1024)
    _, scales = _pyramid(pos, jax.random.PRNGKey(0))
    s0, s1 = scales[0], scales[1]
    x = rng.standard_normal((1, 1024, 16)).astype(np.float32)
    if strided:
        jargs = (jnp.asarray(x), s0.pos, s0.sub_idx, s1.pos)
    else:
        jargs = (jnp.asarray(x), s0.pos, s0.neighbor_idx)
    model = JDSConv(features=32)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *jargs)
        variables = {**variables,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        ref = np.asarray(_apply(model, variables, *jargs))
    port = _load(DSPointConv(16, 32, device="cpu"), variables)
    args = [_t(a) for a in jargs]
    got = port(*args[:3], WINDOWED,
               sub_pos=args[3] if strided else None).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_guide_crf_conv_matches():
    """Radius mask on, steps = 10: the port's fused core (plain versions)
    against the JAX block's scan."""
    rng = np.random.default_rng(2)
    n, h = 1024, 32
    pos = _sorted_cloud(rng, 1, n)
    _, scales = _pyramid(pos, jax.random.PRNGKey(0))
    s0 = scales[0]
    x = rng.standard_normal((1, n, 64)).astype(np.float32)
    y = rng.standard_normal((1, n, h)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(y), s0.pos, s0.neighbor_idx)
    model = JGuide(out_features=h, steps=10, radius=0.1)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *jargs)
        params = dict(variables["params"])
        params["c"] = params["c"] + 0.1 * jnp.asarray(
            rng.standard_normal((h, h)).astype(np.float32))
        variables = {"params": params,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        ref = np.asarray(_apply(model, variables, *jargs))
    port = _load(GuideCRFConv(64, h, h, steps=10, radius=0.1, device="cpu"),
                 variables)
    # the mask is neither empty nor full at this radius
    d2 = ((pos[:, :, None] - pos[0][np.asarray(s0.neighbor_idx)[0, :, 1:]])
          ** 2).sum(-1)
    assert 0.05 < (d2 <= 0.01).mean() < 0.95
    got = port(*map(_t, jargs), WINDOWED).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def small_nets():
    """Full-width CRFSegNet(steps=10) and BaselineSegNet on one JAX-built
    pyramid (B2 x 1024), variables with non-trivial batch statistics, and
    their JAX log-probabilities."""
    rng = np.random.default_rng(3)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    order, scales = _pyramid(pos, key)
    x = jnp.take_along_axis(jnp.asarray(feats), order[..., None], axis=1)
    batch = JBatch(x=x, y=None, scales=scales)
    out = {"pos": pos, "feats": feats, "key": key, "x": x, "scales": scales,
           "order": np.asarray(order)}
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        for name, model in (("crf", JCRFSegNet(n_classes=20, steps=10)),
                            ("baseline", JBaseline(n_classes=20))):
            with neighbor_mode("windowed"), \
                    jax.default_matmul_precision("highest"):
                variables = _init(model, RNGS, batch)
                variables = {**variables, "batch_stats": _perturb_stats(
                    variables["batch_stats"])}
                out[name] = (variables,
                             np.asarray(_apply(model, variables, batch)))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", ["crf", "baseline"])
def test_small_segnet_log_probs_match(small_nets, name):
    variables, ref = small_nets[name]
    cls = CRFSegNet if name == "crf" else BaselineSegNet
    kw = {"steps": 10} if name == "crf" else {}
    model = _load(cls(20, 6, device="cpu", **kw), variables)
    batch = PointBatch(x=_t(small_nets["x"]), y=None,
                       scales=_scales(small_nets["scales"]))
    with torch.no_grad():
        got = model(batch, WINDOWED).numpy()
    assert got.shape == ref.shape == (B, N, 20)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_from_flax_covers_every_tensor(small_nets):
    variables = small_nets["crf"][0]
    sd = from_flax(jax.device_get(variables["params"]),
                   jax.device_get(variables["batch_stats"]))
    model = CRFSegNet(20, 6, steps=10, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    np.testing.assert_array_equal(
        sd["feature.deconv4.c"].numpy(),
        np.asarray(variables["params"]["feature"]["deconv4"]["c"]))
    np.testing.assert_array_equal(
        sd["classifier.fc1.weight"].numpy(),
        np.asarray(variables["params"]["classifier"]["fc1"]["kernel"]).T)


def test_fresh_classifier_biases_are_zero():
    """flax's nn.Dense starts its bias at zero; a from_flax parity test
    cannot see the init, so it is checked here."""
    model = CRFSegNet(20, 6, steps=10, device="cpu")
    assert not model.classifier.fc1.bias.any()
    assert not model.classifier.fc2.bias.any()
    assert model.classifier.fc1.weight.abs().max() <= 1 / 8   # 1/sqrt(64)
    torch.testing.assert_close(model.feature.deconv1.c, torch.eye(32))


def test_predictor_serves_crf_segnet(small_nets):
    """Log-probabilities in the input order: the Predictor's output, put in
    the pyramid's order, is the model's on that pyramid."""
    variables, _ = small_nets["crf"]
    model = _load(CRFSegNet(20, 6, steps=10, device="cpu"), variables)
    mode = NeighborMode("windowed", knn_exact=True)
    pred = Predictor(model, mode=mode, device="cpu")
    offsets = jax_offsets(small_nets["key"], N)
    got = pred.predict_logits(small_nets["pos"], small_nets["feats"],
                              offsets=offsets)
    labels = pred.predict(small_nets["pos"], small_nets["feats"],
                          offsets=offsets)
    assert torch.equal(labels, got.argmax(-1))
    order = torch.from_numpy(small_nets["order"].astype(np.int64))
    batch = PointBatch(x=_t(small_nets["x"]), y=None,
                       scales=_scales(small_nets["scales"]))
    with torch.no_grad():
        ref = model(batch, mode)
    torch.testing.assert_close(
        torch.take_along_dim(got, order[..., None], dim=1), ref,
        rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.exp().sum(-1), torch.ones(B, N))

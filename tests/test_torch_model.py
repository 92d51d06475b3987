"""crfconv_tpu_torch modules against the JAX package on the CPU, with the
same weights (``from_flax``) and the same pyramid: PointConv, the CRF
decoder block and the narrow flagship model."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.models.crf_conv import ContinuousCRFConv as JCRF
from crfconv_tpu.models.point_conv_big import PointConv as JPointConv
from crfconv_tpu.ops import conv_pallas, crf_sim_pallas
from crfconv_tpu.ops.morton import morton_order_np
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.ops.windowed import build_pyramid_windowed as j_pyramid
from crfconv_tpu_torch import PointConvResNet, from_flax
from crfconv_tpu_torch.data.batch import PointBatch, ScaleData
from crfconv_tpu_torch.models.crf_conv import ContinuousCRFConv
from crfconv_tpu_torch.models.point_conv_big import PointConv
from crfconv_tpu_torch.ops import conv, crf_sim
from crfconv_tpu_torch.ops.neighbors import NeighborMode

WINDOWED = NeighborMode("windowed")
NARROW = (16, 32, 64, 128, 256)
RNGS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb_stats(stats):
    """Non-trivial running statistics, so the batch-norm fold matters."""
    return jax.tree.map(
        lambda a: a + 0.1 + 0.05 * jnp.arange(a.size, dtype=a.dtype), stats
    )


def _load(module, variables):
    module.load_state_dict(
        from_flax(jax.device_get(variables["params"]),
                  jax.device_get(variables["batch_stats"]))
    )
    return module.eval()


def _scales(scales_j):
    return tuple(
        ScaleData(*(_t(getattr(s, f)) for f in ScaleData._fields))
        for s in scales_j
    )


def _init(model, rngs, *args, **kw):
    """model.init under jit (eager init dispatches op by op, ~5x slower)."""
    return jax.jit(lambda *a: model.init(rngs, *a, train=False, **kw))(*args)


def _apply(model, variables, *args, **kw):
    return jax.jit(lambda v, *a: model.apply(v, *a, train=False, **kw))(
        variables, *args
    )


def _pyramid(pos, key):
    return jax.jit(lambda p, k: j_pyramid(p, key=k))(jnp.asarray(pos), key)


def _sorted_cloud(rng, b, n):
    pos = rng.random((b, n, 3)).astype(np.float32)
    for i in range(b):
        pos[i] = pos[i][morton_order_np(pos[i])]
    return pos


@pytest.mark.parametrize("fused", [True, False])
def test_point_conv_eval_matches(fused, monkeypatch):
    rng = np.random.default_rng(0)
    n, k, h = 1024, 16, 8
    pos = _sorted_cloud(rng, 1, n)
    x = rng.standard_normal((1, n, h)).astype(np.float32)
    idx = np.clip(
        np.arange(n)[None, :, None] + rng.integers(-48, 48, (1, n, k)), 0, n - 1
    ).astype(np.int32)
    args = tuple(map(jnp.asarray, (x, pos, idx)))
    model = JPointConv(d_model=h)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *args)
        variables = {**variables,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        if fused:   # the Pallas kernel, in interpret mode, at this size
            monkeypatch.setattr(conv_pallas, "FUSED_INTERPRET", True)
            monkeypatch.setattr(conv_pallas, "FUSED_MIN_ROWS", 0)
            monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 0)
        ref = np.asarray(_apply(model, variables, *args))
    port = _load(PointConv(h, device="cpu"), variables)
    got = port(_t(x), _t(pos), _t(idx), WINDOWED).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_point_conv_strided_matches():
    rng = np.random.default_rng(1)
    n, m, k, h, r = 1024, 256, 16, 8, 32
    pos = _sorted_cloud(rng, 1, n)
    sub_pos = np.ascontiguousarray(pos[:, ::4])
    x = rng.standard_normal((1, n, h)).astype(np.float32)
    res = rng.standard_normal((1, n, r)).astype(np.float32)
    idx = np.clip(
        (np.arange(m) * 4)[None, :, None] + rng.integers(-48, 48, (1, m, k)),
        0, n - 1,
    ).astype(np.int32)
    model = JPointConv(d_model=h)
    jargs = tuple(map(jnp.asarray, (x, pos, idx)))
    jargs += (jnp.asarray(sub_pos), jnp.asarray(res))
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *jargs)
        variables = {**variables,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        ref, ref_r = _apply(model, variables, *jargs)
    port = _load(PointConv(h, device="cpu"), variables)
    got, got_r = port(_t(x), _t(pos), _t(idx), WINDOWED, sub_pos=_t(sub_pos),
                      extra=_t(res))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)
    # the JAX CPU gather's hi/lo split floor
    np.testing.assert_allclose(got_r.detach().numpy(), np.asarray(ref_r),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("steps,fused", [(1, True), (1, False), (2, False)])
def test_crf_conv_matches(steps, fused, monkeypatch):
    rng = np.random.default_rng(2)
    n, h_out = 1024, 32
    pos = _sorted_cloud(rng, 1, n)
    _, scales = _pyramid(pos, jax.random.PRNGKey(0))
    s0, s1 = scales[0], scales[1]
    unary = rng.standard_normal((1, s1.pos.shape[1], 64)).astype(np.float32)
    pairwise = rng.standard_normal((1, n, h_out)).astype(np.float32)
    jargs = (jnp.asarray(unary), jnp.asarray(pairwise), s0.up_idx,
             s0.neighbor_idx)
    model = JCRF(out_features=h_out, steps=steps)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, jax.random.PRNGKey(0), *jargs)
        params = jax.tree.map(lambda a: a, variables["params"])
        params["c"] = params["c"] + 0.1 * jnp.asarray(
            rng.standard_normal(params["c"].shape).astype(np.float32)
        )
        variables = {"params": params,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        if fused:   # the Pallas kernel, in interpret mode, at this size
            monkeypatch.setattr(crf_sim_pallas, "SIM_INTERPRET", True)
            monkeypatch.setattr(crf_sim_pallas, "SIM_MIN_ROWS", 0)
            monkeypatch.setattr(crf_sim, "SIM_MIN_ROWS", 0)
        ref = np.asarray(_apply(model, variables, *jargs))
    port = _load(ContinuousCRFConv(64, h_out, h_out, steps, device="cpu"),
                 variables)
    got = port(_t(unary), _t(pairwise), _t(s0.up_idx), _t(s0.neighbor_idx),
               WINDOWED).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _flagship_case(c_in: int, n_classes: int):
    """A narrow flagship (B2 x 1024) with ``c_in`` input channels and
    ``n_classes`` classes on a JAX-built pyramid, its variables with
    non-trivial batch statistics, and its JAX logits."""
    rng = np.random.default_rng(3)
    pos = rng.random((2, 1024, 3)).astype(np.float32)
    feats = rng.random((2, 1024, c_in)).astype(np.float32)
    order, scales = _pyramid(pos, jax.random.PRNGKey(1))
    x = jnp.take_along_axis(jnp.asarray(feats), order[..., None], axis=1)
    batch = JBatch(x=x, y=None, scales=scales)
    model = JResNet(n_classes=n_classes, use_crf=True, steps=1, layers=NARROW)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, RNGS, batch)
        variables = {**variables,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        logits = _apply(model, variables, batch)
    return variables, x, scales, np.asarray(logits)


@pytest.fixture(scope="module")
def narrow_flagship():
    """The narrow flagship at S3DIS's 6 input channels and 13 classes."""
    return _flagship_case(6, 13)


@pytest.fixture(scope="module")
def kitti_flagship():
    """The narrow flagship at SemanticKITTI's 4 input channels and 19
    classes."""
    return _flagship_case(4, 19)


def _check_flagship_logits(case, c_in, n_classes, fused, monkeypatch):
    variables, x, scales, ref = case
    if fused:   # route every eligible layer through the K3/K4 plain versions
        monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 0)
        monkeypatch.setattr(crf_sim, "SIM_MIN_ROWS", 0)
    model = _load(
        PointConvResNet(n_classes, c_in, use_crf=True, steps=1, layers=NARROW,
                        device="cpu"),
        variables,
    )
    with torch.no_grad():
        got = model(PointBatch(x=_t(x), y=None, scales=_scales(scales)),
                    WINDOWED).numpy()
    assert got.shape == ref.shape == (2, 1024, n_classes)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_flagship_logits_match(narrow_flagship, fused, monkeypatch):
    _check_flagship_logits(narrow_flagship, 6, 13, fused, monkeypatch)


@pytest.mark.parametrize("fused", [False, True])
def test_kitti_flagship_logits_match(kitti_flagship, fused, monkeypatch):
    """SemanticKITTI's flagship: 4 input channels (x, y, z, remission), 19
    classes."""
    _check_flagship_logits(kitti_flagship, 4, 19, fused, monkeypatch)


def test_from_flax_covers_every_tensor(narrow_flagship):
    variables = narrow_flagship[0]
    sd = from_flax(jax.device_get(variables["params"]),
                   jax.device_get(variables["batch_stats"]))
    model = PointConvResNet(13, 6, layers=NARROW, device="cpu")
    assert set(sd) == set(model.state_dict())
    w = np.asarray(variables["params"]["conv1_1"]["lin_in"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(sd["conv1_1.lin_in.weight"].numpy(), w.T)
    v = np.asarray(variables["batch_stats"]["deconv1"]["out_nn"]
                   ["MaskedBatchNorm_0"]["var"])
    np.testing.assert_array_equal(sd["deconv1.out_nn.bn.var"].numpy(), v)

"""The strided fused point convolution (kernel K5, ``ops/conv.py::
point_conv_fused_strided``) on the CPU, where the wrapper runs its plain
version: against the JAX package's Pallas ``point_conv_fused_strided`` in
interpret mode and against the port's unfused strided ``PointConv``, with
neighbour rows outside the cloud (they read zero) and riders whose width is
not a multiple of 8; its dispatch guard; and a narrow flagship whose
eligible layers, the strided ones included, take the fused route in both
packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.ops import conv_pallas
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu_torch import PointConvResNet
from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models import point_conv_big
from crfconv_tpu_torch.models.point_conv_big import PointConv
from crfconv_tpu_torch.ops import conv
from tests.test_torch_model import (
    NARROW, RNGS, WINDOWED, _apply, _init, _load, _perturb_stats, _pyramid,
    _scales, _sorted_cloud, _t,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401


def _inputs(b, n, m, k, h, r, seed):
    """Fine cloud, every (n/m)-th point as a center, neighbour indices
    around each center that run past both ends of the cloud, folded
    batch-norm weights."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([_sorted_cloud(rng, 1, n) for _ in range(b)])
    sub_pos = np.ascontiguousarray(pos[:, :: n // m])
    x = rng.standard_normal((b, n, h)).astype(np.float32)
    res = rng.standard_normal((b, n, r)).astype(np.float32)
    idx = ((np.arange(m) * (n // m))[None, :, None]
           + rng.integers(-48, 48, (b, m, k))).astype(np.int32)
    assert (idx < 0).any() and (idx >= n).any()
    w0 = rng.standard_normal((3, h)).astype(np.float32)
    w1 = (rng.standard_normal((h, h)) / np.sqrt(h)).astype(np.float32)
    aff = [(0.5 + rng.random(h)).astype(np.float32) if i % 2 == 0
           else (0.1 * rng.standard_normal(h)).astype(np.float32)
           for i in range(4)]
    return (x, pos, sub_pos, idx, res, w0, aff[0], aff[1], w1, aff[2],
            aff[3])


@pytest.mark.parametrize("b,n,m,k,h,r", [
    (2, 1024, 256, 16, 16, 13),     # conv2_1's hidden width, a ragged rider
    (1, 512, 128, 16, 32, 64),      # conv3_1's
    (1, 300, 75, 8, 8, 20),         # ragged tiles
])
def test_matches_pallas_interpret(b, n, m, k, h, r):
    args = _inputs(b, n, m, k, h, r, seed=h + r)
    ref, ref_r = conv_pallas.point_conv_fused_strided(
        *map(jnp.asarray, args), interpret=True)
    got, got_r = conv.point_conv_fused_strided(*map(_t, args))
    assert got.shape == (b, m, h) and got_r.shape == (b, m, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), rtol=2e-4,
                               atol=2e-5)


def test_rider_max_includes_rows_outside_the_cloud():
    """A neighbour row outside [0, N) reads a zero rider: with a negative
    rider everywhere, the max is 0 exactly where some neighbour is outside
    the cloud."""
    x, pos, sub_pos, idx, res, *mlp = _inputs(1, 256, 64, 8, 8, 5, seed=1)
    res = -1.0 - np.abs(res)
    _, got_r = conv.point_conv_fused_strided(
        *map(_t, (x, pos, sub_pos, idx, res, *mlp)))
    outside = ((idx < 0) | (idx >= 256)).any(-1)
    assert outside.any() and not outside.all()
    np.testing.assert_array_equal(got_r.numpy()[outside], 0.0)
    assert (got_r.numpy()[~outside] < 0).all()


def test_matches_unfused_point_conv(monkeypatch):
    """A strided eval PointConv through the fused route (K5's plain version)
    against the same block through the unfused funnel."""
    x, pos, sub_pos, idx, res, *_ = _inputs(2, 1024, 256, 16, 16, 64, seed=7)
    gen = torch.Generator().manual_seed(0)
    block = PointConv(16, device="cpu")
    with torch.no_grad():
        for mlp in (block.weight_nn_0, block.weight_nn_1):
            mlp.reset_parameters(gen)
            f = mlp.bn.mean.numel()
            mlp.bn.mean.copy_(0.1 * torch.randn(f, generator=gen))
            mlp.bn.var.copy_(0.5 + torch.rand(f, generator=gen))
            mlp.bn.scale.copy_(0.8 + 0.4 * torch.rand(f, generator=gen))
            mlp.bn.bias.copy_(0.1 * torch.randn(f, generator=gen))
    block.eval()
    calls = []
    strided = point_conv_big.point_conv_fused_strided
    monkeypatch.setattr(point_conv_big, "point_conv_fused_strided",
                        lambda *a: calls.append(1) or strided(*a))
    targs = (_t(x), _t(pos), _t(idx), WINDOWED)
    kw = dict(sub_pos=_t(sub_pos), extra=_t(res))
    with torch.no_grad():
        monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 10**9)
        ref, ref_r = block(*targs, **kw)
        assert not calls
        monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 0)
        got, got_r = block(*targs, **kw)
        assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got_r, ref_r, rtol=0, atol=0)


@pytest.mark.parametrize("training,hidden,rows,strided,rider,expect", [
    (False, 16, 16384, True, True, True),      # conv2_1 at Semantic3D
    (False, 32, 4096, True, True, True),       # conv3_1
    (False, 16, 2048, True, True, False),      # conv2_1 at S3DIS
    (False, 64, 4096, True, True, False),      # too wide
    (True, 16, 16384, True, True, False),      # training
    (False, 16, 16384, True, False, False),    # strided without a rider
    (False, 16, 16384, False, True, False),    # a rider without strides
    (False, 8, 65536, False, False, True),     # conv1_1 (K3)
])
def test_fused_eligible(training, hidden, rows, strided, rider, expect):
    assert conv.fused_eligible(training, hidden, rows, True, strided,
                               rider) is expect
    assert not conv.fused_eligible(training, hidden, rows, False, strided,
                                   rider)


def test_flagship_strided_route_matches_jax(monkeypatch):
    """A narrow flagship (B1 x 1024) whose eligible layers all run fused
    (the row guard off): the JAX package through its Pallas kernels in
    interpret mode, the port through the K3/K5 plain versions."""
    rng = np.random.default_rng(5)
    pos = rng.random((1, 1024, 3)).astype(np.float32)
    feats = rng.random((1, 1024, 6)).astype(np.float32)
    order, scales = _pyramid(pos, jax.random.PRNGKey(2))
    x = jnp.take_along_axis(jnp.asarray(feats), order[..., None], axis=1)
    batch = JBatch(x=x, y=None, scales=scales)
    model = JResNet(n_classes=13, use_crf=True, steps=1, layers=NARROW)
    jcalls = []
    jstrided = conv_pallas.point_conv_fused_strided
    monkeypatch.setattr(conv_pallas, "FUSED_MIN_ROWS", 0)
    monkeypatch.setattr(conv_pallas, "FUSED_INTERPRET", True)
    monkeypatch.setattr(conv_pallas, "point_conv_fused_strided",
                        lambda *a, **k: jcalls.append(1) or jstrided(*a, **k))
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        variables = _init(model, RNGS, batch)
        variables = {**variables,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        jcalls.clear()
        ref = np.asarray(_apply(model, variables, batch))
    assert len(jcalls) == 3     # conv2_1, conv3_1, conv4_1 (hidden <= 32)
    calls = []
    strided = point_conv_big.point_conv_fused_strided
    monkeypatch.setattr(point_conv_big, "point_conv_fused_strided",
                        lambda *a: calls.append(1) or strided(*a))
    monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 0)
    port = _load(PointConvResNet(13, 6, use_crf=True, steps=1, layers=NARROW,
                                 device="cpu"), variables)
    with torch.no_grad():
        got = port(PointBatch(x=_t(x), y=None, scales=_scales(scales)),
                   WINDOWED).numpy()
    assert len(calls) == 3
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)

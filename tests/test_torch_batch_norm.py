"""The MLPs' batch norm and leaky ReLU (``ops/batch_norm.py``, kernel K16).

On the CPU: the plain versions against ``MaskedBatchNorm``'s PyTorch ops
and ``leaky_relu`` (values, running statistics and gradients, flax's
gradient at 0), and the dispatch (``fallback_reason``) with its counter.
On the card (marked ``cuda``, skipped without one): the kernels against the
plain versions at F 3 to 512, rows off the chunking, with and without the
activation, inputs whose affine output is exactly 0, reruns bit for bit;
the flagship's every batch norm on the kernels, a request and a step; a
mask, a mesh and bfloat16 kept on PyTorch's ops.

On the card run

    python -m pytest --noconftest -m cuda tests/test_torch_batch_norm.py
"""

from __future__ import annotations

import contextlib
import zlib

import pytest
import torch

from crfconv_tpu_torch import cuda_build
from crfconv_tpu_torch.models.common import (
    BN_MOMENTUM, MLP, MaskedBatchNorm, compute_dtype_scope, leaky_relu01,
)
from crfconv_tpu_torch.ops import batch_norm, spatial_state
from crfconv_tpu_torch.ops.activation import leaky_relu
from crfconv_tpu_torch.utils import profiling

EPS = 1e-5


def _bn(f, generator, dtype=torch.float32, device="cpu"):
    """A MaskedBatchNorm with drawn scale, bias and running statistics."""
    m = MaskedBatchNorm(f).to(dtype)
    with torch.no_grad():
        for p, lo, hi in ((m.scale, 0.5, 1.5), (m.bias, -0.5, 0.5),
                          (m.mean, -0.2, 0.2), (m.var, 0.5, 1.5)):
            p.copy_(torch.rand(f, generator=generator, dtype=dtype)
                    * (hi - lo) + lo)
    return m.to(device)


def _twin(m):
    t = MaskedBatchNorm(m.scale.shape[0]).to(m.scale.dtype)
    t.load_state_dict(m.state_dict())
    return t.to(m.scale.device).train(m.training)


# --------------------------------------------------------------------------
# the CPU: plain versions and dispatch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("slope", [None, 0.1, 0.01])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape", [(3, 37, 16), (130, 8), (2, 5, 7, 3)])
def test_plain_is_masked_batch_norm(shape, training, slope, dtype, tol):
    """batch_norm_act's plain path (CPU tensors) against MaskedBatchNorm's
    ops and leaky_relu: the same values and running statistics, and
    gradients of x, scale and bias within ``tol`` of the larger."""
    gen = torch.Generator().manual_seed(zlib.crc32(repr(shape).encode()))
    f = shape[-1]
    ref = _bn(f, gen, dtype).train(training)
    got = _twin(ref)
    x = torch.randn(shape, generator=gen, dtype=dtype)
    g = torch.randn(shape, generator=gen, dtype=dtype)
    xr = x.clone().requires_grad_(True)
    y_ref = ref._norm(xr, None)
    if slope is not None:
        y_ref = leaky_relu(y_ref, slope)
    y_ref.backward(g)
    xg = x.clone().requires_grad_(True)
    y = batch_norm.batch_norm_act(xg, got.scale, got.bias, got.mean, got.var,
                                  EPS, slope, training, BN_MOMENTUM)
    y.backward(g)
    assert torch.equal(y, y_ref)
    assert torch.equal(got.mean, ref.mean) and torch.equal(got.var, ref.var)
    for a, b in ((xg.grad, xr.grad), (got.scale.grad, ref.scale.grad),
                 (got.bias.grad, ref.bias.grad)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * b.abs().max())


@pytest.mark.parametrize("training", [True, False])
def test_plain_gradient_at_zero_is_flax(training):
    """Where the affine output is exactly 0 the activation's gradient is 1
    (flax's), not the slope: the plain backward and autograd through
    MaskedBatchNorm and leaky_relu agree on such rows."""
    m = MaskedBatchNorm(2)
    with torch.no_grad():   # eval: mean 0, var 1 - eps: invstd exactly 1
        m.var.fill_(1.0 - EPS)
    m.train(training)
    # each column's batch mean is 0, so the middle row's z is exactly 0
    x = torch.tensor([[-1.0, -2.0], [0.0, 0.0], [1.0, 2.0]])
    g = torch.ones_like(x)
    xg = x.clone().requires_grad_(True)
    ref = _twin(m)
    y = batch_norm.batch_norm_act(xg, m.scale, m.bias, m.mean, m.var, EPS,
                                  0.1, training, BN_MOMENTUM)
    assert torch.equal(y[1], torch.zeros(2))
    y.backward(g)
    xr = x.clone().requires_grad_(True)
    leaky_relu(ref._norm(xr, None), 0.1).backward(g)
    torch.testing.assert_close(xg.grad, xr.grad, rtol=1e-6, atol=1e-7)
    dbias = batch_norm.batch_norm_bwd_plain(
        x, g, torch.zeros(2), torch.ones(2), torch.ones(2), torch.zeros(2),
        0.1, training)[2]
    assert torch.equal(dbias, torch.full((2,), 2.1))  # 1 + 1 at 0 + 0.1


class _Mesh:
    def __init__(self, world):
        self.world = world


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("case,reason", [
    ("plain", "cpu"), ("mask", "mask"), ("mesh", "mesh"),
    ("mesh_of_one", "cpu"), ("bf16", "dtype"), ("strided", "layout"),
    ("empty", "layout"),
])
def test_fallback_reason(case, reason, training):
    """The dispatch keeps a masked call, a data-parallel mesh's statistics,
    a narrower dtype, a strided or empty x and CPU tensors on PyTorch's
    ops; a mesh of one rank is no mesh. Eval computes no statistics, so a
    mask or a mesh does not keep it there."""
    m = MaskedBatchNorm(8)
    x = torch.randn(4, 16, 8)
    mask = None
    ctx = None
    if case == "mask":
        mask = torch.ones(4, 16, dtype=torch.bool)
    elif case in ("mesh", "mesh_of_one"):
        ctx = {"data": _Mesh(2 if case == "mesh" else 1)}
    elif case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "strided":
        x = x.transpose(0, 1)
    elif case == "empty":
        x = x[:0]
    if not training and reason in ("mask", "mesh"):
        reason = "cpu"
    params = (m.scale, m.bias, m.mean, m.var)
    with spatial_state.activate(ctx) if ctx else contextlib.nullcontext():
        assert batch_norm.fallback_reason(x, mask, training,
                                          *params) == reason


def test_fallback_counter_counts():
    """CPU calls count nothing, whatever keeps them on PyTorch's ops (a
    mask, a mesh's statistics, the bfloat16 compute dtype or the CPU
    itself): the counter is the card's (its counts there:
    test_card_fallbacks_keep_pytorch_ops)."""
    mlp = MLP(6, 8, leaky_relu01)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 6)
    before = profiling.bn_fallbacks()
    mlp(x)
    mlp(x, torch.ones(2, 16, dtype=torch.bool))
    with compute_dtype_scope(torch.bfloat16):
        mlp(x)
    mlp.eval()
    with spatial_state.activate({"data": _Mesh(2)}):
        mlp(x)
    assert profiling.bn_fallbacks() == before


def test_mlp_applies_the_slope_through_the_norm():
    """An MLP whose activation is a leaky ReLU hands its slope to the norm;
    the output is the norm's followed by the activation, as before."""
    gen = torch.Generator().manual_seed(1)
    for act in (leaky_relu01, None):
        mlp = MLP(5, 12, act)
        mlp.reset_parameters(gen)
        x = torch.randn(3, 40, 5, generator=gen)
        ref = _twin(mlp.bn)
        h = torch.nn.functional.linear(x, mlp.weight)
        want = ref(h)
        if act is not None:
            want = act(want)
        assert torch.equal(mlp(x), want)
        assert torch.equal(mlp.bn.mean, ref.mean)


@pytest.mark.parametrize("rows,f", [(1, 8), (4096, 512), (16 * 65536 * 16, 8),
                                    (16 * 65536, 128), (1000, 3)])
def test_chunks_of(rows, f):
    """A reduction's chunks: at least one, at most a wave of resident
    blocks, each thread at least MIN_ROWS rows where there are enough."""
    c = batch_norm.chunks_of(rows, f, 132)
    v = f // 4 if f % 4 == 0 else f
    ry = batch_norm.THREADS // min(v, batch_norm.THREADS)
    assert 1 <= c <= batch_norm.BLOCKS_PER_SM * 132
    assert c == 1 or rows >= c * ry * batch_norm.MIN_ROWS - ry * \
        batch_norm.MIN_ROWS


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------


@pytest.fixture
def dev(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(zlib.crc32(request.node.nodeid.encode()))
    return torch.device("cuda")


WIDTHS = [3, 8, 16, 32, 64, 128, 256, 512]
# rows off every chunking: odd, below a block's pass, one past a power of 2
ROWS = [1, 5, 1000, 65537, 300001]


def _inputs(rows, f, dev, zeros=False):
    gen = torch.Generator().manual_seed(rows * 1000 + f)
    bn = _bn(f, gen, device=dev)
    x = (torch.randn(rows, f, generator=gen) * 2 + 0.5).to(dev)
    if zeros:
        # bias 0 and x at the running mean: z is exactly 0 in eval; rows of
        # the mean in training put x - mean near 0
        with torch.no_grad():
            bn.bias.zero_()
        x[::3] = bn.mean
    return bn, x


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("f", WIDTHS)
def test_stats_match_plain(dev, f, rows):
    """The batch's mean and invstd and the running statistics' update
    against the plain version in float64 (rtol 1e-5 and 1e-6: the
    reduction order), and a rerun bit for bit."""
    bn, x = _inputs(rows, f, dev)
    rm, rv = bn.mean.clone(), bn.var.clone()
    mean, invstd = batch_norm.batch_norm_stats(x, bn.mean, bn.var, EPS, 0.9)
    rm64, rv64 = rm.double().cpu(), rv.double().cpu()
    m64, i64 = batch_norm.batch_norm_stats_plain(
        x.double().cpu(), rm64, rv64, EPS, 0.9)
    scale = x.double().abs().max().item()
    torch.testing.assert_close(mean.double().cpu(), m64, rtol=1e-5,
                               atol=1e-6 * scale)
    torch.testing.assert_close(invstd.double().cpu(), i64, rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(bn.mean.double().cpu(), rm64, rtol=1e-5,
                               atol=1e-6 * scale)
    torch.testing.assert_close(bn.var.double().cpu(), rv64, rtol=1e-5,
                               atol=1e-6)
    rm2, rv2 = rm.clone(), rv.clone()
    again = batch_norm.batch_norm_stats(x, rm2, rv2, EPS, 0.9)
    assert torch.equal(again[0], mean) and torch.equal(again[1], invstd)
    assert torch.equal(rm2, bn.mean) and torch.equal(rv2, bn.var)


@pytest.mark.cuda
def test_stats_large_offset_does_not_cancel(dev):
    """A column of mean 1e4 and spread 1: the variance comes out within
    1e-4 of the float64 one (a one-pass sum of squares in float32 would
    lose it)."""
    x = torch.randn(1 << 20, 8, device=dev, dtype=torch.float64)
    x32 = (x + 1e4).float()
    rm, rv = torch.zeros(8, device=dev), torch.ones(8, device=dev)
    _, invstd = batch_norm.batch_norm_stats(x32, rm, rv, EPS, 0.9)
    var64 = x32.double().var(dim=0, unbiased=False)
    torch.testing.assert_close(invstd.double(), torch.rsqrt(var64 + EPS),
                               rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("s2_is_var", [False, True])
@pytest.mark.parametrize("slope", [None, 0.1])
@pytest.mark.parametrize("rows", [5, 65537])
@pytest.mark.parametrize("f", WIDTHS)
def test_apply_matches_plain(dev, f, rows, slope, s2_is_var, zeros):
    """y against the plain version on the card: bit for bit given invstd
    (both round each operation alike), within 1 ulp's effect given the
    variance (rsqrt against 1 / sqrt)."""
    bn, x = _inputs(rows, f, dev, zeros)
    s2 = bn.var if s2_is_var else torch.rsqrt(bn.var + EPS)
    args = (x, bn.mean, s2, bn.scale, bn.bias, EPS, slope, s2_is_var)
    with torch.no_grad():
        y = batch_norm.batch_norm_apply(*args)
        ref = batch_norm.batch_norm_apply_plain(*args)
    if s2_is_var:
        torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(y, ref)
    assert torch.equal(batch_norm.batch_norm_apply(*args), y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "sliced", "zeros"])
@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("slope", [None, 0.1])
@pytest.mark.parametrize("rows", [5, 65537])
@pytest.mark.parametrize("f", WIDTHS)
def test_bwd_matches_plain(dev, f, rows, slope, batch, case):
    """dx, dscale and dbias against the plain version in float64 on the
    same z masks (rtol 1e-4, atol 1e-5 of the largest), g dense or a slice
    of a wider tensor read in place, and a rerun bit for bit. The mean and
    invstd are the running ones (the backward takes any), so that rows at
    the mean have z exactly 0."""
    bn, x = _inputs(rows, f, dev, zeros=case == "zeros")
    mean, invstd = bn.mean, torch.rsqrt(bn.var + EPS)
    if case == "sliced":
        g = torch.randn(rows, f + 5, device=dev)[:, 2:2 + f]
    else:
        g = torch.randn(rows, f, device=dev)
    args = (x, g, mean, invstd, bn.scale, bn.bias, slope, batch)
    got = batch_norm.batch_norm_bwd(*args)
    z = (x - mean) * invstd * bn.scale + bn.bias     # the kernel's masks
    g64 = g.double() if slope is None else torch.where(
        z >= 0, g.double(), g.double() * slope)
    ref = batch_norm.batch_norm_bwd_plain(
        x.double(), g64, mean.double(), invstd.double(), bn.scale.double(),
        bn.bias.double(), None, batch)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.double(), b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())
    again = batch_norm.batch_norm_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("slope", [None, 0.1])
def test_autograd_matches_masked_batch_norm(dev, training, slope):
    """batch_norm_act through autograd on the card against MaskedBatchNorm's
    ops and leaky_relu on the card: outputs, running statistics and
    gradients of x, scale and bias (rtol 1e-4, atol 1e-5 of the
    largest)."""
    gen = torch.Generator().manual_seed(7)
    ref = _bn(32, gen, device=dev).train(training)
    got = _twin(ref)
    x = torch.randn(4, 4096, 32, device=dev)
    g = torch.randn(4, 4096, 32, device=dev)
    xr, xg = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    yr = ref._norm(xr, None)
    if slope is not None:
        yr = leaky_relu(yr, slope)
    yr.backward(g)
    y = batch_norm.batch_norm_act(xg, got.scale, got.bias, got.mean, got.var,
                                  EPS, slope, training, BN_MOMENTUM)
    y.backward(g)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.mean, ref.mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.var, ref.var, rtol=1e-5, atol=1e-6)
    for a, b in ((xg.grad, xr.grad), (got.scale.grad, ref.scale.grad),
                 (got.bias.grad, ref.bias.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())


def _launches():
    return {k: v for k, v in cuda_build.launch_counts().items()
            if k.startswith("batch_norm") and v}


@pytest.mark.cuda
def test_flagship_batch_norms_all_fused(dev):
    """Semantic3D's PointConvBig at B1 x 65536 (the flagship's scales a
    cloud): a request runs its 58 eval batch norms on K16 (one apply
    each), a train step its 70 (statistics, apply and backward each), and
    none falls back."""
    from crfconv_tpu_torch import (
        PointConvResNet, Predictor, RawBatch, TrainState, make_train_step,
    )

    model = PointConvResNet(8, 6, use_crf=True, steps=1, device=dev,
                            generator=torch.Generator().manual_seed(0))
    n = 65536
    pos = torch.rand(1, n, 3) * 10
    feats = torch.rand(1, n, 6)
    fallbacks = profiling.bn_fallbacks()
    cuda_build.reset_launch_counts()
    model.eval()
    Predictor(model).predict_logits(pos.numpy(), feats.numpy())
    torch.cuda.synchronize()
    assert _launches() == {"batch_norm_apply": 58}
    cuda_build.reset_launch_counts()
    model.train()
    state = TrainState.create(model, lr=0.01)
    step = make_train_step()
    batch = RawBatch(pos=pos.to(dev), x=feats.to(dev),
                     y=torch.randint(0, 8, (1, n)).to(dev))
    step(state, batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert _launches() == {"batch_norm_stats": 70, "batch_norm_apply": 70,
                           "batch_norm_bwd": 70}
    assert profiling.bn_fallbacks() == fallbacks


@pytest.mark.cuda
def test_card_fallbacks_keep_pytorch_ops(dev):
    """On the card a masked call in training and the bfloat16 compute dtype
    launch no K16 kernel and count as fallbacks, and a mesh's statistics
    in training are dispatched to PyTorch's ops; a plain call launches and
    counts none, and so do an eval call with a mask and one under a mesh
    (point-sharded serving), which normalise with the running statistics:
    one apply each."""
    mlp = MLP(6, 16, leaky_relu01, device=dev)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 512, 6, device=dev)
    mask = torch.ones(2, 512, dtype=torch.bool, device=dev)
    before = profiling.bn_fallbacks()
    cuda_build.reset_launch_counts()
    mlp(x, mask)
    with compute_dtype_scope(torch.bfloat16):
        mlp(x)
    assert _launches() == {}
    now = profiling.bn_fallbacks()
    assert {k: now[k] - before.get(k, 0) for k in now} == {
        "mask": 1, "dtype": 1}
    bn = mlp.bn
    with spatial_state.activate({"data": _Mesh(2)}):
        assert batch_norm.fallback_reason(
            x, None, True, bn.scale, bn.bias, bn.mean, bn.var) == "mesh"
    mlp(x)
    assert _launches() == {"batch_norm_stats": 1, "batch_norm_apply": 1}
    mlp.eval()
    cuda_build.reset_launch_counts()
    with torch.no_grad():
        mlp(x)
        mlp(x, mask)
        with spatial_state.activate({"data": _Mesh(2)}):
            mlp(x)
    assert _launches() == {"batch_norm_apply": 3}
    assert profiling.bn_fallbacks() == now

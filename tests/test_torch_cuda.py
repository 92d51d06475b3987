"""The six CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach: ragged tiles, indices outside their
window (clamped rows that read zero), every template width of K3/K4, tiny
clouds whose windows are mostly sentinel rows, and K > 16; the backward of
the two autograd Functions (K1/K8, K7/K8) against autograd through the
plain versions; and the kernels without a backward refusing to drop a
gradient.

Needs an NVIDIA GPU and nvcc; skipped otherwise. On the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
need not have).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crfconv_tpu_torch.ops import conv, crf_sim, windowed

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sorted_cloud(rng, b, n, dev):
    from crfconv_tpu_torch.ops.morton import morton_order

    pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32))
    order = morton_order(pos)
    return torch.take_along_dim(pos, order[..., None], dim=1).to(dev)


def _idx(rng, b, m, n, k, spread, dev):
    centers = (np.arange(m) * (n / m)).astype(np.int64)
    idx = centers[None, :, None] + rng.integers(-spread, spread, (b, m, k))
    return torch.as_tensor(np.clip(idx, 0, n - 1).astype(np.int32), device=dev)


@pytest.mark.parametrize(
    "m,n,f,k,spread",
    [(1000, 1000, 5, 7, 1000), (3000, 700, 3, 1, 40), (96, 384, 643, 16, 60)],
)
def test_windowed_gather_bit_equal(dev, m, n, f, k, spread):
    rng = np.random.default_rng(0)
    x = torch.randn(2, n, f, device=dev)
    idx = _idx(rng, 2, m, n, k, spread, dev)
    got = windowed.windowed_gather(x, idx)
    assert torch.equal(got, windowed.windowed_gather_plain(x, idx))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n,k,bipartite", [(1000, 16, False), (40, 16, False),
                                            (16, 16, False), (777, 1, True),
                                            (2048, 24, False)])
def test_window_knn_matches_plain(dev, n, k, bipartite, exact):
    rng = np.random.default_rng(1)
    pos = _sorted_cloud(rng, 2, n, dev)
    if bipartite:
        src = pos[:, ::4].contiguous()
        got = windowed.window_knn(src, k, pos, exact=exact)
        ref = windowed.window_knn_plain(src, k, pos, exact=exact)
    else:
        got = windowed.window_knn(pos, k, exact=exact)
        ref = windowed.window_knn_plain(pos, k, exact=exact)
        assert torch.equal(got[:, :, 0], torch.arange(n, device=dev).expand(2, n).int())
    # same arithmetic, no FMA contraction: the same indices
    assert torch.equal(got, ref)


@pytest.mark.parametrize("h,k", [(4, 16), (8, 16), (13, 9), (32, 16)])
def test_point_conv_matches_plain(dev, h, k):
    rng = np.random.default_rng(2)
    n = 1100
    pos = _sorted_cloud(rng, 2, n, dev)
    x = torch.randn(2, n, h, device=dev)
    idx = _idx(rng, 2, n, n, k, 300, dev)   # some rows clamp out of range
    g = torch.Generator().manual_seed(0)
    w = [torch.randn(s, generator=g).to(dev) for s in
         ((3, h), (h,), (h,), (h, h), (h,), (h,))]
    got = conv.point_conv_fused_infer(x, pos, idx, *w)
    ref = conv.point_conv_fused_infer_plain(x, pos, idx, *w)
    # float32 sums over K and H in another order
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,k", [(4, 15), (8, 15), (20, 7), (32, 15)])
def test_crf_similarity_matches_plain(dev, h, k):
    rng = np.random.default_rng(3)
    n = 1100
    y = torch.randn(2, n, h, device=dev)
    z = torch.randn(2, n, h, device=dev)
    idx = _idx(rng, 2, n, n, k, 300, dev)
    msg, s = crf_sim.crf_similarity_message(y, z, idx)
    msg_ref, s_ref = crf_sim.crf_similarity_message_plain(y, z, idx)
    # d = |y_i - y_j|^2 ~ 2H is summed over H in another order; its
    # rounding (~d * 2^-24 * sqrt(H), 2e-5 at H = 32) scales s relatively
    # and msg absolutely
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(msg, msg_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "n,k,h,spread", [(1000, 16, 3, 80), (1100, 15, 19, 300), (333, 16, 128, 60)]
)
def test_weighted_reduce_matches_plain(dev, n, k, h, spread):
    rng = np.random.default_rng(4)
    x = torch.randn(2, n, h, device=dev)
    u = torch.randn(2, n, k, h, device=dev)
    idx = _idx(rng, 2, n, n, k, spread, dev)   # some rows clamp
    out, xg = windowed.windowed_weighted_reduce(x, u, idx)
    out_ref, xg_ref = windowed.windowed_weighted_reduce_plain(x, u, idx)
    # one order of the k-sum, no fused multiply-add: bit-equal
    assert torch.equal(xg, xg_ref)
    assert torch.equal(out, out_ref)


@pytest.mark.parametrize(
    "m,n,f,k,spread",
    [(1000, 1000, 3, 16, 80), (1100, 1100, 19, 15, 300), (333, 333, 128, 16, 60),
     (250, 1000, 19, 16, 60), (3000, 700, 3, 1, 40)],
)
def test_gather_bwd_matches_plain(dev, m, n, f, k, spread):
    rng = np.random.default_rng(5)
    g = torch.randn(2, m, k, f, device=dev)
    idx = _idx(rng, 2, m, n, k, spread, dev)
    got = windowed.windowed_gather_bwd(g, idx, n)
    ref = windowed.windowed_gather_bwd_plain(g, idx, n)
    # f32 atomics add each row's terms in another order than index_add_:
    # the rounding grows with the magnitudes summed into the row, and the
    # window's edge rows collect every clamped slot (hundreds of terms)
    mass = windowed.windowed_gather_bwd_plain(g.abs(), idx, n)
    assert bool(((got - ref).abs() <= 1e-5 * ref.abs() + 1e-6 * mass).all())


@pytest.mark.parametrize("m,n,f,k", [(1000, 1000, 19, 15), (250, 1000, 3, 16),
                                     (3000, 700, 128, 1)])
def test_gather_backward_matches_plain_autograd(dev, m, n, f, k):
    """K1's autograd backward (K8) against autograd through the plain
    gather, with an output gradient that arrives non-contiguous (the
    transpose of a contiguous one)."""
    rng = np.random.default_rng(6)
    x = torch.randn(2, n, f, device=dev, requires_grad=True)
    idx = _idx(rng, 2, m, n, k, 90, dev)
    w = torch.randn(2, k, m, f, device=dev)
    (windowed.windowed_gather(x, idx).transpose(1, 2) * w).sum().backward()
    got = x.grad.clone()
    x.grad = None
    (windowed.windowed_gather_plain(x, idx).transpose(1, 2) * w).sum().backward()
    # atomics in another order: the bound of test_gather_bwd_matches_plain
    mass = windowed.windowed_gather_bwd_plain(
        w.transpose(1, 2).abs().contiguous(), idx, n
    )
    assert bool(((got - x.grad).abs() <= 1e-5 * x.grad.abs() + 1e-6 * mass).all())


def test_weighted_gather_reduce_backward_matches_plain(dev):
    rng = np.random.default_rng(7)
    n, k, h = 1100, 16, 8
    x = torch.randn(2, n, h, device=dev, requires_grad=True)
    u = torch.randn(2, n, k, h, device=dev, requires_grad=True)
    idx = _idx(rng, 2, n, n, k, 90, dev)
    windowed.weighted_gather_reduce(x, u, idx).sin().sum().backward()
    got = x.grad.clone(), u.grad.clone()
    x.grad = u.grad = None
    out, _ = windowed.windowed_weighted_reduce_plain(x, u, idx)
    out.sin().sum().backward()
    # the forward is bit-equal, so du is; dx differs by the order of the
    # atomics (the bound of test_gather_bwd_matches_plain)
    assert torch.equal(got[1], u.grad)
    gu = (out.cos()[:, :, None, :] * u).detach()
    mass = windowed.windowed_gather_bwd_plain(gu.abs(), idx, n)
    assert bool(((got[0] - x.grad).abs() <= 1e-5 * x.grad.abs() + 1e-6 * mass).all())


def test_kernels_without_backward_raise_under_grad(dev):
    """K3, K4 (and K7, K8 called directly) never return a tensor cut off
    from the graph: they raise when an input needs a gradient."""
    rng = np.random.default_rng(8)
    n, h = 256, 8
    pos = _sorted_cloud(rng, 1, n, dev)
    x = torch.randn(1, n, h, device=dev, requires_grad=True)
    idx = _idx(rng, 1, n, n, 16, 40, dev)
    w = [torch.randn(s, device=dev) for s in
         ((3, h), (h,), (h,), (h, h), (h,), (h,))]
    with pytest.raises(RuntimeError, match="no backward"):
        conv.point_conv_fused_infer(x, pos, idx, *w)
    with pytest.raises(RuntimeError, match="no backward"):
        crf_sim.crf_similarity_message(x, x.detach(), idx[..., 1:].contiguous())
    u = torch.randn(1, n, 16, h, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        windowed.windowed_weighted_reduce(x, u, idx)
    with pytest.raises(RuntimeError, match="no backward"):
        windowed.windowed_gather_bwd(u.requires_grad_(), idx, n)
    with torch.no_grad():   # without a graph to build they launch
        conv.point_conv_fused_infer(x, pos, idx, *w)
        crf_sim.crf_similarity_message(x, x, idx[..., 1:].contiguous())


def test_empty_problem_counts_no_launch(dev):
    """A call with nothing to compute launches nothing and counts nothing."""
    from crfconv_tpu_torch import cuda_build

    x = torch.randn(1, 64, 0, device=dev)
    idx = torch.zeros(1, 64, 4, dtype=torch.int32, device=dev)
    cuda_build.reset_launch_counts()
    assert windowed.windowed_gather(x, idx).shape == (1, 64, 4, 0)
    assert windowed.windowed_gather_bwd(
        torch.randn(1, 64, 4, 0, device=dev), idx, 64
    ).shape == (1, 64, 0)
    assert not any(cuda_build.launch_counts().values())


def test_wrappers_check_arguments(dev):
    x = torch.randn(1, 64, 4, device=dev)
    idx = torch.zeros(1, 64, 2, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        windowed.windowed_gather(x, idx)
    with pytest.raises(ValueError):
        windowed.windowed_gather(x.transpose(1, 2).contiguous().transpose(1, 2),
                                 idx.int())
    with pytest.raises(ValueError):
        windowed.windowed_gather(x, idx.int().cpu())

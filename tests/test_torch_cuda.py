"""The four CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach: ragged tiles, indices outside their
window (clamped rows that read zero), every template width of K3/K4, tiny
clouds whose windows are mostly sentinel rows, and K > 16.

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

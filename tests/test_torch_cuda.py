"""The fifteen CUDA kernels against their plain versions on the card, at
edge shapes the main path does not reach: ragged tiles, indices outside
their window (clamped rows that read zero), every template width of K3/K4
and K5 (with riders of 13 to 128 channels), tiny clouds whose windows are
mostly sentinel rows, and K > 16; the CRF cores' kernels (K9-K12, and the
discrete K13/K14 at 1 to 50 classes) at B = 1, N = 1, 63, 65, duplicated
indices, all-masked rows and subnormal weights; the backward of the four
autograd Functions (K1/K8, K7/K8, the continuous core K9-K12, the discrete
core K9/K12-K14) against autograd through the plain versions; the
kernels without a backward refusing to drop a gradient; and the k-min
selection (K6) bit for bit at k = 1 to 40 on rows of 1 to 65536 columns
with ties, signed zeros and +inf, under the exact kNN with TF32 on. K1 is
bit-equal at every store and load path (F = 1 to 643, K = 1 to 31, a
source one float off 16-byte alignment); K8 is bit-equal to its plain
version on CPU copies (index_add_ on the CPU adds in index order, as K8
does) and to itself on a rerun, with g read in place as a slice; the
leaky ReLU's backward kernel gives flax's gradient at 0. K11 and K14 add
lam_t in slot order over a transpose built once per backward call: lam_t
is bit-equal to the plain version on CPU copies and every output to itself
on a rerun (H 3 to 1024); K2 is bit-equal to its plain version at k = 1 to
33 and k = the window's width, exact and packed, same-scale and bipartite,
on 512- and 128-wide windows with duplicated points.

Needs an NVIDIA GPU and nvcc; skipped otherwise. On the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
need not have).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crfconv_tpu_torch.ops import (
    conv, crf_core, crf_sim, discrete_core, neighbors, windowed,
)

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


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k", [1, 16, 31])
@pytest.mark.parametrize("f", [1, 3, 4, 35, 320, 643])
def test_windowed_gather_widths(dev, f, k, offset):
    """Every store path of K1: float4 loads (F % 4 == 0 on a 16-byte
    aligned x), scalar loads (other F, or x one float off alignment), the
    ragged head and tail of each tile's run (M = 1000 is no multiple of
    64, and B * M * K * F need not be one of 4), and clamped slots."""
    rng = np.random.default_rng(10)
    b, m, n = 2, 1000, 1000
    buf = torch.randn(b * n * f + offset, device=dev)
    x = buf[offset:].view(b, n, f)
    idx = _idx(rng, b, m, n, k, 400, dev)
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


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("bipartite", [False, True])
@pytest.mark.parametrize("k", [1, 3, 16, 32, 33, "width"])
@pytest.mark.parametrize("tile,pad", [(64, 128), (16, 16)])
def test_window_knn_bit_equal_every_k(dev, k, bipartite, exact, tile, pad):
    """One-pass selection (k <= 32, 32-bit packed keys where the window is
    at most 2048 wide) and the rounds (k > 32), on the main path's windows
    (512 wide) and on 128-wide ones, with duplicated points (exact ties):
    the keys are distinct, so the indices are the plain version's."""
    rng = np.random.default_rng(2)
    pos = _sorted_cloud(rng, 2, 700, dev)
    pos[:, 1::2] = pos[:, 0::2]                   # every point twice
    src, query = (pos[:, ::4].contiguous(), pos) if bipartite else (pos, None)
    m = pos.shape[1]
    width = windowed.window_starts(m, src.shape[1], tile, pad)[1]
    kk = width if k == "width" else k
    got = windowed.window_knn(src, kk, query, tile, pad, exact)
    ref = windowed.window_knn_plain(src, kk, query, tile, pad, exact)
    assert torch.equal(got, ref)
    if not bipartite:   # the self pin: column 0 is the row itself
        assert torch.equal(got[:, :, 0],
                           torch.arange(m, device=dev).expand(2, m).int())


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
    # index_add_ on the card adds with atomics in another order: the
    # rounding grows with the magnitudes summed into the row, and the
    # window's edge rows collect every clamped slot (hundreds of terms)
    mass = windowed.windowed_gather_bwd_plain(g.abs(), idx, n)
    assert bool(((got - ref).abs() <= 1e-5 * ref.abs() + 1e-6 * mass).all())
    # K8 adds in index order, as index_add_ on the CPU
    assert torch.equal(got.cpu(),
                       windowed.windowed_gather_bwd_plain(g.cpu(), idx.cpu(), n))


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize(
    "m,n,f,k",
    [(1000, 1000, 3, 16), (1000, 1000, 4, 31), (250, 1000, 35, 16),
     (300, 300, 320, 31), (3000, 700, 19, 1), (1000, 1000, 643, 16)],
)
def test_gather_bwd_bit_equal_to_cpu(dev, m, n, f, k, sliced):
    """K8 against the plain version on CPU copies, bit for bit, and against
    itself on a rerun: same-scale, strided and upsample geometries, every
    load path (float4 where F % 4 == 0), a g that is a slice of a wider
    tensor's last dimension (rows ld > F apart, read in place), and
    indices spread past the windows, so that the edge rows of a window
    collect hundreds of clamped slots."""
    rng = np.random.default_rng(11)
    wide = torch.randn(2, m, k, f + (4 if sliced else 0), device=dev)
    g = wide[..., :f]
    idx = _idx(rng, 2, m, n, k, 4 * n, dev)
    got = windowed.windowed_gather_bwd(g, idx, n)
    assert torch.equal(got, windowed.windowed_gather_bwd(g, idx, n))
    ref = windowed.windowed_gather_bwd_plain(g.cpu(), idx.cpu(), n)
    assert torch.equal(got.cpu(), ref)
    terms = windowed.windowed_gather_bwd_plain(
        torch.ones(2, m, k, 1), idx.cpu(), n)
    assert float(terms.max()) >= 200


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
    # and bit-equal to the transpose taken on the CPU
    ref = windowed.windowed_gather_bwd_plain(w.transpose(1, 2).cpu(),
                                             idx.cpu(), n)
    assert torch.equal(got.cpu(), ref)


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


def test_windowed_gather_no_grad_skips_autograd(dev):
    """Without a gradient to build, K1 launches without its autograd
    Function; with one, the output has K1's backward."""
    rng = np.random.default_rng(12)
    x = torch.randn(1, 300, 5, device=dev, requires_grad=True)
    idx = _idx(rng, 1, 300, 300, 7, 40, dev)
    with torch.no_grad():
        a = windowed.windowed_gather(x, idx)
    b = windowed.windowed_gather(x, idx)
    assert a.grad_fn is None and b.grad_fn is not None
    assert torch.equal(a, b)


@pytest.mark.parametrize("numel,offset,sliced", [
    (4096, 0, False), (1001, 0, False), (4096, 1, False), (4199, 0, True)])
def test_leaky_relu_bwd_matches_plain(dev, numel, offset, sliced):
    """The leaky ReLU's backward kernel (float4 and scalar paths, and a
    gradient that is a slice of a wider tensor's last dimension, as the
    backward of a concatenation gives it) against its plain version, on
    inputs holding exact zeros of both signs, and the autograd Function's
    gradient: 1 at x >= 0 (flax's), the slope below."""
    from crfconv_tpu_torch.ops import activation

    g = torch.Generator().manual_seed(0)
    x = torch.randn(numel + offset, generator=g)
    x[::7] = 0.0
    x[3::7] = -0.0
    x, gr = x.to(dev)[offset:], torch.randn(numel, generator=g).to(dev)
    if sliced:   # rows of 13 of 16 columns
        x = x.view(-1, 13)
        gr = torch.randn(x.shape[0], 16, generator=g).to(dev)[:, 2:15]
    for slope in (0.1, 0.01):
        got = activation.leaky_relu_bwd(x, gr, slope)
        assert torch.equal(got, activation.leaky_relu_bwd_plain(x, gr, slope))
        xr = x.clone().requires_grad_()
        activation.leaky_relu(xr, slope).backward(gr)
        assert torch.equal(xr.grad, got)
        assert torch.equal(got[x == 0], gr[x == 0])


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


def _crf_inputs(rng, b, n, h, k, spread, dev, masked=True):
    """State, unary term, similarity (row-stochastic, with a masked slot, an
    all-masked row and subnormal weights, as the main path's far slots
    have), indices with duplicates and out-of-window slots, and M."""
    x = torch.randn(b, n, h, device=dev)
    zp = torch.randn(b, n, h, device=dev)
    s = torch.softmax(torch.randn(b, n, k, device=dev), dim=-1)
    s[:, ::3, k // 2] *= 1e-39
    if masked:
        s[:, :, min(2, k - 1)] = 0.0
        s[:, n // 2] = 0.0
    idx = _idx(rng, b, n, n, k, spread, dev)
    idx[:, :, 0] = idx[:, :, -1]                  # duplicated columns
    m = 0.5 * torch.randn(h, h, device=dev) / h ** 0.5
    return x, zp, s.contiguous(), idx.contiguous(), m


CRF_SHAPES = [   # (b, n, h, k, spread)
    (1, 1, 8, 4, 4), (2, 63, 8, 15, 40), (1, 65, 32, 15, 300),
    (2, 1000, 32, 15, 300), (1, 700, 64, 9, 90), (2, 300, 128, 15, 60),
    (1, 257, 256, 15, 90), (1, 100, 20, 31, 60), (1, 90, 18, 40, 60),
]


@pytest.mark.parametrize("b,n,h,k,spread", CRF_SHAPES)
def test_crf_operator_and_iterate_match_plain(dev, b, n, h, k, spread):
    rng = np.random.default_rng(10)
    x, zp, s, idx, m = _crf_inputs(rng, b, n, h, k, spread, dev)
    col = crf_core.crf_operator(idx)
    assert torch.equal(col, crf_core.crf_operator_plain(idx))
    got = crf_core.crf_iterate(x, zp, s, col, m)
    # one sum order (k, then h ascending), no fused multiply-add: bit-equal
    assert torch.equal(got, crf_core.crf_iterate_plain(x, zp, s, col, m))
    assert torch.equal(got[:, n // 2], zp[:, n // 2])   # all-masked row


@pytest.mark.parametrize("b,n,h,k,spread", CRF_SHAPES)
def test_crf_iterate_bwd_and_neighbor_dot_match_plain(dev, b, n, h, k, spread):
    rng = np.random.default_rng(11)
    x, lam, s, idx, m = _crf_inputs(rng, b, n, h, k, spread, dev)
    col = crf_core.crf_operator(idx)
    dzp = torch.randn(b, n, h, device=dev)
    dM = torch.randn(h, h, device=dev)
    got = crf_core.crf_iterate_bwd(lam, x, s, col, m, dzp, dM)
    ref = crf_core.crf_iterate_bwd_plain(lam, x, s, col, m, dzp, dM)
    assert torch.equal(got[1], ref[1])        # dmsg: the plain version's order
    assert torch.equal(got[2], ref[2])        # dzp + lam
    # lam_t: its terms in ascending slot order, as index_add_ adds them on
    # the CPU (the card's index_add_ adds with atomics), subnormals kept
    cpu = [t.cpu() for t in (lam, x, s, col, m, dzp, dM)]
    assert torch.equal(got[0].cpu(), crf_core.crf_iterate_bwd_plain(*cpu)[0])
    # dM: a sum over every row, in chunks, then the chunks in order
    scale = float((dM.abs() + crf_core._message(x.abs(), s, col).reshape(-1, h).T
                   @ lam.abs().reshape(-1, h)).max())
    assert float((got[3] - ref[3]).abs().max()) <= 1e-5 * scale + 1e-6
    steps = 3
    dmsgs = torch.randn(steps, b, n, h, device=dev)
    xs = torch.randn(steps, b, n, h, device=dev)
    ds = crf_core.crf_neighbor_dot(dmsgs, xs, col)
    ds_ref = crf_core.crf_neighbor_dot_plain(dmsgs, xs, col)
    ds_mass = crf_core.crf_neighbor_dot_plain(dmsgs.abs(), xs.abs(), col)
    assert bool(((ds - ds_ref).abs() <= 1e-5 * ds_mass + 1e-6).all())
    assert bool((ds[col < 0] == 0).all())


@pytest.mark.parametrize("b,n,h,k,spread,steps", [
    (1, 65, 8, 15, 300, 3), (2, 1000, 32, 15, 90, 10), (1, 300, 256, 15, 60, 4),
])
def test_crf_core_backward_matches_plain_autograd(dev, b, n, h, k, spread,
                                                  steps):
    """The Function (K9, K10 forward; K11, K12 backward) against autograd
    through the plain versions, from a non-contiguous output gradient."""
    rng = np.random.default_rng(12)
    z, zp, s, idx, m = _crf_inputs(rng, b, n, h, k, spread, dev)
    ts = [t.clone().requires_grad_() for t in (z, zp, s, m)]
    w = torch.randn(b, h, n, device=dev)
    out = crf_core.crf_core(ts[0], ts[1], ts[2], idx, ts[3], steps)
    got = torch.autograd.grad((out.transpose(1, 2) * w).sum(), ts,
                              retain_graph=True)
    again = torch.autograd.grad((out.transpose(1, 2) * w).sum(), ts)
    for a, r in zip(got, again):   # no atomics: bit-identical
        assert torch.equal(a, r)
    out_ref = crf_core.crf_core_plain(ts[0], ts[1], ts[2], idx, ts[3], steps)
    assert torch.equal(out, out_ref)          # the forward is bit-equal
    ref = torch.autograd.grad((out_ref.transpose(1, 2) * w).sum(), ts)
    for name, a, r in zip(("dz", "dzp", "ds", "dM"), got, ref):
        # atomics and the neighbour dot sum in another order; errors grow
        # through the steps with the operator's norm
        torch.testing.assert_close(a, r, rtol=1e-4,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=name)


def test_crf_kernels_raise_under_grad(dev):
    rng = np.random.default_rng(13)
    x, zp, s, idx, m = _crf_inputs(rng, 1, 128, 8, 7, 40, dev)
    col = crf_core.crf_operator(idx)
    with pytest.raises(RuntimeError, match="no backward"):
        crf_core.crf_iterate(x.requires_grad_(), zp, s, col, m)
    with pytest.raises(ValueError):   # never in place
        crf_core.crf_iterate(zp, zp, s, col, m, out=zp)
    with pytest.raises(ValueError):   # stacks of two lengths
        crf_core.crf_neighbor_dot(torch.zeros(2, 1, 128, 8, device=dev),
                                  torch.zeros(1, 1, 128, 8, device=dev), col)


# --------------------------------------------------------------------------
# K5: the strided point convolution with its rider
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,m,h,k,r,spread", [
    (2, 1100, 275, 16, 16, 64, 300),   # conv2_1's widths; rows clamp out
    (1, 4096, 1024, 32, 16, 128, 48),  # conv3_1's
    (1, 65, 17, 8, 9, 13, 40),         # ragged tiles, a ragged rider
    (1, 1, 1, 4, 4, 5, 4),             # one point
])
def test_point_conv_strided_matches_plain(dev, b, n, m, h, k, r, spread):
    rng = np.random.default_rng(20)
    pos = _sorted_cloud(rng, b, n, dev)
    sub_pos = pos[:, :: max(n // m, 1)][:, :m].contiguous()
    x = torch.randn(b, n, h, device=dev)
    res = torch.randn(b, n, r, device=dev)
    idx = _idx(rng, b, m, n, k, spread, dev)
    idx[:, :, 1] = idx[:, :, 0]                   # duplicated neighbours
    g = torch.Generator().manual_seed(1)
    w = [torch.randn(s, generator=g).to(dev) for s in
         ((3, h), (h,), (h,), (h, h), (h,), (h,))]
    got, got_r = conv.point_conv_fused_strided(x, pos, sub_pos, idx, res, *w)
    ref, ref_r = conv.point_conv_fused_strided_plain(x, pos, sub_pos, idx,
                                                     res, *w)
    # float32 sums over K and H in another order; the max is exact
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(got_r, ref_r)


def test_point_conv_strided_rider_reads_zero_outside(dev):
    """Neighbour rows clamped outside the cloud give a zero rider, so a
    negative rider's max is 0 exactly at those points."""
    rng = np.random.default_rng(21)
    n, m, h, k, r = 300, 75, 8, 8, 20
    pos = _sorted_cloud(rng, 1, n, dev)
    sub_pos = pos[:, ::4].contiguous()
    idx = torch.as_tensor(
        ((np.arange(m) * 4)[None, :, None]
         + rng.integers(-48, 48, (1, m, k))).astype(np.int32), device=dev)
    res = -1.0 - torch.rand(1, n, r, device=dev)
    w = [torch.randn(s, device=dev) for s in
         ((3, h), (h,), (h,), (h, h), (h,), (h,))]
    _, got_r = conv.point_conv_fused_strided(
        torch.randn(1, n, h, device=dev), pos, sub_pos, idx, res, *w)
    outside = ((idx < 0) | (idx >= n)).any(-1)
    assert bool(outside.any()) and not bool(outside.all())
    assert bool((got_r[outside] == 0).all())
    assert bool((got_r[~outside] < 0).all())


def test_point_conv_strided_raises_under_grad(dev):
    rng = np.random.default_rng(22)
    n, m, h = 256, 64, 8
    pos = _sorted_cloud(rng, 1, n, dev)
    idx = _idx(rng, 1, m, n, 16, 40, dev)
    res = torch.randn(1, n, 16, device=dev, requires_grad=True)
    w = [torch.randn(s, device=dev) for s in
         ((3, h), (h,), (h,), (h, h), (h,), (h,))]
    args = (torch.randn(1, n, h, device=dev), pos, pos[:, ::4].contiguous(),
            idx, res, *w)
    with pytest.raises(RuntimeError, match="no backward"):
        conv.point_conv_fused_strided(*args)
    with torch.no_grad():
        conv.point_conv_fused_strided(*args)


# --------------------------------------------------------------------------
# K13, K14: the discrete CRF core
# --------------------------------------------------------------------------


def _discrete_inputs(rng, b, n, l, k, spread, dev):
    """q, u, w (a masked slot, an all-masked row, subnormal and zero
    weights, as exp(-|e_i - e_j|^2) has), indices with duplicates and
    out-of-window slots, C near the identity."""
    q = torch.softmax(2 * torch.randn(b, n, l, device=dev), dim=-1)
    u = -torch.log(torch.softmax(torch.randn(b, n, l, device=dev), dim=-1))
    w = torch.rand(b, n, k, device=dev)
    w[:, ::3, k // 2] *= 1e-39
    w[:, 1::4, k // 3] = 0.0
    w[:, :, min(2, k - 1)] = 0.0
    w[:, n // 2] = 0.0
    idx = _idx(rng, b, n, n, k, spread, dev)
    idx[:, :, 0] = idx[:, :, -1]
    c = torch.eye(l, device=dev) + 0.1 * torch.randn(l, l, device=dev)
    return q, u, w.contiguous(), idx.contiguous(), c


DISCRETE_SHAPES = [   # (b, n, l, k, spread)
    (1, 1, 20, 4, 4), (2, 63, 13, 15, 40), (1, 65, 20, 31, 300),
    (2, 1000, 20, 31, 90), (1, 300, 50, 31, 60), (1, 100, 13, 40, 60),
    (1, 200, 33, 9, 60),
]


@pytest.mark.parametrize("b,n,l,k,spread", DISCRETE_SHAPES)
def test_discrete_iterate_matches_plain(dev, b, n, l, k, spread):
    rng = np.random.default_rng(30)
    q, u, w, idx, c = _discrete_inputs(rng, b, n, l, k, spread, dev)
    col = crf_core.crf_operator(idx)
    msg = torch.empty_like(q)
    got = discrete_core.discrete_iterate(q, u, w, col, c, msg_out=msg)
    ref, ref_msg = discrete_core._iterate_plain(q, u, w, col, c)
    assert torch.equal(msg, ref_msg)     # one order: k ascending
    # exp may round apart from torch.exp; the rest is one order
    assert float((got - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    torch.testing.assert_close(got.sum(-1), torch.ones(b, n, device=dev))
    # an all-masked row is softmax(-u)
    torch.testing.assert_close(got[:, n // 2], torch.softmax(-u[:, n // 2], -1),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("b,n,l,k,spread", DISCRETE_SHAPES)
def test_discrete_iterate_bwd_matches_plain(dev, b, n, l, k, spread):
    rng = np.random.default_rng(31)
    q, u, w, idx, c = _discrete_inputs(rng, b, n, l, k, spread, dev)
    col = crf_core.crf_operator(idx)
    lam = torch.randn(b, n, l, device=dev)
    msg = crf_core._message(q, w, col)
    du = torch.randn(b, n, l, device=dev)
    dC = torch.randn(l, l, device=dev)
    got = discrete_core.discrete_iterate_bwd(lam, q, msg, w, col, c, du, dC)
    ref = discrete_core.discrete_iterate_bwd_plain(lam, q, msg, w, col, c, du,
                                                   dC)
    assert torch.equal(got[1], ref[1])        # dmsg: the plain version's order
    assert torch.equal(got[2], ref[2])        # du + dz
    # lam_t: its terms in ascending slot order, as index_add_ adds them on
    # the CPU, subnormals kept
    cpu = [t.cpu() for t in (lam, q, msg, w, col, c, du, dC)]
    assert torch.equal(got[0].cpu(),
                       discrete_core.discrete_iterate_bwd_plain(*cpu)[0])
    # dC: a sum over every row, in chunks, then the chunks in order
    dz = q * (lam - (lam * q).sum(-1, keepdim=True))
    scale = float((dC.abs() + msg.abs().reshape(-1, l).T
                   @ dz.abs().reshape(-1, l)).max())
    assert float((got[3] - ref[3]).abs().max()) <= 1e-5 * scale + 1e-6


@pytest.mark.parametrize("h", [3, 32, 256, 1024])
def test_crf_iterate_bwd_deterministic(dev, h):
    """K11 at H 3 to 1024: a rerun is bit-identical (no atomics), lam_t is
    bit-equal to the plain version on CPU copies, dM within its bound, and
    a step over a plan built once equals one that builds its own."""
    rng = np.random.default_rng(14)
    b, n, k = 2, 300, 15
    x, lam, s, idx, m = _crf_inputs(rng, b, n, h, k, 90, dev)
    col = crf_core.crf_operator(idx)
    dzp = torch.randn(b, n, h, device=dev)
    dM = torch.randn(h, h, device=dev)
    plan = crf_core.crf_reverse_plan(col, m)
    got = crf_core.crf_iterate_bwd(lam, x, s, col, m, dzp, dM, plan=plan)
    again = crf_core.crf_iterate_bwd(lam, x, s, col, m, dzp, dM, plan=plan)
    own = crf_core.crf_iterate_bwd(lam, x, s, col, m, dzp, dM)
    for a, r, o in zip(got, again, own):
        assert torch.equal(a, r) and torch.equal(a, o)
    cpu = crf_core.crf_iterate_bwd_plain(
        *[t.cpu() for t in (lam, x, s, col, m, dzp, dM)])
    for a, r in zip(got[:3], cpu[:3]):
        assert torch.equal(a.cpu(), r)
    mass = (dM.abs() + crf_core._message(x.abs(), s, col).reshape(-1, h).T
            @ lam.abs().reshape(-1, h)).cpu()
    assert bool(((got[3].cpu() - cpu[3]).abs() <= 1e-4 * mass
                 + 1e-6 * float(mass.max())).all())


def test_discrete_iterate_bwd_deterministic(dev):
    """K14 at ScanNet's 20 classes and K = 31: a rerun is bit-identical,
    lam_t bit-equal to the plain version on CPU copies, dC within its
    bound."""
    rng = np.random.default_rng(34)
    b, n, l, k = 2, 1000, 20, 31
    q, u, w, idx, c = _discrete_inputs(rng, b, n, l, k, 90, dev)
    col = crf_core.crf_operator(idx)
    lam = torch.randn(b, n, l, device=dev)
    msg = crf_core._message(q, w, col)
    du = torch.randn(b, n, l, device=dev)
    dC = torch.randn(l, l, device=dev)
    plan = discrete_core.discrete_reverse_plan(col, c)
    args = (lam, q, msg, w, col, c, du, dC)
    got = discrete_core.discrete_iterate_bwd(*args, plan=plan)
    again = discrete_core.discrete_iterate_bwd(*args, plan=plan)
    for a, r in zip(got, again):
        assert torch.equal(a, r)
    cpu = discrete_core.discrete_iterate_bwd_plain(*[t.cpu() for t in args])
    for a, r in zip(got[:3], cpu[:3]):
        assert torch.equal(a.cpu(), r)
    dz = (q * (lam - (lam * q).sum(-1, keepdim=True))).abs()
    mass = (dC.abs() + msg.abs().reshape(-1, l).T @ dz.reshape(-1, l)).cpu()
    assert bool(((got[3].cpu() - cpu[3]).abs() <= 1e-4 * mass
                 + 1e-6 * float(mass.max())).all())


@pytest.mark.parametrize("b,n,l,k,spread,steps", [
    (1, 65, 13, 15, 300, 3), (2, 1000, 20, 31, 90, 10),
    (1, 300, 50, 31, 60, 4),
])
def test_discrete_core_backward_matches_plain_autograd(dev, b, n, l, k,
                                                       spread, steps):
    """The Function (K9, K13 forward; K14, K12 backward) against autograd
    through the plain versions, from a non-contiguous output gradient."""
    rng = np.random.default_rng(32)
    p, u, w, idx, c = _discrete_inputs(rng, b, n, l, k, spread, dev)
    ts = [t.clone().requires_grad_() for t in (p, u, w, c)]
    g = torch.randn(b, l, n, device=dev)
    out = discrete_core.discrete_core(ts[0], ts[1], ts[2], idx, ts[3], steps)
    got = torch.autograd.grad((out.transpose(1, 2) * g).sum(), ts,
                              retain_graph=True)
    again = torch.autograd.grad((out.transpose(1, 2) * g).sum(), ts)
    for a, r in zip(got, again):   # no atomics: bit-identical
        assert torch.equal(a, r)
    out_ref = discrete_core.discrete_core_plain(ts[0], ts[1], ts[2], idx,
                                                ts[3], steps)
    assert float((out - out_ref).abs().max()) <= 1e-5
    ref = torch.autograd.grad((out_ref.transpose(1, 2) * g).sum(), ts)
    for name, a, r in zip(("dp", "du", "dw", "dC"), got, ref):
        # atomics and the neighbour dot sum in another order; errors grow
        # through the steps with the operator's norm
        torch.testing.assert_close(a, r, rtol=1e-4,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=name)


def test_discrete_kernels_raise_under_grad(dev):
    rng = np.random.default_rng(33)
    q, u, w, idx, c = _discrete_inputs(rng, 1, 128, 20, 7, 40, dev)
    col = crf_core.crf_operator(idx)
    with pytest.raises(RuntimeError, match="no backward"):
        discrete_core.discrete_iterate(q.requires_grad_(), u, w, col, c)
    with pytest.raises(ValueError):   # never in place
        discrete_core.discrete_iterate(u, u, w, col, c, out=u)
    with pytest.raises(ValueError):   # too many classes
        big = torch.zeros(1, 128, 129, device=dev)
        discrete_core.discrete_iterate(big, big, w, col,
                                       torch.zeros(129, 129, device=dev))


# ---------------------------------------------------------------------------
# K6: k-min selection
# ---------------------------------------------------------------------------


def _select_rows(rng, shape, width, dev):
    """Distance rows [*shape, width] with duplicates (values on a coarse
    grid), signed zeros, +inf, and one row with fewer finite entries than
    most k."""
    d = rng.integers(0, 64, shape + (width,)).astype(np.float32) / 8.0
    d[rng.random(d.shape) < 0.1] = 0.0
    d[rng.random(d.shape) < 0.1] = -0.0
    d[rng.random(d.shape) < 0.1] = np.inf
    d[rng.random(d.shape) < 0.3] *= rng.random()   # off-grid values too
    flat = d.reshape(-1, width)
    flat[0] = np.inf
    flat[0, rng.permutation(width)[: max(width // 8, 1)]] = 1.0
    return torch.as_tensor(d, device=dev)


@pytest.mark.parametrize("k", [1, 3, 5, 16, 32, 40])
@pytest.mark.parametrize("width", [31, 33, 1024, 8192, 65536])
def test_select_min_k_bit_equal(dev, k, width):
    if k > width:
        pytest.skip("k > width raises (test_select_min_k_checks)")
    rng = np.random.default_rng(40 + k)
    rows = (1, 3, 5) if width == 65536 else (2, 3, 7)   # not a multiple of 8
    d = _select_rows(rng, rows, width, dev)
    for exact in ((True, False) if width <= 1024 else (True,)):
        got = windowed.select_min_k(d, k, exact)
        torch.cuda.synchronize()
        ref = windowed.select_min_k_plain(d, k, exact)
        assert got.shape == rows + (k,) and got.dtype == torch.int32
        assert torch.equal(got, ref), (exact, (got != ref).sum().item())


@pytest.mark.parametrize("k", [1, 3, 16, 32])
def test_select_min_k_width_equals_k(dev, k):
    rng = np.random.default_rng(50 + k)
    d = _select_rows(rng, (2, 1, 9), k, dev)
    for exact in (True, False):
        got = windowed.select_min_k(d, k, exact)
        assert torch.equal(got, windowed.select_min_k_plain(d, k, exact))
        # every column once
        assert torch.equal(got.sort(-1).values.long(),
                           torch.arange(k, device=dev).expand_as(got))


def test_select_min_k_unaligned_rows(dev):
    """A contiguous block that does not start on 16 bytes takes the scalar
    loads."""
    rng = np.random.default_rng(60)
    d = _select_rows(rng, (1, 2, 9), 1024, dev).reshape(-1)
    buf = torch.empty(d.numel() + 1, device=dev)
    buf[1:] = d
    off = buf[1:].view(1, 2, 9, 1024)
    assert off.data_ptr() % 16 != 0
    for k in (16, 40):
        assert torch.equal(windowed.select_min_k(off, k),
                           windowed.select_min_k_plain(off, k))


def test_select_min_k_checks(dev):
    d = torch.zeros(1, 1, 4, 1025, device=dev)
    with pytest.raises(ValueError):
        windowed.select_min_k(d, 3, exact=False)
    windowed.select_min_k(d[..., :1024].contiguous(), 3, exact=False)
    with pytest.raises(ValueError):
        windowed.select_min_k(d, 1026)
    with pytest.raises(ValueError):
        windowed.select_min_k(d[..., :8], 2)          # not contiguous
    with pytest.raises(TypeError):
        windowed.select_min_k(d.double(), 2)


def test_knn_bruteforce_self_first_under_tf32(dev):
    """With TF32 allowed for the process's matmuls, the exact kNN is the
    one without it (its cross term runs in full float32), column 0 is the
    query itself on all but the rows of near-duplicate points (distance
    below float32's rounding of |q|^2 - 2 q.s + |s|^2), and the setting
    is restored."""
    rng = np.random.default_rng(61)
    pos = torch.as_tensor(rng.random((2, 8192, 3), dtype=np.float32),
                          device=dev)
    ref = neighbors.knn_bruteforce(pos, pos, 16)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        idx = neighbors.knn_bruteforce(pos, pos, 16)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(idx, ref)
    self_share = float((idx[:, :, 0] == torch.arange(8192, device=dev))
                       .float().mean())
    assert self_share >= 0.999
    d = torch.cdist(pos.double(), pos.double())
    exact = torch.topk(d, 16, largest=False).indices
    assert float((idx.long() == exact).float().mean()) >= 0.999

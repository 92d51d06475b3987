"""The fifteen CUDA kernels against their plain versions on the card, at
edge shapes the main path does not reach: ragged tiles, indices outside
their window (clamped rows that read zero), every template width of K3/K4
and K5 (with riders of 13 to 128 channels; Semantic3D's widths with rows
clamped outside the cloud at both ends, rerun-identical; K up to 200 and
pads up to 8000, where a block stages nothing), tiny clouds whose windows
are mostly sentinel rows, and K > 16; the CRF cores' kernels (K9-K12, and the
discrete K13/K14 at 1 to 128 classes, every step of a call in one launch
and one step at a time) at B = 1, N = 1, 63, 65, duplicated
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
on 512- and 128-wide windows with duplicated points. K4 runs every width
from 1 to 32, K from 1 to 300 (at 300 without its shared table) and pads
to 8000, within rtol 1e-4, atol 1e-5 and rerun-identical; on rows off
16-byte alignment (seeded inputs) its msg within a bound derived from
float32's rounding of the float64 plain version; K9 is bit-equal at K 1
to 33 on aligned and unaligned slabs. ShapeNet's and SemanticKITTI's shapes: K2 on clouds of 4
to 32 points (k 8 on 8 points: a window of mostly sentinel rows), K9-K12
on clouds narrower than a 64-row tile (K 7 on 8 rows, and the four CRF
layers of CRFSegNet_Part at B16 x 2048, the coarsest 32 rows wide at
width 256), each through ten steps and the core's backward; K7 and K8 at
the flagship's training shapes of B8 x 65536 points. The loader's copies
to the card on its side stream give the batches of a loader without
prefetch and of the CPU loader, and its errors reach the consumer. Each
wrapper on the driver's path given bfloat16 (the bf16 compute mode's
activations) launches its float32 kernel once and rounds its result once;
a Trainer resumed on the card from its checkpoint and sidecar draws and
steps as the live one.

Needs an NVIDIA GPU and nvcc; skipped otherwise. On the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
need not have).
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as parallel_ranks
import test_torch_spatial_ranks as spatial_ranks
from crfconv_tpu_torch import cuda_build
from crfconv_tpu_torch.ops import (
    conv, crf_core, crf_sim, discrete_core, neighbors, windowed,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(request):
    """The card, with the default generators (the card's and the host's)
    seeded from the test's id: a test's ``torch.randn(..., device=dev)``
    draws its own inputs whatever ran before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(zlib.crc32(request.node.nodeid.encode()))
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


def _raw_idx(rng, b, m, n, k, spread, dev):
    """Indices around each point's center, not clipped to [0, n): the first
    and last tiles' clamps give rows outside the cloud, which read zero.
    Slot 1 repeats slot 0 (duplicated neighbours)."""
    centers = (np.arange(m) * (n / m)).astype(np.int64)
    idx = centers[None, :, None] + rng.integers(-spread, spread, (b, m, k))
    idx[:, :, 1] = idx[:, :, 0]
    starts, width, front = windowed.window_starts(m, n)
    lo = np.repeat(starts - front, 64)[:m][None, :, None]
    rows = np.clip(idx, lo, lo + width - 1)
    assert (rows < 0).any() and (rows >= n).any()   # both ends clamp out
    return torch.as_tensor(idx.astype(np.int32), device=dev)


def _mlp(h, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev) for s in
            ((3, h), (h,), (h,), (h, h), (h,), (h,))]


@pytest.mark.parametrize("h", [8, 16, 32])
def test_point_conv_semantic3d_widths(dev, h):
    """Semantic3D's same-scale widths over 16 tiles (n = 1000, not a
    multiple of 64, so the last block is ragged), rows clamped outside the
    cloud at both ends: within the plain version's rounding, and a rerun
    is bit-identical (one order of every sum, no atomics)."""
    rng = np.random.default_rng(30 + h)
    n, k = 1000, 16
    pos = _sorted_cloud(rng, 2, n, dev)
    x = torch.randn(2, n, h, device=dev)
    idx = _raw_idx(rng, 2, n, n, k, 300, dev)
    w = _mlp(h, dev, h)
    got = conv.point_conv_fused_infer(x, pos, idx, *w)
    ref = conv.point_conv_fused_infer_plain(x, pos, idx, *w)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, conv.point_conv_fused_infer(x, pos, idx, *w))


@pytest.mark.parametrize("h,r", [(16, 64), (32, 128), (16, 30), (32, 13)])
def test_point_conv_strided_semantic3d_widths(dev, h, r):
    """K5 at stride 4 with Semantic3D's (H, R) pairs and ragged riders
    (R % 4 != 0: one channel a thread), n = 4000 over m = 1000, rows
    clamped outside the cloud at both ends: out within rounding, the
    rider's max exact, both bit-identical on a rerun."""
    rng = np.random.default_rng(40 + h + r)
    n, m, k = 4000, 1000, 16
    pos = _sorted_cloud(rng, 2, n, dev)
    sub_pos = pos[:, ::4].contiguous()
    x = torch.randn(2, n, h, device=dev)
    res = torch.randn(2, n, r, device=dev)
    idx = _raw_idx(rng, 2, m, n, k, 600, dev)
    w = _mlp(h, dev, h + r)
    got, got_r = conv.point_conv_fused_strided(x, pos, sub_pos, idx, res, *w)
    ref, ref_r = conv.point_conv_fused_strided_plain(x, pos, sub_pos, idx,
                                                     res, *w)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(got_r, ref_r)
    again, again_r = conv.point_conv_fused_strided(x, pos, sub_pos, idx, res,
                                                   *w)
    assert torch.equal(got, again) and torch.equal(got_r, again_r)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("h,k,r", [(16, 24, 0), (8, 32, 0), (32, 1, 0),
                                   (8, 24, 12), (32, 32, 64), (16, 5, 30)])
def test_point_conv_passes_and_k(dev, monkeypatch, h, k, r, passes):
    """K3 (r = 0) and K5 at one and two passes a block and at K of 1 to
    32, multiples of 4 and not, over ragged tiles, against the plain
    version."""
    monkeypatch.setattr(conv, "block_passes", lambda *_: passes)
    rng = np.random.default_rng(50 + h + k + r)
    n = 1000 if r == 0 else 4000
    m = n if r == 0 else n // 4
    pos = _sorted_cloud(rng, 2, n, dev)
    x = torch.randn(2, n, h, device=dev)
    idx = _raw_idx(rng, 2, m, n, k, 300, dev) if k > 1 else torch.as_tensor(
        np.arange(m)[None, :, None].repeat(2, 0).astype(np.int32) * (n // m),
        device=dev)
    w = _mlp(h, dev, k)
    if r == 0:
        got = conv.point_conv_fused_infer(x, pos, idx, *w)
        ref = conv.point_conv_fused_infer_plain(x, pos, idx, *w)
    else:
        sub_pos = pos[:, ::4].contiguous()
        res = torch.randn(2, n, r, device=dev)
        got, got_r = conv.point_conv_fused_strided(x, pos, sub_pos, idx, res,
                                                   *w)
        ref, ref_r = conv.point_conv_fused_strided_plain(x, pos, sub_pos, idx,
                                                         res, *w)
        assert torch.equal(got_r, ref_r)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def _pc_staged(h, cap, k, passes):
    """Whether a K3/K5 block stages its rows: its shared memory
    (csrc/point_conv.cuh::pc_smem_bytes) within the 231,424 bytes a block
    may ask for."""
    hp = 8 if h <= 8 else (16 if h <= 16 else 32)
    points = 1024 // hp * passes
    floats = hp * hp + 5 * hp + 8 * 512 + cap * (12 if hp == 8 else 4)
    return 4 * (floats + (points + 1) * k + points) <= 231424


@pytest.mark.parametrize("h,k,r,pad,passes,n,staged", [
    (8, 200, 0, 128, 2, 1000, False),    # the [k][points + 1] table
    (8, 200, 0, 128, 1, 1000, True),
    (8, 200, 13, 128, 2, 4000, False),
    (32, 200, 128, 128, 2, 4000, True),
    (8, 16, 0, 1200, 2, 4000, True),     # the staged window
    (8, 16, 13, 2400, 2, 16000, False),
    (16, 16, 64, 8000, 1, 40000, False),
])
def test_point_conv_large_k_and_pad(dev, monkeypatch, h, k, r, pad, passes,
                                    n, staged):
    """K3 (r = 0) and K5 at stride 4 where the block's table of clamped
    rows or its staged window outgrows shared memory (a block then stages
    nothing and reads its rows from L2) and just inside it: out against the
    plain version evaluated in float64, within ``point_conv_error_bound``
    (at K 200 the kernel and the float32 plain version part by more than
    1e-4 on about one element in 30,000), the rider exact, out
    rerun-identical. Every input comes from the case's seeded generator."""
    monkeypatch.setattr(conv, "block_passes", lambda *_: passes)
    m = n if r == 0 else n // 4
    assert _pc_staged(h, conv.stage_rows(m, n, h, passes, 64, pad), k,
                      passes) == staged
    rng = np.random.default_rng(60 + h + k + r)
    inputs = large_k_inputs(rng, h, k, r, pad, n, dev)
    got, ref_64 = large_k_run(inputs, pad, r)
    err = (got[0].double() - ref_64[0]).abs()
    bound = point_conv_error_bound(inputs, pad)
    assert bool((err <= bound).all()), (
        f"out off float64 by {float(err.max()):.3g}, bound "
        f"{float(bound[err > bound].min()):.3g} there")
    if r:
        assert torch.equal(got[1], ref_64[1].float())
    assert torch.equal(got[0], large_k_run(inputs, pad, r, plain=False)[0])


def large_k_inputs(rng, h, k, r, pad, n, dev) -> dict:
    """The inputs of a test_point_conv_large_k_and_pad case, every one
    drawn from ``rng``: a sorted cloud of n points, x, the rider (r > 0:
    stride 4), indices within ``pad`` of each output row's centre, the
    weight MLP."""
    m = n if r == 0 else n // 4
    pos = _sorted_cloud(rng, 1, n, dev)
    out = {
        "x": torch.as_tensor(rng.standard_normal((1, n, h), np.float32),
                             device=dev),
        "pos": pos,
        "sub_pos": pos if r == 0 else pos[:, ::4].contiguous(),
        "idx": torch.as_tensor(
            (np.arange(m) * (n // m))[None, :, None]
            + rng.integers(-pad, pad, (1, m, k)), dtype=torch.int32,
            device=dev),
        "w": _mlp(h, dev, k + pad),
    }
    if r:
        out["res"] = torch.as_tensor(
            rng.standard_normal((1, n, r), np.float32), device=dev)
    return out


def large_k_run(inputs, pad, r, plain=True):
    """(out[, res_max]) of K3 (r = 0) or K5 on ``inputs``, and, with
    ``plain``, of the plain version in float64 beside it."""
    x, pos, idx, w = (inputs[k] for k in ("x", "pos", "idx", "w"))

    def run(fn, dtype=None):
        cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
        args = [cast(x), cast(pos)]
        if r:
            args.append(cast(inputs["sub_pos"]))
        args.append(idx)
        if r:
            args.append(cast(inputs["res"]))
        out = fn(*args, *map(cast, w), pad=pad)
        return out if r else (out,)

    kernel = (conv.point_conv_fused_strided if r
              else conv.point_conv_fused_infer)
    got = run(kernel)
    if not plain:
        return got
    return got, run(conv.point_conv_fused_strided_plain if r
                    else conv.point_conv_fused_infer_plain, torch.float64)


def point_conv_error_bound(inputs, pad, slope=0.1):
    """The most any float32 evaluation of K3/K5's out may lie from the
    exact one, element by element, from float32's rounding (unit u =
    2^-24), to first order, for any order of its sums:

      rel = centre - p_j: |err| <= u |rel|;
      p = rel . w0 (3 terms): |err| <= |e_rel| . |w0| + 5u |rel| . |w0|;
      s = a0 p + c0, t = leaky(s): |err| <= |a0| e_p
            + 2u (|a0| |rel| . |w0| + |c0|) + u |t|;
      q = t . w1 (H terms), v = a1 q + c1: |err| <= |a1| (e_t . |w1|
            + (H + 2) u |t| . |w1|) + 2u (|a1| |t| . |w1| + |c1|);
      out = sum_k v_k x_k (K terms): |err| <= sum_k |x_k| e_v
            + (K + 2) u sum_k |v_k x_k|;

    twice that, for the second-order terms. Evaluated in float64 on the
    rows the plain version gathers."""
    u = 2.0 ** -24
    x, pos, idx = inputs["x"], inputs["pos"], inputs["idx"]
    w0, a0, c0, w1, a1, c1 = (t.double() for t in inputs["w"])
    h, k = x.shape[-1], idx.shape[-1]
    g = windowed.windowed_gather_plain(
        torch.cat([pos, x], dim=-1).double(), idx, windowed.TILE, pad)
    rel = inputs["sub_pos"].double()[:, :, None, :] - g[..., :3]
    rw = rel.abs() @ w0.abs()
    e_p = (u * rel.abs()) @ w0.abs() + 5 * u * rw
    t = torch.nn.functional.leaky_relu(a0 * (rel @ w0) + c0, slope)
    e_t = a0.abs() * e_p + 2 * u * (a0.abs() * rw + c0.abs()) + u * t.abs()
    tw = t.abs() @ w1.abs()
    v = a1 * (t @ w1) + c1
    e_v = (a1.abs() * (e_t @ w1.abs() + (h + 2) * u * tw)
           + 2 * u * (a1.abs() * tw + c1.abs()))
    xk = g[..., 3:].abs()
    return 2 * ((e_v * xk).sum(2) + (k + 2) * u * (v.abs() * xk).sum(2))


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


def _sim_table_max_k():
    """The largest K at which a K4 launch keeps its table and distance
    buffer in shared memory (csrc/crf_sim.cu::SIM_TABLE_MAX_K), as its
    library reports it; above it K4 takes the direct route."""
    kernel = cuda_build.CRF_SIMILARITY_MESSAGE
    cuda_build.build([kernel])
    return ctypes.CDLL(str(kernel.library_path())).crf_similarity_table_max_k()


def _check_sim(y, z, idx, pad=128):
    """K4 against its plain version within rtol 1e-4, atol 1e-5 on msg and
    s (|y_i - y_j|^2 summed over H in another order), and bit-identical on
    a rerun (one order of every sum, no atomics)."""
    msg, s = crf_sim.crf_similarity_message(y, z, idx, pad=pad)
    msg_ref, s_ref = crf_sim.crf_similarity_message_plain(y, z, idx, pad=pad)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(msg, msg_ref, rtol=1e-4, atol=1e-5)
    msg2, s2 = crf_sim.crf_similarity_message(y, z, idx, pad=pad)
    assert torch.equal(msg, msg2) and torch.equal(s, s2)


@pytest.mark.parametrize("h", [1, 5, 8, 12, 16, 24, 32])
def test_crf_similarity_every_width(dev, h):
    """Every width to 32, n = 1100 (a ragged last tile and a ragged last
    block), indices outside their windows and rows clamped outside the
    cloud at both ends (they read zero y and z)."""
    rng = np.random.default_rng(70 + h)
    n, k = 1100, 15
    y = torch.randn(2, n, h, device=dev)
    z = torch.randn(2, n, h, device=dev)
    _check_sim(y, z, _raw_idx(rng, 2, n, n, k, 300, dev))


@pytest.mark.parametrize("h", [8, 32])
@pytest.mark.parametrize("k", [1, 7, 15, 31, 200, 300])
def test_crf_similarity_every_k(dev, h, k):
    """K from 1 to 300: up to K 200 the table and distance buffer fit
    shared memory, at K 300 they do not (the direct route)."""
    assert (k <= _sim_table_max_k()) == (k <= 200)
    n = 1000
    rng = np.random.default_rng(80 + h + k)
    y = torch.randn(1, n, h, device=dev)
    z = torch.randn(1, n, h, device=dev)
    idx = torch.as_tensor(
        np.arange(n)[None, :, None] + rng.integers(-250, 250, (1, n, k)),
        dtype=torch.int32, device=dev)
    _check_sim(y, z, idx)


@pytest.mark.parametrize("pad,n", [(1000, 4000), (1200, 4000), (8000, 40000)])
@pytest.mark.parametrize("h", [8, 16])
def test_crf_similarity_large_pad(dev, h, pad, n):
    """Pads whose windows span thousands of rows, indices across them."""
    rng = np.random.default_rng(90 + h + pad)
    y = torch.randn(1, n, h, device=dev)
    z = torch.randn(1, n, h, device=dev)
    idx = torch.as_tensor(
        np.arange(n)[None, :, None] + rng.integers(-pad, pad, (1, n, 15)),
        dtype=torch.int32, device=dev)
    _check_sim(y, z, idx, pad)


def msg_error_bound(y, z, idx, pad=128):
    """The most any float32 evaluation of K4's msg may lie from the exact
    one, element by element, from float32's rounding (unit u = 2^-24) at
    the call's H and K, to first order:

      d_k = sum_h (y_h - y_jh)^2, H squares of rounded differences summed:
            |err| <= (H + 2) u d_k;
      a_k = d_min - d_k, the max taken off: |err| <= (H + 2) u (d_k +
            d_min) + u |a_k|; e_k = exp(a_k) (expf within 2 ulp): relative
            error rel(e_k) <= |err a_k| + 2u;
      S = sum_k e_k: rel(S) <= sum_k s_k rel(e_k) + K u; s_k = e_k / S:
            rel(s_k) <= rel(e_k) + rel(S) + u;
      msg = sum_k s_k z_k: |err| <= sum_k s_k |z_k| (rel(s_k) + (K + 1) u);

    twice that, for the second-order terms and the kernel's order (it sums
    e_k z_k and divides once). Evaluated in float64 on the rows the plain
    version gathers."""
    u = 2.0 ** -24
    h, k = y.shape[-1], idx.shape[-1]
    g = windowed.windowed_gather_plain(
        torch.cat([y, z], dim=-1).double(), idx, windowed.TILE, pad)
    d = ((y.double()[:, :, None, :] - g[..., :h]) ** 2).sum(-1)
    d_min = d.amin(dim=-1, keepdim=True)
    a = d_min - d
    rel_e = (h + 2) * u * (d + d_min) + u * a.abs() + 2 * u
    s = torch.softmax(a, dim=-1)
    rel_s = rel_e + (s * rel_e).sum(-1, keepdim=True) + (k + 1) * u
    return 2 * ((s * (rel_s + (k + 1) * u))[..., None]
                * g[..., h:].abs()).sum(2)


@pytest.mark.parametrize("n", [1, 63, 65, 4096])
def test_crf_similarity_small_and_unaligned(dev, n):
    """Clouds of one row to a few tiles, and y, z, msg rows off 16-byte
    alignment (slices one float in: the scalar loads and copies). s is held
    to the float32 plain version within rtol 1e-4, atol 1e-5; msg to the
    plain version evaluated in float64, within ``msg_error_bound`` (at H 32
    the two float32 evaluations part by more than 1e-5 on about one call in
    a hundred); both rerun-identical. The inputs come from seeded
    generators."""
    rng = np.random.default_rng(100 + n)
    idx = torch.as_tensor(
        np.arange(n)[None, :, None] + rng.integers(-40, 40, (2, n, 15)),
        dtype=torch.int32, device=dev)
    for h in (8, 16, 32):
        gen = torch.Generator(device=dev).manual_seed(100 + n + h)
        buf = torch.randn(2 * (2 * n * h + 1), device=dev, generator=gen)
        y = buf[1:2 * n * h + 1].view(2, n, h)
        z = buf[2 * n * h + 2:].view(2, n, h)
        assert y.data_ptr() % 16 and z.data_ptr() % 16
        for yy, zz in ((y, z), (y.clone(), z.clone())):
            msg, s = crf_sim.crf_similarity_message(yy, zz, idx)
            s_ref = crf_sim.crf_similarity_message_plain(yy, zz, idx)[1]
            torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-5)
            msg_64 = crf_sim.crf_similarity_message_plain(
                yy.double(), zz.double(), idx)[0]
            err = (msg.double() - msg_64).abs()
            bound = msg_error_bound(yy, zz, idx)
            assert bool((err <= bound).all()), (
                f"h {h}: msg off float64 by {float(err.max()):.3g}, bound "
                f"{float(bound[err > bound].min()):.3g} there")
            msg2, s2 = crf_sim.crf_similarity_message(yy, zz, idx)
            assert torch.equal(msg, msg2) and torch.equal(s, s2)


@pytest.mark.parametrize("k", [1, 15, 31, 33])
@pytest.mark.parametrize("b,n,tile,pad", [
    (2, 50, 64, 128),      # below a tile
    (1, 1024, 64, 128),    # at a multiple of it
    (2, 1100, 64, 128),    # off a multiple
    (3, 1000, 32, 64),     # another tile and pad
])
def test_crf_operator_bit_equal(dev, b, n, k, tile, pad):
    """K9 bit-equal to its plain version, indices in and out of their
    windows (clamped rows outside the cloud give -1), on a 16-byte-aligned
    slab and on one a word off (scalar head and tail)."""
    rng = np.random.default_rng(110 + n + k)
    raw = (np.arange(n)[None, :, None] * 1
           + rng.integers(-400, 400, (b, n, k))).astype(np.int32)
    idx = torch.as_tensor(raw, device=dev)
    col = crf_core.crf_operator(idx, tile, pad)
    assert torch.equal(col, crf_core.crf_operator_plain(idx, tile, pad))
    assert (col == -1).any() and (col >= 0).any()
    buf = torch.empty(raw.size + 1, dtype=torch.int32, device=dev)
    off = buf[1:].view(b, n, k)
    off.copy_(idx)
    assert off.data_ptr() % 16
    assert torch.equal(crf_core.crf_operator(off, tile, pad), col)


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
    with pytest.raises(RuntimeError, match="no backward"):
        crf_core.crf_iterate_steps(x, zp, s, col, m, 2)
    with pytest.raises(ValueError):   # a stack of another length
        crf_core.crf_iterate_steps(zp, zp, s, col, m, 2,
                                   xs=torch.empty(3, 1, 128, 8, device=dev))
    with pytest.raises(ValueError):   # stacks of two lengths
        crf_core.crf_neighbor_dot(torch.zeros(2, 1, 128, 8, device=dev),
                                  torch.zeros(1, 1, 128, 8, device=dev), col)


# K10 runs every step of a call in one cooperative launch; K12 stages a
# 64-row block's window of x_t in shared memory and splits the steps over
# blocks at the coarse scales
SCANNET_CRF_WIDTHS = [   # (b, n, h): the four GuideCRFConv layers, K = 15
    (16, 8192, 32), (16, 2048, 64), (16, 512, 128), (16, 128, 256),
]


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("steps", [1, 2, 10])
@pytest.mark.parametrize("b,n,h,k,spread", CRF_SHAPES)
def test_crf_iterate_steps_bit_equal(dev, b, n, h, k, spread, steps, save):
    rng = np.random.default_rng(14)
    z, zp, s, idx, m = _crf_inputs(rng, b, n, h, k, spread, dev)
    col = crf_core.crf_operator(idx)
    xs = torch.full((steps, b, n, h), float("nan"), device=dev) if save else None
    got = crf_core.crf_iterate_steps(z, zp, s, col, m, steps, xs=xs)
    xs_ref = torch.empty((steps, b, n, h), device=dev)
    ref = crf_core.crf_iterate_steps_plain(z, zp, s, col, m, steps, xs_ref)
    assert torch.equal(got, ref)          # each step bit-equal: so the last
    if save:
        assert torch.equal(xs, xs_ref)    # the stack the backward reads


@pytest.mark.parametrize("b,n,h", SCANNET_CRF_WIDTHS)
def test_crf_iterate_steps_full_width(dev, b, n, h):
    """ScanNet's four CRF layers at full width, ten steps, one launch."""
    from crfconv_tpu_torch import cuda_build

    rng = np.random.default_rng(15)
    z, zp, s, idx, m = _crf_inputs(rng, b, n, h, 15, 24, dev)
    col = crf_core.crf_operator(idx)
    xs = torch.empty((10, b, n, h), device=dev)
    before = cuda_build.CRF_ITERATE.launches
    got = crf_core.crf_iterate_steps(z, zp, s, col, m, 10, xs=xs)
    assert cuda_build.CRF_ITERATE.launches == before + 1
    xs_ref = torch.empty_like(xs)
    ref = crf_core.crf_iterate_steps_plain(z, zp, s, col, m, 10, xs_ref)
    assert torch.equal(got, ref) and torch.equal(xs, xs_ref)
    assert bool(torch.isfinite(got).all())


def _check_neighbor_dot(dmsgs, xs, col):
    ds = crf_core.crf_neighbor_dot(dmsgs, xs, col)
    ds_ref = crf_core.crf_neighbor_dot_plain(dmsgs, xs, col)
    ds_mass = crf_core.crf_neighbor_dot_plain(dmsgs.abs(), xs.abs(), col)
    assert bool(((ds - ds_ref).abs() <= 1e-5 * ds_mass + 1e-6).all())
    assert bool((ds[col < 0] == 0).all())
    # one fixed order a sum, no atomics: a rerun is bit-identical
    assert torch.equal(ds, crf_core.crf_neighbor_dot(dmsgs, xs, col))


@pytest.mark.parametrize("b,n,h,k,spread", CRF_SHAPES + [(16, 8192, 20, 31, 24)])
def test_crf_neighbor_dot_ten_steps(dev, b, n, h, k, spread):
    rng = np.random.default_rng(16)
    _, _, _, idx, _ = _crf_inputs(rng, b, n, h, k, spread, dev)
    col = crf_core.crf_operator(idx)
    dmsgs = torch.randn(10, b, n, h, device=dev)
    xs = torch.randn(10, b, n, h, device=dev)
    _check_neighbor_dot(dmsgs, xs, col)


@pytest.mark.parametrize("b,n,h", SCANNET_CRF_WIDTHS)
def test_crf_neighbor_dot_full_width(dev, b, n, h):
    rng = np.random.default_rng(17)
    _, _, _, idx, _ = _crf_inputs(rng, b, n, h, 15, 24, dev)
    col = crf_core.crf_operator(idx)
    dmsgs = torch.randn(10, b, n, h, device=dev)
    xs = torch.randn(10, b, n, h, device=dev)
    _check_neighbor_dot(dmsgs, xs, col)


def test_crf_neighbor_dot_any_columns(dev):
    """Columns outside the staged window (not K9's) are read from global
    memory: the result does not rest on the clamp."""
    rng = np.random.default_rng(18)
    b, n, h, k = 2, 1500, 32, 9
    col = torch.as_tensor(rng.integers(-1, n, (b, n, k)).astype(np.int32),
                          device=dev)
    dmsgs = torch.randn(3, b, n, h, device=dev)
    xs = torch.randn(3, b, n, h, device=dev)
    _check_neighbor_dot(dmsgs, xs, col)


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
    plan = discrete_core.discrete_reverse_plan(w, col, c)
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
    (1, 300, 50, 31, 60, 4), (1, 200, 128, 8, 90, 2),
    (2, 100, 1, 1, 40, 10), (1, 257, 32, 31, 600, 2),
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


# (b, n, l, k, steps, spread): L 1 to 128, K 1 to 31, 1 to 10 steps, clouds
# smaller than a window and not a multiple of 64, indices out of their
# window (clamped, or outside the cloud: column -1)
DISCRETE_STEPS_SHAPES = [
    (1, 1, 1, 1, 1, 4), (2, 63, 5, 8, 2, 40), (1, 300, 20, 31, 10, 90),
    (2, 1000, 20, 31, 10, 90), (1, 130, 32, 8, 2, 60),
    (1, 200, 50, 31, 10, 60), (1, 65, 128, 31, 2, 300),
    (1, 257, 128, 1, 10, 60), (2, 100, 20, 1, 1, 300),
    (1, 500, 50, 8, 1, 600), (1, 319, 5, 31, 10, 600),
]


def _discrete_stack(dev, b, n, l, k, steps, spread, seed):
    rng = np.random.default_rng(seed)
    p, u, w, idx, c = _discrete_inputs(rng, b, n, l, k, spread, dev)
    col = crf_core.crf_operator(idx)
    qs = torch.empty((steps, b, n, l), device=dev)
    msgs = torch.empty_like(qs)
    q_last = discrete_core.discrete_iterate_steps(p, u, w, col, c, steps,
                                                  qs=qs, msgs=msgs)
    return p, u, w, col, c, qs, msgs, q_last


@pytest.mark.parametrize("b,n,l,k,steps,spread", DISCRETE_STEPS_SHAPES)
def test_discrete_iterate_steps_matches_plain(dev, b, n, l, k, steps, spread):
    """K13 with every step in one launch: each msg_t bit-equal to the
    message of the kernel's own q_t, q_t and q_steps within 2e-6 of the
    plain loop's (expf may round apart from torch.exp), bit-equal to the
    one-step kernel launched once a step and to the call without stacks."""
    p, u, w, col, c, qs, msgs, q_last = _discrete_stack(
        dev, b, n, l, k, steps, spread, 35)
    ref_qs, ref_msgs = torch.empty_like(qs), torch.empty_like(msgs)
    ref = discrete_core.discrete_iterate_steps_plain(
        p, u, w, col, c, steps, ref_qs, ref_msgs)
    for t in range(steps):
        assert torch.equal(msgs[t], crf_core._message(qs[t], w, col))
    scale = float(ref.abs().max())
    assert float((q_last - ref).abs().max()) <= 2e-6 * scale
    assert float((qs - ref_qs).abs().max()) <= 2e-6 * scale
    torch.testing.assert_close(q_last.sum(-1), torch.ones(b, n, device=dev))
    q = p
    for t in range(steps):
        assert torch.equal(q, qs[t])
        m = torch.empty_like(q)
        q = discrete_core.discrete_iterate(q, u, w, col, c, msg_out=m)
        assert torch.equal(m, msgs[t])
    assert torch.equal(q, q_last)
    assert torch.equal(
        discrete_core.discrete_iterate_steps(p, u, w, col, c, steps), q_last)


@pytest.mark.parametrize("b,n,l,k,steps,spread", DISCRETE_STEPS_SHAPES)
def test_discrete_iterate_bwd_steps_matches_cpu_plain(dev, b, n, l, k, steps,
                                                      spread):
    """K14 with every reverse step in one launch: lam_0, the dmsg stack and
    du bit-equal to the plain version on CPU copies and to the one-step
    kernel launched once a step over the same plan; every output
    bit-identical on a rerun; dC within 1e-4 of its mass; the plan's rows
    are S~^T by rows (``transpose_plain``) with w[m, k] and m per term."""
    p, u, w, col, c, qs, msgs, q_last = _discrete_stack(
        dev, b, n, l, k, steps, spread, 36)
    g = torch.randn(b, n, l, device=dev)
    plan = discrete_core.discrete_reverse_plan(w, col, c)
    offsets, slots = crf_core.transpose_plain(col.cpu())
    assert torch.equal(plan.row_ptr.cpu().long(), offsets)
    terms = plan.terms[:slots.numel()].cpu()
    assert torch.equal(terms[:, 1].long(), (slots // k) % n)
    assert torch.equal(terms[:, 0].view(torch.float32),
                       w.cpu().reshape(-1)[slots])
    args = (g, qs, q_last, msgs, w, col, c)
    got = discrete_core.discrete_iterate_bwd_steps(*args, plan=plan)
    again = discrete_core.discrete_iterate_bwd_steps(*args, plan=plan)
    for a, r in zip(got, again):
        assert torch.equal(a, r)
    cpu = discrete_core.discrete_iterate_bwd_steps_plain(
        *[t.cpu() for t in args])
    for name, a, r in zip(("dp", "dmsgs", "du"), got[:3], cpu[:3]):
        assert torch.equal(a.cpu(), r), name
    lam, du, dC = g, torch.zeros_like(g), torch.zeros_like(c)
    for t in reversed(range(steps)):
        qn = q_last if t == steps - 1 else qs[t + 1]
        lam, dmsg, du, dC = discrete_core.discrete_iterate_bwd(
            lam, qn, msgs[t], w, col, c, du, dC, plan=plan)
        assert torch.equal(dmsg, got[1][t])
    assert torch.equal(lam, got[0]) and torch.equal(du, got[2])
    # dC: every row's and step's products in another order than the plain
    # chain, against the mass of its terms
    mass = torch.zeros(l, l, dtype=torch.float64)
    lam = g.cpu().double()
    for t in reversed(range(steps)):
        qn = (q_last if t == steps - 1 else qs[t + 1]).cpu().double()
        dz = qn * (lam - (lam * qn).sum(-1, keepdim=True))
        mass += msgs[t].cpu().double().abs().reshape(-1, l).T @ \
            dz.abs().reshape(-1, l)
        lam = discrete_core.discrete_iterate_bwd_plain(
            lam, qn, msgs[t].cpu().double(), w.cpu().double(), col.cpu(),
            c.cpu().double(), torch.zeros_like(lam),
            torch.zeros(l, l, dtype=torch.float64))[0]
    err = (got[3].cpu().double() - cpu[3].double()).abs()
    assert bool((err <= 1e-4 * mass + 1e-6 * float(mass.max())).all())


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


# --------------------------------------------------------------------------
# ShapeNet's small clouds and SemanticKITTI's large ones
# --------------------------------------------------------------------------


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n,k,bipartite", [(8, 8, False), (8, 1, True),
                                            (32, 16, False), (32, 1, True)])
def test_window_knn_tiny_clouds(dev, n, k, bipartite, exact):
    """K2 at ShapeNet's coarse scales (B16 x 2048: 32 and 8 points, k
    clamped to 8 on the last; the up-search from 4 or 8 coarse points): one
    window of mostly sentinel rows a cloud."""
    rng = np.random.default_rng(20)
    pos = _sorted_cloud(rng, 16, n, dev)
    if bipartite:
        src = pos[:, ::2].contiguous()
        got = windowed.window_knn(src, k, pos, exact=exact)
        ref = windowed.window_knn_plain(src, k, pos, exact=exact)
    else:
        got = windowed.window_knn(pos, k, exact=exact)
        ref = windowed.window_knn_plain(pos, k, exact=exact)
        assert torch.equal(got[:, :, 0],
                           torch.arange(n, device=dev).expand(16, n).int())
    assert torch.equal(got, ref)
    assert windowed.check_window_consistency(
        got.cpu().numpy(), (src if bipartite else pos).shape[1]) == 1.0


SHAPENET_CRF_SHAPES = [   # (b, n, h, k): below a tile, then the 4 layers
    (16, 8, 256, 7), (16, 2048, 32, 15), (16, 512, 64, 15),
    (16, 128, 128, 15), (16, 32, 256, 15),
]


@pytest.mark.parametrize("b,n,h,k", SHAPENET_CRF_SHAPES)
def test_crf_kernels_shapenet_shapes(dev, b, n, h, k):
    """K9 and K10 (ten steps, the saved stack) bit-equal, K11's outputs as
    in test_crf_iterate_bwd_and_neighbor_dot_match_plain, K12 within its
    mass and rerun-identical, at every width ShapeNet's CRFs run."""
    rng = np.random.default_rng(21)
    z, zp, s, idx, m = _crf_inputs(rng, b, n, h, k, n, dev)
    col = crf_core.crf_operator(idx)
    assert torch.equal(col, crf_core.crf_operator_plain(idx))
    xs = torch.empty((10, b, n, h), device=dev)
    got = crf_core.crf_iterate_steps(z, zp, s, col, m, 10, xs=xs)
    xs_ref = torch.empty_like(xs)
    ref = crf_core.crf_iterate_steps_plain(z, zp, s, col, m, 10, xs_ref)
    assert torch.equal(got, ref) and torch.equal(xs, xs_ref)
    lam = torch.randn(b, n, h, device=dev)
    dzp = torch.randn(b, n, h, device=dev)
    dM = torch.randn(h, h, device=dev)
    out = crf_core.crf_iterate_bwd(lam, xs[3], s, col, m, dzp, dM)
    again = crf_core.crf_iterate_bwd(lam, xs[3], s, col, m, dzp, dM)
    assert all(torch.equal(a, r) for a, r in zip(out, again))
    ref = crf_core.crf_iterate_bwd_plain(lam, xs[3], s, col, m, dzp, dM)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
    cpu = [t.cpu() for t in (lam, xs[3], s, col, m, dzp, dM)]
    assert torch.equal(out[0].cpu(), crf_core.crf_iterate_bwd_plain(*cpu)[0])
    scale = float((dM.abs() + crf_core._message(xs[3].abs(), s, col)
                   .reshape(-1, h).T @ lam.abs().reshape(-1, h)).max())
    assert float((out[3] - ref[3]).abs().max()) <= 1e-5 * scale + 1e-6
    _check_neighbor_dot(torch.randn(10, b, n, h, device=dev), xs, col)


@pytest.mark.parametrize("b,n,h,k", SHAPENET_CRF_SHAPES[:1]
                         + SHAPENET_CRF_SHAPES[-1:])
def test_crf_core_backward_shapenet_shapes(dev, b, n, h, k):
    """The fused core's Function at ten steps on clouds narrower than a
    tile, against autograd through the plain versions, as in
    test_crf_core_backward_matches_plain_autograd."""
    rng = np.random.default_rng(22)
    z, zp, s, idx, m = _crf_inputs(rng, b, n, h, k, n, dev)
    ts = [t.clone().requires_grad_() for t in (z, zp, s, m)]
    w = torch.randn(b, h, n, device=dev)
    out = crf_core.crf_core(ts[0], ts[1], ts[2], idx, ts[3], 10)
    got = torch.autograd.grad((out.transpose(1, 2) * w).sum(), ts,
                              retain_graph=True)
    again = torch.autograd.grad((out.transpose(1, 2) * w).sum(), ts)
    for a, r in zip(got, again):
        assert torch.equal(a, r)
    out_ref = crf_core.crf_core_plain(ts[0], ts[1], ts[2], idx, ts[3], 10)
    assert torch.equal(out, out_ref)
    ref = torch.autograd.grad((out_ref.transpose(1, 2) * w).sum(), ts)
    for name, a, r in zip(("dz", "dzp", "ds", "dM"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=name)


def test_weighted_reduce_kitti_step(dev):
    """K7 at the flagship's fused layers of a SemanticKITTI train step (B8
    x 65536 points, K 16, width 8): bit-equal, and its backward's K8 call
    bit-equal to the plain version on CPU copies."""
    rng = np.random.default_rng(23)
    b, n, k, h = 8, 65536, 16, 8
    x = torch.randn(b, n, h, device=dev)
    u = torch.randn(b, n, k, h, device=dev)
    idx = windowed.window_knn(_sorted_cloud(rng, b, n, dev), k)
    out, xg = windowed.windowed_weighted_reduce(x, u, idx)
    out_ref, xg_ref = windowed.windowed_weighted_reduce_plain(x, u, idx)
    assert torch.equal(xg, xg_ref) and torch.equal(out, out_ref)
    g = torch.randn(b, n, k, h, device=dev)
    got = windowed.windowed_gather_bwd(g, idx, n)
    assert torch.equal(got, windowed.windowed_gather_bwd(g, idx, n))
    assert torch.equal(got.cpu(), windowed.windowed_gather_bwd_plain(
        g.cpu(), idx.cpu(), n))


@pytest.mark.parametrize("m,n,f", [(65536, 65536, 35), (16384, 65536, 19),
                                   (65536, 16384, 64)])
def test_gather_bwd_kitti_step(dev, m, n, f):
    """K8 at SemanticKITTI's training shapes (B8 x 65536): same-scale,
    strided (the pyramid's sub_idx) and upsample gathers, bit-equal to the
    plain version on CPU copies and rerun-identical."""
    rng = np.random.default_rng(24)
    b = 8
    pos = _sorted_cloud(rng, b, max(m, n), dev)
    if m == n:
        idx = windowed.window_knn(pos, 16)
    elif m < n:
        idx = windowed.window_knn(pos, 16)[:, ::n // m].contiguous()
    else:
        idx = windowed.window_knn(pos[:, ::m // n].contiguous(), 1, pos)
    g = torch.randn(b, m, idx.shape[2], f, device=dev)
    got = windowed.windowed_gather_bwd(g, idx, n)
    assert torch.equal(got, windowed.windowed_gather_bwd(g, idx, n))
    assert torch.equal(got.cpu(), windowed.windowed_gather_bwd_plain(
        g.cpu(), idx.cpu(), n))


class _Clouds:
    """Random clouds drawn from the loader's generator; ``fail_after``
    samples, then an error."""

    def __init__(self, n=2048, fail_after=None):
        self.n = n
        self.fail_after = fail_after
        self.drawn = 0

    def __len__(self):
        return 64

    def get_sample(self, rng, idx=None):
        self.drawn += 1
        if self.fail_after is not None and self.drawn > self.fail_after:
            raise RuntimeError("sample failed")
        pos = rng.random((self.n, 3), dtype=np.float32)
        return {"pos": pos, "x": np.concatenate([pos, pos], axis=1),
                "y": rng.integers(0, 13, self.n),
                "point_idx": rng.permutation(self.n),
                "cloud_idx": np.int64(rng.integers(4))}


@pytest.mark.parametrize("emit", ["raw", "pyramid"])
def test_loader_prefetch_on_the_card(dev, emit):
    """The loader's side-stream copies from pinned memory: batches of a
    prefetching loader are on the card, int64 where the port indexes, and
    bit-equal to a loader without prefetch and to the CPU loader's."""
    from crfconv_tpu_torch.data.loader import MultiscaleLoader, batch_tensors

    def batches(prefetch, device):
        lo = MultiscaleLoader(_Clouds(), 4, emit=emit, prefetch=prefetch,
                              device=device, seed=3)
        it = iter(lo)
        out = [next(it) for _ in range(6)]
        it.close()
        return out

    fed, plain, cpu = batches(2, dev), batches(0, dev), batches(0, "cpu")
    torch.cuda.synchronize()
    for a, b, c in zip(fed, plain, cpu):
        ta, tb, tc = batch_tensors(a), batch_tensors(b), batch_tensors(c)
        assert len(ta) == len(tb) == len(tc) >= 5
        for x, y, z in zip(ta, tb, tc):
            assert x.is_cuda and x.dtype == y.dtype == z.dtype
            assert x.dtype in (torch.float32, torch.int64)
            assert torch.equal(x, y) and torch.equal(x.cpu(), z)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_error_on_the_card(dev, prefetch):
    from crfconv_tpu_torch.data.loader import MultiscaleLoader

    lo = MultiscaleLoader(_Clouds(fail_after=9), 4, emit="raw",
                          prefetch=prefetch, device=dev)
    got = []
    with pytest.raises(RuntimeError, match="sample failed"):
        for b in lo:
            got.append(b)
    assert len(got) == 2


# --------------------------------------------------------------------------
# the bf16 compute mode's activations at each wrapper, and the Trainer
# --------------------------------------------------------------------------


def _bf16_cases(dev):
    """(name, wrapper, plain, args) on the card; the float arguments are
    the ones given in bfloat16."""
    from crfconv_tpu_torch.ops import activation
    from crfconv_tpu_torch.ops.morton import morton_order

    g = torch.Generator().manual_seed(0)
    b, n, k, h = 2, 8192, 16, 16

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.rand(shape, generator=g) * scale + shift).to(dev)

    pos = torch.rand((b, n, 3), generator=g)
    pos = torch.take_along_dim(pos, morton_order(pos)[..., None], 1).to(dev)
    idx = windowed.window_knn(pos, k)
    nidx = neighbors.remove_self_loop(idx)
    sub = torch.arange(0, n, 4, device=dev)
    mlp = (r(3, h), r(h, shift=0.5), r(h, scale=0.1), r(h, h, scale=0.3),
           r(h, shift=0.5), r(h, scale=0.1))
    s = torch.softmax(r(b, n, k - 1, scale=4.0), dim=-1)
    p = torch.softmax(r(b, n, 4, scale=3.0), dim=-1)
    return [
        ("windowed_gather", windowed.windowed_gather,
         windowed.windowed_gather_plain, (r(b, n, h), idx)),
        ("windowed_gather_bwd", windowed.windowed_gather_bwd,
         windowed.windowed_gather_bwd_plain, (r(b, n, k, h), idx, n)),
        ("windowed_weighted_reduce", windowed.windowed_weighted_reduce,
         windowed.windowed_weighted_reduce_plain,
         (r(b, n, h), r(b, n, k, h), idx)),
        ("point_conv_fused_infer", conv.point_conv_fused_infer,
         conv.point_conv_fused_infer_plain, (r(b, n, h), pos, idx, *mlp)),
        ("point_conv_fused_strided", conv.point_conv_fused_strided,
         conv.point_conv_fused_strided_plain,
         (r(b, n, h), pos, pos[:, sub].contiguous(),
          idx[:, sub].contiguous(), r(b, n, 2 * h), *mlp)),
        ("crf_similarity_message", crf_sim.crf_similarity_message,
         crf_sim.crf_similarity_message_plain, (r(b, n, h), r(b, n, h), nidx)),
        ("crf_core", lambda *a: crf_core.crf_core(*a, steps=3),
         lambda *a: crf_core.crf_core_plain(*a, steps=3),
         (r(b, n, h), r(b, n, h), s, nidx, r(h, h, scale=0.1))),
        ("discrete_core", lambda *a: discrete_core.discrete_core(*a, steps=3),
         lambda *a: discrete_core.discrete_core_plain(*a, steps=3),
         (p, -torch.log(p), r(b, n, k - 1, scale=0.2), nidx, r(4, 4))),
        ("leaky_relu_bwd", lambda x, y: activation.leaky_relu_bwd(x, y, 0.1),
         lambda x, y: activation.leaky_relu_bwd_plain(x, y, 0.1),
         (r(b, n, h, shift=-0.5), r(b, n, h))),
    ]


BF16_CASES = ["windowed_gather", "windowed_gather_bwd",
              "windowed_weighted_reduce", "point_conv_fused_infer",
              "point_conv_fused_strided", "crf_similarity_message", "crf_core",
              "discrete_core", "leaky_relu_bwd"]


@pytest.mark.parametrize("case", BF16_CASES)
def test_wrapper_takes_bf16_on_the_card(dev, case):
    """A wrapper given bfloat16 on the card launches its float32 kernel
    once and rounds the result once: the result is the kernel's on the
    widened inputs, rounded, and that float32 result is held against the
    plain version on the same inputs (bit-equal where the kernel adds in
    the plain order, else rtol 1e-4, atol 1e-5, as chip_smoke.py holds
    them)."""
    name, wrapper, plain, args = next(
        c for c in _bf16_cases(dev) if c[0] == case)
    narrow = [a.to(torch.bfloat16) if isinstance(a, torch.Tensor)
              and a.is_floating_point() else a for a in args]
    wide = [a.float() if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in narrow]
    with torch.no_grad():
        before = cuda_build.launch_counts()
        got = wrapper(*narrow)
        launched = {k: v - before[k]
                    for k, v in cuda_build.launch_counts().items() if v
                    - before[k]}
        once = wrapper(*wide)
        ref = plain(*wide)
    torch.cuda.synchronize()
    assert launched and all(v == 1 for v in launched.values()), launched
    got, once, ref = ((t if isinstance(t, tuple) else (t,))
                      for t in (got, once, ref))
    for a, o, r in zip(got, once, ref):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, o.to(torch.bfloat16))
        assert torch.allclose(o, r, rtol=1e-4, atol=1e-5)


def _write_rooms(root, rng, n_pts=3000):
    """S3DIS's raw layout: Area_1 with two rooms, Area_5 with one; each
    room's wall and floor ``x y z r g b`` rows."""
    import os

    raw = os.path.join(root, "raw")
    base = os.path.join(raw, "Stanford3dDataset_v1.2_Aligned_Version")
    for area, rooms in ((1, 2), (5, 1)):
        rels = []
        for i in range(rooms):
            rel = f"Area_{area}/office_{i}/Annotations"
            os.makedirs(os.path.join(base, rel))
            for cls in ("wall_1", "floor_1", "table_1"):
                pts = np.column_stack([rng.random((n_pts, 3)) * 3,
                                       rng.integers(0, 255, (n_pts, 3))])
                np.savetxt(os.path.join(base, rel, cls + ".txt"), pts,
                           fmt="%.4f")
            rels.append(rel)
        with open(os.path.join(raw, f"Area_{area}_anno.txt"), "w") as f:
            f.write("\n".join(rels) + "\n")


def test_trainer_resume_on_the_card(dev, tmp_path):
    """The Trainer on the card: an epoch, a checkpoint with its sidecar; a
    second Trainer resumed from it draws the live one's next samples bit
    for bit, has its generator's state, and its next step on the same
    batch gives a bit-identical loss and parameters (windowed steps add in
    fixed orders)."""
    from crfconv_tpu_torch.train.config import S3DISConfig
    from crfconv_tpu_torch.train.trainer import Trainer

    _write_rooms(str(tmp_path / "s3dis"), np.random.default_rng(0))
    cfg = S3DISConfig(root=str(tmp_path / "s3dis"), grid_size=0.05,
                      sample_num=2048, batch_size=4, epochs=1,
                      train_samples_per_epoch=12, val_samples_per_epoch=4,
                      layers=(16, 32, 64, 128, 256),
                      checkpoint_dir=str(tmp_path / "ckpt"))

    def make():
        return Trainer(cfg, seed=3, device=dev)

    live = make()
    live.train_one_epoch(0)
    live.ckpt.save(live.state, step=live.state.step,
                   aux=live._aux_state(1))
    resumed = make()
    assert resumed.resume() == 1
    assert torch.equal(resumed.rng.get_state(), live.rng.get_state())
    for t in (live, resumed):
        t.draws = [t.train_loader.dataset.get_sample(t.train_loader.rng)
                   for _ in range(3)]
    for a, b in zip(live.draws, resumed.draws):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    batch = next(iter(resumed.train_loader))
    assert batch.pos.is_cuda
    m1 = live._train_step(live.state, batch, live.rng)
    m2 = resumed._train_step(resumed.state, batch, resumed.rng)
    assert torch.equal(m1["loss"], m2["loss"])
    a, b = live.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)


# --------------------------------------------------------------------------
# data-parallel steps on the card
# --------------------------------------------------------------------------

DP_NARROW = (16, 32, 64, 128, 256)


def _dp_spec(steps: int) -> dict:
    """A narrow flagship (dropout 0.5) and a global B2 x 1024 batch with
    class weights and ignored labels, for ``steps`` windowed steps."""
    from crfconv_tpu_torch import PointConvResNet

    rng = np.random.default_rng(11)
    y = rng.integers(0, 13, (2, 1024))
    y[0, :9] = -1
    kw = dict(n_classes=13, in_channels=6, use_crf=True, steps=1,
              layers=DP_NARROW, dropout_rate=0.5)
    model = PointConvResNet(device="cpu",
                            generator=torch.Generator().manual_seed(4), **kw)
    return {"kind": "step", "model": "PointConvResNet", "model_kw": kw,
            "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "mode": {"mode": "windowed", "knn_exact": False},
            "windowed": True, "steps": steps, "seed": 21,
            "class_weights": (0.5 + rng.random(13)).astype(np.float32),
            "batch": {"pos": rng.random((2, 1024, 3), np.float32),
                      "x": rng.random((2, 1024, 6), np.float32), "y": y}}


def test_dp_world_of_one_nccl_step_is_the_plain_step(dev):
    """make_parallel_train_step over an nccl group of one rank: two steps
    bit-equal to the one-process step's (the gradient bucket, the loss's
    parts and the metrics all-reduced over one rank; the batch norms keep
    their local statistics)."""
    from crfconv_tpu_torch.parallel import (
        close_mesh, make_mesh, make_parallel_train_step,
    )
    from crfconv_tpu_torch.train.train_state import (
        TrainState, make_train_step,
    )

    spec = _dp_spec(2)
    batch = parallel_ranks.make_batch(spec["batch"], dev)
    states = []
    for _ in range(2):
        model = parallel_ranks.get_model("PointConvResNet", device=dev,
                                         **spec["model_kw"])
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in spec["state"].items()})
        states.append(TrainState.create(model, lr=0.01))
    cw = torch.as_tensor(spec["class_weights"], device=dev)
    step = make_train_step(class_weights=cw)
    mesh = make_mesh(1, backend="nccl", device=dev)
    try:
        pstep = make_parallel_train_step(step, mesh)
        for i in range(2):
            a = step(states[0], batch,
                     torch.Generator(device=dev).manual_seed(21 + i))
            b = pstep(states[1], batch,
                      torch.Generator(device=dev).manual_seed(21 + i))
            assert torch.equal(a["loss"], b["loss"])
            assert torch.equal(a["confusion"], b["confusion"])
            sa, sb = (s.model.state_dict() for s in states)
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    finally:
        close_mesh(mesh)


def test_dp_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two gloo ranks on cuda:0, each on one cloud of the global batch:
    two steps against the one-process step on the card (loss rtol 1e-5,
    parameters rtol 1e-3 / atol 5e-5, running statistics rtol 1e-3 / atol
    1e-5), the ranks bit-equal after each step."""
    from crfconv_tpu_torch.parallel import launch

    spec = _dp_spec(2)
    r0, r1 = (r["dp"] for r in launch(
        parallel_ranks.run_scenarios, 2, ["cuda:0", "cuda:0"], "gloo",
        args=({"dp": spec},), init_method=f"file://{tmp_path}/pg",
        timeout_s=600))
    one = parallel_ranks.step_scenario(None, {**spec, "device": "cuda"})
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    params = {n for n, _ in parallel_ranks.get_model(
        "PointConvResNet", device="cpu", **spec["model_kw"]
    ).named_parameters()}
    for i in range(2):
        np.testing.assert_array_equal(r0["confusion"][i],
                                      one["confusion"][i])
        for k, ref in one["states"][i].items():
            assert np.array_equal(r0["states"][i][k], r1["states"][i][k]), k
            tol = (dict(rtol=1e-3, atol=5e-5) if k in params
                   else dict(rtol=1e-3, atol=1e-5))
            np.testing.assert_allclose(r0["states"][i][k], ref.numpy(),
                                       err_msg=k, **tol)


def _spatial_forward_spec(n: int, seed: int) -> dict:
    """A narrow flagship (steps 2) and a B1 x ``n`` windowed pyramid on the
    host, for the point-sharded forward."""
    from crfconv_tpu_torch import PointConvResNet

    rng = np.random.default_rng(seed)
    kw = dict(n_classes=5, in_channels=6, use_crf=True, steps=2,
              layers=DP_NARROW)
    model = PointConvResNet(device="cpu",
                            generator=torch.Generator().manual_seed(seed),
                            **kw)
    pos = rng.random((1, n, 3), dtype=np.float32)
    order, scales = windowed.build_pyramid_windowed(
        pos, generator=torch.Generator().manual_seed(seed), device="cpu")
    x = np.take_along_axis(rng.random((1, n, 6), dtype=np.float32),
                           order.numpy()[..., None], 1)
    return {"kind": "forward", "model": "PointConvResNet", "model_kw": kw,
            "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "batch": {"x": x, "scales": [[t.numpy() for t in s]
                                         for s in scales]}}


def test_spatial_world_of_one_nccl_forward_is_the_unsharded(dev):
    """The point-sharded forward over an nccl point group of one rank
    (zero halos, every frame of at least one halo sharded) against the
    unsharded forward at B1 x 16384: atol 2e-5, the same kernels
    launched (K1-K5, K9, K10; on extended frames, so not as often)."""
    from crfconv_tpu_torch.parallel import (
        close_mesh, make_mesh, make_spatial_forward, shard_points,
    )

    spec = _spatial_forward_spec(16384, 5)
    model = spatial_ranks._model(spec, dev)
    batch = spatial_ranks.make_batch(spec["batch"], dev)
    mode = neighbors.NeighborMode("windowed")
    model.eval()
    with torch.no_grad():
        cuda_build.reset_launch_counts()
        ref = model(batch, mode)
        torch.cuda.synchronize()
        plain = {k: v for k, v in cuda_build.launch_counts().items() if v}
    mesh = make_mesh(1, backend="nccl", device=dev)
    try:
        fn, info = make_spatial_forward(model, mesh, batch, mode)
        assert info["sharded_scales"] == [16384, 4096, 1024]
        cuda_build.reset_launch_counts()
        got = fn(shard_points(batch, mesh, set(info["sharded_scales"])))
        torch.cuda.synchronize()
        sharded = {k: v for k, v in cuda_build.launch_counts().items() if v}
    finally:
        close_mesh(mesh)
    assert set(sharded) == set(plain)
    assert {"windowed_gather", "point_conv_fused_infer",
            "crf_similarity_message"} <= set(plain)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)


def test_spatial_exchange_and_gather_on_the_card(dev, tmp_path):
    """exchange_halo and the replicated all-gather on CUDA tensors, forward
    and backward: two gloo ranks sharing cuda:0 (the rows pass through the
    host), against their global forms; and an nccl group of one (zero
    halos, the whole as it is)."""
    from crfconv_tpu_torch.parallel import (
        close_mesh, exchange_halo, launch, make_mesh,
    )
    from crfconv_tpu_torch.parallel.spatial_forward import (
        _all_gather_replicated,
    )

    x = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    h, n = 2, 4
    rs = launch(spatial_ranks.run_scenarios, 2, ["cuda:0", "cuda:0"], "gloo",
                args=({"e": {"kind": "exchange", "x": x, "h": h},
                       "g": {"kind": "gather", "x": x}},),
                init_method=f"file://{tmp_path}/pg", timeout_s=300)
    pad = np.pad(x, ((0, 0), (h, h), (0, 0)))
    grad = np.zeros_like(x)
    w = np.arange(2 * (n + 2 * h) * 3, dtype=np.float32).reshape(
        2, n + 2 * h, 3)
    for p in range(2):
        for i in range(n + 2 * h):
            if 0 <= p * n - h + i < 2 * n:
                grad[:, p * n - h + i] += w[:, i]
    wg = sum(np.arange(x.size, dtype=np.float32).reshape(x.shape) * (1 + p)
             for p in range(2))
    for p, r in enumerate(rs):
        e = r["e"]
        np.testing.assert_array_equal(e["ext"], pad[:, p * n:p * n + n + 2 * h])
        np.testing.assert_array_equal(e["grad"], grad[:, p * n:(p + 1) * n])
        np.testing.assert_array_equal(e["gathered"], x)
        np.testing.assert_array_equal(e["gather_grad"],
                                      wg[:, p * n:(p + 1) * n])
        np.testing.assert_array_equal(r["g"], x)

    mesh = make_mesh(1, backend="nccl", device=dev)
    try:
        t = torch.as_tensor(x, device=dev).requires_grad_(True)
        e = exchange_halo(t, h, mesh)
        torch.testing.assert_close(e, torch.as_tensor(pad, device=dev))
        e.sum().backward()
        torch.testing.assert_close(t.grad, torch.ones_like(t))
        t.grad = None
        g = _all_gather_replicated(t, mesh)
        (2 * g).sum().backward()
        torch.testing.assert_close(g, t.detach())
        torch.testing.assert_close(t.grad, torch.full_like(t, 2.0))
    finally:
        close_mesh(mesh)


def test_spatial_two_gloo_ranks_forward_on_the_card(dev, tmp_path):
    """Two gloo ranks sharing cuda:0 serve a B1 x 8192 narrow flagship
    point-sharded (scales 8192 and 2048): their rows put together are the
    unsharded forward's on the card within the fused kernels' tolerance
    (K3, K4 on the halo-extended frames, rtol 1e-4, atol 1e-5)."""
    from crfconv_tpu_torch.parallel import launch

    spec = _spatial_forward_spec(8192, 6)
    rs = launch(spatial_ranks.run_scenarios, 2, ["cuda:0", "cuda:0"], "gloo",
                args=({"f": spec},), init_method=f"file://{tmp_path}/pg",
                timeout_s=300)
    model = spatial_ranks._model(spec, dev).eval()
    with torch.no_grad():
        ref = model(spatial_ranks.make_batch(spec["batch"], dev),
                    neighbors.NeighborMode("windowed")).cpu().numpy()
    assert rs[0]["f"]["sharded"] == [8192, 2048]
    got = np.concatenate([r["f"]["out"] for r in rs], axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

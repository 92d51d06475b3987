"""The port's host pyramid and host ops against the JAX package's, on the
CPU: ``build_pyramid`` (random and farthest-point subsampling, with and
without ShapeNet's dilations, k_up 1 and 3, the native and the scipy kNN),
``_dilate``, the numpy Morton codes, grid subsampling (native and numpy),
the native library's build and ``make_batch``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crfconv_tpu.data import pipeline as jpipe
from crfconv_tpu.ops import knn_host as jknn
from crfconv_tpu.ops import morton as jmorton
from crfconv_tpu.ops import subsample as jsub
from crfconv_tpu_torch.data import pipeline
from crfconv_tpu_torch.ops import knn_host, morton, native_build, subsample
from tests.test_torch_ops import few_torch_threads  # noqa: F401

SHAPENET = dict(kernel_sizes=(32, 16, 8, 8, 8), ratios=(4, 2, 2, 2, 2))
DILATIONS = (1, 2, 4, 2, 1)


@pytest.fixture
def jax_backend(monkeypatch):
    """Sets the JAX package's kNN to one backend: it takes the native
    library when it builds, else scipy, and remembers the choice."""
    def use(backend):
        monkeypatch.setattr(jknn, "_NATIVE_TRIED", True)
        monkeypatch.setattr(jknn, "_NATIVE", None)
        if backend == "native":
            from crfconv_tpu.ops import native_build as jnative

            monkeypatch.setattr(jknn, "_NATIVE", jnative.load_knn())
    return use


def _planar_cloud(rng, b, n):
    """Clouds on two planes, coordinates on a 1e-3 grid: exact ties in
    the kNN distances, as in real scans."""
    pos = np.round(rng.random((b, n, 3)), 3).astype(np.float32)
    pos[:, : n // 2, 2] = 0.0
    pos[:, n // 2:, 0] = 0.25
    return pos


@pytest.mark.parametrize("backend", ["native", "scipy"])
@pytest.mark.parametrize("k_up", [1, 3])
@pytest.mark.parametrize("dilations", [None, DILATIONS])
@pytest.mark.parametrize("method", ["random", "fps"])
def test_build_pyramid_matches_jax(method, dilations, k_up, backend,
                                   jax_backend):
    jax_backend(backend)
    pos = np.random.default_rng(1).random((2, 512, 3), dtype=np.float32)
    kw = dict(k_up=k_up, dilations=dilations, method=method, **SHAPENET)
    ref = jpipe.build_pyramid(pos, rng=np.random.default_rng(7), **kw)
    got = pipeline.build_pyramid(pos, rng=np.random.default_rng(7),
                                 backend=backend, **kw)
    assert len(got) == len(ref) == 5
    for s, r in zip(got, ref):
        for name in ("pos", "neighbor_idx", "sub_idx", "up_idx"):
            a, b = getattr(s, name), getattr(r, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert s.up_idx.shape[2] == k_up
        # column 0 is the point itself
        np.testing.assert_array_equal(
            s.neighbor_idx[..., 0], np.broadcast_to(
                np.arange(s.pos.shape[1]), s.neighbor_idx.shape[:2]))


@pytest.mark.parametrize("cloud", ["uniform", "planar"])
def test_backends_agree(cloud):
    """Native and scipy kNN: the same distances, column by column. On a
    uniform cloud the indices agree on >= 0.999 of the entries; on planar
    clouds on a 1e-3 grid, whose distances tie exactly, the two order the
    tied neighbours differently (0.998 of the entries agree there)."""
    rng = np.random.default_rng(2)
    pos = (_planar_cloud(rng, 2, 2048) if cloud == "planar"
           else rng.random((2, 2048, 3), dtype=np.float32))
    a = knn_host.knn_batch(pos, pos, 16, backend="native")
    b = knn_host.knn_batch(pos, pos, 16, backend="scipy")
    assert a.shape == b.shape == (2, 2048, 16) and a.dtype == np.int32
    if cloud == "uniform":
        assert (a == b).mean() >= 0.999
    da = np.take_along_axis(pos, a.reshape(2, -1)[..., None], 1)
    db = np.take_along_axis(pos, b.reshape(2, -1)[..., None], 1)
    q = np.repeat(pos, 16, axis=1)
    np.testing.assert_allclose(((da - q) ** 2).sum(-1),
                               ((db - q) ** 2).sum(-1), rtol=0, atol=1e-6)


def test_knn_backend_is_explicit():
    pos = np.zeros((1, 4, 3), np.float32)
    with pytest.raises(ValueError, match="backend"):
        knn_host.knn_batch(pos, pos, 2, backend="auto")
    with pytest.raises(ValueError, match="backend"):
        subsample.grid_subsample(pos[0], backend="auto")


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A build that fails raises; nothing falls back to scipy."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SOURCE", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_lib", None)
    pos = np.zeros((1, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        knn_host.knn_batch(pos, pos, 2)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_native_builds_into_the_package():
    path = native_build.build()
    assert path.parent == native_build.BUILD_DIR
    assert native_build.BUILD_DIR.parts[-3:] == ("crfconv_tpu_torch",
                                                 "_build", "native")
    assert path.exists()


@pytest.mark.parametrize("k", [8, 32])
def test_dilate_keeps_self(k):
    rng = np.random.default_rng(3)
    pos = rng.random((2, 300, 3), dtype=np.float32)
    nbr = knn_host.knn_batch(pos, pos, 4 * k)
    got = pipeline._dilate(nbr, k, 4, np.random.default_rng(5))
    ref = jpipe._dilate(nbr, k, 4, np.random.default_rng(5))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (2, 300, k)
    np.testing.assert_array_equal(got[..., 0], nbr[..., 0])
    # the other columns reach beyond the plain kNN(k), row by row
    inside = (got[..., :, None] == nbr[..., None, :k]).any(-1)
    assert 0.5 < 1 - inside.mean() < 0.75     # 3/4 of the k - 1 drawn
    np.testing.assert_array_equal(pipeline._dilate(nbr, k, 1, None),
                                  nbr[..., :k])


@pytest.mark.parametrize("shape", [(500, 3), (3, 400, 3)])
def test_morton_np_matches_jax(shape):
    pos = _planar_cloud(np.random.default_rng(4), 1, 1200)[0]
    pos = pos[: int(np.prod(shape)) // 3].reshape(shape)
    code = morton.morton_code_np(pos)
    assert code.dtype == np.uint64
    np.testing.assert_array_equal(code, jmorton.morton_code_np(pos))
    np.testing.assert_array_equal(morton.morton_order_np(pos),
                                  jmorton.morton_order_np(pos))
    # the torch codes order the points the same way
    np.testing.assert_array_equal(
        morton.morton_order(torch.from_numpy(pos)).numpy(),
        morton.morton_order_np(pos))


def _room(rng, n=4000):
    """A floor and a wall on a 1e-3 grid, rgb and labels."""
    pts = np.round(rng.random((n, 3)) * [3.0, 2.0, 2.5], 3).astype(np.float32)
    pts[: n // 2, 2] = 0.0
    pts[n // 2:, 1] = 2.0
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
    lab = rng.integers(0, 4, n).astype(np.int32)
    return pts, rgb, lab


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("parts", ["points", "features", "labels"])
def test_grid_subsample_matches_jax(backend, parts):
    pts, rgb, lab = _room(np.random.default_rng(6))
    args = {"points": (pts,), "features": (pts, rgb),
            "labels": (pts, rgb, lab)}[parts]
    if backend == "native":
        from crfconv_tpu.ops import native_build as jnative

        ref = jnative.load_subsample()(*args, grid_size=0.1)
    else:
        ref = jsub.grid_subsample_numpy(*args, grid_size=0.1)
    got = subsample.grid_subsample(*args, grid_size=0.1, backend=backend)
    got, ref = ((x,) if isinstance(x, np.ndarray) else x for x in (got, ref))
    assert len(got) == len(ref) == len(args)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_grid_subsample_backends_agree():
    """Native and numpy: the same voxels, in another order, on points off
    the voxel boundaries (the JAX package's two backends round a point on a
    boundary differently: native divides in float64 by a float32 size,
    numpy in float32)."""
    rng = np.random.default_rng(8)
    pts = rng.random((5000, 3), dtype=np.float32) * 4
    rgb = rng.random((5000, 4), dtype=np.float32)
    lab = rng.integers(0, 9, 5000).astype(np.int32)
    a = subsample.grid_subsample(pts, rgb, lab, 0.25)
    b = subsample.grid_subsample(pts, rgb, lab, 0.25, backend="numpy")
    assert a[0].shape == b[0].shape
    oa, ob = (np.lexsort(x[0].T) for x in (a, b))
    np.testing.assert_allclose(a[0][oa], b[0][ob], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a[1][oa], b[1][ob], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a[2][oa], b[2][ob])


def test_make_batch_and_synthetic_batch_match_jax():
    """synthetic_batch on the CPU: the JAX package's values, labels and
    indices int64 (the port's gathers index with int64)."""
    got = pipeline.synthetic_batch(2, 256, k_up=3, seed=3,
                                   with_category=True, device="cpu")
    rng = np.random.default_rng(3)
    pos = rng.random((2, 256, 3), dtype=np.float32)
    feats = rng.random((2, 256, 6), dtype=np.float32)
    y = rng.integers(0, 13, size=(2, 256))
    scales = jpipe.build_pyramid(pos, k_up=3, rng=rng)
    category = rng.integers(0, 16, size=(2,))
    assert got.x.dtype == torch.float32 and got.y.dtype == torch.int64
    np.testing.assert_array_equal(got.x.numpy(), feats)
    np.testing.assert_array_equal(got.y.numpy(), y)
    np.testing.assert_array_equal(got.category.numpy(), category)
    for s, r in zip(got.scales, scales):
        np.testing.assert_array_equal(s.pos.numpy(), r.pos)
        for name in ("neighbor_idx", "sub_idx", "up_idx"):
            t = getattr(s, name)
            assert t.dtype == torch.int64, name
            np.testing.assert_array_equal(t.numpy(), getattr(r, name))


def test_distance_pick_matches_jax():
    from crfconv_tpu.ops import native_build as jnative

    pts = np.random.default_rng(9).random((2, 700, 3), dtype=np.float32)
    got = native_build.knn_batch_distance_pick(pts, 40, 16, seed=4)
    ref = jnative.load_knn().knn_batch_distance_pick(pts, 40, 16, seed=4)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (2, 40, 3) and got[1].shape == (2, 40, 16)

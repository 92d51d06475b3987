"""crfconv_tpu_torch ops against the JAX package, on the CPU: window
geometry, Morton order, the plain windowed gather and window kNN against
the JAX CPU path, the pyramid builder, the CRF math, and the rule that the
port imports no JAX."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.ops import crf as jcrf
from crfconv_tpu.ops import morton as jmorton
from crfconv_tpu.ops import neighbors as jnb
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu_torch.ops import crf, morton, neighbors, windowed
from crfconv_tpu_torch.ops.neighbors import NeighborMode

REPO = Path(__file__).resolve().parents[1]
WINDOWED = NeighborMode("windowed")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _sorted_cloud(rng, b, n):
    pos = rng.random((b, n, 3)).astype(np.float32)
    for i in range(b):
        pos[i] = pos[i][jmorton.morton_order_np(pos[i])]
    return pos


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------


def test_import_loads_no_jax():
    code = (
        "import sys, crfconv_tpu_torch, crfconv_tpu_torch.serve\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax') or "
        "m == 'crfconv_tpu' or m.startswith(('jax.', 'flax.', "
        "'crfconv_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_sources_name_no_jax():
    paths = list((REPO / "crfconv_tpu_torch").rglob("*.py"))
    for path in paths + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mods = [w.split(".")[0] for w in words[1:] if w != "import"]
                assert not {"jax", "flax", "crfconv_tpu"} & set(mods), (
                    f"{path}: {line}"
                )


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 8, 4), device="meta")
    idx = torch.empty((1, 8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        windowed.windowed_gather(x, idx)
    with pytest.raises(ValueError):
        windowed.windowed_gather(torch.zeros(1, 8, 4), idx)


# ---------------------------------------------------------------------------
# geometry and Morton order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,n", [(8192, 8192), (2048, 8192), (8192, 2048), (32, 16), (1000, 333)]
)
def test_window_starts_matches(m, n):
    s, w, f = windowed.window_starts(m, n)
    js, jw, jf = jwin.window_starts(m, n)
    np.testing.assert_array_equal(s, js)
    assert (w, f) == (jw, jf)


def test_morton_order_matches():
    pos = _rng(1).random((2, 2048, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        morton.morton_code(_t(pos)).numpy(),
        np.asarray(jmorton.morton_code(jnp.asarray(pos))).astype(np.int64),
    )
    np.testing.assert_array_equal(
        morton.morton_order(_t(pos)).numpy(),
        np.asarray(jmorton.morton_order(jnp.asarray(pos))),
    )


def test_morton_rotated_view_matches():
    pos = _rng(2).random((1, 2048, 3)).astype(np.float32)
    rot = morton.view_rotation(1)
    np.testing.assert_allclose(
        rot.numpy(), np.asarray(jmorton.view_rotation(1)), rtol=0, atol=0
    )
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(
            jmorton.morton_order(jnp.asarray(pos), rot=jnp.asarray(rot.numpy()))
        )
    got = morton.morton_order(_t(pos), rot=rot).numpy()
    # a 3-term dot rounds differently in the two libraries; a point on a
    # grid-cell boundary may change cell
    assert (got == ref).mean() >= 0.995


# ---------------------------------------------------------------------------
# windowed gather (plain) against the JAX CPU path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,n,f,k,consistent",
    [
        (1024, 1024, 8, 16, True),
        (256, 1024, 32, 16, True),
        (1024, 256, 16, 1, True),   # upsample: M > N
        (300, 300, 5, 7, False),    # arbitrary indices: the clamp decides
    ],
)
def test_windowed_gather_matches_jax(m, n, f, k, consistent):
    rng = _rng(3)
    if consistent:
        centers = (np.arange(m) * (n / m)).astype(np.int64)
        idx = np.clip(
            centers[None, :, None] + rng.integers(-100, 100, (2, m, k)),
            0, n - 1,
        ).astype(np.int32)
    else:
        idx = rng.integers(0, n, (2, m, k)).astype(np.int32)
    x = rng.standard_normal((2, n, f)).astype(np.float32)
    got = windowed.windowed_gather(_t(x), _t(idx)).numpy()
    ref = np.asarray(jwin.windowed_gather(jnp.asarray(x), jnp.asarray(idx)))
    # the JAX CPU path selects through a hi/lo bf16 split (~2^-17 relative)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    if consistent:
        np.testing.assert_array_equal(
            got, np.stack([x[b][idx[b]] for b in range(2)])
        )


def test_gather_and_upsample_modes_agree():
    rng = _rng(4)
    n = 512
    x = _t(rng.standard_normal((2, n, 6)).astype(np.float32))
    idx = np.clip(
        np.arange(n)[None, :, None] + rng.integers(-64, 64, (2, n, 9)), 0, n - 1
    ).astype(np.int32)
    exact = neighbors.gather_neighbors(x, _t(idx), NeighborMode())
    win = neighbors.gather_neighbors(x, _t(idx), WINDOWED)
    assert torch.equal(exact, win)
    up = _t(idx[:, :, :1])
    assert torch.equal(
        neighbors.upsample_nearest(x, up, WINDOWED),
        neighbors.upsample_nearest(x, up, NeighborMode()),
    )


def test_masked_softmax_and_self_loop():
    rng = _rng(5)
    logits = rng.standard_normal((2, 7, 5)).astype(np.float32)
    mask = rng.random((2, 7, 5)) > 0.3
    mask[0, 0] = False
    got = neighbors.masked_softmax(_t(logits), _t(mask), dim=-1).numpy()
    ref = np.asarray(jnb.masked_softmax(jnp.asarray(logits), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    nidx = rng.integers(0, 7, (2, 7, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        neighbors.remove_self_loop(_t(nidx)).numpy(),
        np.asarray(jnb.remove_self_loop(jnp.asarray(nidx))),
    )


# ---------------------------------------------------------------------------
# window kNN (plain) against the JAX CPU path (einsum + lax.top_k)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(1024, 16), (1000, 8)])
def test_window_knn_exact_matches_jax(n, k):
    pos = _sorted_cloud(_rng(6), 2, n)
    ref = np.asarray(jwin.window_knn(jnp.asarray(pos), k))
    got = windowed.window_knn(_t(pos), k, exact=True).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    # the two libraries round the 3-term cross product differently, which
    # can swap neighbours whose distances tie to the last bit
    assert (got == ref).mean() >= 0.999
    np.testing.assert_array_equal(got[:, :, 0], np.tile(np.arange(n), (2, 1)))
    assert windowed.check_window_consistency(got, n) == 1.0


def test_window_knn_bipartite_matches_jax():
    pos = _sorted_cloud(_rng(7), 2, 1024)
    coarse = np.ascontiguousarray(pos[:, ::4])
    ref = np.asarray(
        jwin.window_knn(jnp.asarray(coarse), 1, query_pos=jnp.asarray(pos))
    )
    got = windowed.window_knn(_t(coarse), 1, query_pos=_t(pos)).numpy()
    assert got.shape == (2, 1024, 1)
    assert (got == ref).mean() >= 0.999
    assert windowed.check_window_consistency(got, 256) == 1.0


def test_window_knn_packed_near_exact():
    pos = _t(_sorted_cloud(_rng(8), 2, 1024))
    exact = windowed.window_knn(pos, 16, exact=True).numpy()
    packed = windowed.window_knn(pos, 16, exact=False).numpy()
    assert (packed == exact).mean() >= 0.99
    np.testing.assert_array_equal(packed[:, :, 0], exact[:, :, 0])
    # a packed pick is never farther than the exact k-th by more than the
    # 2^-13 relative tie radius
    p = pos.numpy()

    def dist(idx):
        return np.stack([
            np.linalg.norm(p[b][idx[b]] - p[b][:, None], axis=-1)
            for b in range(2)
        ])

    assert np.all(dist(packed)[..., -1] <= dist(exact)[..., -1] * (1 + 1e-3))


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------


def jax_offsets(key, n, ratios=(4, 4, 4, 4, 2)):
    """The per-scale offsets build_pyramid_windowed draws from ``key``."""
    out = []
    for r in ratios:
        key, sub = jax.random.split(key)
        sample = max(n // r, 1)
        out.append(np.asarray(jax.random.randint(sub, (sample,), 0, r)))
        n = sample
    return out


def test_pyramid_matches_jax():
    pos = _rng(9).random((2, 2048, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    order_j, scales_j = jwin.build_pyramid_windowed(jnp.asarray(pos), key=key)
    order, scales = windowed.build_pyramid_windowed(
        pos, offsets=jax_offsets(key, 2048), device="cpu"
    )
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    assert len(scales) == len(scales_j) == 5
    for s, sj in zip(scales, scales_j):
        np.testing.assert_array_equal(s.pos.numpy(), np.asarray(sj.pos))
        for name in ("neighbor_idx", "sub_idx", "up_idx"):
            got = getattr(s, name).numpy()
            ref = np.asarray(getattr(sj, name))
            assert got.shape == ref.shape, name
            assert (got == ref).mean() >= 0.999, name
        n_src = s.pos.shape[1]
        assert windowed.check_window_consistency(
            s.neighbor_idx.numpy(), n_src) == 1.0
        assert windowed.check_window_consistency(
            s.up_idx.numpy(), s.sub_idx.shape[1]) == 1.0


def test_pyramid_generator_and_curve_rot():
    pos = _rng(10).random((1, 1024, 3)).astype(np.float32)
    a = windowed.build_pyramid_windowed(
        pos, generator=torch.Generator().manual_seed(1), device="cpu",
        knn_exact=False, curve_rot=morton.view_rotation(1),
    )
    b = windowed.build_pyramid_windowed(
        pos, generator=torch.Generator().manual_seed(1), device="cpu",
        knn_exact=False, curve_rot=morton.view_rotation(1),
    )
    assert torch.equal(a[0], b[0])
    for sa, sb in zip(a[1], b[1]):
        assert torch.equal(sa.sub_idx, sb.sub_idx)
    assert not torch.equal(a[0], morton.morton_order(_t(pos)))


# ---------------------------------------------------------------------------
# CRF math
# ---------------------------------------------------------------------------


def test_spd_inverse_matches():
    a = _rng(11).standard_normal((8, 8)).astype(np.float32)
    m = np.eye(8, dtype=np.float32) + a.T @ a
    got = crf._spd_inverse(_t(m)).numpy()
    ref = np.asarray(jcrf._spd_inverse(jnp.asarray(m)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("steps,first", [(1, "msg0"), (2, "neighbors0"), (3, None)])
def test_crf_scan_matches(steps, first):
    rng = _rng(12)
    b, n, k, h = 2, 256, 7, 8
    z = rng.standard_normal((b, n, h)).astype(np.float32)
    y = rng.standard_normal((b, n, h)).astype(np.float32)
    c = (np.eye(h) + 0.1 * rng.standard_normal((h, h))).astype(np.float32)
    idx = np.clip(
        np.arange(n)[None, :, None] + rng.integers(-40, 40, (b, n, k)), 0, n - 1
    ).astype(np.int32)
    s_ref = jcrf.gaussian_similarity(jnp.asarray(y), jnp.asarray(idx))
    s = crf.gaussian_similarity(_t(y), _t(idx), NeighborMode())
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-6)
    zn = z[np.arange(b)[:, None, None], idx]
    msg0 = np.einsum("bnk,bnkh->bnh", np.asarray(s_ref), zn)
    kw_j, kw_t = {}, {}
    if first == "msg0":
        kw_j["msg0"], kw_t["msg0"] = jnp.asarray(msg0), _t(msg0)
    elif first == "neighbors0":
        kw_j["neighbors0"], kw_t["neighbors0"] = jnp.asarray(zn), _t(zn)
    ref = jcrf._crf_scan(
        jnp.asarray(z), s_ref, jnp.asarray(idx), jnp.asarray(c), steps, **kw_j
    )
    got = crf.crf_mean_field(
        _t(z), _t(np.asarray(s_ref)), _t(idx), _t(c), steps, NeighborMode(),
        **kw_t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)

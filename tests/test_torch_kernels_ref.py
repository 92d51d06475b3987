"""The plain versions of the port's four CUDA kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU. (On a CPU
tensor each wrapper takes its plain version; the CUDA kernels themselves
are held against these plain versions on the card by chip_smoke.py.)"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.ops.conv_pallas import point_conv_fused_infer as j_conv
from crfconv_tpu.ops.crf_sim_pallas import crf_similarity_message as j_sim
from crfconv_tpu.ops.morton import morton_order_np
from crfconv_tpu.ops.windowed import window_knn as j_knn
from crfconv_tpu.ops.windowed_pallas import (
    window_knn_pallas,
    windowed_gather_pallas,
)
from crfconv_tpu_torch.ops import conv, crf_sim, windowed


def _sorted_cloud(rng, b, n):
    pos = rng.random((b, n, 3)).astype(np.float32)
    for i in range(b):
        pos[i] = pos[i][morton_order_np(pos[i])]
    return pos


def _near_diag(rng, b, m, n, k, spread=48):
    centers = (np.arange(m) * (n / m)).astype(np.int64)
    return np.clip(
        centers[None, :, None] + rng.integers(-spread, spread, (b, m, k)),
        0, n - 1,
    ).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize(
    "m,n,f,k", [(256, 256, 16, 8), (512, 256, 11, 1), (128, 512, 7, 16)]
)
def test_windowed_gather_vs_pallas(m, n, f, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, n, f)).astype(np.float32)
    idx = _near_diag(rng, 1, m, n, k)
    ref = np.asarray(windowed_gather_pallas(
        jnp.asarray(x), jnp.asarray(idx), interpret=True
    ))
    got = windowed.windowed_gather_plain(_t(x), _t(idx)).numpy()
    # the Pallas kernel selects through a hi/lo bf16 split (~2^-17 rel.)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("exact,floor", [(True, 0.999), (False, 0.99)])
def test_window_knn_vs_pallas(exact, floor):
    pos = _sorted_cloud(np.random.default_rng(1), 2, 1024)
    ref = np.asarray(window_knn_pallas(
        jnp.asarray(pos), 16, exact=exact, interpret=True
    ))
    got = windowed.window_knn_plain(_t(pos), 16, exact=exact).numpy()
    # the CPU's XLA may fuse the distance's multiply-adds, which moves
    # last-bit ties
    assert (got == ref).mean() >= floor
    np.testing.assert_array_equal(got[:, :, 0], np.tile(np.arange(1024), (2, 1)))
    assert windowed.check_window_consistency(got, 1024) == 1.0


def test_window_knn_bipartite_vs_pallas():
    pos = _sorted_cloud(np.random.default_rng(2), 2, 1024)
    coarse = np.ascontiguousarray(pos[:, ::4])
    ref = np.asarray(window_knn_pallas(
        jnp.asarray(coarse), 1, query_pos=jnp.asarray(pos), exact=False,
        interpret=True,
    ))
    got = windowed.window_knn_plain(
        _t(coarse), 1, query_pos=_t(pos), exact=False
    ).numpy()
    assert (got == ref).mean() >= 0.999


def test_window_knn_packed_matches_exact_reference_order():
    """Packed keys tie distances within 2^-13 relative; on real clouds
    the selected sets agree with the exact JAX path almost everywhere."""
    pos = _sorted_cloud(np.random.default_rng(3), 1, 2048)
    ref = np.asarray(j_knn(jnp.asarray(pos), 16))
    got = windowed.window_knn_plain(_t(pos), 16, exact=False).numpy()
    assert (np.sort(got, -1) == np.sort(ref, -1)).mean() >= 0.99


def _affine(rng, h):
    return [
        rng.standard_normal((3, h)).astype(np.float32),
        (1 + 0.2 * rng.standard_normal(h)).astype(np.float32),
        (0.1 * rng.standard_normal(h)).astype(np.float32),
        (rng.standard_normal((h, h)) / np.sqrt(h)).astype(np.float32),
        (1 + 0.2 * rng.standard_normal(h)).astype(np.float32),
        (0.1 * rng.standard_normal(h)).astype(np.float32),
    ]


@pytest.mark.parametrize("h,k", [(8, 16), (16, 8)])
def test_point_conv_vs_pallas(h, k):
    rng = np.random.default_rng(4)
    n = 1024
    pos = _sorted_cloud(rng, 1, n)
    x = rng.standard_normal((1, n, h)).astype(np.float32)
    idx = _near_diag(rng, 1, n, n, k)
    w0, a0, c0, w1, a1, c1 = _affine(rng, h)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(j_conv(
            *map(jnp.asarray, (x, pos, idx, w0, a0, c0, w1, a1, c1)),
            interpret=True,
        ))
    got = conv.point_conv_fused_infer_plain(
        *map(_t, (x, pos, idx, w0, a0, c0, w1, a1, c1))
    ).numpy()
    # f32 sums over K and H in another order
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("h,k", [(8, 15), (16, 7), (1, 15), (5, 1), (32, 31), (1, 31), (32, 1)])
def test_crf_similarity_vs_pallas(h, k):
    rng = np.random.default_rng(5)
    n = 1024
    y = rng.standard_normal((1, n, h)).astype(np.float32)
    z = rng.standard_normal((1, n, h)).astype(np.float32)
    idx = _near_diag(rng, 1, n, n, k)
    with jax.default_matmul_precision("highest"):
        msg_ref, s_ref = j_sim(
            jnp.asarray(y), jnp.asarray(z), jnp.asarray(idx), interpret=True
        )
    msg, s = crf_sim.crf_similarity_message_plain(_t(y), _t(z), _t(idx))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(msg.numpy(), np.asarray(msg_ref), rtol=2e-4,
                               atol=2e-4)


def test_fold_bn_matches_reference_fold():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((8, 3)).astype(np.float32)       # [out, in]
    scale, bias, mean = (rng.standard_normal(8).astype(np.float32)
                         for _ in range(3))
    var = rng.random(8).astype(np.float32) + 0.5
    W, a, c = conv.fold_bn(*map(_t, (w, scale, bias, mean, var)))
    x = rng.standard_normal((5, 3)).astype(np.float32)
    bn = (x @ w.T - mean) / np.sqrt(var + 1e-5) * scale + bias
    np.testing.assert_allclose(
        (a * (_t(x) @ W) + c).numpy(), bn, rtol=1e-5, atol=1e-5
    )

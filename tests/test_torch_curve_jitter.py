"""Train-time curve jitter in crfconv_tpu_torch on the CPU: the random
rotation (orthonormal, det +1, reproducible from a seeded generator; the
quaternion-to-matrix formula against the JAX package's), the windowed batch
built on a given rotation against JAX's ``build_windowed_batch(curve_rot=R)``
with the same offsets, and a jittered train step: window-consistent at
every scale, rerun-identical from one seed, and not the unjittered step.
The JAX package draws its rotation from a key, so the two packages' random
rotations are not compared."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.ops import morton as jmorton
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import CRFSegNet
from crfconv_tpu_torch.data.batch import RawBatch
from crfconv_tpu_torch.ops import windowed
from crfconv_tpu_torch.ops.morton import quaternion_rotation, random_rotation
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train import train_state
from crfconv_tpu_torch.train.train_state import (
    TrainState, build_windowed_batch, make_train_step,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets

MODE = NeighborMode("windowed", knn_exact=True)
B, N = 2, 1024


def _t(a):
    return torch.from_numpy(np.array(a))


def test_random_rotation_is_a_rotation():
    for seed in range(8):
        r = random_rotation(torch.Generator().manual_seed(seed)).double()
        assert r.dtype == torch.float64 and r.shape == (3, 3)
        torch.testing.assert_close(r @ r.T, torch.eye(3, dtype=torch.float64),
                                   rtol=0, atol=1e-6)
        assert abs(float(torch.linalg.det(r)) - 1.0) <= 1e-6


def test_random_rotation_is_reproducible():
    a = random_rotation(torch.Generator().manual_seed(3))
    b = random_rotation(torch.Generator().manual_seed(3))
    c = random_rotation(torch.Generator().manual_seed(4))
    assert a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(3)
    first = random_rotation(gen)
    assert torch.equal(first, a) and not torch.equal(random_rotation(gen), a)


@pytest.mark.parametrize("seed", range(4))
def test_quaternion_matrix_matches_jax(seed):
    """The matrix of JAX's own normal 4-vector, by the port's formula."""
    key = jax.random.PRNGKey(seed)
    q = np.array(jax.random.normal(key, (4,), jnp.float32))
    ref = np.asarray(jmorton.random_rotation(key))
    got = quaternion_rotation(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-7)


def _cloud(seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, 20, (B, N)).astype(np.int32)
    return pos, feats, y


def test_rotated_batch_matches_jax():
    """The Morton order and pyramid on a turned curve, with the offsets of
    the JAX key: as JAX's ``build_windowed_batch(curve_rot=R)``."""
    pos, feats, y = _cloud(1)
    key = jax.random.PRNGKey(5)
    rot = np.asarray(jmorton.random_rotation(jax.random.PRNGKey(11)))
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y),
               category=jnp.asarray([2, 7]))
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        ref, ref_order = jts.build_windowed_batch(
            raw, key, curve_rot=jnp.asarray(rot), return_order=True)
    got, order = build_windowed_batch(
        RawBatch(pos=_t(pos), x=_t(feats), y=_t(y), category=_t([2, 7])),
        offsets=jax_offsets(key, N), mode=MODE, curve_rot=torch.from_numpy(rot),
        return_order=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(ref_order))
    # the turned curve is another order than the unturned one
    plain = np.asarray(jmorton.morton_order(jnp.asarray(pos)))
    assert (order.numpy() != plain).mean() > 0.5
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(ref.y))
    np.testing.assert_array_equal(got.category.numpy(),
                                  np.asarray(ref.category))
    for s, sj in zip(got.scales, ref.scales):
        np.testing.assert_array_equal(s.pos.numpy(), np.asarray(sj.pos))
        for name in ("neighbor_idx", "sub_idx", "up_idx"):
            a, r = getattr(s, name).numpy(), np.asarray(getattr(sj, name))
            assert a.shape == r.shape, name
            assert (a == r).mean() >= 0.999, name


def test_jitter_draws_the_rotation_first():
    """curve_jitter draws the rotation from the generator, then the
    offsets: the batch of a turned curve with the generator's next
    draws."""
    pos, feats, y = _cloud(2)
    raw = RawBatch(pos=_t(pos), x=_t(feats), y=_t(y))
    got, order = build_windowed_batch(
        raw, torch.Generator().manual_seed(9), mode=MODE, curve_jitter=True,
        return_order=True)
    gen = torch.Generator().manual_seed(9)
    rot = random_rotation(gen)
    ref, ref_order = build_windowed_batch(raw, gen, mode=MODE, curve_rot=rot,
                                          return_order=True)
    assert torch.equal(order, ref_order)
    for s, r in zip(got.scales, ref.scales):
        for a, b in zip(s, r):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        build_windowed_batch(raw, None, offsets=jax_offsets(
            jax.random.PRNGKey(0), N), mode=MODE, curve_jitter=True)


def test_jittered_pyramid_is_window_consistent():
    pos, feats, y = _cloud(3)
    raw = RawBatch(pos=_t(pos), x=_t(feats), y=_t(y))
    jit, order = build_windowed_batch(
        raw, torch.Generator().manual_seed(1), mode=MODE, curve_jitter=True,
        return_order=True)
    _, plain_order = build_windowed_batch(
        raw, torch.Generator().manual_seed(1), mode=MODE, return_order=True)
    assert not torch.equal(order, plain_order)
    for s in jit.scales:
        n = s.pos.shape[1]
        assert windowed.check_window_consistency(s.neighbor_idx.numpy(),
                                                 n) == 1.0
        assert windowed.check_window_consistency(s.sub_idx.numpy(), n) == 1.0
        assert windowed.check_window_consistency(
            s.up_idx.numpy(), s.sub_idx.shape[1]) == 1.0


def _jitter_step(curve_jitter: bool, seed: int = 4):
    pos, feats, y = _cloud(4)
    model = CRFSegNet(20, 6, steps=2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, lr=0.01)
    m = make_train_step(MODE, curve_jitter=curve_jitter)(
        state, RawBatch(pos=_t(pos), x=_t(feats), y=_t(y)),
        torch.Generator().manual_seed(seed))
    return float(m["loss"]), {n: p.grad.clone()
                              for n, p in model.named_parameters()}


def test_jittered_train_step(monkeypatch):
    """Finite loss; the step turns its curve (one rotation drawn a step);
    a rerun from the same seed is bit-identical; the unjittered step from
    that seed differs."""
    rots = []
    monkeypatch.setattr(train_state, "random_rotation",
                        lambda g: rots.append(1) or random_rotation(g))
    loss, grads = _jitter_step(True)
    assert np.isfinite(loss) and len(rots) == 1
    loss2, grads2 = _jitter_step(True)
    assert loss2 == loss
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)
    loss0, grads0 = _jitter_step(False)
    assert len(rots) == 2
    assert loss0 != loss or not all(torch.equal(grads[n], grads0[n])
                                    for n in grads)

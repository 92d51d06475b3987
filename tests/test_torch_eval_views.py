"""The windowed eval step's orientation ensemble (``eval_views=2``) and the
windowed pyramid's ``k_up`` against the JAX package on the CPU: the narrow
flagship's 2-view eval against ``make_eval_step(windowed=True,
eval_views=2)`` (``multi_view_eval``) with each view's offsets replayed
from its key, and ``build_pyramid_windowed(k_up=3)``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import PointConvResNet, from_flax
from crfconv_tpu_torch.data.batch import RawBatch
from crfconv_tpu_torch.ops import windowed
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train.train_state import TrainState, make_eval_step
from tests.test_torch_model import _perturb_stats
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_train_step import _exact_windowed_gather

NARROW = (16, 32, 64, 128, 256)
B, N = 2, 1024
# windowed with exact kNN selection: the JAX CPU path selects exactly
MODE = NeighborMode("windowed", knn_exact=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k_up", [1, 3])
def test_pyramid_k_up_matches_jax(k_up):
    """Each scale's up_idx holds the k_up nearest coarse points in their
    window, as the JAX package's do."""
    pos = np.random.default_rng(12).random((B, N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    _, ref = jwin.build_pyramid_windowed(jnp.asarray(pos), k_up=k_up, key=key)
    _, got = windowed.build_pyramid_windowed(
        pos, k_up=k_up, offsets=jax_offsets(key, N), device="cpu")
    for s, sj in zip(got, ref):
        for name in ("neighbor_idx", "sub_idx", "up_idx"):
            a, r = getattr(s, name).numpy(), np.asarray(getattr(sj, name))
            assert a.shape == r.shape, name
            assert (a == r).mean() >= 0.999, name
        assert s.up_idx.shape[2] == k_up
        assert windowed.check_window_consistency(
            s.up_idx.numpy(), s.sub_idx.shape[1]) == 1.0


def test_two_view_eval_matches_jax(monkeypatch):
    """The narrow flagship's 2-view eval: probabilities averaged in the raw
    point order (rtol 1e-3 atol 1e-4, the 1-view eval's bound), the mean
    loss over the views, predictions and confusion. The JAX CPU gather is
    taken exactly (its hi/lo bfloat16 split keeps ~16 bits)."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    rng = np.random.default_rng(6)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, 13, (B, N)).astype(np.int32)
    y[1, :5] = -1
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y))
    model = JResNet(n_classes=13, use_crf=True, steps=1, layers=NARROW)
    key = jax.random.PRNGKey(9)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        example = jts.build_windowed_batch(raw, jax.random.PRNGKey(0))
        state = jts.create_train_state(model, example,
                                       jts.make_optimizer(lr=0.01))
        state = state.replace(batch_stats=_perturb_stats(state.batch_stats))
        ref = jax.jit(jts.make_eval_step(model, windowed=True,
                                         eval_views=2))(state, raw, key)
    pmodel = PointConvResNet(13, 6, use_crf=True, steps=1, layers=NARROW,
                             device="cpu")
    pmodel.load_state_dict(from_flax(jax.device_get(state.params),
                                     jax.device_get(state.batch_stats)))
    offsets = [jax_offsets(jax.random.fold_in(key, v), N) for v in range(2)]
    got = make_eval_step(MODE, eval_views=2)(
        TrainState.create(pmodel, lr=0.01),
        RawBatch(pos=_t(pos), x=_t(feats), y=_t(y)), offsets=offsets)
    probs = got["probs"].numpy()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs, np.asarray(ref["probs"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    assert (got["preds"].numpy() == np.asarray(ref["preds"])).mean() >= 0.999
    np.testing.assert_array_equal(got["labels"].numpy(), y)
    assert int(got["confusion"].sum()) == int((y >= 0).sum())

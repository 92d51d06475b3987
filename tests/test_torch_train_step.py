"""One train step and one eval step of the narrow flagship, the port
against ``crfconv_tpu.train.train_state`` on the CPU: the same weights
(``from_flax``), the same pyramid (offsets drawn from the JAX key), dropout
off, and the train-fused dispatch on for both sides (the JAX K7 kernel in
interpret mode, the port's K7 plain version)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.ops import conv_pallas
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import PointConvResNet, from_flax
from crfconv_tpu_torch.data.batch import RawBatch
from crfconv_tpu_torch.models import point_conv_big
from crfconv_tpu_torch.ops import conv
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train.train_state import (
    TrainState, build_windowed_batch, make_eval_step, make_train_step,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets

NARROW = (16, 32, 64, 128, 256)
B, N = 2, 1024
# windowed with exact kNN selection: the JAX CPU path selects exactly
MODE = NeighborMode("windowed", knn_exact=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _state_dict(state):
    return from_flax(jax.device_get(state.params),
                     jax.device_get(state.batch_stats))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX train step on a narrow flagship (train-fused dispatch on),
    and the data and key it ran on."""
    rng = np.random.default_rng(3)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, 13, (B, N)).astype(np.int32)
    y[0, :7] = -1                       # ignored labels reach the loss
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y))
    model = JResNet(n_classes=13, use_crf=True, steps=1, layers=NARROW,
                    dropout_rate=0.0)
    key = jax.random.PRNGKey(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "WGR_INTERPRET", True)
    mp.setattr(conv_pallas, "FUSED_MIN_ROWS", 0)
    try:
        with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
            mode = {"mode": "windowed", "tile": 64, "pad": 128}
            assert conv_pallas.train_fused_eligible(
                True, None, None, 4, N, 16, mode
            )
            example = jts.build_windowed_batch(raw, jax.random.PRNGKey(0))
            state = jts.create_train_state(
                model, example, jts.make_optimizer(lr=0.01), seed=0
            )
            step = jax.jit(jts.make_train_step(model, windowed=True))
            new_state, metrics = step(state, raw, key)
            pk = jax.random.split(key)[1]     # the step's pyramid key
            batch_j = jts.build_windowed_batch(raw, pk)
    finally:
        mp.undo()
    return {
        "raw": (pos, feats, y), "pk": pk, "batch": batch_j,
        "before": _state_dict(state), "after": _state_dict(new_state),
        "loss": float(metrics["loss"]),
        "confusion": np.asarray(metrics["confusion"]),
        "model": model, "state": state, "new_state": new_state,
    }


def _port_state(sd, dropout_rate=0.0):
    model = PointConvResNet(13, 6, use_crf=True, steps=1, layers=NARROW,
                            dropout_rate=dropout_rate, device="cpu")
    model.load_state_dict(sd)
    return TrainState.create(model, lr=0.01)


def _raw(data):
    pos, feats, y = data
    return RawBatch(pos=_t(pos), x=_t(feats), y=_t(y))


def test_pyramids_agree(jax_step):
    """The step parity below runs on identical pyramids."""
    batch = build_windowed_batch(
        _raw(jax_step["raw"]), offsets=jax_offsets(jax_step["pk"], N),
        mode=MODE,
    )
    ref = jax_step["batch"]
    np.testing.assert_array_equal(batch.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(batch.y.numpy(), np.asarray(ref.y))
    for s, sj in zip(batch.scales, ref.scales):
        for name in ("pos", "neighbor_idx", "sub_idx", "up_idx"):
            np.testing.assert_array_equal(
                getattr(s, name).numpy(), np.asarray(getattr(sj, name))
            )


def test_train_step_matches_jax(jax_step, monkeypatch):
    monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 0)
    fused = []
    wgr = point_conv_big.weighted_gather_reduce
    monkeypatch.setattr(point_conv_big, "weighted_gather_reduce",
                        lambda *a: fused.append(1) or wgr(*a))
    state = _port_state(jax_step["before"])
    metrics = make_train_step(MODE)(
        state, _raw(jax_step["raw"]), offsets=jax_offsets(jax_step["pk"], N)
    )
    # same-scale layers with hidden <= 32: conv1_1, conv1_2, conv2_2,
    # conv3_2, conv4_2
    assert len(fused) == 5
    assert state.step == 1
    # the bounds of tests/test_weighted_reduce.py's train-fused step
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["loss"],
                               rtol=1e-5)
    np.testing.assert_array_equal(metrics["confusion"].numpy(),
                                  jax_step["confusion"])
    got = state.model.state_dict()
    ref = jax_step["after"]
    assert set(got) == set(ref)
    params = {n for n, _ in state.model.named_parameters()}
    for name in sorted(ref):
        if name in params:
            tol = dict(rtol=1e-3, atol=5e-5)
        else:   # running statistics
            tol = dict(rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   err_msg=name, **tol)
    # These bounds mostly hold the weights both sides started from: the
    # step moves a weight by lr * (grad + wd * p), far less than them. The
    # gradients are held in float64 by test_train_step_update_matches_jax_f64.


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree,
    )


def _exact_windowed_gather(x, idx, tile, pad, use_pallas=None):
    """The JAX windowed gather's function (each index clamped into its
    tile's window, rows outside [0, N) read zero), gathered exactly. On the
    CPU the JAX package selects rows with a one-hot matmul of a hi/lo
    bfloat16 split, exact to ~16 bits of mantissa whatever the dtype."""
    B, n, _ = x.shape
    M = idx.shape[1]
    starts, width, front = jwin.window_starts(M, n, tile, pad)
    row0 = jnp.asarray(np.repeat(starts, tile)[:M])[None, :, None]
    rows = jnp.clip(idx + front - row0, 0, width - 1) + row0 - front
    ok = (rows >= 0) & (rows < n)
    g = x[jnp.arange(B)[:, None, None], jnp.clip(rows, 0, n - 1)]
    return jnp.where(ok[..., None], g, 0)


def test_train_step_update_matches_jax_f64(jax_step, monkeypatch):
    """The step's update, lr * (grad + wd * p), against the JAX step's, both
    in float64 on the same weights and pyramid: this holds the gradient.

    In float32 the two packages' gradients part by a few percent in the
    deepest layers, for reasons of rounding alone: the JAX gather on the
    CPU keeps ~16 bits of mantissa, and each train-mode batch norm's
    backward cancels and so amplifies such errors layer by layer, while the
    port's float32 gradients stay close to a float64 copy of the port. So
    here both sides run in float64, and the JAX gather forward is taken
    exactly (its custom VJP, an XLA scatter-add, is kept). The port takes
    the train-fused path (K7's autograd Function, K8 in its backward), the
    JAX step its unfused XLA path: the same function.
    """
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 0)
    fused = []
    wgr = point_conv_big.weighted_gather_reduce
    monkeypatch.setattr(point_conv_big, "weighted_gather_reduce",
                        lambda *a: fused.append(1) or wgr(*a))
    # Nonzero biases: at the fresh state's zero biases, a batch norm maps
    # the self-pair row of an all-pairs neighbourhood (the 16- and 4-point
    # scales) onto the leaky ReLU's kink at 0, where torch takes the slope
    # as its gradient and JAX takes 1, and where the sign of the rounding
    # in the batch mean picks the side. The flagship at full size has no
    # all-pairs scale.
    state = jax_step["state"]
    gen = np.random.default_rng(5)
    params32 = jax.tree_util.tree_map_with_path(
        lambda path, a: a + np.float32(0.1) * gen.standard_normal(
            a.shape, dtype=np.float32)
        if path[-1].key == "bias" else a,
        jax.device_get(state.params),
    )
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        params = _f64(params32)
        state = state.replace(params=params,
                              batch_stats=_f64(state.batch_stats),
                              opt_state=state.tx.init(params))
        with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
            step = jax.jit(jts.make_train_step(jax_step["model"]))
            new_state, metrics = step(state, _f64(jax_step["batch"]),
                                      jax.random.PRNGKey(1))
        ref_upd = from_flax(
            jax.tree_util.tree_map(lambda a, b: np.asarray(a - b),
                                   new_state.params, params),
            jax.device_get(new_state.batch_stats),
        )
        ref_loss = float(metrics["loss"])
    finally:
        jax.config.update("jax_enable_x64", old)

    model = PointConvResNet(13, 6, use_crf=True, steps=1, layers=NARROW,
                            dropout_rate=0.0, device="cpu")
    model.load_state_dict(from_flax(params32,
                                    jax.device_get(state.batch_stats)))
    model = model.double()
    batch = build_windowed_batch(
        _raw(jax_step["raw"]), offsets=jax_offsets(jax_step["pk"], N),
        mode=MODE,
    )
    batch = batch._replace(
        x=batch.x.double(),
        scales=tuple(s._replace(pos=s.pos.double()) for s in batch.scales),
    )
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(MODE, windowed=False)(
        TrainState.create(model, lr=0.01), batch
    )
    assert len(fused) == 5
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-10)
    upd = {n: (p.detach() - before[n], ref_upd[n].double())
           for n, p in model.named_parameters()}
    u_max = max(float(r.abs().max()) for _, r in upd.values())
    assert u_max > 0
    # within 1e-6 of the tensor's largest update, plus 1e-9 of the model's
    # largest for the gradients that are zero but for rounding (the
    # batch-norm bias of each deconv's unary_nn_1 and pairwise_nn_1); the
    # JAX update carries float32 rounding (from_flax), ~6e-8 of itself
    for name, (u, r) in sorted(upd.items()):
        bound = 1e-6 * float(r.abs().max()) + 1e-9 * u_max
        gap = float((u - r).abs().max()) / bound
        assert gap <= 1.0, f"{name}: update off by {gap:.3g} of its bound"
    for name, t in model.named_buffers():   # running statistics
        np.testing.assert_allclose(t.numpy(), ref_upd[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def test_eval_step_matches_jax(jax_step):
    """Eval of the stepped JAX state, in both packages (fresh pyramid)."""
    key = jax.random.PRNGKey(7)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        ref = jax.jit(jts.make_eval_step(jax_step["model"], windowed=True))(
            jax_step["new_state"], JRaw(*map(jnp.asarray, jax_step["raw"])),
            key,
        )
    state = _port_state(jax_step["after"])
    got = make_eval_step(MODE)(state, _raw(jax_step["raw"]),
                               offsets=jax_offsets(key, N))
    assert not state.model.training
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    # the flagship logits' bound (tests/test_torch_model.py), on softmax
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(ref["probs"]),
                               rtol=1e-3, atol=1e-4)
    assert (got["preds"].numpy() == np.asarray(ref["preds"])).mean() >= 0.999
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))


def test_dropout_in_the_train_step():
    """Dropout draws from the step's generator: with the pyramid fixed by
    offsets, one generator state gives one step and another a different
    one, and at rate 0 the generator does not matter."""
    rng = np.random.default_rng(4)
    raw = RawBatch(
        pos=torch.as_tensor(rng.random((1, 512, 3), dtype=np.float32)),
        x=torch.as_tensor(rng.random((1, 512, 6), dtype=np.float32)),
        y=torch.as_tensor(rng.integers(0, 5, (1, 512))),
    )
    offsets = jax_offsets(jax.random.PRNGKey(0), 512)
    sd = PointConvResNet(5, 6, layers=(8, 16, 32, 64, 128),
                         device="cpu").state_dict()

    def run(seed, rate=0.5):
        m = PointConvResNet(5, 6, layers=(8, 16, 32, 64, 128),
                            dropout_rate=rate, device="cpu")
        m.load_state_dict(sd)
        st = TrainState.create(m, lr=0.01)
        out = make_train_step(MODE)(st, raw, torch.Generator().manual_seed(seed),
                                    offsets=offsets)
        return float(out["loss"])

    assert run(0) == run(0)
    assert run(0) != run(1)
    assert run(0, rate=0.0) == run(1, rate=0.0)
    m = PointConvResNet(5, 6, layers=(8, 16, 32, 64, 128), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        make_train_step(MODE)(TrainState.create(m, lr=0.01), raw,
                              offsets=jax_offsets(jax.random.PRNGKey(0), 512))

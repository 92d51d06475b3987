"""One train step and one eval step of the full-width CRFSegNet(steps=10)
at B1 x 1024 with ScanNet's settings (label_offset 1, ignore_index -1, no
class weights), the port against ``crfconv_tpu.train.train_state`` on the
CPU: the same weights (``from_flax``) and the same pyramid (offsets drawn
from the JAX key). The port's CRF runs the fused core (the plain versions
of K9-K12), the JAX step its scan."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.models import CRFSegNet as JCRFSegNet
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import CRFSegNet, from_flax
from crfconv_tpu_torch.data.batch import RawBatch
from crfconv_tpu_torch.ops import crf
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train.config import CONFIGS, ScanNetConfig
from crfconv_tpu_torch.train.train_state import (
    TrainState, build_windowed_batch, make_eval_step, make_train_step,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_train_step import _exact_windowed_gather, _f64

CFG = ScanNetConfig()
B, N = 1, 1024
MODE = NeighborMode("windowed", knn_exact=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _state_dict(params, stats):
    return from_flax(jax.device_get(params), jax.device_get(stats))


def _opt_kw():
    return dict(momentum=CFG.momentum, weight_decay=CFG.weight_decay,
                gamma=CFG.gamma)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX train step (label_offset 1) on CRFSegNet(20, steps=10), and
    the data and key it ran on. Labels 0 (unlabeled) become -1 and are
    ignored."""
    rng = np.random.default_rng(3)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, CFG.num_classes + 1, (B, N)).astype(np.int32)
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y))
    model = JCRFSegNet(n_classes=CFG.num_classes, steps=CFG.steps)
    key = jax.random.PRNGKey(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
            example = jts.build_windowed_batch(raw, jax.random.PRNGKey(0))
            tx = jts.make_optimizer(lr=CFG.lr, momentum=CFG.momentum,
                                    weight_decay=CFG.weight_decay,
                                    gamma=CFG.gamma)
            state = jts.create_train_state(model, example, tx, seed=0)
            step = jax.jit(jts.make_train_step(
                model, ignore_index=CFG.ignore_index,
                label_offset=CFG.label_offset, windowed=True))
            new_state, metrics = step(state, raw, key)
            pk = jax.random.split(key)[1]     # the step's pyramid key
            batch_j = jts.build_windowed_batch(raw, pk)
            ekey = jax.random.PRNGKey(7)
            ev = jax.jit(jts.make_eval_step(
                model, ignore_index=CFG.ignore_index,
                label_offset=CFG.label_offset, windowed=True))(
                    new_state, raw, ekey)
    finally:
        mp.undo()
    return {
        "raw": (pos, feats, y), "pk": pk, "batch": batch_j, "ekey": ekey,
        "before": _state_dict(state.params, state.batch_stats),
        "after": _state_dict(new_state.params, new_state.batch_stats),
        "loss": float(metrics["loss"]),
        "confusion": np.asarray(metrics["confusion"]),
        "eval": jax.device_get(ev), "model": model, "state": state,
    }


def _raw(data):
    pos, feats, y = data
    return RawBatch(pos=_t(pos), x=_t(feats), y=_t(y))


def _port_state(sd):
    model = CRFSegNet(CFG.num_classes, CFG.in_channels, steps=CFG.steps,
                      device="cpu")
    model.load_state_dict(sd)
    return TrainState.create(model, lr=CFG.lr, **_opt_kw())


def test_config_copy_matches_jax():
    from crfconv_tpu.train import config as jconfig

    assert set(CONFIGS) == set(jconfig.CONFIGS)
    for name, cls in CONFIGS.items():
        ref = jconfig.CONFIGS[name]()
        got = cls()
        for f in ref.__dataclass_fields__:
            assert getattr(got, f) == getattr(ref, f), (name, f)
        np.testing.assert_array_equal(
            np.asarray(got.class_weights if got.class_weights is not None
                       else []),
            np.asarray(ref.class_weights if ref.class_weights is not None
                       else []))
    assert (CFG.model_name, CFG.steps, CFG.label_offset, CFG.batch_size) == (
        "CRFSegNet", 10, 1, 16)


def test_train_step_matches_jax(jax_step, monkeypatch):
    cores = []
    core = crf.crf_core
    monkeypatch.setattr(crf, "crf_core", lambda *a: cores.append(1) or core(*a))
    state = _port_state(jax_step["before"])
    metrics = make_train_step(
        MODE, ignore_index=CFG.ignore_index, label_offset=CFG.label_offset,
    )(state, _raw(jax_step["raw"]), offsets=jax_offsets(jax_step["pk"], N))
    assert len(cores) == 4     # one fused core per decoder
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["loss"],
                               rtol=1e-5)
    np.testing.assert_array_equal(metrics["confusion"].numpy(),
                                  jax_step["confusion"])
    # the label shift: label 0 became -1 and is not counted
    y = jax_step["raw"][2]
    assert int(metrics["confusion"].sum()) == int((y > 0).sum())
    got = state.model.state_dict()
    ref = jax_step["after"]
    assert set(got) == set(ref)
    params = {n for n, _ in state.model.named_parameters()}
    for name in sorted(ref):
        tol = (dict(rtol=1e-3, atol=5e-5) if name in params
               else dict(rtol=1e-3, atol=1e-5))   # running statistics
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   err_msg=name, **tol)


def test_train_step_update_matches_jax_f64(jax_step):
    """The step's update, lr * (grad + wd * p), against the JAX step's, both
    in float64 on the same weights and pyramid: this holds the gradient,
    the CRF core's backward (the plain K11/K12) included."""
    state = jax_step["state"]
    gen = np.random.default_rng(5)
    params32 = jax.tree_util.tree_map_with_path(   # nonzero biases
        lambda path, a: a + np.float32(0.1) * gen.standard_normal(
            a.shape, dtype=np.float32)
        if path[-1].key in ("bias", "c") else a,
        jax.device_get(state.params),
    )
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        params = _f64(params32)
        state = state.replace(params=params,
                              batch_stats=_f64(state.batch_stats),
                              opt_state=state.tx.init(params))
        with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
            step = jax.jit(jts.make_train_step(
                jax_step["model"], ignore_index=CFG.ignore_index,
                label_offset=CFG.label_offset))
            new_state, metrics = step(state, _f64(jax_step["batch"]),
                                      jax.random.PRNGKey(1))
        ref_upd = from_flax(
            jax.tree_util.tree_map(lambda a, b: np.asarray(a - b),
                                   new_state.params, params),
            jax.device_get(new_state.batch_stats),
        )
        ref_loss = float(metrics["loss"])
    finally:
        mp.undo()
        jax.config.update("jax_enable_x64", old)

    model = CRFSegNet(CFG.num_classes, CFG.in_channels, steps=CFG.steps,
                      device="cpu")
    model.load_state_dict(_state_dict(params32, state.batch_stats))
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
    metrics = make_train_step(
        MODE, ignore_index=CFG.ignore_index, label_offset=CFG.label_offset,
        windowed=False,
    )(TrainState.create(model, lr=CFG.lr, **_opt_kw()), batch)
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-10)
    upd = {n: (p.detach() - before[n], ref_upd[n].double())
           for n, p in model.named_parameters()}
    u_max = max(float(r.abs().max()) for _, r in upd.values())
    assert u_max > 0
    # within 1e-6 of the tensor's largest update, plus 1e-9 of the model's
    # largest; the JAX update carries float32 rounding (from_flax)
    for name, (u, r) in sorted(upd.items()):
        bound = 1e-6 * float(r.abs().max()) + 1e-9 * u_max
        gap = float((u - r).abs().max()) / bound
        assert gap <= 1.0, f"{name}: update off by {gap:.3g} of its bound"


def test_eval_step_matches_jax(jax_step):
    """Eval of the stepped JAX state in both packages (label_offset 1)."""
    ref = jax_step["eval"]
    state = _port_state(jax_step["after"])
    got = make_eval_step(MODE, ignore_index=CFG.ignore_index,
                         label_offset=CFG.label_offset)(
        state, _raw(jax_step["raw"]), offsets=jax_offsets(jax_step["ekey"], N))
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(ref["probs"]),
                               rtol=1e-3, atol=1e-4)
    assert (got["preds"].numpy() == np.asarray(ref["preds"])).mean() >= 0.999
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(ref["confusion"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))

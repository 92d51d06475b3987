"""One train step and one eval step of the full-width
BaselineDiscreteCRFSegNet(steps=10) at B1 x 1024 with ScanNet's settings
(label_offset 1, ignore_index -1, no class weights), the port against
``crfconv_tpu.train.train_state`` on the CPU: the same weights
(``from_flax``), the same pyramid (offsets drawn from the JAX key) and the
same kNN(32) of the discrete CRF. The JAX step runs once, in float64; the
port steps in float32 and in float64. The loss sums the two heads' cross
entropy; train metrics read the first head (log p), eval the last (log q).
The port's discrete CRF runs the fused core (the plain versions of K9, K12,
K13 and K14), the JAX step its scan."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.models import BaselineDiscreteCRFSegNet as JBaseDisc
from crfconv_tpu.models import segnets as jsegnets
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import losses as jlosses
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import BaselineDiscreteCRFSegNet, from_flax
from crfconv_tpu_torch.models import segnets
from crfconv_tpu_torch.ops import crf
from crfconv_tpu_torch.train.losses import segmentation_loss
from crfconv_tpu_torch.train.train_state import (
    TrainState, build_windowed_batch, make_eval_step, make_train_step,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_small_train import (
    CFG, MODE, _opt_kw, _raw, _state_dict, _t,
)
from tests.test_torch_train_step import _exact_windowed_gather, _f64

B, N = 1, 1024


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step (label_offset 1) of BaselineDiscreteCRFSegNet(20,
    steps=10) in float64, from float32 weights with nonzero biases and
    compatibilities off the identity, and the eval step of the stepped
    state; the data, the pyramids' keys and the discrete CRF's kNN(32) on
    each pyramid (both packages take it). Both train-step tests read this
    one step: the float32 port step against it at float32 bounds, the
    float64 port step's update at float64 bounds."""
    rng = np.random.default_rng(4)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, CFG.num_classes + 1, (B, N)).astype(np.int32)
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y))
    model = JBaseDisc(n_classes=CFG.num_classes, steps=CFG.steps)
    key = jax.random.PRNGKey(1)
    pk = jax.random.split(key)[1]     # the step's pyramid key
    ekey = jax.random.PRNGKey(7)
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    old = jax.config.jax_enable_x64
    try:
        with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
            build = jax.jit(jts.build_windowed_batch)
            batch, ebatch = build(raw, pk), build(raw, ekey)
            idx = np.asarray(jwin.window_knn(batch.scales[0].pos, 32))
            eidx = np.asarray(jwin.window_knn(ebatch.scales[0].pos, 32))
            tx = jts.make_optimizer(lr=CFG.lr, **_opt_kw())
            state = jts.create_train_state(model, batch, tx, seed=0)
        gen = np.random.default_rng(5)
        params32 = jax.tree_util.tree_map_with_path(   # nonzero biases
            lambda path, a: a + np.float32(0.1) * gen.standard_normal(
                a.shape, dtype=np.float32)
            if path[-1].key == "bias" else a,
            jax.device_get(state.params),
        )
        params32 = dict(params32)
        params32["crf"] = dict(params32["crf"])
        params32["crf"]["C"] = params32["crf"]["C"] + 0.1 * rng.standard_normal(
            (20, 20)).astype(np.float32)
        stats32 = jax.device_get(state.batch_stats)
        jax.config.update("jax_enable_x64", True)
        with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
            params = _f64(params32)
            state = state.replace(params=params, batch_stats=_f64(stats32),
                                  opt_state=state.tx.init(params))
            mp.setattr(jsegnets, "_discrete_crf_idx",
                       lambda p_: jnp.asarray(idx))
            new_state, metrics = jax.jit(jts.make_train_step(
                model, ignore_index=CFG.ignore_index,
                label_offset=CFG.label_offset))(
                    state, _f64(batch), jax.random.PRNGKey(1))
            mp.setattr(jsegnets, "_discrete_crf_idx",
                       lambda p_: jnp.asarray(eidx))
            ev = jax.jit(jts.make_eval_step(
                model, ignore_index=CFG.ignore_index,
                label_offset=CFG.label_offset))(new_state, _f64(ebatch))
            update = from_flax(
                jax.tree_util.tree_map(lambda a, b: np.asarray(a - b),
                                       new_state.params, params),
                jax.device_get(new_state.batch_stats),
            )
            out = {
                "raw": (pos, feats, y), "pk": pk, "ekey": ekey,
                "idx": idx, "eidx": eidx,
                "before": _state_dict(params32, stats32),
                "after": _state_dict(new_state.params,
                                     new_state.batch_stats),
                "update": update,
                "loss": float(metrics["loss"]),
                "confusion": np.asarray(metrics["confusion"]),
                "eval": jax.device_get(ev),
            }
    finally:
        mp.undo()
        jax.config.update("jax_enable_x64", old)
    return out


def _port_state(sd):
    model = BaselineDiscreteCRFSegNet(CFG.num_classes, CFG.in_channels,
                                      steps=CFG.steps, device="cpu")
    model.load_state_dict(sd)
    return TrainState.create(model, lr=CFG.lr, **_opt_kw())


def _same_idx(monkeypatch, idx):
    """The port's discrete CRF takes the JAX step's kNN(32) (its own agrees
    with it but for last-bit distance ties, test_torch_discrete.py)."""
    own = segnets._discrete_crf_idx

    def take(pos, mode):
        mine = own(pos, mode)
        assert (mine.numpy() == idx).mean() >= 0.999
        return _t(idx)

    monkeypatch.setattr(segnets, "_discrete_crf_idx", take)


def test_two_head_loss_matches_jax():
    """The sum of the heads' weighted cross entropy, as the JAX package's
    segmentation_loss takes it for (log p, log q)."""
    rng = np.random.default_rng(2)
    heads = [np.log(rng.dirichlet(np.ones(20), (2, 64))).astype(np.float32)
             for _ in range(2)]
    labels = rng.integers(-1, 20, (2, 64)).astype(np.int32)
    cw = rng.random(20).astype(np.float32) + 0.5
    for weights in (None, cw):
        ref = jlosses.segmentation_loss(
            tuple(map(jnp.asarray, heads)), jnp.asarray(labels),
            None if weights is None else jnp.asarray(weights))
        got = segmentation_loss(
            tuple(map(_t, heads)), _t(labels).long(),
            None if weights is None else _t(weights))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        single = sum(float(segmentation_loss(
            _t(h), _t(labels).long(),
            None if weights is None else _t(weights))) for h in heads)
        np.testing.assert_allclose(float(got), single, rtol=1e-6)


def test_train_step_matches_jax(jax_step, monkeypatch):
    """The float32 port step against the JAX step (float64): the loss, the
    first head's confusion, the stepped weights and running statistics."""
    cores = []
    core = crf.discrete_core
    monkeypatch.setattr(crf, "discrete_core",
                        lambda *a: cores.append(1) or core(*a))
    _same_idx(monkeypatch, jax_step["idx"])
    state = _port_state(jax_step["before"])
    metrics = make_train_step(
        MODE, ignore_index=CFG.ignore_index, label_offset=CFG.label_offset,
    )(state, _raw(jax_step["raw"]), offsets=jax_offsets(jax_step["pk"], N))
    assert len(cores) == 1
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["loss"],
                               rtol=1e-5)
    # the train metrics read the first head (log p)
    np.testing.assert_array_equal(metrics["confusion"].numpy(),
                                  jax_step["confusion"])
    got = state.model.state_dict()
    ref = jax_step["after"]
    assert set(got) == set(ref)
    params = {n for n, _ in state.model.named_parameters()}
    for name in sorted(ref):
        tol = (dict(rtol=1e-3, atol=5e-5) if name in params
               else dict(rtol=1e-3, atol=1e-5))   # running statistics
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   err_msg=name, **tol)


def test_train_step_update_matches_jax_f64(jax_step, monkeypatch):
    """The step's update, lr * (grad + wd * p), against the JAX step's, both
    in float64 on the same weights, pyramid and kNN(32): this holds the
    gradient through both heads, the discrete core's backward (the plain
    K14/K12) included."""
    monkeypatch.setattr(segnets, "_discrete_crf_idx",
                        lambda pos, mode: _t(jax_step["idx"]))
    model = BaselineDiscreteCRFSegNet(CFG.num_classes, CFG.in_channels,
                                      steps=CFG.steps, device="cpu")
    model.load_state_dict(jax_step["before"])
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
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["loss"],
                               rtol=1e-10)
    upd = {n: (p.detach() - before[n], jax_step["update"][n].double())
           for n, p in model.named_parameters()}
    u_max = max(float(r.abs().max()) for _, r in upd.values())
    assert u_max > 0
    assert all(float(u.abs().max()) > 0 for n, (u, _) in upd.items()
               if n.startswith("crf."))
    # within 1e-6 of the tensor's largest update, plus 1e-9 of the model's
    # largest
    for name, (u, r) in sorted(upd.items()):
        bound = 1e-6 * float(r.abs().max()) + 1e-9 * u_max
        gap = float((u - r).abs().max()) / bound
        assert gap <= 1.0, f"{name}: update off by {gap:.3g} of its bound"


def test_eval_step_matches_jax(jax_step, monkeypatch):
    """Eval of the stepped JAX state in both packages (label_offset 1): the
    probabilities and predictions are the last head's (q)."""
    ref = jax_step["eval"]
    _same_idx(monkeypatch, jax_step["eidx"])
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

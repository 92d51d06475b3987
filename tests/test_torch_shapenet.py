"""ShapeNet part segmentation in crfconv_tpu_torch against the JAX package
on the CPU: the full-width CRFSegNet_Part at B2 x 1024 with the same
weights (``from_flax``) and the same pyramid, at steps 2 and 10, in the
windowed and the exact regime; one windowed train step; the category
one-hot (an id outside [0, 16) gives a zero row, as ``jax.nn.one_hot``
does); the model registry; ShapeNet's part-IoU metric and the vote test's
IoU. The port's CRF runs its fused core (the plain versions of K9-K12) in
the windowed regime and its scan in the exact one."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu import models as jmodels
from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.models import CRFSegNet_Part as JPart
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import metrics as jmetrics
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import CRFSegNet_Part, from_flax, get_model
from crfconv_tpu_torch import models as tmodels
from crfconv_tpu_torch.data.batch import PointBatch, RawBatch
from crfconv_tpu_torch.models.segnets import category_one_hot
from crfconv_tpu_torch.ops import crf
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train import metrics
from crfconv_tpu_torch.train.config import ShapeNetConfig
from crfconv_tpu_torch.train.train_state import TrainState, make_train_step
from tests.test_torch_exact import _jax_pyramid
from tests.test_torch_model import (
    RNGS, _apply, _init, _load, _perturb_stats, _pyramid, _scales, _t,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_train_step import _exact_windowed_gather

CFG = ShapeNetConfig()
B, N = 2, 1024
# the second cloud's category is outside [0, 16): a zero one-hot row
CATEGORY = np.array([5, 16], np.int32)
WINDOWED = NeighborMode("windowed", knn_exact=True)
EXACT = NeighborMode("exact")


@pytest.fixture(scope="module")
def part_nets():
    """CRFSegNet_Part's variables (non-trivial batch statistics, c off the
    identity), and its JAX log-probabilities at steps 2 and 10 on one
    windowed and one exact pyramid."""
    rng = np.random.default_rng(4)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    order, wscales = _pyramid(pos, jax.random.PRNGKey(1))
    wx = jnp.take_along_axis(jnp.asarray(feats), order[..., None], axis=1)
    escales = _jax_pyramid(pos, jax.random.PRNGKey(2))
    batches = {
        "windowed": JBatch(x=wx, y=None, scales=wscales,
                           category=jnp.asarray(CATEGORY)),
        "exact": JBatch(x=jnp.asarray(feats), y=None, scales=escales,
                        category=jnp.asarray(CATEGORY)),
    }
    out = {"batches": batches, "ref": {}}
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        with jax.default_matmul_precision("highest"):
            with neighbor_mode("windowed"):
                variables = _init(JPart(n_classes=50, steps=2), RNGS,
                                  batches["windowed"])
            params = jax.tree_util.tree_map_with_path(
                lambda path, a: a + 0.1 * jnp.asarray(
                    rng.standard_normal(a.shape).astype(np.float32))
                if path[-1].key == "c" else a, variables["params"])
            variables = {"params": params, "batch_stats": _perturb_stats(
                variables["batch_stats"])}
            for regime in ("windowed", "exact"):
                for steps in (2, 10):
                    with neighbor_mode(regime):
                        out["ref"][regime, steps] = np.asarray(_apply(
                            JPart(n_classes=50, steps=steps), variables,
                            batches[regime]))
    finally:
        mp.undo()
    out["variables"] = variables
    return out


def _port_batch(jbatch):
    return PointBatch(x=_t(jbatch.x), y=None, scales=_scales(jbatch.scales),
                      category=_t(jbatch.category))


@pytest.mark.parametrize("regime", ["windowed", "exact"])
@pytest.mark.parametrize("steps", [2, 10])
def test_part_segnet_log_probs_match(part_nets, regime, steps, monkeypatch):
    cores = []
    core = crf.crf_core
    monkeypatch.setattr(crf, "crf_core", lambda *a: cores.append(1) or core(*a))
    model = _load(CRFSegNet_Part(50, 6, steps=steps, device="cpu"),
                  part_nets["variables"])
    with torch.no_grad():
        got = model(_port_batch(part_nets["batches"][regime]),
                    WINDOWED if regime == "windowed" else EXACT).numpy()
    ref = part_nets["ref"][regime, steps]
    assert got.shape == ref.shape == (B, N, 50)
    # the fused core in the windowed regime, one per decoder; the scan in
    # the exact one
    assert len(cores) == (4 if regime == "windowed" else 0)
    # the coarsest scale (4 points) clamps k
    assert part_nets["batches"][regime].scales[-1].neighbor_idx.shape[1:] \
        == (4, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_category_one_hot_matches_jax():
    """Ids outside [0, 16), 16 and -1 included, give zero rows, as in
    ``jax.nn.one_hot``; ``torch.nn.functional.one_hot`` would raise."""
    ids = np.array([0, 3, 15, 16, -1, 40], np.int32)
    ref = np.asarray(jax.nn.one_hot(jnp.asarray(ids), 16))
    got = category_one_hot(torch.from_numpy(ids), 16, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[3:].any()


def test_part_segnet_needs_a_category(part_nets):
    model = CRFSegNet_Part(50, 6, steps=2, device="cpu")
    batch = _port_batch(part_nets["batches"]["windowed"])._replace(
        category=None)
    with pytest.raises(ValueError, match="category"):
        model(batch, WINDOWED)


def test_from_flax_covers_every_tensor(part_nets):
    variables = part_nets["variables"]
    sd = from_flax(jax.device_get(variables["params"]),
                   jax.device_get(variables["batch_stats"]))
    model = CRFSegNet_Part(50, 6, steps=10, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert tuple(sd["classifier.fc1.weight"].shape) == (256, 80)
    np.testing.assert_array_equal(
        sd["classifier.fc1.weight"].numpy(),
        np.asarray(variables["params"]["classifier"]["fc1"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["feature.deconv4.c"].numpy(),
        np.asarray(variables["params"]["feature"]["deconv4"]["c"]))


def test_fresh_part_segnet_init():
    """Classifier biases at zero, weights within 1/sqrt(80)."""
    model = CRFSegNet_Part(device="cpu")
    assert not model.classifier.fc1.bias.any()
    assert not model.classifier.fc2.bias.any()
    assert model.classifier.fc1.weight.abs().max() <= 1 / np.sqrt(80)
    assert model.classifier.fc2.out_features == 50


@pytest.fixture(scope="module")
def part_step():
    """One JAX windowed train step of CRFSegNet_Part(50, steps=10) with
    ShapeNet's optimizer (label_offset 0), and the data and key it ran
    on."""
    rng = np.random.default_rng(6)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, CFG.num_classes, (B, N)).astype(np.int32)
    category = np.array([4, 12], np.int32)
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y),
               category=jnp.asarray(category))
    model = JPart(n_classes=CFG.num_classes, steps=CFG.steps)
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
            new_state, m = step(state, raw, key)
    finally:
        mp.undo()
    sd = lambda st: from_flax(jax.device_get(st.params),   # noqa: E731
                              jax.device_get(st.batch_stats))
    return {"raw": (pos, feats, y, category), "key": key,
            "before": sd(state), "after": sd(new_state),
            "loss": float(m["loss"]), "confusion": np.asarray(m["confusion"])}


def test_part_train_step_matches_jax(part_step):
    model = CRFSegNet_Part(CFG.num_classes, CFG.in_channels, steps=CFG.steps,
                           device="cpu")
    model.load_state_dict(part_step["before"])
    state = TrainState.create(model, lr=CFG.lr, momentum=CFG.momentum,
                              weight_decay=CFG.weight_decay, gamma=CFG.gamma)
    pos, feats, y, category = map(_t, part_step["raw"])
    pk = jax.random.split(part_step["key"])[1]    # the step's pyramid key
    m = make_train_step(WINDOWED, ignore_index=CFG.ignore_index,
                        label_offset=CFG.label_offset)(
        state, RawBatch(pos=pos, x=feats, y=y, category=category),
        offsets=jax_offsets(pk, N))
    np.testing.assert_allclose(float(m["loss"]), part_step["loss"], rtol=1e-5)
    np.testing.assert_array_equal(m["confusion"].numpy(),
                                  part_step["confusion"])
    got, ref = state.model.state_dict(), part_step["after"]
    assert set(got) == set(ref)
    params = {n for n, _ in state.model.named_parameters()}
    for name in sorted(ref):
        tol = (dict(rtol=1e-3, atol=5e-5) if name in params
               else dict(rtol=1e-3, atol=1e-5))   # running statistics
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   err_msg=name, **tol)


def test_registry_matches_jax():
    assert set(tmodels._REGISTRY) == set(jmodels._REGISTRY)
    assert tmodels.PointConvBig is tmodels.PointConvResNet
    for name in sorted(tmodels._REGISTRY):
        kw = {"n_classes": 4, "device": "cpu"}
        if name not in ("PointConvBig", "PointConvResNet", "BaselineSegNet"):
            kw["steps"] = 2
        model = get_model(name, **kw)
        assert type(model) is tmodels._REGISTRY[name]
        assert type(model).__name__ == jmodels._REGISTRY[name].__name__
    with pytest.raises(KeyError, match="Available"):
        get_model("NoSuchNet")


def test_running_score_shapenet_matches_jax():
    assert metrics.SHAPENET_OBJ_CLASSES == jmetrics.SHAPENET_OBJ_CLASSES
    assert metrics.SHAPENET_SEG_CLASSES == jmetrics.SHAPENET_SEG_CLASSES
    rng = np.random.default_rng(7)
    got, ref = metrics.RunningScoreShapeNet(), jmetrics.RunningScoreShapeNet()
    for i in range(40):
        cat = int(rng.integers(0, 14))    # categories 14 and 15 unseen
        parts = jmetrics.SHAPENET_SEG_CLASSES[
            [k for k, v in jmetrics.SHAPENET_OBJ_CLASSES.items()
             if v == cat][0]]
        lt = rng.choice(parts, 300)
        lp = np.where(rng.random(300) < 0.7, lt, rng.integers(0, 50, 300))
        mask = rng.random(300) < 0.9 if i % 3 else None
        a = got.update(lt, lp, cat, mask)
        r = ref.update(lt, lp, cat, mask)
        assert abs(a - r) <= 1e-12
    (p, mp, per), (rp, rmp, rper) = got.get_scores(), ref.get_scores()
    assert abs(p - rp) <= 1e-12 and abs(mp - rmp) <= 1e-12
    assert per.keys() == rper.keys()
    for k in per:
        assert abs(per[k] - rper[k]) <= 1e-12
    got.reset()
    assert not got.category_num.any() and not got.category_iou.any()


def test_iou_from_confusions_matches_jax():
    rng = np.random.default_rng(8)
    conf = rng.integers(0, 50, (3, 13, 13)).astype(np.float64)
    conf[0, 4] = 0          # classes with no true points take the mean
    conf[1, [2, 7]] = 0
    got = metrics.iou_from_confusions(conf)
    ref = jmetrics.iou_from_confusions(conf)
    assert got.shape == (3, 13)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(metrics.iou_from_confusions(conf[2]), ref[2],
                               rtol=0, atol=1e-12)

"""Data-parallel training of the port on the CPU: two gloo ranks, spawned
once through ``crfconv_tpu_torch.parallel.launch``
(``tests/test_torch_parallel_ranks.py`` says what each rank runs), against
the one-process port step on the whole batch and against the JAX
package's data-parallel step on a 2-device mesh of the conftest's virtual
CPU devices.

The scenarios of that one launch, each rank on half of a global
B2 x 1024 batch:

  * the narrow windowed flagship with dropout 0.5, class weights and
    ignored labels, two steps (the dropout mask drawn at the global shape);
  * one windowed flagship step from the JAX package's initial weights
    (biases moved off zero, dropout off) on the JAX step's pyramid, against
    the JAX mesh step;
  * the flagship's exact-regime step on the JAX step's host pyramid, and a
    discrete-net step, against the JAX mesh step;
  * a masked batch norm whose statistics are all-reduced, against the JAX
    one on the whole batch;
  * a two-rank Trainer (2 epochs of 2 steps, a checkpoint, a resume, a
    vote test) on two synthetic S3DIS rooms.

Train steps are held at the tolerances of tests/test_torch_train_step.py:
the loss at rtol 1e-5, parameters at rtol 1e-3 / atol 5e-5, running
statistics at rtol 1e-3 / atol 1e-5; the two ranks' states bit-equal.
``python -m crfconv_tpu_torch.train --n-devices 2`` spawning its own ranks
is tests/test_torch_parallel_cli.py's.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.models import BaselineDiscreteCRFSegNet as JBaseDisc
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.models import segnets as jsegnets
from crfconv_tpu.models.common import MaskedBatchNorm as JBN
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.parallel import make_mesh as jax_mesh
from crfconv_tpu.parallel import make_parallel_train_step as jax_pstep
from crfconv_tpu.parallel import replicate as jax_replicate
from crfconv_tpu.parallel import shard_batch as jax_shard
from crfconv_tpu.train import losses as jlosses
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import from_flax
from crfconv_tpu_torch.data import datasets
from crfconv_tpu_torch.data.batch import PointBatch, ScaleData
from crfconv_tpu_torch.parallel import Mesh, launch, shard_batch
from crfconv_tpu_torch.train import __main__ as cli
from crfconv_tpu_torch.train import losses
from crfconv_tpu_torch.train.config import S3DISConfig
from crfconv_tpu_torch.train.trainer import Trainer
from tests import test_torch_parallel_ranks as ranks
from tests.test_data import _make_s3dis_raw
from tests.test_torch_exact import _jax_pyramid
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_train_step import _exact_windowed_gather

NARROW = (16, 32, 64, 128, 256)
B, N = 2, 1024
FLAGSHIP_KW = dict(n_classes=13, in_channels=6, use_crf=True, steps=1,
                   layers=NARROW)
WINDOWED = dict(mode="windowed", knn_exact=True)
DISCRETE_STEPS = 2
DISCRETE_KW = dict(n_classes=20, in_channels=6, steps=DISCRETE_STEPS)
TRAINER_CFG = dict(mode="train", use_crf=False, grid_size=0.2,
                   sample_num=256, batch_size=1, epochs=2,
                   train_samples_per_epoch=4, val_samples_per_epoch=2,
                   layers=(8, 16, 32, 64, 128))
PARAM_TOL = dict(rtol=1e-3, atol=5e-5)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)


def _biased(params, seed):
    """Biases moved off zero: at zero biases a batch norm can put the
    all-pairs coarse scales' self rows on the leaky ReLU's kink
    (tests/test_torch_train_step.py)."""
    gen = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + np.float32(0.1) * gen.standard_normal(
            a.shape, dtype=np.float32)
        if path[-1].key == "bias" else a,
        jax.device_get(params))


def _state_np(params, stats):
    return {k: v.numpy() for k, v in from_flax(
        jax.device_get(params), jax.device_get(stats)).items()}


def _jax_mesh_step(model, state, batch, key, **step_kw):
    """The JAX train step jitted over a 2-device mesh, the state replicated
    and the batch sharded on its leading axis."""
    mesh = jax_mesh(2)
    step = jax_pstep(jts.make_train_step(model, **step_kw), mesh)
    # the step donates its state: replicate a copy
    state = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), state)
    new_state, metrics = step(jax_replicate(state, mesh),
                              jax_shard(batch, mesh), key)
    return {"loss": float(metrics["loss"]),
            "confusion": np.asarray(metrics["confusion"]),
            "state": _state_np(new_state.params, new_state.batch_stats)}


def global_batch():
    """The global B2 x 1024 batch: positions, features, 13-class labels
    with ignored ones, class weights."""
    rng = np.random.default_rng(3)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, 13, (B, N)).astype(np.int32)
    y[0, :7] = -1                               # ignored labels
    cw = (0.5 + rng.random(13)).astype(np.float32)
    return pos, feats, y, cw


def jax_flagship(raw):
    """The narrow JAX flagship (dropout off) and its initial train state
    with biases moved off zero; the state as the port's state dict."""
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        model = JResNet(n_classes=13, use_crf=True, steps=1, layers=NARROW,
                        dropout_rate=0.0)
        example = jax.jit(jts.build_windowed_batch)(raw,
                                                   jax.random.PRNGKey(0))
        state = jts.create_train_state(model, example,
                                       jts.make_optimizer(lr=0.01), seed=0)
        params = _biased(state.params, 5)
        state = state.replace(params=params, opt_state=state.tx.init(params))
    return model, state, _state_np(params, state.batch_stats)


def step_spec(model, model_kw, state, batch, mode, **kw) -> dict:
    return {"kind": "step", "model": model, "model_kw": model_kw,
            "state": state, "batch": batch, "mode": mode, "windowed": True,
            "steps": 1, **kw}


def _specs(trainer_cfg):
    """Every scenario of the two ranks (the flagship with dropout, the
    windowed, exact and discrete steps against JAX's, the batch norm,
    ``make_global_batch``, the Trainer on ``trainer_cfg``) and the JAX
    steps to hold them to."""
    pos, feats, y, cw = global_batch()
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y))
    model, state, start = jax_flagship(raw)
    key = jax.random.PRNGKey(1)
    pk = jax.random.split(key)[1]               # the JAX step's pyramid key
    raw_np = {"pos": pos, "x": feats, "y": y}
    scales = _jax_pyramid(pos, jax.random.PRNGKey(2))
    specs = {
        "dropout": step_spec(
            "PointConvResNet", {**FLAGSHIP_KW, "dropout_rate": 0.5}, start,
            raw_np, WINDOWED, steps=2, seed=7, class_weights=cw),
        "windowed": step_spec(
            "PointConvResNet", {**FLAGSHIP_KW, "dropout_rate": 0.0}, start,
            raw_np, WINDOWED, offsets=jax_offsets(pk, N), class_weights=cw),
        "exact": step_spec(
            "PointConvResNet", {**FLAGSHIP_KW, "dropout_rate": 0.0}, start,
            {"x": feats, "y": y, "scales": [
                [np.asarray(getattr(s, f)) for f in ScaleData._fields]
                for s in scales]},
            {"mode": "exact"}, windowed=False),
    }
    todo = [("windowed", "windowed", model, state, raw, key,
             dict(class_weights=jnp.asarray(cw), windowed=True)),
            ("exact", "exact", model, state,
             JBatch(x=jnp.asarray(feats), y=jnp.asarray(y), scales=scales),
             key, {})]

    rng = np.random.default_rng(6)
    yd = rng.integers(0, 21, (B, N)).astype(np.int32)   # label 0: ignored
    draw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats),
                y=jnp.asarray(yd))
    dmodel = JBaseDisc(n_classes=20, steps=DISCRETE_STEPS)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        built = jax.jit(jts.build_windowed_batch)(draw, pk)
        idx = np.asarray(jwin.window_knn(built.scales[0].pos, 32))
        dstate = jts.create_train_state(dmodel, built,
                                        jts.make_optimizer(lr=0.01), seed=0)
        dparams = dict(_biased(dstate.params, 6))
        dparams["crf"] = dict(dparams["crf"])
        dparams["crf"]["C"] = dparams["crf"]["C"] + 0.1 * rng.standard_normal(
            (20, 20)).astype(np.float32)
        dstate = dstate.replace(params=dparams,
                                opt_state=dstate.tx.init(dparams))
    specs["discrete"] = step_spec(
        "BaselineDiscreteCRFSegNet", DISCRETE_KW,
        _state_np(dparams, dstate.batch_stats),
        {"pos": pos, "x": feats, "y": yd}, WINDOWED, label_offset=1,
        offsets=jax_offsets(pk, N), crf_idx=idx)
    todo.append(("discrete", "windowed", dmodel, dstate, draw, key,
                 dict(label_offset=1, windowed=True, idx=idx)))

    rng = np.random.default_rng(4)
    x = (1.0 + rng.standard_normal((B, 200, 8))).astype(np.float32)
    specs["global_batch"] = {"kind": "global_batch"}
    specs["bn"] = {
        "kind": "bn", "x": x, "mask": rng.random((B, 200)) > 0.25,
        "probe": rng.standard_normal(x.shape).astype(np.float32),
        "scale": (1 + 0.2 * rng.standard_normal(8)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}
    specs["trainer"] = {"kind": "trainer", "cfg": trainer_cfg}
    return specs, todo


def jax_mesh_steps(todo) -> dict:
    """The JAX mesh step of each ``todo`` entry (name, regime, model,
    state, batch, key, step options; ``idx``: the discrete CRF's kNN(32)),
    the JAX windowed gather taken exactly."""
    refs = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        for name, regime, model, state, batch, key, kw in todo:
            kw = dict(kw)
            idx = kw.pop("idx", None)
            if idx is not None:
                mp.setattr(jsegnets, "_discrete_crf_idx",
                           lambda p_, i=idx: jnp.asarray(i))
            with neighbor_mode(regime), \
                    jax.default_matmul_precision("highest"):
                refs[name] = _jax_mesh_step(model, state, batch, key, **kw)
    finally:
        mp.undo()
    return refs


def _jax_bn(sp) -> dict:
    """The JAX masked batch norm on the whole batch: output, gradients of
    the probe's loss, running statistics."""
    f = sp["x"].shape[-1]

    def loss(params, xj):
        yv, upd = JBN().apply(
            {"params": params, "batch_stats": {
                "mean": np.zeros(f, np.float32),
                "var": np.ones(f, np.float32)}},
            xj, train=True, mask=jnp.asarray(sp["mask"]),
            mutable=["batch_stats"])
        return jnp.sum(yv * sp["probe"]), (yv, upd["batch_stats"])

    (_, (yv, upd)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {"scale": jnp.asarray(sp["scale"]),
             "bias": jnp.asarray(sp["bias"])}, jnp.asarray(sp["x"]))
    return {"y": np.asarray(yv), "dx": np.asarray(gx),
            "dscale": np.asarray(gp["scale"]), "dbias": np.asarray(gp["bias"]),
            "mean": np.asarray(upd["mean"]), "var": np.asarray(upd["var"])}


def run_dp(specs, todo, pg_dir) -> dict:
    """The two ranks' results of ``specs``, the one-process port's of its
    steps and the JAX mesh steps of ``todo``: the ranks run in the
    background while the rest runs here."""
    box = {}

    def run():
        try:
            box["ranks"] = launch(ranks.run_scenarios, 2, ["cpu", "cpu"],
                                  "gloo", args=(specs,),
                                  init_method=f"file://{pg_dir}/pg",
                                  timeout_s=600)
        except BaseException as e:      # raised below
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    try:
        jax_refs = jax_mesh_steps(todo)
        if "bn" in specs:
            jax_refs["bn"] = _jax_bn(specs["bn"])
        one = ranks.run_scenarios(
            None, {k: v for k, v in specs.items() if v["kind"] == "step"})
    finally:
        th.join(timeout=660)
    assert not th.is_alive(), "the ranks did not finish"
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "one": one, "jax": jax_refs}


@pytest.fixture(scope="module")
def s3dis_root(tmp_path_factory):
    """Two rooms an area of S3DIS's raw layout, processed once here (the
    ranks read the dataset's caches)."""
    root = str(tmp_path_factory.mktemp("s3dis"))
    _make_s3dis_raw(root, n_rooms=2, n_pts=600)
    datasets.S3DISRoomDataset(root, test_area=5, grid_size=0.2,
                              num_points=256)
    return root


@pytest.fixture(scope="module")
def trainer_cfg(s3dis_root, tmp_path_factory):
    return dict(TRAINER_CFG, root=s3dis_root,
                checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def dp(trainer_cfg, tmp_path_factory):
    specs, todo = _specs(trainer_cfg)
    return run_dp(specs, todo, tmp_path_factory.mktemp("pg"))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_states(got, ref, params, label):
    assert set(got) == set(ref)
    for name in sorted(ref):
        tol = PARAM_TOL if name in params else STAT_TOL
        np.testing.assert_allclose(_np(got[name]), _np(ref[name]),
                                   err_msg=f"{label}: {name}", **tol)


def _param_names(model_name, kw):
    return {n for n, _ in ranks.get_model(model_name, device="cpu",
                                          **kw).named_parameters()}


def _ranks_equal(dp, name):
    a, b = (r[name] for r in dp["ranks"])
    assert a["loss"] == b["loss"]
    for sa, sb in zip(a["states"], b["states"]):
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), k
    return a


def test_dropout_step_matches_one_process(dp):
    """Two steps with dropout 0.5: the ranks' global step against the
    one-process step on the whole batch (the same generator, the mask drawn
    at the global shape and sliced), the ranks bit-equal after each."""
    a = _ranks_equal(dp, "dropout")
    one = dp["one"]["dropout"]
    params = _param_names("PointConvResNet", FLAGSHIP_KW)
    np.testing.assert_allclose(a["loss"], one["loss"], rtol=1e-5)
    for i in range(2):
        np.testing.assert_array_equal(a["confusion"][i],
                                      _np(one["confusion"][i]))
        _assert_states(a["states"][i], one["states"][i], params,
                       f"step {i}")


def check_step(dp, name, model, kw):
    """One step of scenario ``name``: the two ranks bit-equal, and against
    the JAX 2-device mesh step and the one-process port step."""
    a = _ranks_equal(dp, name)
    params = _param_names(model, kw)
    one = dp["one"][name]
    for label, ref in (("jax mesh", dp["jax"][name]),
                       ("one process", {
                           "loss": one["loss"][0],
                           "confusion": _np(one["confusion"][0]),
                           "state": one["states"][0]})):
        np.testing.assert_allclose(a["loss"][0], ref["loss"], rtol=1e-5,
                                   err_msg=label)
        np.testing.assert_array_equal(a["confusion"][0], ref["confusion"],
                                      err_msg=label)
        _assert_states(a["states"][0], ref["state"], params, label)


def test_windowed_step_matches_jax_mesh_and_one_process(dp):
    """One windowed flagship step from the JAX initial state with class
    weights and ignored labels, on the JAX step's pyramid."""
    check_step(dp, "windowed", "PointConvResNet", FLAGSHIP_KW)


def test_all_reduced_masked_batch_norm_matches_jax(dp):
    """Each rank's rows of a masked batch norm whose statistics are
    all-reduced: its output and input gradient are those rows of the JAX
    batch norm on the whole batch, its parameter gradients summed over the
    ranks and its running statistics (equal on both ranks) are JAX's, at
    rtol 1e-5."""
    ref = dp["jax"]["bn"]
    tol = dict(rtol=1e-5, atol=1e-5)
    r0, r1 = (r["bn"] for r in dp["ranks"])
    np.testing.assert_allclose(np.concatenate([r0["y"], r1["y"]]), ref["y"],
                               **tol)
    np.testing.assert_allclose(np.concatenate([r0["dx"], r1["dx"]]),
                               ref["dx"], **tol)
    for g in ("dscale", "dbias"):
        np.testing.assert_allclose(r0[g] + r1[g], ref[g], **tol)
    for s in ("mean", "var"):
        assert np.array_equal(r0[s], r1[s])
        np.testing.assert_allclose(r0[s], ref[s], rtol=1e-5, atol=1e-6)


def test_make_global_batch_checks_the_ranks_shapes(dp):
    """Equal shards pass as they are; a rank whose shard differs makes
    every rank raise (no rank is left waiting in a collective)."""
    for r in dp["ranks"]:
        assert r["global_batch"] == {"same": True, "unequal_raised": True}


def test_exact_step_matches_jax_mesh_and_one_process(dp):
    """The flagship's exact-regime step on the JAX step's host-built
    pyramid (each rank its clouds' rows of it)."""
    check_step(dp, "exact", "PointConvResNet", FLAGSHIP_KW)


def test_discrete_step_matches_jax_mesh_and_one_process(dp):
    """BaselineDiscreteCRFSegNet (two heads sharing the loss's denominator,
    label offset 1) on the JAX step's pyramid and discrete kNN(32)."""
    check_step(dp, "discrete", "BaselineDiscreteCRFSegNet", DISCRETE_KW)


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_parts_match_jax(weighted):
    """The numerator and denominator of the weighted cross entropy with
    ignored and out-of-range labels, and the two-head parts, against the
    JAX package's; the parts of two halves sum to the whole batch's loss."""
    rng = np.random.default_rng(2)
    c = 13
    scores = [rng.standard_normal((2, 300, c)).astype(np.float32) * 3
              for _ in range(2)]
    labels = rng.integers(0, c, (2, 300)).astype(np.int64)
    labels[0, :20] = -1
    labels[1, :5] = c
    w = (0.5 + rng.random(c)).astype(np.float32) if weighted else None
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else torch.from_numpy(w)
    t = [torch.from_numpy(s) for s in scores]
    lt = torch.from_numpy(labels)
    for got, ref in (
        (losses.weighted_cross_entropy_parts(t[0], lt, wt),
         jlosses.weighted_cross_entropy_parts(jnp.asarray(scores[0]),
                                              jnp.asarray(labels), wj)),
        (losses.segmentation_loss_parts(tuple(t), lt, wt),
         jlosses.segmentation_loss_parts(
             tuple(map(jnp.asarray, scores)), jnp.asarray(labels), wj)),
    ):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
    halves = [losses.segmentation_loss_parts(
        (t[0][i:i + 1], t[1][i:i + 1]), lt[i:i + 1], wt) for i in range(2)]
    whole = losses.segmentation_loss(tuple(t), lt, wt)
    np.testing.assert_allclose(
        float(sum(n for n, _ in halves) / sum(d for _, d in halves)),
        float(whole), rtol=1e-6)


def test_shard_batch_takes_the_ranks_rows():
    """A PointBatch's rows [r * b, (r + 1) * b), the pyramid's included;
    an uneven split raises."""
    gen = torch.Generator().manual_seed(0)
    sc = ScaleData(torch.rand(4, 8, 3, generator=gen),
                   torch.randint(0, 8, (4, 8, 2), generator=gen), None,
                   torch.randint(0, 2, (4, 8, 1), generator=gen))
    batch = PointBatch(x=torch.rand(4, 8, 5, generator=gen),
                       y=torch.arange(32).reshape(4, 8), scales=(sc,),
                       cloud_idx=torch.arange(4))
    part = shard_batch(batch, Mesh(2, 1, torch.device("cpu"), "gloo"))
    assert torch.equal(part.x, batch.x[2:])
    assert torch.equal(part.cloud_idx, torch.tensor([2, 3]))
    assert part.scales[0].sub_idx is None
    assert torch.equal(part.scales[0].up_idx, sc.up_idx[2:])
    with pytest.raises(ValueError, match="split"):
        shard_batch(batch, Mesh(3, 0, torch.device("cpu"), "gloo"))


def test_two_rank_trainer_checkpoints_and_resumes(dp, trainer_cfg):
    """A Trainer on two ranks: 2 epochs of 2 steps (an epoch is half the
    one-process epoch's steps), every loss and the final state equal on
    both ranks, rank 0 the only checkpoint writer, a run resumed from the
    first epoch's checkpoint bit-identical to the uninterrupted one, and
    its labeled vote test alike on both ranks."""
    r0, r1 = (r["trainer"] for r in dp["ranks"])
    one = Trainer(S3DISConfig(**trainer_cfg), seed=0, device="cpu")
    assert r0["epoch_len"] == r1["epoch_len"] == len(one.train_loader) // 2
    assert r0["epoch_len"] == 2
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 4
    assert np.isfinite(r0["losses"]).all()
    assert r0["best"] == r1["best"]
    for k in r0["state"]:
        assert np.array_equal(r0["state"][k], r1["state"][k]), k
    assert r0["saves"] == [2, 4] and r1["saves"] == []
    assert r0["start"] == r1["start"] == 1
    for r in (r0, r1):
        assert r["resumed"] == r["losses"][2:]
        for k in r["state"]:
            assert np.array_equal(r["resumed_state"][k], r["state"][k]), k
    # the vote test: every rank's probabilities gathered, so both ranks
    # hold the same accumulators and scores
    assert r0["votes"] == r1["votes"]
    assert 0.0 <= r0["votes"]["full_mIoU"] <= 1.0
    for a, b in zip(r0["test_probs"], r1["test_probs"]):
        assert np.array_equal(a, b) and a.any()


def test_trainer_n_devices_needs_a_process_group(s3dis_root, tmp_path):
    with pytest.raises(RuntimeError, match="n_devices=2"):
        Trainer(S3DISConfig(root=s3dis_root, checkpoint_dir=str(tmp_path),
                            sample_num=256, grid_size=0.2), device="cpu",
                n_devices=2)


def test_cli_n_devices_needs_the_cards(s3dis_root):
    """--n-devices 2 on the card's default device raises where there are
    fewer than two cards, and never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        cli.main(["--dataset", "S3DIS", "--root", s3dis_root,
                  "--n-devices", "2"])
    assert cli.rank_devices("cpu", 2) == ["cpu", "cpu"]

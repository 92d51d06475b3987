"""The port's experiment driver on the CPU, against the JAX package's:
``Trainer`` (train/trainer.py), the vote eval (train/vote.py), KITTI's
streaming eval (train/kitti_eval.py) and the CLI (train/__main__.py).

Against the JAX package: an exact-regime epoch of both trainers on the same
rooms (dropout off in both through each module's ``get_model``, the JAX
initial state copied into the port), then one more step from the JAX
trainer's whole state carried over (``load_flax_train_state``: the momentum
trace and the step too); ``labeled_vote_eval``, the unlabeled ``test``'s
files, ``eval_partseg`` and ``streaming_eval`` on the same inputs; the
``--set`` coercion. The rest mirrors tests/test_trainer.py and
tests/test_semantic3d_trainer.py on the port: train and vote, microbatched
eval, checkpoints with their sidecars, kill-and-resume, preemption, the
signal handlers, the Semantic3D label shift and the compute-dtype scope.
"""

from __future__ import annotations

import dataclasses
import os
import signal

import jax
import numpy as np
import pytest
import torch

from crfconv_tpu import models as jmodels
from crfconv_tpu.data import datasets as jdatasets
from crfconv_tpu.train import __main__ as jmain
from crfconv_tpu.train import config as jconfig
from crfconv_tpu.train import kitti_eval as jkitti
from crfconv_tpu.train import trainer as jtrainer
from crfconv_tpu.train import vote as jvote
from crfconv_tpu_torch import models, set_compute_dtype
from crfconv_tpu_torch.convert import load_flax_train_state
from crfconv_tpu_torch.data import datasets
from crfconv_tpu_torch.data.ply import read_ply
from crfconv_tpu_torch.models.common import get_compute_dtype
from crfconv_tpu_torch.train import __main__ as cli
from crfconv_tpu_torch.train import trainer as trainer_mod
from crfconv_tpu_torch.train.checkpoint import CheckpointManager
from crfconv_tpu_torch.train.config import S3DISConfig, Semantic3DConfig
from crfconv_tpu_torch.train.kitti_eval import streaming_eval
from crfconv_tpu_torch.train.train_state import TrainState
from crfconv_tpu_torch.train.trainer import Trainer
from crfconv_tpu_torch.train.vote import labeled_vote_eval
from tests.test_data import _make_s3dis_raw
from tests.test_semantic3d_trainer import _make_semantic3d_raw
from tests.test_torch_loader import _assert_batch_equal
from tests.test_torch_ops import few_torch_threads  # noqa: F401

NARROW = (8, 16, 32, 64, 128)


@pytest.fixture(scope="module")
def s3dis_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("s3dis"))
    _make_s3dis_raw(root, n_rooms=2, n_pts=600)
    return root


def _cfg(cls, root, ckpt, **kw):
    base = dict(root=root, mode="train", use_crf=True, steps=1, grid_size=0.2,
                sample_num=256, batch_size=2, epochs=2,
                train_samples_per_epoch=8, val_samples_per_epoch=4,
                checkpoint_dir=str(ckpt), layers=NARROW)
    base.update(kw)
    return cls(**base)


def _trainer(root, ckpt, seed=0, **kw):
    return Trainer(_cfg(S3DISConfig, root, ckpt, **kw), seed=seed,
                   device="cpu")


def _record(trainer, jax_side: bool):
    """Wrap a trainer's train step to record (batch, loss) per step."""
    steps, step = [], trainer._train_step

    def rec(state, batch, rng):
        out = step(state, batch, rng)
        m = out[1] if jax_side else out
        steps.append((batch, float(m["loss"])))
        return out

    trainer._train_step = rec
    return steps


def _no_dropout(monkeypatch):
    monkeypatch.setattr(jtrainer, "get_model", lambda name, **kw:
                        jmodels.get_model(name, dropout_rate=0.0, **kw))
    monkeypatch.setattr(trainer_mod, "get_model", lambda name, **kw:
                        models.get_model(name, dropout_rate=0.0, **kw))


def _from_jax(jt):
    from crfconv_tpu_torch import from_flax

    return from_flax(jax.device_get(jt.state.params),
                     jax.device_get(jt.state.batch_stats))


def _assert_state_close(port, jt):
    ref = _from_jax(jt)
    got = port.state.model.state_dict()
    assert set(got) == set(ref)
    params = {n for n, _ in port.state.model.named_parameters()}
    for name in sorted(ref):
        tol = (dict(rtol=1e-3, atol=5e-5) if name in params
               else dict(rtol=1e-3, atol=1e-5))     # running statistics
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   err_msg=name, **tol)


def test_exact_epoch_matches_jax(s3dis_root, tmp_path, monkeypatch):
    """One exact-regime epoch of each trainer from the same weights: the
    batches bit-equal, each step's loss (rtol 1e-5 the first, 1e-4 after),
    the train confusion equal, the parameters at rtol 1e-3, atol 5e-5 (the
    running statistics at atol 1e-5); then the JAX trainer's whole state
    (weights, statistics, momentum trace, step) carried into the port and
    one more step each on the next batch: the updates agree within 1e-3 of
    each tensor's largest and the weights' rounding (the momentum term is
    most of each update)."""
    _no_dropout(monkeypatch)
    kw = dict(neighbor_regime="exact", epochs=1)
    with jax.default_matmul_precision("highest"):
        jt = jtrainer.Trainer(_cfg(jconfig.S3DISConfig, s3dis_root,
                                   tmp_path / "j", **kw), seed=0)
    pt = _trainer(s3dis_root, tmp_path / "p", **kw)
    # Nonzero biases (tests/test_torch_train_step.py): at the fresh state's
    # zero biases a batch norm maps the self-pair row of the all-pairs
    # scales (16 and 4 points here) onto the leaky ReLU's kink at 0, where
    # the rounding of the batch mean picks the side in each package
    gen = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + np.float32(0.1) * gen.standard_normal(
            a.shape, dtype=np.float32)
        if path[-1].key == "bias" else a, jax.device_get(jt.state.params))
    jt.state = jt.state.replace(params=jax.device_put(params))
    # a fresh JAX state: zero momentum and step 0, as the port's
    load_flax_train_state(pt.state, jax.device_get(jt.state))
    jsteps, psteps = _record(jt, True), _record(pt, False)
    with jax.default_matmul_precision("highest"):
        jt.train_one_epoch(0)
    pt.train_one_epoch(0)
    assert len(psteps) == len(jsteps) == 4
    for i, ((pb, pl), (jb, jl)) in enumerate(zip(psteps, jsteps)):
        _assert_batch_equal(pb, jb)
        np.testing.assert_allclose(pl, jl, rtol=1e-5 if i == 0 else 1e-4)
    np.testing.assert_array_equal(pt.metrics.confusion_matrix,
                                  jt.metrics.confusion_matrix)
    _assert_state_close(pt, jt)
    assert pt.state.step == int(jt.state.step) == 4

    # the whole JAX state, momentum trace and step included
    load_flax_train_state(pt.state, jax.device_get(jt.state))
    before = {n: p.detach().clone()
              for n, p in pt.state.model.named_parameters()}
    jb, pb = next(iter(jt.train_loader)), next(iter(pt.train_loader))
    _assert_batch_equal(pb, jb)
    with jax.default_matmul_precision("highest"):
        jt.state, _ = jt._train_step(jt.state, jb, jax.random.PRNGKey(0))
    pt._train_step(pt.state, pb, pt.rng)
    ref = _from_jax(jt)
    for name, p in pt.state.model.named_parameters():
        du, dr = p.detach() - before[name], ref[name] - before[name]
        # plus 4 float32 ulps of the weights: the updates are differences
        # of float32 weights (a batch-norm bias before another batch norm
        # moves by its weight decay alone, ~1e-7)
        bound = (1e-3 * float(dr.abs().max())
                 + 2.0 ** -21 * float(before[name].abs().max()))
        assert float((du - dr).abs().max()) <= bound, name
    assert pt.state.step == 5


def test_set_momentum_and_schedule(s3dis_root, tmp_path):
    """The momentum buffers set are the given trace, and the learning rate
    that of the staircase schedule at the given step."""
    from crfconv_tpu_torch.convert import set_momentum

    pt = _trainer(s3dis_root, tmp_path)
    params = dict(pt.state.model.named_parameters())
    rng = np.random.default_rng(0)
    trace = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
             for n, p in params.items()}
    set_momentum(pt.state, {n: torch.from_numpy(v) for n, v in trace.items()},
                 9)
    for n, p in params.items():
        np.testing.assert_array_equal(
            pt.state.optimizer.state[p]["momentum_buffer"].numpy(), trace[n])
    assert pt.state.step == 9
    lr = pt.state.optimizer.param_groups[0]["lr"]
    assert lr == pytest.approx(pt.cfg.lr * pt.cfg.gamma ** (9 // 4))


class TestTrainer:
    def test_train_and_vote(self, s3dis_root, tmp_path):
        trainer = _trainer(s3dis_root, tmp_path)
        best = trainer.train()
        assert 0.0 <= best <= 1.0
        assert trainer.ckpt.latest_path() is not None
        assert trainer.ckpt.best_path() is not None
        assert trainer.ckpt.restore_aux()["epoch"] == 2
        step_before = trainer.state.step
        trainer.load()
        assert trainer.state.step == step_before
        res = trainer.test_labeled(num_votes=2)
        assert 0.0 <= res["full_mIoU"] <= 1.0
        assert 0.0 <= res["sub_mIoU"] <= 1.0
        assert 0.0 <= res["Overall Acc"] <= 1.0

    def test_microbatched_eval_matches_flat(self, s3dis_root, tmp_path):
        trainer = _trainer(s3dis_root, tmp_path)
        batch = next(iter(trainer.val_loader))
        flat = trainer._eval_batch(batch)
        trainer.cfg = dataclasses.replace(trainer.cfg, eval_microbatch=1)
        micro = trainer._eval_batch(batch)
        np.testing.assert_array_equal(flat["confusion"].numpy(),
                                      micro["confusion"].numpy())
        np.testing.assert_allclose(flat["probs"].numpy(),
                                   micro["probs"].numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(flat["preds"].numpy(),
                                      micro["preds"].numpy())
        np.testing.assert_array_equal(flat["point_idx"].numpy(),
                                      micro["point_idx"].numpy())
        # the vote passes' pyramids: each chunk draws as the batch does
        flat = trainer._eval_batch(batch, vote_pass=3)
        trainer.cfg = dataclasses.replace(trainer.cfg, eval_microbatch=0)
        again = trainer._eval_batch(batch, vote_pass=3)
        np.testing.assert_allclose(flat["probs"].numpy(),
                                   again["probs"].numpy(), rtol=1e-5,
                                   atol=1e-6)


class TestCheckpointManager:
    def test_atomic_save_best_and_retention(self, tmp_path):
        state = TrainState.create(torch.nn.Linear(2, 2), lr=0.1)
        mgr = CheckpointManager(str(tmp_path), keep=2)

        def save(value, step, metric, aux):
            with torch.no_grad():
                state.model.weight.fill_(value)
            return mgr.save(state, step=step, metric=metric, aux=aux)

        p1 = save(1.0, 1, 0.1, {"epoch": 1, "a": np.arange(3)})
        save(2.0, 2, 0.5, {"epoch": 2, "a": np.arange(4)})
        p3 = save(3.0, 3, 0.3, None)
        files = sorted(os.listdir(tmp_path))
        assert not [f for f in files if f.endswith(".tmp")]
        assert [f for f in files if f.startswith("ckpt_0")] == [
            "ckpt_00000002.pt", "ckpt_00000002.pt.aux.pkl",
            "ckpt_00000003.pt"]
        assert not os.path.exists(p1 + ".aux.pkl")   # pruned with its ckpt
        best = mgr.restore(state, mgr.best_path())
        assert float(best.model.weight[0, 0]) == 2.0
        aux = mgr.restore_aux(os.path.join(tmp_path, "ckpt_00000002.pt"))
        assert aux["epoch"] == 2
        np.testing.assert_array_equal(aux["a"], np.arange(4))
        assert mgr.restore_aux() is None           # the latest has none
        assert float(mgr.restore(state).model.weight[0, 0]) == 3.0
        assert mgr.latest_path() == p3
        # a tie does not replace the best (strictly higher)
        save(4.0, 4, 0.5, None)
        assert float(mgr.restore(state, mgr.best_path())
                     .model.weight[0, 0]) == 2.0


class TestPreemptResume:
    def test_kill_and_resume_reproduces_stream(self, s3dis_root, tmp_path):
        """A run resumed from its checkpoint draws the samples the live run
        draws next, and its next step is bit-identical to the live run's
        on the same batch (the generator's state rides in the sidecar)."""
        def make():
            return _trainer(s3dis_root, tmp_path, use_crf=False,
                            sample_num=128, train_samples_per_epoch=4,
                            val_samples_per_epoch=2)

        t1 = make()
        t1.train_one_epoch(0)
        t1.ckpt.save(t1.state, step=t1.state.step, aux=t1._aux_state(1))
        rng_state = t1.rng.get_state()
        ref = [t1.train_loader.dataset.get_sample(t1.train_loader.rng)
               for _ in range(4)]

        t2 = make()
        assert t2.resume() == 1
        out = [t2.train_loader.dataset.get_sample(t2.train_loader.rng)
               for _ in range(4)]
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(r["point_idx"], o["point_idx"])
        assert t2.state.step == t1.state.step
        assert torch.equal(t2.rng.get_state(), rng_state)

        batch = next(iter(t2.train_loader))
        m1 = t1._train_step(t1.state, batch, t1.rng)
        m2 = t2._train_step(t2.state, batch, t2.rng)
        assert torch.equal(m1["loss"], m2["loss"])
        a, b = t1.state.model.state_dict(), t2.state.model.state_dict()
        assert all(torch.equal(a[n], b[n]) for n in a)

    def test_mid_epoch_preemption_breaks_loop(self, s3dis_root, tmp_path):
        trainer = _trainer(s3dis_root, tmp_path, seed=1)
        pre = {"flag": True}
        trainer.train_one_epoch(0, pre)
        assert pre.get("mid_epoch") is True
        assert trainer.state.step == 0

    def test_preempted_train_saves_and_restores_handlers(self, s3dis_root,
                                                         tmp_path,
                                                         monkeypatch):
        """SIGTERM during training stops the loop with a checkpoint and its
        sidecar; the previous handlers come back, after
        an exception too."""
        trainer = _trainer(s3dis_root, tmp_path)
        before = (signal.getsignal(signal.SIGTERM),
                  signal.getsignal(signal.SIGINT))
        step = trainer._train_step

        def step_then_signal(*a):
            out = step(*a)
            signal.raise_signal(signal.SIGTERM)
            return out

        trainer._train_step = step_then_signal
        trainer.train()
        # the flag is read every 10th step and at each epoch's start: the
        # first epoch (4 steps) ends, the second saves and stops
        assert trainer.state.step == 4
        assert trainer.ckpt.restore_aux()["epoch"] == 1
        assert (signal.getsignal(signal.SIGTERM),
                signal.getsignal(signal.SIGINT)) == before

        def boom(preempted):
            raise RuntimeError("boom")

        monkeypatch.setattr(trainer, "_train_loop", boom)
        with pytest.raises(RuntimeError, match="boom"):
            trainer.train()
        assert (signal.getsignal(signal.SIGTERM),
                signal.getsignal(signal.SIGINT)) == before


class TestDeviceScope:
    def test_compute_dtype_does_not_leak(self, s3dis_root, tmp_path):
        """A bfloat16 trainer's products run in bfloat16 inside its calls
        only; the loss and the parameters stay float32."""
        set_compute_dtype(None)
        trainer = _trainer(s3dis_root, tmp_path, compute_dtype="bfloat16")
        seen = []
        hook = trainer.model.conv1_1.lin_in.register_forward_hook(
            lambda mod, inp, out: seen.append(out.dtype))
        batch = next(iter(trainer.train_loader))
        m = trainer._train_step(trainer.state, batch, trainer.rng)
        hook.remove()
        assert seen == [torch.bfloat16]
        assert get_compute_dtype() is None
        assert m["loss"].dtype == torch.float32
        assert np.isfinite(float(m["loss"]))
        assert {p.dtype for p in trainer.model.parameters()} == {
            torch.float32}

        def raising(*a):
            assert get_compute_dtype() is torch.bfloat16
            raise RuntimeError("inside")

        with pytest.raises(RuntimeError, match="inside"):
            trainer._scoped(raising)()
        assert get_compute_dtype() is None

    def test_mesh_options_raise(self, s3dis_root, tmp_path):
        # n_devices > 1 trains data-parallel, and spatial_mesh (2, 2)
        # point-sharded on 4 ranks, over an initialised process group;
        # without one each raises
        with pytest.raises(RuntimeError, match="n_devices"):
            Trainer(_cfg(S3DISConfig, s3dis_root, tmp_path), device="cpu",
                    n_devices=2)
        with pytest.raises(RuntimeError, match="spatial_mesh"):
            _trainer(s3dis_root, tmp_path, spatial_mesh=(2, 2))


# --------------------------------------------------------------------------
# Semantic3D
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sem3d(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sem3d"))
    _make_semantic3d_raw(root)
    cfg = _cfg(Semantic3DConfig, root, tmp_path_factory.mktemp("ck"),
               grid_size=0.3, epochs=1, train_samples_per_epoch=4,
               val_samples_per_epoch=2)
    return root, Trainer(cfg, seed=0, device="cpu")


def test_train_epoch_with_label_shift(sem3d):
    _, trainer = sem3d
    tr = trainer.train_one_epoch(0)
    assert np.isfinite(tr["loss"])
    # labels 1..8 shifted to 0..7; 0 (unlabeled) ignored
    assert trainer.metrics.confusion_matrix.shape == (8, 8)
    assert trainer.metrics.confusion_matrix.sum() > 0


class _Stub:
    """The attributes a JAX Trainer method reads, set by hand."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_unlabeled_test_writes_what_jax_writes(sem3d, tmp_path):
    """The same test_probs give the same PLY and ascii ``.labels`` files as
    the JAX trainer's ``test`` (its method run on the JAX reader's val set
    with the same probabilities)."""
    root, trainer = sem3d
    jval = jdatasets.Semantic3DWholeDataset(
        root, grid_size=0.3, num_points=256, train_sample_per_epoch=4,
        test_sample_per_epoch=2).val_set
    rng = np.random.default_rng(5)
    probs = [rng.random(p.shape).astype(np.float32)
             for p in trainer.test_probs]

    def vote(ds):
        def run(smooth):
            ds.sampler.min_possibility = [
                m + 5.0 for m in ds.sampler.min_possibility]
        return run

    trainer.test_probs = [p.copy() for p in probs]
    trainer._vote_epoch = vote(trainer.val_set)
    try:
        out = trainer.test(num_votes=1, saving_path=str(tmp_path / "port"))
    finally:
        del trainer._vote_epoch
    stub = _Stub(cfg=jconfig.Semantic3DConfig(), val_set=jval,
                 test_probs=[p.copy() for p in probs], _vote_epoch=vote(jval))
    ref = jtrainer.Trainer.test(stub, num_votes=1,
                                saving_path=str(tmp_path / "jax"))
    files = sorted(os.listdir(out))
    assert files == sorted(os.listdir(ref))
    assert [f for f in files if f.endswith(".labels")]
    for f in files:
        if f.endswith(".labels"):
            with open(os.path.join(out, f)) as a, \
                    open(os.path.join(ref, f)) as b:
                assert a.read() == b.read()
        else:
            got, want = read_ply(os.path.join(out, f)), read_ply(
                os.path.join(ref, f))
            np.testing.assert_array_equal(got["pred"], want["pred"])
            assert got["pred"].shape[0] == trainer.val_set.test_labels[
                0].shape[0]


# --------------------------------------------------------------------------
# the vote eval, the part IoU, KITTI's streaming eval, the CLI
# --------------------------------------------------------------------------


class _FakeDS:
    label_values = np.array([0, 1], np.int32)

    def __init__(self):
        n = 50
        rng = np.random.default_rng(0)
        self.input_labels = [rng.integers(0, 2, n)]
        self.val_labels = self.input_labels
        self.val_proj = [np.arange(n)]
        self.min_possibility = np.array([0.0])


@pytest.mark.parametrize("delta,expect_epochs", [(1.0, 1), (4.0, 2)])
def test_vote_delta_rule_matches_jax(delta, expect_epochs):
    results = []
    for fn in (labeled_vote_eval, jvote.labeled_vote_eval):
        ds, probs, calls = _FakeDS(), [np.zeros((50, 2), np.float32)], []

        def vote(ds=ds, probs=probs, calls=calls):
            calls.append(1)
            ds.min_possibility += 2.0
            probs[0][:, 0] = 1.0

        results.append(fn(ds, vote, probs, num_votes=100, vote_delta=delta))
        assert len(calls) == expect_epochs
    assert results[0] == results[1]
    assert "full_mIoU" in results[0]


def test_vote_eval_on_rooms_matches_jax(s3dis_root):
    """The port's ``labeled_vote_eval`` (its confusion by ``np.bincount``)
    and the JAX package's (scikit-learn's) on the rooms' val set with real
    probabilities: equal results."""
    from crfconv_tpu_torch.train.vote import confusion_matrix
    from sklearn.metrics import confusion_matrix as sk_confusion

    ds = datasets.S3DISRoomDataset(s3dis_root, grid_size=0.2, num_points=256,
                                   train_sample_per_epoch=8,
                                   test_sample_per_epoch=4).test_set
    rng = np.random.default_rng(2)
    logits = [rng.standard_normal((p.shape[0], 13)).astype(np.float32) * 3
              for p in ds.input_points]
    probs = [np.exp(l) / np.exp(l).sum(1, keepdims=True) for l in logits]

    def vote():
        ds.sampler.min_possibility = [m + 0.7 for m in
                                      ds.sampler.min_possibility]

    start = list(ds.sampler.min_possibility)
    got = labeled_vote_eval(ds, vote, probs, num_votes=3, vote_delta=1.0)
    ds.sampler.min_possibility = start
    ref = jvote.labeled_vote_eval(ds, vote, probs, num_votes=3,
                                  vote_delta=1.0)
    assert got == ref and "sub_mIoU" in got
    for i in range(len(probs)):
        preds = ds.label_values[np.argmax(probs[i], 1)]
        a = confusion_matrix(ds.input_labels[i], preds, ds.label_values)
        b = sk_confusion(ds.input_labels[i], preds, labels=ds.label_values)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_confusion_matches_sklearn():
    from crfconv_tpu_torch.train.vote import confusion_matrix
    from sklearn.metrics import confusion_matrix as sk_confusion

    rng = np.random.default_rng(4)
    for labels in (np.arange(13), np.array([3, 1, 7, 2]), np.array([5])):
        t, p = rng.integers(-1, 15, 400), rng.integers(-1, 15, 400)
        a = confusion_matrix(t, p, labels)
        b = sk_confusion(t, p, labels=labels)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_eval_partseg_matches_jax():
    """``eval_partseg`` over the same batches' predictions, labels and
    categories: the port's and the JAX trainer's method give equal
    pIoU, mpIoU and per-category IoU."""
    from crfconv_tpu.train.metrics import SHAPENET_SEG_CLASSES

    rng = np.random.default_rng(6)
    cats = sorted(SHAPENET_SEG_CLASSES)
    batches, outs = [], []
    for _ in range(3):
        c = rng.integers(0, 16, 4)
        labels = np.stack([rng.choice(SHAPENET_SEG_CLASSES[cats[k]], 64)
                           for k in c])
        preds = np.where(rng.random(labels.shape) < 0.7, labels,
                         rng.integers(0, 50, labels.shape))
        batches.append(c)
        outs.append({"preds": preds, "labels": labels})

    class Batch:
        def __init__(self, c, torch_side):
            self.category = torch.as_tensor(c) if torch_side else c

    port = _Stub(val_loader=[Batch(c, True) for c in batches], mesh=None)
    feed = iter(outs)
    port._eval_batch = lambda b: {k: torch.as_tensor(v)
                                  for k, v in next(feed).items()}
    got = Trainer.eval_partseg(port)
    jfeed = iter(outs)
    stub = _Stub(val_loader=[Batch(c, False) for c in batches], state=None,
                 _place=lambda b: b, _fetch=jtrainer.Trainer._fetch,
                 _eval_batch=lambda s, b: next(jfeed))
    ref = jtrainer.Trainer.eval_partseg(stub)
    assert got["pIoU"] == ref["pIoU"] and got["mpIoU"] == ref["mpIoU"]
    assert got["class_pIoU"] == ref["class_pIoU"]


def _write_kitti(root, rng):
    for seq_id, nf in [("00", 2), ("01", 3), ("08", 2)]:
        seq = os.path.join(root, "raw", "sequences", seq_id)
        os.makedirs(os.path.join(seq, "velodyne"))
        os.makedirs(os.path.join(seq, "labels"))
        for f in range(nf):
            n = 200 + 10 * f
            rng.random((n, 4)).astype(np.float32).tofile(
                os.path.join(seq, "velodyne", f"{f:06d}.bin"))
            rng.choice([0, 10, 40, 48, 50, 70], size=n).astype(
                np.uint32).tofile(os.path.join(seq, "labels",
                                               f"{f:06d}.label"))


@pytest.mark.parametrize("sequences", ["train", "val"])
def test_streaming_eval_matches_jax(tmp_path, sequences):
    root = str(tmp_path)
    _write_kitti(root, np.random.default_rng(3))

    def predict(frame):
        # right where a hash of the position says so, else class 2
        y = np.asarray(frame["y"]).astype(np.int64) - 1
        keep = (np.asarray(frame["pos"])[:, 0] * 1000).astype(int) % 3 > 0
        return np.where(keep, np.maximum(y, 0), 2)

    got = streaming_eval(datasets.SemanticKITTIDataset(
        root, sequences=sequences, num_points=64), predict)
    ref = jkitti.streaming_eval(jdatasets.SemanticKITTIDataset(
        root, sequences=sequences, num_points=64), predict)
    assert got.keys() == ref.keys()
    assert list(got["per_sequence"]) == list(ref["per_sequence"])
    np.testing.assert_equal(got, ref)
    # the tensor a model returns on the card is read the same way
    got_t = streaming_eval(datasets.SemanticKITTIDataset(
        root, sequences=sequences, num_points=64),
        lambda f: torch.as_tensor(predict(f)))
    np.testing.assert_equal(got_t, ref)


@pytest.mark.parametrize("value,ref", [
    ("true", False), ("0", True), ("YES", False), ("7", 3), ("-2", 0),
    ("0.25", 1.0), ("1e-3", 0.5), ("4,4,2", (16, 16)), ("0.5,1", (1.0,)),
    ("windowed", "exact"), ("bfloat16", "float32"),
])
def test_set_coercion_matches_jax(value, ref):
    got, want = cli._coerce(value, ref), jmain._coerce(value, ref)
    assert got == want and type(got) is type(want)


def test_cli_builds_the_config(tmp_path):
    cfg, args = cli.parse([
        "--dataset", "S3DIS", "--root", str(tmp_path), "--mode", "test",
        "--no-crf", "--steps", "3", "--batch-size", "4", "--device", "cpu",
        "--set", "kernel_sizes=8,8,8,8,8", "--set", "compute_dtype=bfloat16",
        "--set", "eval_views=1", "--set", "curve_jitter=1"])
    assert (cfg.mode, cfg.use_crf, cfg.steps, cfg.batch_size) == (
        "test", False, 3, 4)
    assert cfg.kernel_sizes == (8, 8, 8, 8, 8)
    assert (cfg.compute_dtype, cfg.eval_views, cfg.curve_jitter) == (
        "bfloat16", 1, True)
    assert args.device == "cpu"
    with pytest.raises(SystemExit):
        cli.parse(["--dataset", "S3DIS", "--root", ".", "--set", "nope=1"])


def test_cli_trains_and_tests(s3dis_root, tmp_path, monkeypatch):
    """``python -m crfconv_tpu_torch.train`` in-process: a train run, then
    the test mode voting with the run's best checkpoint."""
    got = []

    class Recording(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            got.append(self)

    monkeypatch.setattr(cli, "Trainer", Recording)
    common = ["--dataset", "S3DIS", "--root", s3dis_root, "--batch-size",
              "2", "--device", "cpu", "--set", "grid_size=0.2", "--set",
              "sample_num=256", "--set", "val_samples_per_epoch=4",
              "--set", "train_samples_per_epoch=4", "--set",
              f"checkpoint_dir={tmp_path}", "--no-crf", "--epochs", "1"]
    best = cli.main(common + ["--mode", "train"])
    assert 0.0 <= best <= 1.0
    best_path = got[0].ckpt.best_path()
    assert best_path is not None
    res = cli.main(common + ["--mode", "test"])
    assert 0.0 <= res["full_mIoU"] <= 1.0
    ref = torch.load(best_path, weights_only=True)["model"]
    now = got[1].state.model.state_dict()
    assert all(torch.equal(now[n], ref[n]) for n in ref)

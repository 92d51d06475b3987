"""The pieces of the port's train step against the JAX package on the
CPU: train-mode batch norm, the weighted cross entropy, the confusion
matrix and scores, the optimizer and its staircase decay, dropout, the
checkpoint manager, the classifier's initial bias, and the rule that no
module of the port imports JAX or the JAX package."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crfconv_tpu.models.common import MaskedBatchNorm as JBN
from crfconv_tpu.ops import crf as jcrf
from crfconv_tpu.train import losses as jlosses
from crfconv_tpu.train import metrics as jmetrics
from crfconv_tpu.train.train_state import make_optimizer as j_make_optimizer
from crfconv_tpu_torch import PointConvResNet
from crfconv_tpu_torch.models.common import MaskedBatchNorm, dropout
from crfconv_tpu_torch.ops import crf
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train import losses, metrics
from crfconv_tpu_torch.train.checkpoint import CheckpointManager
from crfconv_tpu_torch.train.train_state import TrainState, make_optimizer

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# batch norm, loss, metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 5, 7), (3, 100, 4)])
def test_batch_norm_train_matches_flax(shape):
    rng = np.random.default_rng(0)
    f = shape[-1]
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(f)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(f)).astype(np.float32)
    var = (0.5 + rng.random(f)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    ref, upd = JBN().apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    bn = MaskedBatchNorm(f)
    bn.load_state_dict({"scale": _t(scale), "bias": _t(bias),
                        "mean": _t(mean), "var": _t(var)})
    got = bn.train()(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    # eval mode normalises with the updated running statistics
    ref_eval = JBN().apply({"params": variables["params"],
                            "batch_stats": upd["batch_stats"]},
                           jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn.eval()(_t(x)).detach().numpy(),
                               np.asarray(ref_eval), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy_matches(weighted):
    rng = np.random.default_rng(1)
    c = 13
    scores = rng.standard_normal((2, 300, c)).astype(np.float32) * 3
    labels = rng.integers(0, c, (2, 300)).astype(np.int64)
    labels[0, :20] = -1          # ignore_index
    labels[1, :5] = c            # out of range
    labels[1, 5:9] = -7
    w = (0.5 + rng.random(c)).astype(np.float32) if weighted else None
    ref = jlosses.weighted_cross_entropy(
        jnp.asarray(scores), jnp.asarray(labels),
        None if w is None else jnp.asarray(w), ignore_index=-1,
    )
    got = losses.weighted_cross_entropy(
        _t(scores), _t(labels), None if w is None else _t(w), ignore_index=-1
    )
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    both = losses.segmentation_loss((_t(scores), _t(scores)), _t(labels))
    np.testing.assert_allclose(
        float(both), 2 * float(losses.weighted_cross_entropy(
            _t(scores), _t(labels))), rtol=1e-6,
    )


def test_confusion_and_scores_match():
    rng = np.random.default_rng(2)
    c = 6
    y = rng.integers(-1, c + 2, (4, 500))
    p = rng.integers(0, c, (4, 500))
    ref = np.asarray(jmetrics.confusion_matrix_device(
        jnp.asarray(y), jnp.asarray(p), c, ignore_index=-1
    ))
    got = metrics.confusion_matrix_device(_t(y), _t(p), c, ignore_index=-1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.sum() == ((y >= 0) & (y < c)).sum()
    ref_s, ref_cls = jmetrics.scores_from_confusion(ref)
    got_s, got_cls = metrics.scores_from_confusion(got.numpy())
    assert got_s == pytest.approx(ref_s)
    np.testing.assert_allclose(list(got_cls.values()), list(ref_cls.values()))
    run, jrun = metrics.RunningScore(c), jmetrics.RunningScore(c)
    run.update(y, p)
    run.update_confusion(got)
    jrun.update(y, p)
    jrun.update_confusion(ref)
    np.testing.assert_array_equal(run.confusion_matrix, jrun.confusion_matrix)


def test_crf_train_path_gradient_matches_jax():
    """The CRF of the train path (steps=1 from the gathered neighbours):
    the gradient into z, the similarity, the neighbours and c, through
    C = c^T c and the Cholesky inverse of I + C, against jax.grad."""
    rng = np.random.default_rng(7)
    b, n, k, h = 2, 64, 15, 8
    z, nb = (rng.standard_normal(s).astype(np.float32)
             for s in ((b, n, h), (b, n, k, h)))
    s = rng.random((b, n, k)).astype(np.float32)
    s /= s.sum(-1, keepdims=True)
    c = (np.eye(h) + 0.3 * rng.standard_normal((h, h))).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)

    def f(z, s, nb, c):
        x = jcrf.crf_mean_field(z, s, jnp.asarray(idx), c, 1, neighbors0=nb)
        return jnp.sum(jnp.sin(x))

    with jax.default_matmul_precision("highest"):
        ref = jax.grad(f, argnums=(0, 1, 2, 3))(z, s, nb, c)
    ts = [_t(a).requires_grad_() for a in (z, s, nb, c)]
    x = crf.crf_mean_field(ts[0], ts[1], _t(idx), ts[3], 1, NeighborMode(),
                           neighbors0=ts[2])
    x.sin().sum().backward()
    for name, t, r in zip(("z", "s", "neighbors", "c"), ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# optimizer and dropout
# ---------------------------------------------------------------------------


def test_optimizer_matches_optax_across_a_decay_boundary():
    spe = 3
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(2 * spe + 1)]
    tx = j_make_optimizer(lr=0.1, steps_per_epoch=spe)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt, sched = make_optimizer(list(tp.values()), lr=0.1,
                                steps_per_epoch=spe)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = _t(v)
        opt.step()
        sched.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6)
    # two decays: 0.1 * 0.95^2 from step 2 * spe on
    assert sched.get_last_lr()[0] == pytest.approx(0.1 * 0.95**2)


def test_dropout_generator_and_rate():
    x = torch.ones(200_000)
    a = dropout(x, 0.3, torch.Generator().manual_seed(5))
    b = dropout(x, 0.3, torch.Generator().manual_seed(5))
    c = dropout(x, 0.3, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(1 - kept.float().mean().item() - 0.3) < 0.005
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert torch.equal(dropout(x, 0.0, None), x)
    with pytest.raises(ValueError):
        dropout(x, 0.5, None)


def test_classifier_bias_starts_at_zero():
    """As flax's nn.Dense; every other Linear keeps torch's init."""
    model = PointConvResNet(13, 6, layers=(8, 16, 32, 64, 128), device="cpu")
    assert torch.count_nonzero(model.classifier_1.bias) == 0
    assert torch.count_nonzero(model.classifier_1.weight) > 0
    bound = 1 / np.sqrt(32)
    assert float(model.classifier_1.weight.detach().abs().max()) <= bound


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _small_state(seed=0):
    model = PointConvResNet(5, 4, layers=(8, 16, 32, 64, 128), device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    return TrainState.create(model, lr=0.05, steps_per_epoch=2)


def _take_steps(state, n):
    for _ in range(n):
        for p in state.model.parameters():
            p.grad = torch.ones_like(p)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1


def test_checkpoint_round_trip(tmp_path):
    state = _small_state(0)
    _take_steps(state, 3)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(state, state.step)
    assert os.path.basename(path) == "ckpt_00000003.pt"
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    fresh = mgr.restore(_small_state(1))
    assert fresh.step == 3
    for (n, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert fresh.scheduler.get_last_lr() == state.scheduler.get_last_lr()
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           fresh.optimizer.state[q]["momentum_buffer"])
    # both continue identically
    _take_steps(state, 1)
    _take_steps(fresh, 1)
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_retention_and_strict_best(tmp_path):
    state = _small_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step, metric in [(1, 0.5), (2, 0.5), (3, 0.4), (4, 0.3)]:
        mgr.save(state, step, metric)
    files = sorted(p for p in os.listdir(tmp_path) if p.startswith("ckpt_"))
    # the newest two plus the best, which a tie (step 2) did not replace
    assert files == ["ckpt_00000001.pt", "ckpt_00000003.pt",
                     "ckpt_00000004.pt", "ckpt_best.pt"]
    assert mgr._load_meta()["best"]["step"] == 1
    assert mgr.latest_path().endswith("ckpt_00000004.pt")
    mgr.save(state, 5, 0.6)
    assert mgr._load_meta()["best"]["step"] == 5
    assert mgr.best_path().endswith("ckpt_best.pt")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def test_no_module_of_the_port_imports_jax():
    """Every module of crfconv_tpu_torch, and chip_smoke, imports with jax,
    flax and crfconv_tpu blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'crfconv_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import crfconv_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    crfconv_tpu_torch.__path__, 'crfconv_tpu_torch.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert 'crfconv_tpu_torch.train.train_state' in mods, mods\n"
        "assert {'crfconv_tpu_torch.ops.discrete_core',\n"
        "        'crfconv_tpu_torch.models.discrete_crf'} <= set(mods), mods\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'crfconv_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)

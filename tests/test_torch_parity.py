"""The port's parity harness (crfconv_tpu_torch/parity) on the CPU, against
the JAX package's (crfconv_tpu/parity).

Against the JAX package: the synthetic corpora written byte for byte; the
port's oracle bit-equal to the JAX package's (tests/torch_ref.py) from the
same flax parameters, and close to the port's flagship in the exact regime;
the torch arm (``run_torch_reference``) on the dry-run corpus without the
plateau protocol, its every step's loss and its vote result equal to JAX's;
with the plateau protocol, the one deliberate departure: on a tie for the
best val mIoU the port keeps the first tied state (as its Trainer's
checkpoint manager does) where JAX's torch arm keeps the last. Then the
harness end to end on the CPU, both arms in one call and through the CLI,
and the two arms as separate calls combined by ``CRFCONV_PARITY_ARM``.
"""

from __future__ import annotations

import inspect
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from crfconv_tpu import parity as jparity
from crfconv_tpu.data import datasets as jdatasets
from crfconv_tpu.data.pipeline import synthetic_batch
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.parity import synthetic as jsynthetic
from crfconv_tpu.train import config as jconfig
from crfconv_tpu.train import metrics as jmetrics
from crfconv_tpu.train import vote as jvote
from crfconv_tpu_torch import PointConvResNet, Trainer, from_flax, parity
from crfconv_tpu_torch.data import datasets
from crfconv_tpu_torch.data.pipeline import build_pyramid, make_batch
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.parity import __main__ as cli
from crfconv_tpu_torch.parity import oracle, synthetic
from crfconv_tpu_torch.train import config, metrics, vote
from tests import torch_ref
from tests.test_torch_ops import few_torch_threads  # noqa: F401

REPORT_KEYS = {"port_full_mIoU", "torch_full_mIoU", "delta", "tolerance",
               "within_tolerance", "port", "torch", "config"}


def _tree(root) -> dict:
    """{path under root: the file's bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# the corpora
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_rooms_byte_equal(tmp_path, seed):
    kw = dict(rooms_per_area=2, pts_per_room=3000, seed=seed)
    n = synthetic.make_synthetic_rooms(str(tmp_path / "port"), **kw)
    n_j = jsynthetic.make_synthetic_rooms(str(tmp_path / "jax"), **kw)
    tree = _tree(tmp_path / "port")
    assert n == n_j >= 4 * 3000 * 0.99
    assert len(tree) > 20 and tree == _tree(tmp_path / "jax")


@pytest.mark.parametrize("n_rooms,n_pts", [(2, 500), (1, 40)])
def test_synthetic_raw_byte_equal(tmp_path, n_rooms, n_pts):
    parity.make_synthetic_raw(str(tmp_path / "port"), n_rooms, n_pts)
    jparity.make_synthetic_raw(str(tmp_path / "jax"), n_rooms, n_pts)
    tree = _tree(tmp_path / "port")
    assert len(tree) == 2 * (1 + 3 * n_rooms)
    assert tree == _tree(tmp_path / "jax")


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_variables():
    """The full-width flax flagship's initial variables (13 classes)."""
    batch = synthetic_batch(1, 256, 6, 13, seed=5)
    model = JResNet(n_classes=13, use_crf=True, steps=1)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables = jax.jit(lambda b: model.init(rngs, b, train=False))(batch)
    return jax.device_get(variables)


def _exact_batch():
    """A B2 x 1024 batch with the host pyramid (exact kNN)."""
    rng = np.random.default_rng(7)
    pos = rng.random((2, 1024, 3)).astype(np.float32)
    x = rng.random((2, 1024, 6)).astype(np.float32)
    return make_batch(x, None, build_pyramid(pos, rng=rng), device="cpu")


@pytest.mark.parametrize("steps", [1, 2])
def test_oracle_matches_reference_and_port(flagship_variables, steps):
    """The port's oracle equals the JAX package's bit for bit from the same
    flax parameters, and the port's flagship (``from_flax``, the exact
    regime) within rtol 1e-3, atol 1e-4 on the same pyramid."""
    params = flagship_variables["params"]
    batch = _exact_batch()
    scales = [s._asdict() for s in batch.scales]
    outs = []
    for mod in (oracle, torch_ref):
        m = mod.TorchPointConvResNet(6, 13, use_crf=True, steps=steps)
        mod.load_from_flax(m, params)
        with torch.no_grad():
            outs.append(m.eval()(batch.x, scales))
    ours, ref = outs
    assert ours.shape == (2, 1024, 13)
    assert torch.equal(ours, ref)

    port = PointConvResNet(13, 6, use_crf=True, steps=steps, device="cpu")
    port.load_state_dict(from_flax(params, flagship_variables["batch_stats"]))
    with torch.no_grad():
        got = port.eval()(batch, NeighborMode("exact"))
    np.testing.assert_allclose(got.numpy(), ours.numpy(), rtol=1e-3,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the torch arm against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dry_roots(tmp_path_factory):
    """The dry-run corpus twice, one copy a package (each processes it into
    its own cache beside the raw files)."""
    roots = {}
    for side in ("port", "jax"):
        roots[side] = str(tmp_path_factory.mktemp(f"dry_{side}"))
        parity.make_synthetic_raw(roots[side])
    return roots


def _arm_inputs(side: str, root: str, **kw):
    """The dry run's config and a fresh dataset of one package."""
    cfg_mod, D = ((config, datasets) if side == "port"
                  else (jconfig, jdatasets))
    cfg = cfg_mod.S3DISConfig(**{
        **dict(root=root, mode="train", use_crf=True, steps=1, grid_size=0.2,
               sample_num=128, batch_size=2, epochs=2,
               train_samples_per_epoch=4, val_samples_per_epoch=2,
               checkpoint_dir=os.path.join(root, "ckpt")),
        **kw})
    ds = D.S3DISRoomDataset(
        root, test_area=cfg.test_area, grid_size=cfg.grid_size,
        num_points=cfg.sample_num,
        train_sample_per_epoch=cfg.train_samples_per_epoch,
        test_sample_per_epoch=cfg.val_samples_per_epoch)
    return cfg, ds


def _run_arm(side: str, root: str, **kw) -> dict:
    cfg, ds = _arm_inputs(side, root, **kw)
    if side == "port":
        return parity.run_torch_reference(cfg, ds, seed=0, num_votes=2,
                                          device="cpu")
    return jparity.run_torch_reference(cfg, ds, seed=0, num_votes=2)


def test_torch_reference_matches_jax(dry_roots, monkeypatch):
    """Without the plateau protocol the port's torch arm is JAX's: every
    step's loss and the vote result equal (the loaders give the same
    batches, the weights are the same draws), and the caller's global
    generator is left as it was."""
    losses = []
    ce = F.cross_entropy

    def recorded(*args, **kwargs):
        out = ce(*args, **kwargs)
        losses.append(float(out.detach()))
        return out

    monkeypatch.setattr(F, "cross_entropy", recorded)
    res_j = _run_arm("jax", dry_roots["jax"])
    losses_j, losses[:] = list(losses), []
    before = torch.get_rng_state()
    res = _run_arm("port", dry_roots["port"])
    assert torch.equal(torch.get_rng_state(), before)
    assert len(losses_j) == 4 and losses == losses_j
    assert res_j and res == res_j
    assert 0.0 <= res["full_mIoU"] <= 1.0 and 0.0 <= res["sub_mIoU"] <= 1.0


SCRIPTED_MIOU = [0.3, 0.5, 0.5, 0.4, 0.2]


def _tie_run(side: str, root: str, monkeypatch):
    """The torch arm with patience 2 under a scripted val mIoU sequence (a
    tie at epochs 1 and 2): the model's state at each epoch's val and the
    state it votes with."""
    oracle_mod, metrics_mod, vote_mod = (
        (oracle, metrics, vote) if side == "port"
        else (torch_ref, jmetrics, jvote))
    made, at_val, voted = [], [], []

    def state(model):
        return {k: v.clone() for k, v in model.state_dict().items()}

    class Recorded(oracle_mod.TorchPointConvResNet):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    class Scripted(metrics_mod.RunningScore):
        def get_scores(self):
            scores, per_class = super().get_scores()
            at_val.append(state(made[-1]))
            return ({**scores, "Mean IoU": SCRIPTED_MIOU[len(at_val) - 1]},
                    per_class)

    def vote_eval(ds, vote_epoch_fn, test_probs, num_votes=100, **kw):
        voted.append(state(made[-1]))
        return {}

    # each package imports these names from their modules when it runs
    target = "crfconv_tpu_torch" if side == "port" else "crfconv_tpu"
    monkeypatch.setattr(f"{target}.parity.oracle.TorchPointConvResNet",
                        Recorded)
    monkeypatch.setattr(metrics_mod, "RunningScore", Scripted)
    monkeypatch.setattr(vote_mod, "labeled_vote_eval", vote_eval)
    assert _run_arm(side, root, epochs=8, early_stop_patience=2) == {}
    return at_val, voted[0]


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_tie_keeps_first_best_unlike_jax(dry_roots, monkeypatch):
    """Val mIoU 0.3, 0.5, 0.5, 0.4, 0.2 with patience 2: both arms reset
    patience on the tie and stop after the fifth epoch; the port votes with
    epoch 1's state (the first tied best), JAX's torch arm with epoch 2's
    (the last)."""
    at_val_j, voted_j = _tie_run("jax", dry_roots["jax"], monkeypatch)
    at_val, voted = _tie_run("port", dry_roots["port"], monkeypatch)
    assert len(at_val) == len(at_val_j) == len(SCRIPTED_MIOU)
    assert all(_equal(a, b) for a, b in zip(at_val, at_val_j))
    assert not _equal(at_val[1], at_val[2])
    assert _equal(voted, at_val[1])
    assert _equal(voted_j, at_val_j[2])


# ---------------------------------------------------------------------------
# the harness end to end
# ---------------------------------------------------------------------------

def _check_report(report: dict, device: str) -> None:
    assert set(report) == REPORT_KEYS
    for arm in ("port", "torch"):
        res = report[arm]
        assert 0.0 <= res["full_mIoU"] <= 1.0
        assert 0.0 <= res["sub_mIoU"] <= 1.0
        assert res["wall_s"] > 0
        assert report[f"{arm}_full_mIoU"] == res["full_mIoU"]
    assert report["delta"] == (report["port_full_mIoU"]
                               - report["torch_full_mIoU"])
    assert report["within_tolerance"] == (
        abs(report["delta"]) <= parity.MIOU_TOLERANCE)
    assert report["config"]["device"] == device
    assert report["config"]["dry_run"] is True


def test_run_parity_dry_run_both_arms(tmp_path, monkeypatch):
    monkeypatch.delenv("CRFCONV_PARITY_ARM", raising=False)
    out = tmp_path / "report.json"
    report = parity.run_parity(str(tmp_path), dry_run=True, num_votes=2,
                               seed=0, out=str(out), device="cpu")
    _check_report(report, "cpu")
    with open(out) as f:
        assert json.load(f) == report
    for arm in ("port", "torch"):
        with open(tmp_path / f"parity_{arm}.json") as f:
            assert json.load(f) == report[arm]


def test_cli_arms_as_separate_calls(tmp_path, monkeypatch):
    """``CRFCONV_PARITY_ARM=port`` then ``torch`` through the CLI: the
    first call leaves the torch arm pending, the second assembles the
    report from both files unchanged; devices default to cuda."""
    assert cli.parse(["--root", "r"]).device == "cuda"
    for fn in (parity.run_parity, parity.run_torch_reference, Trainer):
        assert inspect.signature(fn).parameters["device"].default == "cuda"

    out = tmp_path / "report.json"
    argv = ["--root", str(tmp_path), "--dry-run", "--num-votes", "2",
            "--device", "cpu", "--out", str(out)]
    monkeypatch.setenv("CRFCONV_PARITY_ARM", "port")
    first = cli.main(argv)
    assert first["pending"] == "torch" and set(first) == {"port", "pending"}
    assert not out.exists()
    monkeypatch.setenv("CRFCONV_PARITY_ARM", "torch")
    report = cli.main(argv)
    _check_report(report, "cpu")
    for arm in ("port", "torch"):
        with open(tmp_path / f"parity_{arm}.json") as f:
            assert report[arm] == json.load(f)
    assert report["port"] == first["port"]
    with open(out) as f:
        assert json.load(f) == report
    monkeypatch.setenv("CRFCONV_PARITY_ARM", "jax")
    with pytest.raises(ValueError, match="CRFCONV_PARITY_ARM"):
        cli.main(argv)

"""What each rank of the data-parallel CPU tests runs (no tests here).

``tests/test_torch_parallel.py`` spawns two gloo ranks once through
``crfconv_tpu_torch.parallel.launch`` with :func:`run_scenarios`, which
runs every scenario of its spec on the rank's shard of each global batch
and returns the results (numpy). The same functions with ``mesh=None``
give the one-process port step on the whole batch. This module imports
torch and the port only, so a spawned rank starts without JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from crfconv_tpu_torch.data.batch import PointBatch, RawBatch, ScaleData
from crfconv_tpu_torch.models import get_model
from crfconv_tpu_torch.models import segnets
from crfconv_tpu_torch.models.common import MaskedBatchNorm
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.parallel import (
    data_parallel, make_global_batch, make_parallel_train_step, replicate,
    shard_batch,
)
from crfconv_tpu_torch.train.train_state import TrainState, make_train_step


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def make_batch(spec: dict, dev):
    """The global batch of a spec on ``dev``: a RawBatch, or a PointBatch
    where the spec has ``scales``."""
    def t(a):
        return None if a is None else _t(a).to(dev)

    if "scales" in spec:
        return PointBatch(
            x=t(spec["x"]), y=t(spec["y"]).long(),
            scales=tuple(ScaleData(*map(t, s)) for s in spec["scales"]))
    return RawBatch(pos=t(spec["pos"]), x=t(spec["x"]), y=t(spec["y"]).long())


def _rows(a, mesh):
    """This rank's rows of a global array (all of them with no mesh)."""
    if mesh is None:
        return a
    b = a.shape[0] // mesh.world
    return a[mesh.rank * b:(mesh.rank + 1) * b]


def step_scenario(mesh, spec: dict) -> dict:
    """``spec["steps"]`` train steps of a fresh model from
    ``spec["state"]`` on this rank's shard of the global batch (on the
    rank's device; ``spec["device"]``, default the CPU, with no mesh); the
    losses, confusions and the state after each step, on the host."""
    dev = (torch.device(spec.get("device", "cpu")) if mesh is None
           else mesh.device)
    model = get_model(spec["model"], device=dev, **spec["model_kw"])
    model.load_state_dict({k: _t(v) for k, v in spec["state"].items()})
    state = TrainState.create(model, lr=spec.get("lr", 0.01))
    if mesh is not None:
        replicate(state, mesh)
    mode = NeighborMode(**spec["mode"])
    cw = _t(spec.get("class_weights"))
    cw = None if cw is None else cw.to(dev)
    step = make_train_step(mode, cw, spec.get("ignore_index", -1),
                           windowed=spec["windowed"],
                           label_offset=spec.get("label_offset", 0))
    if mesh is not None:
        step = make_parallel_train_step(step, mesh)
    batch = make_batch(spec["batch"], dev)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    own = segnets._discrete_crf_idx
    if spec.get("crf_idx") is not None:
        # the discrete CRF's kNN(32) of the reference step
        segnets._discrete_crf_idx = (
            lambda pos, m: _t(_rows(spec["crf_idx"], mesh)).to(dev))
    out = {"loss": [], "confusion": [], "states": []}
    try:
        for i in range(spec["steps"]):
            gen = (torch.Generator(device=dev).manual_seed(spec["seed"] + i)
                   if "seed" in spec else None)
            m = step(state, batch, gen, offsets=spec.get("offsets"))
            out["loss"].append(float(m["loss"]))
            out["confusion"].append(m["confusion"].cpu().numpy())
            out["states"].append({k: v.detach().to("cpu", copy=True)
                                  for k, v in
                                  state.model.state_dict().items()})
    finally:
        segnets._discrete_crf_idx = own
    return out


def bn_scenario(mesh, spec: dict) -> dict:
    """A train-mode MaskedBatchNorm with a mask on this rank's rows: its
    output, the gradients of a fixed linear loss, and the running
    statistics."""
    bn = MaskedBatchNorm(spec["x"].shape[-1])
    with torch.no_grad():
        bn.scale.copy_(_t(spec["scale"]))
        bn.bias.copy_(_t(spec["bias"]))
    x = _t(_rows(spec["x"], mesh)).requires_grad_(True)
    mask = _t(_rows(spec["mask"], mesh))
    with data_parallel(mesh):
        y = bn(x, mask)
        (y * _t(_rows(spec["probe"], mesh))).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dscale": bn.scale.grad,
            "dbias": bn.bias.grad, "mean": bn.mean, "var": bn.var}


def global_batch_scenario(mesh, spec: dict) -> dict:
    """``make_global_batch`` on shards of equal shapes (returned as they
    are) and of unequal ones (rank r with 8 + r points: raises on every
    rank)."""
    def batch(n):
        return RawBatch(pos=torch.zeros(1, n, 3), x=torch.zeros(1, n, 6))

    same = batch(8)
    out = {"same": make_global_batch(same, mesh) is same}
    try:
        make_global_batch(batch(8 + mesh.rank), mesh)
        out["unequal_raised"] = False
    except ValueError:
        out["unequal_raised"] = True
    return out


def trainer_scenario(mesh, spec: dict) -> dict:
    """A Trainer on ``n_devices = world`` for ``spec["cfg"]["epochs"]``
    epochs,
    then a second one resumed from the first epoch's checkpoint that runs
    the rest and the labeled vote test: each rank's step losses, the
    checkpoints it saved, its epoch length, both runs' final states, the
    vote's scores and accumulators."""
    from crfconv_tpu_torch.train import trainer as trainer_mod
    from crfconv_tpu_torch.train.config import S3DISConfig

    def make():
        cfg = S3DISConfig(**spec["cfg"])
        t = trainer_mod.Trainer(cfg, seed=0, device="cpu",
                                n_devices=mesh.world)
        t.losses, t.saves = [], []
        step, save = t._train_step, t.ckpt.save

        def rec(state, batch, rng):
            m = step(state, batch, rng)
            t.losses.append(float(m["loss"]))
            return m

        def rec_save(*a, **kw):
            t.saves.append(kw.get("step"))
            return save(*a, **kw)

        t._train_step, t.ckpt.save = rec, rec_save
        return t

    t = make()
    best = t.train()
    first = os.path.join(t.ckpt.directory,
                         t.ckpt._load_meta()["checkpoints"][0]["name"])
    r = make()
    start = r.resume(first)
    r.train()
    votes = r.test_labeled(num_votes=2)
    return {"losses": t.losses, "saves": t.saves, "best": best,
            "epoch_len": len(t.train_loader), "start": start,
            "resumed": r.losses,
            "state": t.model.state_dict(),
            "resumed_state": r.model.state_dict(),
            "votes": votes, "test_probs": r.test_probs}


SCENARIOS = {"step": step_scenario, "bn": bn_scenario,
             "global_batch": global_batch_scenario,
             "trainer": trainer_scenario}


def run_scenarios(mesh, specs: dict) -> dict:
    """Every scenario of ``specs`` ({name: spec with its "kind"}) on this
    rank, one torch thread a rank."""
    torch.set_num_threads(1)
    return {name: SCENARIOS[spec["kind"]](mesh, spec)
            for name, spec in specs.items()}

"""What each rank of the point-sharded CPU tests runs (no tests here).

``tests/test_torch_spatial.py`` spawns the ranks of a point group through
``crfconv_tpu_torch.parallel.launch`` with :func:`run_scenarios`, which
runs every scenario of its spec on the rank's span of each global batch
and returns the results (numpy). The same functions with ``mesh=None``
give the one-process port on the whole batch. This module imports torch
and the port only, so a spawned rank starts without JAX.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from crfconv_tpu_torch.data.batch import PointBatch, ScaleData
from crfconv_tpu_torch.models import get_model
from crfconv_tpu_torch.ops import conv, crf_sim
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.parallel import (
    all_gather_points, build_pyramid_windowed_spatial,
    crf_mean_field_spatial, exchange_halo, forward_spatial,
    make_spatial_forward,
    make_spatial_mesh, make_spatial_train_step, replicate, shard_points,
)
from crfconv_tpu_torch.parallel.spatial_forward import (
    _all_gather_replicated, choose_sharded_scales,
)
from crfconv_tpu_torch.train.train_state import TrainState, make_train_step


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _mode(spec) -> NeighborMode:
    return NeighborMode("windowed", **spec.get("mode", {}))


@contextlib.contextmanager
def fused_rows(spec):
    """The fused conv's and similarity's least row counts of the spec (the
    unsharded and the sharded forwards then take the same routes)."""
    rows = spec.get("fused_min_rows")
    if rows is None:
        yield
        return
    saved = conv.FUSED_MIN_ROWS, crf_sim.SIM_MIN_ROWS
    conv.FUSED_MIN_ROWS = crf_sim.SIM_MIN_ROWS = rows
    try:
        yield
    finally:
        conv.FUSED_MIN_ROWS, crf_sim.SIM_MIN_ROWS = saved


def make_batch(spec: dict, dev=None, dtype=None) -> PointBatch:
    """The global PointBatch of a spec (features, labels, the scales; its
    floats in ``dtype`` where one is given)."""
    def t(a):
        if a is None:
            return None
        a = _t(a).to(dev or "cpu")
        return a.to(dtype) if dtype is not None and a.is_floating_point() \
            else a

    y = t(spec.get("y"))
    return PointBatch(
        x=t(spec["x"]), y=None if y is None else y.long(),
        scales=tuple(ScaleData(*map(t, s)) for s in spec["scales"]))


def _model(spec, dev):
    model = get_model(spec["model"], device=dev, **spec["model_kw"])
    if spec.get("state") is not None:
        model.load_state_dict({k: _t(v) for k, v in spec["state"].items()})
    return model


def forward_scenario(mesh, spec: dict):
    """The eval forward of a model on the spec's batch: this rank's rows of
    its output under ``mesh`` (point-sharded; the whole, gathered by
    ``forward_spatial``, where ``spec["whole"]``), the whole output
    without."""
    dev = "cpu" if mesh is None else mesh.device
    model = _model(spec, dev)
    mode = _mode(spec)
    batch = make_batch(spec["batch"], dev)
    with fused_rows(spec):
        if mesh is None:
            model.eval()
            with torch.no_grad():
                return model(batch, mode)
        if spec.get("whole"):
            return {"out": forward_spatial(model, batch, mesh, mode)}
        fn, info = make_spatial_forward(model, mesh, batch, mode)
        out = fn(shard_points(batch, mesh, set(info["sharded_scales"]),
                              mode.tile, mode.pad))
    return {"out": out, "sharded": info["sharded_scales"]}


def build_scenario(mesh, spec: dict):
    """The windowed pyramid of the spec's sorted positions and offsets:
    this rank's part of the point-sharded build, or the whole one."""
    mode = _mode(spec)
    dev = "cpu" if mesh is None else mesh.device
    pos = _t(spec["pos"]).to(dev)
    gen = None
    if spec.get("offsets") is None:
        gen = torch.Generator(device=dev).manual_seed(spec.get("seed", 0))
    kw = dict(k_up=spec.get("k_up", 1), offsets=spec.get("offsets"),
              generator=gen)
    if mesh is None:
        # the unsharded builder sorts; the positions are sorted already
        _, scales = build_pyramid_windowed(
            pos, tile=mode.tile, pad=mode.pad, knn_exact=mode.knn_exact,
            device=dev, **kw)
        return [list(s) for s in scales]
    scales = build_pyramid_windowed_spatial(pos, mesh, mode=mode, **kw)
    return [list(s) for s in scales]


def crf_scenario(mesh, spec: dict):
    """``crf_mean_field_spatial`` on this rank's span of (z, s, idx), or
    the unsharded ``crf_mean_field`` on the whole."""
    from crfconv_tpu_torch.ops.crf import crf_mean_field

    mode = _mode(spec)
    z, s, idx, c = (_t(spec[k]) for k in ("z", "s", "idx", "c"))
    if mesh is None:
        return crf_mean_field(z, s, idx, c, spec["steps"], mode)
    n = z.shape[1] // mesh.world
    span = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return crf_mean_field_spatial(
        z[:, span], s[:, span], idx[:, span].contiguous(), c, mesh,
        spec["steps"], mode, halo_steps=spec.get("halo_steps"))


def exchange_scenario(mesh, spec: dict):
    """``exchange_halo`` and the replicated all-gather of a known tensor,
    forward and backward (the gradient of sum(w * out)), on the rank's
    device."""
    x = _t(spec["x"]).to(mesh.device)
    n = x.shape[1] // mesh.world
    xl = x[:, mesh.rank * n:(mesh.rank + 1) * n].clone().requires_grad_(True)
    h = spec["h"]
    e = exchange_halo(xl, h, mesh)
    w = torch.arange(e.numel(), dtype=x.dtype,
                     device=x.device).reshape(e.shape)
    (e * w).sum().backward()
    xg = x[:, mesh.rank * n:(mesh.rank + 1) * n].clone().requires_grad_(True)
    g = _all_gather_replicated(xg, mesh)
    wg = torch.arange(g.numel(), dtype=x.dtype,
                      device=x.device).reshape(g.shape) * (1 + mesh.rank)
    (g * wg).sum().backward()
    return {"ext": e.detach(), "grad": xl.grad, "gathered": g.detach(),
            "gather_grad": xg.grad}


def step_scenario(mesh, spec: dict) -> dict:
    """``spec["steps"]`` train steps of a fresh model from
    ``spec["state"]`` on the spec's built batch (in float64 where
    ``spec["float64"]``): the point-sharded step on this rank's part (over
    a data x points mesh where ``spec["grid"]`` gives one), or the
    one-process step on the whole; the losses, confusions and the state
    after each step."""
    dev = "cpu" if mesh is None else mesh.device
    dtype = torch.float64 if spec.get("float64") else None
    model = _model(spec, dev)
    if dtype is not None:
        model = model.to(dtype)
    state = TrainState.create(model, lr=spec.get("lr", 0.05),
                              steps_per_epoch=10)
    mode = _mode(spec)
    batch = make_batch(spec["batch"], dev, dtype)
    if mesh is None:
        step = make_train_step(mode, None, spec.get("ignore_index", -1),
                               windowed=False,
                               label_offset=spec.get("label_offset", 0))
    else:
        if spec.get("grid"):
            mesh = make_spatial_mesh(*spec["grid"], mesh=mesh)
        replicate(state, mesh if spec.get("grid") is None else mesh.world)
        step = make_spatial_train_step(
            mesh, batch, mode, None, spec.get("ignore_index", -1),
            spec.get("label_offset", 0))
        batch = shard_points(batch, mesh, set(step.sharded_scales),
                             mode.tile, mode.pad)
    out = {"loss": [], "confusion": [], "states": []}
    for i in range(spec["steps"]):
        gen = torch.Generator(device=dev).manual_seed(spec.get("seed", 0)
                                                      + i)
        m = step(state, batch, gen)
        out["loss"].append(float(m["loss"]))
        out["confusion"].append(m["confusion"].cpu().numpy())
        out["states"].append({k: v.detach().to("cpu", copy=True)
                              for k, v in state.model.state_dict().items()})
    return out


def predict_scenario(mesh, spec: dict):
    """``Predictor(mesh=...)`` (or the one-device Predictor) on a raw
    request: the scores in the input order."""
    from crfconv_tpu_torch.serve import Predictor

    dev = "cpu" if mesh is None else mesh.device
    model = _model(spec, dev)
    kw = {} if mesh is None else {"mesh": mesh}
    pred = Predictor(model, _mode(spec), device=dev, seed=spec["seed"],
                     **kw)
    with fused_rows(spec):
        return pred.predict_logits(_t(spec["pos"]), _t(spec["feats"]))


def trainer_scenario(mesh, spec: dict) -> dict:
    """A Trainer on ``spec["cfg"]`` (its ``spatial_mesh`` on these ranks,
    or one process): each step's loss and the final state."""
    from crfconv_tpu_torch.train import trainer as trainer_mod
    from crfconv_tpu_torch.train.config import S3DISConfig

    cfg = S3DISConfig(**spec["cfg"])
    if mesh is None:
        cfg.spatial_mesh = None
    t = trainer_mod.Trainer(cfg, seed=0, device="cpu")
    t.losses = []
    step = t._train_step

    def rec(state, batch, rng):
        m = step(state, batch, rng)
        t.losses.append(float(m["loss"]))
        return m

    t._train_step = rec
    best = t.train()
    return {"losses": t.losses, "best": best,
            "state": t.model.state_dict(),
            "ckpt_files": sorted(os.listdir(t.ckpt.directory))
            if os.path.isdir(t.ckpt.directory) else []}


def raises_scenario(mesh, spec: dict) -> dict:
    """The raises: a policy that shards nothing, and a point-sharded
    forward asked for a card this rank lacks."""
    out = {}
    lengths = set(spec["lengths"])
    try:
        make_spatial_train_step(mesh, lengths)
        out["no_scale"] = None
    except ValueError as e:
        out["no_scale"] = str(e)
    out["policy"] = sorted(choose_sharded_scales(lengths, mesh.world, 64,
                                                 128))
    return out


def gather_scenario(mesh, spec: dict):
    """``all_gather_points`` of this rank's rows of a known tensor."""
    x = _t(spec["x"]).to(mesh.device)
    n = x.shape[1] // mesh.world
    return all_gather_points(x[:, mesh.rank * n:(mesh.rank + 1) * n], mesh)


SCENARIOS = {"forward": forward_scenario, "build": build_scenario,
             "crf": crf_scenario, "exchange": exchange_scenario,
             "step": step_scenario, "predict": predict_scenario,
             "trainer": trainer_scenario, "raises": raises_scenario,
             "gather": gather_scenario}


def run_scenarios(mesh, specs: dict) -> dict:
    """Every scenario of ``specs`` ({name: spec with its "kind"}) on this
    rank, one torch thread a rank."""
    torch.set_num_threads(1)
    return {name: SCENARIOS[spec["kind"]](mesh, spec)
            for name, spec in specs.items()}

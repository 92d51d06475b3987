"""Runs one cell of ``BENCHMARK.json`` once: set-up, a measured window, an
optional traced pass, and the comparison with the plain reference.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the mix's ``loop`` names the module of
``mixes/`` that drives the window. This module holds what the loops
share: the weights (on the device, in one call), the rooms, their
transforms and point orders, and the subsampling offsets, all drawn from
the seed, and the result line. Each per-layer metric is read by
``metrics/<name>.py``, or, where there is none, by the reader of its name
before the first dot (``metrics/mfu.py`` reads ``mfu.serve`` and
``mfu.train``). The program under test is ``crfconv_tpu_torch``; the
reference is ``reference/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import checks, rooms

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "crfconv_tpu")
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    ref: object
    loop: object
    end_to_end: list
    per_layer: list
    limits: dict


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, overrides: dict = None,
              mix_overrides: dict = None) -> Cell:
    """The cell ``name``; ``overrides`` and ``mix_overrides`` replace keys
    of its configuration and traffic mix (the tests' small sizes on the
    CPU)."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = {**json.loads((root / conf["file"]).read_text()),
           **(overrides or {})}
    mix, loop = load_mix(w["traffic"], mix_overrides)
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = (json.loads(limits_file.read_text())
              if limits_file.exists() else {})
    return Cell(name, cfg, mix, ref, loop,
                [m for m in manifest["end_to_end"] if reports(m, name)],
                [m for m in manifest["per_layer"] if reports(m, name)],
                limits)


def load_mix(name: str, overrides: dict = None):
    """(the traffic mix ``name`` with ``overrides``, its loop module). A
    key that the loop does not read, or one it reads and the file lacks,
    is refused."""
    mix = {**json.loads((BENCH / "traffic" / f"{name}.json").read_text()),
           **(overrides or {})}
    loop = importlib.import_module(f"portbench.mixes.{mix['loop']}")
    unread = set(mix) - set(loop.PARAMS) - {"loop", "why"}
    lacking = set(loop.PARAMS) - set(mix)
    if unread or lacking:
        raise SystemExit(f"traffic {name!r}: keys {sorted(unread)} are not "
                         f"read by loop {mix['loop']!r}, keys "
                         f"{sorted(lacking)} are missing")
    return mix, loop


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def subseed(seed: int, k: int) -> int:
    """A 63-bit seed of its own for each use ``k`` of the run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 63), k])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if is_cuda(device):
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def reset_peak(device) -> None:
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


# --------------------------------------------------------------------------
# weights and inputs
# --------------------------------------------------------------------------


def make_weights(spec, seed: int, device) -> dict:
    """Every leaf of ``spec`` from one uniform draw on the device:
    Linear weights and biases U(+-1/sqrt(fan_in)), batch-norm scales
    0.8-1.2, biases and running means +-0.1, running variances 0.5-1.5,
    CRF compatibilities I + U(+-0.2/sqrt(h))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    u = torch.rand(total, generator=gen, device=device)
    fan = {}
    for name, shape, kind in spec:
        if kind == "weight":
            fan[name.rsplit(".", 1)[0]] = shape[1]
    W, o = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        v = u[o:o + n].view(shape)
        o += n
        sym = 2.0 * v - 1.0
        if kind in ("weight", "bias"):
            v = sym / math.sqrt(fan[name.rsplit(".", 1)[0]])
        elif kind == "bn_scale":
            v = 0.8 + 0.4 * v
        elif kind in ("bn_bias", "bn_mean"):
            v = 0.1 * sym
        elif kind == "bn_var":
            v = 0.5 + v
        elif kind == "compat":
            v = torch.eye(shape[0], device=device) + 0.2 * sym / math.sqrt(
                shape[0])
        W[name] = v.clone()
    return W


def program_model(cfg, W: dict, device):
    """The program's model of the configuration, with the weights ``W``
    copied in (every leaf by name)."""
    import crfconv_tpu_torch as port

    model = getattr(port, cfg["model"])(**cfg["model_args"], device=device)
    model.load_state_dict(W, strict=True)
    return model


def _rotations(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def make_pool(cfg, mix, seed: int, device):
    """``mix["pool"]`` distinct batches of ``batch_size`` clouds of
    ``sample_num`` points: cloud b of batch p is room (p * B + b) mod
    ``mix["rooms"]``, turned about z by an angle and put in a point order
    drawn from the seed. Returns [(pos, feats, labels, offsets)], tensors
    on ``device``; ``offsets`` holds each scale's subsampling offsets."""
    B, N, C = cfg["batch_size"], cfg["sample_num"], cfg["in_channels"]
    pos, feats, labels = rooms.make_clouds(
        subseed(seed, 1), mix["rooms"], N, C, cfg["num_classes"],
        cfg["label_offset"])
    pos = torch.as_tensor(pos, device=device)
    feats = torch.as_tensor(feats, device=device)
    labels = torch.as_tensor(labels, device=device)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 2))
    pool = []
    for p in range(mix["pool"]):
        idx = (p * B + torch.arange(B, device=device)) % mix["rooms"]
        theta = 2 * math.pi * torch.rand(B, generator=gen, device=device)
        perm = torch.argsort(torch.rand(B, N, generator=gen, device=device),
                             dim=1)
        P = torch.take_along_dim(pos[idx], perm[..., None], dim=1)
        P = P @ _rotations(theta).transpose(1, 2)
        X = torch.take_along_dim(feats[idx], perm[..., None], dim=1)
        if C >= 6:
            X[..., 3:6] = P - P.mean(dim=1, keepdim=True)
        Y = torch.take_along_dim(labels[idx], perm, dim=1)
        offsets, n = [], N
        for r in cfg["ratios"]:
            keep = max(n // r, 1)
            offsets.append(torch.randint(0, r, (keep,), generator=gen,
                                         device=device))
            n = keep
        pool.append((P.contiguous(), X.contiguous(), Y.contiguous(),
                     offsets))
    return pool


def checked_entries(seed: int, pool: int, k: int) -> list:
    """The pool entries whose last served request is compared."""
    rng = np.random.default_rng(subseed(seed, 3))
    return sorted(int(i) for i in rng.choice(pool, k, replace=False))


def set_precision(cfg) -> None:
    """Run the program as the configuration states its precision."""
    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class Phases:
    """Set-up's phases on the host clock, printed to standard error."""

    def __init__(self, t_start: float):
        self.t = t_start
        self.mark("start, imports and kernel libraries")

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        print(f"setup {name}: {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def free(device) -> None:
    import gc

    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the result
# --------------------------------------------------------------------------


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or else the reader of the name before its
    first dot."""
    own = BENCH / "metrics" / f"{name}.py"
    return own if own.is_file() else \
        BENCH / "metrics" / f"{name.partition('.')[0]}.py"


def load_reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def result(cell: Cell, out: dict, trace: bool, device) -> dict:
    """The result line: the end-to-end metrics (or, traced, the per-layer
    ones whose readers find something), the device, the breakdown, and
    every number compared with its limit, last."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_reader(m["name"])(out["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": None, "attempted": out["attempted"], "failed": 0,
           "metrics": metrics, "device": info}
    sl = out.get("readings") and out["readings"].slice
    if trace and sl:
        info["busy_s"] = sl["busy_s"]
        info["window_s"] = sl["wall_s"]
        res["breakdown"] = {"device_ops": [list(x) for x in sl["device_ops"]],
                            "idle_gaps": [list(x) for x in sl["idle_gaps"]]}
    for k, v in out["checks"].items():
        if k not in cell.limits:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    numbers = {k: {"value": out["checks"].get(k, math.inf), "limit": lim}
               for k, lim in cell.limits.items()}
    res["correct"] = checks.verdict(numbers)
    res["checks"] = numbers
    return res


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None, overrides: dict = None,
        mix_overrides: dict = None) -> dict:
    """One run of cell ``name`` and its result line; ``t_start`` is when
    the process started (set-up is counted from it)."""
    cell, out = measure(name, seed, seconds, trace, device, t_start,
                        overrides, mix_overrides)
    return result(cell, out, trace, device)


def measure(name: str, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: float = None, overrides: dict = None,
            mix_overrides: dict = None):
    """(the cell, what its loop measured and every number it compared)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, overrides=overrides,
                     mix_overrides=mix_overrides)
    set_precision(cell.cfg)
    if is_cuda(device):
        # every missing kernel library at once (nvcc in parallel), into the
        # package's build directory inside the checkout
        from crfconv_tpu_torch import cuda_build

        cuda_build.build()
    out = cell.loop.run(cell, seed, seconds, trace, device, t_start)
    return cell, out


"""Command-line experiment driver.

    python -m crfconv_tpu_torch.train --dataset S3DIS --root /data/S3DIS \
        --mode train --model PointConvBig --use-crf --steps 1

Counterpart of the JAX package's CLI (``crfconv_tpu/train/__main__.py``),
with its flags; every config field can be overridden with ``--set
key=value`` (a tuple field as comma-separated values). ``--device`` names
the device (default ``cuda``).

``--n-devices N`` trains data-parallel on N ranks of ``--batch-size``
each: under ``torchrun`` (its environment set) this process is one rank
and joins the group; otherwise N ranks are spawned on ``cuda:0`` ..
``cuda:N-1`` (raising where fewer cards are present), or on the CPU with
``--device cpu``. ``--backend`` names the process group's backend (default
``nccl`` on cards, ``gloo`` on the CPU).

``--set spatial_mesh=D,P`` trains point-sharded on D x P ranks (D data
shards, each cloud's points split over P ranks; the windowed regime), as
``--n-devices D*P`` starts them.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from crfconv_tpu_torch.train.config import CONFIGS
from crfconv_tpu_torch.train.trainer import Trainer
from crfconv_tpu_torch.utils.logging import LOGGER, init_logger


def _coerce(value: str, ref, kind: str = None):
    """``value`` as the type of the field's current value ``ref`` (where it
    is None, as the field's annotation ``kind`` names it: a tuple of ints
    from comma-separated values)."""
    if isinstance(ref, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(ref, int):
        return int(value)
    if isinstance(ref, float):
        return float(value)
    if isinstance(ref, tuple):
        return tuple(type(ref[0])(v) for v in value.split(","))
    if ref is None and kind is not None and "Tuple[int" in kind:
        return tuple(int(v) for v in value.split(","))
    return value


def parse(argv=None):
    """(the config, the parsed arguments) of a command line."""
    p = argparse.ArgumentParser(prog="crfconv_tpu_torch.train")
    p.add_argument("--dataset", required=True, choices=sorted(CONFIGS))
    p.add_argument("--root", required=True, help="dataset root directory")
    p.add_argument("--mode", default=None, choices=["train", "test"])
    p.add_argument("--model", default=None, help="model registry name")
    p.add_argument("--use-crf", action="store_true", default=None)
    p.add_argument("--no-crf", dest="use_crf", action="store_false")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one process and device each")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process group backend (default: nccl on cards, "
                   "gloo on the CPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default: cuda)")
    p.add_argument("--log-file", default=None)
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override any config field",
    )
    args = p.parse_args(argv)

    cfg = CONFIGS[args.dataset](root=args.root)
    for name, val in (
        ("mode", args.mode), ("model_name", args.model),
        ("use_crf", args.use_crf), ("steps", args.steps),
        ("epochs", args.epochs), ("batch_size", args.batch_size),
    ):
        if val is not None:
            setattr(cfg, name, val)
    for kv in args.set:
        key, _, value = kv.partition("=")
        if not hasattr(cfg, key):
            raise SystemExit(f"unknown config field {key!r}")
        kind = {f.name: str(f.type)
                for f in dataclasses.fields(cfg)}.get(key)
        setattr(cfg, key, _coerce(value, getattr(cfg, key), kind))
    return cfg, args


def rank_devices(device: str, n: int) -> list:
    """The devices of ``n`` spawned ranks: ``cuda:0`` .. ``cuda:n-1`` for
    a card (raising where fewer are present), else ``device`` n times."""
    import torch

    if torch.device(device).type != "cuda":
        return [device] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"--n-devices {n} needs {n} CUDA devices, this "
                           f"machine has {have}")
    return [f"cuda:{r}" for r in range(n)]


def _run(cfg, args, device, rank: int = 0):
    init_logger(args.log_file if rank == 0 else None, level=logging.INFO)
    trainer = Trainer(cfg, seed=args.seed, device=device,
                      n_devices=args.n_devices)
    result = trainer()
    logging.getLogger(LOGGER).info("done: %s", result)
    return result


def _rank_main(mesh, argv):
    """One spawned rank of ``--n-devices``."""
    cfg, args = parse(argv)
    return _run(cfg, args, mesh.device, mesh.rank)


def main(argv=None):
    """Run the command line ``argv``; returns the trainer's result (the
    best val mIoU in train mode, the vote test's scores in test mode; rank
    0's where ranks were spawned)."""
    import torch.distributed as dist

    from crfconv_tpu_torch.parallel import launch, make_mesh

    cfg, args = parse(argv)
    n = args.n_devices
    if n is None and getattr(cfg, "spatial_mesh", None):
        n = int(cfg.spatial_mesh[0]) * int(cfg.spatial_mesh[1])
        args.n_devices = n
    if n is None or n <= 1 or dist.is_initialized():
        return _run(cfg, args, args.device)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:   # torchrun
        mesh = make_mesh(n, backend=args.backend,
                         device="cpu" if args.device == "cpu" else None)
        return _run(cfg, args, mesh.device, mesh.rank)
    return launch(_rank_main, n, rank_devices(args.device, n), args.backend,
                  args=(argv,))[0]


if __name__ == "__main__":
    main()

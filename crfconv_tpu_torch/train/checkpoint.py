"""Checkpoints of the full train state.

Counterpart of ``crfconv_tpu/train/checkpoint.py``: model, optimizer,
scheduler and step written with ``torch.save``, atomically (a temporary
file, then ``os.replace``) so an interrupted save never corrupts the
latest checkpoint; the best checkpoint by metric (higher is better, a tie
does not replace it) and the newest ``keep`` are retained. A checkpoint may
carry an aux sidecar ``<ckpt>.aux.pkl``: host state (the sampler's arrays,
the loader's and trainer's generator states, the epoch) pickled, as the
JAX package writes it, since ``torch.load(weights_only=True)``, which reads
the model's state, refuses numpy arrays.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Optional

import torch

from crfconv_tpu_torch.train.train_state import TrainState

BEST = "ckpt_best.pt"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _meta_path(self) -> str:
        return os.path.join(self.directory, "checkpoints.json")

    def _load_meta(self) -> dict:
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                return json.load(f)
        return {"checkpoints": [], "best": None}

    def _store_meta(self, meta: dict) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, self._meta_path())

    def save(
        self, state: TrainState, step: int, metric: Optional[float] = None,
        aux: Optional[dict] = None,
    ) -> str:
        """Write a checkpoint of ``state``, and ``aux`` beside it as its
        sidecar (atomically too); track the best by ``metric`` (strictly
        higher replaces it); prune beyond ``keep`` (the best is always
        retained), sidecars with their checkpoints. Returns the
        checkpoint's path."""
        name = f"ckpt_{step:08d}.pt"
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        if aux is not None:
            apath = path + ".aux.pkl"
            with open(apath + ".tmp", "wb") as f:
                pickle.dump(aux, f)
            os.replace(apath + ".tmp", apath)

        meta = self._load_meta()
        meta["checkpoints"].append({"name": name, "step": step,
                                    "metric": metric})
        if metric is not None and (
            meta["best"] is None or metric > meta["best"]["metric"]
        ):
            meta["best"] = {"name": name, "step": step, "metric": metric}
            best_tmp = os.path.join(self.directory, BEST + ".tmp")
            shutil.copyfile(path, best_tmp)
            os.replace(best_tmp, os.path.join(self.directory, BEST))
        while len(meta["checkpoints"]) > self.keep:
            victim = meta["checkpoints"].pop(0)
            if meta["best"] and victim["name"] == meta["best"]["name"]:
                continue
            vp = os.path.join(self.directory, victim["name"])
            for f in (vp, vp + ".aux.pkl"):
                if os.path.exists(f):
                    os.remove(f)
        self._store_meta(meta)
        return path

    def latest_path(self) -> Optional[str]:
        meta = self._load_meta()
        if not meta["checkpoints"]:
            return None
        return os.path.join(self.directory, meta["checkpoints"][-1]["name"])

    def best_path(self) -> Optional[str]:
        p = os.path.join(self.directory, BEST)
        return p if os.path.exists(p) else None

    def restore(self, state: TrainState, path: Optional[str] = None) -> TrainState:
        """Load a checkpoint (default: the latest) into ``state``, whose
        model lies on the device the tensors are loaded to."""
        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        state.load_state_dict(
            torch.load(path, map_location=device, weights_only=True)
        )
        return state

    def restore_aux(self, path: Optional[str] = None) -> Optional[dict]:
        """The aux sidecar of a checkpoint (default: the latest), or None
        if it has none."""
        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        apath = path + ".aux.pkl"
        if not os.path.exists(apath):
            return None
        with open(apath, "rb") as f:
            return pickle.load(f)

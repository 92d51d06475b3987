"""S3DIS Area-5 mIoU parity harness (BASELINE.json: ±0.3 points).

Counterpart of ``crfconv_tpu/parity/__init__.py``. One command trains both
arms on the same room pipeline, runs the labeled vote test of each and
prints the full-cloud mIoU delta:

  * the port arm: the port's flagship through
    ``crfconv_tpu_torch.train.Trainer`` (its kernels on the card);
  * the torch arm: the oracle (``parity/oracle.py``), a plain-PyTorch
    re-execution of the reference recipe (trainval.py:21-155 and
    test_s3dis :218-327), fed by the port's loader with the host pyramid.

    python -m crfconv_tpu_torch.parity --root /data/S3DIS [--epochs 100]

Both arms run on ``device`` ("cuda" by default). ``--dry-run`` writes a
tiny synthetic raw corpus and runs the whole harness in minutes;
``--corpus rooms`` runs it at scale on the structured synthetic corpus
(``parity/synthetic.py``).

Departures from the JAX harness: the arm it names ``jax`` is ``port`` here
(``CRFCONV_PARITY_ARM=port``, ``parity_port.json``, ``port_full_mIoU``);
under the plateau protocol the torch arm keeps the first of tied best
epochs, as the Trainer's checkpoint manager does (JAX's torch arm keeps
the last); the port arm starts from an empty checkpoint directory, so a
rerun in the same root never votes with an earlier run's best; each arm's
result carries its wall time (``wall_s``) and the report its ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from crfconv_tpu_torch.utils.logging import LOGGER

log = logging.getLogger(LOGGER)

MIOU_TOLERANCE = 0.003  # ±0.3 mIoU points (BASELINE.json north star)
ARMS = ("both", "port", "torch")


def run_torch_reference(cfg, dataset, seed: int = 0, num_votes: int = 100,
                        device="cuda"):
    """Train and vote-test the oracle with the reference recipe on
    ``device``: SGD(momentum 0.95, wd 1e-4) with a per-epoch
    ExponentialLR(gamma), weighted CE (trainval.py:69-73, :101-104), the
    vote smoothed by 0.95 with the labeled eval's projection (test_s3dis).
    The weights are drawn as ``torch.manual_seed(seed)`` draws them,
    without touching the caller's generator."""
    import torch.nn.functional as F

    from crfconv_tpu_torch.data import transforms as T
    from crfconv_tpu_torch.data.loader import MultiscaleLoader
    from crfconv_tpu_torch.parity.oracle import TorchPointConvResNet
    from crfconv_tpu_torch.train import metrics
    from crfconv_tpu_torch.train.vote import labeled_vote_eval

    device = torch.device(device)
    loader_kw = dict(kernel_sizes=cfg.kernel_sizes, ratios=cfg.ratios,
                     k_up=cfg.k_up, device=device)
    train_loader = MultiscaleLoader(
        dataset.train_set, cfg.batch_size,
        transform=T.default_train_transform(), seed=seed, **loader_kw)
    val_loader = MultiscaleLoader(
        dataset.test_set, cfg.batch_size,
        transform=T.default_test_transform(), seed=seed + 1, **loader_kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TorchPointConvResNet(
            6, cfg.num_classes, use_crf=cfg.use_crf, steps=cfg.steps)
    model.to(device)
    opt = torch.optim.SGD(
        model.parameters(), lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay,
    )
    sched = torch.optim.lr_scheduler.ExponentialLR(opt, gamma=cfg.gamma)
    cw = cfg.class_weights
    cw = None if cw is None else torch.as_tensor(
        np.asarray(cw, np.float32), device=device)

    def inputs(batch):
        return batch.x, [s._asdict() for s in batch.scales]

    patience = getattr(cfg, "early_stop_patience", None)
    best_miou, best_state, since_best = -1.0, None, 0
    for epoch in range(cfg.epochs):
        model.train()
        tot, n = 0.0, 0
        for batch in train_loader:
            logits = model(*inputs(batch))
            y = (batch.y - cfg.label_offset).reshape(-1)
            loss = F.cross_entropy(
                logits.reshape(-1, cfg.num_classes), y, weight=cw,
                ignore_index=cfg.ignore_index,
            )
            opt.zero_grad()
            loss.backward()
            opt.step()
            tot, n = tot + float(loss.detach()), n + 1
        sched.step()
        if patience is None:
            log.info("torch epoch %d: loss=%.4f", epoch, tot / max(n, 1))
            continue
        # the plateau: a val mIoU an epoch, the best state kept, a stop
        # after `patience` epochs without a better one
        model.eval()
        score = metrics.RunningScore(cfg.num_classes, cfg.ignore_index)
        with torch.no_grad():
            for batch in val_loader:
                pred = model(*inputs(batch)).argmax(-1).reshape(-1)
                score.update(
                    (batch.y - cfg.label_offset).reshape(-1).cpu().numpy(),
                    pred.cpu().numpy())
        miou = score.get_scores()[0]["Mean IoU"]
        log.info(
            "torch epoch %d: loss=%.4f val mIoU=%.2f%%",
            epoch, tot / max(n, 1), miou * 100,
        )
        if miou >= best_miou:
            # a tie resets patience, as the Trainer's loop does, and keeps
            # the first tied best, as its checkpoint manager does
            since_best = 0
            if miou > best_miou:
                best_miou = miou
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
        else:
            since_best += 1
            if since_best >= patience:
                log.info("torch early stop at epoch %d", epoch)
                break
    if best_state is not None:
        model.load_state_dict(best_state)

    # labeled vote test, the reference's semantics
    model.eval()
    ds = dataset.test_set
    test_probs = [
        np.zeros((c.shape[0], cfg.num_classes), np.float32)
        for c in ds.input_points
    ]

    def vote_epoch():
        with torch.no_grad():
            for batch in val_loader:
                x, scales = inputs(batch)
                probs = torch.softmax(model(x, scales), dim=-1)
                probs = probs.reshape(
                    x.shape[0], -1, cfg.num_classes).cpu().numpy()
                p_idx = batch.point_idx.cpu().numpy()
                c_idx = batch.cloud_idx.cpu().numpy().reshape(-1)
                for b in range(probs.shape[0]):
                    c = int(c_idx[b])
                    test_probs[c][p_idx[b]] = (
                        cfg.test_smooth * test_probs[c][p_idx[b]]
                        + (1 - cfg.test_smooth) * probs[b]
                    )

    return labeled_vote_eval(ds, vote_epoch, test_probs, num_votes)


def make_synthetic_raw(root: str, n_rooms: int = 2, n_pts: int = 500):
    """Tiny synthetic S3DIS raw corpus (the layout the dataset's reader
    consumes) for the --dry-run harness check."""
    rng = np.random.default_rng(0)
    raw = os.path.join(root, "raw")
    data_dir = os.path.join(raw, "Stanford3dDataset_v1.2_Aligned_Version")
    for area in (1, 5):
        rels = []
        for r in range(n_rooms):
            rel = f"Area_{area}/office_{r}/Annotations"
            anno = os.path.join(data_dir, rel)
            os.makedirs(anno, exist_ok=True)
            for cls in ("wall_1", "floor_1", "chair_1"):
                pts = np.column_stack([
                    rng.random((n_pts, 3)) * 3,
                    rng.integers(0, 255, (n_pts, 3)),
                ])
                np.savetxt(os.path.join(anno, cls + ".txt"), pts, fmt="%.4f")
            rels.append(rel)
        with open(os.path.join(raw, f"Area_{area}_anno.txt"), "w") as f:
            f.write("\n".join(rels) + "\n")


def _run_port(cfg, dataset, seed: int, num_votes: int, device) -> dict:
    """The port arm: the Trainer trained, under the plateau protocol
    restored to its best checkpoint, then vote-tested."""
    from crfconv_tpu_torch.train import trainer as trainer_mod

    # an earlier run's checkpoints (<root>/ckpt) would compete for "best"
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    trainer = trainer_mod.Trainer(cfg, dataset=dataset, seed=seed,
                                  device=device)
    trainer.train()
    if cfg.early_stop_patience is not None:
        # the plateau protocol: vote with the best val state (the torch
        # arm restores its best state_dict alike)
        best = trainer.ckpt.best_path()
        if best is not None:
            trainer.load(best)
    return trainer.test_labeled(num_votes)


def run_parity(
    root: str,
    epochs: Optional[int] = None,
    num_votes: int = 100,
    seed: int = 0,
    dry_run: bool = False,
    out: Optional[str] = None,
    corpus: Optional[str] = None,
    rooms_per_area: int = 8,
    pts_per_room: int = 80_000,
    patience: Optional[int] = None,
    scale_kw: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Train and vote-test both arms on S3DIS Area 5; return the report.

    ``corpus='rooms'`` runs the harness at scale on the structured
    synthetic corpus (parity/synthetic.py, written under ``root`` unless
    ``root/raw`` exists): over 1M raw points of room geometry with S3DIS's
    13 classes, both arms trained to an early-stopped plateau
    (``patience``) and restored to their best val state before the vote
    test. ``scale_kw`` overrides config fields (sample_num, batch_size,
    train_samples_per_epoch, neighbor_regime, ...).

    ``CRFCONV_PARITY_ARM`` picks the arms: ``both`` (the default) runs
    them in turn; ``port`` or ``torch`` runs one and writes its result to
    ``<root>/parity_<arm>.json``, so the arms can run as separate calls:
    the report is assembled once both files exist (else the one arm's
    result is returned, with the other ``pending``).
    """
    from crfconv_tpu_torch.data import datasets as D
    from crfconv_tpu_torch.parity.synthetic import make_synthetic_rooms
    from crfconv_tpu_torch.train.config import S3DISConfig

    arm = os.environ.get("CRFCONV_PARITY_ARM", "both")
    if arm not in ARMS:
        raise ValueError(f"CRFCONV_PARITY_ARM must be one of {ARMS}, not "
                         f"{arm!r}")
    if dry_run:
        if corpus == "rooms":
            make_synthetic_rooms(
                root, rooms_per_area=2, pts_per_room=2000, seed=seed
            )
        else:
            make_synthetic_raw(root)
        cfg = S3DISConfig(
            root=root, mode="train", use_crf=True, steps=1, grid_size=0.2,
            sample_num=128, batch_size=2, epochs=epochs or 1,
            train_samples_per_epoch=4, val_samples_per_epoch=2,
            early_stop_patience=patience,
            checkpoint_dir=os.path.join(root, "ckpt"),
        )
        num_votes = min(num_votes, 2)
    elif corpus == "rooms":
        if not os.path.isdir(os.path.join(root, "raw")):
            n = make_synthetic_rooms(
                root, rooms_per_area=rooms_per_area,
                pts_per_room=pts_per_room, seed=seed,
            )
            log.info("generated synthetic room corpus: %d raw points", n)
        cfg = S3DISConfig(
            root=root, mode="train",
            epochs=epochs or 60,
            early_stop_patience=5 if patience is None else patience,
            checkpoint_dir=os.path.join(root, "ckpt"),
            **(scale_kw or {}),
        )
    else:
        cfg = S3DISConfig(root=root, mode="train",
                          checkpoint_dir=os.path.join(root, "ckpt"))
        if epochs is not None:
            cfg = dataclasses.replace(cfg, epochs=epochs)
        if patience is not None:
            cfg = dataclasses.replace(cfg, early_stop_patience=patience)

    def build_dataset():
        # a fresh dataset an arm: each sampler starts from the same state
        return D.S3DISRoomDataset(
            cfg.root, test_area=cfg.test_area, grid_size=cfg.grid_size,
            num_points=cfg.sample_num,
            train_sample_per_epoch=cfg.train_samples_per_epoch,
            test_sample_per_epoch=cfg.val_samples_per_epoch,
        )

    def arm_path(name):
        return os.path.join(root, f"parity_{name}.json")

    def timed(name, fn) -> dict:
        t0 = time.perf_counter()
        res = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        res = {**res, "wall_s": time.perf_counter() - t0}
        log.info("parity: %s arm took %.1f s", name, res["wall_s"])
        with open(arm_path(name), "w") as f:
            json.dump(res, f)
        return res

    results = {}
    if arm in ("both", "port"):
        log.info("parity: training the port's flagship ...")
        results["port"] = timed("port", lambda: _run_port(
            cfg, build_dataset(), seed, num_votes, device))
    if arm in ("both", "torch"):
        log.info("parity: training the torch reference oracle ...")
        results["torch"] = timed("torch", lambda: run_torch_reference(
            cfg, build_dataset(), seed=seed, num_votes=num_votes,
            device=device))
    for name in ("port", "torch"):
        if name in results:
            continue
        if not os.path.exists(arm_path(name)):
            log.info("parity: %s arm pending", name)
            return {**results, "pending": name}
        with open(arm_path(name)) as f:
            results[name] = json.load(f)

    pm = results["port"].get("full_mIoU", float("nan"))
    tm = results["torch"].get("full_mIoU", float("nan"))
    delta = pm - tm
    report = {
        "port_full_mIoU": pm,
        "torch_full_mIoU": tm,
        "delta": delta,
        "tolerance": MIOU_TOLERANCE,
        "within_tolerance": bool(abs(delta) <= MIOU_TOLERANCE),
        "port": results["port"],
        "torch": results["torch"],
        "config": {
            "epochs": cfg.epochs, "sample_num": cfg.sample_num,
            "batch_size": cfg.batch_size, "grid_size": cfg.grid_size,
            "num_votes": num_votes, "dry_run": dry_run,
            "corpus": corpus,
            "early_stop_patience": cfg.early_stop_patience,
            "neighbor_regime": cfg.neighbor_regime,
            "device": str(device),
            **(
                {
                    "rooms_per_area": rooms_per_area,
                    "pts_per_room": pts_per_room,
                }
                if corpus == "rooms" else {}
            ),
        },
    }
    print(json.dumps(
        {k: report[k] for k in (
            "port_full_mIoU", "torch_full_mIoU", "delta",
            "within_tolerance",
        )}
    ))
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    return report

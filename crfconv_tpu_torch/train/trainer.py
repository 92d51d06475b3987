"""Experiment driver: train, validate, and the vote-based test.

Counterpart of ``crfconv_tpu/train/trainer.py`` (reference trainval.py:20-343)
on one device, or data-parallel over the ranks of a process group:

  * epochs of train steps fed by ``MultiscaleLoader`` (raw batches whose
    pyramid the step builds on the device in the windowed regime, host
    pyramids in the exact one), the confusion matrix summed on the device
    and read once an epoch;
  * a validation epoch after each train epoch, the best checkpoint by its
    mIoU, early stopping;
  * preemption-safe checkpoints: SIGTERM/SIGINT stop the loop at a step
    boundary and save; the aux sidecar keeps the loader's and the sampler's
    state and the trainer's generator, so a resumed run draws the stream an
    uninterrupted one would;
  * vote-based full-cloud inference with running-mean probabilities and the
    sub -> full projection (``test``, ``test_labeled``), the ShapeNet
    part-IoU eval (``eval_partseg``).

``n_devices > 1`` trains data-parallel, one rank a process (launched by
``parallel.launch`` or ``torchrun``, the group initialised by
``parallel.make_mesh`` or joined here): rank r loads shard r of the data
and ``cfg.batch_size`` is a rank's batch, as under the JAX package's
``process_count > 1``; the steps run their global form
(``parallel/sharding.py``); the val and vote passes gather every rank's
probabilities, so every rank holds the same vote accumulators and takes
the same decisions; rank 0 writes the checkpoints, whose sidecar keeps
every rank's loader state.

``cfg.spatial_mesh = (d_data, d_pts)`` trains point-sharded on a world of
d_data * d_pts ranks (``parallel.make_spatial_mesh``; windowed regime
only): the d_pts ranks of a point group load the same data shard (of
d_data) and each builds its span of the pyramid
(``parallel.build_windowed_batch_spatial``) and steps through
``parallel.make_spatial_train_step``; validation and the vote passes run
the one-rank eval step, data-parallel over the data group, as the JAX
package evaluates on one device.

Departures from the JAX package: the neighbour regime is passed to the
steps as a :class:`NeighborMode` (there is no process-wide regime); one
``torch.Generator`` on the device stands for the trainer's PRNG key (its
state is in the sidecar); the compute dtype is scoped to the trainer's own
calls; the JAX package's single-process ``n_devices=N`` splits one batch
of ``batch_size`` over N devices, while here each of the N ranks loads
``batch_size`` (under ``spatial_mesh`` each data shard); a data-parallel
vote pass stops once every rank's sampler has covered the clouds (the
smallest of the ranks' minimum possibilities); the point-sharded step
turns the curve with ``curve_jitter`` as the one-rank step does, and
draws its dropout at the global shape (the JAX package's spatial step
does neither).
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from crfconv_tpu_torch.data import transforms as T
from crfconv_tpu_torch.data.batch import slice_batch
from crfconv_tpu_torch.data.loader import (
    MultiscaleLoader, loader_load_state_dict, loader_state_dict,
)
from crfconv_tpu_torch.models import get_model
from crfconv_tpu_torch.models.common import compute_dtype_scope
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.parallel import sharding
from crfconv_tpu_torch.train.checkpoint import CheckpointManager
from crfconv_tpu_torch.train.config import Config
from crfconv_tpu_torch.train.metrics import RunningScore, RunningScoreShapeNet
from crfconv_tpu_torch.train.train_state import (
    TrainState, make_eval_step, make_train_step,
)
from crfconv_tpu_torch.utils.logging import LOGGER

log = logging.getLogger(LOGGER)

# the seed of the vote passes' pyramid generators: pass p draws from a
# generator seeded with VOTE_SEED * 2**32 + p
VOTE_SEED = 17
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class _SplitPair:
    """Train/val holder for datasets without a wrapper class."""

    def __init__(self, train_set, val_set):
        self.train_set = train_set
        self.val_set = val_set


def _build_dataset(cfg: Config):
    from crfconv_tpu_torch.data import datasets as D

    if cfg.dataset == "S3DIS":
        return D.S3DISRoomDataset(
            cfg.root,
            test_area=getattr(cfg, "test_area", 5),
            grid_size=cfg.grid_size,
            num_points=cfg.sample_num,
            train_sample_per_epoch=cfg.train_samples_per_epoch,
            test_sample_per_epoch=cfg.val_samples_per_epoch,
        )
    if cfg.dataset == "Semantic3D":
        return D.Semantic3DWholeDataset(
            cfg.root,
            grid_size=cfg.grid_size,
            num_points=cfg.sample_num,
            train_sample_per_epoch=cfg.train_samples_per_epoch,
            test_sample_per_epoch=cfg.val_samples_per_epoch,
        )
    if cfg.dataset == "ShapeNet":
        return _SplitPair(
            D.ShapeNetNormalDataset(cfg.root, train=True,
                                    num_points=cfg.sample_num),
            D.ShapeNetNormalDataset(cfg.root, train=False,
                                    num_points=cfg.sample_num),
        )
    if cfg.dataset == "ScanNet":
        return _SplitPair(
            D.ScanNetDataset(cfg.root, train=True, num_points=cfg.sample_num,
                             sample_per_epoch=cfg.train_samples_per_epoch),
            D.ScanNetDataset(cfg.root, train=False, num_points=cfg.sample_num,
                             sample_per_epoch=cfg.val_samples_per_epoch),
        )
    if cfg.dataset in ("Paris-Lille-3D", "NPM3D"):
        return _SplitPair(
            D.NPM3DDataset(cfg.root, train=True, num_points=cfg.sample_num,
                           sample_per_epoch=cfg.train_samples_per_epoch),
            D.NPM3DDataset(cfg.root, train=False, num_points=cfg.sample_num,
                           sample_per_epoch=cfg.val_samples_per_epoch),
        )
    if cfg.dataset == "SemanticKITTI":
        return _SplitPair(
            D.SemanticKITTIDataset(
                cfg.root, sequences="train", num_points=cfg.sample_num,
                sample_per_epoch=cfg.train_samples_per_epoch),
            D.SemanticKITTIDataset(
                cfg.root, sequences="val", num_points=cfg.sample_num,
                sample_per_epoch=cfg.val_samples_per_epoch),
        )
    raise ValueError(
        f"no default dataset builder for {cfg.dataset!r}; pass one explicitly"
    )


def _fetch(t: Optional[torch.Tensor], mesh=None) -> Optional[np.ndarray]:
    """A device tensor on the host as numpy (bfloat16 as float32); under a
    data-parallel ``mesh`` every rank's rows, in rank order."""
    if t is None:
        return None
    if mesh is not None:
        t = sharding.all_gather_cat(t, mesh)
    if t.is_floating_point() and t.dtype != torch.float64:
        t = t.float()
    return t.cpu().numpy()


def _join_mesh(n_devices: int, device: torch.device):
    """The data-parallel mesh of a Trainer on ``n_devices`` ranks: the
    initialised process group's, which must have that many ranks."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            f"n_devices={n_devices} trains on that many processes: start "
            "them with crfconv_tpu_torch.parallel.launch or torchrun and "
            "initialise the group (parallel.make_mesh) first")
    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"n_devices={n_devices}, but the process group "
                           f"has {dist.get_world_size()} ranks")
    # a device without an index is the rank's own card
    return sharding.make_mesh(
        n_devices, device=None if device.type == "cuda"
        and device.index is None else device)


def _spatial_mesh(cfg, n_devices: Optional[int], device: torch.device):
    """The (data, points) mesh of ``cfg.spatial_mesh``: the initialised
    process group's ranks (a world of one initialises its own)."""
    if cfg.neighbor_regime != "windowed":
        raise ValueError("spatial_mesh trains point-sharded, which needs "
                         "the windowed neighbour regime")
    d_data, d_pts = (int(v) for v in cfg.spatial_mesh)
    n = d_data * d_pts
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but spatial_mesh "
                         f"{tuple(cfg.spatial_mesh)} has {n} ranks")
    if n > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                f"spatial_mesh {tuple(cfg.spatial_mesh)} trains on {n} "
                "processes: start them with crfconv_tpu_torch.parallel."
                "launch or torchrun and initialise the group "
                "(parallel.make_mesh) first")
        world = _join_mesh(n, device)
    else:
        world = sharding.make_mesh(1, device=device)
    return sharding.make_spatial_mesh(d_data, d_pts, world)


def _batches(loader, mesh):
    """The loader's batches; under a data-parallel ``mesh`` the first one's
    shapes are checked equal on every rank (a loader draws batches of one
    shape, and a step on unequal shards would hang or differ)."""
    for i, batch in enumerate(loader):
        if i == 0 and mesh is not None:
            sharding.make_global_batch(batch, mesh)
        yield batch


class _GlobalCoverage:
    """A trainer's val set whose ``min_possibility`` is the smallest over
    the ranks' samplers, for ``labeled_vote_eval``'s stopping rule."""

    def __init__(self, trainer):
        self._trainer = trainer

    def __getattr__(self, name):
        return getattr(self._trainer.val_set, name)

    @property
    def min_possibility(self) -> float:
        return self._trainer._min_possibility()


class Trainer:
    def __init__(
        self,
        cfg: Config,
        dataset=None,
        seed: int = 0,
        device="cuda",
        n_devices: Optional[int] = None,
    ):
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(COMPUTE_DTYPES)}, not "
                             f"{cfg.compute_dtype!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        # self.world: every rank (None: one process); self.mesh: the ranks
        # that split the data (None: this rank loads all of it)
        self.world = self.mesh = self.spatial = None
        windowed = cfg.neighbor_regime == "windowed"
        if getattr(cfg, "spatial_mesh", None):
            self.spatial = _spatial_mesh(cfg, n_devices, self.device)
            self.world, self.mesh = self.spatial.world, self.spatial.data
            self.device = self.world.device
        elif n_devices is not None and n_devices > 1:
            self.world = self.mesh = _join_mesh(n_devices, self.device)
            self.device = self.mesh.device
        self.dataset = dataset if dataset is not None else _build_dataset(cfg)

        has_rgb = cfg.dataset in ("S3DIS", "Semantic3D")
        train_tf = T.default_train_transform() if has_rgb else None
        test_tf = T.default_test_transform() if has_rgb else None

        train_set = getattr(self.dataset, "train_set", self.dataset)
        val_set = getattr(
            self.dataset, "val_set", getattr(self.dataset, "test_set", None)
        )
        loader_kw = dict(
            kernel_sizes=cfg.kernel_sizes,
            ratios=cfg.ratios,
            k_up=cfg.k_up,
            dilations=cfg.dilations,
            sample_method=cfg.sample_method,
            emit="raw" if windowed else "pyramid",
            device=self.device,
        )
        if self.mesh is not None:
            loader_kw.update(num_shards=self.mesh.world,
                             shard_index=self.mesh.rank)
        self.train_loader = MultiscaleLoader(
            train_set, cfg.batch_size, transform=train_tf, seed=seed,
            **loader_kw,
        )
        self.val_loader = (
            MultiscaleLoader(val_set, cfg.batch_size, transform=test_tf,
                             seed=seed + 1, **loader_kw)
            if val_set is not None else None
        )
        self.val_set = val_set

        # vote accumulators, one per validation cloud
        if val_set is not None and hasattr(val_set, "input_points"):
            self.test_probs = [
                np.zeros((c.shape[0], cfg.num_classes), np.float32)
                for c in val_set.input_points
            ]
        else:
            self.test_probs = None

        # the example batch, as the JAX trainer draws it: from a second
        # loader with the same seed and no prefetch (it shares the dataset,
        # whose sampler it advances, as there), so the train stream matches
        example = next(iter(MultiscaleLoader(
            train_set, cfg.batch_size, transform=train_tf, seed=seed,
            prefetch=0, **loader_kw)))

        model_kw = dict(n_classes=cfg.num_classes,
                        in_channels=int(example.x.shape[-1]),
                        device=self.device,
                        generator=torch.Generator().manual_seed(seed))
        if cfg.model_name in ("PointConvBig", "PointConvResNet"):
            model_kw.update(use_crf=cfg.use_crf, steps=cfg.steps)
            if getattr(cfg, "layers", None):
                model_kw.update(layers=tuple(cfg.layers))
        elif cfg.model_name != "BaselineSegNet":
            model_kw.update(steps=cfg.steps)
        self.model = get_model(cfg.model_name, **model_kw)

        self.state = TrainState.create(
            self.model, lr=cfg.lr, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, gamma=cfg.gamma,
            steps_per_epoch=max(len(self.train_loader), 1),
        )
        if self.world is not None:
            sharding.replicate(self.state, self.world)
        self.mode = (
            NeighborMode("windowed", knn_exact=cfg.windowed_knn_exact)
            if windowed else NeighborMode("exact")
        )
        self._compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        cw = cfg.class_weights
        cw = None if cw is None else torch.as_tensor(cw, device=self.device)
        if self.spatial is not None:
            self._train_step = self._scoped(
                self._make_spatial_mesh_step(cw, example))
        else:
            self._train_step = self._scoped(self._parallel(make_train_step(
                self.mode, cw, cfg.ignore_index, windowed=windowed,
                label_offset=cfg.label_offset,
                curve_jitter=windowed and getattr(cfg, "curve_jitter", False),
            )))
        self._eval_step = self._scoped(self._parallel(make_eval_step(
            self.mode, cw, cfg.ignore_index, label_offset=cfg.label_offset,
            windowed=windowed,
            eval_views=getattr(cfg, "eval_views", 1) if windowed else 1,
        )))

        self.metrics = RunningScore(cfg.num_classes, cfg.ignore_index)
        self.ckpt = CheckpointManager(
            os.path.join(cfg.checkpoint_dir, cfg.prefix)
        )
        # the trainer's generator: each train step's pyramid offsets, curve
        # rotation and dropout mask
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _scope(self):
        """This trainer's compute dtype for the block; the previous one is
        restored afterwards, so it never leaks into other computations."""
        with compute_dtype_scope(self._compute_dtype):
            yield

    def _scoped(self, fn):
        """``fn`` run under :meth:`_scope` at every call."""

        def wrapped(*args, **kwargs):
            with self._scope():
                return fn(*args, **kwargs)

        return wrapped

    def _make_spatial_mesh_step(self, cw, example):
        """The train step of a (data, points) mesh: a RawBatch in, its
        Morton sort, this rank's span of the pyramid built point-sharded
        (the offsets, then the dropout, from the step's generator), the
        point-sharded step. The first batch is checked equal on every rank
        of the point group."""
        from crfconv_tpu_torch.parallel.spatial_build import pyramid_lengths
        from crfconv_tpu_torch.parallel.spatial_train import (
            build_windowed_batch_spatial, check_same_batch,
            make_spatial_train_step,
        )

        cfg = self.cfg
        n = int(example.x.shape[1])
        step = make_spatial_train_step(
            self.spatial, set(pyramid_lengths(n, cfg.ratios)), self.mode,
            cw, cfg.ignore_index, cfg.label_offset)
        checked = []

        def spatial_step(state, raw, rng):
            if not checked:
                check_same_batch(raw, self.spatial)
                checked.append(True)
            batch = build_windowed_batch_spatial(
                raw, self.spatial, rng, mode=self.mode,
                kernel_sizes=cfg.kernel_sizes, ratios=cfg.ratios,
                k_up=cfg.k_up,
                curve_jitter=getattr(cfg, "curve_jitter", False))
            return step(state, batch, rng)

        return spatial_step

    def _parallel(self, step):
        """``step`` in its data-parallel form where the trainer has a
        mesh."""
        if self.mesh is None:
            return step
        return sharding.make_parallel_train_step(step, self.mesh)

    def _global_flag(self, flag: bool) -> bool:
        """``flag`` raised on any rank (each rank's own, alone)."""
        if self.world is None:
            return flag
        t = torch.tensor([int(flag)], device=sharding.comm_device(
            self.world))
        return bool(sharding.all_reduce_max(t, self.world)[0])

    def _min_possibility(self) -> float:
        """The val sampler's least possibility: the smallest over the
        ranks' samplers where the trainer has a mesh."""
        m = float(np.min(self.val_set.min_possibility))
        if self.mesh is None:
            return m
        t = torch.tensor([-m], dtype=torch.float64,
                         device=sharding.comm_device(self.mesh))
        return -float(sharding.all_reduce_max(t, self.mesh)[0])

    def _save(self, epoch: int, metric: Optional[float] = None) -> None:
        """A checkpoint of the state with the sidecar of ``epoch``: written
        by rank 0 alone, the other ranks waiting until it is on disk."""
        aux = self._aux_state(epoch)
        if self._writer():
            self.ckpt.save(self.state, step=self.state.step, metric=metric,
                           aux=aux)
        if self.world is not None:
            import torch.distributed as dist

            dist.barrier(group=self.world.group)

    def _writer(self) -> bool:
        """Whether this rank writes the run's files (rank 0 of the
        world)."""
        return self.world is None or self.world.rank == 0

    def _vote_generator(self, vote_pass: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            (VOTE_SEED << 32) + vote_pass)

    def _eval_batch(self, batch, vote_pass: Optional[int] = None) -> dict:
        """The eval step, in chunks of ``cfg.eval_microbatch`` clouds where
        that is set; each chunk draws its pyramid as the whole batch would
        (the step's own generator, or the vote pass's afresh)."""
        def run(b):
            gen = None if vote_pass is None else self._vote_generator(
                vote_pass)
            return self._eval_step(self.state, b, gen)

        m = self.cfg.eval_microbatch
        nb = batch.x.shape[0]
        if not m or m >= nb:
            return run(batch)
        if nb % m:
            raise ValueError("batch_size must be divisible by "
                             "eval_microbatch")
        outs = [run(slice_batch(batch, i, m)) for i in range(0, nb, m)]
        merged = {}
        for k in outs[0]:
            vals = [o[k] for o in outs]
            if vals[0] is None:
                merged[k] = None
            elif k == "loss":
                merged[k] = torch.stack(vals).mean()
            elif k == "confusion":
                merged[k] = sum(vals)
            else:
                merged[k] = torch.cat(vals, dim=0)
        return merged

    @staticmethod
    def _mean_loss(losses) -> float:
        if not losses:
            return float("nan")
        return float(np.mean(_fetch(torch.stack(losses)).astype(np.float64)))

    def train_one_epoch(self, epoch: int,
                        preempted: Optional[dict] = None) -> dict:
        self.metrics.reset()
        losses = []
        confusion = None
        batches = _batches(self.train_loader, self.mesh)
        for step_i, batch in enumerate(batches):
            # step-granular preemption: an epoch can be thousands of samples;
            # under a mesh every rank stops at the same step
            if (preempted is not None and step_i % 10 == 0
                    and self._global_flag(preempted["flag"])):
                preempted["mid_epoch"] = True
                break
            m = self._train_step(self.state, batch, self.rng)
            losses.append(m["loss"])
            confusion = (m["confusion"] if confusion is None
                         else confusion + m["confusion"])
        if confusion is not None:
            self.metrics.update_confusion(_fetch(confusion))
        return {"loss": self._mean_loss(losses)}

    def val_one_epoch(self, epoch: int) -> dict:
        self.metrics.reset()
        losses = []
        confusion = None
        for batch in _batches(self.val_loader, self.mesh):
            m = self._eval_batch(batch)
            losses.append(m["loss"])
            confusion = (m["confusion"] if confusion is None
                         else confusion + m["confusion"])
        if confusion is not None:
            self.metrics.update_confusion(_fetch(confusion))
        return {"loss": self._mean_loss(losses)}

    def train(self) -> float:
        """The training loop; SIGTERM/SIGINT save a checkpoint and stop it
        at the next step boundary (the previous handlers are restored on
        the way out, an exception included)."""
        preempted = {"flag": False}

        def _handler(signum, frame):
            preempted["flag"] = True

        old_term = signal.signal(signal.SIGTERM, _handler)
        try:
            old_int = signal.signal(signal.SIGINT, _handler)
            try:
                return self._train_loop(preempted)
            finally:
                signal.signal(signal.SIGINT, old_int)
        finally:
            signal.signal(signal.SIGTERM, old_term)

    # ------------------------------------------------------------------
    # host-side resume state: the sampler's possibility arrays and the
    # generators; without it a resumed run replays another crop schedule
    # ------------------------------------------------------------------
    def _aux_state(self, epoch: int) -> dict:
        """The sidecar of a checkpoint; under a mesh its ``train_loader``
        is the list of every rank's loader state (a collective: every rank
        calls it)."""
        loader = loader_state_dict(self.train_loader)
        if self.mesh is not None:
            import torch.distributed as dist

            states = [None] * self.mesh.world
            dist.all_gather_object(states, loader, group=self.mesh.group)
            loader = states
        return {
            "epoch": epoch,
            "trainer_rng": self.rng.get_state().numpy(),
            "train_loader": loader,
        }

    def _load_aux(self, aux: dict) -> int:
        self.rng.set_state(torch.from_numpy(np.asarray(aux["trainer_rng"])))
        loader = aux["train_loader"]
        world = 1 if self.mesh is None else self.mesh.world
        if isinstance(loader, list) != (world > 1) or (
                world > 1 and len(loader) != world):
            raise ValueError(
                f"the checkpoint's loader state is of "
                f"{len(loader) if isinstance(loader, list) else 1} ranks, "
                f"this run has {world}")
        if world > 1:
            loader = loader[self.mesh.rank]
        loader_load_state_dict(self.train_loader, loader)
        return int(aux["epoch"])

    def resume(self, path: Optional[str] = None) -> int:
        """Restore the latest (or the given) checkpoint and its host state;
        returns the epoch to continue from."""
        self.state = self.ckpt.restore(self.state, path)
        aux = self.ckpt.restore_aux(path)
        self._start_epoch = self._load_aux(aux) if aux is not None else 0
        log.info("resumed from step %d (epoch %d)", self.state.step,
                 self._start_epoch)
        return self._start_epoch

    def _train_loop(self, preempted) -> float:
        best_iou = 0.0
        since_best = 0
        for epoch in range(getattr(self, "_start_epoch", 0), self.cfg.epochs):
            if self._global_flag(preempted["flag"]):
                self._save(epoch)
                log.warning("preempted at epoch %d; checkpoint saved", epoch)
                break
            t1 = time.time()
            tr = self.train_one_epoch(epoch, preempted)
            t2 = time.time()
            if preempted.get("mid_epoch"):
                self._save(epoch)
                log.warning("preempted mid-epoch %d; checkpoint saved", epoch)
                break
            scores, _ = self.metrics.get_scores()
            log.info(
                "epoch %d train: loss=%.4f OA=%.2f%% mIoU=%.2f%% (%.1fs)",
                epoch, tr["loss"], scores["Overall Acc"] * 100,
                scores["Mean IoU"] * 100, t2 - t1,
            )
            if self.val_loader is not None:
                va = self.val_one_epoch(epoch)
                scores, _ = self.metrics.get_scores()
                miou = scores["Mean IoU"]
                log.info("epoch %d val:   loss=%.4f OA=%.2f%% mIoU=%.2f%%",
                         epoch, va["loss"], scores["Overall Acc"] * 100,
                         miou * 100)
                # the loop's best takes a tie (>=); the checkpoint manager's
                # best does not (strictly higher), as in the JAX package
                if miou >= best_iou:
                    best_iou = miou
                    since_best = 0
                else:
                    since_best += 1
                self._save(epoch + 1, metric=miou)
                patience = self.cfg.early_stop_patience
                if patience is not None and since_best >= patience:
                    log.info("early stop at epoch %d (no val improvement "
                             "for %d epochs)", epoch, patience)
                    break
        log.info("training finished, best mIoU %.2f%%", best_iou * 100)
        return best_iou

    # ------------------------------------------------------------------
    # vote-based inference (reference trainval.py:157-327)
    # ------------------------------------------------------------------
    def _vote_epoch(self, smooth: float) -> None:
        """One pass over the val loader accumulating running-mean
        probabilities. Each pass draws its pyramids from a generator of its
        own (the same for every batch of the pass), so windowed votes see
        varied subsamples."""
        self._vote_pass = getattr(self, "_vote_pass", -1) + 1
        for batch in _batches(self.val_loader, self.mesh):
            m = self._eval_batch(batch, self._vote_pass)
            # every rank's clouds, so that every rank votes alike
            probs = _fetch(m["probs"], self.mesh)            # [B, N, C]
            point_idx = _fetch(
                m["point_idx"] if m.get("point_idx") is not None
                else batch.point_idx, self.mesh)              # [B, N]
            cloud_idx = _fetch(batch.cloud_idx, self.mesh).reshape(-1)
            for b in range(probs.shape[0]):
                c = int(cloud_idx[b])
                p_idx = point_idx[b]
                self.test_probs[c][p_idx] = (
                    smooth * self.test_probs[c][p_idx]
                    + (1 - smooth) * probs[b]
                )

    def test(self, num_votes: int = 100,
             saving_path: Optional[str] = None) -> str:
        """Unlabeled vote test: vote until coverage, project to the full
        clouds and write a PLY of dataset labels (network class + 1) per
        cloud and, where the dataset has the benchmark's name map
        (Semantic3D), the server's ascii ``.labels`` file of the same
        labels (trainval.py:157-216); under a mesh rank 0 writes them.
        Returns the directory written."""
        from crfconv_tpu_torch.data.ply import write_ply

        cfg = self.cfg
        saving_path = saving_path or os.path.join(
            "results", cfg.dataset, "predictions")
        writer = self._writer()
        if writer:
            os.makedirs(saving_path, exist_ok=True)
        last_min, epoch = -0.5, 0
        while last_min < num_votes:
            self._vote_epoch(cfg.test_smooth)
            new_min = self._min_possibility()
            log.info("vote epoch %d, min possibility %.2f", epoch, new_min)
            if last_min + cfg.vote_delta < new_min and not writer:
                return saving_path    # every rank holds the same votes
            if last_min + cfg.vote_delta < new_min:
                # Semantic3D names them test_proj / val_files, S3DIS
                # val_proj / input_names
                proj_list = (getattr(self.val_set, "test_proj", None)
                             or getattr(self.val_set, "val_proj"))
                names = (getattr(self.val_set, "input_names", None)
                         or getattr(self.val_set, "val_files"))
                ascii_map = getattr(self.val_set, "ascii_files", None)
                for i, name in enumerate(names):
                    probs = self.test_probs[i][proj_list[i]]
                    preds = np.argmax(probs, axis=1).astype(np.uint8) + 1
                    write_ply(os.path.join(saving_path, str(name)), [preds],
                              ["pred"])
                    if ascii_map is not None:
                        base = os.path.basename(str(name))
                        key = base if base in ascii_map else base + ".ply"
                        label_name = ascii_map.get(
                            key, os.path.splitext(base)[0] + ".labels")
                        np.savetxt(os.path.join(saving_path, label_name),
                                   preds, fmt="%d")
                return saving_path
            epoch += 1
        return saving_path

    def test_labeled(self, num_votes: int = 100) -> dict:
        """Labeled vote eval: sub-cloud and re-projected full-cloud IoU with
        class-proportion rescaling (trainval.py:218-327, ``train/vote.py``)."""
        from crfconv_tpu_torch.train.vote import labeled_vote_eval

        return labeled_vote_eval(
            self.val_set if self.mesh is None else _GlobalCoverage(self),
            lambda: self._vote_epoch(self.cfg.test_smooth),
            self.test_probs,
            num_votes,
            vote_delta=self.cfg.vote_delta,
        )

    def eval_partseg(self) -> dict:
        """ShapeNet part segmentation: each instance's part IoU averaged per
        category -> pIoU and mpIoU over the val loader (reference
        utils/metrics.py:58-112)."""
        score = RunningScoreShapeNet()
        for batch in _batches(self.val_loader, self.mesh):
            m = self._eval_batch(batch)
            preds = _fetch(m["preds"], self.mesh)
            labels = _fetch(m["labels"], self.mesh)   # in the order of preds
            cats = _fetch(batch.category, self.mesh).reshape(-1)
            for b in range(preds.shape[0]):
                score.update(labels[b], preds[b], int(cats[b]))
        p_iou, mp_iou, cls = score.get_scores()
        log.info("part-seg pIoU %.2f%%, mpIoU %.2f%%", p_iou * 100,
                 mp_iou * 100)
        return {"pIoU": p_iou, "mpIoU": mp_iou, "class_pIoU": cls}

    def load(self, path: Optional[str] = None) -> None:
        self.state = self.ckpt.restore(self.state, path)

    def __call__(self):
        """Train (``cfg.mode`` "train") or run the labeled vote test
        ("test") on ``cfg.model_path``, else on this run's best checkpoint,
        else its latest, where one exists (the JAX package's test mode
        votes with freshly initialised weights)."""
        if self.cfg.mode == "train":
            return self.train()
        if self.cfg.mode == "test":
            path = (self.cfg.model_path or self.ckpt.best_path()
                    or self.ckpt.latest_path())
            if path is not None:
                self.load(path)
            return self.test_labeled()
        raise ValueError("mode must be 'train' or 'test'")

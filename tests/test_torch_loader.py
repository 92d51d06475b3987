"""The port's MultiscaleLoader against the JAX package's, on the CPU: its
batches with ``emit`` "pyramid" and "raw" at prefetch 0 and 2, sharded,
resumed from ``loader_state_dict``, a worker's error, an early stop; and
the slice as a whole: ShapeNet files through the loader's host pyramid
(ShapeNet's dilations) into CRFSegNet_Part in the exact regime, and S3DIS
rooms through the loader and the windowed pyramid into the flagship,
each against the JAX package on the same batches and weights."""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data import datasets as jdatasets
from crfconv_tpu.data import loader as jloader
from crfconv_tpu.data import transforms as jT
from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.data.batch import ScaleData as JScale
from crfconv_tpu.models import CRFSegNet_Part as JPart
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import CRFSegNet_Part, PointConvResNet
from crfconv_tpu_torch.data import datasets, loader
from crfconv_tpu_torch.data import transforms as T
from crfconv_tpu_torch.data.batch import PointBatch, RawBatch
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train.config import ShapeNetConfig
from crfconv_tpu_torch.train.train_state import (
    TrainState, build_windowed_batch, make_train_step,
)
from tests.test_torch_data_readers import write_s3dis, write_shapenet
from tests.test_torch_model import RNGS, _apply, _init, _load, _perturb_stats
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_train_step import _exact_windowed_gather

CFG = ShapeNetConfig()
SHAPENET_PYRAMID = dict(kernel_sizes=CFG.kernel_sizes, ratios=CFG.ratios,
                        k_up=CFG.k_up, dilations=CFG.dilations)
EXACT = NeighborMode("exact")
WINDOWED = NeighborMode("windowed", knn_exact=True)
NARROW = (16, 32, 64, 128, 256)


@pytest.fixture(scope="module")
def s3dis_root(tmp_path_factory):
    """Three small rooms, processed once by the JAX package (both packages'
    readers give the same processed files: test_torch_data_readers)."""
    root = str(tmp_path_factory.mktemp("s3dis"))
    write_s3dis(root, np.random.default_rng(11), n_pts=1000)
    jdatasets.S3DISRoomDataset(root, grid_size=0.1, num_points=1024)
    return root


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    write_shapenet(root, np.random.default_rng(12))
    jdatasets.ShapeNetNormalDataset(root, train=True, num_points=256)
    return root


def _rooms(pkg, root, num_points=1024):
    return pkg.S3DISRoomDataset(root, grid_size=0.1,
                                num_points=num_points).train_set


def _loaders(kind, root, prefetch, **kw):
    """The JAX loader (host arrays) and the port's (CPU tensors) over the
    same files, each over its own dataset object (its own sampler)."""
    if kind == "s3dis":
        jds, ds = _rooms(jdatasets, root, 256), _rooms(datasets, root, 256)
        kw = dict(transform_pair=(jT.default_train_transform(),
                                  T.default_train_transform()), **kw)
    else:
        jds = jdatasets.ShapeNetNormalDataset(root, train=True,
                                              num_points=256)
        ds = datasets.ShapeNetNormalDataset(root, train=True, num_points=256)
        kw = dict(SHAPENET_PYRAMID, **kw)
    jt, tt = kw.pop("transform_pair", (None, None))
    ref = jloader.MultiscaleLoader(jds, 2, transform=jt, prefetch=prefetch,
                                   device_put=False, seed=5, **kw)
    got = loader.MultiscaleLoader(ds, 2, transform=tt, prefetch=prefetch,
                                  device="cpu", seed=5, **kw)
    return ref, got


def _assert_batch_equal(got, ref):
    """A port batch of CPU tensors against a JAX batch of host arrays:
    the same values, the port's integer fields int64."""
    assert type(got).__name__ == type(ref).__name__
    for name in ref._fields:
        r, g = getattr(ref, name), getattr(got, name)
        if name == "scales":
            assert len(g) == len(r)
            for s, sr in zip(g, r):
                for f in sr._fields:
                    np.testing.assert_array_equal(getattr(s, f).numpy(),
                                                  getattr(sr, f), err_msg=f)
                    if f != "pos":
                        assert getattr(s, f).dtype == torch.int64
            continue
        if r is None:
            assert g is None, name
            continue
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        assert g.dtype == (torch.float32 if name in ("pos", "x")
                           else torch.int64), name


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("emit,kind", [("raw", "s3dis"), ("pyramid", "s3dis"),
                                       ("pyramid", "shapenet")])
def test_loader_matches_jax(s3dis_root, shapenet_root, emit, kind, prefetch):
    root = s3dis_root if kind == "s3dis" else shapenet_root
    ref, got = _loaders(kind, root, prefetch, emit=emit)
    assert len(got) == len(ref)
    n = 0
    for g, r in zip(got, ref):
        _assert_batch_equal(g, r)
        n += 1
        if n == 3:
            break
    assert n == 3


def test_sharded_loader_matches_jax(shapenet_root):
    ref, got = _loaders("shapenet", shapenet_root, 0, emit="pyramid",
                        num_shards=2, shard_index=1)
    assert len(got) == len(ref) == 48 // (2 * 2)   # 48 train shapes
    _assert_batch_equal(next(iter(got)), next(iter(ref)))
    with pytest.raises(ValueError, match="shard"):
        loader.MultiscaleLoader([], 2, num_shards=2, shard_index=2)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_resume_gives_the_next_batch(s3dis_root, prefetch):
    """loader_state_dict carries the loader's generator and the sampler's
    (its possibility arrays and its own generator): restored, a fresh
    loader draws the batch that the loader drew next. A prefetching loader
    has drawn ahead of what it handed on when its state is read, as the JAX
    package's does; without prefetch the two packages' states agree."""
    ref, got = _loaders("s3dis", s3dis_root, prefetch, emit="raw")
    for lo in (ref, got):
        it = iter(lo)
        next(it)
        it.close()
    state = loader.loader_state_dict(got)
    jstate = jloader.loader_state_dict(ref)
    assert set(state) == set(jstate) == {"rng_state", "sampler"}
    if prefetch == 0:
        assert state["rng_state"] == jstate["rng_state"]
        assert state["sampler"]["rng_state"] == jstate["sampler"]["rng_state"]
    nxt = next(iter(got))
    fresh = loader.MultiscaleLoader(
        _rooms(datasets, s3dis_root, 256), 2,
        transform=T.default_train_transform(), emit="raw", device="cpu",
        prefetch=prefetch, seed=99)
    loader.loader_load_state_dict(fresh, state)
    _assert_batch_equal(next(iter(fresh)), JRaw(
        *(None if t is None else t.numpy() for t in nxt)))


class _Broken:
    def __init__(self, after):
        self.after = after
        self.calls = 0

    def __len__(self):
        return 8

    def get_sample(self, rng, idx=None):
        self.calls += 1
        if self.calls > self.after:
            raise RuntimeError("boom")
        return {"pos": rng.random((16, 3)), "x": rng.random((16, 4))}


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("after", [0, 3])
def test_worker_error_propagates(prefetch, after):
    lo = loader.MultiscaleLoader(_Broken(after), 2, emit="raw", device="cpu",
                                 prefetch=prefetch)
    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for b in lo:
            got.append(b)
    assert len(got) == after // 2


def test_early_stop_ends_the_producer():
    """Leaving the loop early stops and joins the producer thread, even
    with its queue full."""
    before = threading.active_count()
    lo = loader.MultiscaleLoader(_Broken(10 ** 6), 2, emit="raw",
                                 device="cpu", prefetch=1)
    it = iter(lo)
    b = next(it)
    assert isinstance(b, RawBatch) and tuple(b.x.shape) == (2, 16, 4)
    it.close()
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _jax_point_batch(b):
    return JBatch(
        x=jnp.asarray(b.x), y=jnp.asarray(b.y.astype(np.int32)),
        scales=tuple(JScale(*map(jnp.asarray, s)) for s in b.scales),
        category=jnp.asarray(b.category.astype(np.int32)))


@pytest.fixture(scope="module")
def shapenet_slice(shapenet_root):
    """One B2 x 256 batch of the ShapeNet files through both loaders (host
    pyramid, ShapeNet's kernel sizes, ratios, k_up 3 and dilations), the
    JAX CRFSegNet_Part(50, steps=10) log-probabilities on it in the exact
    regime and one JAX exact train step."""
    ref, got = _loaders("shapenet", shapenet_root, 2, emit="pyramid")
    jb, tb = next(iter(ref)), next(iter(got))
    jbatch = _jax_point_batch(jb)
    model = JPart(n_classes=CFG.num_classes, steps=CFG.steps)
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        with neighbor_mode("exact"), jax.default_matmul_precision("highest"):
            variables = _init(model, RNGS, jbatch)
            variables = {**variables, "batch_stats": _perturb_stats(
                variables["batch_stats"])}
            logp = np.asarray(_apply(model, variables, jbatch))
            tx = jts.make_optimizer(lr=CFG.lr, momentum=CFG.momentum,
                                    weight_decay=CFG.weight_decay,
                                    gamma=CFG.gamma)
            state = jts.create_train_state(model, jbatch, tx, seed=0)
            step = jax.jit(jts.make_train_step(
                model, ignore_index=CFG.ignore_index,
                label_offset=CFG.label_offset))
            _, metrics = step(state, jbatch, jax.random.PRNGKey(1))
    finally:
        mp.undo()
    return {"batches": (jb, tb), "variables": variables, "logp": logp,
            "state": state, "loss": float(metrics["loss"]),
            "confusion": np.asarray(metrics["confusion"])}


def test_shapenet_slice_log_probs_match_jax(shapenet_slice):
    jb, tb = shapenet_slice["batches"]
    _assert_batch_equal(tb, jb)
    # the dilated scales reach beyond the plain kNN(k)
    assert tb.scales[1].neighbor_idx.shape[2] == CFG.kernel_sizes[1]
    model = _load(CRFSegNet_Part(CFG.num_classes, CFG.in_channels,
                                 steps=CFG.steps, device="cpu"),
                  shapenet_slice["variables"])
    with torch.no_grad():
        got = model(tb, EXACT).numpy()
    ref = shapenet_slice["logp"]
    assert got.shape == ref.shape == (2, 256, CFG.num_classes)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_shapenet_slice_train_step_matches_jax(shapenet_slice):
    from crfconv_tpu_torch import from_flax

    _, tb = shapenet_slice["batches"]
    st = shapenet_slice["state"]
    model = CRFSegNet_Part(CFG.num_classes, CFG.in_channels, steps=CFG.steps,
                           device="cpu")
    model.load_state_dict(from_flax(jax.device_get(st.params),
                                    jax.device_get(st.batch_stats)))
    state = TrainState.create(model, lr=CFG.lr, momentum=CFG.momentum,
                              weight_decay=CFG.weight_decay, gamma=CFG.gamma)
    m = make_train_step(EXACT, windowed=False, ignore_index=CFG.ignore_index,
                        label_offset=CFG.label_offset)(state, tb)
    np.testing.assert_allclose(float(m["loss"]), shapenet_slice["loss"],
                               rtol=1e-5)
    np.testing.assert_array_equal(m["confusion"].numpy(),
                                  shapenet_slice["confusion"])


def test_s3dis_slice_logits_match_jax(s3dis_root):
    """B2 x 1024 crops of the rooms through both loaders (emit "raw", the
    train transform), the windowed pyramid from one key (the port given
    its offsets), and the narrow flagship's logits on it."""
    jds, ds = _rooms(jdatasets, s3dis_root), _rooms(datasets, s3dis_root)
    ref = jloader.MultiscaleLoader(
        jds, 2, transform=jT.default_train_transform(), emit="raw",
        device_put=False, seed=2)
    got = loader.MultiscaleLoader(
        ds, 2, transform=T.default_train_transform(), emit="raw",
        device="cpu", seed=2)
    jraw, traw = next(iter(ref)), next(iter(got))
    _assert_batch_equal(traw, jraw)
    key = jax.random.PRNGKey(1)
    model = JResNet(n_classes=13, use_crf=True, steps=1, layers=NARROW)
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        with neighbor_mode("windowed"), \
                jax.default_matmul_precision("highest"):
            jbatch = jts.build_windowed_batch(
                JRaw(pos=jnp.asarray(jraw.pos), x=jnp.asarray(jraw.x)), key)
            variables = _init(model, RNGS, jbatch)
            variables = {**variables, "batch_stats": _perturb_stats(
                variables["batch_stats"])}
            logits = np.asarray(_apply(model, variables, jbatch))
    finally:
        mp.undo()
    batch = build_windowed_batch(traw, offsets=jax_offsets(key, 1024),
                                 mode=WINDOWED)
    np.testing.assert_array_equal(batch.x.numpy(), np.asarray(jbatch.x))
    port = _load(PointConvResNet(13, 6, use_crf=True, steps=1, layers=NARROW,
                                 device="cpu"), variables)
    with torch.no_grad():
        out = port(PointBatch(x=batch.x, y=None, scales=batch.scales),
                   WINDOWED).numpy()
    assert out.shape == logits.shape == (2, 1024, 13)
    np.testing.assert_allclose(out, logits, rtol=1e-3, atol=1e-4)

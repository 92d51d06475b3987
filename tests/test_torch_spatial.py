"""Point-sharded serving of the port on the CPU: two gloo ranks of a point
group, spawned once through ``crfconv_tpu_torch.parallel.launch``
(``tests/test_torch_spatial_ranks.py`` says what each rank runs), against
the one-process port on the whole cloud and against the JAX package's
``make_spatial_forward``, ``build_pyramid_windowed_spatial`` and
``crf_mean_field_spatial`` on a 2-device mesh of the conftest's virtual
CPU devices (the same weights through ``convert.from_flax``, the same
subsampling offsets).

At B1 x 4096 over two ranks scales 4096 and 1024 are sharded (spans of
2048 and 512 rows) and every branch of ``spatial_gather`` runs: the
same-scale exchanges, the strided 4096 -> 1024 exchange, the
sharded-to-sharded upsample (its halo equal to the span), the cut-over
all-gather (1024 -> 256) and the infeasible-halo fallback (the upsample out
of the replicated 256). Tolerances are JAX's own (tests/test_spatial*.py):
logits within atol 2e-5 of the unsharded port and within the model
tolerance (rtol 1e-3, atol 1e-4) of JAX; the fused-conv route at 2e-4;
the chunked CRF at rtol 2e-5, atol 2e-6. Point-sharded training is
``tests/test_torch_spatial_train.py``'s.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.data.batch import ScaleData as JScale
from crfconv_tpu.models import BaselineDiscreteCRFSegNet as JDisc
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.models.segnets import CRFSegNet as JCRFSegNet
from crfconv_tpu.ops import crf as jcrf
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.parallel import crf_mean_field_spatial as jcrf_spatial
from crfconv_tpu.parallel import make_mesh as jax_mesh
from crfconv_tpu.parallel import make_spatial_forward as jforward
from crfconv_tpu_torch import from_flax
from crfconv_tpu_torch.ops.crf import crf_mean_field
from crfconv_tpu_torch.ops.morton import morton_order
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed, window_knn
from crfconv_tpu_torch.parallel import (
    choose_sharded_scales, launch, make_spatial_mesh,
)
from crfconv_tpu_torch.parallel.spatial import _chunk_plan
from crfconv_tpu_torch.parallel.spatial_forward import (
    _halo_pair, same_scale_halo,
)
from crfconv_tpu_torch.train.config import S3DISConfig
from crfconv_tpu_torch.train.trainer import Trainer
from tests import test_torch_spatial_ranks as ranks
from tests.test_data import _make_s3dis_raw
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets

REPO = Path(__file__).resolve().parents[1]
NARROW = (8, 16, 32, 64, 128)
N = 4096
UNFUSED = 1 << 30          # the fused routes' least rows: none runs fused
PORT_TOL = dict(rtol=0, atol=2e-5)
JAX_TOL = dict(rtol=1e-3, atol=1e-4)
CRF_TOL = dict(rtol=2e-5, atol=2e-6)
TRAINER_CFG = dict(mode="train", use_crf=False, grid_size=0.2,
                   sample_num=2048, batch_size=1, epochs=1,
                   train_samples_per_epoch=3, val_samples_per_epoch=1,
                   layers=NARROW)


def cloud(n, seed, key, tile=64, pad=128):
    """A random cloud's Morton-sorted features and windowed pyramid, its
    offsets drawn as the JAX builder draws them from ``key``: (the port's
    batch spec, the JAX batch)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((1, n, 3), dtype=np.float32)
    feats = rng.random((1, n, 6), dtype=np.float32)
    order, scales = build_pyramid_windowed(
        pos, offsets=jax_offsets(key, n), tile=tile, pad=pad, device="cpu")
    x = np.take_along_axis(feats, order.numpy()[..., None], 1)
    scales = [[None if t is None else t.numpy() for t in s] for s in scales]
    jb = JBatch(x=jnp.asarray(x), y=None, scales=tuple(
        JScale(*map(jnp.asarray, s)) for s in scales))
    return {"x": x, "scales": scales}, jb


def jax_init(model, tile=64, pad=128):
    """A JAX model's initial variables (their shapes do not depend on the
    cloud's size: a 512-point cloud initialises them) and their state dict
    for the port."""
    _, jb = cloud(512, 11, jax.random.PRNGKey(12), tile, pad)
    with neighbor_mode("windowed", tile=tile, pad=pad):
        v = jax.jit(lambda b: model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, b, train=False))(jb)
    state = from_flax(jax.device_get(v["params"]),
                      jax.device_get(v["batch_stats"]))
    return v, {k: t.numpy() for k, t in state.items()}


def jax_forward(model, variables, jb, tile=64, pad=128):
    """JAX's point-sharded forward on a 2-device mesh and its info."""
    with neighbor_mode("windowed", tile=tile, pad=pad), \
            jax.default_matmul_precision("highest"):
        fn, info = jforward(model, jax_mesh(2), jb)
        out = fn(variables, jb)
    out = tuple(map(np.asarray, out)) if isinstance(out, tuple) else (
        np.asarray(out))
    return out, info["sharded_scales"]


def forward_spec(name, kw, state, batch, **extra):
    return {"kind": "forward", "model": name, "model_kw": kw,
            "state": state, "batch": batch, "fused_min_rows": UNFUSED,
            **extra}


def crf_inputs(n=8192, h=8, seed=3):
    """A continuous CRF's inputs on an 8192-point windowed kNN: two ranks
    of 4096 rows exchange in chunks of 3 steps (a fused core from the
    handed state) and 1 (the scan)."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.random((1, n, 3), dtype=np.float32))
    pos = torch.take_along_dim(pos, morton_order(pos)[..., None], dim=1)
    idx = window_knn(pos, 16)[:, :, 1:].contiguous().numpy()
    z = rng.standard_normal((1, n, h)).astype(np.float32)
    s = rng.random((1, n, 15)).astype(np.float32)
    s /= s.sum(-1, keepdims=True)
    c = (np.eye(h) + 0.1 * rng.standard_normal((h, h))).astype(np.float32)
    return {"z": z, "s": s, "idx": idx, "c": c}


def _specs(trainer_cfg):
    """Every scenario of the two ranks and the JAX references to hold
    them to."""
    specs, jref = {}, {}
    batch, jb = cloud(N, 0, jax.random.PRNGKey(1))
    flag = JResNet(n_classes=5, use_crf=True, steps=1, layers=NARROW)
    v, state = jax_init(flag)
    for steps in (1, 2):
        kw = dict(n_classes=5, in_channels=6, use_crf=True, steps=steps,
                  layers=NARROW)
        specs[f"flagship{steps}"] = forward_spec("PointConvResNet", kw,
                                                 state, batch)
        model = JResNet(n_classes=5, use_crf=True, steps=steps,
                        layers=NARROW)
        jref[f"flagship{steps}"] = jax_forward(model, v, jb)
    specs["fused"] = dict(specs["flagship1"], fused_min_rows=0, whole=True)

    nocrf = JResNet(n_classes=5, use_crf=False, layers=NARROW)
    v, state = jax_init(nocrf)
    specs["no_crf"] = forward_spec(
        "PointConvResNet", dict(n_classes=5, in_channels=6, use_crf=False,
                                layers=NARROW), state, batch)
    jref["no_crf"] = jax_forward(nocrf, v, jb)

    small = JCRFSegNet(n_classes=5, steps=1)
    v, state = jax_init(small)
    specs["small"] = forward_spec(
        "CRFSegNet", dict(n_classes=5, in_channels=6, steps=1), state, batch)
    jref["small"] = jax_forward(small, v, jb)

    disc = JDisc(n_classes=5, steps=2)
    v, state = jax_init(disc)
    specs["discrete"] = forward_spec(
        "BaselineDiscreteCRFSegNet", dict(n_classes=5, in_channels=6,
                                          steps=2), state, batch)
    jref["discrete"] = jax_forward(disc, v, jb)

    alt_batch, alt_jb = cloud(2048, 2, jax.random.PRNGKey(4), 32, 64)
    v, state = jax_init(flag, 32, 64)
    specs["alt_geometry"] = forward_spec(
        "PointConvResNet", dict(n_classes=5, in_channels=6, use_crf=True,
                                steps=1, layers=NARROW), state, alt_batch,
        mode={"tile": 32, "pad": 64})
    jref["alt_geometry"] = jax_forward(flag, v, alt_jb, 32, 64)

    # the build: sorted positions, the JAX builder's offsets injected
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.random((1, N, 3), dtype=np.float32))
    pos = torch.take_along_dim(pos, morton_order(pos)[..., None],
                               dim=1).numpy()
    specs["build"] = {"kind": "build", "pos": pos,
                      "offsets": jax_offsets(jax.random.PRNGKey(6), N)}
    specs["build_drawn"] = {"kind": "build", "pos": pos, "seed": 9,
                            "mode": {"knn_exact": False}}

    crf = crf_inputs()
    for name, steps, halo in (("crf", 10, None), ("crf_halo2", 5, 2)):
        specs[name] = {"kind": "crf", **crf, "steps": steps,
                       "halo_steps": halo}
        with neighbor_mode("windowed"), \
                jax.default_matmul_precision("highest"):
            jref[name] = np.asarray(jcrf_spatial(
                *map(jnp.asarray, (crf["z"], crf["s"], crf["idx"],
                                   crf["c"])), jax_mesh(2), steps=steps,
                halo_steps=halo))

    req = np.random.default_rng(8)
    specs["predict"] = {
        "kind": "predict", "model": "PointConvResNet",
        "model_kw": dict(n_classes=5, in_channels=6, use_crf=True, steps=1,
                         layers=NARROW),
        "state": specs["flagship1"]["state"], "seed": 3,
        "mode": {"knn_exact": False}, "fused_min_rows": UNFUSED,
        "pos": req.random((2, N, 3), dtype=np.float32),
        "feats": req.random((2, N, 6), dtype=np.float32)}
    x = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    specs["exchange"] = {"kind": "exchange", "x": x, "h": 2}
    specs["gather"] = {"kind": "gather", "x": x}
    specs["raises"] = {"kind": "raises", "lengths": [256, 64, 16, 4, 1]}
    specs["trainer"] = {"kind": "trainer", "cfg": dict(
        trainer_cfg, spatial_mesh=(1, 2))}
    return specs, jref


def run_ranks(specs, pg_dir) -> dict:
    """The two ranks' results of ``specs`` and the one-process port's,
    the ranks running in the background meanwhile."""
    box = {}

    def run():
        try:
            box["ranks"] = launch(ranks.run_scenarios, 2, ["cpu", "cpu"],
                                  "gloo", args=(specs,),
                                  init_method=f"file://{pg_dir}/pg",
                                  timeout_s=600)
        except BaseException as e:      # raised below
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    try:
        alone = {"exchange", "gather", "raises"}
        one = {}
        for name, spec in specs.items():
            if name in alone:
                continue
            if spec["kind"] == "trainer":
                spec = dict(spec, cfg=dict(spec["cfg"], checkpoint_dir=str(
                    pg_dir / "one")))
            one[name] = ranks.SCENARIOS[spec["kind"]](None, spec)
    finally:
        th.join(timeout=660)
    assert not th.is_alive(), "the ranks did not finish"
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "one": one}


@pytest.fixture(scope="module")
def trainer_cfg(tmp_path_factory):
    from crfconv_tpu_torch.data import datasets

    root = str(tmp_path_factory.mktemp("s3dis"))
    _make_s3dis_raw(root, n_rooms=2, n_pts=600)
    datasets.S3DISRoomDataset(root, test_area=5, grid_size=0.2,
                              num_points=2048)
    return dict(TRAINER_CFG, root=root,
                checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def sp(trainer_cfg, tmp_path_factory):
    specs, jref = _specs(trainer_cfg)
    out = run_ranks(specs, tmp_path_factory.mktemp("pg"))
    out["jax"], out["specs"] = jref, specs
    return out


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _joined(sp, name, i=None):
    """The two ranks' rows of a forward, concatenated on the point axis."""
    outs = [r[name]["out"] for r in sp["ranks"]]
    if i is not None:
        outs = [o[i] for o in outs]
    return np.concatenate([_np(o) for o in outs], axis=1)


@pytest.mark.parametrize("name,sharded", [
    ("flagship1", [4096, 1024]), ("flagship2", [4096, 1024]),
    ("no_crf", [4096, 1024]), ("small", [4096, 1024]),
    ("alt_geometry", [2048, 512])])
def test_forward_matches_unsharded_and_jax(sp, name, sharded):
    """The point-sharded forward: the ranks' rows put together are the
    unsharded port's logits (atol 2e-5) and JAX's point-sharded forward's
    (the model tolerance), with JAX's scale policy."""
    ref_j, sharded_j = sp["jax"][name]
    for r in sp["ranks"]:
        assert r[name]["sharded"] == sharded == sharded_j
    got = _joined(sp, name)
    np.testing.assert_allclose(got, _np(sp["one"][name]), **PORT_TOL)
    np.testing.assert_allclose(got, ref_j, **JAX_TOL)


def test_discrete_net_matches_unsharded_and_jax(sp):
    """BaselineDiscreteCRFSegNet(steps 2): the in-model kNN(32) runs
    halo-exchanged, the discrete CRF in chunks; both heads."""
    ref_j, sharded_j = sp["jax"]["discrete"]
    assert sharded_j == [4096, 1024]
    for i in range(2):
        got = _joined(sp, "discrete", i)
        np.testing.assert_allclose(got, _np(sp["one"]["discrete"][i]),
                                   **PORT_TOL)
        np.testing.assert_allclose(got, ref_j[i], **JAX_TOL)


def test_fused_conv_route_matches_unsharded(sp):
    """With the fused routes' least rows at 0 both forwards take K3, K5
    and K4 (plain versions here) wherever they are eligible: sharded on
    the halo-extended frames, else after the cut-over all-gather or on
    the unfused gathers where a halo is infeasible. Through
    ``forward_spatial``: each rank returns the whole output."""
    a, b = (_np(r["fused"]["out"]) for r in sp["ranks"])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, _np(sp["one"]["fused"]), rtol=2e-4,
                               atol=2e-4)


def _scales_np(scales):
    return [[None if t is None else _np(t) for t in s] for s in scales]


@pytest.mark.parametrize("name", ["build", "build_drawn"])
def test_sharded_build_equals_unsharded(sp, name):
    """Each rank's span of a sharded scale and the whole of a replicated
    one are the unsharded builder's, bit for bit: the JAX builder's
    offsets injected (the unsharded builder is held to JAX's by
    tests/test_torch_ops.py), or drawn from a generator as the unsharded
    builder draws them, with the packed-key selection."""
    ref = _scales_np(sp["one"][name])
    parts = [_scales_np(r[name]) for r in sp["ranks"]]
    sharded = 0
    for s in range(5):
        for f in range(4):
            a, b = parts[0][s][f], parts[1][s][f]
            if a.shape == ref[s][f].shape:
                assert np.array_equal(a, b), (s, f)
                got = a
            else:
                got = np.concatenate([a, b], axis=1)
                sharded += 1
            assert np.array_equal(got, ref[s][f]), (s, f)
    # scales 0 and 1: pos, kNN and up-link; scale 0's sub_idx (scale 1's)
    assert sharded == 7


@pytest.mark.parametrize("name", ["crf", "crf_halo2"])
def test_crf_mean_field_spatial(sp, name):
    """crf_mean_field_spatial at 8192 points over two ranks, in chunks
    (10 steps: 3, 3, 3, 1; halo_steps 2 over 5 steps: 2, 2, 1): the
    unsharded port and JAX's on a 2-device mesh."""
    got = np.concatenate([_np(r[name]) for r in sp["ranks"]], axis=1)
    np.testing.assert_allclose(got, _np(sp["one"][name]), **CRF_TOL)
    np.testing.assert_allclose(got, sp["jax"][name], **CRF_TOL)


def test_chunk_plans():
    """The chunks of the ScanNet CRF (steps 10) at the default geometry:
    3 steps on spans of 4096 rows, 1 on 1024, as JAX's."""
    assert _chunk_plan(10, 4096, 64, 128) == (3, 1536)
    assert _chunk_plan(10, 1024, 64, 128) == (1, 512)
    assert _halo_pair(4096, 4096, 64, 128) == (512, 512)
    assert _halo_pair(4096, 1024, 64, 128) == (2048, 512)
    assert same_scale_halo(32, 64) == 256


def test_predictor_mesh_matches_one_device(sp):
    """Predictor(mesh=...) on a B2 x 4096 request: every rank returns the
    whole request's scores in the input order, the one-device
    Predictor's within atol 2e-5."""
    a, b = (_np(r["predict"]) for r in sp["ranks"])
    assert a.shape == (2, N, 5)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, _np(sp["one"]["predict"]), **PORT_TOL)


def _global_halo_grad(x, h, world):
    """The gradient of sum_p sum(w * exchange_p(x)) at the global x (w an
    arange over each rank's extended block)."""
    b, n_all, f = x.shape
    n = n_all // world
    g = np.zeros_like(x)
    w = np.arange(b * (n + 2 * h) * f, dtype=x.dtype).reshape(b, n + 2 * h, f)
    for p in range(world):
        for i in range(n + 2 * h):
            j = p * n - h + i
            if 0 <= j < n_all:
                g[:, j] += w[:, i]
    return g


def test_exchange_and_all_gather(sp):
    """exchange_halo: the neighbours' rows, zeros past the ends, and the
    transpose (each halo's gradient added into its owner); the replicated
    all-gather: the whole on each rank, each span's gradient summed over
    the ranks into its owner."""
    x = sp["specs"]["exchange"]["x"]
    h, n = 2, 4
    pad = np.pad(x, ((0, 0), (h, h), (0, 0)))
    grad = _global_halo_grad(x, h, 2)
    wg = sum(np.arange(x.size, dtype=x.dtype).reshape(x.shape) * (1 + p)
             for p in range(2))
    for p, r in enumerate(sp["ranks"]):
        e = r["exchange"]
        np.testing.assert_array_equal(e["ext"], pad[:, p * n:p * n + n + 2 * h])
        np.testing.assert_array_equal(e["grad"], grad[:, p * n:(p + 1) * n])
        np.testing.assert_array_equal(e["gathered"], x)
        np.testing.assert_array_equal(e["gather_grad"],
                                      wg[:, p * n:(p + 1) * n])
        np.testing.assert_array_equal(r["gather"], x)


def test_policy_and_its_raise(sp):
    """A cloud too small for two spans of a halo shards nothing, and the
    train step says so; JAX's collision rule (4 ranks at 65,536: a span of
    16,384 is scale 1's length) shards nothing either."""
    for r in sp["ranks"]:
        assert r["raises"]["policy"] == []
        assert "no scale satisfies the sharding policy" in \
            r["raises"]["no_scale"]
    lens = {65536, 16384, 4096, 1024, 256, 128}
    assert choose_sharded_scales(lens, 4, 64, 128) == set()
    assert choose_sharded_scales(lens, 2, 64, 128) == {65536, 16384, 4096,
                                                       1024}
    assert choose_sharded_scales({8192, 2048, 512, 128, 32, 16}, 2, 64,
                                 128) == {8192, 2048}


def test_point_sharded_entry_points_need_the_card(tmp_path):
    """Asked for the card (the default) where there is none, the mesh and
    the Trainer raise; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_spatial_mesh(1, 2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        Trainer(S3DISConfig(root=str(tmp_path), spatial_mesh=(1, 1)))


def test_trainer_spatial_mesh_matches_one_process(sp):
    """A Trainer with spatial_mesh (1, 2) on two S3DIS rooms (B1 x 2048,
    scale 2048 sharded): an epoch of 3 steps with its val pass, the two
    ranks' losses and states equal, rank 0 the only checkpoint writer;
    the first loss is the one-process Trainer's (rtol 1e-5), the rest
    close to it (rtol 1e-3: float32 sums in another order, two steps on)."""
    r0, r1 = (r["trainer"] for r in sp["ranks"])
    one = sp["one"]["trainer"]
    assert len(r0["losses"]) == 3 and np.isfinite(r0["losses"]).all()
    assert r0["losses"] == r1["losses"]
    for k in r0["state"]:
        assert np.array_equal(r0["state"][k], r1["state"][k]), k
    np.testing.assert_allclose(r0["losses"][0], one["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-3)
    assert r0["ckpt_files"] and r0["ckpt_files"] == r1["ckpt_files"]


def test_crf_restart_state_matches_jax():
    """crf_mean_field from a handed state x0 (a chunk of the halo
    iteration): the port's fused core at steps 3 against JAX's scan, and
    its gradients in float64 against the port's own scan loop."""
    inp = crf_inputs(n=1024)
    x0 = np.random.default_rng(4).standard_normal(inp["z"].shape).astype(
        np.float32)
    mode = NeighborMode("windowed")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = crf_mean_field(t["z"], t["s"], t["idx"], t["c"], 3, mode,
                         x0=torch.from_numpy(x0))
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        ref = jcrf.crf_mean_field(
            *map(jnp.asarray, (inp["z"], inp["s"], inp["idx"], inp["c"])),
            steps=3, x0=jnp.asarray(x0), allow_fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **CRF_TOL)

    d = {k: v.double().requires_grad_(k != "idx") if v.is_floating_point()
         else v for k, v in t.items()}
    x0d = torch.from_numpy(x0).double().requires_grad_(True)
    out = crf_mean_field(d["z"], d["s"], d["idx"], d["c"], 3, mode, x0=x0d)
    grads = torch.autograd.grad(out.square().sum(), [d["z"], d["s"],
                                                     d["c"], x0d])
    from crfconv_tpu_torch.ops.crf_core import compat_products
    from crfconv_tpu_torch.ops.windowed import windowed_gather_plain

    C, inv, _ = compat_products(d["c"])
    x = x0d
    for _ in range(3):
        msg = torch.einsum("bnk,bnkh->bnh", d["s"],
                           windowed_gather_plain(x, d["idx"]))
        x = (d["z"] + msg @ C) @ inv
    ref_g = torch.autograd.grad(x.square().sum(), [d["z"], d["s"], d["c"],
                                                   x0d])
    torch.testing.assert_close(out, x, rtol=1e-12, atol=1e-12)
    for g, r in zip(grads, ref_g):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)


def test_spatial_modules_import_without_jax():
    """With jax, flax and crfconv_tpu blocked, the point-sharded modules
    import and their policy runs."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'crfconv_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import crfconv_tpu_torch.parallel as par\n"
        "from crfconv_tpu_torch.parallel import spatial, spatial_build, "
        "spatial_forward, spatial_train\n"
        "from crfconv_tpu_torch import serve\n"
        "from crfconv_tpu_torch.train import trainer, __main__\n"
        "assert par.choose_sharded_scales({4096, 1024, 256}, 2, 64, 128)"
        " == {4096, 1024}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'crfconv_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)

"""The exact neighbour regime of crfconv_tpu_torch against the JAX package
on the CPU, where the kernel wrappers run their plain versions: the k-min
selection (K6's plain version) against ``lax.top_k`` and the Pallas
``select_min_k`` in interpret mode, ``knn_bruteforce``, the device pyramid
(``build_pyramid_device`` against ``build_pyramid_jax``), the narrow
flagship's exact forward, one exact train step and eval step, the
full-width ``BaselineDiscreteCRFSegNet(steps=10)`` in the exact regime, and
the regime guard of the steps on a built pyramid."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.data.pipeline import build_pyramid_jax
from crfconv_tpu.models import BaselineDiscreteCRFSegNet as JBaseDisc
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.models import segnets as jsegnets
from crfconv_tpu.ops import neighbors as jnb
from crfconv_tpu.ops import windowed_pallas
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import (
    BaselineDiscreteCRFSegNet, PointConvResNet, build_pyramid_device,
    from_flax,
)
from crfconv_tpu_torch.data.batch import PointBatch, RawBatch
from crfconv_tpu_torch.models import segnets
from crfconv_tpu_torch.ops import crf, neighbors, windowed
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train.train_state import (
    TrainState, make_eval_step, make_train_step,
)
from tests.test_torch_model import (
    RNGS, _apply, _init, _load, _perturb_stats, _scales, _t,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _f64

EXACT = NeighborMode("exact")
NARROW = (16, 32, 64, 128, 256)
B, N = 2, 1024


# ---------------------------------------------------------------------------
# K6's plain version
# ---------------------------------------------------------------------------


def _rows(rng, shape, width, signed_zeros=True, inf=True):
    """Rows on a coarse grid (ties), with signed zeros and +inf if asked,
    and, with +inf, a first row holding fewer finite entries than k."""
    d = rng.integers(0, 64, shape + (width,)).astype(np.float32) / 8.0
    if signed_zeros:
        d[rng.random(d.shape) < 0.1] = 0.0
        d[rng.random(d.shape) < 0.1] = -0.0
    if inf:
        d[rng.random(d.shape) < 0.1] = np.inf
        flat = d.reshape(-1, width)
        flat[0] = np.inf
        flat[0, rng.permutation(width)[:3]] = 1.0
    return d


def _top_k(d, k):
    return np.asarray(jax.lax.top_k(-jnp.asarray(d), k)[1])


def test_select_min_k_on_the_issue_rows():
    """A row with fewer than k finite entries and a row with signed zeros:
    both keys give lax.top_k's order (no repeated column; -0.0 first)."""
    rows = [
        (np.array([3, 1, np.inf, 2, np.inf, np.inf, 0.5, np.inf]), 5),
        (np.array([1, 1, 0, -0.0, 1, 0]), 4),
    ]
    for row, k in rows:
        d = row.astype(np.float32).reshape(1, 1, 1, -1)
        ref = _top_k(d, k)
        for exact in (True, False):
            got = windowed.select_min_k(_t(d), k, exact).numpy()
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [1, 3, 16, 32])
@pytest.mark.parametrize("width", [32, 100, 1024, 1500])
def test_select_min_k_plain_matches_top_k(k, width):
    """Bit-equal to lax.top_k(-d, k)[1] on rows with ties, signed zeros and
    +inf, exact everywhere and packed up to width 1024 (the grid's values
    lie far more than 2^-13 apart, so the packed key ties only true
    ties)."""
    rng = np.random.default_rng(width + k)
    d = _rows(rng, (2, 3, 5), width)
    ref = _top_k(d, k)
    for exact in ((True, False) if width <= 1024 else (True,)):
        got = windowed.select_min_k(_t(d), k, exact)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("exact", [True, False])
def test_select_min_k_plain_matches_pallas(exact):
    """Bit-equal to the Pallas select_min_k (interpret mode) on finite rows
    with ties. Not on the rows above: the Pallas exact body masks a picked
    column with +inf, so in a row with fewer than k finite entries it picks
    the lowest column again ([3, 1, inf, 2, inf, inf, 0.5, inf], k = 5:
    [6 1 3 0 0], where lax.top_k gives [6 1 3 0 2]), and it ties -0.0 with
    +0.0 ([1, 1, 0, -0, 1, 0], k = 4: [2 3 5 0], lax.top_k [3 2 5 0]).
    The port follows lax.top_k, the kernel's documented contract; its
    packed body agrees with lax.top_k on both rows."""
    rng = np.random.default_rng(7)
    d = _rows(rng, (1, 2, 8), 300, signed_zeros=False, inf=False)
    ref = windowed_pallas.select_min_k(jnp.asarray(d), 16, exact,
                                       interpret=True)
    got = windowed.select_min_k(_t(d), 16, exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_select_min_k_checks():
    d = torch.zeros(1, 1, 2, 1025)
    with pytest.raises(ValueError):
        windowed.select_min_k(d, 3, exact=False)
    with pytest.raises(ValueError):
        windowed.select_min_k(d, 1026)
    with pytest.raises(ValueError):
        windowed.select_min_k(d, 0)


# ---------------------------------------------------------------------------
# knn_bruteforce and the device pyramid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 16, 32])
@pytest.mark.parametrize("bipartite,tile", [(False, None), (True, None),
                                            (False, 96), (True, 40)])
def test_knn_bruteforce_matches_jax(k, bipartite, tile):
    """Index agreement >= 0.999 (last-bit distance ties may round apart),
    same-scale and bipartite, with the tile rule and with tiles that do not
    divide M (padded queries)."""
    rng = np.random.default_rng(k)
    support = rng.random((B, 700, 3)).astype(np.float32)
    query = rng.random((B, 333, 3)).astype(np.float32) if bipartite else support
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jnb.knn_bruteforce(
            jnp.asarray(support), jnp.asarray(query), k, tile=tile))
    got = neighbors.knn_bruteforce(_t(support), _t(query), k, tile=tile)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert (got.numpy() == ref).mean() >= 0.999
    if not bipartite:
        assert (got.numpy()[:, :, 0] == np.arange(700)).mean() >= 0.999


def test_knn_bruteforce_chunks_and_full_f32(monkeypatch):
    """A call larger than the block budget runs one selection per chunk of
    (batch, query tile) blocks and gives the one-launch result; the cross
    term runs at full float32 whatever the process's setting, which is
    restored."""
    rng = np.random.default_rng(11)
    pos = _t(rng.random((3, 500, 3)).astype(np.float32))
    whole = neighbors.knn_bruteforce(pos, pos, 16, tile=64)
    calls, precisions = [], []
    select = neighbors.select_min_k
    monkeypatch.setattr(neighbors, "select_min_k",
                        lambda d, k: calls.append(d.shape) or select(d, k))
    baddbmm = torch.baddbmm
    monkeypatch.setattr(
        torch, "baddbmm", lambda *a, **kw: precisions.append(
            torch.get_float32_matmul_precision()) or baddbmm(*a, **kw))
    monkeypatch.setattr(neighbors, "KNN_BLOCK_BUDGET", 5 * 64 * 500 * 4)
    torch.set_float32_matmul_precision("high")
    try:
        chunked = neighbors.knn_bruteforce(pos, pos, 16, tile=64)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(chunked, whole)
    # 3 batches x 8 tiles = 24 blocks, 5 a launch
    assert [c[1] for c in calls] == [5, 5, 5, 5, 4]
    assert precisions == ["highest"] * 5


def jax_choices(key, n, ratios):
    """The kept points of each scale that build_pyramid_jax draws from
    ``key``."""
    out = []
    for r in ratios:
        key, sub = jax.random.split(key)
        sample = max(n // r, 1)
        out.append(np.asarray(jax.random.permutation(sub, n)[:sample]))
        n = sample
    return out


def _jax_pyramid(pos, key, k_up=1, kernel_sizes=(16,) * 5,
                 ratios=(4, 4, 4, 4, 2)):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda p, kk: build_pyramid_jax(
            p, kernel_sizes, ratios, k_up=k_up, key=kk))(jnp.asarray(pos), key)


@pytest.mark.parametrize("k_up", [1, 3])
def test_pyramid_device_matches_jax(k_up):
    """At 2048 points, so the last scale keeps 4 >= k_up points."""
    pos = np.random.default_rng(9).random((1, 2048, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = _jax_pyramid(pos, key, k_up)
    got = build_pyramid_device(
        pos, k_up=k_up, choices=jax_choices(key, 2048, (4, 4, 4, 4, 2)),
        device="cpu")
    assert len(got) == len(ref) == 5
    for s, sj in zip(got, ref):
        np.testing.assert_array_equal(s.pos.numpy(), np.asarray(sj.pos))
        for name in ("neighbor_idx", "sub_idx", "up_idx"):
            a, r = getattr(s, name).numpy(), np.asarray(getattr(sj, name))
            assert a.shape == r.shape and a.dtype == np.int32, name
            assert (a == r).mean() >= 0.999, name
        assert s.up_idx.shape[2] == k_up


def test_pyramid_device_generator():
    """One generator state gives one pyramid, another a different one; the
    permutation is shared across the batch."""
    cloud = np.random.default_rng(10).random((1, 256, 3)).astype(np.float32)
    pos = np.concatenate([cloud, cloud])
    a, b = (build_pyramid_device(pos, generator=torch.Generator()
                                 .manual_seed(1), device="cpu")
            for _ in range(2))
    c = build_pyramid_device(pos, generator=torch.Generator().manual_seed(2),
                             device="cpu")
    for sa, sb in zip(a, b):
        assert torch.equal(sa.pos, sb.pos)
        assert torch.equal(sa.sub_idx, sb.sub_idx)
    assert not torch.equal(a[1].pos, c[1].pos)
    for s in a:
        assert torch.equal(s.pos[0], s.pos[1])


# ---------------------------------------------------------------------------
# models in the exact regime
# ---------------------------------------------------------------------------


def _count_kernels(monkeypatch):
    """Counts the windowed kernels' wrappers that a forward reaches (none
    may run in the exact regime)."""
    from crfconv_tpu_torch.models import crf_conv, point_conv_big

    hits = []
    for mod, name in ((neighbors, "windowed_gather"),
                      (point_conv_big, "point_conv_fused_infer"),
                      (point_conv_big, "point_conv_fused_strided"),
                      (point_conv_big, "weighted_gather_reduce"),
                      (crf_conv, "crf_similarity_message"),
                      (crf, "crf_core"), (crf, "discrete_core"),
                      (windowed, "window_knn")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            hits.append(_n) or _f(*a, **kw))
    return hits


def test_flagship_exact_forward_matches_jax(monkeypatch):
    """The narrow flagship in the exact regime on one JAX-built pyramid."""
    rng = np.random.default_rng(1)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    scales = _jax_pyramid(pos, jax.random.PRNGKey(1))
    jbatch = JBatch(x=jnp.asarray(feats), y=None, scales=scales)
    model = JResNet(n_classes=13, use_crf=True, steps=1, layers=NARROW)
    with neighbor_mode("exact"), jax.default_matmul_precision("highest"):
        variables = _init(model, RNGS, jbatch)
        variables = {**variables,
                     "batch_stats": _perturb_stats(variables["batch_stats"])}
        ref = np.asarray(_apply(model, variables, jbatch))
    port = _load(PointConvResNet(13, 6, use_crf=True, steps=1, layers=NARROW,
                                 device="cpu"), variables)
    hits = _count_kernels(monkeypatch)
    with torch.no_grad():
        got = port(PointBatch(x=_t(feats), y=None, scales=_scales(scales)),
                   EXACT)
    assert not hits
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def exact_step():
    """One JAX exact-regime train step of the narrow flagship, in float64
    from float32 weights with nonzero biases (dropout off), on a pyramid of
    build_pyramid_jax; the eval step of the stepped state on another."""
    rng = np.random.default_rng(3)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    y = rng.integers(0, 13, (B, N)).astype(np.int32)
    y[0, :7] = -1                       # ignored labels reach the loss
    scales = _jax_pyramid(pos, jax.random.PRNGKey(2))
    escales = _jax_pyramid(pos, jax.random.PRNGKey(8))
    batch = JBatch(x=jnp.asarray(feats), y=jnp.asarray(y), scales=scales)
    ebatch = batch._replace(scales=escales)
    model = JResNet(n_classes=13, use_crf=True, steps=1, layers=NARROW,
                    dropout_rate=0.0)
    with neighbor_mode("exact"), jax.default_matmul_precision("highest"):
        state = jts.create_train_state(model, batch, jts.make_optimizer(
            lr=0.01), seed=0)
    # nonzero biases: see tests/test_torch_train_step.py (the all-pairs
    # coarse scales put a batch-normed row on the leaky ReLU's kink)
    gen = np.random.default_rng(5)
    params32 = jax.tree_util.tree_map_with_path(
        lambda path, a: a + np.float32(0.1) * gen.standard_normal(
            a.shape, dtype=np.float32)
        if path[-1].key == "bias" else a,
        jax.device_get(state.params),
    )
    stats32 = jax.device_get(state.batch_stats)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with neighbor_mode("exact"), jax.default_matmul_precision("highest"):
            params = _f64(params32)
            state = state.replace(params=params, batch_stats=_f64(stats32),
                                  opt_state=state.tx.init(params))
            new_state, metrics = jax.jit(jts.make_train_step(model))(
                state, _f64(batch), jax.random.PRNGKey(1))
            ev = jax.jit(jts.make_eval_step(model))(new_state, _f64(ebatch))
            return {
                "data": (feats, y), "scales": scales, "escales": escales,
                "before": from_flax(params32, stats32),
                "after": from_flax(jax.device_get(new_state.params),
                                   jax.device_get(new_state.batch_stats)),
                "update": from_flax(
                    jax.tree_util.tree_map(lambda a, b: np.asarray(a - b),
                                           new_state.params, params),
                    jax.device_get(new_state.batch_stats)),
                "loss": float(metrics["loss"]),
                "confusion": np.asarray(metrics["confusion"]),
                "eval": jax.device_get(ev),
            }
    finally:
        jax.config.update("jax_enable_x64", old)


def _flagship(sd, dtype=torch.float32):
    model = PointConvResNet(13, 6, use_crf=True, steps=1, layers=NARROW,
                            dropout_rate=0.0, device="cpu")
    model.load_state_dict(sd)
    return model.to(dtype)


def _port_batch(exact_step, scales="scales", dtype=torch.float32):
    feats, y = exact_step["data"]
    sc = _scales(exact_step[scales])
    return PointBatch(
        x=_t(feats).to(dtype), y=_t(y).long(),
        scales=tuple(s._replace(pos=s.pos.to(dtype)) for s in sc))


def test_exact_train_step_matches_jax(exact_step, monkeypatch):
    """The float32 port step's loss and confusion against the JAX step
    (float64, rtol 1e-5), then the float64 port step's update within 1e-6
    of each tensor's largest (+1e-9 of the model's); no windowed kernel
    runs."""
    hits = _count_kernels(monkeypatch)
    step = make_train_step(EXACT, windowed=False)
    metrics = step(TrainState.create(_flagship(exact_step["before"]),
                                     lr=0.01), _port_batch(exact_step))
    np.testing.assert_allclose(float(metrics["loss"]), exact_step["loss"],
                               rtol=1e-5)
    np.testing.assert_array_equal(metrics["confusion"].numpy(),
                                  exact_step["confusion"])
    model = _flagship(exact_step["before"], torch.float64)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step(TrainState.create(model, lr=0.01),
                   _port_batch(exact_step, dtype=torch.float64))
    assert not hits
    np.testing.assert_allclose(float(metrics["loss"]), exact_step["loss"],
                               rtol=1e-10)
    ref_upd = exact_step["update"]
    upd = {n: (p.detach() - before[n], ref_upd[n].double())
           for n, p in model.named_parameters()}
    u_max = max(float(r.abs().max()) for _, r in upd.values())
    assert u_max > 0
    for name, (u, r) in sorted(upd.items()):
        bound = 1e-6 * float(r.abs().max()) + 1e-9 * u_max
        gap = float((u - r).abs().max()) / bound
        assert gap <= 1.0, f"{name}: update off by {gap:.3g} of its bound"
    for name, t in model.named_buffers():   # running statistics
        np.testing.assert_allclose(t.numpy(), ref_upd[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def test_exact_eval_step_matches_jax(exact_step):
    """make_eval_step(windowed=False) on a built exact pyramid: the stepped
    state's probabilities, in the batch's order."""
    ref = exact_step["eval"]
    state = TrainState.create(_flagship(exact_step["after"]), lr=0.01)
    got = make_eval_step(EXACT, windowed=False)(
        state, _port_batch(exact_step, "escales"))
    assert not state.model.training
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(ref["probs"]),
                               rtol=1e-3, atol=1e-4)
    assert (got["preds"].numpy() == np.asarray(ref["preds"])).mean() >= 0.999
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))


def test_discrete_segnet_exact_matches_jax(monkeypatch):
    """Full-width BaselineDiscreteCRFSegNet(20, steps=10) in the exact
    regime, on a JAX pyramid with ScanNet's k_up = 3: log p and log q. At
    B1 x 2048 (as many points as B2 x 1024), so the last scale keeps 4 >=
    k_up points. The port's kNN(32) is knn_bruteforce (K6); both packages
    take it, so a last-bit distance tie cannot pick different neighbours,
    and it agrees with the JAX package's on >= 0.999 of the indices."""
    rng = np.random.default_rng(3)
    b, n = 1, 2048
    pos = rng.random((b, n, 3)).astype(np.float32)
    feats = rng.random((b, n, 6)).astype(np.float32)
    scales = _jax_pyramid(pos, jax.random.PRNGKey(1), k_up=3)
    idx = segnets._discrete_crf_idx(_t(scales[0].pos), EXACT)
    with jax.default_matmul_precision("highest"):
        jidx = np.asarray(jnb.knn_bruteforce(scales[0].pos, scales[0].pos,
                                             32))
    assert idx.shape == (b, n, 32) and (idx.numpy() == jidx).mean() >= 0.999
    batch = JBatch(x=jnp.asarray(feats), y=None, scales=scales)
    model = JBaseDisc(n_classes=20, steps=10)
    mp = pytest.MonkeyPatch()
    mp.setattr(jsegnets, "_discrete_crf_idx",
               lambda p_: jnp.asarray(idx.numpy()))
    try:
        with neighbor_mode("exact"), jax.default_matmul_precision("highest"):
            variables = _init(model, RNGS, batch)
            params = dict(variables["params"])
            crf_p = dict(params["crf"])
            crf_p["C"] = crf_p["C"] + 0.1 * jnp.asarray(
                rng.standard_normal((20, 20)).astype(np.float32))
            params["crf"] = crf_p
            variables = {"params": params, "batch_stats": _perturb_stats(
                variables["batch_stats"])}
            ref = [np.asarray(a) for a in _apply(model, variables, batch)]
    finally:
        mp.undo()
    port = _load(BaselineDiscreteCRFSegNet(20, 6, steps=10, device="cpu"),
                 variables)
    hits = _count_kernels(monkeypatch)
    monkeypatch.setattr(segnets, "_discrete_crf_idx", lambda p_, m_: idx)
    with torch.no_grad():
        got = port(PointBatch(x=_t(feats), y=None, scales=_scales(scales)),
                   EXACT)
    assert not hits
    for head, a, r in zip(("log p", "log q"), got, ref):
        assert a.shape == r.shape == (b, n, 20)
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-3, atol=1e-4,
                                   err_msg=head)


# ---------------------------------------------------------------------------
# the regime guard of the steps on a built pyramid
# ---------------------------------------------------------------------------


def test_steps_on_a_built_pyramid_name_its_regime():
    """A step on a built pyramid must be told its regime: the windowed
    default over an exact pyramid would gather wrong rows without an
    error."""
    with pytest.raises(ValueError, match="mode"):
        make_train_step(windowed=False)
    with pytest.raises(ValueError, match="mode"):
        make_eval_step(windowed=False)
    with pytest.raises(ValueError, match="windowed"):
        make_eval_step(EXACT, windowed=False, eval_views=2)
    make_train_step(EXACT, windowed=False)
    make_eval_step(EXACT, windowed=False)
    make_train_step()           # windowed: builds its own pyramid
    rng = np.random.default_rng(0)
    raw = RawBatch(pos=_t(rng.random((1, 256, 3)).astype(np.float32)),
                   x=_t(rng.random((1, 256, 6)).astype(np.float32)),
                   y=_t(rng.integers(0, 5, (1, 256))))
    scales = build_pyramid_device(raw.pos, device="cpu")
    batch = PointBatch(x=raw.x, y=raw.y, scales=scales)
    m = PointConvResNet(5, 6, layers=(8, 16, 32, 64, 128), device="cpu")
    out = make_train_step(EXACT, windowed=False)(
        TrainState.create(m, lr=0.01), batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(out["loss"]))

"""The discrete CRF of crfconv_tpu_torch against the JAX package on the CPU,
where each kernel wrapper runs its plain version: the fused core
(``ops/discrete_core.py``, kernels K13/K14 over K9/K12) forward and VJP
against ``crf._discrete_scan`` and the Pallas ``discrete_crf_core`` in
interpret mode, its backward against autograd in float64, the dispatch of
``discrete_crf_update``, ``DiscreteCRFConv`` through ``from_flax``, and the
full-width ``BaselineDiscreteCRFSegNet(steps=10)`` and ``DualCRFSegNet
(steps=10)`` at B2 x 1024 on one JAX-built pyramid."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.models import BaselineDiscreteCRFSegNet as JBaseDisc
from crfconv_tpu.models import DualCRFSegNet as JDual
from crfconv_tpu.models import segnets as jsegnets
from crfconv_tpu.models.discrete_crf import DiscreteCRFConv as JDiscrete
from crfconv_tpu.ops import crf as jcrf
from crfconv_tpu.ops import crf_pallas
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu_torch import BaselineDiscreteCRFSegNet, DualCRFSegNet
from crfconv_tpu_torch import from_flax
from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models import segnets
from crfconv_tpu_torch.models.discrete_crf import DiscreteCRFConv
from crfconv_tpu_torch.ops import crf, discrete_core
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from tests.test_torch_model import (
    RNGS, _apply, _init, _load, _perturb_stats, _pyramid, _scales,
    _sorted_cloud, _t,
)
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _exact_windowed_gather

WINDOWED = NeighborMode("windowed")
B, N = 2, 1024


@pytest.fixture(autouse=True)
def _exact_jax_gather(monkeypatch):
    """The JAX CPU gather selects with a hi/lo bfloat16 one-hot product (~16
    mantissa bits); taken exactly here (the function is the same)."""
    monkeypatch.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)


def _inputs(b, n, l, k, seed, reach=64, dup=False, masked=False):
    """p (row-stochastic), u = -log p, w (optionally with masked slots and
    an all-masked row), window-consistent idx (optionally duplicated),
    C near the identity."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, n, l))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    u = -np.log(np.maximum(p, 1e-12))
    w = 0.5 * rng.random((b, n, k))
    idx = np.clip(np.arange(n)[None, :, None]
                  + rng.integers(-reach, reach, (b, n, k)), 0, n - 1)
    if dup:
        idx[:, :, 1] = idx[:, :, 0]
    if masked:
        w[:, :, 2] = 0.0
        w[:, 5] = 0.0                    # an isolated point: all masked
    c = np.eye(l) + 0.05 * rng.standard_normal((l, l))
    return tuple(a.astype(np.float32) for a in (p, u, w)) + (
        idx.astype(np.int32), c.astype(np.float32))


SHAPES = [   # (b, n, l, k, steps, dup, masked)
    (1, 256, 20, 31, 10, False, False),   # ScanNet's classes, kNN 32 - self
    (2, 200, 13, 9, 3, True, True),       # n not a multiple of 64
]


def _jax_scan(p, u, w, idx, c, steps):
    return np.asarray(jcrf._discrete_scan(*map(jnp.asarray, (p, u, w, idx, c)),
                                          steps))


@pytest.mark.parametrize("b,n,l,k,steps,dup,masked", SHAPES)
def test_forward_matches_discrete_scan(b, n, l, k, steps, dup, masked):
    p, u, w, idx, c = _inputs(b, n, l, k, seed=l + n, dup=dup, masked=masked)
    ref = _jax_scan(p, u, w, idx, c, steps)
    got = discrete_core.discrete_core(*map(_t, (p, u, w, idx, c)), steps)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    if masked:   # an all-masked row is softmax(-u) = p
        np.testing.assert_allclose(got[:, 5].numpy(), p[:, 5], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("b,n,l,k,steps,dup,masked", SHAPES)
def test_forward_matches_pallas_interpret(b, n, l, k, steps, dup, masked):
    p, u, w, idx, c = _inputs(b, n, l, k, seed=l + n, dup=dup, masked=masked)
    ref = crf_pallas.discrete_crf_core(*map(jnp.asarray, (p, u, w, idx, c)),
                                       steps, 64, 128, True)
    got = discrete_core.discrete_core(*map(_t, (p, u, w, idx, c)), steps)
    # the Pallas kernel multiplies hi/lo bfloat16 splits of q and A
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def _port_grads(p, u, w, idx, c, steps, g):
    ts = [_t(a).requires_grad_() for a in (p, u, w, c)]
    out = discrete_core.discrete_core(ts[0], ts[1], ts[2], _t(idx), ts[3],
                                      steps)
    return [a.numpy() for a in torch.autograd.grad((out * _t(g)).sum(), ts)]


@pytest.mark.parametrize("b,n,l,k,steps,dup,masked,pallas", [
    SHAPES[0][:4] + (4,) + SHAPES[0][5:] + (False,),
    SHAPES[1] + (True,),
])
def test_backward_matches_jax(b, n, l, k, steps, dup, masked, pallas):
    """dp, du, dw and dC of the plain reverse recurrence (K14, K12) against
    the VJP of the scan and, on the shape with duplicated indices, masked
    slots and a partial tile, of the Pallas discrete_crf_core in interpret
    mode (the native backward kernel #14; ~8 s of tracing a shape)."""
    p, u, w, idx, c = _inputs(b, n, l, k, seed=l + n + 1, dup=dup,
                              masked=masked)
    g = np.random.default_rng(9).standard_normal(p.shape).astype(np.float32)
    got = _port_grads(p, u, w, idx, c, steps, g)
    jp, ju, jw, ji, jc = map(jnp.asarray, (p, u, w, idx, c))

    def vjp(fn):
        return jax.vjp(fn, jp, ju, jw, jc)[1](jnp.asarray(g))

    scan = vjp(lambda a, b_, c_, d: jcrf._discrete_scan(a, b_, c_, ji, d,
                                                        steps))
    for name, a, r in zip(("dp", "du", "dw", "dC"), got, scan):
        scale = float(np.abs(np.asarray(r)).max())
        # float32 sum order
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)
    if not pallas:
        return
    ref = vjp(lambda a, b_, c_, d: crf_pallas.discrete_crf_core(
        a, b_, c_, ji, d, steps, 64, 128, True))
    for name, a, r in zip(("dp", "du", "dw", "dC"), got, ref):
        scale = float(np.abs(np.asarray(r)).max())
        # the hi/lo bfloat16 splits of the Pallas kernel
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_backward_matches_autograd_f64():
    """The Function's backward (the written-out reverse recurrence) against
    autograd through the plain forward, in float64, with indices out of
    their window (clamped, some rows read zero), duplicates and masked
    slots."""
    p, u, w, idx, c = _inputs(2, 150, 7, 7, seed=3, reach=400, dup=True,
                              masked=True)
    ts = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
          for a in (p, u, w, c)]
    i = _t(idx)
    g = torch.randn(2, 150, 7, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(
        (discrete_core.discrete_core(ts[0], ts[1], ts[2], i, ts[3], 5)
         * g).sum(), ts)
    ref = torch.autograd.grad(
        (discrete_core.discrete_core_plain(ts[0], ts[1], ts[2], i, ts[3], 5)
         * g).sum(), ts)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("context,grad", [
    (torch.inference_mode, False), (torch.no_grad, False),
    (torch.enable_grad, True),
])
def test_core_saves_only_for_a_gradient(context, grad, monkeypatch):
    """With C a parameter (it needs a gradient in any grad mode), the core
    writes each step's message for the backward only when grad mode is on:
    serving runs under inference_mode and keeps no stacks."""
    msg_outs = []
    iterate = discrete_core.discrete_iterate

    def spy(*a, **kw):
        msg_outs.append(kw.get("msg_out"))
        return iterate(*a, **kw)

    monkeypatch.setattr(discrete_core, "discrete_iterate", spy)
    p, u, w, idx, c = _inputs(1, 64, 5, 7, seed=2)
    C = torch.nn.Parameter(_t(c))
    with context():
        q = discrete_core.discrete_core(_t(p), _t(u), _t(w), _t(idx), C, 3)
    assert len(msg_outs) == 3
    assert all((m is not None) == grad for m in msg_outs)
    assert q.requires_grad == grad


@pytest.mark.parametrize("mode,steps,fused", [
    (WINDOWED, 10, True), (WINDOWED, 1, False),
    (NeighborMode("exact"), 3, False),
])
def test_dispatch(mode, steps, fused, monkeypatch):
    """The windowed regime at steps >= 2 runs the fused core; the masked
    weights are zeroed first; the result is the JAX dispatch's (its scan on
    the CPU)."""
    cores = []
    core = crf.discrete_core
    monkeypatch.setattr(crf, "discrete_core",
                        lambda *a: cores.append(1) or core(*a))
    p, u, w, idx, c = _inputs(1, 256, 20, 15, seed=5)
    mask = np.random.default_rng(6).random(w.shape) < 0.7
    with neighbor_mode(mode.mode), jax.default_matmul_precision("highest"):
        ref = jcrf.discrete_crf_update(
            *map(jnp.asarray, (p, u, w, idx, c)), steps=steps,
            mask=jnp.asarray(mask), allow_fused=True)
    got = crf.discrete_crf_update(*map(_t, (p, u, w, idx, c)), steps, mode,
                                  mask=_t(mask))
    assert len(cores) == int(fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_discrete_crf_conv_matches():
    """DiscreteCRFConv at steps 10 with perturbed kernels and
    compatibilities, loaded through from_flax; the radius mask is neither
    empty nor full."""
    rng = np.random.default_rng(1)
    n = 512
    pos = _sorted_cloud(rng, 1, n)
    logits = rng.standard_normal((1, n, 20))
    p = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    f = rng.random((1, n, 6)).astype(np.float32)
    idx = np.asarray(jwin.window_knn(jnp.asarray(pos), 32))
    jargs = tuple(map(jnp.asarray, (pos, p, f, idx)))
    model = JDiscrete(n_classes=20, feat_features=6, steps=10)
    with neighbor_mode("windowed"), jax.default_matmul_precision("highest"):
        params = dict(jax.jit(lambda *a: model.init(
            jax.random.PRNGKey(0), *a, train=False))(*jargs)["params"])
        params["C"] = params["C"] + 0.1 * jnp.asarray(
            rng.standard_normal((20, 20)).astype(np.float32))
        params["W"] = params["W"] * jnp.asarray(
            [[0.5], [1.0], [1.5], [2.0], [2.5]], jnp.float32)
        ref = np.asarray(jax.jit(lambda v, *a: model.apply(
            v, *a, train=False))({"params": params}, *jargs))
    port = DiscreteCRFConv(20, 6, steps=10, device="cpu")
    port.load_state_dict(from_flax(jax.device_get(params), {}))
    d2 = ((pos[:, :, None] - pos[0][idx[0, :, 1:]]) ** 2).sum(-1)
    assert 0.05 < (d2 <= 0.04).mean() < 0.95
    with torch.no_grad():
        got = port(*map(_t, (pos, p, f, idx)), WINDOWED).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def discrete_nets():
    """Full-width BaselineDiscreteCRFSegNet(steps=10) and DualCRFSegNet
    (steps=10) on one JAX-built pyramid (B2 x 1024), variables with
    non-trivial batch statistics and compatibilities, and their JAX
    (log p, log q). Both packages take the discrete CRF's kNN(32) from the
    port's window_knn, so a last-bit distance tie cannot pick different
    neighbours."""
    rng = np.random.default_rng(3)
    pos = rng.random((B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 6)).astype(np.float32)
    order, scales = _pyramid(pos, jax.random.PRNGKey(1))
    x = jnp.take_along_axis(jnp.asarray(feats), order[..., None], axis=1)
    batch = JBatch(x=x, y=None, scales=scales)
    idx = segnets._discrete_crf_idx(_t(scales[0].pos), WINDOWED)
    out = {"x": x, "scales": scales, "idx": idx}
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    mp.setattr(jsegnets, "_discrete_crf_idx",
               lambda pos_: jnp.asarray(idx.numpy()))
    try:
        for name, model in (("baseline", JBaseDisc(n_classes=20, steps=10)),
                            ("dual", JDual(n_classes=20, steps=10))):
            with neighbor_mode("windowed"), \
                    jax.default_matmul_precision("highest"):
                variables = _init(model, RNGS, batch)
                params = dict(variables["params"])
                crf_p = dict(params["crf"])
                crf_p["C"] = crf_p["C"] + 0.1 * jnp.asarray(
                    rng.standard_normal((20, 20)).astype(np.float32))
                params["crf"] = crf_p
                variables = {"params": params, "batch_stats": _perturb_stats(
                    variables["batch_stats"])}
                out[name] = (variables,
                             [np.asarray(a) for a in
                              _apply(model, variables, batch)])
    finally:
        mp.undo()
    return out


def test_discrete_crf_idx_matches_jax(discrete_nets):
    """The port's kNN(32) for the discrete CRF against the JAX package's
    (exact selection: last-bit distance ties may order differently)."""
    pos0 = discrete_nets["scales"][0].pos
    with neighbor_mode("windowed"):
        ref = np.asarray(jwin.window_knn(pos0, 32))
    got = discrete_nets["idx"].numpy()
    assert got.shape == ref.shape == (B, N, 32)
    assert (got[:, :, 0] == np.arange(N)).all()
    assert (got == ref).mean() >= 0.999


@pytest.mark.parametrize("name", ["baseline", "dual"])
def test_discrete_segnet_log_probs_match(discrete_nets, name):
    variables, ref = discrete_nets[name]
    cls = BaselineDiscreteCRFSegNet if name == "baseline" else DualCRFSegNet
    model = _load(cls(20, 6, steps=10, device="cpu"), variables)
    batch = PointBatch(x=_t(discrete_nets["x"]), y=None,
                       scales=_scales(discrete_nets["scales"]))
    cores = []
    core = crf.discrete_core
    mp = pytest.MonkeyPatch()
    mp.setattr(crf, "discrete_core", lambda *a: cores.append(1) or core(*a))
    try:
        with torch.no_grad():
            got = model(batch, WINDOWED)
    finally:
        mp.undo()
    assert len(cores) == 1
    assert len(got) == len(ref) == 2
    for head, a, r in zip(("log p", "log q"), got, ref):
        assert a.shape == r.shape == (B, N, 20)
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-3, atol=1e-4,
                                   err_msg=head)


def test_from_flax_carries_the_crf(discrete_nets):
    variables = discrete_nets["baseline"][0]
    sd = from_flax(jax.device_get(variables["params"]),
                   jax.device_get(variables["batch_stats"]))
    model = BaselineDiscreteCRFSegNet(20, 6, steps=10, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    for leaf in ("F", "W", "C"):
        np.testing.assert_array_equal(
            sd[f"crf.{leaf}"].numpy(),
            np.asarray(variables["params"]["crf"][leaf]))


def test_fresh_discrete_crf_parameters():
    """flax's init of the head: F ~ U[0, 1), W = 1/5, C = I; the
    classifier 256 wide with zero biases."""
    model = BaselineDiscreteCRFSegNet(20, 6, steps=10, device="cpu")
    f = model.crf.F.detach()
    assert tuple(f.shape) == (5, 6, 64)
    assert 0.0 <= float(f.min()) and float(f.max()) < 1.0
    torch.testing.assert_close(model.crf.W, torch.full((5, 1), 0.2))
    torch.testing.assert_close(model.crf.C, torch.eye(20))
    assert model.classifier.fc1.out_features == 256
    assert not model.classifier.fc1.bias.any()

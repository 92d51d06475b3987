"""The port's bf16 compute mode on the CPU, against the JAX package's.

``compute_dtype_scope(torch.bfloat16)`` runs every MLP's product in
bfloat16, as ``set_compute_dtype(jnp.bfloat16)`` runs flax's
``nn.Dense(dtype=...)``: the flagship's bf16 forward against the JAX
package's f32 and bf16 forwards (tests/test_mixed_precision.py's bound, a
median absolute logit difference below 0.1); the loss in float32; the
windowed 2-view eval and curve-jitter train step of the flagship and of
CRFSegNet_Part against the JAX package's bf16 on the same weights, offsets
and rotation, through the same kernel wrappers called as often as in
float32, with a planted fault (the CRF message zeroed) that the bounds
must catch; and each kernel wrapper given bfloat16 (on the CPU,
its plain version): a bfloat16 result equal to the float32 result on the
same (bfloat16) values rounded once, and within rtol 1e-2 (plus 1e-2 of
the output's scale for entries near zero) of the float32 result on the
unrounded inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crfconv_tpu.data.batch import RawBatch as JRaw
from crfconv_tpu.data.pipeline import synthetic_batch
from crfconv_tpu.models import CRFSegNet_Part as JPart
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.models.common import compute_dtype_scope as jscope
from crfconv_tpu.ops import morton as jmorton
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch import (
    CRFSegNet_Part, PointConvResNet, RawBatch, TrainState, compute_dtype_scope,
    from_flax, get_compute_dtype,
)
from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models import crf_conv, point_conv_big
from crfconv_tpu_torch.ops import (
    activation, conv, crf_core, crf_sim, discrete_core, neighbors, windowed,
)
from crfconv_tpu_torch.ops.morton import morton_order
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train import train_state
from crfconv_tpu_torch.train.config import ShapeNetConfig
from crfconv_tpu_torch.train.losses import weighted_cross_entropy
from crfconv_tpu_torch.train.train_state import (
    make_eval_step, make_train_step,
)
from tests.test_torch_model import RNGS, _apply, _init, _load, _scales
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_train_step import _exact_windowed_gather

EXACT = NeighborMode("exact")
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship (8 classes, use_crf, steps=1) on
    test_mixed_precision.py's batch: its logits in float32 and bfloat16."""
    batch = synthetic_batch(1, 256, 6, 8, seed=9)
    model = JResNet(n_classes=8, use_crf=True, steps=1)
    with jax.default_matmul_precision("highest"):
        variables = _init(model, RNGS, batch)
        ref = np.asarray(_apply(model, variables, batch))
        with jscope(jnp.bfloat16):
            bf = np.asarray(_apply(model, variables, batch)).astype(np.float32)
    assert get_compute_dtype() is None
    return batch, variables, ref, bf


def _port_batch(batch):
    return PointBatch(x=torch.from_numpy(np.array(batch.x)), y=None,
                      scales=_scales(batch.scales))


def test_bf16_forward_matches_jax(flagship):
    batch, variables, ref, jbf = flagship
    model = _load(PointConvResNet(8, 6, use_crf=True, steps=1, device="cpu"),
                  variables)
    tb = _port_batch(batch)
    with torch.no_grad():
        f32 = model(tb, EXACT).numpy()
        with compute_dtype_scope(BF16):
            out = model(tb, EXACT)
    assert get_compute_dtype() is None
    # the classifier's last Dense is a bare nn.Dense in the JAX model:
    # float32 logits in either mode
    assert out.dtype == torch.float32
    out = out.numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(f32, ref, rtol=1e-3, atol=1e-4)
    assert np.median(np.abs(out - ref)) < 0.1
    # as close to the JAX package's bf16 mode as that is to its f32 mode
    assert np.median(np.abs(out - jbf)) <= np.median(np.abs(jbf - ref))


def test_bf16_loss_is_f32():
    scores = torch.zeros((16, 5), dtype=BF16)
    labels = torch.zeros((16,), dtype=torch.int64)
    loss = weighted_cross_entropy(scores, labels)
    assert loss.dtype == torch.float32
    assert np.isfinite(float(loss))


def test_scope_nests_and_restores():
    assert get_compute_dtype() is None
    with compute_dtype_scope(BF16):
        assert get_compute_dtype() is BF16
        with compute_dtype_scope(None):
            assert get_compute_dtype() is None
        with pytest.raises(RuntimeError):
            with compute_dtype_scope(torch.float16):
                raise RuntimeError
        assert get_compute_dtype() is BF16
    assert get_compute_dtype() is None


def test_mlp_product_in_bf16_params_and_grads_f32():
    from crfconv_tpu_torch.models.common import MLP

    mlp = MLP(6, 8, None, use_bn=False, device="cpu")
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(4, 6)
    with compute_dtype_scope(BF16):
        y = mlp(x)
    assert y.dtype == BF16
    want = torch.nn.functional.linear(x.to(BF16), mlp.weight.to(BF16),
                                      mlp.bias.to(BF16))
    assert torch.equal(y, want)
    y.float().sum().backward()
    assert mlp.weight.dtype == mlp.weight.grad.dtype == torch.float32
    assert mlp.bias.grad.dtype == torch.float32


# --------------------------------------------------------------------------
# the windowed path in bf16 against the JAX package's bf16
# --------------------------------------------------------------------------

BW, NW = 2, 512
# windowed with exact kNN selection: the JAX CPU path selects exactly
WMODE = NeighborMode("windowed", knn_exact=True)
EVAL_KEY, STEP_KEY = 3, 4
# bfloat16's unit roundoff: one rounding moves a value by at most this share
BF16_ROUNDOFF = 2.0 ** -8


def _net_spec(net):
    if net == "flagship":
        layers = (8, 16, 32, 64, 128)
        return dict(
            classes=13, category=None, opt=dict(lr=0.01), ignore=-1, offset=0,
            jax=lambda: JResNet(n_classes=13, use_crf=True, steps=1,
                                layers=layers, dropout_rate=0.0),
            port=lambda: PointConvResNet(13, 6, use_crf=True, steps=1,
                                         layers=layers, dropout_rate=0.0,
                                         device="cpu"))
    cfg = ShapeNetConfig()
    return dict(
        classes=cfg.num_classes, category=np.array([4, 12], np.int32),
        opt=dict(lr=cfg.lr, momentum=cfg.momentum,
                 weight_decay=cfg.weight_decay, gamma=cfg.gamma),
        ignore=cfg.ignore_index, offset=cfg.label_offset,
        jax=lambda: JPart(n_classes=cfg.num_classes, steps=cfg.steps),
        port=lambda: CRFSegNet_Part(cfg.num_classes, 6, steps=cfg.steps,
                                    device="cpu"))


def _state_dict(st):
    return from_flax(jax.device_get(st.params), jax.device_get(st.batch_stats))


@pytest.fixture(scope="module", params=["flagship", "part"])
def bf16_jax(request):
    """One net's JAX 2-view eval and curve-jitter train step, in float32
    and in bfloat16, from one state (dropout off; biases moved off the
    leaky ReLU's kink at 0, where torch's and JAX's gradients differ) with
    the JAX CPU gather taken exactly: the eval's probabilities, the step's
    train-mode outputs (caught where they reach the loss), its loss and
    updated state; and the offsets and rotation the JAX keys drew."""
    spec = _net_spec(request.param)
    rng = np.random.default_rng(1)
    pos = rng.random((BW, NW, 3)).astype(np.float32)
    feats = rng.random((BW, NW, 6)).astype(np.float32)
    y = rng.integers(0, spec["classes"], (BW, NW)).astype(np.int32)
    cat = spec["category"]
    raw = JRaw(pos=jnp.asarray(pos), x=jnp.asarray(feats), y=jnp.asarray(y),
               category=None if cat is None else jnp.asarray(cat))
    model = spec["jax"]()
    kw = dict(ignore_index=spec["ignore"], label_offset=spec["offset"],
              windowed=True)
    ekey, skey = jax.random.PRNGKey(EVAL_KEY), jax.random.PRNGKey(STEP_KEY)
    outs, runs = [], {}
    loss = jts.segmentation_loss

    def caught(outputs, *a):
        jax.debug.callback(
            lambda o: outs.append(np.asarray(o, np.float32)), outputs)
        return loss(outputs, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
        with neighbor_mode("windowed"), \
                jax.default_matmul_precision("highest"):
            example = jts.build_windowed_batch(raw, jax.random.PRNGKey(0))
            state = jts.create_train_state(
                model, example, jts.make_optimizer(**spec["opt"]), seed=0)
            gen = np.random.default_rng(5)
            params = jax.tree_util.tree_map_with_path(
                lambda path, a: a + np.float32(0.1) * gen.standard_normal(
                    a.shape, dtype=np.float32)
                if path[-1].key == "bias" else a,
                jax.device_get(state.params))
            state = state.replace(params=params,
                                  opt_state=state.tx.init(params))
            for dt in ("f32", "bf16"):
                with jscope(None if dt == "f32" else jnp.bfloat16):
                    ev = jax.jit(jts.make_eval_step(
                        model, eval_views=2, **kw))(state, raw, ekey)
                    with pytest.MonkeyPatch.context() as lp:
                        lp.setattr(jts, "segmentation_loss", caught)
                        new, m = jax.jit(jts.make_train_step(
                            model, curve_jitter=True, **kw))(state, raw, skey)
                        m = jax.device_get(m)
                        jax.effects_barrier()
                runs[dt] = {"probs": np.asarray(ev["probs"], np.float32),
                            "out": outs.pop(), "loss": float(m["loss"]),
                            "after": _state_dict(new)}
    assert not outs
    # the step splits off its pyramid key, which splits off the rotation's
    pk, rk = jax.random.split(jax.random.split(skey)[1])
    return {
        "net": request.param, "spec": spec, "runs": runs,
        "before": _state_dict(state),
        "raw": RawBatch(pos=_t(pos), x=_t(feats), y=_t(y),
                        category=None if cat is None else _t(cat)),
        "eval_offsets": [jax_offsets(jax.random.fold_in(ekey, v), NW)
                         for v in range(2)],
        "step_offsets": jax_offsets(pk, NW),
        "rotation": _t(jmorton.random_rotation(rk)),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def _counting(monkeypatch, sites):
    counts = {}
    for mod, name in sites:
        fn = getattr(mod, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrap)
    return counts


def _port_runs(jx, monkeypatch, counts=None):
    """The port's 2-view eval and curve-jitter step on the JAX runs'
    state, offsets and rotation, in float32 and in bfloat16."""
    spec = jx["spec"]
    monkeypatch.setattr(conv, "FUSED_MIN_ROWS", 0)       # K3 on the path
    monkeypatch.setattr(crf_sim, "SIM_MIN_ROWS", 0)      # K4 on the path
    monkeypatch.setattr(train_state, "random_rotation",
                        lambda g: jx["rotation"])
    kw = dict(ignore_index=spec["ignore"], label_offset=spec["offset"])
    loss = train_state.segmentation_loss
    outs, runs = [], {}
    for dt in ("f32", "bf16"):
        model = spec["port"]()
        model.load_state_dict(jx["before"])
        state = TrainState.create(model, **spec["opt"])
        if counts is not None:
            counts.clear()
        with compute_dtype_scope(None if dt == "f32" else BF16):
            ev = make_eval_step(WMODE, eval_views=2, **kw)(
                state, jx["raw"], offsets=jx["eval_offsets"])
            eval_counts = dict(counts or {})
            with pytest.MonkeyPatch.context() as lp:
                lp.setattr(train_state, "segmentation_loss",
                           lambda o, *a: outs.append(o.detach().float())
                           or loss(o, *a))
                m = make_train_step(WMODE, curve_jitter=True, **kw)(
                    state, jx["raw"], torch.Generator(),
                    offsets=jx["step_offsets"])
        runs[dt] = {"probs": ev["probs"].float().numpy(),
                    "out": outs.pop().numpy(), "loss": m["loss"],
                    "after": {k: v.clone() for k, v in
                              model.state_dict().items()},
                    "params": dict(model.named_parameters()),
                    "eval_counts": eval_counts, "counts": dict(counts or {})}
    assert get_compute_dtype() is None
    return runs


def _median_gap(a, b):
    return float(np.median(np.abs(a - b)))


def _log_softmax(a):
    return torch.log_softmax(torch.from_numpy(np.array(a, np.float64)),
                             -1).numpy()


def _spread(logp):
    """The median size of log-probabilities about their class mean: the
    logits' size, whatever their normaliser."""
    return float(np.median(np.abs(logp - logp.mean(-1, keepdims=True))))


def _update(after, before, names):
    return torch.cat([(after[n].double() - before[n].double()).flatten()
                      for n in sorted(names)])


def _bf16_gaps(jx, port):
    """The port's bf16 eval and step against the JAX package's bf16, each
    beside the yardsticks it is held to: JAX's own bf16-to-f32 distance,
    and one bf16 rounding of the logits' size."""
    j32, j16 = jx["runs"]["f32"], jx["runs"]["bf16"]
    p16 = port["bf16"]
    names = set(p16["params"])
    ev = [np.log(r["probs"]) for r in (j32, j16, p16)]
    st = [_log_softmax(r["out"]) for r in (j32, j16, p16)]
    up = [_update(r["after"], jx["before"], names) for r in (j32, j16, p16)]
    return {
        "eval": (_median_gap(ev[2], ev[1]), _median_gap(ev[1], ev[0]),
                 BF16_ROUNDOFF * _spread(ev[0])),
        "step": (_median_gap(st[2], st[1]), _median_gap(st[1], st[0]),
                 BF16_ROUNDOFF * _spread(st[0])),
        # the update: the port's bf16 against JAX's f32, held to JAX's bf16
        "update": (float((up[2] - up[0]).norm()),
                   float((up[1] - up[0]).norm())),
    }


def test_bf16_windowed_forward_and_step(bf16_jax, monkeypatch):
    """The 2-view eval and a curve-jitter train step in bf16 against the
    JAX package's bf16 on the same weights, offsets and rotation.

    The eval's log-probabilities: the median gap to JAX's bf16 no larger
    than JAX's bf16 is from its f32 (test_bf16_forward_matches_jax's rule)
    and below one bf16 rounding of the logits' median size. The step's
    train-mode outputs (as log-softmax) are held to the rule alone: the two
    packages round in different places, and a batch norm that normalizes
    by the batch's own statistics magnifies that, so their bf16 steps part
    by nearly as much as JAX's bf16 step does from its f32. The update:
    the port's bf16 no farther from JAX's f32 update than JAX's bf16 is.
    In f32 the port is JAX's (the 2-view eval's bound; the update within
    1e-3 of its size). The same wrapper calls in both dtypes; the loss,
    parameters and gradients float32."""
    counts = _counting(monkeypatch, [
        (neighbors, "windowed_gather"), (windowed, "window_knn"),
        (point_conv_big, "point_conv_fused_infer"),
        (crf_conv, "crf_similarity_message"),
        (windowed, "_windowed_gather_launch"),
        (windowed, "windowed_weighted_reduce"),
        (windowed, "windowed_gather_bwd"), (activation, "leaky_relu_bwd"),
        (crf_core, "crf_iterate_steps"), (crf_core, "crf_iterate_bwd"),
        (crf_core, "crf_neighbor_dot"),
    ])
    port = _port_runs(bf16_jax, monkeypatch, counts)
    p32, p16 = port["f32"], port["bf16"]
    j32 = bf16_jax["runs"]["f32"]
    assert p16["eval_counts"] == p32["eval_counts"]
    assert p16["counts"] == p32["counts"]
    c32 = p32["counts"]
    assert c32["leaky_relu_bwd"] > 0 and c32["windowed_gather_bwd"] > 0
    if bf16_jax["net"] == "flagship":
        # the six same-scale convs and the four CRFs' setups, both views
        assert p32["eval_counts"]["point_conv_fused_infer"] == 12
        assert p32["eval_counts"]["crf_similarity_message"] == 8
        assert c32["windowed_weighted_reduce"] > 0
    else:
        assert c32["crf_iterate_steps"] > 0 and c32["crf_iterate_bwd"] > 0
    # float32: the port is the JAX package's
    np.testing.assert_allclose(p32["probs"], j32["probs"], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(p32["loss"]), j32["loss"], rtol=1e-5)
    names = set(p32["params"])
    before = bf16_jax["before"]
    u32 = _update(j32["after"], before, names)
    assert float((_update(p32["after"], before, names) - u32).norm()) <= (
        1e-3 * float(u32.norm()))
    # bfloat16: against the JAX package's bfloat16
    gaps = _bf16_gaps(bf16_jax, port)
    gap, jax_gap, rounding = gaps["eval"]
    assert gap <= jax_gap and gap <= rounding, gaps
    gap, jax_gap, _ = gaps["step"]
    assert gap <= jax_gap, gaps
    assert gaps["update"][0] <= gaps["update"][1], gaps
    assert np.isfinite(p16["probs"]).all()
    assert p16["loss"].dtype == torch.float32
    assert np.isfinite(float(p16["loss"]))
    assert {p.dtype for p in p16["params"].values()} == {torch.float32}
    assert {p.grad.dtype for p in p16["params"].values()
            if p.grad is not None} == {torch.float32}


def test_bf16_bound_catches_zeroed_crf_message(bf16_jax, monkeypatch):
    """The bounds above bite: with every CRF message zeroed in the port
    (the similarity and the first message times 0) the eval breaks both of
    its bounds and the step's outputs their rule, each by a factor of 6 or
    more here, and the flagship's update its bound. (The part net's JAX
    bf16 update lies as far from its f32 update as the faulty one does:
    there the outputs are the check.)"""
    mean_field = crf_conv.crf_mean_field

    def zeroed(z, s, idx, c, steps, mode, neighbors0=None, msg0=None):
        return mean_field(z, s * 0, idx, c, steps, mode, neighbors0,
                          None if msg0 is None else msg0 * 0)

    monkeypatch.setattr(crf_conv, "crf_mean_field", zeroed)
    gaps = _bf16_gaps(bf16_jax, _port_runs(bf16_jax, monkeypatch))
    gap, jax_gap, rounding = gaps["eval"]
    assert gap > jax_gap and gap > rounding, gaps
    gap, jax_gap, _ = gaps["step"]
    assert gap > jax_gap, gaps
    if bf16_jax["net"] == "flagship":
        assert gaps["update"][0] > gaps["update"][1], gaps


# --------------------------------------------------------------------------
# each kernel wrapper given bf16
# --------------------------------------------------------------------------

B, N, K, H = 2, 256, 8, 8


def _cloud(seed=0):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((B, N, 3), generator=g)
    order = morton_order(pos)
    pos = torch.take_along_dim(pos, order[..., None], dim=1).contiguous()
    return pos, windowed.window_knn(pos, K), g


def _mlp_args(g):
    def r(*shape, scale=1.0):
        return (torch.rand(shape, generator=g) * scale).contiguous()
    return (r(3, H), r(H) + 0.5, r(H, scale=0.1), r(H, H, scale=0.3),
            r(H) + 0.5, r(H, scale=0.1))


def _cases():
    """(name, fn, args); narrow floats in args are the ones the test
    rounds to bfloat16."""
    pos, idx, g = _cloud()
    x = torch.rand((B, N, H), generator=g)
    u = torch.rand((B, N, K, H), generator=g)
    nidx = neighbors.remove_self_loop(idx)
    s = torch.softmax(torch.rand((B, N, K - 1), generator=g) * 4, dim=-1)
    M = torch.rand((H, H), generator=g) * 0.1
    p = torch.softmax(torch.rand((B, N, 4), generator=g) * 3, dim=-1)
    w = torch.rand((B, N, K - 1), generator=g) * 0.2
    C = torch.rand((4, 4), generator=g)
    sub = torch.arange(0, N, 4)
    sub_pos, sub_idx = pos[:, sub].contiguous(), idx[:, sub].contiguous()
    res = torch.rand((B, N, 2 * H), generator=g)
    d = torch.rand((B, 4, 64, 128), generator=g)
    w0, a0, c0, w1, a1, c1 = _mlp_args(g)
    return [
        ("windowed_gather", windowed.windowed_gather, (x, idx)),
        ("windowed_gather_bwd", windowed.windowed_gather_bwd,
         (torch.rand((B, N, K, H), generator=g), idx, N)),
        ("windowed_gather_bwd_plain", windowed.windowed_gather_bwd_plain,
         (torch.rand((B, N, K, H), generator=g), idx, N)),
        ("windowed_weighted_reduce", windowed.windowed_weighted_reduce,
         (x, u, idx)),
        ("windowed_weighted_reduce_plain",
         windowed.windowed_weighted_reduce_plain, (x, u, idx)),
        ("weighted_gather_reduce", windowed.weighted_gather_reduce,
         (x, u, idx)),
        ("point_conv_fused_infer", conv.point_conv_fused_infer,
         (x, pos, idx, w0, a0, c0, w1, a1, c1)),
        ("point_conv_fused_infer_plain", conv.point_conv_fused_infer_plain,
         (x, pos, idx, w0, a0, c0, w1, a1, c1)),
        ("point_conv_fused_strided", conv.point_conv_fused_strided,
         (x, pos, sub_pos, sub_idx, res, w0, a0, c0, w1, a1, c1)),
        ("point_conv_fused_strided_plain",
         conv.point_conv_fused_strided_plain,
         (x, pos, sub_pos, sub_idx, res, w0, a0, c0, w1, a1, c1)),
        ("crf_similarity_message", crf_sim.crf_similarity_message,
         (x, torch.rand((B, N, H), generator=g), nidx)),
        ("crf_similarity_message_plain", crf_sim.crf_similarity_message_plain,
         (x, torch.rand((B, N, H), generator=g), nidx)),
        ("crf_core", lambda *a: crf_core.crf_core(*a, steps=3),
         (x, torch.rand((B, N, H), generator=g), s, nidx, M)),
        ("crf_core_plain", lambda *a: crf_core.crf_core_plain(*a, steps=3),
         (x, torch.rand((B, N, H), generator=g), s, nidx, M)),
        ("discrete_core", lambda *a: discrete_core.discrete_core(*a, steps=3),
         (p, -torch.log(p), w, nidx, C)),
        ("discrete_core_plain",
         lambda *a: discrete_core.discrete_core_plain(*a, steps=3),
         (p, -torch.log(p), w, nidx, C)),
        ("leaky_relu_bwd", lambda a, b: activation.leaky_relu_bwd(a, b, 0.1),
         (x - 0.5, torch.rand((B, N, H), generator=g))),
        ("leaky_relu_bwd_plain",
         lambda a, b: activation.leaky_relu_bwd_plain(a, b, 0.1),
         (x - 0.5, torch.rand((B, N, H), generator=g))),
        ("window_knn", lambda q: windowed.window_knn(q, K), (pos,)),
        ("window_knn_plain", lambda q: windowed.window_knn_plain(q, K),
         (pos,)),
        ("select_min_k", lambda a: windowed.select_min_k(a, 5), (d,)),
        ("select_min_k_plain", lambda a: windowed.select_min_k_plain(a, 5),
         (d,)),
    ]


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_wrapper_takes_bf16(case):
    name, fn, args = next(c for c in _cases() if c[0] == case)
    narrow = [a.to(BF16) if isinstance(a, torch.Tensor)
              and a.is_floating_point() else a for a in args]
    with torch.no_grad():
        got = _outputs(fn(*narrow))
        once = _outputs(fn(*[a.float() if isinstance(a, torch.Tensor)
                             and a.is_floating_point() else a
                             for a in narrow]))
        ref = _outputs(fn(*args))
    for g_, o, r in zip(got, once, ref):
        if not r.is_floating_point():          # indices
            assert g_.dtype == r.dtype and torch.equal(g_, o)
            continue
        assert g_.dtype == BF16
        assert torch.equal(g_, o.to(BF16))
        scale = float(r.abs().max())
        assert torch.allclose(g_.float(), r, rtol=1e-2, atol=1e-2 * scale)


@pytest.mark.parametrize("case", ["windowed_gather", "weighted_gather_reduce",
                                  "crf_core", "discrete_core"])
def test_autograd_wrappers_give_bf16_gradients(case):
    """The autograd fronts widen outside their Functions: the gradients
    come back in the inputs' dtype and equal the float32 backward's,
    rounded."""
    name, fn, args = next(c for c in _cases() if c[0] == case)
    leaves = [a.to(BF16).requires_grad_() if isinstance(a, torch.Tensor)
              and a.is_floating_point() else a for a in args]
    out = _outputs(fn(*leaves))[0]
    assert out.dtype == BF16
    out.float().square().sum().backward()
    wide = [a.detach().float().requires_grad_() if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in leaves]
    out32 = _outputs(fn(*wide))[0]
    out32.to(BF16).float().square().sum().backward()
    for a, b in zip(leaves, wide):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            assert a.grad.dtype == BF16
            assert torch.equal(a.grad, b.grad.to(BF16))

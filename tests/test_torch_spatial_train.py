"""Point-sharded training of the port on the CPU: the step of
``parallel/spatial_train.py`` on two gloo ranks of a point group, and on
four ranks of a 2 (data) x 2 (points) grid, spawned through
``crfconv_tpu_torch.parallel.launch`` (``tests/test_torch_spatial_ranks.py``
says what each rank runs), against the one-process port step on the whole
batch and against the JAX package's ``make_spatial_train_step`` on a
2-device mesh of the conftest's virtual CPU devices.

The narrow flagship at B1 x 4096 (scales 4096 and 1024 sharded): two
steps at dropout 0 from the JAX initial weights (biases moved off zero,
as tests/test_torch_parallel.py does), held to JAX's tolerances of
tests/test_spatial_train.py: the loss at rtol 1e-5, the confusion equal,
every parameter and running statistic at rtol 2e-4, atol 2e-5, against
both references (the JAX gather taken exactly, as
tests/test_torch_train_step.py does); the ranks' states bit-equal. With
dropout 0.5 (the mask drawn at the global shape and sliced) and the CRF
at steps 2 the step runs in float64 against the one-process step, at rtol
1e-9: that holds every parameter's gradient, the replicated coarse
scales' included, where float32 rounding would hide a wrong sum.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crfconv_tpu.data.batch import PointBatch as JBatch
from crfconv_tpu.data.batch import ScaleData as JScale
from crfconv_tpu.models import PointConvResNet as JResNet
from crfconv_tpu.ops import windowed as jwin
from crfconv_tpu.ops.neighbors import neighbor_mode
from crfconv_tpu.parallel import make_mesh as jax_mesh
from crfconv_tpu.parallel.spatial_train import (
    make_spatial_train_step as jax_spatial_step,
)
from crfconv_tpu.train import train_state as jts
from crfconv_tpu_torch.models import get_model
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.parallel import launch
from tests import test_torch_spatial_ranks as ranks
from tests.test_torch_ops import few_torch_threads  # noqa: F401
from tests.test_torch_ops import jax_offsets
from tests.test_torch_parallel import _biased, _state_np
from tests.test_torch_train_step import _exact_windowed_gather

NARROW = (8, 16, 32, 64, 128)
N = 4096
STEPS = 2
KW = dict(n_classes=5, in_channels=6, use_crf=True, steps=1, layers=NARROW,
          dropout_rate=0.0)
TOL = dict(rtol=2e-4, atol=2e-5)
F64_TOL = dict(rtol=1e-9, atol=1e-12)
GRID_TOL = dict(rtol=1e-3, atol=5e-5)


def batch(b, seed, key, n=N):
    """B clouds' Morton-sorted features, labels and windowed pyramid (the
    JAX builder's offsets from ``key``): (the port's spec, the JAX
    batch)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((b, n, 3), dtype=np.float32)
    feats = rng.random((b, n, 6), dtype=np.float32)
    y = rng.integers(0, 5, (b, n)).astype(np.int32)
    order, scales = build_pyramid_windowed(
        pos, offsets=jax_offsets(key, n), device="cpu")
    o = order.numpy()
    x = np.take_along_axis(feats, o[..., None], 1)
    y = np.take_along_axis(y, o, 1)
    scales = [[t.numpy() for t in s] for s in scales]
    jb = JBatch(x=jnp.asarray(x), y=jnp.asarray(y), scales=tuple(
        JScale(*map(jnp.asarray, s)) for s in scales))
    return {"x": x, "y": y.astype(np.int64), "scales": scales}, jb


JMODEL = JResNet(n_classes=5, use_crf=True, steps=1, layers=NARROW,
                 dropout_rate=0.0)


def jax_state():
    """The JAX initial train state with its biases moved off zero (its
    shapes do not depend on the cloud's size: a 512-point cloud
    initialises it) and the port's state dict of it."""
    _, small = batch(1, 3, jax.random.PRNGKey(3), 512)
    with neighbor_mode("windowed"):
        tx = jts.make_optimizer(lr=0.05, steps_per_epoch=10)
        st = jts.create_train_state(JMODEL, small, tx, seed=0)
        params = _biased(st.params, 5)
        st = st.replace(params=params, opt_state=tx.init(params))
    return st, _state_np(params, st.batch_stats)


def jax_steps(st, jb):
    """JAX's point-sharded step on a 2-device mesh, STEPS times from
    ``st``: each step's loss, confusion and state."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jwin, "_windowed_gather_impl", _exact_windowed_gather)
    try:
        with neighbor_mode("windowed"), \
                jax.default_matmul_precision("highest"):
            step = jax_spatial_step(JMODEL, jax_mesh(2), jb)
            out = {"loss": [], "confusion": [], "states": []}
            for i in range(STEPS):
                st, m = step(st, jb, jax.random.PRNGKey(10 + i))
                out["loss"].append(float(m["loss"]))
                out["confusion"].append(np.asarray(m["confusion"]))
                out["states"].append(_state_np(st.params, st.batch_stats))
    finally:
        mp.undo()
    return out


def step_spec(state, b, **kw):
    return {"kind": "step", "model": "PointConvResNet", "model_kw": KW,
            "state": state, "batch": b, "steps": STEPS, "seed": 7, **kw}


def _launch(n, specs, pg_dir, box, key):
    try:
        box[key] = launch(ranks.run_scenarios, n, ["cpu"] * n, "gloo",
                          args=(specs,), init_method=f"file://{pg_dir}/pg",
                          timeout_s=600)
    except BaseException as e:      # raised below
        box[key + "_error"] = e


@pytest.fixture(scope="module")
def st(tmp_path_factory):
    """The ranks' steps (two ranks, then the four of the grid, in the
    background), the one-process steps and JAX's."""
    b1, jb1 = batch(1, 0, jax.random.PRNGKey(1))
    b2, _ = batch(2, 1, jax.random.PRNGKey(2))
    port = get_model("PointConvResNet", device="cpu",
                     **dict(KW, dropout_rate=0.5, steps=2))
    dropout_state = {k: v.numpy() for k, v in port.state_dict().items()}
    box = {}
    jst, start = jax_state()
    specs2 = {
        "step": step_spec(start, b1),
        "dropout64": step_spec(dropout_state, b1, float64=True, model_kw=dict(
            KW, dropout_rate=0.5, steps=2)),
    }
    specs4 = {"grid": step_spec(start, b2, grid=(2, 2)),
              "grid_dropout64": step_spec(dropout_state, b2, grid=(2, 2),
                                          float64=True, model_kw=dict(
                                              KW, dropout_rate=0.5))}

    def both():
        _launch(2, specs2, tmp_path_factory.mktemp("pg2"), box, "two")
        _launch(4, specs4, tmp_path_factory.mktemp("pg4"), box, "four")

    th = threading.Thread(target=both)
    th.start()
    try:
        jax_ref = jax_steps(jst, jb1)
        one = {name: ranks.step_scenario(None, spec)
               for specs in (specs2, specs4) for name, spec in specs.items()}
    finally:
        th.join(timeout=1260)
    assert not th.is_alive(), "the ranks did not finish"
    for k in ("two_error", "four_error"):
        if k in box:
            raise box[k]
    return {"two": box["two"], "four": box["four"], "one": one,
            "jax": jax_ref}


def _assert_states(got, ref, label, tol):
    assert set(got) == set(ref)
    for name in sorted(ref):
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(ref[name]),
                                   err_msg=f"{label}: {name}", **tol)


def _ranks_equal(results, name):
    first = results[0][name]
    for r in results[1:]:
        assert r[name]["loss"] == first["loss"]
        for sa, sb in zip(first["states"], r[name]["states"]):
            for k in sa:
                assert np.array_equal(sa[k], sb[k]), k
    return first


def _check(got, ref, label, tol, loss_rtol=1e-5):
    for i in range(STEPS):
        np.testing.assert_allclose(got["loss"][i], ref["loss"][i],
                                   rtol=loss_rtol, err_msg=f"{label} {i}")
        np.testing.assert_array_equal(got["confusion"][i],
                                      np.asarray(ref["confusion"][i]),
                                      err_msg=f"{label} {i}")
        _assert_states(got["states"][i], ref["states"][i], f"{label} {i}",
                       tol)


def test_step_matches_one_process_and_jax(st):
    """Two point-sharded steps at dropout 0 on two ranks: the one-process
    step's and JAX's point-sharded step's loss, confusion, parameters and
    running statistics after each step."""
    got = _ranks_equal(st["two"], "step")
    _check(got, st["one"]["step"], "one process", TOL)
    _check(got, st["jax"], "jax spatial step", TOL)


def test_dropout_step_float64_matches_one_process(st):
    """Dropout 0.5 and the CRF at steps 2, in float64: every parameter and
    statistic the one-process step's at rtol 1e-9 after each step."""
    got = _ranks_equal(st["two"], "dropout64")
    _check(got, st["one"]["dropout64"], "one process", F64_TOL,
           loss_rtol=1e-12)


def test_grid_step_matches_one_process(st):
    """A 2 x 2 grid on B2 x 4096: each data group a cloud, each point
    group its two spans; every rank's state equal, and the one-process
    step's on both clouds at the data-parallel steps' tolerance of
    tests/test_torch_parallel.py (rtol 1e-3, atol 5e-5: its statistics sum
    over four ranks in another order, and float32 parts by 3e-5 on one
    weight of the second step; the float64 grid step below holds the
    gradients at rtol 1e-9)."""
    got = _ranks_equal(st["four"], "grid")
    _check(got, st["one"]["grid"], "one process", GRID_TOL)


def test_grid_dropout_step_float64_matches_one_process(st):
    """The grid's step with dropout 0.5 in float64 (the mask's clouds by
    data rank and its points by point rank) at rtol 1e-9."""
    got = _ranks_equal(st["four"], "grid_dropout64")
    _check(got, st["one"]["grid_dropout64"], "one process", F64_TOL,
           loss_rtol=1e-12)

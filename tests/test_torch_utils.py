"""The port's utils (crfconv_tpu_torch/utils) and top-level exports on the
CPU, against the JAX package's: the visualization's arrays and files (PLY
and HTML byte for byte), ``StepTimer`` under one clock, ``device_time``'s
two modes, ``trace``'s file (also when the traced region raises), every
name of ``crfconv_tpu.__all__``, and the parity harness and utils importing
and running with JAX and the JAX package blocked."""

from __future__ import annotations

import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import crfconv_tpu
import crfconv_tpu_torch
from crfconv_tpu.utils import profiling as jprofiling
from crfconv_tpu.utils import visualization as jvis
from crfconv_tpu_torch.utils import device_time, profiling
from crfconv_tpu_torch.utils import visualization as vis

REPO = Path(__file__).resolve().parents[1]


def _blocks():
    """A room of 300 points in two overlapping blocks, with labels."""
    rng = np.random.default_rng(0)
    pos = rng.random((300, 3)).astype(np.float32)
    labels = rng.integers(0, 13, 300)
    b1 = {"pos": pos[:180], "indices": np.arange(180), "pred": labels[:180]}
    b2 = {"pos": pos[120:], "indices": np.arange(120, 300),
          "pred": labels[120:]}
    return pos, labels, [b1, b2]


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_assembly_and_colors_match_jax():
    pos, labels, blocks = _blocks()
    for num_points in (None, 320):
        got, filled = vis.assemble_room(blocks, num_points)
        ref, filled_j = jvis.assemble_room(blocks, num_points)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(filled, filled_j)
        vals = vis.assemble_values(blocks, "pred", num_points)
        np.testing.assert_array_equal(
            vals, jvis.assemble_values(blocks, "pred", num_points))
    assert filled[:300].all() and not filled[300:].any()
    np.testing.assert_array_equal(got[:300], pos)
    np.testing.assert_array_equal(vals[:300], labels)
    for lab in (labels, np.array([-3, 0, 12, 40])):
        np.testing.assert_array_equal(vis.labels_to_colors(lab),
                                      jvis.labels_to_colors(lab))


@pytest.mark.parametrize("color", ["labels", "rgb_float", "rgb_uint8"])
def test_ply_and_html_files_byte_equal(tmp_path, color):
    pos, labels, _ = _blocks()
    rng = np.random.default_rng(1)
    kw = {"labels": dict(labels=labels),
          "rgb_float": dict(rgb=rng.random((300, 3))),
          "rgb_uint8": dict(rgb=rng.integers(0, 256, (300, 3), np.uint8))}[
              color]
    for name, fn in (("room.ply", "export_colored_ply"),
                     ("room.html", "export_html")):
        got = getattr(vis, fn)(str(tmp_path / "port" / name), pos, **kw)
        ref = getattr(jvis, fn)(str(tmp_path / "jax" / name), pos, **kw)
        assert _read(got) == _read(ref)
    small = vis.export_html(str(tmp_path / "small.html"), pos, labels=labels,
                            max_points=100, title="t")
    assert _read(small) == _read(jvis.export_html(
        str(tmp_path / "small_j.html"), pos, labels=labels, max_points=100,
        title="t"))
    with pytest.raises(ValueError, match="labels or rgb"):
        vis.export_colored_ply(str(tmp_path / "none.ply"), pos)


def test_render_png(tmp_path):
    pytest.importorskip("matplotlib", reason="render_png needs matplotlib")
    pos, labels, _ = _blocks()
    f = vis.render_png(str(tmp_path / "out" / "room.png"), pos, labels)
    assert os.path.getsize(f) > 1000


def test_step_timer_matches_jax(monkeypatch):
    """Both timers under one scripted clock give the same summary."""
    summaries = []
    for timer_cls in (profiling.StepTimer, jprofiling.StepTimer):
        clock = iter([0.0, 0.5, 1.25, 2.0, 2.5, 3.75, 4.0])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        t = timer_cls(warmup_steps=2)
        for points in (10, 100, 100, 120, 80, 90, 110):
            t.tick(points)
        summaries.append(t.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 5 and summaries[0]["points_per_sec"] > 0


@pytest.mark.parametrize("mode", ["loop", "chain"])
@pytest.mark.parametrize("with_env", [False, True])
def test_device_time(mode, with_env):
    """A chain of 256 x 256 products, the carry a pair or (with ``env``)
    one matrix: seconds a call in (0, 1), as for the JAX package's."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.random((256, 256), np.float32))
    if with_env:
        t = device_time(lambda c, w: c @ w, a, iters=8, mode=mode, env=a)
    else:
        t = device_time(lambda c: (c[0] @ c[1], c[1]), (a, a), iters=8,
                        mode=mode)
    assert 0 < t < 1
    with pytest.raises(ValueError, match="mode"):
        device_time(lambda c: c, a, mode="graph")


@pytest.mark.parametrize("raises", [False, True])
def test_trace_writes_a_file(tmp_path, raises):
    """A Chrome trace of the region under log_dir, naming its operators;
    written too when the region raises (and the error goes on)."""
    a = torch.ones(64, 64)

    def region():
        with profiling.trace(str(tmp_path)):
            (a @ a).sum()
            if raises:
                raise KeyError("inside the trace")

    if raises:
        with pytest.raises(KeyError):
            region()
    else:
        region()
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    text = _read(files[0]).decode()
    assert "traceEvents" in text and "aten::mm" in text


def test_every_jax_export_has_its_counterpart():
    for name in crfconv_tpu.__all__:
        assert name in crfconv_tpu_torch.__all__, name
        assert getattr(crfconv_tpu_torch, name) is not None, name
    assert crfconv_tpu_torch.__version__ == crfconv_tpu.__version__


def test_parity_and_utils_run_without_jax(tmp_path):
    """With jax, flax and crfconv_tpu blocked, every module of the parity
    harness and the utils imports, and their functions run (the imports
    inside them included): the torch arm of a dry run, the rooms corpus,
    device_time, trace and the exports."""
    code = (
        "import sys, os, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'crfconv_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "import crfconv_tpu_torch.parity, crfconv_tpu_torch.utils\n"
        "mods = [m.name for pkg in (crfconv_tpu_torch.parity,\n"
        "                           crfconv_tpu_torch.utils)\n"
        "        for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                       pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "want = {'crfconv_tpu_torch.parity.' + m for m in\n"
        "        ('__main__', 'oracle', 'synthetic')} | {\n"
        "        'crfconv_tpu_torch.utils.' + m for m in\n"
        "        ('benchtools', 'profiling', 'visualization')}\n"
        "assert want <= set(mods), mods\n"
        "from crfconv_tpu_torch.parity import __main__ as cli, synthetic\n"
        "from crfconv_tpu_torch.utils import device_time, profiling\n"
        "from crfconv_tpu_torch.utils import visualization as vis\n"
        "tmp = sys.argv[1]\n"
        "os.environ['CRFCONV_PARITY_ARM'] = 'torch'\n"
        "res = cli.main(['--root', os.path.join(tmp, 'dry'), '--dry-run',\n"
        "                '--num-votes', '2', '--device', 'cpu'])\n"
        "assert res['pending'] == 'port' and res['torch'], res\n"
        "assert synthetic.make_synthetic_rooms(os.path.join(tmp, 'rooms'),\n"
        "    rooms_per_area=1, pts_per_room=500) > 0\n"
        "a = torch.ones(8, 8)\n"
        "assert device_time(lambda c: c @ a, a, iters=2) > 0\n"
        "with profiling.trace(os.path.join(tmp, 'trace')):\n"
        "    a @ a\n"
        "pos = np.zeros((4, 3), np.float32)\n"
        "vis.export_html(os.path.join(tmp, 'v.html'), pos, labels=[0] * 4)\n"
        "vis.export_colored_ply(os.path.join(tmp, 'v.ply'), pos, [1] * 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'crfconv_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                   check=True)

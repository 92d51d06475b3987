"""The ``scannet.serve`` cell at a size the CPU holds: its traffic keys are
its loop's, its ladder does not move with the seed, the CRFSegNet
reference imports nothing of the program and builds the program's 3-NN
pyramid index for index, a sound run is correct and reads 40 steps, the
TF32 control is not, and the cell's readers read hand-made readings and
read nothing where the program has no CRF span or counter."""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import checks, flops, harness
from portbench.mixes import serve_scenes
from portbench.reference import crfsegnet, pyramid

ROOT = Path(__file__).resolve().parent.parent.parent
CELL = "scannet.serve"
SMALL = {"sample_num": 1024}
FEW = {"pool": 3, "block_step": 2, "rooms": 2, "points_per_m2": 600,
       "warmup_requests": 3, "checked_requests": 2, "profiled_requests": 2}


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_the_traffic_keys_are_the_loops():
    cell = harness.load_cell(CELL)
    assert cell.loop is serve_scenes
    assert set(cell.mix) - {"loop", "why"} == set(serve_scenes.PARAMS)
    assert serve_scenes.ladder(cell.mix) == list(range(8, 129, 8))
    assert cell.cfg["k_up"] == 3 and cell.cfg["steps"] == 10


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.crfsegnet; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('crfconv_tpu_torch', 'crfconv_tpu', 'jax', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_ladder_is_the_same_under_every_seed():
    cell = harness.load_cell(CELL, overrides=SMALL, mix_overrides=FEW)
    a = serve_scenes.make_scenes(cell.cfg, cell.mix, 3)
    b = serve_scenes.make_scenes(cell.cfg, cell.mix, 2**31 + 3)
    assert [p.shape for p, _, _ in a] == [p.shape for p, _, _ in b] == [
        (k, 1024, 3) for k in (2, 4, 6)]
    assert not torch.equal(a[0][0], b[0][0])
    for pos, feats, offs in a:
        # each block a 1.5 m column, turned about z: no two of its points
        # farther apart across than the column's diagonal
        xy = pos[..., :2]
        assert float(torch.cdist(xy, xy).max()) <= 1.5 * 2 ** 0.5 + 1e-4
        assert torch.allclose(feats[..., 3:6].mean(dim=1),
                              torch.zeros(1, 3), atol=1e-4)
        assert [o.shape[0] for o in offs] == [256, 64, 16, 4, 2]


def test_the_reference_pyramid_is_the_programs_at_k_up_3():
    from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed

    cell = harness.load_cell(CELL, overrides=SMALL, mix_overrides=FEW)
    pos, _, offs = serve_scenes.make_scenes(cell.cfg, cell.mix, 5)[1]
    order, scales = build_pyramid_windowed(
        pos, offsets=offs, knn_exact=False, k_up=3, device="cpu")
    r_order, r_scales = pyramid.build(pos, offs, [16] * 5, [4, 4, 4, 4, 2],
                                      3)
    assert torch.equal(order, r_order)
    for got, want in zip(scales, r_scales):
        assert torch.equal(got.neighbor_idx.long(), want["nbr"])
        assert torch.equal(got.up_idx.long(), want["up"])


def test_a_sound_run_is_correct_and_runs_forty_steps():
    res = harness.run(CELL, 2**31 + 101, 1.0, True, "cpu",
                      overrides=SMALL, mix_overrides=FEW)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["crf_steps.serve"]["value"] == 40


@pytest.mark.parametrize("seed", [1, 2**31 + 102])
def test_the_control_is_not_correct(seed):
    cell = harness.load_cell(CELL, overrides=SMALL, mix_overrides=FEW)
    numbers = serve_scenes.control(cell, seed, "cpu")
    assert not checks.verdict({k: {"value": numbers[k], "limit": lim}
                               for k, lim in cell.limits.items()}), numbers


def _read(name, r):
    return harness.load_reader(name)(r)


def test_the_readers_on_hand_made_readings():
    crf = {"crf_ms": 12.5, "forward_ms": 30.0, "crf_spans": 4.0,
           "steps": 40.0, "bound_s": 0.002, "device_s": 0.008, "calls": 8.0}
    r = SimpleNamespace(crf=crf)
    assert _read("crf_ms.serve", r) == 12.5
    assert _read("crf_steps.serve", r) == 40.0
    assert _read("crf_roofline.serve", r) == pytest.approx(25.0)
    # a program without the span or the counter, or without the cell's
    # readings at all, reads nothing
    bare = {**crf, "crf_ms": None, "steps": None}
    for name in ("crf_ms.serve", "crf_steps.serve"):
        assert _read(name, SimpleNamespace(crf=bare)) is None
        assert _read(name, SimpleNamespace()) is None
    no_device = SimpleNamespace(crf={**crf, "device_s": 0.0})
    assert _read("crf_roofline.serve", no_device) is None
    assert _read("crf_roofline.serve", SimpleNamespace()) is None


def test_the_operation_count_by_hand():
    cfg = {**harness.load_cell(CELL).cfg, "batch_size": 1}
    n = [8192, 2048, 512, 128, 32, 16]
    enc = 0.0
    cin = 6
    for s, ch in enumerate(crfsegnet.CHANNELS):
        if s:
            enc += crfsegnet.ds_conv_flops(n[s - 1], n[s], 16, cin, ch, True)
        else:
            enc += crfsegnet.ds_conv_flops(n[0], n[0], 16, cin, ch, False)
        enc += crfsegnet.ds_conv_flops(n[s], n[s], 16, ch, ch, False)
        cin = ch
    dec = 0.0
    cin = 512
    for i, ch in crfsegnet.DECODER:
        rows, skip = n[i - 1], crfsegnet.CHANNELS[i - 1]
        dec += (2 * rows * 3 * cin + 2 * rows * (cin + skip) * ch
                + rows * 15 * (3 * ch + 3)
                + 10 * (2 * rows * 15 * ch + 4 * rows * ch * ch + rows * ch))
        if i > 1:
            dec += 2 * rows * (ch + skip) * ch
        cin = ch
    head = flops.linear(8192, 64, 128) + flops.linear(8192, 128, 20)
    assert crfsegnet.forward_flops(cfg) == pytest.approx(enc + dec + head)

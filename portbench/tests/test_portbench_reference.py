"""The port's CPU path held to the benchmark's plain reference at a tiny
size: the windowed pyramid index for index, and the harness's own
comparison served and trained (three steps)."""

import pytest
import torch

from portbench import harness, rooms
from portbench.reference import pyramid

SMALL = {"batch_size": 2, "sample_num": 2048}
FEW = {"pool": 4, "rooms": 4}
# every sampled request served within the window, also on a busy CPU
SERVE = {"pool": 2, "rooms": 2, "checked_requests": 2, "warmup_requests": 1}


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_pyramid_matches_the_port(seed):
    from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed

    pos, _, _ = rooms.make_clouds(seed, 2, 4096, 6, 8, 1)
    pos = torch.as_tensor(pos)
    gen = torch.Generator().manual_seed(seed)
    offsets, n = [], 4096
    for r in (4, 4, 4, 4, 2):
        offsets.append(torch.randint(0, r, (n // r,), generator=gen))
        n //= r
    order, scales = build_pyramid_windowed(
        pos, offsets=offsets, knn_exact=False, k_up=1, device="cpu")
    r_order, r_scales = pyramid.build(pos, offsets, [16] * 5,
                                      [4, 4, 4, 4, 2], 1)
    assert torch.equal(order, r_order)
    for got, want in zip(scales, r_scales):
        assert torch.equal(got.pos, want["pos"])
        assert torch.equal(got.neighbor_idx.long(), want["nbr"])
        assert torch.equal(got.sub_idx.long(), want["sub"])
        assert torch.equal(got.up_idx.long(), want["up"])


@pytest.mark.parametrize("seed", [11, 2**31 + 11])
def test_serving_matches_the_reference(seed):
    _, out = harness.measure("semantic3d.serve", seed, 4.0, False, "cpu",
                             overrides=SMALL, mix_overrides=SERVE)
    assert set(out["checks"]) == {"served_gap"}
    assert out["checks"]["served_gap"] < 1e-4


@pytest.mark.parametrize("seed", [12, 2**31 + 12])
def test_training_matches_the_reference(seed):
    _, out = harness.measure("semantic3d.train", seed, 0.1, False, "cpu",
                             overrides=SMALL, mix_overrides=FEW)
    num = out["checks"]
    assert num["loss_gap"] < 1e-5 and num["loss_gap_first"] < 1e-5
    assert num["grad_gap_median"] <= num["grad_gap"]
    assert num["update_gap_median"] <= num["update_gap"]
    assert num["grad_gap"] < 1e-4
    assert num["update_gap"] < 1e-2


def test_the_float32_reference_lies_within_rounding_of_float64():
    from portbench import calibrate

    cell, out = harness.measure("semantic3d.train", 13, 0.1, False, "cpu",
                                overrides=SMALL, mix_overrides=FEW)
    look = calibrate.look_float64(cell, 13, out["program"], "cpu")
    for side in ("float32_vs_float64", "program_vs_float64"):
        num = look[side]
        assert num["loss_gap"] < 1e-6 and num["grad_gap"] < 1e-3, (side, num)
        assert num["update_gap_median"] < 1e-4, (side, num)

"""The frozen counts against hand counts at tiny shapes: ``bounds.bound_of``
(bytes over 3.35 TB/s or operations over 67 TFLOP/s, in ms) and the
model-operation count of ``flops.py`` and the reference models."""

import json
from pathlib import Path

import pytest
import torch

from portbench import bounds, flops
from portbench.reference import pointconvbig

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
BW, OPS = 3.35e12, 67e12


def test_bound_gather_is_bytes():
    x = torch.zeros(1, 4, 2)
    idx = torch.zeros(1, 4, 3, dtype=torch.int32)
    out = torch.zeros(1, 4, 3, 2)
    ms, by = bounds.bound_of("windowed_gather", (x, idx, 64, 128), out)
    assert by == "bytes"
    assert ms == pytest.approx((32 + 48 + 96) / BW * 1e3)


def test_bound_knn_is_operations():
    pos = torch.zeros(1, 100, 3)
    out = torch.zeros(1, 100, 4, dtype=torch.int32)
    ms, by = bounds.bound_of("window_knn", (pos, 4, None, 64, 128, False),
                             out)
    # window width 64 + 2 * (128 + 64) + 8 = 456, rounded up to 512
    assert by == "operations"
    assert ms == pytest.approx(100 * 512 * 9 / OPS * 1e3)


def test_bound_point_conv_and_crf():
    x = torch.zeros(1, 8, 4)
    idx = torch.zeros(1, 8, 3, dtype=torch.int32)
    ms, _ = bounds.bound_of("point_conv_fused_infer",
                            (x, torch.zeros(1, 8, 3), idx), x)
    assert ms == pytest.approx(max(
        (128 + 96 + 96 + 128) / BW, 8 * 3 * (2 * 16 + 44 + 3) / OPS) * 1e3)
    z = torch.zeros(2, 5, 4)
    s = torch.zeros(2, 5, 6)
    args = (z, z, s, torch.zeros(2, 5, 6, dtype=torch.int32),
            torch.zeros(4, 4), 3)
    ms, _ = bounds.bound_of("crf_iterate", args, z)
    ops = 2 * 5 * (2 * 6 * 4 + 2 * 16) * 3
    nb = (160 + 160 + 240 + 240 + 64) + 160
    assert ms == pytest.approx(max(nb / BW, ops / OPS) * 1e3)


def test_flops_primitives():
    assert flops.linear(3, 4, 5) == 120
    # weight net 3->4->4 on 6 offsets (72 + 96 multiply-adds), sum 24
    assert flops.point_conv(2, 3, 4) == 144 + 192 + 48
    assert flops.similarity(2, 3, 4) == 2 * 3 * 15
    assert flops.mean_field(2, 3, 4, 2) == 2 * (48 + 128 + 8)


def _cfg(name, **kw):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(kw)
    return cfg


def test_pointconvbig_count_by_hand():
    cfg = _cfg("pointconvbig-semantic3d", batch_size=2, sample_num=64,
               layers=[4, 8, 8, 8, 8], in_channels=2, num_classes=3,
               ratios=[4, 2, 2, 2, 2], kernel_sizes=[5, 4, 4, 3, 3])
    n = [64, 16, 8, 4, 2, 1]
    K = cfg["kernel_sizes"]
    lin = lambda r, a, b: 2 * r * a * b  # noqa: E731

    def block(src, m, k, cin, cout, strided):
        h = cout // 4
        ops = lin(src, cin, h) + lin(m * k, 3, h) + lin(m * k, h, h) \
            + 2 * m * k * h + lin(m, h, cout)
        ops += lin(src, cin, cout) if cin != cout else 0
        return ops + (m * k * cout if strided else 0)

    want = (block(64, 64, 5, 2, 4, False) + block(64, 64, 5, 4, 4, False)
            + block(64, 16, 5, 4, 8, True) + block(16, 16, 4, 8, 8, False))
    for s in (2, 3, 4):
        want += block(n[s - 1], n[s], K[s - 1], 8, 8, True)
        want += block(n[s], n[s], K[s], 8, 8, False)
    L = [4, 8, 8, 8, 8]
    for lvl in (3, 2, 1, 0):
        s_rows, rows, kc = n[lvl + 1], n[lvl], K[lvl] - 1
        down, skip = L[lvl + 1], L[lvl]
        h = skip // 4
        want += (lin(s_rows, down, h) + lin(s_rows, h, h) + lin(rows, skip, h)
                 + lin(rows, h, h) + rows * kc * (3 * h + 3)
                 + (2 * rows * kc * h + 4 * rows * h * h + rows * h)
                 + lin(rows, h, skip) + lin(rows, 2 * skip, skip))
    want += lin(64, 4, 16) + lin(64, 16, 3)
    assert pointconvbig.forward_flops(cfg) == pytest.approx(2 * want)
    assert flops.model_flops(pointconvbig, cfg, True) == pytest.approx(
        6 * want)

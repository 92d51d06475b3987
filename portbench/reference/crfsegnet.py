"""Reference of ScanNet's CRFSegNet (``CRFSegNet(20, 6, steps=10)``): a
five-stage encoder of depthwise-separable point convolutions, a decoder of
3-NN interpolations each refined by a guided continuous Gaussian CRF, and
a classifier, in evaluation (the running batch-norm statistics).

Written from the model's published description (CRFConv's
point_conv_small.py, crf_conv.py and segnets.py), one layer to a function,
over the reference pyramid (``pyramid.build``). Leaf names follow the
program's state dict, so the benchmark loads one set of weights into both.

- DSPointConv(c_in, c): h = MLP c_in -> c/4 (LeakyReLU 0.01) on the
  inputs; w = MLP 3 -> c/4 (LeakyReLU 0.01) -> c/4 on p_i - p_j;
  out_i = MLP c/4 -> c (sum_k w_ik * h_j) plus the shortcut (x, max-pooled
  over the neighbours where strided, then MLP c_in -> c where the widths
  differ), then LeakyReLU 0.01. Each stage: a strided conv (from the second
  stage on), then a same-scale one; 32, 64, 128, 256, 512 channels.
- Interpolation, coarse to fine: the features of the ``k_up`` nearest
  coarse points weighted by 1 / max(|p_i - p_j|^2, 1e-8), normalised.
- GuideCRFConv(c_in, c_skip, c): z = MLP c_in -> c (no activation) on the
  interpolated features, y = MLP c_skip -> c (LeakyReLU 0.01) on the skip
  features; s = softmax_k(-|y_i - y_j|^2) over the K - 1 neighbours less
  the point itself, neighbours farther than ``radius`` masked out (the
  published radius graph, r = 0.2); ``steps`` Jacobi steps
  x <- (z + (S x) C)(I + C)^-1 from x = z, C = c^T c; LeakyReLU 0.01.
  A fusion MLP [x, skip] -> c (LeakyReLU 0.01) follows every decoder but
  the last.
- Classifier: [decoder, finest encoder features] (64) -> Linear 128, ReLU,
  Linear -> classes, then log-softmax.

Departures from the published model, all shared with the program: the
radius graph is the in-window kNN of the pyramid with the radius as a mask
(the published graph keeps up to 32 neighbours inside r; here the K - 1
nearest in the point's window, those beyond r masked); the interpolation's
neighbours are the pyramid's window kNN, not a global search; MLPs are
Linear -> batch norm -> activation, the Linear without a bias.
"""

from __future__ import annotations

import torch

from portbench import flops as F
from portbench.reference.nn import leaky, masked_softmax, mlp, mlp_spec
from portbench.reference.pointconvbig import mean_field
from portbench.reference.pyramid import gather

CHANNELS = (32, 64, 128, 256, 512)
# (scale, channels) of the four decoders, coarse to fine
DECODER = ((4, 256), (3, 128), (2, 64), (1, 32))
CLASSIFIER_HIDDEN = 128
EPS = 1e-8          # the interpolation's least squared distance


def _encoder_plan(cfg):
    """[(name, c_in, c_out, stage, strided)] of the ten point convs."""
    out, cin = [], cfg["in_channels"]
    for stage, ch in enumerate(CHANNELS):
        out.append((f"feature.encoder.conv{stage + 1}_1", cin, ch, stage,
                    stage > 0))
        out.append((f"feature.encoder.conv{stage + 1}_2", ch, ch, stage,
                    False))
        cin = ch
    return out


def param_spec(cfg) -> list:
    """(name, shape, kind) of every leaf, in the program's order."""
    spec = []
    for p, cin, cout, _, _ in _encoder_plan(cfg):
        h = cout // 4
        spec += mlp_spec(p + ".mlp2", cin, h)
        if cin != cout:
            spec += mlp_spec(p + ".mlp4", cin, cout)
        spec += mlp_spec(p + ".mlp1_0", 3, h)
        spec += mlp_spec(p + ".mlp1_1", h, h)
        spec += mlp_spec(p + ".mlp3", h, cout)
    cin = CHANNELS[-1]
    for i, ch in DECODER:
        p = f"feature.deconv{i}"
        spec.append((p + ".c", (ch, ch), "compat"))
        spec += mlp_spec(p + ".unary", cin, ch)
        spec += mlp_spec(p + ".pairwise", CHANNELS[i - 1], ch)
        if i > 1:
            spec += mlp_spec(f"feature.fusion{i - 1}", ch + CHANNELS[i - 1],
                             ch)
        cin = ch
    spec += mlp_spec("classifier.fc1", 2 * CHANNELS[0], CLASSIFIER_HIDDEN,
                     bn=False)
    spec += mlp_spec("classifier.fc2", CLASSIFIER_HIDDEN, cfg["num_classes"],
                     bn=False)
    return spec


def _ds_conv(W, p, x, pos, idx, sub_pos, mm):
    h = mlp(W, p + ".mlp2", x, 0.01, False, mm)
    residual = x if sub_pos is None else gather(x, idx).amax(dim=2)
    if p + ".mlp4.weight" in W:
        residual = mlp(W, p + ".mlp4", residual, None, False, mm)
    center = pos if sub_pos is None else sub_pos
    rel = center[:, :, None, :] - gather(pos, idx)
    w = mlp(W, p + ".mlp1_0", rel, 0.01, False, mm)
    w = mlp(W, p + ".mlp1_1", w, None, False, mm)
    h = mlp(W, p + ".mlp3", (w * gather(h, idx)).sum(dim=2), None, False, mm)
    return leaky(h + residual, 0.01)


def _interpolate(x, pos_src, pos_dst, up):
    d2 = (pos_dst[:, :, None, :] - gather(pos_src, up)).square().sum(dim=-1)
    w = 1.0 / torch.clamp(d2, min=EPS)
    w = w / w.sum(dim=-1, keepdim=True)
    return (w[..., None] * gather(x, up)).sum(dim=2)


def _guide_crf(W, p, x, y, pos, nbr, steps, radius, mm):
    nidx = nbr[:, :, 1:]
    z = mlp(W, p + ".unary", x, None, False, mm)
    g = mlp(W, p + ".pairwise", y, 0.01, False, mm)
    d2 = (pos[:, :, None, :] - gather(pos, nidx)).square().sum(dim=-1)
    logits = -(g[:, :, None, :] - gather(g, nidx)).square().sum(dim=-1)
    s = masked_softmax(logits, d2 <= radius * radius, dim=2)
    return leaky(mean_field(z, s, nidx, W[p + ".c"], steps, mm), 0.01)


def forward(W, x, scales, cfg, train=False, mm="float32", gen=None):
    """Log-probabilities [B, N, classes] of the Morton-sorted features
    ``x`` over the reference pyramid's ``scales``, in evaluation (the
    benchmark serves this configuration; ``train`` must be False and
    ``gen`` is not used)."""
    if train:
        raise ValueError("the CRFSegNet reference is an evaluation forward")
    s = scales
    feats = []
    for p, _, _, stage, strided in _encoder_plan(cfg):
        if strided:
            x = _ds_conv(W, p, x, s[stage - 1]["pos"], s[stage - 1]["sub"],
                         s[stage]["pos"], mm)
        else:
            x = _ds_conv(W, p, x, s[stage]["pos"], s[stage]["nbr"], None,
                         mm)
        if p.endswith("_2"):
            feats.append(x)
    h = feats[4]
    for i, _ in DECODER:
        h = _interpolate(h, s[i]["pos"], s[i - 1]["pos"], s[i - 1]["up"])
        guide = feats[i - 1]
        h = _guide_crf(W, f"feature.deconv{i}", h, guide, s[i - 1]["pos"],
                       s[i - 1]["nbr"], cfg["steps"], cfg["radius"], mm)
        if i > 1:
            h = mlp(W, f"feature.fusion{i - 1}",
                    torch.cat([h, guide], dim=-1), 0.01, False, mm)
    h = torch.cat([h, feats[0]], dim=-1)
    h = mlp(W, "classifier.fc1", h, 0.0, False, mm, bn=False)
    h = mlp(W, "classifier.fc2", h, None, False, mm, bn=False)
    return torch.log_softmax(h, dim=-1)


def ds_conv_flops(src: int, m: int, k: int, cin: int, cout: int,
                  strided: bool) -> float:
    """One DSPointConv: ``src`` input rows, ``m`` output rows, ``k``
    neighbours."""
    h = cout // 4
    ops = F.linear(src, cin, h) + F.point_conv(m, k, h) + F.linear(m, h, cout)
    if cin != cout:
        ops += F.linear(m, cin, cout)
    if strided:
        ops += float(m * k * cin)
    return ops


def forward_flops(cfg) -> float:
    """Model operations of one forward of a batch of ``batch_size`` blocks
    (``flops``), with the interpolations' weighted sums counted as
    neighbour sums (a multiply and an add per neighbour and channel)."""
    K = cfg["kernel_sizes"]
    n = [cfg["sample_num"]]
    for r in cfg["ratios"]:
        n.append(max(n[-1] // r, 1))
    total = 0.0
    for _, cin, cout, stage, strided in _encoder_plan(cfg):
        src = n[stage - 1] if strided else n[stage]
        k = K[stage - 1] if strided else K[stage]
        total += ds_conv_flops(src, n[stage], k, cin, cout, strided)
    cin = CHANNELS[-1]
    for i, ch in DECODER:
        rows, skip, kc = n[i - 1], CHANNELS[i - 1], K[i - 1] - 1
        total += 2.0 * rows * cfg["k_up"] * cin
        total += F.linear(rows, cin, ch) + F.linear(rows, skip, ch)
        total += F.similarity(rows, kc, ch)
        total += F.mean_field(rows, kc, ch, cfg["steps"])
        if i > 1:
            total += F.linear(rows, ch + skip, ch)
        cin = ch
    total += F.linear(n[0], 2 * CHANNELS[0], CLASSIFIER_HIDDEN)
    total += F.linear(n[0], CLASSIFIER_HIDDEN, cfg["num_classes"])
    return cfg["batch_size"] * total

"""Reference of PointConvBig (``PointConvResNet(use_crf=True)``): a
five-stage encoder of bottleneck residual point convolutions, a decoder of
continuous Gaussian CRF blocks and an MLP classifier.

Written from the model's published equations (CRFConv's point_conv_big.py
and continuous_crf_conv_big.py), one layer to a function, over the
reference pyramid (``pyramid.build``). Leaf names follow the program's
state dict, so the benchmark loads one set of weights into both.

- Point convolution: out_i = sum_k w(p_i - p_j) * h_j over the K
  neighbours, w an MLP 3 -> h -> h (LeakyReLU 0.1 between).
- Bottleneck block: lin_in (LeakyReLU 0.1) -> point conv -> lin_out, plus
  the shortcut (max-pooled over the neighbours where strided), then
  LeakyReLU 0.01.
- CRF block: unary MLPs on the coarse features, pairwise MLPs on the skip
  features, the coarse state upsampled to its nearest coarse point, the
  similarity softmax_k(-|y_i - y_j|^2) over the neighbours less the point
  itself, ``steps`` mean-field steps x <- (z + (S x) C)(I + C)^-1 with
  C = c^T c, an output MLP and a fusion MLP over [x, skip].
- Classifier: MLP 32 -> 128 (LeakyReLU 0.1), dropout in training, then
  Linear 128 -> classes.
"""

from __future__ import annotations

import torch

from portbench import flops as F
from portbench.reference.nn import leaky, matmul, mlp, mlp_spec
from portbench.reference.pyramid import gather

BLOCKS = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
          "conv4_1", "conv4_2", "conv5_1", "conv5_2")
DECONVS = ("deconv4", "deconv3", "deconv2", "deconv1")


def _plan(cfg):
    """[(block, c_in, c_out, stage, strided)] of the encoder."""
    L = cfg["layers"]
    out, cin = [], cfg["in_channels"]
    for i, name in enumerate(BLOCKS):
        stage = i // 2
        out.append((name, cin, L[stage], stage, i % 2 == 0 and stage > 0))
        cin = L[stage]
    return out


def param_spec(cfg) -> list:
    """(name, shape, kind) of every leaf, in the program's order."""
    L = cfg["layers"]
    spec = []
    for name, cin, cout, _, _ in _plan(cfg):
        h = cout // 4
        if cin != cout:
            spec += mlp_spec(name + ".shortcut", cin, cout)
        spec += mlp_spec(name + ".lin_in", cin, h)
        spec += mlp_spec(name + ".point_conv.weight_nn_0", 3, h)
        spec += mlp_spec(name + ".point_conv.weight_nn_1", h, h)
        spec += mlp_spec(name + ".lin_out", h, cout)
    for i, name in enumerate(DECONVS):
        down, skip = L[4 - i], L[3 - i]
        h = skip // 4
        spec.append((name + ".c", (h, h), "compat"))
        spec += mlp_spec(name + ".unary_nn_0", down, h)
        spec += mlp_spec(name + ".unary_nn_1", h, h)
        spec += mlp_spec(name + ".pairwise_nn_0", skip, h)
        spec += mlp_spec(name + ".pairwise_nn_1", h, h)
        spec += mlp_spec(name + ".out_nn", h, skip)
        spec += mlp_spec(name + ".fusion_nn", 2 * skip, skip)
    spec += mlp_spec("classifier_0", L[0], 4 * L[0])
    spec += mlp_spec("classifier_1", 4 * L[0], cfg["num_classes"], bn=False)
    return spec


def _block(W, p, x, pos, idx, sub_pos, train, mm):
    residual = x
    if p + ".shortcut.weight" in W:
        residual = mlp(W, p + ".shortcut", x, None, train, mm)
    h = mlp(W, p + ".lin_in", x, 0.1, train, mm)
    center = pos if sub_pos is None else sub_pos
    rel = center[:, :, None, :] - gather(pos, idx)
    w = mlp(W, p + ".point_conv.weight_nn_0", rel, 0.1, train, mm)
    w = mlp(W, p + ".point_conv.weight_nn_1", w, None, train, mm)
    h = (w * gather(h, idx)).sum(dim=2)
    if sub_pos is not None:
        residual = gather(residual, idx).amax(dim=2)
    h = mlp(W, p + ".lin_out", h, None, train, mm)
    return leaky(h + residual, 0.01)


def compat(c, mm):
    """(C, (I + C)^-1) of a CRF's compatibility parameter c."""
    C = matmul(c.t(), c, mm)
    eye = torch.eye(C.shape[0], dtype=C.dtype, device=C.device)
    return C, torch.linalg.inv(eye + C)


def mean_field(z, s, nidx, c, steps, mm):
    """``steps`` steps x <- (z + (S x) C)(I + C)^-1 from x = z."""
    C, inv = compat(c, mm)
    x = z
    for _ in range(steps):
        msg = (s[..., None] * gather(x, nidx)).sum(dim=2)
        x = matmul(z + matmul(msg, C, mm), inv, mm)
    return x


def _crf(W, p, unary, pairwise, up, nbr, steps, train, mm):
    nidx = nbr[:, :, 1:]
    x = mlp(W, p + ".unary_nn_0", unary, 0.1, train, mm)
    x = mlp(W, p + ".unary_nn_1", x, None, train, mm)
    y = mlp(W, p + ".pairwise_nn_0", pairwise, 0.1, train, mm)
    y = mlp(W, p + ".pairwise_nn_1", y, None, train, mm)
    z = gather(x, up[..., :1])[:, :, 0]
    s = torch.softmax(-(y[:, :, None, :] - gather(y, nidx)).square()
                      .sum(dim=-1), dim=2)
    x = mean_field(z, s, nidx, W[p + ".c"], steps, mm)
    x = mlp(W, p + ".out_nn", x, 0.1, train, mm)
    return mlp(W, p + ".fusion_nn", torch.cat([x, pairwise], dim=-1), 0.1,
               train, mm)


def forward(W, x, scales, cfg, train=False, mm="float32", gen=None):
    """Logits [B, N, classes] of the Morton-sorted features ``x`` over the
    reference pyramid's ``scales``. In training the classifier's hidden
    layer keeps the entries where ``torch.rand`` of its shape, drawn from
    ``gen`` on its device, is at least the dropout rate, scaled by
    1 / (1 - rate): the mask the program draws from the step's
    generator."""
    s = scales
    feats = []
    for name, _, _, stage, strided in _plan(cfg):
        if strided:
            x = _block(W, name, x, s[stage - 1]["pos"], s[stage - 1]["sub"],
                       s[stage]["pos"], train, mm)
        else:
            x = _block(W, name, x, s[stage]["pos"], s[stage]["nbr"], None,
                       train, mm)
        if name.endswith("_2"):
            feats.append(x)
    h = feats[4]
    for i, name in enumerate(DECONVS):
        lvl = 3 - i
        h = _crf(W, name, h, feats[lvl], s[lvl]["up"], s[lvl]["nbr"],
                 cfg["steps"], train, mm)
    h = mlp(W, "classifier_0", h, 0.1, train, mm)
    rate = cfg["dropout_rate"]
    if train and rate > 0.0:
        keep = torch.rand(h.shape, generator=gen, device=h.device) >= rate
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return mlp(W, "classifier_1", h, None, train, mm, bn=False)


def forward_flops(cfg) -> float:
    """Model operations of one forward of a batch (``flops``)."""
    L, K, B = cfg["layers"], cfg["kernel_sizes"], cfg["batch_size"]
    n = [cfg["sample_num"]]
    for r in cfg["ratios"]:
        n.append(max(n[-1] // r, 1))
    total = 0.0
    for _, cin, cout, stage, strided in _plan(cfg):
        src = n[stage - 1] if strided else n[stage]
        k = K[stage - 1] if strided else K[stage]
        total += F.bottleneck(src, n[stage], k, cin, cout, strided)
    for i in range(4):
        lvl = 3 - i
        total += F.continuous_crf(n[lvl + 1], n[lvl], K[lvl] - 1, L[lvl + 1],
                                  L[lvl], cfg["steps"])
    total += F.linear(n[0], L[0], 4 * L[0])
    total += F.linear(n[0], 4 * L[0], cfg["num_classes"])
    return B * total

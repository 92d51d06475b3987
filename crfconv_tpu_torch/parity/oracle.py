"""Plain-PyTorch re-execution of the reference "big" model's semantics.

Counterpart of ``crfconv_tpu/parity/oracle.py``: the yardstick of the
parity harness (``python -m crfconv_tpu_torch.parity``), which trains it
beside the port's flagship, and of whole-model parity tests. Written from
the reference's documented semantics (models/point_conv_big.py,
models/continuous_crf_conv_big.py, models/common.py) with no
torch_geometric / torch_points3d dependencies: FastBatchNorm1d is plain
BatchNorm1d applied over flattened points, exactly its definition. It runs
no kernel of the port, on whatever device its parameters and inputs lie.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # x [B, N, F], idx [B, M, K] -> [B, M, K, F]
    B, Fdim, K = x.shape[0], x.shape[-1], idx.shape[-1]
    flat = idx.reshape(B, -1, 1).expand(-1, -1, Fdim)
    return x.gather(dim=1, index=flat).reshape(B, -1, K, Fdim)


class TorchMLP(nn.Module):
    """Linear (bias iff no BN) -> BatchNorm over flattened points -> act."""

    def __init__(self, cin, cout, bn=True, act_slope=None):
        super().__init__()
        self.lin = nn.Linear(cin, cout, bias=not bn)
        self.bn = nn.BatchNorm1d(cout) if bn else None
        self.act_slope = act_slope

    def forward(self, x):
        shape = x.shape
        x = self.lin(x.reshape(-1, shape[-1]))
        if self.bn is not None:
            x = self.bn(x)
        if self.act_slope is not None:
            x = F.leaky_relu(x, negative_slope=self.act_slope)
        return x.reshape(*shape[:-1], -1)


class TorchPointConv(nn.Module):
    def __init__(self, d_model):
        super().__init__()
        self.w0 = TorchMLP(3, d_model, act_slope=0.1)
        self.w1 = TorchMLP(d_model, d_model, act_slope=None)

    def forward(self, x, pos, idx, sub_pos=None):
        neighbors = gather_neighbors(pos, idx)
        center = pos if sub_pos is None else sub_pos
        rel = center.unsqueeze(2) - neighbors
        w = self.w1(self.w0(rel))
        xn = gather_neighbors(x, idx)
        return (w * xn).sum(dim=2)


class TorchResNetBBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        hidden = cout // 4
        self.lin_in = TorchMLP(cin, hidden, act_slope=0.1)
        self.lin_out = TorchMLP(hidden, cout, act_slope=None)
        self.shortcut = TorchMLP(cin, cout, act_slope=None) if cin != cout else None
        self.point_conv = TorchPointConv(hidden)

    def forward(self, x, pos, idx, sub_pos=None):
        residual = self.shortcut(x) if self.shortcut is not None else x
        if sub_pos is not None:
            residual = gather_neighbors(residual, idx).max(dim=2)[0]
        h = self.lin_in(x)
        h = self.point_conv(h, pos, idx, sub_pos)
        h = self.lin_out(h)
        return F.leaky_relu(h + residual)  # default slope 0.01


class TorchCRFConv(nn.Module):
    def __init__(self, c_unary, c_pair, c_out, steps=1):
        super().__init__()
        hidden = c_out // 4
        self.hidden = hidden
        self.steps = steps
        self.unary0 = TorchMLP(c_unary, hidden, act_slope=0.1)
        self.unary1 = TorchMLP(hidden, hidden, act_slope=None)
        self.pair0 = TorchMLP(c_pair, hidden, act_slope=0.1)
        self.pair1 = TorchMLP(hidden, hidden, act_slope=None)
        self.out_nn = TorchMLP(hidden, c_out, act_slope=0.1)
        self.fusion = TorchMLP(c_out * 2, c_out, act_slope=0.1)
        self.c = nn.Parameter(torch.eye(hidden))

    def forward(self, unary, pairwise, up_idx, neighbor_idx):
        nidx = neighbor_idx[:, :, 1:]  # drop self-loop
        x = self.unary1(self.unary0(unary))
        y = self.pair1(self.pair0(pairwise))
        x = x.gather(dim=1, index=up_idx.expand(-1, -1, x.shape[-1]))
        yn = gather_neighbors(y, nidx)
        s = (y.unsqueeze(2) - yn).pow(2).sum(-1, keepdim=True)
        s = (-s).softmax(dim=2)
        z = x
        # on c's device: a host-made eye cannot be added to a CUDA C
        eye = torch.eye(self.hidden, dtype=self.c.dtype,
                        device=self.c.device)
        C = self.c.t().mm(self.c)
        inv = (eye + C).inverse()
        for _ in range(self.steps):
            x = gather_neighbors(x, nidx)
            x = (s * x).sum(dim=2)
            x = z + x.matmul(C)
            x = x.matmul(inv)
        x = self.out_nn(x)
        return self.fusion(torch.cat([x, pairwise], dim=-1))


class TorchUpsampling(nn.Module):
    def __init__(self, c_down, c_up, c_out):
        super().__init__()
        self.lin = TorchMLP(c_down, c_up, act_slope=0.1)
        self.fusion = TorchMLP(c_up * 2, c_out, act_slope=0.1)

    def forward(self, x_down, x_up, up_idx, neighbor_idx=None):
        x = x_down.gather(dim=1, index=up_idx.expand(-1, -1, x_down.shape[-1]))
        x = self.lin(x)
        return self.fusion(torch.cat([x_up, x], dim=-1))


class TorchPointConvResNet(nn.Module):
    """Oracle for the flagship PointConvResNet."""

    def __init__(self, in_channels, n_classes, use_crf=True, steps=1):
        super().__init__()
        L = [32, 64, 128, 256, 512]
        self.conv1_1 = TorchResNetBBlock(in_channels, L[0])
        self.conv1_2 = TorchResNetBBlock(L[0], L[0])
        self.conv2_1 = TorchResNetBBlock(L[0], L[1])
        self.conv2_2 = TorchResNetBBlock(L[1], L[1])
        self.conv3_1 = TorchResNetBBlock(L[1], L[2])
        self.conv3_2 = TorchResNetBBlock(L[2], L[2])
        self.conv4_1 = TorchResNetBBlock(L[2], L[3])
        self.conv4_2 = TorchResNetBBlock(L[3], L[3])
        self.conv5_1 = TorchResNetBBlock(L[3], L[4])
        self.conv5_2 = TorchResNetBBlock(L[4], L[4])
        mk = (
            (lambda a, b: TorchCRFConv(a, b, b, steps=steps))
            if use_crf
            else (lambda a, b: TorchUpsampling(a, b, b))
        )
        self.deconv4 = mk(L[4], L[3])
        self.deconv3 = mk(L[3], L[2])
        self.deconv2 = mk(L[2], L[1])
        self.deconv1 = mk(L[1], L[0])
        self.classifier0 = TorchMLP(L[0], L[0] * 4, act_slope=0.1)
        self.classifier1 = nn.Linear(L[0] * 4, n_classes)

    def forward(self, x, scales):
        # scales: list of dicts with pos/neighbor_idx/sub_idx/up_idx tensors
        s = scales
        x1 = self.conv1_1(x, s[0]["pos"], s[0]["neighbor_idx"])
        x1 = self.conv1_2(x1, s[0]["pos"], s[0]["neighbor_idx"])
        x2 = self.conv2_1(x1, s[0]["pos"], s[0]["sub_idx"], sub_pos=s[1]["pos"])
        x2 = self.conv2_2(x2, s[1]["pos"], s[1]["neighbor_idx"])
        x3 = self.conv3_1(x2, s[1]["pos"], s[1]["sub_idx"], sub_pos=s[2]["pos"])
        x3 = self.conv3_2(x3, s[2]["pos"], s[2]["neighbor_idx"])
        x4 = self.conv4_1(x3, s[2]["pos"], s[2]["sub_idx"], sub_pos=s[3]["pos"])
        x4 = self.conv4_2(x4, s[3]["pos"], s[3]["neighbor_idx"])
        x5 = self.conv5_1(x4, s[3]["pos"], s[3]["sub_idx"], sub_pos=s[4]["pos"])
        x5 = self.conv5_2(x5, s[4]["pos"], s[4]["neighbor_idx"])
        h = self.deconv4(x5, x4, s[3]["up_idx"], s[3]["neighbor_idx"])
        h = self.deconv3(h, x3, s[2]["up_idx"], s[2]["neighbor_idx"])
        h = self.deconv2(h, x2, s[1]["up_idx"], s[1]["neighbor_idx"])
        h = self.deconv1(h, x1, s[0]["up_idx"], s[0]["neighbor_idx"])
        h = self.classifier0(h)
        return self.classifier1(h)


# ---------------------------------------------------------------------------
# weight transfer: flax params -> torch state dict
# ---------------------------------------------------------------------------

def _copy_mlp(tmlp: TorchMLP, fparams: dict):
    tmlp.lin.weight.data = torch.from_numpy(
        np.asarray(fparams["Dense_0"]["kernel"]).T.copy()
    )
    if "bias" in fparams["Dense_0"]:
        tmlp.lin.bias.data = torch.from_numpy(
            np.asarray(fparams["Dense_0"]["bias"]).copy()
        )
    if tmlp.bn is not None:
        bn = fparams["MaskedBatchNorm_0"]
        tmlp.bn.weight.data = torch.from_numpy(np.asarray(bn["scale"]).copy())
        tmlp.bn.bias.data = torch.from_numpy(np.asarray(bn["bias"]).copy())


def _copy_block(tb: TorchResNetBBlock, fp: dict):
    _copy_mlp(tb.lin_in, fp["lin_in"])
    _copy_mlp(tb.lin_out, fp["lin_out"])
    if tb.shortcut is not None:
        _copy_mlp(tb.shortcut, fp["shortcut"])
    _copy_mlp(tb.point_conv.w0, fp["point_conv"]["weight_nn_0"])
    _copy_mlp(tb.point_conv.w1, fp["point_conv"]["weight_nn_1"])


def _copy_crf(tc: TorchCRFConv, fp: dict):
    _copy_mlp(tc.unary0, fp["unary_nn_0"])
    _copy_mlp(tc.unary1, fp["unary_nn_1"])
    _copy_mlp(tc.pair0, fp["pairwise_nn_0"])
    _copy_mlp(tc.pair1, fp["pairwise_nn_1"])
    _copy_mlp(tc.out_nn, fp["out_nn"])
    _copy_mlp(tc.fusion, fp["fusion_nn"])
    tc.c.data = torch.from_numpy(np.asarray(fp["c"]).copy())


def _copy_upsampling(tu: TorchUpsampling, fp: dict):
    _copy_mlp(tu.lin, fp["lin"])
    _copy_mlp(tu.fusion, fp["fusion"])


def load_from_flax(tmodel: TorchPointConvResNet, params: dict, use_crf=True):
    """Copy a flax PointConvResNet param tree into the torch oracle."""
    for name in [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
        "conv4_1", "conv4_2", "conv5_1", "conv5_2",
    ]:
        _copy_block(getattr(tmodel, name), params[name])
    for name in ["deconv4", "deconv3", "deconv2", "deconv1"]:
        if use_crf:
            _copy_crf(getattr(tmodel, name), params[name])
        else:
            _copy_upsampling(getattr(tmodel, name), params[name])
    _copy_mlp(tmodel.classifier0, params["classifier_0"])
    tmodel.classifier1.weight.data = torch.from_numpy(
        np.asarray(params["classifier_1"]["kernel"]).T.copy()
    )
    tmodel.classifier1.bias.data = torch.from_numpy(
        np.asarray(params["classifier_1"]["bias"]).copy()
    )

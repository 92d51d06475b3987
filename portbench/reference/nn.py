"""The reference's layers: Linear -> batch norm -> activation, with every
matrix product through :func:`matmul`, in float32 or, for the benchmark's
control, in TF32 (or, for a look at rounding, in the operands' float64).

TF32 is emulated, the same on the CPU and the card: both operands of a
product (and of its two backward products) are rounded to TF32's 10-bit
mantissa, to nearest with ties to even, and the product accumulates in
float32, as the tensor cores do.
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10-bit mantissa), as float32."""
    b = x.detach().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        da = g @ to_tf32(b).transpose(-1, -2)
        db = to_tf32(a).transpose(-1, -2) @ g
        # a may carry leading batch axes where b does not
        while db.dim() > b.dim():
            db = db.sum(0)
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor, mm: str) -> torch.Tensor:
    """a [..., k] @ b [k, n] in TF32 (``mm`` "tf32") or in the operands'
    own precision (float32, or float64 for the look at rounding)."""
    if mm == "tf32":
        return _Tf32Matmul.apply(a, b)
    return a @ b


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Leaky ReLU with gradient 1 at x >= 0."""
    return torch.where(x >= 0, x, x * slope)


def batch_norm(W: dict, p: str, x: torch.Tensor, train: bool):
    """Over all leading axes: the biased batch statistics in training (two
    passes), the running statistics in evaluation."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = (x - mean).square().mean(dim=dims)
    else:
        mean, var = W[p + ".mean"], W[p + ".var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * W[p + ".scale"] \
        + W[p + ".bias"]


def mlp(W: dict, p: str, x, act, train: bool, mm: str, bn: bool = True):
    """Linear (bias iff no batch norm) -> batch norm -> activation slope
    ``act`` (None: none)."""
    y = matmul(x, W[p + ".weight"].t(), mm)
    if bn:
        y = batch_norm(W, p + ".bn", y, train)
    else:
        y = y + W[p + ".bias"]
    return y if act is None else leaky(y, act)


def mlp_spec(p: str, cin: int, cout: int, bn: bool = True) -> list:
    """(name, shape, kind) of one MLP's leaves."""
    out = [(p + ".weight", (cout, cin), "weight")]
    if bn:
        out += [(p + ".bn.scale", (cout,), "bn_scale"),
                (p + ".bn.bias", (cout,), "bn_bias"),
                (p + ".bn.mean", (cout,), "bn_mean"),
                (p + ".bn.var", (cout,), "bn_var")]
    else:
        out.append((p + ".bias", (cout,), "bias"))
    return out


def masked_softmax(logits, mask, dim):
    """Softmax over ``dim`` with masked slots exactly 0 and a fully masked
    row all zeros."""
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, neg)
    z = z - z.amax(dim=dim, keepdim=True).detach()
    e = torch.where(mask, torch.exp(z), 0.0)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True),
                           min=torch.finfo(logits.dtype).tiny)

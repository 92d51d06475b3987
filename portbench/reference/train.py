"""The reference's training step: the weighted cross-entropy and SGD with
momentum and weight decay, followed over the first steps of a run.

The loss is torch's cross-entropy with per-class weights and an ignored
label: sum_i w_{y_i} nll_i / sum_i w_{y_i} over the points whose label
(less the configuration's offset) lies in [0, classes). The optimizer is
SGD(lr, momentum, weight decay) with the decay added to the gradient
before the momentum trace and the rate lr * gamma ** (step //
steps_per_epoch).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import pyramid


def class_weights(cfg, device):
    """1 / (class frequency + 0.02) from the configuration's per-class
    point counts, or None where it has none."""
    counts = cfg.get("num_per_class")
    if not counts:
        return None
    n = np.asarray(counts, np.float64)
    w = (1.0 / (n / n.sum() + 0.02)).astype(np.float32)
    return torch.as_tensor(w, device=device)


def loss(out, labels, cfg, weights):
    c = out.shape[-1]
    if out.dtype != torch.float64:
        out = out.float()
    logp = torch.log_softmax(out, dim=-1).reshape(-1, c)
    y = labels.reshape(-1) - cfg["label_offset"]
    valid = (y != cfg["ignore_index"]) & (y >= 0) & (y < c)
    safe = torch.where(valid, y, torch.zeros_like(y))
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = valid.to(logp.dtype)
    if weights is not None:
        w = torch.where(valid, weights[safe], torch.zeros_like(nll))
    return (nll * w).sum() / w.sum().clamp_min(1e-12)


def sort_inputs(pos, x, y, offsets, cfg):
    """The reference pyramid of a batch and its features and labels in the
    pyramid's order."""
    with torch.no_grad():
        order, scales = pyramid.build(pos, offsets, cfg["kernel_sizes"],
                                      cfg["ratios"], cfg["k_up"],
                                      cfg["tile"], cfg["pad"])
    take = lambda a: torch.take_along_dim(  # noqa: E731
        a, order.reshape(order.shape + (1,) * (a.dim() - 2)), dim=1)
    return take(x), (None if y is None else take(y)), scales


def follow(model, W0: dict, spec, steps, cfg, mm="float32") -> dict:
    """Train a copy of ``W0`` for the given steps, each (pos, x, y,
    offsets, dropout generator). Returns each step's loss, the gradient
    after the decay of each leaf at the first step (what the momentum
    trace starts from), each leaf's raw first gradient, and each leaf's
    change over all the steps, as norms by leaf name. ``mm`` "float64"
    runs the layers (weights, features, positions) in float64 on the same
    pyramid: the look at which side a leaf's gap comes from."""
    names = [n for n, _, kind in spec if kind not in ("bn_mean", "bn_var")]
    wide = mm == "float64"
    W = {k: v.detach().to(torch.float64 if wide else v.dtype, copy=True)
         for k, v in W0.items()}
    for n in names:
        W[n].requires_grad_(True)
    dev = W[names[0]].device
    weights = class_weights(cfg, dev)
    buf, losses, first, raw = {}, [], {}, {}
    for t, (pos, x, y, offsets, gen) in enumerate(steps):
        xs, ys, scales = sort_inputs(pos, x, y, offsets, cfg)
        if wide:
            xs = xs.double()
            scales = [{**sc, "pos": sc["pos"].double()} for sc in scales]
        out = model.forward(W, xs, scales, cfg, train=True, mm=mm, gen=gen)
        L = loss(out, ys, cfg, weights)
        grads = torch.autograd.grad(L, [W[n] for n in names])
        losses.append(float(L.detach()))
        lr = cfg["lr"] * cfg["gamma"] ** (t // cfg["steps_per_epoch"])
        with torch.no_grad():
            for n, g in zip(names, grads):
                d = g + cfg["weight_decay"] * W[n]
                if t == 0:
                    raw[n] = float(torch.linalg.vector_norm(g))
                    first[n] = float(torch.linalg.vector_norm(d))
                    buf[n] = d.clone()
                else:
                    buf[n].mul_(cfg["momentum"]).add_(d)
                W[n].sub_(lr * buf[n])
        del out, L, grads, scales
    change = {n: float(torch.linalg.vector_norm(W[n].detach() - W0[n]))
              for n in names}
    return {"losses": losses, "first_grad": first, "raw_grad": raw,
            "change": change}

"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference run on the same inputs and weights.

Serving, for the sampled requests (their last call in the window),
``served_gap``: the widest of two gaps, over the request's root-mean-square
reference logit: between a served logit and the reference's, and by which
the reference's logit of a served label lies below the reference's best
logit of that point. A label that the program's rounding turns on a near
tie lies below the best by at most twice the first gap; a label altered
after the scores lies below it by a whole logit.

Training, over the first steps (which set-up runs through the window's
own call):

- ``loss_gap``: the widest relative gap between a step's loss and the
  reference's;
- ``grad_gap``: over the leaves, the widest gap between the norm of the
  first gradient as the optimizer gets it (its momentum trace after one
  step) and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``update_gap``: the same for the norm of each leaf's change over the
  steps;
- ``loss_gap_first``, ``grad_gap_median``, ``update_gap_median``: the
  first step's loss gap and the median leaf's gaps, steadier from seed to
  seed where a few leaves' gaps swing (a cell's limits file names the
  numbers it compares).

Leaves whose raw first gradient in the reference is under a thousandth of
the median leaf's (nought to rounding, as a bias that a softmax or a batch
norm cancels) are left out of the two leaf numbers.

The training reference runs in float64 on its own float32 pyramid: the
later steps can amplify float32's rounding in a few seeds by four orders
of magnitude, and a float32 reference, whose scatter-adds round in another
order on every run, would then read its own noise as the program's.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

from portbench.reference import pyramid
from portbench.reference.train import follow

EXCLUDE_BELOW = 1e-3
BLOCK = 4     # clouds the serving reference runs at once
TRAIN_MM = "float64"    # the training reference's precision


def verdict(numbers: dict) -> bool:
    """True where there are numbers and each is finite and at most its
    limit."""
    return bool(numbers) and all(
        n["limit"] is not None and math.isfinite(n["value"])
        and n["value"] <= n["limit"] for n in numbers.values())


@torch.no_grad()
def reference_logits(ref, W, cfg, pos, feats, offsets, mm="float32"):
    """The reference's scores [B, N, C] of one request, in its input point
    order, a block of clouds at a time."""
    outs = []
    for b in range(0, pos.shape[0], BLOCK):
        order, scales = pyramid.build(
            pos[b:b + BLOCK], offsets, cfg["kernel_sizes"], cfg["ratios"],
            cfg["k_up"], cfg["tile"], cfg["pad"])
        x = torch.take_along_dim(feats[b:b + BLOCK], order[..., None], dim=1)
        y = ref.forward(W, x, scales, cfg, train=False, mm=mm)
        out = torch.empty_like(y)
        out.scatter_(1, order[..., None].expand_as(y), y)
        outs.append(out)
    return torch.cat(outs)


def served_gap(logits, labels, ref_logits) -> float:
    """``served_gap`` of one request."""
    scale = ref_logits.square().mean().sqrt()
    best = ref_logits.amax(dim=-1)
    at = ref_logits.gather(-1, labels[..., None])[..., 0]
    return float(torch.maximum((logits - ref_logits).abs().amax(),
                               (best - at).amax()) / scale)


def serve_numbers(cell, W, inputs, device) -> dict:
    """The widest gap over the sampled requests; ``inputs`` holds
    ((pos, feats, offsets), (served logits, served labels)) each."""
    worst = 0.0
    for (pos, feats, offs), (logits, labels) in inputs:
        ref = reference_logits(cell.ref, W, cell.cfg, pos.to(device),
                               feats.to(device), offs)
        worst = max(worst, served_gap(logits.to(device), labels.to(device),
                                      ref))
    return {"served_gap": worst}


def serve_control(cell, W, requests, device, mm="tf32") -> dict:
    """The numbers when the reference in a lower precision takes the
    program's place: its scores and their argmax served."""
    inputs = []
    for pos, feats, offs in requests:
        low = reference_logits(cell.ref, W, cell.cfg, pos.to(device),
                               feats.to(device), offs, mm=mm)
        inputs.append(((pos, feats, offs), (low, low.argmax(dim=-1))))
    return serve_numbers(cell, W, inputs, device)


def step_inputs(steps, device):
    """(pos, x, y, offsets, dropout generator) of each followed step: a
    fresh generator seeded as the program's step was."""
    return [(p, x, y, offs,
             torch.Generator(device=device).manual_seed(seed))
            for p, x, y, offs, seed in steps]


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in names}


def compared_leaves(want: dict) -> list:
    raw = want["raw_grad"]
    med = statistics.median(raw.values())
    return [n for n in want["first_grad"] if raw[n] >= EXCLUDE_BELOW * med]


def train_compare(got: dict, want: dict) -> dict:
    names = compared_leaves(want)
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(got["losses"], want["losses"])]
    grad = leaf_gaps(got["first_grad"], want["first_grad"], names).values()
    change = leaf_gaps(got["change"], want["change"], names).values()
    return {"loss_gap": max(steps), "loss_gap_first": steps[0],
            "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "update_gap": max(change),
            "update_gap_median": statistics.median(change)}


def report_leaves(got: dict, want: dict) -> None:
    """The three widest leaf gaps of each leaf number, with each leaf's
    reference norm over the median leaf's, on standard error."""
    names = compared_leaves(want)
    for key in ("first_grad", "change"):
        med = statistics.median(want[key][n] for n in names)
        gaps = leaf_gaps(got[key], want[key], names)
        for n in sorted(gaps, key=gaps.get, reverse=True)[:3]:
            print(f"leaf {key} {n} gap {gaps[n]:.3e} norm/median "
                  f"{want[key][n] / med:.3e}", file=sys.stderr)


def train_numbers(cell, W, steps, program: dict, device) -> dict:
    want = follow(cell.ref, W, cell.ref.param_spec(cell.cfg),
                  step_inputs(steps, device), cell.cfg, mm=TRAIN_MM)
    report_leaves(program, want)
    return train_compare(program, want)


def train_control(cell, W, steps, device, mm="tf32") -> dict:
    """The numbers when the reference in a lower precision takes the
    program's place."""
    spec = cell.ref.param_spec(cell.cfg)
    want = follow(cell.ref, W, spec, step_inputs(steps, device), cell.cfg,
                  mm=TRAIN_MM)
    low = follow(cell.ref, W, spec, step_inputs(steps, device), cell.cfg,
                 mm=mm)
    return train_compare(low, want)

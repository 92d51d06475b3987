"""Serving whole scenes in a closed loop with one client: a request is one
scene from host memory (page-locked on a card), all its 1.5 m x 1.5 m
columns, each resampled to the configuration's block of points, in one
``Predictor.predict_logits`` call with the configuration's pyramid; the
argmax labels are copied to the host, and the next scene is sent when
they are back.

The pool is a fixed ladder of ``pool`` scene sizes, ``block_step`` blocks
a rung (8, 16, ..., 128 blocks at 8 and 16), the same under every seed,
cycled in order. The seed draws the rest: a bank of ``rooms`` rooms
(``rooms.py``), each scene's floor plan filled with them (a room at most
``room_m`` metres a side, ``points_per_m2`` points a square metre of
floor, flipped and fitted to its place), the scene's turn about z, each
block's points and their order, and the scene's subsampling offsets. A
block's features are its points' colour / 255 and their positions less
the block's mean.

Set-up serves ``warmup_requests`` requests (a whole cycle: every shape,
and the largest scene's memory, before the window). After the window, a
traced run reads the ``crf`` spans, ``profiling.crf_steps()`` and the CRF
kernels' bounds and device time over ``profiled_requests`` scenes from the
middle of the ladder, then the profiled slice over the same scenes; every
run then serves ``checked_requests`` scenes drawn from the seed once more
and holds them to the reference (``checks.serve_numbers``).
"""

from __future__ import annotations

import json
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import checks, harness, kernel_trace, rooms, tracing

KIND = "serve"
PARAMS = ("pool", "block_step", "rooms", "points_per_m2", "room_m",
          "warmup_requests", "checked_requests", "profiled_requests")
CRF_KERNELS = ("crf_operator", "crf_iterate")   # K9 and K10


def grid(blocks: int) -> tuple:
    """(columns along x, along y) of a scene of ``blocks`` columns: y the
    largest divisor of ``blocks`` not above its square root."""
    ny = max(d for d in range(1, math.isqrt(blocks) + 1) if blocks % d == 0)
    return blocks // ny, ny


def make_bank(mix, seed: int, device) -> list:
    """``mix["rooms"]`` rooms of a room's largest floor's points, in random
    point order: [(xyz, rgb)], float32 on ``device``."""
    rng = np.random.default_rng(harness.subseed(seed, 10))
    n = int(round(mix["points_per_m2"] * mix["room_m"] ** 2))
    bank = []
    for _ in range(mix["rooms"]):
        xyz, rgb, _ = rooms.make_cloud(rng, n)
        bank.append((torch.as_tensor(xyz, dtype=torch.float32, device=device),
                     torch.as_tensor(rgb, dtype=torch.float32, device=device)))
    return bank


def fill_plan(gen, bank, mix, width: float, depth: float):
    """The floor plan [0, width] x [0, depth] filled with rooms of the
    bank, each flipped, fitted to its place and cut to the plan's density:
    (xyz, rgb)."""
    nrx = math.ceil(width / mix["room_m"])
    nry = math.ceil(depth / mix["room_m"])
    sw, sd = width / nrx, depth / nry
    n = int(round(mix["points_per_m2"] * sw * sd))
    dev = gen.device
    size = torch.tensor([sw, sd], device=dev)
    xyz, rgb = [], []
    for i in range(nrx):
        for j in range(nry):
            k = int(torch.randint(len(bank), (1,), generator=gen, device=dev))
            p, c = bank[k][0][:n].clone(), bank[k][1][:n]
            lo, hi = p[:, :2].amin(dim=0), p[:, :2].amax(dim=0)
            u = (p[:, :2] - lo) / torch.clamp(hi - lo, min=1e-9)
            flip = torch.rand(2, generator=gen, device=dev) < 0.5
            u = torch.where(flip, 1.0 - u, u)
            p[:, :2] = u * size + torch.tensor([i * sw, j * sd], device=dev)
            xyz.append(p)
            rgb.append(c)
    return torch.cat(xyz), torch.cat(rgb)


def make_scene(gen, bank, blocks: int, cfg, mix):
    """One scene of ``blocks`` columns of ``cfg["block_size"]`` metres, each
    resampled to ``cfg["sample_num"]`` points (a random subset in random
    order, or all its points in random order and random repeats where a
    column has fewer): positions [blocks, N, 3] and features [blocks, N,
    C], float32 on the generator's device."""
    N, C, bs = cfg["sample_num"], cfg["in_channels"], cfg["block_size"]
    dev = gen.device
    nx, ny = grid(blocks)
    xyz, rgb = fill_plan(gen, bank, mix, nx * bs, ny * bs)
    shuffle = torch.randperm(xyz.shape[0], generator=gen, device=dev)
    xyz, rgb = xyz[shuffle], rgb[shuffle]
    cell = torch.div(xyz[:, :2], bs, rounding_mode="floor").long()
    col = (cell[:, 0].clamp(0, nx - 1) * ny + cell[:, 1].clamp(0, ny - 1))
    # each column's points, in the shuffled order
    by_col = torch.argsort(col, stable=True)
    counts = torch.bincount(col, minlength=blocks)
    if not bool(counts.all()):
        raise ValueError(f"a scene of {blocks} columns has an empty one")
    j = torch.arange(N, device=dev)[None, :]
    repeat = (torch.rand(blocks, N, generator=gen, device=dev)
              * counts[:, None]).long().clamp(max=counts[:, None] - 1)
    rows = torch.where(j < counts[:, None], j, repeat)
    pick = by_col[(torch.cumsum(counts, 0) - counts)[:, None] + rows]
    theta = 2 * math.pi * float(torch.rand(1, generator=gen, device=dev))
    rot = torch.tensor([[math.cos(theta), -math.sin(theta), 0.0],
                        [math.sin(theta), math.cos(theta), 0.0],
                        [0.0, 0.0, 1.0]], device=dev)
    centre = torch.tensor([nx * bs / 2, ny * bs / 2, 0.0], device=dev)
    pos = (xyz[pick] - centre) @ rot.T
    cols = torch.cat([rgb[pick] / 255.0,
                      pos - pos.mean(dim=1, keepdim=True)], dim=-1)
    feats = torch.zeros(blocks, N, C, device=dev)
    feats[..., :min(6, C)] = cols[..., :C]
    return pos, feats


def ladder(mix) -> list:
    """Blocks of each scene of the pool: ``block_step`` times 1, 2, ...,
    ``pool``."""
    return [mix["block_step"] * (i + 1) for i in range(mix["pool"])]


def make_scenes(cfg, mix, seed: int, device="cpu") -> list:
    """The pool, made on ``device``: one scene a rung of the ladder,
    [(pos, feats, offsets)]. Positions and features, the request's points,
    are on the host, page-locked where ``device`` is a card, as a service's
    receive buffers for whole scans would be; ``offsets`` are on ``device``
    (each scale's subsampling offsets, shared by the scene's blocks: the
    benchmark's stand-in for the program's own draw, placed as
    ``harness.make_pool`` places it)."""
    bank = make_bank(mix, seed, device)
    gen = torch.Generator(device=device).manual_seed(harness.subseed(seed,
                                                                     11))
    pool = []
    for blocks in ladder(mix):
        pos, feats = make_scene(gen, bank, blocks, cfg, mix)
        offsets, n = [], cfg["sample_num"]
        for r in cfg["ratios"]:
            keep = max(n // r, 1)
            offsets.append(torch.randint(0, r, (keep,), generator=gen,
                                         device=device))
            n = keep
        pos, feats = pos.cpu(), feats.cpu()
        if harness.is_cuda(device):
            pos, feats = pos.pin_memory(), feats.pin_memory()
        pool.append((pos, feats, offsets))
    return pool


def pyramid(cfg) -> dict:
    """The configuration's pyramid, as ``Predictor`` takes it."""
    return {"kernel_sizes": tuple(cfg["kernel_sizes"]),
            "ratios": tuple(cfg["ratios"]), "k_up": cfg["k_up"]}


def profiled_scenes(mix) -> list:
    """The ``profiled_requests`` scenes in the middle of the ladder."""
    k = mix["profiled_requests"]
    start = (mix["pool"] - k) // 2
    return list(range(start, start + k))


def crf_readings(request, picks, device) -> dict:
    """Per request of ``picks``: the CUDA-event ms of the program's ``crf``
    and ``forward`` spans, the ``crf`` spans opened, the fused cores' steps
    (``profiling.crf_steps()``), and the CRF kernels' summed bounds and
    device seconds (``kernel_trace``). A span or counter the program lacks
    reads None."""
    from crfconv_tpu_torch.utils import profiling

    steps = getattr(profiling, "crf_steps", None)
    harness.sync(device)
    before = steps() if steps else 0
    with profiling.tracing() as rec:
        for i in picks:
            request(i)
    totals = rec.totals()
    k = len(picks)
    out = {"steps": (steps() - before) / k if steps else None}
    for name in ("crf", "forward"):
        t = totals.get(name)
        out[name + "_ms"] = (t["event_ms"] / k if t and t["event_ms"]
                             is not None else None)
    out["crf_spans"] = totals["crf"]["count"] / k if "crf" in totals else None

    def again():
        for i in picks:
            request(i)
        return k

    out.update(kernel_trace.bounds_and_time(again, CRF_KERNELS))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from crfconv_tpu_torch import Predictor

    cfg, mix = cell.cfg, cell.mix
    clock = harness.Phases(t_start)
    W = harness.make_weights(cell.ref.param_spec(cfg),
                             harness.subseed(seed, 0), device)
    model = harness.program_model(cfg, W, device)
    predictor = Predictor(model, device=device, **pyramid(cfg))
    clock.mark("weights and model")
    scenes = make_scenes(cfg, mix, seed, device)
    clock.mark("inputs")
    spans = None

    def request(i):
        pos, feats, offs = scenes[i % len(scenes)]
        if spans is not None:
            spans.begin("request")
        logits = predictor.predict_logits(pos, feats, offs)
        labels = logits.argmax(dim=-1).cpu()
        if spans is not None:
            spans.end("request")
        return logits, labels

    for i in range(mix["warmup_requests"]):
        request(i)
    harness.sync(device)
    clock.mark("warm-up requests")
    setup_s = time.perf_counter() - t_start
    setup_peak = harness.peak_bytes(device)
    harness.reset_peak(device)
    lat, n, blocks = [], 0, 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
        request(n)
        lat.append(time.perf_counter() - t)
        blocks += scenes[n % len(scenes)][0].shape[0]
        n += 1
    window_s = t - t0
    peak = harness.peak_bytes(device)
    points = blocks * cfg["sample_num"]
    out = {
        "attempted": n, "setup_s": setup_s, "window_s": window_s,
        "memory_peak_bytes": max(peak, setup_peak),
        "e2e": {"serve_points_per_s": points / window_s,
                "serve_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "peak_gib": peak / harness.GIB, "setup_s": setup_s},
    }
    if trace:
        picks = profiled_scenes(mix)
        crf = crf_readings(request, picks, device)
        print("reading crf " + json.dumps(crf), file=sys.stderr)
        spans = tracing.Spans(timed=False)
        spans.wrap(predictor, "prepare", "prepare")
        spans.hook_forward(model)

        def profiled():
            for i in picks:
                request(i)
            return len(picks)

        per_block = cell.ref.forward_flops({**cfg, "batch_size": 1})
        out["readings"] = SimpleNamespace(
            kind=KIND, units=n, window_s=window_s,
            model_flops=per_block * blocks / max(n, 1), crf=crf,
            slice=tracing.profile_slice(profiled, spans))
    checked = harness.checked_entries(seed, len(scenes),
                                      mix["checked_requests"])
    inputs = [(scenes[p], request(p)) for p in checked]
    del predictor, model
    harness.free(device)
    out["checks"] = checks.serve_numbers(cell, W, inputs, device)
    return out


def control(cell, seed: int, device, mm: str = "tf32") -> dict:
    """The numbers of a run of ``seed`` with the reference in ``mm`` in the
    program's place, on the run's own checked scenes and weights."""
    cfg, mix = cell.cfg, cell.mix
    W = harness.make_weights(cell.ref.param_spec(cfg),
                             harness.subseed(seed, 0), device)
    scenes = make_scenes(cfg, mix, seed, device)
    checked = harness.checked_entries(seed, len(scenes),
                                      mix["checked_requests"])
    return checks.serve_control(cell, W, [scenes[p] for p in checked],
                                device, mm)

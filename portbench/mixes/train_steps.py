"""Training steps back to back on placed batches: the step of
``make_train_step`` builds each batch's windowed pyramid, runs the
forward, the weighted loss, the backward and the SGD update, and leaves
the loss on the device. The first ``checked_steps``, which the reference
follows, run in set-up through the same call on the same state that the
window then continues."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from portbench import checks, flops, harness, tracing

KIND = "train"
PARAMS = ("pool", "rooms", "checked_steps", "profiled_steps")


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from crfconv_tpu_torch import RawBatch, TrainState, make_train_step
    from portbench.reference.train import class_weights

    cfg, mix = cell.cfg, cell.mix
    clock = harness.Phases(t_start)
    W = harness.make_weights(cell.ref.param_spec(cfg),
                             harness.subseed(seed, 0), device)
    model = harness.program_model(cfg, W, device)
    state = TrainState.create(
        model, lr=cfg["lr"], momentum=cfg["momentum"],
        weight_decay=cfg["weight_decay"], gamma=cfg["gamma"],
        steps_per_epoch=cfg["steps_per_epoch"])
    step = make_train_step(
        class_weights=class_weights(cfg, device),
        ignore_index=cfg["ignore_index"], label_offset=cfg["label_offset"])
    clock.mark("weights and model")
    pool = harness.make_pool(cfg, mix, seed, device)
    batches = [(RawBatch(pos=p, x=x, y=y), offs) for p, x, y, offs in pool]
    clock.mark("inputs")
    spans = tracing.Spans(timed=harness.is_cuda(device)) if trace else None
    if spans is not None:
        spans.hook_forward(model)

    def run_step(i, gen):
        raw, offs = batches[i % len(batches)]
        if spans is not None:
            spans.begin("step")
        res = step(state, raw, gen, offs)
        if spans is not None:
            spans.end("step")
        return res

    # the checked steps: the reference follows them from the same weights
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    n_checked = mix["checked_steps"]
    losses, first = [], {}
    for t in range(n_checked):
        gen = torch.Generator(device=device).manual_seed(
            harness.subseed(seed, 100 + t))
        losses.append(run_step(t, gen)["loss"])
        if t == 0:
            first = {n: torch.linalg.vector_norm(
                state.optimizer.state[p]["momentum_buffer"])
                for n, p in params.items()}
    program = {
        "losses": [float(v) for v in losses],
        "first_grad": {n: float(v) for n, v in first.items()},
        "change": {n: float(torch.linalg.vector_norm(p.detach() - before[n]))
                   for n, p in params.items()},
    }
    del before
    if spans is not None:
        spans.events.clear()
    gen = torch.Generator(device=device).manual_seed(
        harness.subseed(seed, 200))
    harness.sync(device)
    clock.mark("checked steps")
    setup_s = time.perf_counter() - t_start
    setup_peak = harness.peak_bytes(device)
    harness.reset_peak(device)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        run_step(n_checked + n, gen)
        n += 1
    harness.sync(device)
    window_s = time.perf_counter() - t0
    peak = harness.peak_bytes(device)
    points = cfg["batch_size"] * cfg["sample_num"]
    out = {
        "attempted": n, "setup_s": setup_s, "window_s": window_s,
        "memory_peak_bytes": max(peak, setup_peak),
        "e2e": {"train_points_per_s": n * points / window_s,
                "peak_gib": peak / harness.GIB, "setup_s": setup_s},
    }
    if trace:
        def profiled():
            for j in range(mix["profiled_steps"]):
                run_step(n + j, gen)
            return mix["profiled_steps"]

        out["readings"] = SimpleNamespace(
            kind=KIND, units=n, window_s=window_s,
            spans_ms=spans.totals_ms(),
            model_flops=flops.model_flops(cell.ref, cfg, train=True),
            slice=tracing.profile_slice(profiled, spans))
    steps = [(p, x, y, offs, harness.subseed(seed, 100 + t))
             for t, (p, x, y, offs) in enumerate(pool[:n_checked])]
    del state, step, model, params, batches, pool
    harness.free(device)
    out["checks"] = checks.train_numbers(cell, W, steps, program, device)
    out["program"] = program    # what the checked steps read, for a look
    return out

"""Serving in a closed loop with one client: requests of a batch of crops
from host memory through ``Predictor.predict_logits``, the argmax, and the
labels copied to the host, each sent when the last one's labels are
back."""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np

from portbench import checks, flops, harness, tracing

KIND = "serve"
PARAMS = ("pool", "rooms", "warmup_requests", "checked_requests",
          "profiled_requests")


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from crfconv_tpu_torch import Predictor

    cfg, mix = cell.cfg, cell.mix
    clock = harness.Phases(t_start)
    W = harness.make_weights(cell.ref.param_spec(cfg),
                             harness.subseed(seed, 0), device)
    model = harness.program_model(cfg, W, device)
    predictor = Predictor(model, device=device)
    clock.mark("weights and model")
    pool = [(pos.cpu(), feats.cpu(), offs) for pos, feats, _, offs
            in harness.make_pool(cfg, mix, seed, device)]
    clock.mark("inputs")
    checked = harness.checked_entries(seed, len(pool),
                                      mix["checked_requests"])
    spans = tracing.Spans(timed=harness.is_cuda(device)) if trace else None
    if spans is not None:
        spans.wrap(predictor, "prepare", "prepare")
        spans.hook_forward(model)

    def request(i):
        pos, feats, offs = pool[i % len(pool)]
        if spans is not None:
            spans.begin("request")
        logits = predictor.predict_logits(pos, feats, offs)
        labels = logits.argmax(dim=-1).cpu()
        if spans is not None:
            spans.end("request")
        return logits, labels

    for i in range(mix["warmup_requests"]):
        request(i)
    if spans is not None:
        spans.events.clear()
    harness.sync(device)
    clock.mark("warm-up requests")
    setup_s = time.perf_counter() - t_start
    setup_peak = harness.peak_bytes(device)
    harness.reset_peak(device)
    served, lat, n = {}, [], 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
        logits, labels = request(n)
        lat.append(time.perf_counter() - t)
        if n % len(pool) in checked:
            served[n % len(pool)] = (logits, labels)
        n += 1
    window_s = t - t0
    peak = harness.peak_bytes(device)
    points = cfg["batch_size"] * cfg["sample_num"]
    out = {
        "attempted": n, "setup_s": setup_s, "window_s": window_s,
        "memory_peak_bytes": max(peak, setup_peak),
        "e2e": {"serve_points_per_s": n * points / window_s,
                "serve_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "peak_gib": peak / harness.GIB, "setup_s": setup_s},
    }
    if trace:
        harness.sync(device)

        def profiled():
            for j in range(mix["profiled_requests"]):
                request(n + j)
            return mix["profiled_requests"]

        out["readings"] = SimpleNamespace(
            kind=KIND, units=n, window_s=window_s,
            spans_ms=spans.totals_ms(),
            model_flops=flops.model_flops(cell.ref, cfg, train=False),
            slice=tracing.profile_slice(profiled, spans))
    missing = [p for p in checked if p not in served]
    inputs = [(pool[p], served[p]) for p in checked if p in served]
    del predictor, model, served, pool
    harness.free(device)
    out["checks"] = checks.serve_numbers(cell, W, inputs, device)
    if missing:   # a sampled request that never came
        out["checks"] = {k: math.inf for k in out["checks"]}
    return out

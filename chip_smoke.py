#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crfconv_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from crfconv_tpu_torch/csrc/ (nvcc, sm_90a).
2. Serves one warm-up request of the flagship model and records every
   kernel call of that forward (its real inputs).
3. Kernel phases: re-runs each recorded call through the kernel and its
   plain PyTorch version on the card, checks them against each other and
   times both (CUDA events, median of 20 runs after warm-up) beside the
   call's bound and, where one PyTorch call computes the same function,
   that call's time.
4. Main path: resets the launch counts, serves REQUESTS requests of
   B8 x 8192 points (S3DIS shape) through Predictor with the full-width
   PointConvResNet(13 classes, use_crf, steps=1) and seeded random
   weights, and checks outputs and launch counts.
5. Runs one forward with the kernels and one with the plain versions on
   the same pyramid and compares the logits.

Prints the card's name and power limit, one JSON line of kernel results
and, last, {"ok": true, "device": {...}}. Exits non-zero, without that
last line, if any check fails or no GPU is present. Full results go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B, N, C_IN, N_CLASSES = 8, 8192, 6, 13
REQUESTS = 3
SEED = 0
DEVICE = "cuda:0"
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM float32, outside the tensor cores
# launches of each kernel per B8 x 8192 request (pyramid + forward)
EXPECTED_PER_REQUEST = {
    "windowed_gather": 15,
    "window_knn": 10,
    "point_conv_fused_infer": 2,
    "crf_similarity_message": 1,
}
REPLACES = {
    "windowed_gather": "crfconv_tpu/ops/windowed_pallas.py:448",
    "window_knn": "crfconv_tpu/ops/windowed_pallas.py:684",
    "point_conv_fused_infer": "crfconv_tpu/ops/conv_pallas.py:380",
    "crf_similarity_message": "crfconv_tpu/ops/crf_sim_pallas.py:146",
}

FAILURES = []


def expect(cond: bool, what: str) -> None:
    if not cond:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else (
        f"nvidia-smi failed: {r.stderr.strip()}"
    )


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def patched(pairs):
    """Temporarily rebind module attributes: [(module, name, value)]."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def call_sites():
    """(module, attribute) through which the main path reaches each kernel
    wrapper, with the wrapper and its plain version."""
    from crfconv_tpu_torch.models import crf_conv, point_conv_big
    from crfconv_tpu_torch.ops import conv, crf_sim, neighbors, windowed

    return {
        "windowed_gather": (neighbors, "windowed_gather",
                            windowed.windowed_gather,
                            windowed.windowed_gather_plain),
        "window_knn": (windowed, "window_knn", windowed.window_knn,
                       windowed.window_knn_plain),
        "point_conv_fused_infer": (point_conv_big, "point_conv_fused_infer",
                                   conv.point_conv_fused_infer,
                                   conv.point_conv_fused_infer_plain),
        "crf_similarity_message": (crf_conv, "crf_similarity_message",
                                   crf_sim.crf_similarity_message,
                                   crf_sim.crf_similarity_message_plain),
    }


def record_calls(sites, run):
    """Run ``run()`` and return every call each kernel wrapper received."""
    calls = {name: [] for name in sites}

    def recorder(name, fn):
        def rec(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return rec

    with patched([(m, a, recorder(name, k))
                  for name, (m, a, k, _) in sites.items()]):
        run()
    return calls


# --------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once, and the
# operations the function needs on these inputs
# --------------------------------------------------------------------------


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound_of(name, args, out):
    if name == "windowed_gather":
        ops = 0
    elif name == "window_knn":
        pos, k = args[0], args[1]
        q = args[2] if len(args) > 2 and args[2] is not None else pos
        from crfconv_tpu_torch.ops.windowed import window_starts

        _, width, _ = window_starts(q.shape[1], pos.shape[1], *args[3:5])
        # 8 flops per distance and one comparison per candidate
        ops = q.shape[0] * q.shape[1] * width * 9
    elif name == "point_conv_fused_infer":
        x, idx = args[0], args[2]
        b, n, h = x.shape
        ops = b * n * idx.shape[2] * (2 * h * h + 11 * h + 3)
    else:  # crf_similarity_message
        y, idx = args[0], args[2]
        b, n, h = y.shape
        ops = b * n * idx.shape[2] * (5 * h + 4)
    outs = out if isinstance(out, tuple) else (out,)
    t_bytes = (nbytes(*args) + nbytes(*outs)) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------


def compare(name, args, got, ref):
    """Max abs error of one call, with the phase's checks."""
    from crfconv_tpu_torch.ops.windowed import check_window_consistency

    if name == "windowed_gather":
        expect(torch.equal(got, ref), "windowed_gather: not bit-equal")
        return float((got - ref).abs().max()) if got.numel() else 0.0
    if name == "window_knn":
        pos = args[0]
        same = len(args) < 3 or args[2] is None
        agree = float((got == ref).float().mean())
        expect(agree >= 0.999, f"window_knn: agreement {agree}")
        g = got.cpu().numpy()
        cons = check_window_consistency(g, pos.shape[1])
        expect(cons == 1.0, f"window_knn: window consistency {cons}")
        if same:
            self_ok = bool((got[:, :, 0] == torch.arange(
                got.shape[1], device=got.device)).all())
            expect(self_ok, "window_knn: column 0 is not self")
        return float((got.long() - ref.long()).abs().max())
    # K3, K4: float32 sums in another order than the plain matmuls/sums
    err = 0.0
    for a, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        ok = torch.allclose(a, r, rtol=1e-4, atol=1e-5)
        expect(ok, f"{name}: outside rtol 1e-4 atol 1e-5")
        err = max(err, float((a - r).abs().max()))
    return err


def library_call(name, args):
    """One PyTorch call computing the same function, or None."""
    if name != "windowed_gather":
        return None
    x, idx = args[0], args[1]
    b_ix = torch.arange(x.shape[0], device=x.device)[:, None, None]
    gidx = idx.long()   # window-consistent: the clamp is the identity
    return lambda: x[b_ix, gidx]


def kernel_phase(name, kernel, plain, calls):
    err, bound_ms, by_ops = 0.0, 0.0, {"bytes": 0.0, "operations": 0.0}
    for args, kwargs in calls:
        got = kernel(*args, **kwargs)
        ref = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = max(err, compare(name, args, got, ref))
        b_ms, b_by = bound_of(name, args, got)
        bound_ms += b_ms
        by_ops[b_by] += b_ms
    ms = median_ms(lambda: [kernel(*a, **k) for a, k in calls])
    plain_ms = median_ms(lambda: [plain(*a, **k) for a, k in calls])
    libs = [library_call(name, a) for a, _ in calls]
    library_ms = (
        median_ms(lambda: [f() for f in libs]) if all(libs) else None
    )
    return {
        "name": name,
        "route": "cuda",
        "source": f"crfconv_tpu_torch/csrc/{kernel_source(name)}",
        "replaces": REPLACES[name],
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": max(by_ops, key=by_ops.get),
        "library_ms": library_ms,
        "calls_per_forward": len(calls),
    }


def kernel_source(name):
    from crfconv_tpu_torch import cuda_build

    return {k.name: k.source for k in cuda_build.KERNELS}[name]


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def make_model(device):
    from crfconv_tpu_torch import PointConvResNet
    from crfconv_tpu_torch.models.common import MaskedBatchNorm

    gen = torch.Generator().manual_seed(SEED)
    model = PointConvResNet(
        N_CLASSES, C_IN, use_crf=True, steps=1, device=device, generator=gen,
    )
    with torch.no_grad():   # non-trivial batch-norm statistics
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                f = m.mean.numel()
                m.mean.copy_(0.1 * torch.randn(f, generator=gen))
                m.var.copy_(0.5 + torch.rand(f, generator=gen))
                m.scale.copy_(0.8 + 0.4 * torch.rand(f, generator=gen))
                m.bias.copy_(0.1 * torch.randn(f, generator=gen))
    return model.eval()


def request(rng, device):
    pos = torch.as_tensor(rng.random((B, N, 3), dtype=np.float32), device=device)
    feats = torch.as_tensor(rng.random((B, N, C_IN), dtype=np.float32),
                            device=device)
    return pos, feats


def profile_request(predictor, pos, feats, path):
    """Device time by kernel name over one request (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        predictor.predict_logits(pos, feats)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    rows = []
    for e in p.key_averages():   # device-side events only: the kernels
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.key, e.self_device_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    p.export_chrome_trace(path)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import crfconv_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: crfconv_tpu_torch not importable beside {__file__}: "
              f"{e}", file=sys.stderr)
        return 2
    from crfconv_tpu_torch import Predictor, cuda_build
    from crfconv_tpu_torch.data.batch import PointBatch
    from crfconv_tpu_torch.serve import SERVING_MODE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    smi = smi_line()
    print(smi, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    build_s = cuda_build.build(verbose=True)
    print(f"# kernels built in {build_s:.1f} s", flush=True)

    model = make_model(dev)
    predictor = Predictor(model, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED)

    # warm-up request, recording every kernel call of the main path
    sites = call_sites()
    pos, feats = request(rng, dev)
    calls = record_calls(sites, lambda: predictor.predict_logits(pos, feats))
    torch.cuda.synchronize()
    for name, per in EXPECTED_PER_REQUEST.items():
        expect(len(calls[name]) == per,
               f"{name}: {len(calls[name])} calls per request, expected {per}")

    # kernel phases
    results = {}
    for name, (_, _, kernel, plain) in sites.items():
        with torch.inference_mode():
            results[name] = kernel_phase(name, kernel, plain, calls[name])
        r = results[name]
        print(f"# {name}: {r['calls_per_forward']} calls, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), library "
              f"{r['library_ms']}, max_abs_err {r['max_abs_err']:.3g}",
              flush=True)

    # K2 in exact selection mode on the same recorded calls (the main path
    # selects with packed keys)
    with torch.inference_mode():
        knn, knn_plain = sites["window_knn"][2:]
        for args, _ in calls["window_knn"]:
            exact_args = args[:5] + (True,)
            compare("window_knn", exact_args, knn(*exact_args),
                    knn_plain(*exact_args))
    torch.cuda.synchronize()
    print("# window_knn exact mode checked on the same calls", flush=True)

    # main path: REQUESTS requests through the Predictor
    reqs = [request(rng, dev) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat = []
    outs = []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        logits = predictor.predict_logits(p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(logits)
    counts = cuda_build.launch_counts()
    for name, per in EXPECTED_PER_REQUEST.items():
        expect(counts[name] == per * REQUESTS,
               f"{name}: {counts[name]} launches in {REQUESTS} requests, "
               f"expected {per * REQUESTS}")
        results[name]["launches"] = counts[name]
    for logits in outs:
        expect(tuple(logits.shape) == (B, N, N_CLASSES),
               f"logits shape {tuple(logits.shape)}")
        expect(bool(torch.isfinite(logits).all()), "non-finite logits")
        labels = logits.argmax(-1)
        expect(bool(((labels >= 0) & (labels < N_CLASSES)).all()),
               "labels outside [0, 13)")
    pts_s = REQUESTS * B * N / sum(lat)
    print(f"# served {REQUESTS} requests of {B}x{N}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s",
          flush=True)

    # phases of one request: pyramid and forward, CUDA events
    from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed

    p_, f_ = reqs[0]

    def pyramid():
        return build_pyramid_windowed(
            p_, generator=torch.Generator(device=dev).manual_seed(SEED),
            knn_exact=SERVING_MODE.knn_exact, device=dev,
        )

    order, scales = pyramid()
    x = torch.take_along_dim(f_, order[..., None], dim=1)
    batch = PointBatch(x=x, y=None, scales=scales)
    with torch.inference_mode():
        pyramid_ms = median_ms(pyramid, runs=10)
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=10)
        request_ms = median_ms(lambda: predictor.predict_logits(p_, f_),
                               runs=10)
        # the same forward through the plain versions, on the same pyramid
        got = model(batch, SERVING_MODE)
        plain_pairs = [(m, a, pl) for m, a, _, pl in sites.values()]
        with patched(plain_pairs):
            ref = model(batch, SERVING_MODE)
            plain_forward_ms = median_ms(
                lambda: model(batch, SERVING_MODE), runs=5, warmup=1
            )
    torch.cuda.synchronize()
    d_logit = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    argmax_agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # tolerance: K3/K4 sum in another order than the plain matmuls
    # (~1e-6 relative per layer), carried through 20 layers
    expect(d_logit <= 1e-3 * max(1.0, scale),
           f"kernel vs plain forward: max |dlogit| {d_logit} (scale {scale})")
    expect(argmax_agree >= 0.999, f"argmax agreement {argmax_agree}")
    print(f"# forward kernels vs plain: max |dlogit| {d_logit:.3g} "
          f"(max |logit| {scale:.3g}), argmax agreement {argmax_agree}",
          flush=True)
    print(f"# one request: {request_ms:.3f} ms (pyramid {pyramid_ms:.3f} ms, "
          f"forward {forward_ms:.3f} ms; plain-version forward "
          f"{plain_forward_ms:.3f} ms)", flush=True)

    profile_rows, busy_ms = [], None
    try:
        with torch.inference_mode():
            profile_rows = profile_request(
                predictor, p_, f_, os.path.join(out_dir, "chip_smoke_trace.json")
            )
        busy_ms = sum(r[1] for r in profile_rows)
        n_launch = sum(r[2] for r in profile_rows)
        print(f"# profiler: {n_launch} kernel launches, busy {busy_ms:.3f} ms "
              f"in one request of {request_ms:.3f} ms (idle share "
              f"{1 - busy_ms / request_ms:.3f}); top:", flush=True)
        for key, ms, cnt in profile_rows[:12]:
            print(f"#   {ms:9.4f} ms  x{cnt:<4d} {key[:90]}", flush=True)
    except Exception as e:  # measurement extra: report and go on
        print(f"# profiler unavailable: {e!r}", flush=True)

    kernels = []
    for name in EXPECTED_PER_REQUEST:
        r = dict(results[name])
        r.pop("calls_per_forward")
        kernels.append(r)
    summary = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "build_s": build_s,
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogit": d_logit,
        "argmax_agreement": argmax_agree,
        "kernels": kernels,
        "calls_per_forward": {n: results[n]["calls_per_forward"]
                              for n in results},
        "kernel_busy_ms": busy_ms,
        "profile": profile_rows[:40],
        "failures": FAILURES,
    }
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(summary, fh, indent=1)

    if FAILURES:
        print(f"FAIL: {len(FAILURES)} checks failed", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

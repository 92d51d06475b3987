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
   that call's time; the kernel's and that call's device time (the sum of
   their kernels in torch.profiler over five runs of the phase's calls,
   divided by five; a phase fails where the profile holds fewer launches of
   the kernel's own device functions than calls) and the wrapper's host
   time a call (no synchronisation), split for K1 into the wrapper,
   Kernel.__call__ and the bare ctypes call. K3, K5, K10 and K12 are also
   timed per group of calls of one width (K5's by M, H and R).
4. Main path: resets the launch counts, serves REQUESTS requests of
   B8 x 8192 points (S3DIS shape) through Predictor with the full-width
   PointConvResNet(13 classes, use_crf, steps=1) and seeded random
   weights, and checks outputs and launch counts.
5. Runs one forward with the kernels and one with the plain versions on
   the same pyramid and compares the logits.
6. Train: takes one warm-up step of the full-width flagship (B8 x 8192,
   dropout 0.5, SGD lr 0.01) through make_train_step, recording every
   kernel call of that step, and holds each kernel (K1, K2, K7, K8, the
   leaky ReLU's backward) against its plain version on those calls, timed
   as in 3; each K8 call is also run twice (bit-identical) and held
   bit-equal to the plain version on CPU copies of its inputs, as on
   ScanNet's step in 10.
7. Train main path: resets the launch counts, takes TRAIN_STEPS steps and
   checks the loss, that every gradient is finite and not all zero, that
   every parameter and running statistic moved, and the launch counts per
   step; times the step and its phases and profiles one step.
8. From one state, one pyramid and one dropout seed, takes a step with the
   kernels and one through the plain versions, differentiated by autograd
   (not through the port's autograd Functions), and compares loss,
   gradients, parameters and running statistics.
9. One eval step, a checkpoint saved and restored into a fresh state, and
   the same eval step on it: the probabilities must be identical.
10. ScanNet (ScanNetConfig: CRFSegNet(20 classes, steps=10), B16 x 8192,
    label_offset 1): one warm-up request and one warm-up train step,
    recording every kernel call of each (K1, K2, K9, K10 in the request;
    K1, K2, K8, K9-K12 and the leaky ReLU's backward in the step), each
    held against its plain version and timed as in 3 (K2 bit-equal on
    every call of every path; K10, one call a CRF core running all its
    steps, bit-equal with the stack it saves); each K11 call (and K14's
    in 14) is run twice (bit-identical) and every tenth, the first reverse
    step of each core (every K14 call: all of a core's reverse steps), held
    bit-equal to the plain version on CPU copies;
    each K12 call (and the discrete step's in 14) is run twice
    (bit-identical); the reverse steps' plans (S~^T's structure, built
    once a backward) are timed. K10's and K12's calls are also timed per
    layer width beside their bounds, and the request's K10 calls against
    the same steps launched one at a time.
11. ScanNet serving main path: SCANNET_REQUESTS requests through
    Predictor with seeded weights; outputs and exact launch counts; one
    forward with the kernels against one through the plain versions on the
    same pyramid (bit-equal); a profiled request.
12. ScanNet train main path: TRAIN_STEPS steps through make_train_step with
    ScanNet's settings, checked as in 7 (every CRF's c included); the step,
    its phases and a profile.
13. A ScanNet train step with the kernels against one through the plain
    versions differentiated by autograd, from one state and pyramid, as in
    8, and a second kernel step whose gradients must be bit-identical
    (K8, K11, K12 and K14 add without atomics; so for the flagship in 8
    and the discrete net in 14).
14. ScanNet-discrete (BaselineDiscreteCRFSegNet(20 classes, steps=10), B16 x
    8192, label_offset 1): a warm-up request (pyramid, forward, the last
    head log q, as the JAX package serves a two-head model) and a warm-up
    train step, recording every kernel call of each (K1, K2, K9, K13 in the
    request; K1, K2, K8, K9, K12, K13, K14 in the step; K13 and K14 one call
    a core for all its steps), each held against its plain
    version and timed as in 3 (K13's and K14's bounds beside the sum of
    their steps' one-step bounds), the request's K13 call and the step's
    K14 call also against the same steps launched one at a time (bit-equal,
    device and event ms of each); DISCRETE_REQUESTS requests and
    TRAIN_STEPS steps with exact launch counts, checked as in 11-12; a
    forward and a train step with the kernels against the plain versions,
    as in 13; profiles and peak memory.
15. Semantic3D serving (Semantic3DConfig: PointConvResNet(8 classes,
    use_crf, steps=1), B16 x 65536): a recorded warm-up request whose K1-K5
    calls are held against the plain versions; SEMANTIC3D_REQUESTS requests
    through Predictor with exact launch counts (K5 on conv2_1 and
    conv3_1); a kernel-vs-plain forward; a profile and peak memory.
16. Flagship exact serving (the exact neighbour regime, B8 x 8192): a
    recorded warm-up request (build_pyramid_device, then the forward in
    NeighborMode("exact")) whose K6 calls are held bit-equal against the
    plain version, exact and, where the row is at most 1024 wide, packed;
    EXACT_REQUESTS requests with exact launch counts (K6 10, every other
    kernel 0) and column 0 == self on >= 0.999 of every scale's rows;
    request, pyramid and forward times, a profile and peak memory.
17. Flagship exact train step on a pyramid built once: TRAIN_STEPS steps of
    make_train_step(NeighborMode("exact"), windowed=False), no kernel
    launched but the leaky ReLU's backward, a finite loss, every parameter
    moved; step time, phases, train points/s; one exact eval step.
18. Windowed 2-view eval (make_eval_step(eval_views=2), B8 x 8192): K1's
    phase on one eval's recorded calls, launch counts per eval (K1 30, K2
    20, K3 4, K4 2), probabilities finite and normalised, and against the
    same eval with K1, K3 and K4 replaced by their plain versions.
19. ScanNet-discrete exact serving (BaselineDiscreteCRFSegNet(20 classes,
    steps=10), B16 x 8192, ScanNet's kernel sizes, ratios and k_up = 3):
    a recorded warm-up request whose K6 calls are held bit-equal;
    DISCRETE_REQUESTS requests with K6 11 launches each (10 pyramid + the
    CRF's kNN(32)) and no other kernel; a kernel-vs-plain forward; times,
    a profile and peak memory.
20. ShapeNet serving (ShapeNetConfig: CRFSegNet_Part(50 classes,
    steps=10), B16 x 2048, 6 input channels, categories seeded in [0, 16),
    build_pyramid_windowed's defaults as the reference bench builds them):
    a recorded warm-up request (K1, K2, K9, K10 held against their plain
    versions; the coarsest CRF runs on 32 rows a cloud at width 256),
    SCANNET_REQUESTS requests through Predictor with the category, exact
    launch counts, finite normalised log-probabilities and their part IoU,
    a bit-equal kernel-vs-plain forward, a profile and peak memory.
21. ShapeNet training at B8 (SGD lr 0.01): a recorded warm-up step (K1,
    K2, K8, K9-K12, the leaky ReLU's backward), TRAIN_STEPS steps, a
    kernel-vs-plain step and a rerun bit-identical, as in 10-13; one more
    step with curve_jitter: its pyramid window-consistent at every scale,
    its loss finite, a rerun from the same seed bit-identical.
22. SemanticKITTI serving (SemanticKITTIConfig: PointConvResNet(19
    classes, 4 input channels, use_crf, steps=1), B8 x 65536 through
    Predictor), as Semantic3D's in 15, K1-K5 held on every recorded call.
23. SemanticKITTI training at B8 x 65536 (dropout 0.5, SGD lr 0.01,
    label_offset 1): a recorded warm-up step (K1, K2, K7 on four layers,
    K8, the leaky ReLU's backward), TRAIN_STEPS steps with exact launch
    counts, a kernel-vs-plain step and a rerun bit-identical.
24. ScanNet exact serving (CRFSegNet(20 classes, steps=10), B16 x 8192,
    build_pyramid_device with ScanNet's kernel sizes, ratios and k_up 3):
    K6 held bit-equal on every recorded call, K6 10 launches a request, the
    CRFs' scans in plain PyTorch; as in 19.
25. ScanNet exact training: each step builds its pyramid (K6 10 launches)
    and trains on it (the scans differentiated by autograd, the leaky
    ReLU's backward 41 launches); K6 and the leaky ReLU's backward held on
    a recorded step; TRAIN_STEPS steps checked as in 12, peak memory; a
    step with the kernels against one with K6 and the leaky ReLU's
    backward plain, and a rerun (autograd's gather backward adds with
    atomics: gradients held to their tolerance, bit-identity reported).
26. ScanNet-discrete exact training (BaselineDiscreteCRFSegNet(20 classes,
    steps=10), B16 x 8192), as in 25 (K6 11 launches a step with the CRF's
    kNN(32), the leaky ReLU's backward 37).
27. S3DIS training fed by the data layer: three rooms of 120,000 points
    written as S3DIS's raw files in a temporary directory (a storage room
    small enough that its crops are padded with duplicate points),
    processed by S3DISRoomDataset (numpy parse, the native grid subsample,
    grid 0.04) and cropped by the possibility sampler; MultiscaleLoader
    (emit "raw", prefetch 2, the train transform, pinned copies on a side
    stream) feeds the flagship's windowed train step at B8 x 8192: a
    recorded step whose K1, K2, K7, K8 and leaky-ReLU backward calls are
    held against their plain versions (K2 bit-equal); LOADER_STEPS (10)
    loader-fed steps with exact launch counts (K1 18, K2 10, K7 2, K8 18,
    K15 47), a finite loss and every parameter moved; the step's event ms fed
    by the loader against the same batches placed on the card beforehand
    (fed, placed, placed, fed); a profiled loader-fed step and peak memory;
    a loader without prefetch, restored to the first one's starting state,
    gives every batch bit for bit; the loader's host ms a batch and its
    H2D copy ms.
28. ShapeNet training fed by the data layer: the 16 categories' shapes
    (2,600-3,000 points) written as ShapeNet's raw files, read by
    ShapeNetNormalDataset and fed by MultiscaleLoader with the host
    pyramid of ShapeNetConfig (kernel sizes 32, 16, 8, 8, 8, ratios 4, 2,
    2, 2, 2, k_up 3, dilations 1, 2, 4, 2, 1; emit "pyramid", prefetch 2)
    to CRFSegNet_Part(50 classes, steps=10) in the exact regime at B8 x
    2048 with the category a cloud: the pyramid's column 0 self on every
    row, every index in range, neighbours outside the plain kNN(k) only at
    the dilated scales; the leaky ReLU's backward, the path's one kernel,
    held on a recorded step and counted exactly (41 a step); the steps as
    in 27; build_pyramid's host ms.

29. S3DIS through the experiment driver: ``main([...])`` of
    crfconv_tpu_torch.train.__main__ in this process, on the rooms of 27
    (Area_5 the val area), S3DISConfig's full-width flagship (use_crf,
    steps=1) at B8 x 8192, windowed with packed kNN, the 2-view val: two
    epochs of 5 steps and 2 val batches (launch counts set to 0 before the
    run and read after: K1 18, K2 10, K7 2, K8 18, K15 47 a step and K1 30,
    K2 20, K3 4, K4 2 a val batch, each val batch's also checked as it
    runs); every kernel call of a
    recorded step and val batch held against its plain version; finite
    losses, each val confusion summing to its labelled points, the latest
    and best checkpoints and their sidecars written; a second Trainer
    resumed from the last checkpoint draws the live one's next samples bit
    for bit and its next step gives a bit-identical loss and parameters; a
    profiled Trainer step; then ``--mode test``: the labeled vote test on
    the best checkpoint (sub-cloud and full-cloud mIoU and overall accuracy
    in [0, 1]; more than 40 passes fail), its eval batches counted and one
    held. Epoch, step, val and vote ms; the driver's overhead: Trainer
    epochs over 5 batches placed beforehand against the plain step in a
    loop on them, in turns (median against median, called resolved only
    where the two sides' interquartile ranges part), and beside it the
    Trainer's steps fed by the loader (each epoch's after its first)
    against phase 27's.
30. ShapeNet through the CLI: the shapes of 28, ShapeNetConfig's
    CRFSegNet_Part(50, steps=10) at B16 x 2048, windowed with curve
    jitter: one epoch and its 2-view val, launches checked a step
    (ScanNet's) and a val batch (twice a request's), a recorded step's K1,
    K2, K8-K12, K15 calls and val batch's K1, K2, K9, K10 calls held
    against their plain versions, then eval_partseg (pIoU, mpIoU in
    [0, 1]).
31. The bf16 compute mode: the full-width flagship at B8 x 8192, a request
    through Predictor and a train step under
    compute_dtype_scope(torch.bfloat16) and in float32 from the same
    weights and seeds: the same launch counts, every kernel call of the
    bf16 request and step held against its plain version on the float32
    inputs the wrapper widens it to (and the wrapper's result that one
    rounded), the median |logit| difference below 0.1, the loss float32
    and finite, the parameters float32, the scope restored; both modes'
    request and step ms.
32. The parity harness: ``main([...])`` of crfconv_tpu_torch.parity's CLI
    in this process, both arms on the card, on a synthetic room corpus
    (make_synthetic_rooms, 2 rooms an area of 40,000 points, written in a
    temporary directory) with S3DISConfig's full-width flagship through
    --scale-kw (use_crf, steps 1, B8 x 8192, windowed, 2-view val): 2
    epochs of 3 steps and 2 val batches, patience 1, 2 votes. The port arm
    (the Trainer) launches exactly K1 18, K2 10, K7 2, K8 18, K15 47 a step
    and K1 30, K2 20, K3 4, K4 2 a val or vote batch (counts set to 0
    before the run and read after; the oracle arm launches none); its
    recorded step and val batch held against the plain versions; the
    oracle's parameters and every input on the card; each arm's full and
    sub mIoU in [0, 1], the report's keys and delta. Then the arms as
    separate calls (CRFCONV_PARITY_ARM port, then torch): the second
    call's report carries both arm files unchanged. Each arm's epoch, step
    (events), val and vote ms and peak memory; the oracle's B8 x 8192 step
    beside the port's (exact host pyramid against windowed: a yardstick).
33. The utils: device_time of phase 4's request in both modes beside
    median_ms, finite and positive; profiling.trace around two requests
    writes one trace naming K1's device function; StepTimer over 5
    synchronised requests gives a finite, positive points/s.

The data phases print which host backend ran (the native library's
file). Prints the card's name and power limit, one JSON line of kernel results
and, last, {"ok": true, "device": {...}}. Exits non-zero, without that
last line, if any check fails or no GPU is present. Full results go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B, N, C_IN, N_CLASSES = 8, 8192, 6, 13
REQUESTS = 3
TRAIN_STEPS = 5
DROPOUT = 0.5
LR = 0.01
SEED = 0
DEVICE = "cuda:0"
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM float32, outside the tensor cores
PROFILE_REPS = 5    # runs of a phase profiled together, its device ms / 5
# launches of each kernel per B8 x 8192 request (pyramid + forward)
EXPECTED_PER_REQUEST = {
    "windowed_gather": 15,
    "window_knn": 10,
    "point_conv_fused_infer": 2,
    "crf_similarity_message": 1,
    "point_conv_fused_strided": 0,   # conv2_1 has 2048 < 4096 rows
    "crf_operator": 0,          # steps = 1: no fused CRF core
    "crf_iterate": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 0,      # the backward only
}
# launches of each kernel per B8 x 8192 train step (pyramid, forward,
# backward): K8 is the backward of every K1 gather whose source needs a
# gradient (all but the two gathers of pos) and of both K7 calls; the
# leaky ReLU's backward runs once per activation (47, counted in the
# model's code)
EXPECTED_PER_STEP = {
    "windowed_gather": 18,
    "window_knn": 10,
    "point_conv_fused_infer": 0,
    "crf_similarity_message": 0,
    "windowed_weighted_reduce": 2,
    "windowed_gather_bwd": 18,
    "crf_operator": 0,
    "crf_iterate": 0,
    "crf_iterate_bwd": 0,
    "crf_neighbor_dot": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 47,
}
# the flagship's activations per train step, in either regime
FLAGSHIP_LEAKY_PER_STEP = EXPECTED_PER_STEP["leaky_relu_bwd"]
SCANNET_REQUESTS = 3
# launches per B16 x 8192 ScanNet request with CRFSegNet(steps=10): K1 is
# the encoder's 10 gathers of [pos, h], 2 per k-NN interpolation (features
# and positions) and 2 per GuideCRFConv (the radius mask's positions and
# the similarity's guidance), 4 decoders each; each decoder's fused core
# builds its operator once (K9) and runs its 10 steps in one launch (K10)
SCANNET_PER_REQUEST = {
    "windowed_gather": 10 + 4 * 2 + 4 * 2,
    "window_knn": 10,
    "point_conv_fused_infer": 0,
    "crf_similarity_message": 0,
    "windowed_weighted_reduce": 0,
    "windowed_gather_bwd": 0,
    "crf_operator": 4,
    "crf_iterate": 4,
    "crf_iterate_bwd": 0,
    "crf_neighbor_dot": 0,
    "select_min_k": 0,
    "leaky_relu_bwd": 0,
}
# per ScanNet train step: the forward's, and in the backward K8 for every
# gather whose source needs a gradient (not the 4 + 4 gathers of
# positions), per core one build of the transpose's structure and 10
# reverse steps (K11) and one neighbour dot (K12), and one leaky-ReLU
# backward per activation
SCANNET_PER_STEP = {
    **SCANNET_PER_REQUEST,
    "windowed_gather_bwd": 10 + 4 + 4,
    "crf_iterate_bwd": 4 * (1 + 10),
    "crf_neighbor_dot": 4,
    "leaky_relu_bwd": 41,
}
# calls of each wrapper per ScanNet step: K11's reverse steps alone (its
# plan is built outside the wrapper)
SCANNET_CALLS_PER_STEP = {**SCANNET_PER_STEP, "crf_iterate_bwd": 4 * 10}
DISCRETE_REQUESTS = 3
# launches per B16 x 8192 ScanNet-discrete request with
# BaselineDiscreteCRFSegNet(steps=10): K1 is the encoder's 10 gathers, 2 per
# k-NN interpolation (4 decoders) and the discrete CRF's 2 (the kernel
# embeddings, F = 5 x 64, and the radius mask's positions); K2 the pyramid's
# 10 searches and the CRF's kNN(32); its fused core builds the operator once
# (K9) and runs its 10 steps in one launch (K13)
DISCRETE_PER_REQUEST = {
    "windowed_gather": 10 + 4 * 2 + 2,
    "window_knn": 10 + 1,
    "point_conv_fused_infer": 0,
    "crf_similarity_message": 0,
    "point_conv_fused_strided": 0,
    "windowed_weighted_reduce": 0,
    "windowed_gather_bwd": 0,
    "crf_operator": 1,
    "crf_iterate": 0,
    "crf_iterate_bwd": 0,
    "crf_neighbor_dot": 0,
    "discrete_iterate": 1,
    "discrete_iterate_bwd": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 0,
}
# per ScanNet-discrete train step: the forward's, and in the backward K8 for
# every gather whose source needs a gradient (not the 4 + 1 of positions),
# one build of the plan (S~^T by rows) and one launch of K14 for the 10
# reverse steps, one neighbour dot (K12) and one leaky-ReLU backward per
# activation
DISCRETE_PER_STEP = {
    **DISCRETE_PER_REQUEST,
    "windowed_gather_bwd": 10 + 4 + 1,
    "discrete_iterate_bwd": 1 + 1,
    "crf_neighbor_dot": 1,
    "leaky_relu_bwd": 37,
}
# calls of each wrapper per discrete step: K14's alone (its plan is built
# outside the wrapper)
DISCRETE_CALLS_PER_STEP = {**DISCRETE_PER_STEP, "discrete_iterate_bwd": 1}
EXACT_REQUESTS = 3
EXACT = None    # NeighborMode("exact"), set in main() after the import check
CARD = ""       # the card's name and power limit (nvidia-smi), set in main()
# launches per exact-regime request: K6 selects every kNN of the pyramid (a
# same-scale and an upsample search per scale), plus the discrete CRF's
# kNN(32); no other kernel runs in the exact regime (its gathers are plain
# index gathers, its CRFs the scans)
EXACT_PER_REQUEST = {"select_min_k": 10}
DISCRETE_EXACT_PER_REQUEST = {"select_min_k": 11}
# per windowed 2-view eval: twice a flagship request's launches
TWO_VIEW_PER_EVAL = {"windowed_gather": 30, "window_knn": 20,
                     "point_conv_fused_infer": 4, "crf_similarity_message": 2}
SEMANTIC3D_REQUESTS = 3
# launches per B16 x 65536 Semantic3D request: every eval PointConv with at
# least 4096 output rows and hidden width <= 32 runs fused, the same-scale
# conv1_1, conv1_2, conv2_2, conv3_2 (K3) and the strided conv2_1 and
# conv3_1 with their residual riders (K5); so does the CRF's similarity and
# first message (K4) of deconv1, deconv2 and deconv3 (hidden 8, 16, 32 on
# 65536, 16384, 4096 rows); K1 takes the other 4 convs' gathers, deconv4's
# CRF gather and the 4 upsamplings
SEMANTIC3D_PER_REQUEST = {
    "windowed_gather": 4 + 1 + 4,
    "window_knn": 10,
    "point_conv_fused_infer": 4,
    "crf_similarity_message": 3,
    "point_conv_fused_strided": 2,
    "windowed_weighted_reduce": 0,
    "windowed_gather_bwd": 0,
    "crf_operator": 0,
    "crf_iterate": 0,
    "discrete_iterate": 0,
    "select_min_k": 0,        # the exact regime only
    "leaky_relu_bwd": 0,
}
# ShapeNet's CRFSegNet_Part is the small family's CRF net with a wider
# classifier: a B16 x 2048 request launches what a ScanNet request does (its
# decoders' fused CRF cores at K 15 on 2048, 512, 128 and 32 rows a cloud),
# and a B8 step what a ScanNet step does (SCANNET_PER_REQUEST, _PER_STEP)
SHAPENET_TRAIN_BATCH = 8     # config_bench.py's micro: ShapeNet trains at B8
# SemanticKITTI serves the flagship at 65536 points a cloud, as Semantic3D:
# the launches of SEMANTIC3D_PER_REQUEST a request. Its train step contracts
# every same-scale conv with at least 4096 rows and width <= 32 through K7
# (conv1_1, conv1_2, conv2_2, conv3_2), each with a K1 gather of pos; the
# strided convs and the CRFs gather with K1 (the eval kernels K3-K5 do not
# train): K1 18, K7 4, and K8 for every gather but the 4 of pos and for the
# 4 K7 calls
KITTI_PER_STEP = {**EXPECTED_PER_STEP, "windowed_weighted_reduce": 4}
# per exact-regime train step, its pyramid built in the step: K6 selects the
# pyramid's 10 kNNs (and the discrete CRF's kNN(32)); the leaky ReLU's
# backward runs once per activation; the CRFs are the scans, plain PyTorch
SCANNET_EXACT_PER_STEP = {"select_min_k": 10, "leaky_relu_bwd": 41}
DISCRETE_EXACT_PER_STEP = {"select_min_k": 11, "leaky_relu_bwd": 37}
REPLACES = {
    "windowed_gather": "crfconv_tpu/ops/windowed_pallas.py:448",
    "window_knn": "crfconv_tpu/ops/windowed_pallas.py:684",
    "point_conv_fused_infer": "crfconv_tpu/ops/conv_pallas.py:380",
    "crf_similarity_message": "crfconv_tpu/ops/crf_sim_pallas.py:146",
    "windowed_weighted_reduce": "crfconv_tpu/ops/windowed_pallas.py:842",
    "windowed_gather_bwd": "crfconv_tpu/ops/windowed_pallas.py:372",
    "crf_operator": "crfconv_tpu/ops/crf_pallas.py:149",
    "crf_iterate": "crfconv_tpu/ops/crf_pallas.py:278",
    "crf_iterate_bwd": "crfconv_tpu/ops/crf_pallas.py:403",
    "crf_neighbor_dot": "crfconv_tpu/ops/crf_pallas.py:1147",
    "point_conv_fused_strided": "crfconv_tpu/ops/conv_pallas.py:258",
    "discrete_iterate": "crfconv_tpu/ops/crf_pallas.py:690",
    "discrete_iterate_bwd": "crfconv_tpu/ops/crf_pallas.py:1383",
    "select_min_k": "crfconv_tpu/ops/windowed_pallas.py:285",
    # flax's leaky-ReLU gradient at 0 in one launch; no TPU kernel
    "leaky_relu_bwd": None,
}


def only(counts: dict) -> dict:
    """Expected launches: ``counts``, and 0 for every other kernel."""
    return {name: counts.get(name, 0) for name in REPLACES}

FAILURES = []
# kernels whose every replayed call was bit-equal to the plain version
BIT_EQUAL = {}
# largest fraction of its rounding bound that a kernel (and its plain
# version) reached, over the calls of one phase: {kernel: [kernel, plain]}
OF_BOUND = {}
# widths of the K6 calls also held in packed mode
PACKED_CHECKED = []
# launches of each kernel in each main path: {kernel: {path: count}}
LAUNCHES = {name: {} for name in REPLACES}
# requests, steps or evals of each main path: {path: count}
UNITS = {}


def record_launches(path: str, counts: dict, expected: dict, units: int,
                    unit: str) -> None:
    """Check one main path's launch counts against ``expected`` per
    ``unit`` and keep them."""
    UNITS[path] = units
    for name, per in expected.items():
        expect(counts[name] == per * units,
               f"{path}: {counts[name]} launches of {name} in {units} "
               f"{unit}, expected {per * units}")
        LAUNCHES[name][path] = counts[name]


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


def train_call_sites():
    """As :func:`call_sites`, for the kernels of the train step: K1 and K7
    are reached inside their autograd Functions, K8 in their backward."""
    from crfconv_tpu_torch.ops import activation, windowed

    return {
        "windowed_gather": (windowed, "_windowed_gather_launch",
                            windowed._windowed_gather_launch,
                            windowed.windowed_gather_plain),
        "window_knn": (windowed, "window_knn", windowed.window_knn,
                       windowed.window_knn_plain),
        "windowed_weighted_reduce": (
            windowed, "windowed_weighted_reduce",
            windowed.windowed_weighted_reduce,
            windowed.windowed_weighted_reduce_plain,
        ),
        "windowed_gather_bwd": (windowed, "windowed_gather_bwd",
                                windowed.windowed_gather_bwd,
                                windowed.windowed_gather_bwd_plain),
        "leaky_relu_bwd": (activation, "leaky_relu_bwd",
                           activation.leaky_relu_bwd,
                           activation.leaky_relu_bwd_plain),
    }


def leaky_plain_pair():
    """The leaky ReLU's backward kernel replaced by its plain version, for
    the steps through the plain versions."""
    from crfconv_tpu_torch.ops import activation

    return (activation, "leaky_relu_bwd", activation.leaky_relu_bwd_plain)


def record_calls(sites, run, snapshot=()):
    """Run ``run()`` and return every call each kernel wrapper received
    (through the site's attribute, whatever the phase replays it with).
    For the kernels named in ``snapshot``, whose inputs are buffers that
    the caller overwrites later (the CRF cores' ping-pong states), the
    tensors are copied as they were and the output buffers dropped, so a
    replay computes the recorded call into fresh outputs; a K13 call that
    saved its stacks replays with ``with_stack``, a K10 call that saved its
    stack with ``with_xs``."""
    calls = {name: [] for name in sites}

    def recorder(name, fn):
        def rec(*args, **kwargs):
            if name in snapshot:
                kw = {k: v for k, v in kwargs.items()
                      if k not in ("out", "dmsg_out", "msg_out", "xs", "qs",
                                   "msgs", "dmsgs")}
                if kwargs.get("msgs") is not None:
                    kw["with_stack"] = True   # K13 saving its stacks
                if kwargs.get("xs") is not None:
                    kw["with_xs"] = True    # K10 saving the stack
                calls[name].append((
                    tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args), kw,
                ))
            else:
                calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return rec

    with patched([(m, a, recorder(name, getattr(m, a)))
                  for name, (m, a, _, _) in sites.items()]):
        run()
    return calls


# --------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once, and the
# operations the function needs on these inputs
# --------------------------------------------------------------------------


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound_of(name, args, out, kwargs=None):
    outs = out if isinstance(out, tuple) else (out,)
    in_bytes = nbytes(*args)
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
    elif name == "windowed_weighted_reduce":
        ops = 2 * args[1].numel()          # a multiply and an add per u
    elif name == "windowed_gather_bwd":
        ops = args[0].numel()              # an add per element of g
    elif name == "crf_operator":
        ops = 0                            # a clamp per index
    elif name == "leaky_relu_bwd":
        ops = args[0].numel()              # a comparison per element
    elif name in ("crf_iterate", "crf_iterate_bwd"):
        x, s_ = args[0], args[2]
        b, n, h = x.shape
        k = s_.shape[2]
        # the message (2 K H a row) and the apply (2 H^2) a step (K10 runs
        # args[5] steps); the backward adds the scatter (2 K H), dM (2 H^2)
        # and dzp (H)
        per_row = 2 * k * h + 2 * h * h
        ops = b * n * (per_row * args[5] if name == "crf_iterate"
                       else 2 * per_row + h)
    elif name == "crf_neighbor_dot":
        t, b, n, h = args[1].shape
        ops = 2 * t * b * n * args[2].shape[2] * h
    elif name == "point_conv_fused_strided":
        x, idx, res = args[0], args[3], args[4]
        b, m, k = idx.shape
        h = x.shape[2]
        # the weight MLP and the product per neighbour, the rider's max
        ops = b * m * k * (2 * h * h + 11 * h + 3 + res.shape[2])
    elif name == "select_min_k":
        ops = args[0].numel()              # a comparison per entry
    elif name == "discrete_iterate":
        # every step's message (2 L a kept slot), L x L product (2 L^2) and
        # softmax (~5 L a row); p, u, w, col, C read, q_steps (and the
        # stacks) written once
        p_, col_, steps = args[0], args[3], args[5]
        b, n, l = p_.shape
        slots = int((col_ >= 0).sum())
        ops = steps * (2 * slots * l + b * n * (2 * l * l + 5 * l))
    elif name == "discrete_iterate_bwd":
        # every reverse step's transpose (2 L a term of the plan), dmsg and
        # dC (2 L^2 each) and dot, dz, du (~5 L a row); g, q_1..q_steps, the
        # msg stack, C and the plan (S~^T by rows, encoding w and col) read,
        # dp, the dmsg stack, du and dC written once
        g_, qs_, plan = args[0], args[1], kwargs.get("plan")
        steps, b, n, l = qs_.shape
        terms = (int(plan.row_ptr[-1]) if plan is not None
                 else int((args[5] >= 0).sum()))
        ops = steps * (2 * terms * l + b * n * (4 * l * l + 5 * l))
        in_bytes = (nbytes(g_, qs_[1:], args[2], args[3], args[6])
                    + 4 * (b * n + 1) + 8 * terms)
    else:  # crf_similarity_message
        y, idx = args[0], args[2]
        b, n, h = y.shape
        ops = b * n * idx.shape[2] * (5 * h + 4)
    t_bytes = (in_bytes + nbytes(*outs)) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def step_bound_of(name, args, out) -> float:
    """The sum of the one-step bounds of a fused discrete call's steps (K13,
    K14): each step's inputs read and outputs written once, as the one-step
    entries (one launch a step) move them."""
    if name == "discrete_iterate":
        state, w_, col_, c_, steps = args[0], args[2], args[3], args[4], args[5]
        rows = 3 + (out[2] is not None)  # q_t, u, q_{t+1} (and msg_t)
        mats = nbytes(c_)
    else:
        state, w_, col_, c_ = args[0], args[4], args[5], args[6]
        steps = args[1].shape[0]
        rows = 7  # lam, q_{t+1}, msg_t, du in; lam_t, dmsg_t, du out
        mats = 3 * nbytes(c_)  # C, and dC in and out
    b, n, l = state.shape
    per_row = 2 * l * l + 5 * l if name == "discrete_iterate" else \
        4 * l * l + 5 * l
    ops = 2 * int((col_ >= 0).sum()) * l + b * n * per_row
    step_bytes = rows * nbytes(state) + nbytes(w_, col_) + mats
    return steps * max(step_bytes / PEAK_BYTES_PER_S,
                       ops / PEAK_F32_OPS_PER_S) * 1e3


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
        # distinct keys, the same distance rounding: one answer
        pos = args[0]
        same = len(args) < 3 or args[2] is None
        expect(torch.equal(got, ref), "window_knn: not bit-equal")
        g = got.cpu().numpy()
        cons = check_window_consistency(g, pos.shape[1])
        expect(cons == 1.0, f"window_knn: window consistency {cons}")
        if same:
            self_ok = bool((got[:, :, 0] == torch.arange(
                got.shape[1], device=got.device)).all())
            expect(self_ok, "window_knn: column 0 is not self")
        return float((got.long() - ref.long()).abs().max())
    if name == "select_min_k":
        # distinct keys: one order, bit for bit; packed too where the row
        # is at most 1024 wide
        from crfconv_tpu_torch.ops.windowed import (
            PACKED_MAX_WIDTH, select_min_k, select_min_k_plain,
        )
        d, k = args[0], args[1]
        expect(torch.equal(got, ref), "select_min_k: not bit-equal")
        if d.shape[-1] <= PACKED_MAX_WIDTH:
            PACKED_CHECKED.append(d.shape[-1])
            expect(torch.equal(select_min_k(d, k, False),
                               select_min_k_plain(d, k, False)),
                   "select_min_k: packed mode not bit-equal")
        return float((got.long() - ref.long()).abs().max())
    if name == "windowed_weighted_reduce":   # one order of the k-sum
        expect(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
               "windowed_weighted_reduce: out or xg not bit-equal")
    if name == "windowed_gather_bwd":
        # f32 atomics add each row's terms in no fixed order. Any order (or
        # tree) of the n adds into a row lies within g sum|term| of the
        # exact sum, g = (n - 1) u / (1 - (n - 1) u) with u = 2^-24, plus
        # 2^-126 an add that atom.add.f32 flushes when subnormal; the kernel
        # (and, for comparison, the plain version) is held to that around
        # the sum taken in float64. A row of two terms can reach 1 - u of it
        from crfconv_tpu_torch.ops.windowed import windowed_gather_bwd_plain
        g, rest = args[0].double(), args[1:]
        exact = windowed_gather_bwd_plain(g, *rest)
        mass = windowed_gather_bwd_plain(g.abs(), *rest)
        terms = windowed_gather_bwd_plain(torch.ones_like(g[..., :1]), *rest)
        nu = (terms - 1).clamp(min=0) * 2.0 ** -24
        bound = (nu / (1 - nu) * mass
                 + torch.finfo(torch.float32).tiny * terms)
        frac = [float(((t.double() - exact).abs() / bound).nan_to_num(0.0)
                      .max()) for t in (got, ref)]
        OF_BOUND[name] = [max(a, b) for a, b in
                          zip(OF_BOUND.get(name, frac), frac)]
        expect(frac[0] <= 1.0, "windowed_gather_bwd: outside the rounding "
               f"bound of the exact sum ({frac[0]:.7g} of it)")
    if name == "crf_iterate":
        # every step in one sum order (k, then h ascending), no fused
        # multiply-add, as the plain loop adds: x_steps and the saved stack
        # bit-equal
        expect(torch.equal(got[0], ref[0]), f"{name}: not bit-equal")
        if ref[1] is not None:
            expect(got[1] is not None and torch.equal(got[1], ref[1]),
                   f"{name}: the saved stack not bit-equal")
        return float((got[0] - ref[0]).abs().max())
    if name in ("crf_operator", "leaky_relu_bwd"):
        # one clamp; one comparison
        expect(torch.equal(got, ref), f"{name}: not bit-equal")
        return float((got - ref).abs().max()) if got.numel() else 0.0
    if name == "crf_similarity_message":
        # one order of every sum, no atomics: a rerun is bit-identical
        from crfconv_tpu_torch.ops.crf_sim import crf_similarity_message
        again = crf_similarity_message(*args)
        expect(torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1]),
               f"{name}: a rerun is not bit-identical")
    if name == "crf_iterate_bwd":
        from crfconv_tpu_torch.ops.crf_core import _message
        lam, x, s_, col, m = args[:5]
        # dmsg (one order, as the plain version) and dzp + lam: bit-equal
        expect(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
               "crf_iterate_bwd: dmsg or dzp not bit-equal")
        # lam_t: within the rounding bound of the exact sum over the
        # kernel's dmsg (the plain version's index_add_ on the card adds
        # with atomics, which flush subnormals)
        lam_bound(name, got[0], s_, col, got[1])
        # dM: chunk sums added in order into the running sum against one
        # product over every row added to it (B*N terms, 131072 at deconv1:
        # float32 rounding grows with their count in either order, at the
        # scale of the running sum and of the products)
        h = lam.shape[-1]
        dm_mass = args[6].abs() + (_message(x.abs(), s_, col).reshape(-1, h).T
                                   @ lam.abs().reshape(-1, h))
        expect(bool(((got[3] - ref[3]).abs() <= 1e-4 * dm_mass
                     + 1e-6 * float(dm_mass.max())).all()),
               "crf_iterate_bwd: dM outside 1e-4 of its mass")
        return max(float((a - r).abs().max()) for a, r in zip(got, ref))
    if name == "point_conv_fused_strided":
        # the convolution: float32 sums in another order, as K3; the
        # rider's max is exact
        ok = torch.allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)
        expect(ok, f"{name}: out outside rtol 1e-4 atol 1e-5")
        expect(torch.equal(got[1], ref[1]), f"{name}: rider max not equal")
        return float((got[0] - ref[0]).abs().max())
    if name == "discrete_iterate":
        # every step in one sum order (k, then j, then l ascending) in both;
        # expf may round apart from torch.exp, so q_steps and the q stack
        # are held to 2e-6 of their scale, and every msg_t bit-equal to the
        # message of the kernel's own q_t
        from crfconv_tpu_torch.ops.crf_core import _message
        q_scale = float(ref[0].abs().max())
        d_q = float((got[0] - ref[0]).abs().max())
        BIT_EQUAL.setdefault(name, True)
        BIT_EQUAL[name] &= bool(torch.equal(got[0], ref[0]))
        expect(d_q <= 2e-6 * q_scale, f"{name}: q off by {d_q}")
        if ref[1] is not None:
            expect(got[1] is not None, f"{name}: no stacks saved")
            d_s = float((got[1] - ref[1]).abs().max())
            expect(d_s <= 2e-6 * q_scale, f"{name}: q stack off by {d_s}")
            BIT_EQUAL[name] &= bool(torch.equal(got[1], ref[1])
                                    and torch.equal(got[2], ref[2]))
            w_, col = args[2], args[3]
            expect(all(torch.equal(got[2][t], _message(got[1][t], w_, col))
                       for t in range(got[1].shape[0])),
                   f"{name}: a msg_t not bit-equal to the message of its q_t")
            d_q = max(d_q, d_s)
        return d_q
    if name == "discrete_iterate_bwd":
        g_, qs_, q_last, msgs_, w_, col, c_ = args[:7]
        # the first reverse step reads the same inputs in both: its dmsg is
        # bit-equal; the later ones read lam, which the plain version on the
        # card adds with atomics (check_reverse holds every output bit-equal
        # to the plain version on CPU copies)
        expect(torch.equal(got[1][-1], ref[1][-1]),
               f"{name}: the first reverse step's dmsg not bit-equal")
        lam_bound(name, got[0], w_, col, got[1][0])   # lam_0, as K11's lam_t
        # dC: every row's and step's products summed in a fixed order of
        # partials, against the mass of its terms over the kernel's steps
        dc_mass = discrete_dc_mass(args, got)
        expect(bool(((got[3] - ref[3]).abs() <= 1e-4 * dc_mass
                     + 1e-6 * float(dc_mass.max())).all()),
               f"{name}: dC outside 1e-4 of its mass")
        return max(float((a - r).abs().max()) for a, r in zip(got, ref))
    if name == "crf_neighbor_dot":
        from crfconv_tpu_torch.ops.crf_core import (
            crf_neighbor_dot, crf_neighbor_dot_plain,
        )
        mass = crf_neighbor_dot_plain(args[0].abs(), args[1].abs(), args[2])
        expect(bool(((got - ref).abs() <= 1e-5 * mass
                     + 1e-6 * float(mass.max())).all()),
               "crf_neighbor_dot: outside 1e-5 of its mass")
        # one fixed order a sum, no atomics: a rerun is bit-identical
        expect(torch.equal(got, crf_neighbor_dot(*args)),
               "crf_neighbor_dot: a rerun is not bit-identical")
        return float((got - ref).abs().max())
    # K3, K4: float32 sums in another order than the plain matmuls and
    # sums; K8 also within the bound above
    err = 0.0
    for a, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        ok = torch.allclose(a, r, rtol=1e-4, atol=1e-5)
        expect(ok, f"{name}: outside rtol 1e-4 atol 1e-5")
        err = max(err, float((a - r).abs().max()))
    return err


def discrete_dc_mass(args, got):
    """sum_t |msg_t|^T |dz_t| of a fused K14 call, dz_t formed from the
    kernel's own dmsg stack (lam_{t+1} = S~^T dmsg_{t+1}, g at the top)."""
    from crfconv_tpu_torch.ops.crf_core import crf_iterate_bwd_plain
    g_, qs_, q_last, msgs_, w_, col = args[:6]
    steps, l = qs_.shape[0], qs_.shape[-1]
    eye = torch.eye(l, device=g_.device)
    zero = torch.zeros_like(g_)
    mass = torch.zeros((l, l), device=g_.device)
    for t in range(steps):
        qn = q_last if t == steps - 1 else qs_[t + 1]
        lam = g_ if t == steps - 1 else crf_iterate_bwd_plain(
            got[1][t + 1], zero, w_, col, eye, zero, torch.zeros_like(eye))[0]
        dz = qn * (lam - (lam * qn).sum(-1, keepdim=True))
        mass += msgs_[t].abs().reshape(-1, l).T @ dz.abs().reshape(-1, l)
    return mass


# K8's determinism checks per path: [calls, reruns bit-identical, calls
# bit-equal to the plain version on CPU copies (or None where not held)]
BWD_CHECKS = {}
# paths whose K8 calls are held bit-equal to the plain version on CPU
# copies: index_add_ on the CPU adds in index order, as K8 does; the
# discrete step's 5 GB calls and SemanticKITTI's (B8 x 65536, held on the
# CPU by tests/test_torch_cuda.py) keep the rounding bound alone
BWD_CPU_PATHS = ("flagship train", "scannet train", "shapenet train",
                 "s3dis_loader train")


def check_gather_bwd(kernel, args, kwargs, got, path) -> None:
    """K8 sums each row's terms in ascending slot order: a second launch
    is bit-identical, and on BWD_CPU_PATHS the result is bit-equal to the
    plain version run on CPU copies of the inputs."""
    from crfconv_tpu_torch.ops.windowed import windowed_gather_bwd_plain

    rec = BWD_CHECKS.setdefault(path, [0, 0, None])
    rec[0] += 1
    again = kernel(*args, **kwargs)
    same = torch.equal(got, again)
    rec[1] += same
    expect(same, f"windowed_gather_bwd ({path}): a rerun is not "
           "bit-identical")
    if path in BWD_CPU_PATHS:
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        equal = torch.equal(got.cpu(), windowed_gather_bwd_plain(*cpu,
                                                                 **kwargs))
        rec[2] = (rec[2] or 0) + equal
        expect(equal, f"windowed_gather_bwd ({path}): not bit-equal to the "
               "plain version on the CPU")


def lam_bound(name, lam_t, w, col, dmsg) -> None:
    """lam_t = S~^T dmsg against its exact sum (float64) over the same
    products: any order of a row's n terms w * dmsg, each rounded, lies
    within g sum|term| of it, g = n u / (1 - n u), u = 2^-24, plus 2^-150
    a product that rounds to a subnormal; no allowance for flushed adds.
    Records the kernel's fraction of the bound in OF_BOUND."""
    from crfconv_tpu_torch.ops.crf_core import crf_iterate_bwd_plain

    b, n, h = dmsg.shape
    eye = torch.eye(h, dtype=torch.float64, device=dmsg.device)
    zero = torch.zeros_like(dmsg, dtype=torch.float64)

    def transpose(ws, d):   # S~^T d in float64 (d as dmsg, M = I)
        return crf_iterate_bwd_plain(d, zero, ws, col, eye, zero,
                                     torch.zeros_like(eye))[0]

    exact = transpose(w.double(), dmsg.double())
    mass = transpose(w.double().abs(), dmsg.double().abs())
    ones = torch.ones_like(zero[..., :1])
    terms = crf_iterate_bwd_plain(
        ones, zero[..., :1], torch.ones_like(w, dtype=torch.float64), col,
        eye[:1, :1], zero[..., :1], torch.zeros_like(eye[:1, :1]))[0]
    nu = terms * 2.0 ** -24
    bound = nu / (1 - nu) * mass + terms * 2.0 ** -150
    frac = float(((lam_t.double() - exact).abs() / bound).nan_to_num(0.0)
                 .max())
    OF_BOUND[name] = [max(frac, OF_BOUND.get(name, [0.0])[0]), None]
    expect(frac <= 1.0, f"{name}: lam_t outside the rounding bound of the "
           f"exact sum ({frac:.7g} of it)")


# K11's and K14's determinism checks per path: [calls, reruns
# bit-identical, calls held to the plain version on CPU copies, of those
# bit-equal]. The CPU check takes the first reverse step of each core's
# backward for K11 (every REVERSE_CPU_EVERY-th call: 10 steps a core) and
# every K14 call (all of a core's reverse steps in one call)
REVERSE_CHECKS = {}
REVERSE_CPU_EVERY = 10


def check_reverse(name, kernel, plain, i, args, kwargs, got, path) -> None:
    """A second launch of a reverse step (K11) or of a core's reverse steps
    (K14) is bit-identical in every output; on every REVERSE_CPU_EVERY-th
    K11 call and every K14 call the outputs are bit-equal to the plain
    version run on CPU copies of the inputs (lam_t adds in index_add_'s CPU
    order, dmsg and the running sum of dzp or du in the plain version's; dM
    or dC is held to its bound in compare)."""
    rec = REVERSE_CHECKS.setdefault(f"{name} ({path})", [0, 0, 0, 0])
    rec[0] += 1
    again = kernel(*args, **kwargs)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    rec[1] += same
    expect(same, f"{name} ({path}): a rerun is not bit-identical")
    if name == "crf_iterate_bwd" and i % REVERSE_CPU_EVERY:
        return
    rec[2] += 1
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    ref = plain(*cpu)
    equal = all(torch.equal(a.cpu(), r) for a, r in zip(got[:3], ref[:3]))
    rec[3] += equal
    expect(equal, f"{name} ({path}): lam_t (dp), dmsg or the running sum "
           "not bit-equal to the plain version on the CPU")


def plan_ms(name, calls) -> dict:
    """Build time of the distinct plans (S~^T's structure, W^T, the
    workspaces) that the recorded reverse steps shared: one a core's
    backward, outside the steps' own times."""
    from crfconv_tpu_torch.ops import crf_core, discrete_core

    plans = {}
    for args, kwargs in calls:
        geo = kwargs["plan"].geometry
        plans.setdefault(id(kwargs["plan"]), (
            (crf_core.crf_reverse_plan, (args[3], args[4]) + geo)
            if name == "crf_iterate_bwd" else
            (discrete_core.discrete_reverse_plan, tuple(args[4:7]) + geo)))
    jobs = list(plans.values())

    def run():
        return [build(*a) for build, a in jobs]

    return {"plans": len(jobs), "ms": median_ms(run),
            "device_ms": device_ms(run, PROFILE_REPS)[0],
            "host_us": host_us(run, len(jobs))}


def library_call(name, args):
    """One PyTorch call computing the same function, or None. The main
    path's indices are window-consistent, so the clamp is the identity."""
    if name == "windowed_gather":
        x, idx = args[0], args[1]
        b_ix = torch.arange(x.shape[0], device=x.device)[:, None, None]
        gidx = idx.long()
        return lambda: x[b_ix, gidx]
    if name == "select_min_k":
        # the same set; torch.topk's order among ties is not guaranteed
        d, k = args[0], args[1]
        return lambda: torch.topk(d, k, dim=-1, largest=False)
    if name == "windowed_gather_bwd":
        g, idx, n = args[0], args[1], args[2]
        b, f = g.shape[0], g.shape[-1]
        rows = (torch.arange(b, device=g.device)[:, None, None] * n
                + idx.long()).reshape(-1)
        src = g.reshape(-1, f)
        return lambda: torch.zeros(
            (b * n, f), device=g.device
        ).index_add_(0, rows, src)
    return None


def device_ms(fn, reps: int = PROFILE_REPS):
    """Device time of one call of ``fn``: the sum of every CUDA kernel,
    copy and fill it ran (torch.profiler), and those by name with their
    launches, over ``reps`` calls profiled together, divided by ``reps``
    (the profiler misses a single short call, and counted one of K5's two
    calls in a phase profiled once)."""
    rows = profile_device(lambda: [fn() for _ in range(reps)])
    return (sum(r[1] for r in rows) / reps,
            [(k, ms / reps, n / reps) for k, ms, n in rows])


def kernel_functions(name) -> tuple:
    """The __global__ functions of a kernel's source and of the csrc/
    headers it includes: the device functions its launches run."""
    csrc = os.path.join(HERE, "crfconv_tpu_torch", "csrc")
    seen, todo, names = set(), [kernel_source(name)], set()
    while todo:
        f = todo.pop()
        if f in seen or not os.path.exists(os.path.join(csrc, f)):
            continue
        seen.add(f)
        with open(os.path.join(csrc, f)) as fh:
            text = fh.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            text))
        todo += re.findall(r'#include\s+"([^"]+)"', text)
    return tuple(sorted(names))


def profiled_launches(rows, functions) -> float:
    """Launches a run of ``functions`` in profiler rows (name, ms, launches
    a run); copies, fills and PyTorch's own kernels do not count."""
    pat = re.compile(r"\b(?:" + "|".join(map(re.escape, functions)) + r")\b")
    return sum(n for key, _, n in rows if pat.search(key))


def check_profiled_launches(label, rows, functions, calls) -> float:
    """Fail the run where the profiler recorded fewer launches of the
    kernel's own device functions than the phase made calls (a kernel that
    launches several functions a call passes with more)."""
    got = profiled_launches(rows, functions)
    expect(got >= calls, f"{label}: the profiler recorded {got:g} launches "
           f"of {', '.join(functions)} a run, fewer than its {calls} calls")
    return got


def host_us(fn, calls: int, runs: int = 5) -> float:
    """Host time of one wrapper call: the wall time of ``fn`` (``calls``
    calls, no synchronisation inside) over ``calls``, median of ``runs``."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) / calls * 1e6


def host_split_us(kernel, calls) -> dict:
    """Host time of one K1 call, split: the wrapper as the path calls it,
    ``Kernel.__call__`` on the arguments the wrapper marshalled, and the
    bare ctypes function on them. The outputs stay alive while their
    pointers are relaunched."""
    from crfconv_tpu_torch import cuda_build

    k1 = cuda_build.WINDOWED_GATHER
    fn = k1._fn
    marshalled = []
    k1._fn = lambda *a: marshalled.append(a) or fn(*a)
    try:
        keep = [kernel(*a, **k) for a, k in calls]
    finally:
        k1._fn = fn
    n = len(calls)
    split = {
        "wrapper": host_us(lambda: [kernel(*a, **k) for a, k in calls], n),
        "kernel_call": host_us(lambda: [k1(*a) for a in marshalled], n),
        "ctypes": host_us(lambda: [fn(*a) for a in marshalled], n),
    }
    del keep
    return split


# the kernels timed per group of calls: the group's key and label, and the
# output rows of a call
WIDTHS = {
    "crf_iterate": (lambda a: a[0].shape[-1], lambda key: f"H {key}",
                    lambda a: a[0].shape[-3] * a[0].shape[-2]),
    "crf_neighbor_dot": (lambda a: a[1].shape[-1], lambda key: f"H {key}",
                         lambda a: a[1].shape[-3] * a[1].shape[-2]),
    "point_conv_fused_infer": (lambda a: a[0].shape[-1],
                               lambda key: f"H {key}",
                               lambda a: a[0].shape[0] * a[0].shape[1]),
    "point_conv_fused_strided": (
        lambda a: (a[3].shape[1], a[0].shape[2], a[4].shape[2]),
        lambda key: f"M {key[0]} H {key[1]} R {key[2]}",
        lambda a: a[3].shape[0] * a[3].shape[1]),
    # K4 by (rows, H), K9 by (rows, K): one group a call shape
    "crf_similarity_message": (
        lambda a: (a[0].shape[0] * a[0].shape[1], a[0].shape[2]),
        lambda key: f"rows {key[0]} H {key[1]}",
        lambda a: a[0].shape[0] * a[0].shape[1]),
    "crf_operator": (
        lambda a: (a[0].shape[0] * a[0].shape[1], a[0].shape[2]),
        lambda key: f"rows {key[0]} K {key[1]}",
        lambda a: a[0].shape[0] * a[0].shape[1]),
}


def per_width(name, kernel, calls) -> list:
    """K10's, K12's and K3's calls of one path grouped by width (one group a
    layer width), K5's by (M, H, R), K4's by (rows, H), K9's by (rows, K):
    per group the calls, device and event
    ms, host us a call, the bound and its ratio; for K10 also the sum of
    its steps' one-step bounds (each step's x, zp, s, col and out moved
    once). The device time is the profiler's over five runs of the group,
    over five: it misses a single short call."""
    key_of, label_of, rows_of = WIDTHS[name]
    groups = {}
    for a, k in calls:
        groups.setdefault(key_of(a), []).append((a, k))
    rows = []
    for key, group in sorted(groups.items()):
        def run():
            for a, k in group:
                kernel(*a, **k)
        bound, step_bound = 0.0, 0.0
        for a, k in group:
            out = kernel(*a, **k)
            bound += bound_of(name, a, out)[0]
            if name == "crf_iterate":
                one = bound_of(name, a[:5] + (1,), out[0])[0]
                step_bound += one * a[5]
        dev_ms = device_ms(run)[0]
        row = {"h": (key if isinstance(key, int) else
                     None if name == "crf_operator" else key[1]),
               "group": label_of(key), "rows": int(rows_of(group[0][0])),
               "calls": len(group), "device_ms": dev_ms, "ms": median_ms(run),
               "host_us": host_us(run, len(group)), "bound_ms": bound,
               "of_bound": dev_ms / bound if bound and dev_ms else None}
        if name == "crf_iterate":
            row["steps"] = sum(a[5] for a, _ in group)
            row["step_bound_ms"] = step_bound
        rows.append(row)
    return rows


def steps_vs_launches(name, calls) -> dict:
    """A fused CRF kernel's recorded calls (K10's or K13's of a request, K14's
    of a step) run as recorded (all of a call's steps in one launch, grid
    barriers between steps) and as one launch a step (the same kernel at
    steps = 1, ping-ponging two buffers, or K14's one-step entry over the
    call's plan): device and event ms of each, and the launches. The two
    run the same arithmetic: their outputs must be bit-equal (K14's dC adds
    its partials in another order)."""
    from crfconv_tpu_torch.ops import crf_core, discrete_core

    if name == "discrete_iterate_bwd":
        def fused_one(a, k):
            return discrete_core.discrete_iterate_bwd_steps(*a[:7],
                                                            plan=k["plan"])

        def stepwise_one(i, a, k):
            g_, qs_, q_last, msgs_, w_, col, c_ = a[:7]
            steps = qs_.shape[0]
            lam, du, dC = g_, torch.zeros_like(g_), torch.zeros_like(c_)
            dmsgs = torch.empty_like(msgs_)
            for t in reversed(range(steps)):
                qn = q_last if t == steps - 1 else qs_[t + 1]
                lam, _, du, dC = discrete_core.discrete_iterate_bwd(
                    lam, qn, msgs_[t], w_, col, c_, du, dC,
                    dmsg_out=dmsgs[t], plan=k["plan"])
            return lam, dmsgs, du
        steps_of = [a[1].shape[0] for a, _ in calls]
    else:
        fuse, one = ((crf_core.crf_iterate_steps, crf_core.crf_iterate)
                     if name == "crf_iterate" else
                     (discrete_core.discrete_iterate_steps,
                      discrete_core.discrete_iterate))
        bufs = [(torch.empty_like(a[0]), torch.empty_like(a[0]))
                for a, _ in calls]

        def fused_one(a, k):
            return (fuse(*a[:6]),)

        def stepwise_one(i, a, k):
            x = a[0]
            for t in range(a[5]):
                x = one(x, *a[1:5], out=bufs[i][t % 2])
            return (x,)
        steps_of = [a[5] for a, _ in calls]

    def fused():
        for a, k in calls:
            fused_one(a, k)

    def stepwise():
        for i, (a, k) in enumerate(calls):
            stepwise_one(i, a, k)

    # one order of the sums: the two are bit-equal
    for i, (a, k) in enumerate(calls):
        got, ref = fused_one(a, k), stepwise_one(i, a, k)
        expect(all(torch.equal(x, y) for x, y in zip(got, ref)),
               f"{name}: one launch a step differs from the fused call")
    r = {"launches_fused": len(calls), "launches_stepwise": sum(steps_of)}
    for label, fn in (("fused", fused), ("stepwise", stepwise),
                      ("stepwise_again", stepwise), ("fused_again", fused)):
        r[f"{label}_device_ms"] = device_ms(fn)[0]
        r[f"{label}_ms"] = median_ms(fn)
    return r


def kernel_phase(name, kernel, plain, calls, path):
    err, bound_ms, by_ops = 0.0, 0.0, {"bytes": 0.0, "operations": 0.0}
    step_bound_ms = None   # K13's, K14's: the sum of their one-step bounds
    ref_max = 0.0
    for i, (args, kwargs) in enumerate(calls):
        got = kernel(*args, **kwargs)
        ref = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = max(err, compare(name, args, got, ref))
        if name == "windowed_gather_bwd":
            check_gather_bwd(kernel, args, kwargs, got, path)
        if name in ("crf_iterate_bwd", "discrete_iterate_bwd"):
            check_reverse(name, kernel, plain, i, args, kwargs, got, path)
        ref_max = max([ref_max] + [
            float(r.abs().max()) for r in (ref if isinstance(ref, tuple)
                                           else (ref,))
            if isinstance(r, torch.Tensor) and r.is_floating_point()
            and r.numel()
        ])
        b_ms, b_by = bound_of(name, args, got, kwargs)
        bound_ms += b_ms
        by_ops[b_by] += b_ms
        if name in ("discrete_iterate", "discrete_iterate_bwd"):
            step_bound_ms = (step_bound_ms or 0.0) + step_bound_of(name, args,
                                                                    got)
    of_bound = OF_BOUND.pop(name, None)

    def run_kernel():
        for a, k in calls:
            kernel(*a, **k)

    ms = median_ms(run_kernel)
    kernel_device_ms, device_kernels = device_ms(run_kernel)
    functions = kernel_functions(name)
    profiled = check_profiled_launches(f"{name} ({path})", device_kernels,
                                       functions, len(calls))
    kernel_host_us = host_us(run_kernel, len(calls))
    plain_ms = median_ms(lambda: [plain(*a, **k) for a, k in calls])
    libs = [library_call(name, a) for a, _ in calls]
    library_ms = library_device_ms = None
    if all(libs):
        library_ms = median_ms(lambda: [f() for f in libs])
        library_device_ms = device_ms(lambda: [f() for f in libs])[0]
    split = host_split_us(kernel, calls) if name == "windowed_gather" else None
    plans = (plan_ms(name, calls) if name in ("crf_iterate_bwd",
                                              "discrete_iterate_bwd")
             else None)
    widths = per_width(name, kernel, calls) if name in WIDTHS else None
    barrier = (steps_vs_launches(name, calls)
               if (name, path) in (("crf_iterate", "scannet serve"),
                                   ("discrete_iterate", "discrete serve"),
                                   ("discrete_iterate_bwd", "discrete train"))
               else None)
    return {
        "name": name,
        "route": "cuda",
        "source": f"crfconv_tpu_torch/csrc/{kernel_source(name)}",
        "replaces": REPLACES[name],
        "launches": None,
        "max_abs_err": err,
        "max_abs_ref": ref_max,
        "ms": ms,
        "device_ms": kernel_device_ms,
        "device_kernels": [(k[:60], t, n) for k, t, n in device_kernels],
        "profiled_launches": profiled,
        "host_us": kernel_host_us,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": max(by_ops, key=by_ops.get),
        "step_bound_ms": step_bound_ms,
        "library_ms": library_ms,
        "library_device_ms": library_device_ms,
        "calls": len(calls),
        "of_bound": of_bound,
        "host_split_us": split,
        "plan": plans,
        "widths": widths,
        "steps_vs_launches": barrier,
    }


def kernel_source(name):
    from crfconv_tpu_torch import cuda_build

    return {k.name: k.source for k in cuda_build.KERNELS}[name]


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def randomize_batch_norms(model, gen: torch.Generator):
    """Non-trivial batch-norm statistics and affine terms, from ``gen``."""
    from crfconv_tpu_torch.models.common import MaskedBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                f = m.mean.numel()
                m.mean.copy_(0.1 * torch.randn(f, generator=gen))
                m.var.copy_(0.5 + torch.rand(f, generator=gen))
                m.scale.copy_(0.8 + 0.4 * torch.rand(f, generator=gen))
                m.bias.copy_(0.1 * torch.randn(f, generator=gen))
    return model.eval()


def make_model(device):
    from crfconv_tpu_torch import PointConvResNet

    gen = torch.Generator().manual_seed(SEED)
    model = PointConvResNet(
        N_CLASSES, C_IN, use_crf=True, steps=1, device=device, generator=gen,
    )
    return randomize_batch_norms(model, gen)


def request(rng, device):
    pos = torch.as_tensor(rng.random((B, N, 3), dtype=np.float32), device=device)
    feats = torch.as_tensor(rng.random((B, N, C_IN), dtype=np.float32),
                            device=device)
    return pos, feats


def profile_device(fn, path=None):
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    sorted by time; the chrome trace goes to ``path`` if one is given. A
    first call runs as the profiler's warm-up step and is not recorded,
    and each call starts 50 ms into its step: without them the tracer
    missed device work that started at once (the first of a phase's
    calls, on the H100), and a pause after the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    rows = []

    def ready(p):
        for e in p.key_averages():   # device-side events only: the kernels,
            # copies and fills, not the ranges that annotate them on the
            # device (Optimizer.step#SGD.step)
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and not getattr(e, "is_user_annotation", False)):
                rows.append((e.key, e.self_device_time_total / 1e3, e.count))
        if path is not None:
            p.export_chrome_trace(path)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as p:
        for _ in range(2):
            time.sleep(0.05)   # the device work lies well inside the window
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            p.step()
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_phase(label: str, fn, path: str, unit: str, unit_ms: float):
    """Profile one call of ``fn`` (one ``unit`` of ``unit_ms``): prints the
    device's busy time, idle share and top kernels; returns (rows, busy
    ms). A pass that records no device time fails the run."""
    rows = profile_device(fn, path)
    expect(bool(rows), f"{label}: no device time recorded")
    busy = sum(r[1] for r in rows)
    print(f"# {label}: {sum(r[2] for r in rows)} kernel launches, busy "
          f"{busy:.3f} ms in one {unit} of {unit_ms:.3f} ms (idle share "
          f"{1 - busy / unit_ms:.3f}); top:", flush=True)
    for key, ms, cnt in rows[:12]:
        print(f"#   {ms:9.4f} ms  x{cnt:<4d} {key[:90]}", flush=True)
    return rows, busy


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------


def make_train_state(device, seed: int = SEED):
    """A fresh TrainState of the full-width flagship, weights from ``seed``."""
    from crfconv_tpu_torch import PointConvResNet, TrainState

    model = PointConvResNet(
        N_CLASSES, C_IN, use_crf=True, steps=1, dropout_rate=DROPOUT,
        device=device, generator=torch.Generator().manual_seed(seed),
    )
    return TrainState.create(model, lr=LR)


def train_batch(rng, device):
    from crfconv_tpu_torch import RawBatch

    pos, feats = request(rng, device)
    y = torch.as_tensor(rng.integers(0, N_CLASSES, (B, N)), device=device)
    return RawBatch(pos=pos, x=feats, y=y)


def step_generator(device, i: int) -> torch.Generator:
    """The generator of step ``i``: its pyramid offsets, then dropout."""
    return torch.Generator(device=device).manual_seed(SEED + 1 + i)


def snapshot(model) -> dict:
    """Copies of every parameter and buffer, by name."""
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def step_phases_ms(state, raw, gen, label_offset: int = 0, mode=None,
                   build=None):
    """One train step in make_train_step's order, with a synchronize after
    each phase: host ms of (pyramid, forward + loss, backward, optimizer).
    The confusion matrix, a few small kernels, is left out. With ``mode``
    (a built pyramid's regime) ``raw`` is that PointBatch and the pyramid
    phase is empty, unless ``build(raw, gen)`` builds it there."""
    from crfconv_tpu_torch.train.losses import segmentation_loss
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    torch.cuda.synchronize()
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    state.model.train()
    if mode is None:
        mode = TRAIN_MODE
        batch = build_windowed_batch(raw, gen, mode=TRAIN_MODE)
    else:
        batch = raw if build is None else build(raw, gen)
    mark()
    out = state.model(batch, mode, dropout_generator=gen)
    loss = segmentation_loss(out, batch.y - label_offset)
    mark()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mark()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    mark()
    return np.diff(marks) * 1e3


def grad_gap(model_a, model_b):
    """The worst gradient of two models as a fraction of its tolerance:
    1e-4 of its tensor's largest magnitude, plus a floor of 1e-6 of the
    model's largest for the gradients that are zero but for rounding (the
    batch-norm bias of each deconv's unary_nn_1 and pairwise_nn_1: the
    row-stochastic CRF message and the next batch norm remove a constant
    shift of the first, the similarity sees only differences of the
    second). Returns (fraction, its parameter's name, largest |grad|)."""
    grads = [(n, p.grad, q.grad) for (n, p), q in
             zip(model_a.named_parameters(), model_b.parameters())]
    g_max = max(float(r.abs().max()) for _, _, r in grads)
    worst, name = 0.0, None
    for n, g, r in grads:
        frac = float((g - r).abs().max()) / (
            1e-4 * float(r.abs().max()) + 1e-6 * g_max)
        if frac > worst:
            worst, name = frac, n
    return worst, name, g_max


def run_phases(results: dict, path: str, sites, calls) -> None:
    """Kernel phases on one main path's recorded calls: every kernel of
    ``sites`` that the path called is held against its plain version and
    timed; the phase joins the kernel's list in ``results``."""
    for name, (_, _, kernel, plain) in sites.items():
        if not calls[name]:
            continue
        with torch.inference_mode():
            r = kernel_phase(name, kernel, plain, calls[name], path)
        r["path"] = path
        results.setdefault(name, []).append(r)
        print_phase(r)


def print_phase(r) -> None:
    print(f"# {r['name']} ({r['path']}; {CARD}): {r['calls']} calls "
          f"({r['profiled_launches']:g} launches a run profiled), kernel "
          f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, host "
          f"{r['host_us']:.1f} us a call), "
          f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us "
          f"({r['bound_by']}), library {r['library_ms']} (device "
          f"{r['library_device_ms']}), max_abs_err "
          f"{r['max_abs_err']:.3g} (max |plain| {r['max_abs_ref']:.3g})"
          + ("" if r["of_bound"] is None else
             f", of rounding bound: kernel {r['of_bound'][0]:.7g}"
             + ("" if r["of_bound"][1] is None else
                f", plain {r['of_bound'][1]:.7g}"))
          + ("" if r["host_split_us"] is None else
             f", host us a call {r['host_split_us']}")
          + ("" if r["plan"] is None else
             f", plans built {r['plan']}"), flush=True)
    for w in r.get("widths") or ():
        print(f"#   {r['name']} {w['group']} ({w['rows']} rows, {w['calls']} "
              f"calls): device "
              + (f"{w['device_ms'] * 1e3:.1f} us" if w["device_ms"] else
                 "not measured")
              + f", events "
              f"{w['ms'] * 1e3:.1f} us, host {w['host_us']:.1f} us a call, "
              f"bound {w['bound_ms'] * 1e3:.2f} us ("
              + ("n/a" if w["of_bound"] is None else f"{w['of_bound']:.1f}x")
              + ")" + ("" if "step_bound_ms" not in w else
                       f", {w['steps']} steps' one-step bounds "
                       f"{w['step_bound_ms'] * 1e3:.2f} us"), flush=True)
    if r.get("step_bound_ms"):
        print(f"#   {r['name']} the steps' one-step bounds sum to "
              f"{r['step_bound_ms'] * 1e3:.2f} us", flush=True)
    if r.get("steps_vs_launches"):
        print(f"#   {r['name']} steps in one launch vs one launch a step: "
              f"{r['steps_vs_launches']}", flush=True)


def leaky_backward_ab(step, rows) -> dict:
    """The flagship step with the leaky-ReLU backward kernel (profiled
    ``rows``) against the same step with torch's own leaky-ReLU backward
    (which takes the slope as the gradient at 0): step ms (events, median
    of 3) in turns kernel, torch, torch, kernel, and profiler launches."""
    import torch.nn.functional as F
    from crfconv_tpu_torch.models import common

    def torch_leaky(x, slope):
        return F.leaky_relu(x, negative_slope=slope)

    ms = {"kernel": [], "torch": []}
    for arm in ("kernel", "torch", "torch", "kernel"):
        pairs = [(common, "leaky_relu", torch_leaky)] if arm == "torch" else []
        with patched(pairs):
            ms[arm].append(median_ms(step, runs=3, warmup=1))
    with patched([(common, "leaky_relu", torch_leaky)]):
        torch_rows = profile_device(step)
    out = {"kernel": {"step_ms": ms["kernel"],
                      "launches": sum(r[2] for r in rows)},
           "torch": {"step_ms": ms["torch"],
                     "launches": sum(r[2] for r in torch_rows)}}
    print(f"# flagship step, leaky-ReLU backward kernel vs torch's: {out}",
          flush=True)
    return out


def train_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 6-9: adds the train step's kernel phases to ``results`` and
    each kernel's launches in the train main path; returns the train
    measurements."""
    from crfconv_tpu_torch import (
        CheckpointManager, cuda_build, make_eval_step, make_train_step,
    )
    from crfconv_tpu_torch.models import point_conv_big
    from crfconv_tpu_torch.ops import neighbors, windowed
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    train_step = make_train_step(TRAIN_MODE)
    state = make_train_state(dev)
    raws = [train_batch(rng, dev) for _ in range(TRAIN_STEPS)]

    # 6. warm-up step, recording every kernel call of a train step
    sites = train_call_sites()
    calls = record_calls(
        sites, lambda: train_step(state, raws[0], step_generator(dev, 0))
    )
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = EXPECTED_PER_STEP[name]
        expect(len(got) == per,
               f"train {name}: {len(got)} calls per step, expected {per}")
    run_phases(results, "flagship train", sites, calls)
    del calls

    # 7. main path: TRAIN_STEPS steps
    params = dict(state.model.named_parameters())
    before = snapshot(state.model)
    gens = [step_generator(dev, 1 + i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    step_s, losses = [], []
    for i, raw in enumerate(raws):
        t0 = time.perf_counter()
        m = train_step(state, raw, gens[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        expect(np.isfinite(losses[-1]), f"train step {i}: loss {losses[-1]}")
        bad = [n for n, p in params.items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.any())]
        expect(not bad, f"train step {i}: no, non-finite or all-zero "
               f"gradient {bad[:4]}")
        expect(tuple(m["confusion"].shape) == (N_CLASSES, N_CLASSES)
               and int(m["confusion"].sum()) == B * N,
               f"train step {i}: confusion matrix does not count {B * N}")
    record_launches("flagship train", cuda_build.launch_counts(),
                    EXPECTED_PER_STEP, TRAIN_STEPS, "steps")
    after = snapshot(state.model)
    still = [n for n in params if torch.equal(before[n], after[n])]
    expect(not still, f"parameters that did not move: {still[:4]}")
    stats = [n for n in before if n not in params]
    same = [n for n in stats if torch.equal(before[n], after[n])]
    expect(stats and not same, f"running statistics unchanged: {same[:4]}")
    pts_s = TRAIN_STEPS * B * N / sum(step_s)
    print(f"# trained {TRAIN_STEPS} steps of {B}x{N}: "
          f"{[round(t * 1e3, 3) for t in step_s]} ms, {pts_s:.1f} points/s, "
          f"loss {[round(v, 5) for v in losses]}", flush=True)

    gen = step_generator(dev, 50)
    step_ms = median_ms(lambda: train_step(state, raws[0], gen), runs=5,
                        warmup=1)
    split = np.median(
        [step_phases_ms(state, raws[0], gen) for _ in range(5)], axis=0
    )
    print(f"# one train step: {step_ms:.3f} ms (events, median of 5); "
          f"phases pyramid {split[0]:.3f}, forward+loss {split[1]:.3f}, "
          f"backward {split[2]:.3f}, optimizer {split[3]:.3f} ms (host "
          f"clock with a synchronize after each, median of 5)", flush=True)
    profile_rows, busy_ms = profile_phase(
        "train profiler", lambda: train_step(state, raws[0], gen),
        os.path.join(out_dir, "chip_smoke_train_trace.json"), "step", step_ms,
    )
    leaky_vs_torch = leaky_backward_ab(
        lambda: train_step(state, raws[0], gen), profile_rows)

    # 8. one state, one pyramid, one dropout seed: kernels vs plain
    # versions, and a second kernel step for K8's run-to-run spread. The
    # plain step replaces the autograd Functions (K1/K8, K7/K8) at their
    # call sites by the plain versions, so autograd differentiates those
    # directly: a gradient the Functions dropped or mis-routed shows here
    batch = build_windowed_batch(raws[0], step_generator(dev, 100),
                                 mode=TRAIN_MODE)
    pb_step = make_train_step(TRAIN_MODE, windowed=False)
    sk, sk2, sp = (make_train_state(dev) for _ in range(3))
    cuda_build.reset_launch_counts()
    mk = pb_step(sk, batch, step_generator(dev, 101))
    k_counts = cuda_build.launch_counts()
    pb_step(sk2, batch, step_generator(dev, 101))
    plain_pairs = [
        (neighbors, "windowed_gather", windowed.windowed_gather_plain),
        (point_conv_big, "weighted_gather_reduce",
         lambda *a: windowed.windowed_weighted_reduce_plain(*a)[0]),
        leaky_plain_pair(),
    ]
    cuda_build.reset_launch_counts()
    with patched(plain_pairs):
        mp = pb_step(sp, batch, step_generator(dev, 101))
    p_counts = cuda_build.launch_counts()
    torch.cuda.synchronize()
    for name in ("windowed_gather", "windowed_weighted_reduce",
                 "windowed_gather_bwd", "leaky_relu_bwd"):
        expect(k_counts[name] == EXPECTED_PER_STEP[name],
               f"kernel step: {k_counts[name]} launches of {name}")
    expect(not any(p_counts.values()), f"plain step launched {p_counts}")
    # K1 and K7 are bit-equal to their plain versions, so the forward and
    # the loss are too. The backward differs only by the order of K8's and
    # autograd's f32 atomics (~1e-7 relative per call; the backward makes
    # no discrete choices that could amplify it)
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    expect(loss_k == loss_p, f"kernel vs plain step: loss {loss_k} vs {loss_p}")
    d_grad, worst, g_max = grad_gap(sk.model, sp.model)
    expect(d_grad <= 1.0, f"kernel vs plain step: gradient of {worst} at "
           f"{d_grad:.3g} of its tolerance")
    d_rerun, worst_rerun, _ = grad_gap(sk.model, sk2.model)
    expect(d_rerun <= 1.0, f"kernel step rerun: gradient of {worst_rerun} "
           f"at {d_rerun:.3g} of its tolerance")
    rerun_bit_equal = all(
        torch.equal(p.grad, q.grad)
        for p, q in zip(sk.model.parameters(), sk2.model.parameters())
    )
    a, b = snapshot(sk.model), snapshot(sp.model)
    off = []
    for n in b:   # the bounds of the JAX package's own train-step test
        atol = 5e-5 if n in params else 1e-5
        if not torch.allclose(a[n], b[n], rtol=1e-3, atol=atol):
            off.append(n)
    expect(not off, f"kernel vs plain step: outside rtol 1e-3 {off[:4]}")
    with patched(plain_pairs):
        plain_step_ms = median_ms(lambda: pb_step(sp, batch, gen), runs=3,
                                  warmup=1)
    kernel_step_ms = median_ms(lambda: pb_step(sk, batch, gen), runs=3,
                               warmup=1)
    print(f"# train step kernels vs plain (one pyramid): loss {loss_k} vs "
          f"{loss_p}, worst gradient {worst} at {d_grad:.3g} of its "
          f"tolerance (largest |grad| {g_max:.3g}); kernel step rerun: "
          f"gradients bit-equal {rerun_bit_equal}, worst {worst_rerun} at "
          f"{d_rerun:.3g}; step on a built pyramid {kernel_step_ms:.3f} ms, "
          f"plain versions {plain_step_ms:.3f} ms", flush=True)
    # K8 adds without atomics: two steps are bit-identical
    expect(rerun_bit_equal, "kernel step rerun: gradients not bit-identical")

    # 9. eval step, checkpoint round trip
    eval_step = make_eval_step(TRAIN_MODE)
    e1 = eval_step(state, raws[0], step_generator(dev, 200))
    ckpt_dir = os.path.join(out_dir, "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(state, state.step)
    fresh = mgr.restore(make_train_state(dev, seed=SEED + 1))
    e2 = eval_step(fresh, raws[0], step_generator(dev, 200))
    torch.cuda.synchronize()
    shutil.rmtree(ckpt_dir)
    expect(tuple(e1["probs"].shape) == (B, N, N_CLASSES)
           and bool(torch.isfinite(e1["probs"]).all()),
           "eval probabilities not finite or of the wrong shape")
    expect(fresh.step == state.step, f"restored step {fresh.step}")
    expect(torch.equal(e1["probs"], e2["probs"])
           and torch.equal(e1["preds"], e2["preds"]),
           "eval after the checkpoint round trip differs")
    print(f"# eval step and checkpoint round trip: loss "
          f"{float(e1['loss']):.5f} before, {float(e2['loss']):.5f} after",
          flush=True)
    return {
        "train_steps_ms": [t * 1e3 for t in step_s],
        "train_points_per_s": pts_s,
        "train_losses": losses,
        "train_step_ms": step_ms,
        "train_phases_ms": dict(zip(
            ("pyramid", "forward_loss", "backward", "optimizer"),
            map(float, split),
        )),
        "train_kernel_busy_ms": busy_ms,
        "train_profile": profile_rows[:40],
        "leaky_relu_backward": leaky_vs_torch,
        "kernel_vs_plain_step": {
            "loss": [loss_k, loss_p], "grad_of_tolerance": d_grad,
            "grad_worst": worst, "grad_max": g_max,
            "rerun_grad_of_tolerance": d_rerun,
            "rerun_grads_bit_equal": rerun_bit_equal,
            "kernel_step_ms": kernel_step_ms, "plain_step_ms": plain_step_ms,
        },
        "train_calls_per_step": EXPECTED_PER_STEP,
    }


# --------------------------------------------------------------------------
# ScanNet: CRFSegNet(steps=10), the continuous CRF's fused core
# --------------------------------------------------------------------------


def small_train_path(label, state, raws, train_step, dev, cfg, expected,
                     out_dir, mode=None, build=None):
    """The train main path of a net at ``cfg``'s settings: TRAIN_STEPS
    steps with their checks (a finite loss, every gradient finite and
    nonzero, the confusion matrix counting the labelled points, exact
    launch counts per step, every parameter and running statistic moved),
    then one step's time, its phase split (``mode`` and ``build`` as in
    :func:`step_phases_ms`) and a profile. Returns the parameters (with the
    gradients of the last step taken) and the measurements."""
    from crfconv_tpu_torch import cuda_build

    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    params = dict(state.model.named_parameters())
    before = snapshot(state.model)
    gens = [step_generator(dev, 1 + i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    step_s, losses = [], []
    for i, raw in enumerate(raws):
        t0 = time.perf_counter()
        m = train_step(state, raw, gens[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        expect(np.isfinite(losses[-1]), f"{label} step {i}: loss {losses[-1]}")
        bad = [nm for nm, p in params.items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.any())]
        expect(not bad, f"{label} step {i}: no, non-finite or all-zero "
               f"gradient {bad[:4]}")
        labelled = int((raw.y >= cfg.label_offset).sum())
        expect(tuple(m["confusion"].shape) == (n_cls, n_cls)
               and int(m["confusion"].sum()) == labelled,
               f"{label} step {i}: confusion matrix does not count the "
               f"{labelled} labelled points")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    record_launches(f"{label} train", cuda_build.launch_counts(), expected,
                    TRAIN_STEPS, "steps")
    after = snapshot(state.model)
    still = [nm for nm in params if torch.equal(before[nm], after[nm])]
    expect(not still, f"{label} parameters that did not move: {still[:4]}")
    stats = [nm for nm in before if nm not in params]
    same = [nm for nm in stats if torch.equal(before[nm], after[nm])]
    expect(stats and not same,
           f"{label} running statistics unchanged: {same[:4]}")
    pts_s = TRAIN_STEPS * b * n / sum(step_s)
    print(f"# {label}: trained {TRAIN_STEPS} steps of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in step_s]} ms, {pts_s:.1f} points/s, "
          f"loss {[round(v, 5) for v in losses]}, peak memory "
          f"{peak_gb:.2f} GiB", flush=True)

    gen_t = step_generator(dev, 50)
    step_ms = median_ms(lambda: train_step(state, raws[0], gen_t), runs=3,
                        warmup=1)
    split = np.median([step_phases_ms(state, raws[0], gen_t, cfg.label_offset,
                                      mode, build) for _ in range(3)], axis=0)
    print(f"# {label} one train step: {step_ms:.3f} ms (events, median of "
          f"3); phases pyramid {split[0]:.3f}, forward+loss {split[1]:.3f}, "
          f"backward {split[2]:.3f}, optimizer {split[3]:.3f} ms", flush=True)
    profile, busy = profile_phase(
        f"{label} train profiler", lambda: train_step(state, raws[0], gen_t),
        os.path.join(out_dir, f"chip_smoke_{label}_train_trace.json"), "step",
        step_ms,
    )
    return params, {
        "train_steps_ms": [t * 1e3 for t in step_s],
        "train_points_per_s": pts_s,
        "train_losses": losses,
        "train_step_ms": step_ms,
        "train_phases_ms": dict(zip(
            ("pyramid", "forward_loss", "backward", "optimizer"),
            map(float, split),
        )),
        "train_peak_gib": peak_gb,
        "train_kernel_busy_ms": busy,
        "train_profile": profile[:40],
    }


def small_kernel_vs_plain_step(label, make_state, raw, dev, cfg, plain_pairs,
                               expected, plain_launches, loss_rtol,
                               dropout: bool = False):
    """From one state and one pyramid: a train step through the kernels, a
    second one for the run-to-run spread, and one with
    ``plain_pairs`` patched in, differentiated by autograd (with
    ``dropout``, each from a generator of one seed). Launch counts
    (``expected`` for the kernel step, ``plain_launches`` for the plain
    one), the losses within ``loss_rtol``, every gradient within its
    tolerance (:func:`grad_gap`), parameters rtol 1e-3 atol 5e-5 and
    running statistics rtol 1e-3 atol 1e-5. Returns the measurements."""
    from crfconv_tpu_torch import cuda_build, make_train_step
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    batch = build_windowed_batch(raw, step_generator(dev, 100),
                                 mode=TRAIN_MODE)
    step = make_train_step(TRAIN_MODE, ignore_index=cfg.ignore_index,
                           label_offset=cfg.label_offset, windowed=False)

    def pb_step(state, batch):
        return step(state, batch,
                    step_generator(dev, 101) if dropout else None)

    sk, sk2, sp = (make_state() for _ in range(3))
    cuda_build.reset_launch_counts()
    mk = pb_step(sk, batch)
    k_counts = cuda_build.launch_counts()
    pb_step(sk2, batch)
    cuda_build.reset_launch_counts()
    with patched(plain_pairs):
        mp = pb_step(sp, batch)
    p_counts = cuda_build.launch_counts()
    torch.cuda.synchronize()
    for name, per in expected.items():
        expect(k_counts[name] == per, f"{label} kernel step: "
               f"{k_counts[name]} launches of {name}, expected {per}")
    expect(all(c == plain_launches.get(nm, 0) for nm, c in p_counts.items()),
           f"{label} plain step launched {p_counts}")
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    expect(abs(loss_k - loss_p) <= loss_rtol * abs(loss_p),
           f"{label} kernel vs plain step: loss {loss_k} vs {loss_p}")
    d_grad, worst, g_max = grad_gap(sk.model, sp.model)
    expect(d_grad <= 1.0, f"{label} kernel vs plain step: gradient of "
           f"{worst} at {d_grad:.3g} of its tolerance")
    d_rerun, worst_rerun, _ = grad_gap(sk.model, sk2.model)
    expect(d_rerun <= 1.0, f"{label} kernel step rerun: gradient of "
           f"{worst_rerun} at {d_rerun:.3g} of its tolerance")
    rerun_differs = [
        nm for (nm, p), q in zip(sk.model.named_parameters(),
                                 sk2.model.parameters())
        if not torch.equal(p.grad, q.grad)]
    rerun_bit_equal = not rerun_differs
    # K8, K11, K12 and K14 add without atomics: two steps are bit-identical
    expect(rerun_bit_equal, f"{label} kernel step rerun: gradients of "
           f"{rerun_differs[:6]} not bit-identical")
    a_sd, b_sd = snapshot(sk.model), snapshot(sp.model)
    pnames = {nm for nm, _ in sk.model.named_parameters()}
    off = [nm for nm in b_sd if not torch.allclose(
        a_sd[nm], b_sd[nm], rtol=1e-3, atol=5e-5 if nm in pnames else 1e-5)]
    expect(not off, f"{label} kernel vs plain step: outside rtol 1e-3 "
           f"{off[:4]}")
    del sk2
    kernel_step_ms = median_ms(lambda: pb_step(sk, batch), runs=3, warmup=1)
    with patched(plain_pairs):
        plain_step_ms = median_ms(lambda: pb_step(sp, batch), runs=3,
                                  warmup=1)
    print(f"# {label} train step kernels vs plain (one pyramid): loss "
          f"{loss_k} vs {loss_p}, worst gradient {worst} at {d_grad:.3g} of "
          f"its tolerance (largest |grad| {g_max:.3g}); kernel step rerun: "
          f"gradients bit-equal {rerun_bit_equal} ({len(rerun_differs)} "
          f"differ: {rerun_differs[:6]}), worst {worst_rerun} at "
          f"{d_rerun:.3g}; step on a built pyramid {kernel_step_ms:.3f} ms, "
          f"plain versions {plain_step_ms:.3f} ms", flush=True)
    return {
        "loss": [loss_k, loss_p], "grad_of_tolerance": d_grad,
        "grad_worst": worst, "grad_max": g_max,
        "rerun_grad_of_tolerance": d_rerun,
        "rerun_grads_bit_equal": rerun_bit_equal,
        "rerun_grads_differ": rerun_differs,
        "kernel_step_ms": kernel_step_ms, "plain_step_ms": plain_step_ms,
    }


def scannet_config():
    from crfconv_tpu_torch.train.config import ScanNetConfig

    return ScanNetConfig()


def scannet_model(cfg, device, seed: int = SEED):
    from crfconv_tpu_torch import CRFSegNet

    return CRFSegNet(cfg.num_classes, cfg.in_channels, steps=cfg.steps,
                     device=device,
                     generator=torch.Generator().manual_seed(seed))


def scannet_state(cfg, device, seed: int = SEED):
    """A fresh TrainState with ScanNet's optimizer settings."""
    from crfconv_tpu_torch import TrainState

    return TrainState.create(
        scannet_model(cfg, device, seed), lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, gamma=cfg.gamma,
    )


def scannet_cloud(cfg, rng, device, labels: bool = False):
    """A batch of B16 x 8192 random clouds; with ``labels``, a RawBatch
    whose labels are 0 (unlabeled, ignored after the offset) to 20."""
    from crfconv_tpu_torch import RawBatch

    b, n = cfg.batch_size, cfg.sample_num
    pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32),
                          device=device)
    feats = torch.as_tensor(
        rng.random((b, n, cfg.in_channels), dtype=np.float32), device=device)
    if not labels:
        return pos, feats
    y = torch.as_tensor(rng.integers(0, cfg.num_classes + 1, (b, n)),
                        device=device)
    return RawBatch(pos=pos, x=feats, y=y)


def _k10(z, zp, s, col, M, steps, with_xs=False):
    """K10 as a phase replays it: (x_steps, the saved stack or None)."""
    from crfconv_tpu_torch.ops import crf_core

    xs = z.new_empty((steps,) + tuple(z.shape)) if with_xs else None
    return crf_core.crf_iterate_steps(z, zp, s, col, M, steps, xs=xs), xs


def _k10_plain(z, zp, s, col, M, steps, with_xs=False):
    from crfconv_tpu_torch.ops import crf_core

    xs = z.new_empty((steps,) + tuple(z.shape)) if with_xs else None
    return crf_core.crf_iterate_steps_plain(z, zp, s, col, M, steps, xs), xs


def crf_call_sites():
    """As :func:`call_sites`, for the CRF core's kernels, reached from its
    autograd Function (K10 through ``crf_iterate_steps``, one call a
    core)."""
    from crfconv_tpu_torch.ops import crf_core

    sites = {
        name: (crf_core, name, getattr(crf_core, name),
               getattr(crf_core, name + "_plain"))
        for name in ("crf_operator", "crf_iterate_bwd", "crf_neighbor_dot")
    }
    sites["crf_iterate"] = (crf_core, "crf_iterate_steps", _k10, _k10_plain)
    return sites


def scannet_plain_pairs():
    """The ScanNet model's kernels replaced by their plain versions at their
    call sites: K1 (so K8 becomes autograd's) and the whole fused CRF core
    (so K9-K12 become autograd through the plain K9/K10)."""
    from crfconv_tpu_torch.ops import crf, crf_core, neighbors, windowed

    return [(neighbors, "windowed_gather", windowed.windowed_gather_plain),
            (crf, "crf_core", crf_core.crf_core_plain), leaky_plain_pair()]


def scannet_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 10-13: ScanNet's CRFSegNet (:func:`crf_net_phases`)."""
    cfg = scannet_config()
    model = scannet_model(cfg, dev)
    out, _ = crf_net_phases(
        "scannet", model, SEED + 7, lambda: scannet_state(cfg, dev),
        lambda: (*scannet_cloud(cfg, rng, dev), {}),
        lambda: scannet_cloud(cfg, rng, dev, labels=True), cfg, cfg, dev,
        out_dir, results)
    return out


def crf_net_phases(label, model, seed, make_state, request, raw_batch, cfg,
                   tcfg, dev, out_dir: str, results: dict, score=None):
    """A small-family net with continuous CRFs at steps >= 2 (ScanNet's
    CRFSegNet, ShapeNet's CRFSegNet_Part), its batch norms and
    compatibilities randomised from ``seed``: a warm-up request and a
    warm-up train step whose kernel calls are held against the plain
    versions, the serving main path (``request()`` gives a request's
    positions, features and Predictor keywords; ``score(logp, keywords)``
    reads each output), a kernel-vs-plain forward, a profile, the train
    main path at ``tcfg``'s batch (``raw_batch()`` gives its labelled
    RawBatches) and the kernel-vs-plain step. Adds the kernel phases to
    ``results``; returns (the measurements, the train batches)."""
    from crfconv_tpu_torch import Predictor, cuda_build, make_train_step
    from crfconv_tpu_torch.serve import SERVING_MODE
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(seed)
    model = randomize_batch_norms(model, gen)
    with torch.no_grad():   # compatibilities away from the identity
        for name, p in model.named_parameters():
            if name.endswith(".c"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(dev))
    predictor = Predictor(model, device=dev, seed=SEED)
    crf_sites = crf_call_sites()

    # warm-up request and warm-up train step, recording every kernel call
    # of each; every kernel held against its plain version on them
    serve_sites = {k: v for k, v in call_sites().items()
                   if k in ("windowed_gather", "window_knn")}
    serve_sites.update((k, crf_sites[k]) for k in ("crf_operator",
                                                   "crf_iterate"))
    pos, feats, kw = request()
    calls = record_calls(serve_sites,
                         lambda: predictor.predict_logits(pos, feats, **kw),
                         snapshot=tuple(crf_sites))
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = SCANNET_PER_REQUEST[name]
        expect(len(got) == per,
               f"{label} {name}: {len(got)} calls per request, expected {per}")
    crf_cores = sorted({(a[0].shape[1], a[0].shape[2], a[2].shape[2])
                        for a, _ in calls["crf_iterate"]})
    run_phases(results, f"{label} serve", serve_sites, calls)
    del calls

    train_step = make_train_step(TRAIN_MODE, ignore_index=tcfg.ignore_index,
                                 label_offset=tcfg.label_offset)
    state = make_state()
    raws = [raw_batch() for _ in range(TRAIN_STEPS)]
    train_sites = {**train_call_sites(), **crf_sites}
    calls = record_calls(
        train_sites, lambda: train_step(state, raws[0], step_generator(dev, 0)),
        snapshot=tuple(crf_sites),
    )
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = SCANNET_CALLS_PER_STEP[name]
        expect(len(got) == per,
               f"{label} {name}: {len(got)} calls per step, expected {per}")
    run_phases(results, f"{label} train", train_sites, calls)
    del calls
    torch.cuda.empty_cache()

    # serving main path
    reqs = [request() for _ in range(SCANNET_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    lat, outs = [], []
    for p_, f_, kw in reqs:
        t0 = time.perf_counter()
        logp = predictor.predict_logits(p_, f_, **kw)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(logp)
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    record_launches(f"{label} serve", cuda_build.launch_counts(),
                    SCANNET_PER_REQUEST, SCANNET_REQUESTS, "requests")
    for logp, (_, _, kw) in zip(outs, reqs):
        expect(tuple(logp.shape) == (b, n, n_cls),
               f"{label} log-probs shape {tuple(logp.shape)}")
        expect(bool(torch.isfinite(logp).all()), f"{label}: non-finite output")
        norm = float((torch.logsumexp(logp, -1)).abs().max())
        expect(norm <= 1e-4, f"{label}: log-probs off normal by {norm}")
        labels = logp.argmax(-1)
        expect(bool(((labels >= 0) & (labels < n_cls)).all()),
               f"{label}: labels outside [0, {n_cls})")
        if score is not None:
            score(logp, kw)
    del outs
    pts_s = SCANNET_REQUESTS * b * n / sum(lat)
    print(f"# {label}: served {SCANNET_REQUESTS} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s; "
          f"peak memory {serve_peak:.2f} GiB; CRF cores on (rows a cloud, "
          f"width, K) {crf_cores}", flush=True)

    p_, f_, kw = reqs[0]

    def pyramid():
        return predictor.prepare(p_, f_, **kw)

    batch, _ = pyramid()
    with torch.inference_mode():
        pyramid_ms = median_ms(pyramid, runs=5)
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=5)
        request_ms = median_ms(lambda: predictor.predict_logits(p_, f_, **kw),
                               runs=5)
        got = model(batch, SERVING_MODE)
        with patched(scannet_plain_pairs()):
            ref = model(batch, SERVING_MODE)
            plain_forward_ms = median_ms(lambda: model(batch, SERVING_MODE),
                                         runs=3, warmup=1)
    torch.cuda.synchronize()
    d_logp = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    fwd_bit_equal = bool(torch.equal(got, ref))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # K1, K9 and K10 (all steps of a core fused into one launch) are
    # bit-equal to their plain versions and the rest of the forward is the
    # same torch code: bit-equal
    expect(fwd_bit_equal,
           f"{label} kernel vs plain forward: max |dlogp| {d_logp}")
    expect(agree >= 0.999, f"{label} argmax agreement {agree}")
    print(f"# {label} forward kernels vs plain: max |dlogp| {d_logp:.3g} "
          f"(max |logp| {scale:.3g}), bit-equal {fwd_bit_equal}, argmax "
          f"agreement {agree}", flush=True)
    print(f"# {label} one request: {request_ms:.3f} ms (pyramid "
          f"{pyramid_ms:.3f} ms, forward {forward_ms:.3f} ms; plain-version "
          f"forward {plain_forward_ms:.3f} ms)", flush=True)
    del got, ref, batch
    with torch.inference_mode():
        serve_profile, serve_busy = profile_phase(
            f"{label} profiler",
            lambda: predictor.predict_logits(p_, f_, **kw),
            os.path.join(out_dir, f"chip_smoke_{label}_trace.json"),
            "request", request_ms,
        )
    del predictor, reqs
    torch.cuda.empty_cache()

    # train main path
    params, train = small_train_path(label, state, raws, train_step, dev,
                                     tcfg, SCANNET_PER_STEP, out_dir)
    c_grads = {nm: float(p.grad.abs().max()) for nm, p in params.items()
               if nm.endswith(".c")}
    expect(len(c_grads) == 4 and all(v > 0 for v in c_grads.values()),
           f"{label}: CRF compatibility gradients {c_grads}")
    del state, params
    torch.cuda.empty_cache()

    # one state, one pyramid: kernels vs plain versions, and a second
    # kernel step for the run-to-run spread; the forward is bit-equal (K1,
    # K9, K10), so the loss is; the backward differs from the plain one by
    # the order of autograd's atomics and K11's and K12's sums
    step_check = small_kernel_vs_plain_step(
        label, make_state, raws[0], dev, tcfg, scannet_plain_pairs(),
        {**SCANNET_PER_STEP, "window_knn": 0}, {}, loss_rtol=0.0,
    )
    return {
        "config": {"model": tcfg.model_name, "batch": b, "points": n,
                   "classes": n_cls, "steps": cfg.steps,
                   "train_batch": tcfg.batch_size,
                   "label_offset": cfg.label_offset},
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogp": d_logp,
        "forward_bit_equal": fwd_bit_equal,
        "argmax_agreement": agree,
        "serve_peak_gib": serve_peak,
        "crf_cores": crf_cores,
        "kernel_busy_ms": serve_busy,
        "profile": serve_profile[:40],
        **train,
        "c_grad_max": c_grads,
        "kernel_vs_plain_step": step_check,
        "calls_per_request": SCANNET_PER_REQUEST,
        "calls_per_step": SCANNET_PER_STEP,
    }, raws


# --------------------------------------------------------------------------
# ScanNet-discrete: BaselineDiscreteCRFSegNet(steps=10), the discrete CRF
# --------------------------------------------------------------------------


def discrete_model(cfg, device, seed: int = SEED):
    from crfconv_tpu_torch import BaselineDiscreteCRFSegNet

    return BaselineDiscreteCRFSegNet(
        cfg.num_classes, cfg.in_channels, steps=cfg.steps, device=device,
        generator=torch.Generator().manual_seed(seed))


def discrete_state(cfg, device, seed: int = SEED):
    """A fresh TrainState of the discrete net with ScanNet's optimizer."""
    from crfconv_tpu_torch import TrainState

    return TrainState.create(
        discrete_model(cfg, device, seed), lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, gamma=cfg.gamma,
    )


def serve_last_head(predictor, pos, feats):
    """A two-head model served as the JAX package serves it: the
    Predictor's pyramid, the forward, the last head (log q), in the input
    order."""
    with torch.inference_mode():
        batch, order = predictor.prepare(pos, feats)
        logq = predictor.model(batch, predictor.mode)[-1]
        return predictor.restore(logq, order)


def _k13(p, u, w, col, C, steps, with_stack=False):
    """K13 as a phase replays it: (q_steps, the q stack or None, the msg
    stack or None)."""
    from crfconv_tpu_torch.ops import discrete_core

    qs = p.new_empty((steps,) + tuple(p.shape)) if with_stack else None
    msgs = torch.empty_like(qs) if with_stack else None
    return (discrete_core.discrete_iterate_steps(p, u, w, col, C, steps,
                                                 qs=qs, msgs=msgs), qs, msgs)


def _k13_plain(p, u, w, col, C, steps, with_stack=False):
    from crfconv_tpu_torch.ops import discrete_core

    qs = p.new_empty((steps,) + tuple(p.shape)) if with_stack else None
    msgs = torch.empty_like(qs) if with_stack else None
    return (discrete_core.discrete_iterate_steps_plain(p, u, w, col, C, steps,
                                                       qs, msgs), qs, msgs)


def discrete_call_sites():
    """As :func:`call_sites`, for the discrete core's kernels, reached from
    its autograd Function (K9 and K12 are the continuous core's; K13 and K14
    through their steps entries, one call a core)."""
    from crfconv_tpu_torch.ops import crf_core, discrete_core

    return {
        "crf_operator": (discrete_core, "crf_operator", crf_core.crf_operator,
                         crf_core.crf_operator_plain),
        "discrete_iterate": (discrete_core, "discrete_iterate_steps", _k13,
                             _k13_plain),
        "discrete_iterate_bwd": (
            discrete_core, "discrete_iterate_bwd_steps",
            discrete_core.discrete_iterate_bwd_steps,
            discrete_core.discrete_iterate_bwd_steps_plain),
        "crf_neighbor_dot": (discrete_core, "crf_neighbor_dot",
                             crf_core.crf_neighbor_dot,
                             crf_core.crf_neighbor_dot_plain),
    }


def discrete_plain_pairs():
    """The discrete net's kernels replaced by their plain versions at their
    call sites: K1 (so K8 becomes autograd's) and the whole discrete core
    (K9, K13, and autograd for K12/K14). K2 (the CRF's kNN) stays: it is
    held against its plain version on its recorded calls, and a last-bit
    distance tie there would move a neighbour, not test the rest."""
    from crfconv_tpu_torch.ops import crf, discrete_core, neighbors, windowed

    return [(neighbors, "windowed_gather", windowed.windowed_gather_plain),
            (crf, "discrete_core", discrete_core.discrete_core_plain),
            leaky_plain_pair()]


def discrete_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 14: adds the ScanNet-discrete request's and step's kernel phases
    to ``results`` and its main paths' launches; returns its
    measurements."""
    from crfconv_tpu_torch import Predictor, cuda_build, make_train_step
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    cfg = scannet_config()
    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(SEED + 11)
    model = randomize_batch_norms(discrete_model(cfg, dev), gen)
    with torch.no_grad():   # compatibilities away from the identity
        model.crf.C.add_(0.1 * torch.randn(model.crf.C.shape,
                                           generator=gen).to(dev))
    predictor = Predictor(model, device=dev, seed=SEED)
    d_sites = discrete_call_sites()

    # warm-up request and train step, recording every kernel call of each
    serve_sites = {k: v for k, v in call_sites().items()
                   if k in ("windowed_gather", "window_knn")}
    serve_sites.update((k, d_sites[k]) for k in ("crf_operator",
                                                 "discrete_iterate"))
    pos, feats = scannet_cloud(cfg, rng, dev)
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(serve_sites,
                         lambda: serve_last_head(predictor, pos, feats),
                         snapshot=tuple(d_sites))
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, got in calls.items():
        per = DISCRETE_PER_REQUEST[name]
        expect(len(got) == per, f"discrete {name}: {len(got)} calls per "
               f"request, expected {per}")
    run_phases(results, "discrete serve", serve_sites, calls)
    del calls
    torch.cuda.empty_cache()

    train_step = make_train_step(TRAIN_MODE, ignore_index=cfg.ignore_index,
                                 label_offset=cfg.label_offset)
    state = discrete_state(cfg, dev)
    raws = [scannet_cloud(cfg, rng, dev, labels=True)
            for _ in range(TRAIN_STEPS)]
    train_sites = {**train_call_sites(), **d_sites}
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(
        train_sites, lambda: train_step(state, raws[0], step_generator(dev, 0)),
        snapshot=tuple(d_sites),
    )
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = DISCRETE_CALLS_PER_STEP[name]
        expect(len(got) == per,
               f"discrete {name}: {len(got)} calls per step, expected {per}")
    run_phases(results, "discrete train", train_sites, calls)
    del calls
    torch.cuda.empty_cache()

    # serving main path
    reqs = [scannet_cloud(cfg, rng, dev) for _ in range(DISCRETE_REQUESTS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat, outs = [], []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        logq = serve_last_head(predictor, p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append(logq)
    record_launches("discrete serve", cuda_build.launch_counts(),
                    DISCRETE_PER_REQUEST, DISCRETE_REQUESTS, "requests")
    for logq in outs:
        expect(tuple(logq.shape) == (b, n, n_cls),
               f"discrete log q shape {tuple(logq.shape)}")
        expect(bool(torch.isfinite(logq).all()), "discrete: non-finite log q")
        # q sums to 1; the 1e-12 floor of log q can add up to L * 1e-12
        norm = float(torch.logsumexp(logq, -1).abs().max())
        expect(norm <= 1e-4, f"discrete: log q off normal by {norm}")
    del outs
    pts_s = DISCRETE_REQUESTS * b * n / sum(lat)
    print(f"# discrete: served {DISCRETE_REQUESTS} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s",
          flush=True)

    from crfconv_tpu_torch.serve import SERVING_MODE

    p_, f_ = reqs[0]
    batch, _ = predictor.prepare(p_, f_)
    with torch.inference_mode():
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=5)
        request_ms = median_ms(lambda: serve_last_head(predictor, p_, f_), runs=5)
        got = model(batch, SERVING_MODE)[-1]
        with patched(discrete_plain_pairs()):
            ref = model(batch, SERVING_MODE)[-1]
            plain_forward_ms = median_ms(lambda: model(batch, SERVING_MODE),
                                         runs=3, warmup=1)
    torch.cuda.synchronize()
    d_logq = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    fwd_bit_equal = bool(torch.equal(got, ref))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # K1, K9 are bit-equal to their plain versions, K13 up to expf's
    # rounding; the rest of the forward is the same torch code
    expect(d_logq <= 1e-5 * max(1.0, scale),
           f"discrete kernel vs plain forward: max |dlogq| {d_logq}")
    expect(agree >= 0.999, f"discrete argmax agreement {agree}")
    print(f"# discrete forward kernels vs plain: max |dlogq| {d_logq:.3g} "
          f"(max |logq| {scale:.3g}), bit-equal {fwd_bit_equal}, argmax "
          f"agreement {agree}", flush=True)
    print(f"# discrete one request: {request_ms:.3f} ms (forward "
          f"{forward_ms:.3f} ms; plain-version forward {plain_forward_ms:.3f}"
          f" ms); peak memory of a request {serve_peak:.2f} GiB", flush=True)
    del got, ref, batch
    with torch.inference_mode():
        serve_profile, serve_busy = profile_phase(
            "discrete profiler", lambda: serve_last_head(predictor, p_, f_),
            os.path.join(out_dir, "chip_smoke_discrete_trace.json"),
            "request", request_ms,
        )
    del reqs, model, predictor
    torch.cuda.empty_cache()

    # train main path
    params, train = small_train_path("discrete", state, raws, train_step,
                                     dev, cfg, DISCRETE_PER_STEP, out_dir)
    crf_grads = {nm: float(params[nm].grad.abs().max())
                 for nm in ("crf.F", "crf.W", "crf.C")}
    print(f"# discrete: CRF gradients {crf_grads}", flush=True)
    del state, params
    torch.cuda.empty_cache()

    # one state, one pyramid: kernels vs plain versions, and a second kernel
    # step for the run-to-run spread. The built pyramid leaves one K2
    # launch, the CRF's kNN(32), in both steps. K13 may round its exp apart
    # from torch's, so the losses may part in the last bits; the backward
    # differs from the plain one by the order of autograd's atomics and
    # K14's sums
    step_check = small_kernel_vs_plain_step(
        "discrete", lambda: discrete_state(cfg, dev), raws[0], dev, cfg,
        discrete_plain_pairs(), {**DISCRETE_PER_STEP, "window_knn": 1},
        {"window_knn": 1}, loss_rtol=1e-6,
    )
    torch.cuda.empty_cache()
    return {
        "config": {"model": "BaselineDiscreteCRFSegNet", "batch": b,
                   "points": n, "classes": n_cls, "steps": cfg.steps,
                   "label_offset": cfg.label_offset},
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogq": d_logq,
        "forward_bit_equal": fwd_bit_equal,
        "argmax_agreement": agree,
        "serve_peak_gib": serve_peak,
        "kernel_busy_ms": serve_busy,
        "profile": serve_profile[:40],
        **train,
        "crf_grad_max": crf_grads,
        "kernel_vs_plain_step": step_check,
        "calls_per_request": DISCRETE_PER_REQUEST,
        "calls_per_step": DISCRETE_PER_STEP,
    }


# --------------------------------------------------------------------------
# Semantic3D serving: the flagship at B16 x 65536, the strided fused conv
# --------------------------------------------------------------------------


def semantic3d_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 15: Semantic3D serving (:func:`flagship_serve_phases`)."""
    from crfconv_tpu_torch.train.config import Semantic3DConfig

    return flagship_serve_phases("semantic3d", Semantic3DConfig(), SEED + 13,
                                 dev, rng, out_dir, results)


def flagship_serve_phases(label, cfg, seed, dev, rng, out_dir: str,
                          results: dict) -> dict:
    """A serving path of the full-width flagship at a large cloud size
    (``cfg``'s batch, points, input channels and classes), weights from
    ``seed``: a recorded warm-up request whose K1-K5 calls are held against
    the plain versions, SEMANTIC3D_REQUESTS requests through the Predictor
    with the launches of SEMANTIC3D_PER_REQUEST each, a kernel-vs-plain
    forward, a profile and peak memory. Adds the kernel phases to
    ``results`` and returns the measurements."""
    from crfconv_tpu_torch import Predictor, PointConvResNet, cuda_build
    from crfconv_tpu_torch.models import point_conv_big
    from crfconv_tpu_torch.ops import conv
    from crfconv_tpu_torch.serve import SERVING_MODE

    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(seed)
    model = randomize_batch_norms(
        PointConvResNet(n_cls, cfg.in_channels, use_crf=True, steps=cfg.steps,
                        device=dev, generator=gen), gen)
    predictor = Predictor(model, device=dev, seed=SEED)

    def cloud():
        pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32),
                              device=dev)
        feats = torch.as_tensor(
            rng.random((b, n, cfg.in_channels), dtype=np.float32),
            device=dev)
        return pos, feats

    sites = {**call_sites(), "point_conv_fused_strided": (
        point_conv_big, "point_conv_fused_strided",
        conv.point_conv_fused_strided, conv.point_conv_fused_strided_plain)}
    pos, feats = cloud()
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(sites, lambda: predictor.predict_logits(pos, feats))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, got in calls.items():
        per = SEMANTIC3D_PER_REQUEST[name]
        expect(len(got) == per, f"{label} {name}: {len(got)} calls per "
               f"request, expected {per}")
    strided_rows = sorted((a[3].shape[1], a[0].shape[2], a[4].shape[2])
                          for a, _ in calls["point_conv_fused_strided"])
    run_phases(results, f"{label} serve", sites, calls)
    del calls
    torch.cuda.empty_cache()

    reqs = [cloud() for _ in range(SEMANTIC3D_REQUESTS)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat = []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        logits = predictor.predict_logits(p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        expect(tuple(logits.shape) == (b, n, n_cls),
               f"{label} logits shape {tuple(logits.shape)}")
        expect(bool(torch.isfinite(logits).all()),
               f"{label}: non-finite logits")
        del logits
    record_launches(f"{label} serve", cuda_build.launch_counts(),
                    SEMANTIC3D_PER_REQUEST, SEMANTIC3D_REQUESTS, "requests")
    pts_s = SEMANTIC3D_REQUESTS * b * n / sum(lat)
    print(f"# {label}: served {SEMANTIC3D_REQUESTS} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s; "
          f"K5 on (rows, hidden, rider) {strided_rows}", flush=True)

    p_, f_ = reqs[0]

    def pyramid():
        return predictor.prepare(p_, f_)

    batch, _ = pyramid()
    with torch.inference_mode():
        pyramid_ms = median_ms(pyramid, runs=5)
        forward_ms = median_ms(lambda: model(batch, SERVING_MODE), runs=5)
        request_ms = median_ms(lambda: predictor.predict_logits(p_, f_),
                               runs=5)
        got = model(batch, SERVING_MODE)
        with patched([(m, a, pl) for m, a, _, pl in sites.values()]):
            ref = model(batch, SERVING_MODE)
            plain_forward_ms = median_ms(lambda: model(batch, SERVING_MODE),
                                         runs=3, warmup=1)
    torch.cuda.synchronize()
    d_logit = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # K3/K4/K5 sum in another order than the plain matmuls (~1e-6 relative
    # per layer), carried through 20 layers: 1e-6 of the largest logit was
    # measured on the H100, so 1e-4 leaves a hundredfold
    expect(d_logit <= 1e-4 * scale,
           f"{label} kernel vs plain forward: max |dlogit| {d_logit}")
    expect(agree >= 0.999, f"{label} argmax agreement {agree}")
    print(f"# {label} forward kernels vs plain: max |dlogit| "
          f"{d_logit:.3g} (max |logit| {scale:.3g}), argmax agreement "
          f"{agree}", flush=True)
    print(f"# {label} one request: {request_ms:.3f} ms (pyramid "
          f"{pyramid_ms:.3f} ms, forward {forward_ms:.3f} ms; plain-version "
          f"forward {plain_forward_ms:.3f} ms); peak memory of a request "
          f"{peak:.2f} GiB", flush=True)
    del got, ref, batch
    with torch.inference_mode():
        profile_rows, busy = profile_phase(
            f"{label} profiler", lambda: predictor.predict_logits(p_, f_),
            os.path.join(out_dir, f"chip_smoke_{label}_trace.json"),
            "request", request_ms,
        )
    del predictor, model, reqs
    torch.cuda.empty_cache()
    return {
        "config": {"model": "PointConvResNet", "batch": b, "points": n,
                   "in_channels": cfg.in_channels, "classes": n_cls,
                   "steps": cfg.steps},
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "plain_forward_ms": plain_forward_ms,
        "max_abs_dlogit": d_logit,
        "argmax_agreement": agree,
        "peak_gib": peak,
        "strided_calls": strided_rows,
        "kernel_busy_ms": busy,
        "profile": profile_rows[:40],
        "calls_per_request": SEMANTIC3D_PER_REQUEST,
    }


# --------------------------------------------------------------------------
# the exact regime: K6 under the device kNN; the windowed 2-view eval
# --------------------------------------------------------------------------


def self_share(scales) -> float:
    """The least share, over the scales, of rows whose column 0 is the row
    itself (a TF32 cross term would move the self-distance off 0)."""
    shares = []
    for s in scales:
        rows = torch.arange(s.neighbor_idx.shape[1], device=s.neighbor_idx.device)
        shares.append(float((s.neighbor_idx[:, :, 0] == rows).float().mean()))
    return min(shares)


def exact_serve_path(label, make_request, serve, n_requests, expected,
                     check_out, out_dir):
    """An exact-regime serving path: a recorded warm-up request whose K6
    calls are held against the plain version, then ``n_requests`` requests
    with exact launch counts, column 0 == self, ``check_out`` on each
    output, request / pyramid / forward times, a kernel-vs-plain forward
    (K6 plain in the forward), a profile and the peak memory. ``serve(pos,
    feats)`` returns (output, scales); ``serve(pos, feats, scales)`` runs
    the forward alone."""
    from crfconv_tpu_torch import cuda_build
    from crfconv_tpu_torch.ops import neighbors, windowed

    # the site through which knn_bruteforce reaches K6
    sites = {"select_min_k": (neighbors, "select_min_k", windowed.select_min_k,
                              windowed.select_min_k_plain)}
    pos, feats = make_request()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = record_calls(sites, lambda: serve(pos, feats))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = len(calls["select_min_k"])
    expect(got == expected["select_min_k"],
           f"{label}: {got} K6 calls per request, expected "
           f"{expected['select_min_k']}")
    results = {}
    PACKED_CHECKED.clear()
    run_phases(results, f"{label} serve", sites, calls)
    packed = sorted(set(PACKED_CHECKED))
    del calls
    torch.cuda.empty_cache()

    reqs = [make_request() for _ in range(n_requests)]
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    lat, outs = [], []
    for p_, f_ in reqs:
        t0 = time.perf_counter()
        out, scales = serve(p_, f_)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        outs.append((out, self_share(scales)))
        del scales
    record_launches(f"{label} serve", cuda_build.launch_counts(),
                    only(expected), n_requests, "requests")
    shares = [sh for _, sh in outs]
    expect(min(shares) >= 0.999, f"{label}: column 0 is self on only "
           f"{min(shares)} of a scale's rows")
    for out, _ in outs:
        check_out(out)
    del outs
    b, n = reqs[0][0].shape[:2]
    pts_s = n_requests * b * n / sum(lat)
    print(f"# {label}: served {n_requests} requests of {b}x{n}: "
          f"{[round(t * 1e3, 3) for t in lat]} ms, {pts_s:.1f} points/s; "
          f"column 0 == self on >= {min(shares)} of every scale's rows; "
          f"peak memory of a request {peak:.2f} GiB", flush=True)

    p_, f_ = reqs[0]
    _, scales = serve(p_, f_)
    with torch.inference_mode():
        pyramid_ms = median_ms(lambda: serve.pyramid(p_), runs=5)
        forward_ms = median_ms(lambda: serve(p_, f_, scales), runs=5)
        request_ms = median_ms(lambda: serve(p_, f_), runs=5)
        got_out = serve(p_, f_, scales)
        with patched([(neighbors, "select_min_k",
                       windowed.select_min_k_plain)]):
            ref_out = serve(p_, f_, scales)
    torch.cuda.synchronize()
    d_out = float((got_out - ref_out).abs().max())
    scale = float(ref_out.abs().max())
    # the forward's only kernel in the exact regime is K6 (the discrete
    # CRF's kNN(32)), bit-equal to its plain version
    expect(d_out <= 1e-5 * max(1.0, scale),
           f"{label} kernel vs plain forward: max |d| {d_out}")
    print(f"# {label} one request: {request_ms:.3f} ms (pyramid "
          f"{pyramid_ms:.3f} ms, forward {forward_ms:.3f} ms); forward "
          f"kernels vs plain max |d| {d_out:.3g} (max |out| {scale:.3g})",
          flush=True)
    del got_out, ref_out, scales
    with torch.inference_mode():
        profile, busy = profile_phase(
            f"{label} profiler", lambda: serve(p_, f_),
            os.path.join(out_dir, f"chip_smoke_{label}_trace.json"),
            "request", request_ms,
        )
    torch.cuda.empty_cache()
    return results, {
        "requests_ms": [t * 1e3 for t in lat],
        "points_per_s": pts_s,
        "request_ms": request_ms,
        "pyramid_ms": pyramid_ms,
        "forward_ms": forward_ms,
        "max_abs_dforward": d_out,
        "self_share_min": min(shares),
        "packed_checked_widths": packed,
        "peak_gib": peak,
        "kernel_busy_ms": busy,
        "profile": profile[:40],
        "calls_per_request": only(expected),
    }


class ExactServer:
    """A request of the exact regime: build_pyramid_device on the card (its
    subsample drawn from a generator seeded with SEED, as the Predictor
    seeds its own), then the forward in NeighborMode("exact"), under
    inference_mode; ``head`` picks the served output."""

    def __init__(self, model, dev, kernel_sizes=None, ratios=None, k_up=1,
                 head=None):
        self.model, self.dev, self.k_up, self.head = model, dev, k_up, head
        self.pyr_kw = {}
        if kernel_sizes is not None:
            self.pyr_kw = {"kernel_sizes": kernel_sizes, "ratios": ratios}

    def pyramid(self, pos):
        from crfconv_tpu_torch import build_pyramid_device

        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        return build_pyramid_device(pos, k_up=self.k_up, generator=gen,
                                    device=self.dev, **self.pyr_kw)

    def __call__(self, pos, feats, scales=None):
        from crfconv_tpu_torch.data.batch import PointBatch

        with torch.inference_mode():
            built = scales is None
            if built:
                scales = self.pyramid(pos)
            out = self.model(PointBatch(x=feats, y=None, scales=scales),
                             EXACT)
            if self.head is not None:
                out = out[self.head]
            return (out, scales) if built else out


def exact_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 16-17: the flagship's exact serving and train step; adds K6's
    phases to ``results``; returns the measurements."""
    from crfconv_tpu_torch import (
        build_pyramid_device, cuda_build, make_eval_step, make_train_step,
    )
    from crfconv_tpu_torch.data.batch import PointBatch

    model = make_model(dev)

    def check_logits(logits):
        expect(tuple(logits.shape) == (B, N, N_CLASSES),
               f"exact logits shape {tuple(logits.shape)}")
        expect(bool(torch.isfinite(logits).all()), "exact: non-finite logits")

    serve = ExactServer(model, dev)
    phases, serving = exact_serve_path(
        "exact", lambda: request(rng, dev), serve, EXACT_REQUESTS,
        EXACT_PER_REQUEST, check_logits, out_dir)
    for name, r in phases.items():
        results.setdefault(name, []).extend(r)
    del model, serve
    torch.cuda.empty_cache()

    # 17. the train step on a pyramid built once, as the reference's exact
    # train bench builds it
    state = make_train_state(dev)
    raw = train_batch(rng, dev)
    scales = build_pyramid_device(
        raw.pos, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    batch = PointBatch(x=raw.x, y=raw.y, scales=scales)
    train_step = make_train_step(EXACT, windowed=False)
    train_step(state, batch, step_generator(dev, 0))     # warm-up
    params = dict(state.model.named_parameters())
    before = snapshot(state.model)
    gens = [step_generator(dev, 1 + i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    step_s, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = train_step(state, batch, gens[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        expect(np.isfinite(losses[-1]), f"exact step {i}: loss {losses[-1]}")
        bad = [nm for nm, p in params.items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.any())]
        expect(not bad, f"exact step {i}: no, non-finite or all-zero "
               f"gradient {bad[:4]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    record_launches("exact train", cuda_build.launch_counts(),
                    only({"leaky_relu_bwd": FLAGSHIP_LEAKY_PER_STEP}),
                    TRAIN_STEPS, "steps")
    after = snapshot(state.model)
    still = [nm for nm in params if torch.equal(before[nm], after[nm])]
    expect(not still, f"exact: parameters that did not move: {still[:4]}")
    pts_s = TRAIN_STEPS * B * N / sum(step_s)
    gen = step_generator(dev, 50)
    step_ms = median_ms(lambda: train_step(state, batch, gen), runs=3,
                        warmup=1)
    split = np.median([step_phases_ms(state, batch, gen, mode=EXACT)
                       for _ in range(3)], axis=0)
    print(f"# exact: trained {TRAIN_STEPS} steps of {B}x{N} on one pyramid: "
          f"{[round(t * 1e3, 3) for t in step_s]} ms, {pts_s:.1f} points/s, "
          f"loss {[round(v, 5) for v in losses]}, peak memory {peak:.2f} GiB;"
          f" one step {step_ms:.3f} ms (events, median of 3), phases "
          f"forward+loss {split[1]:.3f}, backward {split[2]:.3f}, optimizer "
          f"{split[3]:.3f} ms", flush=True)
    profile, busy = profile_phase(
        "exact train profiler", lambda: train_step(state, batch, gen),
        os.path.join(out_dir, "chip_smoke_exact_train_trace.json"), "step",
        step_ms,
    )
    cuda_build.reset_launch_counts()
    ev = make_eval_step(EXACT, windowed=False)(state, batch)
    torch.cuda.synchronize()
    expect(not any(cuda_build.launch_counts().values()),
           f"exact eval launched {cuda_build.launch_counts()}")
    probs = ev["probs"]
    expect(tuple(probs.shape) == (B, N, N_CLASSES)
           and bool(torch.isfinite(probs).all())
           and float((probs.sum(-1) - 1).abs().max()) <= 1e-5,
           "exact eval: probabilities not finite or not normalised")
    print(f"# exact eval step: loss {float(ev['loss']):.5f}", flush=True)
    del state, batch, scales, ev
    torch.cuda.empty_cache()
    return {
        "config": {"model": "PointConvResNet", "batch": B, "points": N,
                   "classes": N_CLASSES, "steps": 1, "mode": "exact"},
        **serving,
        "train_steps_ms": [t * 1e3 for t in step_s],
        "train_points_per_s": pts_s,
        "train_losses": losses,
        "train_step_ms": step_ms,
        "train_phases_ms": dict(zip(
            ("pyramid", "forward_loss", "backward", "optimizer"),
            map(float, split))),
        "train_peak_gib": peak,
        "train_kernel_busy_ms": busy,
        "train_profile": profile[:40],
    }


def two_view_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 18: the windowed 2-view eval of the flagship at B8 x 8192;
    adds K1's phase on the eval's recorded calls to ``results``."""
    from crfconv_tpu_torch import TrainState, cuda_build, make_eval_step
    from crfconv_tpu_torch.models import crf_conv, point_conv_big
    from crfconv_tpu_torch.ops import conv, crf_sim, neighbors, windowed
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    state = TrainState.create(make_model(dev), lr=LR)
    raw = train_batch(rng, dev)
    eval_step = make_eval_step(TRAIN_MODE, eval_views=2)

    def run():
        return eval_step(state, raw, step_generator(dev, 300))

    # warm-up, recording K1's calls of one eval
    sites = {"windowed_gather": call_sites()["windowed_gather"]}
    calls = record_calls(sites, run)
    torch.cuda.synchronize()
    n_k1 = len(calls["windowed_gather"])
    expect(n_k1 == TWO_VIEW_PER_EVAL["windowed_gather"],
           f"two-view eval: {n_k1} K1 calls, expected "
           f"{TWO_VIEW_PER_EVAL['windowed_gather']}")
    run_phases(results, "two-view eval", sites, calls)
    del calls
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    record_launches("two-view eval", cuda_build.launch_counts(),
                    only(TWO_VIEW_PER_EVAL), 1, "evals")
    probs = got["probs"]
    norm = float((probs.sum(-1) - 1).abs().max())
    expect(tuple(probs.shape) == (B, N, N_CLASSES)
           and bool(torch.isfinite(probs).all()) and norm <= 1e-5,
           f"two-view eval: probabilities not finite or off normal by {norm}")
    # K1, K3 and K4 by their plain versions, on the same pyramids (K2, held
    # on its own calls, stays: a last-bit distance tie would move a
    # neighbour, not test the rest)
    plain = [(neighbors, "windowed_gather", windowed.windowed_gather_plain),
             (point_conv_big, "point_conv_fused_infer",
              conv.point_conv_fused_infer_plain),
             (crf_conv, "crf_similarity_message",
              crf_sim.crf_similarity_message_plain)]
    with patched(plain):
        ref = run()
    torch.cuda.synchronize()
    d_probs = float((probs - ref["probs"]).abs().max())
    # the 1-view forward read 7.45e-8 of max|logit| kernels vs plain
    expect(d_probs <= 1e-5, f"two-view eval kernels vs plain: max |dprobs| "
           f"{d_probs}")
    eval_ms = median_ms(run, runs=5)
    print(f"# two-view eval of {B}x{N}: {eval_ms:.3f} ms (events, median of "
          f"5; host {host_ms:.3f} ms), probabilities off normal by "
          f"{norm:.3g}, kernels vs plain max |dprobs| {d_probs:.3g}, loss "
          f"{float(got['loss']):.5f}", flush=True)
    profile, busy = profile_phase(
        "two-view profiler", run,
        os.path.join(out_dir, "chip_smoke_two_view_trace.json"), "eval",
        eval_ms,
    )
    del state, raw, got, ref
    torch.cuda.empty_cache()
    return {
        "eval_ms": eval_ms,
        "points_per_s": B * N / (eval_ms / 1e3),
        "max_abs_dprobs": d_probs,
        "probs_off_normal": norm,
        "kernel_busy_ms": busy,
        "profile": profile[:40],
        "calls_per_eval": only(TWO_VIEW_PER_EVAL),
    }


def discrete_exact_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 19: ScanNet-discrete served in the exact regime."""
    cfg = scannet_config()
    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(SEED + 17)
    model = randomize_batch_norms(discrete_model(cfg, dev), gen)
    with torch.no_grad():   # compatibilities away from the identity
        model.crf.C.add_(0.1 * torch.randn(model.crf.C.shape,
                                           generator=gen).to(dev))

    def check_logq(logq):
        expect(tuple(logq.shape) == (b, n, n_cls),
               f"discrete exact log q shape {tuple(logq.shape)}")
        expect(bool(torch.isfinite(logq).all()),
               "discrete exact: non-finite log q")
        norm = float(torch.logsumexp(logq, -1).abs().max())
        expect(norm <= 1e-4, f"discrete exact: log q off normal by {norm}")

    serve = ExactServer(model, dev, cfg.kernel_sizes, cfg.ratios, cfg.k_up,
                        head=-1)
    phases, serving = exact_serve_path(
        "discrete_exact", lambda: scannet_cloud(cfg, rng, dev), serve,
        DISCRETE_REQUESTS, DISCRETE_EXACT_PER_REQUEST, check_logq, out_dir)
    for name, r in phases.items():
        results.setdefault(name, []).extend(r)
    del model, serve
    torch.cuda.empty_cache()
    return {
        "config": {"model": "BaselineDiscreteCRFSegNet", "batch": b,
                   "points": n, "classes": n_cls, "steps": cfg.steps,
                   "k_up": cfg.k_up, "mode": "exact"},
        **serving,
    }


# --------------------------------------------------------------------------
# ShapeNet: CRFSegNet_Part(steps=10), part segmentation with a category
# --------------------------------------------------------------------------


def shapenet_config(batch_size=None):
    """ShapeNetConfig; its pyramid is build_pyramid_windowed's defaults, as
    the reference bench builds it (config_bench.py:108-109)."""
    from crfconv_tpu_torch.train.config import ShapeNetConfig

    cfg = ShapeNetConfig()
    if batch_size is not None:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    return cfg


def shapenet_model(cfg, device, seed: int = SEED):
    from crfconv_tpu_torch import CRFSegNet_Part

    return CRFSegNet_Part(cfg.num_classes, cfg.in_channels, steps=cfg.steps,
                          device=device,
                          generator=torch.Generator().manual_seed(seed))


def shapenet_state(cfg, device, seed: int = SEED):
    """A fresh TrainState with ShapeNet's optimizer settings."""
    from crfconv_tpu_torch import TrainState

    return TrainState.create(
        shapenet_model(cfg, device, seed), lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, gamma=cfg.gamma,
    )


def shapenet_cloud(cfg, rng, device, labels: bool = False):
    """B x 2048 random clouds with 6 features and a category each in [0,
    16); with ``labels``, a RawBatch whose labels are parts of the cloud's
    category."""
    from crfconv_tpu_torch import RawBatch
    from crfconv_tpu_torch.train.metrics import SHAPENET_OBJ_CLASSES

    b, n = cfg.batch_size, cfg.sample_num
    pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32),
                          device=device)
    feats = torch.as_tensor(
        rng.random((b, n, cfg.in_channels), dtype=np.float32), device=device)
    category = rng.integers(0, len(SHAPENET_OBJ_CLASSES), (b,))
    if not labels:
        return pos, feats, torch.as_tensor(category, device=device)
    y = shapenet_labels(rng, category, n)
    return RawBatch(pos=pos, x=feats, y=torch.as_tensor(y, device=device),
                    category=torch.as_tensor(category, device=device))


def shapenet_labels(rng, category, n: int) -> np.ndarray:
    """[B, n] part labels, each cloud's drawn among its category's parts."""
    from crfconv_tpu_torch.train.metrics import (
        SHAPENET_OBJ_CLASSES, SHAPENET_SEG_CLASSES,
    )

    names = {v: k for k, v in SHAPENET_OBJ_CLASSES.items()}
    return np.stack([rng.choice(SHAPENET_SEG_CLASSES[names[int(c)]], n)
                     for c in category])


def shapenet_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 20-21: ShapeNet's CRFSegNet_Part(50 classes, steps=10) served
    at B16 x 2048 with a category a cloud and trained at B8
    (:func:`crf_net_phases`), the part IoU of its outputs, and one step
    with curve jitter."""
    from crfconv_tpu_torch import make_train_step
    from crfconv_tpu_torch.ops.windowed import check_window_consistency
    from crfconv_tpu_torch.train.metrics import RunningScoreShapeNet
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    cfg = shapenet_config()
    tcfg = shapenet_config(SHAPENET_TRAIN_BATCH)
    score = RunningScoreShapeNet()

    def request():
        pos, feats, category = shapenet_cloud(cfg, rng, dev)
        return pos, feats, {"category": category}

    def read(logp, kw):
        # part IoU against labels drawn in each cloud's category (the
        # metric's path; the weights are random)
        cats = kw["category"].tolist()
        y = shapenet_labels(rng, cats, cfg.sample_num)
        pred = logp.argmax(-1).cpu().numpy()
        for i, c in enumerate(cats):
            score.update(y[i], pred[i], c)

    out, raws = crf_net_phases(
        "shapenet", shapenet_model(cfg, dev), SEED + 19,
        lambda: shapenet_state(tcfg, dev), request,
        lambda: shapenet_cloud(tcfg, rng, dev, labels=True), cfg, tcfg, dev,
        out_dir, results, score=read)
    p_iou, mp_iou, _ = score.get_scores()
    expect(0.0 <= p_iou <= 1.0 and 0.0 <= mp_iou <= 1.0,
           f"shapenet: part IoU {p_iou}, {mp_iou} outside [0, 1]")
    print(f"# shapenet: part IoU of random weights {p_iou:.4f} (mean over "
          f"categories {mp_iou:.4f})", flush=True)

    # one step with curve jitter: the rotation drawn from the step's
    # generator turns its Morton curve; its pyramid is window-consistent at
    # every scale, its loss finite, and a rerun from the same seed
    # bit-identical
    jit_step = make_train_step(TRAIN_MODE, ignore_index=tcfg.ignore_index,
                               label_offset=tcfg.label_offset,
                               curve_jitter=True)
    jb, order = build_windowed_batch(raws[0], step_generator(dev, 400),
                                     mode=TRAIN_MODE, curve_jitter=True,
                                     return_order=True)
    _, plain_order = build_windowed_batch(raws[0], step_generator(dev, 400),
                                          mode=TRAIN_MODE, return_order=True)
    consistency = []
    for sc in jb.scales:
        n_s = sc.pos.shape[1]
        consistency.append(min(
            check_window_consistency(sc.neighbor_idx.cpu().numpy(), n_s),
            check_window_consistency(sc.sub_idx.cpu().numpy(), n_s),
            check_window_consistency(sc.up_idx.cpu().numpy(),
                                     sc.sub_idx.shape[1])))
    expect(all(c == 1.0 for c in consistency),
           f"shapenet jittered pyramid: window consistency {consistency}")
    turned = float((order != plain_order).float().mean())
    expect(turned > 0.5, f"shapenet jitter: only {turned} of the Morton order "
           "moved")
    del jb
    jit_runs = []
    for _ in range(2):
        st = shapenet_state(tcfg, dev)
        m = jit_step(st, raws[0], step_generator(dev, 400))
        jit_runs.append((float(m["loss"]),
                         [p.grad.clone() for p in st.model.parameters()]))
        del st
    (loss_a, grads_a), (loss_b, grads_b) = jit_runs
    jit_identical = loss_a == loss_b and all(
        torch.equal(a, b_) for a, b_ in zip(grads_a, grads_b))
    expect(bool(np.isfinite(loss_a)), f"shapenet jittered step: loss {loss_a}")
    expect(jit_identical, "shapenet jittered step: a rerun from the same "
           "seed is not bit-identical")
    print(f"# shapenet jittered step: loss {loss_a:.6f}, window consistency "
          f"{consistency}, {turned:.3f} of the order moved, rerun "
          f"bit-identical {jit_identical}", flush=True)
    del jit_runs, grads_a, grads_b, raws
    torch.cuda.empty_cache()
    return {
        **out,
        "pyramid": "build_pyramid_windowed defaults",
        "part_iou": [p_iou, mp_iou],
        "jitter": {"loss": loss_a, "window_consistency": consistency,
                   "order_moved": turned, "rerun_bit_identical": jit_identical},
    }


# --------------------------------------------------------------------------
# SemanticKITTI: the flagship at B8 x 65536 with 4 input channels
# --------------------------------------------------------------------------


def kitti_config():
    from crfconv_tpu_torch.train.config import SemanticKITTIConfig

    return SemanticKITTIConfig()


def kitti_state(cfg, device, seed: int = SEED):
    """A fresh TrainState of the full-width flagship at SemanticKITTI's
    widths (4 input channels, 19 classes), dropout 0.5, its optimizer."""
    from crfconv_tpu_torch import PointConvResNet, TrainState

    model = PointConvResNet(
        cfg.num_classes, cfg.in_channels, use_crf=True, steps=cfg.steps,
        dropout_rate=DROPOUT, device=device,
        generator=torch.Generator().manual_seed(seed),
    )
    return TrainState.create(model, lr=cfg.lr, momentum=cfg.momentum,
                             weight_decay=cfg.weight_decay, gamma=cfg.gamma)


def kitti_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 22-23: SemanticKITTI served (:func:`flagship_serve_phases`)
    and trained at B8 x 65536 (label_offset 1, dropout 0.5): a recorded
    warm-up step whose K1, K2, K7, K8 and leaky-ReLU calls are held against
    the plain versions, TRAIN_STEPS steps with exact launch counts, and a
    kernel step against one through the plain versions, rerun
    bit-identical."""
    from crfconv_tpu_torch import RawBatch, make_train_step
    from crfconv_tpu_torch.models import point_conv_big
    from crfconv_tpu_torch.ops import neighbors, windowed
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    cfg = kitti_config()
    serving = flagship_serve_phases("kitti", cfg, SEED + 23, dev, rng,
                                    out_dir, results)
    torch.cuda.empty_cache()

    def raw_batch():
        b, n = cfg.batch_size, cfg.sample_num
        pos = torch.as_tensor(rng.random((b, n, 3), dtype=np.float32),
                              device=dev)
        feats = torch.as_tensor(
            rng.random((b, n, cfg.in_channels), dtype=np.float32), device=dev)
        y = torch.as_tensor(rng.integers(0, cfg.num_classes + 1, (b, n)),
                            device=dev)
        return RawBatch(pos=pos, x=feats, y=y)

    train_step = make_train_step(TRAIN_MODE, ignore_index=cfg.ignore_index,
                                 label_offset=cfg.label_offset)
    state = kitti_state(cfg, dev)
    raws = [raw_batch() for _ in range(TRAIN_STEPS)]
    sites = train_call_sites()
    calls = record_calls(
        sites, lambda: train_step(state, raws[0], step_generator(dev, 0)))
    torch.cuda.synchronize()
    for name, got in calls.items():
        per = KITTI_PER_STEP[name]
        expect(len(got) == per,
               f"kitti {name}: {len(got)} calls per step, expected {per}")
    k7_rows = sorted((a[0].shape[1], a[0].shape[2])
                     for a, _ in calls["windowed_weighted_reduce"])
    run_phases(results, "kitti train", sites, calls)
    del calls
    torch.cuda.empty_cache()
    params, train = small_train_path("kitti", state, raws, train_step, dev,
                                     cfg, KITTI_PER_STEP, out_dir)
    del state, params
    torch.cuda.empty_cache()
    plain_pairs = [
        (neighbors, "windowed_gather", windowed.windowed_gather_plain),
        (point_conv_big, "weighted_gather_reduce",
         lambda *a: windowed.windowed_weighted_reduce_plain(*a)[0]),
        leaky_plain_pair(),
    ]
    step_check = small_kernel_vs_plain_step(
        "kitti", lambda: kitti_state(cfg, dev), raws[0], dev, cfg,
        plain_pairs, {**KITTI_PER_STEP, "window_knn": 0}, {}, loss_rtol=0.0,
        dropout=True,
    )
    print(f"# kitti train: K7 on (rows a cloud, width) {k7_rows}", flush=True)
    del raws
    torch.cuda.empty_cache()
    return {**serving, **train, "k7_calls": k7_rows,
            "kernel_vs_plain_step": step_check,
            "calls_per_step": KITTI_PER_STEP}


# --------------------------------------------------------------------------
# the CRF heads' exact-regime training: the scans under K6's pyramid
# --------------------------------------------------------------------------


def exact_train_path(label, make_state, make_raw, cfg, dev, expected,
                     out_dir) -> tuple:
    """An exact-regime train path of a small-family net at ``cfg``'s
    settings: each step builds its pyramid on the card
    (build_pyramid_device with ``cfg``'s kernel sizes, ratios and k_up, K6
    selecting) and takes make_train_step(NeighborMode("exact"),
    windowed=False) on it; its CRFs run the scans (plain PyTorch,
    differentiated by autograd). A recorded warm-up step whose K6 and
    leaky-ReLU calls are held against the plain versions; the main path of
    :func:`small_train_path` with ``expected`` launches a step; from one
    state and pyramid seed a step with the kernels against one with K6 and
    the leaky ReLU's backward plain (losses equal, gradients within
    :func:`grad_gap`), and a rerun. Returns (the kernel phases, the
    measurements)."""
    from crfconv_tpu_torch import (
        build_pyramid_device, cuda_build, make_train_step,
    )
    from crfconv_tpu_torch.data.batch import PointBatch
    from crfconv_tpu_torch.ops import neighbors, windowed

    train_step = make_train_step(EXACT, ignore_index=cfg.ignore_index,
                                 label_offset=cfg.label_offset,
                                 windowed=False)

    def build(raw, gen):
        return PointBatch(x=raw.x, y=raw.y, scales=build_pyramid_device(
            raw.pos, cfg.kernel_sizes, cfg.ratios, k_up=cfg.k_up,
            generator=gen, device=dev))

    def step(state, raw, gen):
        return train_step(state, build(raw, gen), gen)

    state = make_state()
    raws = [make_raw() for _ in range(TRAIN_STEPS)]
    sites = {"select_min_k": (neighbors, "select_min_k",
                              windowed.select_min_k,
                              windowed.select_min_k_plain),
             "leaky_relu_bwd": train_call_sites()["leaky_relu_bwd"]}
    calls = record_calls(sites, lambda: step(state, raws[0],
                                             step_generator(dev, 0)))
    torch.cuda.synchronize()
    for name, got in calls.items():
        expect(len(got) == expected[name], f"{label} {name}: {len(got)} "
               f"calls per step, expected {expected[name]}")
    results = {}
    run_phases(results, f"{label} train", sites, calls)
    del calls
    torch.cuda.empty_cache()

    params, train = small_train_path(label, state, raws, step, dev, cfg,
                                     only(expected), out_dir, EXACT, build)
    del state, params
    torch.cuda.empty_cache()

    # one pyramid seed: K6 and the leaky ReLU's backward against their plain
    # versions (the pyramid and the forward are bit-equal, so the loss is);
    # the scans' backward adds with autograd's atomics (gather's backward),
    # so the gradients are held to grad_gap and a rerun is reported
    sk, sk2, sp = (make_state() for _ in range(3))
    cuda_build.reset_launch_counts()
    mk = step(sk, raws[0], step_generator(dev, 100))
    k_counts = cuda_build.launch_counts()
    step(sk2, raws[0], step_generator(dev, 100))
    cuda_build.reset_launch_counts()
    with patched([(neighbors, "select_min_k", windowed.select_min_k_plain),
                  leaky_plain_pair()]):
        mp = step(sp, raws[0], step_generator(dev, 100))
    p_counts = cuda_build.launch_counts()
    torch.cuda.synchronize()
    for name, per in expected.items():
        expect(k_counts[name] == per, f"{label} kernel step: "
               f"{k_counts[name]} launches of {name}, expected {per}")
    expect(not any(p_counts.values()), f"{label} plain step launched "
           f"{p_counts}")
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    expect(loss_k == loss_p, f"{label} kernel vs plain step: loss {loss_k} vs "
           f"{loss_p}")
    d_grad, worst, g_max = grad_gap(sk.model, sp.model)
    expect(d_grad <= 1.0, f"{label} kernel vs plain step: gradient of "
           f"{worst} at {d_grad:.3g} of its tolerance")
    d_rerun, worst_rerun, _ = grad_gap(sk.model, sk2.model)
    expect(d_rerun <= 1.0, f"{label} kernel step rerun: gradient of "
           f"{worst_rerun} at {d_rerun:.3g} of its tolerance")
    rerun_differs = [
        nm for (nm, p), q in zip(sk.model.named_parameters(),
                                 sk2.model.parameters())
        if not torch.equal(p.grad, q.grad)]
    print(f"# {label} train step kernels vs plain (one pyramid seed): loss "
          f"{loss_k} vs {loss_p}, worst gradient {worst} at {d_grad:.3g} of "
          f"its tolerance (largest |grad| {g_max:.3g}); rerun: "
          f"{len(rerun_differs)} gradients not bit-identical, worst "
          f"{worst_rerun} at {d_rerun:.3g}", flush=True)
    del sk, sk2, sp, raws
    torch.cuda.empty_cache()
    return results, {
        **train,
        "kernel_vs_plain_step": {
            "loss": [loss_k, loss_p], "grad_of_tolerance": d_grad,
            "grad_worst": worst, "grad_max": g_max,
            "rerun_grad_of_tolerance": d_rerun,
            "rerun_grads_differ": rerun_differs},
        "calls_per_step": only(expected),
    }


def scannet_exact_phases(dev, rng, out_dir: str, results: dict) -> dict:
    """Phases 24-25: ScanNet's CRFSegNet(20 classes, steps=10) served and
    trained in the exact regime at B16 x 8192 (ScanNet's kernel sizes,
    ratios and k_up = 3): K6 under the pyramid, the CRFs' scans."""
    cfg = scannet_config()
    b, n, n_cls = cfg.batch_size, cfg.sample_num, cfg.num_classes
    gen = torch.Generator().manual_seed(SEED + 29)
    model = randomize_batch_norms(scannet_model(cfg, dev), gen)
    with torch.no_grad():   # compatibilities away from the identity
        for name, p in model.named_parameters():
            if name.endswith(".c"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(dev))

    def check_logp(logp):
        expect(tuple(logp.shape) == (b, n, n_cls),
               f"scannet exact log-probs shape {tuple(logp.shape)}")
        expect(bool(torch.isfinite(logp).all()),
               "scannet exact: non-finite log-probs")
        norm = float(torch.logsumexp(logp, -1).abs().max())
        expect(norm <= 1e-4, f"scannet exact: log-probs off normal by {norm}")

    serve = ExactServer(model, dev, cfg.kernel_sizes, cfg.ratios, cfg.k_up)
    phases, serving = exact_serve_path(
        "scannet_exact", lambda: scannet_cloud(cfg, rng, dev), serve,
        SCANNET_REQUESTS, EXACT_PER_REQUEST, check_logp, out_dir)
    for name, r in phases.items():
        results.setdefault(name, []).extend(r)
    del model, serve
    torch.cuda.empty_cache()
    phases, train = exact_train_path(
        "scannet_exact", lambda: scannet_state(cfg, dev),
        lambda: scannet_cloud(cfg, rng, dev, labels=True), cfg, dev,
        SCANNET_EXACT_PER_STEP, out_dir)
    for name, r in phases.items():
        results.setdefault(name, []).extend(r)
    return {
        "config": {"model": cfg.model_name, "batch": b, "points": n,
                   "classes": n_cls, "steps": cfg.steps, "k_up": cfg.k_up,
                   "mode": "exact"},
        **serving, **train,
    }


def discrete_exact_train_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 26: ScanNet-discrete's BaselineDiscreteCRFSegNet(20 classes,
    steps=10) trained in the exact regime at B16 x 8192: K6 under the
    pyramid and the CRF's kNN(32), the discrete CRF's scan."""
    cfg = scannet_config()
    phases, train = exact_train_path(
        "discrete_exact", lambda: discrete_state(cfg, dev),
        lambda: scannet_cloud(cfg, rng, dev, labels=True), cfg, dev,
        DISCRETE_EXACT_PER_STEP, out_dir)
    for name, r in phases.items():
        results.setdefault(name, []).extend(r)
    return {"config": {"model": "BaselineDiscreteCRFSegNet",
                       "batch": cfg.batch_size, "points": cfg.sample_num,
                       "classes": cfg.num_classes, "steps": cfg.steps,
                       "k_up": cfg.k_up, "mode": "exact"},
            **train}


# --------------------------------------------------------------------------
# loader-fed training: synthetic dataset files, the readers, the loader
# --------------------------------------------------------------------------

ROOM_POINTS = 120_000
LOADER_STEPS = 10   # loader-fed steps a round (fed, placed, placed, fed)
# (area, room, box size in m, offset of its corner, furniture: (class, low
# corner, high corner, points)); the storage room subsamples to fewer than
# 8192 points at 0.04 m, so its crops are padded with duplicate points
S3DIS_ROOMS = (
    ("Area_1", "office_1", (6.0, 5.0, 3.0), (12.345, 7.031, 0.512), (
        ("table", (1.0, 1.0, 0.0), (2.6, 1.8, 0.75), 12000),
        ("chair", (1.5, 2.1, 0.0), (2.0, 2.6, 0.9), 4000),
        ("bookcase", (0.0, 3.6, 0.0), (0.4, 4.8, 2.0), 10000),
        ("board", (2.0, 4.95, 1.0), (4.0, 5.0, 2.2), 4000))),
    ("Area_1", "storage_1", (1.0, 1.0, 2.0), (3.25, -4.5, 0.512), (
        ("clutter", (0.1, 0.1, 0.0), (0.6, 0.5, 0.8), 6000),)),
    ("Area_5", "office_2", (6.0, 5.0, 3.0), (-20.0, 3.3, 0.125), (
        ("table", (3.0, 2.0, 0.0), (4.6, 2.8, 0.75), 12000),
        ("sofa", (0.2, 0.2, 0.0), (2.2, 1.1, 0.8), 8000))),
)
S3DIS_COLORS = {
    "ceiling": (200, 200, 190), "floor": (120, 100, 80),
    "wall": (180, 170, 160), "table": (140, 90, 50), "chair": (40, 40, 60),
    "bookcase": (90, 60, 30), "board": (240, 240, 240),
    "sofa": (60, 90, 140), "clutter": (150, 60, 60),
}
# launches per loader-fed S3DIS step: the flagship's train step
S3DIS_LOADER_PER_STEP = EXPECTED_PER_STEP
# per exact-regime ShapeNet step on the host pyramid: the leaky ReLU's
# backward once per activation of CRFSegNet_Part (counted on a CPU step by
# tests/test_torch_chip_smoke_checks.py), no other kernel (the host builds
# the pyramid, the CRFs are the scans)
SHAPENET_EXACT_PER_STEP = {"leaky_relu_bwd": 41}


def box_surface(rng, lo, hi, n: int):
    """``n`` points uniform on the surface of the box [lo, hi] and each
    point's face (2 * axis + side: 4 the floor, 5 the ceiling)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    d = hi - lo
    area = np.array([d[1] * d[2], d[0] * d[2], d[0] * d[1]])
    face = rng.choice(6, n, p=np.repeat(area, 2) / (2 * area.sum()))
    p = lo + rng.random((n, 3)) * d
    axis = face // 2
    p[np.arange(n), axis] = np.where(face % 2 == 1, hi[axis], lo[axis])
    return p, face


def write_s3dis_rooms(root: str, rng) -> None:
    """S3DIS's raw layout: each room ROOM_POINTS points on its box's walls,
    floor and ceiling and on box furniture, one ``<class>_<i>.txt`` of
    ``x y z r g b`` rows (millimetres, as the dataset's files) a part."""
    raw = os.path.join(root, "raw")
    rels = {}
    for area, room, size, offset, furniture in S3DIS_ROOMS:
        rel = f"{area}/{room}/Annotations"
        anno = os.path.join(raw, "Stanford3dDataset_v1.2_Aligned_Version",
                            rel)
        os.makedirs(anno)
        shell, face = box_surface(
            rng, (0, 0, 0), size, ROOM_POINTS - sum(f[3] for f in furniture))
        parts = [("floor", shell[face == 4]), ("ceiling", shell[face == 5])]
        parts += [("wall", shell[face == f]) for f in range(4)]
        parts += [(cls, box_surface(rng, lo, hi, n)[0])
                  for cls, lo, hi, n in furniture]
        seen = {}
        for cls, pts in parts:
            seen[cls] = seen.get(cls, 0) + 1
            rgb = np.clip(np.asarray(S3DIS_COLORS[cls]) + rng.normal(
                0, 12, (len(pts), 3)), 0, 255)
            np.savetxt(os.path.join(anno, f"{cls}_{seen[cls]}.txt"),
                       np.column_stack([pts + offset, rgb]),
                       fmt="%.3f %.3f %.3f %d %d %d")
        rels.setdefault(area, []).append(rel)
    for area, names in rels.items():
        with open(os.path.join(raw, f"{area}_anno.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


def write_shapenet_shapes(root: str, rng, shapes: int = 4) -> None:
    """ShapeNet's normal layout: the 16 categories, ``shapes`` shapes each
    (two train, one val, one test) of 2,600-3,000 points on an ellipsoid,
    ``x y z nx ny nz part`` rows, the parts bands of height in the
    category's own range, and the shuffled split lists."""
    from crfconv_tpu_torch.train.metrics import (
        SHAPENET_OBJ_CLASSES, SHAPENET_SEG_CLASSES,
    )

    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "train_test_split"))
    names = sorted(SHAPENET_OBJ_CLASSES, key=SHAPENET_OBJ_CLASSES.get)
    with open(os.path.join(raw, "synsetoffset2category.txt"), "w") as f:
        f.writelines(f"{name}\t{i:08d}\n" for i, name in enumerate(names))
    lists = {"train": [], "val": [], "test": []}
    for i, name in enumerate(names):
        synset = f"{i:08d}"
        os.makedirs(os.path.join(raw, synset))
        parts = np.asarray(SHAPENET_SEG_CLASSES[name])
        for j in range(shapes):
            n = int(rng.integers(2600, 3001))
            axes = rng.uniform(0.2, 0.8, 3)
            u = rng.standard_normal((n, 3))
            pos = u / np.linalg.norm(u, axis=1, keepdims=True) * axes
            normal = pos / axes ** 2
            normal /= np.linalg.norm(normal, axis=1, keepdims=True)
            band = np.minimum(((pos[:, 2] / axes[2] + 1) / 2 * len(parts))
                              .astype(int), len(parts) - 1)
            sid = f"shape{j:04d}"
            np.savetxt(os.path.join(raw, synset, sid + ".txt"),
                       np.column_stack([pos, normal, parts[band]]),
                       fmt="%.6f %.6f %.6f %.6f %.6f %.6f %d")
            split = ("train", "train", "val", "test")[j % 4]
            lists[split].append(f"shape_data/{synset}/{sid}")
    for split, entries in lists.items():
        with open(os.path.join(raw, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(entries, f)


def batches_equal(a, b) -> bool:
    """Two batches of tensors (a RawBatch or PointBatch each) hold the same
    values, bit for bit."""
    from crfconv_tpu_torch.data.loader import batch_tensors

    ta, tb = batch_tensors(a), batch_tensors(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


def pyramid_checks(scales, kernel_sizes, dilations, knn) -> dict:
    """A host pyramid's invariants, on host copies: scale 0's column 0 is
    the point itself on every row; every index lies in its scale; and at
    each scale the share of neighbour entries outside the plain kNN(k) of
    the point (``knn(pos, k)`` -> [B, N, k]) is 0 where the dilation is 1
    and above 0 where it is larger. Returns the self share, whether every
    index is in range and the share outside kNN(k) at each scale."""
    out = {"in_range": True, "outside_knn": []}
    for s, sc in enumerate(scales):
        pos = sc.pos.cpu().numpy()
        nbr = sc.neighbor_idx.cpu().numpy()
        n, n_sub = pos.shape[1], sc.sub_idx.shape[1]
        up = sc.up_idx.cpu().numpy()
        sub = sc.sub_idx.cpu().numpy()
        out["in_range"] &= bool(
            (nbr >= 0).all() and (nbr < n).all() and (sub >= 0).all()
            and (sub < n).all() and (up >= 0).all() and (up < n_sub).all())
        if s == 0:
            out["self_share"] = float((nbr[..., 0] == np.arange(n)).mean())
        plain = knn(pos, kernel_sizes[s])
        inside = (nbr[..., :, None] == plain[..., None, :]).any(-1)
        out["outside_knn"].append(float(1 - inside.mean()))
    expect(out["self_share"] == 1.0,
           f"host pyramid: column 0 is self on {out['self_share']} of rows")
    expect(out["in_range"], "host pyramid: an index outside its scale")
    for s, (share, d) in enumerate(zip(out["outside_knn"], dilations)):
        expect((share > 0) if d > 1 else (share == 0),
               f"host pyramid scale {s} (dilation {d}): {share} of the "
               "neighbours outside the plain kNN(k)")
    return out


def endless(loader):
    """The loader's batches epoch after epoch, as a trainer draws them."""
    while True:
        yield from loader


def timed_steps(state, train_step, batches, n: int, dev, seed0: int):
    """``n`` train steps on ``next(batches)``, with no synchronisation
    between them, as a training loop runs: returns the event ms of each
    step (the stream's time from one step's end to the next's, the wait
    for the batch included), the losses and the host seconds."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    losses = []
    for i in range(n):
        m = train_step(state, next(batches), step_generator(dev, seed0 + i))
        losses.append(m["loss"])
        ev[i + 1].record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    return ([ev[i].elapsed_time(ev[i + 1]) for i in range(n)],
            [float(v) for v in losses], host_s)


def loader_host_ms(loader, runs: int) -> dict:
    """The loader without a step (prefetch 0): host ms of a batch's draw
    (samples, transforms, stacking), of its placing (host pyramid where
    ``emit`` is "pyramid", pinned copies, the device synchronised), and the
    device ms of its H2D copies from pinned memory (events); medians."""
    draw, place, h2d, nbytes_ = [], [], [], 0
    for _ in range(runs):
        t0 = time.perf_counter()
        h = loader.draw()
        t1 = time.perf_counter()
        loader.place(h)
        torch.cuda.synchronize()
        draw.append((t1 - t0) * 1e3)
        place.append((time.perf_counter() - t1) * 1e3)
    arrays = [a for a in (h.pos, h.x, h.y, h.point_idx) if a is not None]
    pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
              for a in arrays]
    nbytes_ = sum(a.nbytes for a in arrays)
    h2d = median_ms(lambda: [p.to(loader.device, non_blocking=True)
                             for p in pinned])
    return {"draw_ms": statistics.median(draw),
            "place_ms": statistics.median(place),
            "batch_ms": statistics.median(d + p for d, p in zip(draw, place)),
            "h2d_ms": h2d, "h2d_bytes": nbytes_,
            "h2d_gb_per_s": nbytes_ / h2d / 1e6}


def loader_train_path(label, loader, state, train_step, dev, sites,
                      expected, out_dir, results) -> tuple:
    """A train path fed by ``loader`` (prefetch 2, on the card): a recorded
    step whose kernel calls are held against their plain versions
    (``results`` gains the phases); LOADER_STEPS steps fed by the loader,
    with exact launch counts, a finite loss, finite nonzero gradients and
    every parameter and running statistic moved; the same steps on the
    same batches placed on the card beforehand, in turns with steps fed by
    the loader (fed, placed, placed, fed); a profiled loader-fed step and
    peak memory. Returns every batch the loader gave, in order, and the
    measurements."""
    from crfconv_tpu_torch import cuda_build

    name = f"{label} train"
    consumed = []

    def fed_batches():
        for b in endless(loader):
            consumed.append(b)
            yield b

    fed = fed_batches()
    first = next(fed)
    calls = record_calls(sites, lambda: train_step(state, first,
                                                   step_generator(dev, 0)))
    torch.cuda.synchronize()
    for kname, got in calls.items():
        expect(len(got) == expected[kname], f"{name} {kname}: {len(got)} "
               f"calls per step, expected {expected[kname]}")
    run_phases(results, name, sites, calls)
    del calls

    params = dict(state.model.named_parameters())
    before = snapshot(state.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    fed_ms, losses, host_s = timed_steps(state, train_step, fed, LOADER_STEPS,
                                         dev, 1)
    counts = cuda_build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    record_launches(name, counts, only(expected), LOADER_STEPS, "steps")
    expect(all(np.isfinite(losses)), f"{name}: losses {losses}")
    bad = [n for n, p in params.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool(p.grad.any())]
    expect(not bad, f"{name}: no, non-finite or all-zero gradient {bad[:4]}")
    after = snapshot(state.model)
    still = [n for n in params if torch.equal(before[n], after[n])]
    expect(not still, f"{name}: parameters that did not move {still[:4]}")
    stats = [n for n in before if n not in params]
    same = [n for n in stats if torch.equal(before[n], after[n])]
    expect(stats and not same, f"{name}: running statistics unchanged "
           f"{same[:4]}")
    del before, after

    placed = consumed[1:1 + LOADER_STEPS]
    placed_ms, _, _ = timed_steps(state, train_step, iter(placed),
                                  LOADER_STEPS, dev, 1)
    placed2_ms, _, _ = timed_steps(state, train_step, iter(placed),
                                   LOADER_STEPS, dev, 1)
    fed2_ms, _, _ = timed_steps(state, train_step, fed, LOADER_STEPS, dev, 1)
    fed_med = statistics.median(fed_ms + fed2_ms)
    placed_med = statistics.median(placed_ms + placed2_ms)
    print(f"# {name} ({CARD}): {LOADER_STEPS} loader-fed steps "
          f"{[round(t, 3) for t in fed_ms]} ms (events; {host_s:.3f} s host), "
          f"loss {[round(v, 5) for v in losses]}, peak memory "
          f"{peak_gb:.2f} GiB; in turns fed, placed, placed, fed: "
          f"median step {fed_med:.3f} ms fed by the loader, {placed_med:.3f} "
          f"ms on the same batches placed beforehand (gap "
          f"{fed_med - placed_med:+.3f} ms)", flush=True)
    gen = step_generator(dev, 50)
    profile, busy = profile_phase(
        f"{label} profiler (loader-fed)",
        lambda: train_step(state, next(fed), gen),
        os.path.join(out_dir, f"chip_smoke_{label}_trace.json"), "step",
        fed_med)
    fed.close()
    return consumed, {
        "fed_steps_ms": fed_ms, "fed_again_ms": fed2_ms,
        "placed_steps_ms": placed_ms, "placed_again_ms": placed2_ms,
        "fed_step_ms": fed_med, "placed_step_ms": placed_med,
        "fed_host_s": host_s, "losses": losses, "peak_gib": peak_gb,
        "kernel_busy_ms": busy, "idle_share": 1 - busy / fed_med,
        "profile": profile[:40], "calls_per_step": only(expected),
    }


def s3dis_loader_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 27: S3DIS rooms written as raw files, processed by the port's
    reader (numpy parse, native grid subsample, KD-tree projection), cropped
    by the possibility sampler and fed by MultiscaleLoader (emit "raw",
    prefetch 2, the train transform) to the full-width flagship's windowed
    train step at B8 x 8192 (:func:`loader_train_path`); a loader without
    prefetch restored to the first one's starting state gives the same
    batches bit for bit, and times a batch on the host."""
    import tempfile

    from crfconv_tpu_torch import (
        MultiscaleLoader, S3DISRoomDataset, loader_load_state_dict,
        loader_state_dict, make_train_step,
    )
    from crfconv_tpu_torch.data.transforms import default_train_transform
    from crfconv_tpu_torch.ops import native_build
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    with tempfile.TemporaryDirectory(prefix="chip_smoke_s3dis_") as root:
        t0 = time.perf_counter()
        write_s3dis_rooms(root, np.random.default_rng(SEED + 27))
        t1 = time.perf_counter()
        data = S3DISRoomDataset(root, grid_size=0.04, num_points=N,
                                seed=SEED)
        t2 = time.perf_counter()
    train = data.train_set
    sub_points = [int(p.shape[0]) for p in train.input_points]
    lib = native_build.library_path().name
    print(f"# s3dis loader: {len(S3DIS_ROOMS)} rooms of {ROOM_POINTS} points "
          f"written in {t1 - t0:.2f} s, processed in {t2 - t1:.2f} s (host "
          f"kNN and grid subsample: native, {lib}); training sub-clouds "
          f"{sub_points} points", flush=True)
    expect(min(sub_points) < N < max(sub_points),
           f"s3dis loader: sub-clouds {sub_points} do not straddle {N}")

    def make_loader(prefetch):
        return MultiscaleLoader(train, B, transform=default_train_transform(),
                                emit="raw", prefetch=prefetch, device=dev,
                                seed=SEED)

    loader = make_loader(2)
    start = loader_state_dict(loader)
    consumed, out = loader_train_path(
        "s3dis_loader", loader, make_train_state(dev), make_train_step(
            TRAIN_MODE), dev, train_call_sites(), S3DIS_LOADER_PER_STEP,
        out_dir, results)
    padded = sum(int(len(torch.unique(row)) < N) for b in consumed
                 for row in b.point_idx)
    # the same draws without the thread: a loader without prefetch from the
    # first one's starting state (the sampler's and the loader's generators)
    replay = make_loader(0)
    loader_load_state_dict(replay, start)
    again = iter(replay)
    same = all(batches_equal(b, next(again)) for b in consumed)
    again.close()
    expect(same, "s3dis loader: a loader without prefetch gives other "
           "batches")
    host = loader_host_ms(replay, runs=5)
    print(f"# s3dis loader ({CARD}): {len(consumed)} batches, {padded} of "
          f"{len(consumed) * B} crops padded with duplicates; prefetch 0 "
          f"replay bit-equal {same}; host ms a batch without a step "
          f"{host['batch_ms']:.3f} (draw {host['draw_ms']:.3f}, place "
          f"{host['place_ms']:.3f}), H2D copy {host['h2d_ms']:.4f} ms for "
          f"{host['h2d_bytes']} bytes ({host['h2d_gb_per_s']:.2f} GB/s)",
          flush=True)
    del consumed
    torch.cuda.empty_cache()
    return {"rooms": len(S3DIS_ROOMS), "room_points": ROOM_POINTS,
            "host_backend": f"native ({lib})", "write_s": t1 - t0,
            "process_s": t2 - t1,
            "sub_cloud_points": sub_points, "padded_crops": padded,
            "prefetch0_bit_equal": same, "host": host, **out}


def shapenet_loader_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 28: ShapeNet shapes written as raw files, read by the port's
    reader and fed by MultiscaleLoader with ShapeNetConfig's host pyramid
    (kernel sizes 32, 16, 8, 8, 8, ratios 4, 2, 2, 2, 2, k_up 3, dilations
    1, 2, 4, 2, 1; emit "pyramid", prefetch 2) to CRFSegNet_Part(50,
    steps=10) trained in the exact regime at B8 x 2048 with the category a
    cloud (:func:`loader_train_path`); the first batch's pyramid checked
    (:func:`pyramid_checks`) and the host pyramid timed."""
    import tempfile

    from crfconv_tpu_torch import (
        MultiscaleLoader, ShapeNetNormalDataset, build_pyramid,
        make_train_step,
    )
    from crfconv_tpu_torch.ops import activation, knn_host

    cfg = shapenet_config(SHAPENET_TRAIN_BATCH)
    pyramid = dict(kernel_sizes=cfg.kernel_sizes, ratios=cfg.ratios,
                   k_up=cfg.k_up, dilations=cfg.dilations)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shapenet_") as root:
        t0 = time.perf_counter()
        write_shapenet_shapes(root, np.random.default_rng(SEED + 28))
        t1 = time.perf_counter()
        data = ShapeNetNormalDataset(root, train=True,
                                     num_points=cfg.sample_num)
        t2 = time.perf_counter()
    print(f"# shapenet loader: {len(data)} training shapes written in "
          f"{t1 - t0:.2f} s, processed in {t2 - t1:.2f} s", flush=True)

    def make_loader(prefetch):
        return MultiscaleLoader(data, cfg.batch_size, emit="pyramid",
                                prefetch=prefetch, device=dev, seed=SEED,
                                **pyramid)

    timing = make_loader(0)
    h = timing.draw()
    pyr_ms = []
    for i in range(5):
        t = time.perf_counter()
        build_pyramid(h.pos, rng=np.random.default_rng(i), **pyramid)
        pyr_ms.append((time.perf_counter() - t) * 1e3)
    host = loader_host_ms(timing, runs=5)
    print(f"# shapenet loader ({CARD}): build_pyramid at "
          f"{cfg.batch_size}x{cfg.sample_num} (native kNN) "
          f"{statistics.median(pyr_ms):.3f} ms host (median of 5); host ms "
          f"a batch without a step {host['batch_ms']:.3f} (draw "
          f"{host['draw_ms']:.3f}, pyramid and place {host['place_ms']:.3f})",
          flush=True)

    loader = make_loader(2)
    it = iter(loader)
    first = next(it)
    it.close()
    checks = pyramid_checks(
        first.scales, cfg.kernel_sizes, cfg.dilations,
        lambda pos, k: knn_host.knn_batch(pos, pos, k))
    expect(first.category is not None and first.y.dtype == torch.int64
           and first.scales[0].neighbor_idx.dtype == torch.int64,
           "shapenet loader: a batch without its category or int64 ids")
    print(f"# shapenet loader pyramid: column 0 self on "
          f"{checks['self_share']} of scale 0's rows, indices in range "
          f"{checks['in_range']}, neighbours outside the plain kNN(k) by "
          f"scale {[round(s, 4) for s in checks['outside_knn']]} (dilations "
          f"{cfg.dilations})", flush=True)
    sites = {"leaky_relu_bwd": (activation, "leaky_relu_bwd",
                                activation.leaky_relu_bwd,
                                activation.leaky_relu_bwd_plain)}
    train_step = make_train_step(EXACT, windowed=False,
                                 ignore_index=cfg.ignore_index,
                                 label_offset=cfg.label_offset)
    consumed, out = loader_train_path(
        "shapenet_loader", loader, shapenet_state(cfg, dev), train_step, dev,
        sites, SHAPENET_EXACT_PER_STEP, out_dir, results)
    del consumed
    torch.cuda.empty_cache()
    return {"shapes": len(data), "write_s": t1 - t0, "process_s": t2 - t1,
            "build_pyramid_ms": pyr_ms, "host": host, "pyramid": checks,
            "config": {"model": cfg.model_name, "batch": cfg.batch_size,
                       "points": cfg.sample_num, "steps": cfg.steps,
                       "mode": "exact", **pyramid},
            **out}


# --------------------------------------------------------------------------
# the experiment driver (Trainer through python -m crfconv_tpu_torch.train)
# and the bf16 compute mode
# --------------------------------------------------------------------------

TRAINER_EPOCHS = 2
TRAINER_STEPS = 5          # train steps an S3DIS epoch (B8 crops each)
TRAINER_SHAPENET_BATCH = 16   # ShapeNetConfig's batch
TRAINER_VAL_BATCHES = 2    # val batches an epoch, and a vote pass
VOTE_MAX_PASSES = 40       # a vote test that needs more passes fails
# launches a ShapeNet val batch (the 2-view eval): twice a request's
SHAPENET_VAL_PER_BATCH = {k: 2 * v for k, v in SCANNET_PER_REQUEST.items()}
# kernel calls of a main path held against the plain version outside the
# kernel phases: {kernel: {path: {"calls": n, "max_abs_err": x}}}
HELD = {name: {} for name in REPLACES}


def counts_since(before: dict) -> dict:
    """Launches of each kernel since the counts were ``before``
    (``cuda_build.launch_counts()``)."""
    from crfconv_tpu_torch import cuda_build

    return {k: v - before[k] for k, v in cuda_build.launch_counts().items()}


def hold_calls(path: str, sites, calls) -> None:
    """Every recorded call of each kernel of ``sites`` held against its
    plain version on the same inputs (:func:`compare`; K8's and K11's
    reruns and CPU checks as in a kernel phase), without timing. A call
    recorded with narrower floats (the bf16 mode) is held on the float32
    inputs the wrapper widens it to, and the wrapper's own result must be
    that float32 result rounded once. HELD gains the path's calls and
    largest error."""
    from crfconv_tpu_torch.ops._launch import NARROW, widen

    for name, (_, _, kernel, plain) in sites.items():
        if not calls[name]:
            continue
        err, narrowed = 0.0, 0
        with torch.inference_mode():
            for i, (args, kwargs) in enumerate(calls[name]):
                wide = tuple(widen(a) for a in args)
                got = kernel(*wide, **kwargs)
                ref = plain(*wide, **kwargs)
                torch.cuda.synchronize()
                err = max(err, compare(name, wide, got, ref))
                if name == "windowed_gather_bwd":
                    check_gather_bwd(kernel, wide, kwargs, got, path)
                if name == "crf_iterate_bwd":
                    check_reverse(name, kernel, plain, i, wide, kwargs, got,
                                  path)
                if all(a is w for a, w in zip(args, wide)):
                    continue
                narrowed += 1
                direct = kernel(*args, **kwargs)
                pairs = zip(direct if isinstance(direct, tuple) else (direct,),
                            got if isinstance(got, tuple) else (got,))
                for d, g in pairs:
                    if isinstance(d, torch.Tensor) and d.is_floating_point():
                        expect(d.dtype in NARROW and torch.equal(
                            d, g.to(d.dtype)), f"{name} ({path}): the "
                            "narrow call is not its float32 result rounded")
        OF_BOUND.pop(name, None)
        HELD[name][path] = {"calls": len(calls[name]), "max_abs_err": err,
                            "narrow_calls": narrowed}
        print(f"# held {name} ({path}): {len(calls[name])} calls against the "
              f"plain version ({narrowed} widened from bf16), max_abs_err "
              f"{err:.3g}", flush=True)


def probed_trainer(label: str, step_sites, eval_sites, eval_launches: dict,
                   snapshot=()):
    """The CLI's Trainer class, instrumented for a phase: its first train
    step and first eval batch record their kernel calls (``probe["calls"]``);
    every eval batch's launches are checked against ``eval_launches`` (a
    step's are checked over the run, by the caller, so that a step's timed
    window holds the step alone); it keeps each step's loss and end event,
    each epoch's and val epoch's ms, each val epoch's confusion sum and
    labelled points, and each vote pass's ms (a pass beyond
    VOTE_MAX_PASSES raises). Each instance it makes is appended to the
    class's ``made``."""
    from crfconv_tpu_torch import cuda_build
    from crfconv_tpu_torch.train.trainer import Trainer

    made = []

    class Probed(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
            self.probe = {"calls": {}, "losses": [], "step_ends": [],
                          "epoch_ms": [], "epoch_start": [], "val_ms": [],
                          "val_batches": [], "val_labelled": [],
                          "val_confusion": [], "vote_ms": [],
                          "eval_batches": 0, "in_val": False}
            self.plain_step = step = self._train_step

            def probed_step(state, batch, rng):
                if "step" not in self.probe["calls"]:
                    out = []
                    self.probe["calls"]["step"] = record_calls(
                        step_sites, lambda: out.append(step(state, batch,
                                                            rng)), snapshot)
                    m = out[0]
                else:
                    m = step(state, batch, rng)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.probe["losses"].append(m["loss"])
                self.probe["step_ends"].append(end)
                return m

            self._train_step = probed_step

        def _eval_batch(self, batch, vote_pass=None):
            before = cuda_build.launch_counts()
            if "eval" not in self.probe["calls"]:
                out = []
                self.probe["calls"]["eval"] = record_calls(
                    eval_sites, lambda: out.append(
                        super(Probed, self)._eval_batch(batch, vote_pass)),
                    snapshot)
                m = out[0]
            else:
                m = super()._eval_batch(batch, vote_pass)
            counts = counts_since(before)
            expect(all(counts[k] == eval_launches.get(k, 0) for k in counts),
                   f"{label}: an eval batch launched {counts}, expected "
                   f"{only(eval_launches)}")
            self.probe["eval_batches"] += 1
            if self.probe["in_val"]:
                y = batch.y - self.cfg.label_offset
                ok = (y >= 0) & (y < self.cfg.num_classes)
                if self.cfg.ignore_index is not None:
                    ok &= y != self.cfg.ignore_index
                self.probe["val_labelled"][-1] += int(ok.sum())
            return m

        def train_one_epoch(self, epoch, preempted=None):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.probe["epoch_start"].append(
                (start, len(self.probe["step_ends"])))
            t0 = time.perf_counter()
            out = super().train_one_epoch(epoch, preempted)
            torch.cuda.synchronize()
            self.probe["epoch_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        def val_one_epoch(self, epoch):
            self.probe["val_labelled"].append(0)
            n0 = self.probe["eval_batches"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.probe["in_val"] = True
            try:
                out = super().val_one_epoch(epoch)
            finally:
                self.probe["in_val"] = False
            torch.cuda.synchronize()
            self.probe["val_ms"].append((time.perf_counter() - t0) * 1e3)
            self.probe["val_batches"].append(self.probe["eval_batches"] - n0)
            self.probe["val_confusion"].append(
                float(self.metrics.confusion_matrix.sum()))
            return out

        def _vote_epoch(self, smooth):
            if len(self.probe["vote_ms"]) >= VOTE_MAX_PASSES:
                raise RuntimeError(f"{label}: no coverage after "
                                   f"{VOTE_MAX_PASSES} vote passes")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._vote_epoch(smooth)
            torch.cuda.synchronize()
            self.probe["vote_ms"].append((time.perf_counter() - t0) * 1e3)

    Probed.made = made
    return Probed


def spread_ms(times: list) -> dict:
    """The median, quartiles and range of a list of ms."""
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {"n": len(times), "median": float(med), "q1": float(q1),
            "q3": float(q3), "min": float(min(times)),
            "max": float(max(times))}


def step_overhead(trainer_ms: list, plain_ms: list) -> dict:
    """The Trainer's step ms less a plain loop's on the same batches, by
    their medians; resolved only where the two interquartile ranges do
    not overlap."""
    a, b = spread_ms(trainer_ms), spread_ms(plain_ms)
    return {"trainer": a, "plain": b,
            "overhead_ms": a["median"] - b["median"],
            "resolved": a["q1"] > b["q3"] or b["q1"] > a["q3"]}


def step_event_ms(probe: dict, epoch: int, steps: int = TRAINER_STEPS
                  ) -> list:
    """The event ms of each of the ``steps`` steps of ``epoch``: from the
    epoch's start (or the previous step's end) to the step's end, the
    batch's wait included."""
    start, first = probe["epoch_start"][epoch]
    ends = probe["step_ends"][first:first + steps]
    marks = [start] + ends
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def run_cli(argv, cls):
    """``main(argv)`` of crfconv_tpu_torch.train in this process, with its
    Trainer class ``cls`` (a ``probed_trainer``); returns (the result, the
    trainer)."""
    from crfconv_tpu_torch.train import __main__ as cli

    with patched([(cli, "Trainer", cls)]):
        result = cli.main(argv)
    return result, cls.made[-1]


def trainer_checks(label: str, trainer, step_calls: dict, val_per: dict):
    """The recorded calls' counts, every loss finite, each val epoch's
    confusion summing to its labelled points, the checkpoints written."""
    probe = trainer.probe
    for name, got in probe["calls"]["step"].items():
        expect(len(got) == step_calls.get(name, 0), f"{label} {name}: "
               f"{len(got)} calls in the recorded step, expected "
               f"{step_calls.get(name, 0)}")
    for name, got in probe["calls"]["eval"].items():
        expect(len(got) == val_per.get(name, 0), f"{label} {name}: "
               f"{len(got)} calls in the recorded eval batch, expected "
               f"{val_per.get(name, 0)}")
    losses = [float(v) for v in probe["losses"]]
    expect(bool(losses) and all(np.isfinite(losses)),
           f"{label}: losses {losses}")
    for conf, n in zip(probe["val_confusion"], probe["val_labelled"]):
        expect(conf == n and n > 0, f"{label}: a val confusion sums to "
               f"{conf}, its batches carry {n} labelled points")
    ck = trainer.ckpt
    latest, best = ck.latest_path(), ck.best_path()
    expect(latest is not None and os.path.exists(latest)
           and best is not None and os.path.exists(best)
           and ck.restore_aux() is not None,
           f"{label}: latest {latest}, best {best} or the sidecar missing")
    return losses


def vote_result_ok(res: dict) -> bool:
    """A labeled vote test's result: sub-cloud and full-cloud mIoU and the
    overall accuracy, each in [0, 1] (an empty result fails)."""
    keys = ("sub_mIoU", "full_mIoU", "Overall Acc")
    return bool(res) and all(
        k in res and np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0
        for k in keys)


def samples_equal(a: list, b: list) -> bool:
    """Two lists of sampler draws (dicts of arrays) equal bit for bit."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def trainer_s3dis_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 29: S3DIS through ``python -m crfconv_tpu_torch.train``
    (``main`` in this process): the rooms of phase 27 (Area_5 the val
    area), S3DISConfig's full-width flagship at B8 x 8192, windowed with
    packed kNN and the 2-view val; TRAINER_EPOCHS epochs of TRAINER_STEPS
    steps and TRAINER_VAL_BATCHES val batches (the main path: the launch
    counts set to 0 before the run and read after), a recorded step and val
    batch held against the plain versions, a Trainer resumed from the last
    checkpoint drawing what the live one draws and stepping bit-identically,
    a profiled Trainer step, then ``--mode test`` (the labeled vote test on
    the best checkpoint, its own main path)."""
    import tempfile

    from crfconv_tpu_torch import cuda_build
    from crfconv_tpu_torch.train.trainer import Trainer

    step_sites, eval_sites = train_call_sites(), call_sites()
    cls = probed_trainer("trainer s3dis", step_sites, eval_sites,
                         TWO_VIEW_PER_EVAL)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        root = os.path.join(tmp, "s3dis")
        write_s3dis_rooms(root, np.random.default_rng(SEED + 27))
        common = [
            "--dataset", "S3DIS", "--root", root, "--device", str(dev),
            "--seed", str(SEED), "--epochs", str(TRAINER_EPOCHS),
            "--batch-size", str(B), "--set", f"sample_num={N}",
            "--set", f"checkpoint_dir={os.path.join(tmp, 'ckpt')}",
            "--set", f"train_samples_per_epoch={TRAINER_STEPS * B}",
            "--set", f"val_samples_per_epoch={TRAINER_VAL_BATCHES * B}",
        ]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        best, live = run_cli(common + ["--mode", "train"], cls)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = cuda_build.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        cfg = live.cfg
        expect(cfg.sample_num == N and cfg.eval_views == 2
               and live.mode.windowed and not live.mode.knn_exact
               and cfg.model_name == "PointConvBig" and cfg.use_crf
               and cfg.steps == 1, f"trainer s3dis: config {cfg}")
        n_steps = TRAINER_EPOCHS * TRAINER_STEPS
        n_val = TRAINER_EPOCHS * TRAINER_VAL_BATCHES
        record_launches("trainer s3dis", counts, {
            k: n_steps * S3DIS_LOADER_PER_STEP.get(k, 0)
            + n_val * TWO_VIEW_PER_EVAL.get(k, 0) for k in REPLACES}, 1,
            "runs")
        losses = trainer_checks("trainer s3dis", live, S3DIS_LOADER_PER_STEP,
                                TWO_VIEW_PER_EVAL)
        expect(0.0 <= best <= 1.0, f"trainer s3dis: best mIoU {best}")
        probe = live.probe
        hold_calls("trainer s3dis train", step_sites, probe["calls"]["step"])
        hold_calls("trainer s3dis val", eval_sites, probe["calls"]["eval"])
        probe["calls"] = {"step": None, "eval": None}   # held; not again
        torch.cuda.empty_cache()
        # every step but each epoch's first (whose wait holds the epoch's
        # loader start): event ms, the wait for the batch in it
        steps_ms = [t for e in range(TRAINER_EPOCHS)
                    for t in step_event_ms(probe, e)[1:]]
        step_ms = statistics.median(steps_ms)
        epoch_ms = probe["epoch_ms"][-1]
        val_ms = probe["val_ms"][-1] / probe["val_batches"][-1]

        # a second trainer resumed from the last checkpoint draws what the
        # live one draws next, and its next step is bit-identical
        resumed = Trainer(cfg, seed=SEED, device=dev)
        start = resumed.resume()
        expect(start == TRAINER_EPOCHS, f"trainer s3dis: resumed at epoch "
               f"{start}")
        same_rng = torch.equal(resumed.rng.get_state(), live.rng.get_state())
        draws = [[t.train_loader.dataset.get_sample(t.train_loader.rng)
                  for _ in range(B)] for t in (live, resumed)]
        same_draws = samples_equal(*draws)
        batch = next(iter(resumed.train_loader))
        m_live = live.plain_step(live.state, batch, live.rng)
        m_res = resumed._train_step(resumed.state, batch, resumed.rng)
        a, b = live.state.model.state_dict(), resumed.state.model.state_dict()
        same_step = bool(torch.equal(m_live["loss"], m_res["loss"])) and all(
            torch.equal(a[n], b[n]) for n in a)
        expect(same_rng and same_draws and same_step, "trainer s3dis "
               f"resume: generator {same_rng}, draws {same_draws}, step "
               f"{same_step} not the live trainer's")
        print(f"# trainer s3dis resume: at epoch {start}, generator state "
              f"equal {same_rng}, {B} draws bit-equal {same_draws}, next "
              f"step loss {float(m_res['loss']):.6f} and parameters "
              f"bit-identical {same_step}", flush=True)
        del resumed, a, b, draws

        # the driver's own cost: on batches placed on the card beforehand
        # (the loader's thread stopped), the plain step in a loop and the
        # Trainer's epoch in turns (plain, Trainer, Trainer, plain)
        loader = live.train_loader
        batches = endless(loader)
        placed = [next(batches) for _ in range(TRAINER_STEPS)]
        batches.close()
        live.train_loader = placed

        def trainer_round():
            live.train_one_epoch(len(probe["epoch_start"]))
            return step_event_ms(probe, len(probe["epoch_start"]) - 1)

        def plain_round():
            return timed_steps(live.state, live.plain_step, iter(placed),
                               TRAINER_STEPS, dev, 60)[0]

        loop_ms = plain_round()
        placed_ms = trainer_round() + trainer_round()
        loop_ms += plain_round()
        live.train_loader = loader

        batches = endless(loader)
        profile, busy = profile_phase(
            "trainer s3dis profiler",
            lambda: live.plain_step(live.state, next(batches), live.rng),
            os.path.join(out_dir, "chip_smoke_trainer_s3dis_trace.json"),
            "step", step_ms)
        batches.close()
        del live, batch
        torch.cuda.empty_cache()

        # --mode test: the vote test on the best checkpoint
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res, tester = run_cli(common + ["--mode", "test"], cls)
        except RuntimeError as e:      # no coverage within the cap
            expect(False, str(e))
            res, tester = {}, None
        test_s = time.perf_counter() - t0
        counts = cuda_build.launch_counts()
        best_step = (tester.ckpt._load_meta()["best"]["step"]
                     if tester is not None else None)
    expect(vote_result_ok(res), f"trainer s3dis test: vote result {res}")
    passes = len(tester.probe["vote_ms"]) if tester is not None else 0
    if tester is not None:
        expect(tester.state.step == best_step, "trainer s3dis test: voted "
               f"with the state of step {tester.state.step}, the best "
               f"checkpoint's is {best_step}")
        record_launches("trainer s3dis test", counts, only(TWO_VIEW_PER_EVAL),
                        tester.probe["eval_batches"], "eval batches")
        hold_calls("trainer s3dis test", eval_sites,
                   tester.probe["calls"]["eval"])
    vote_ms = (statistics.median(tester.probe["vote_ms"])
               if passes else float("nan"))
    scores = {k: res.get(k) for k in ("sub_mIoU", "full_mIoU", "Overall Acc")}
    del tester
    torch.cuda.empty_cache()
    print(f"# trainer s3dis ({CARD}): {TRAINER_EPOCHS} epochs of "
          f"{TRAINER_STEPS} steps + {TRAINER_VAL_BATCHES} val batches in "
          f"{train_s:.2f} s; last epoch {epoch_ms:.3f} ms "
          f"({TRAINER_STEPS / epoch_ms * 1e3:.3f} steps/s), median step "
          f"{step_ms:.3f} ms (events), val {val_ms:.3f} ms a batch; losses "
          f"{[round(v, 5) for v in losses]}; best mIoU {best:.4f}; peak "
          f"{peak_gb:.2f} GiB; vote test {passes} passes in {test_s:.2f} s "
          f"({vote_ms:.3f} ms a pass): {scores}", flush=True)
    return {"epochs": TRAINER_EPOCHS, "steps_per_epoch": TRAINER_STEPS,
            "val_batches": TRAINER_VAL_BATCHES, "train_s": train_s,
            "epoch_ms": epoch_ms,
            "steps_per_s": TRAINER_STEPS / epoch_ms * 1e3,
            "step_ms": step_ms, "steps_ms": steps_ms,
            "placed_steps_ms": placed_ms, "loop_steps_ms": loop_ms,
            "val_ms_a_batch": val_ms, "losses": losses,
            "best_miou": best, "peak_gib": peak_gb, "vote_passes": passes,
            "vote_ms_a_pass": vote_ms, "test_s": test_s,
            "vote_result": {k: v for k, v in res.items() if k != "full_IoUs"},
            "resume": {"rng": same_rng, "draws": same_draws,
                       "step": same_step},
            "kernel_busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "profile": profile[:40],
            "calls_per_step": only(S3DIS_LOADER_PER_STEP),
            "calls_per_val_batch": only(TWO_VIEW_PER_EVAL)}


def trainer_shapenet_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 30: ShapeNet through the CLI: the shapes of phase 28,
    ShapeNetConfig's CRFSegNet_Part(50, steps=10) at B16 x 2048, windowed
    with curve jitter, one epoch and its 2-view val (the main path), a
    recorded step (K1, K2, K8-K12, K15) and val batch (K1, K2, K9, K10)
    held against the plain versions, then ``eval_partseg``."""
    import tempfile

    from crfconv_tpu_torch import cuda_build

    crf_sites = crf_call_sites()
    step_sites = {**train_call_sites(), **crf_sites}
    eval_sites = {k: v for k, v in call_sites().items()
                  if k in ("windowed_gather", "window_knn")}
    eval_sites.update((k, crf_sites[k]) for k in ("crf_operator",
                                                  "crf_iterate"))
    cls = probed_trainer("trainer shapenet", step_sites, eval_sites,
                         SHAPENET_VAL_PER_BATCH, snapshot=tuple(crf_sites))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        root = os.path.join(tmp, "shapenet")
        write_shapenet_shapes(root, np.random.default_rng(SEED + 28))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        best, tr = run_cli([
            "--dataset", "ShapeNet", "--root", root, "--device", str(dev),
            "--seed", str(SEED), "--epochs", "1", "--mode", "train",
            "--batch-size", str(TRAINER_SHAPENET_BATCH),
            "--set", "curve_jitter=1",
            "--set", f"checkpoint_dir={os.path.join(tmp, 'ckpt')}"], cls)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = cuda_build.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        cfg = tr.cfg
        expect(cfg.batch_size == 16 == TRAINER_SHAPENET_BATCH
               and cfg.sample_num == 2048
               and cfg.steps == 10 and cfg.curve_jitter
               and cfg.model_name == "CRFSegNet_Part" and tr.mode.windowed,
               f"trainer shapenet: config {cfg}")
        n_steps = len(tr.probe["losses"])
        n_val = tr.probe["val_batches"][0]
        expect(n_steps >= 2 and n_val >= 1, f"trainer shapenet: {n_steps} "
               f"steps, {n_val} val batches")
        record_launches("trainer shapenet", counts, {
            k: n_steps * SCANNET_PER_STEP.get(k, 0)
            + n_val * SHAPENET_VAL_PER_BATCH.get(k, 0) for k in REPLACES}, 1,
            "runs")
        losses = trainer_checks("trainer shapenet", tr, SCANNET_CALLS_PER_STEP,
                                SHAPENET_VAL_PER_BATCH)
        hold_calls("trainer shapenet train", step_sites,
                   tr.probe["calls"]["step"])
        hold_calls("trainer shapenet val", eval_sites,
                   tr.probe["calls"]["eval"])
        tr.probe["calls"] = {"step": None, "eval": None}
        torch.cuda.empty_cache()
        epoch_ms = tr.probe["epoch_ms"][0]
        val_ms = tr.probe["val_ms"][0] / n_val
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part = tr.eval_partseg()
        torch.cuda.synchronize()
        part_ms = (time.perf_counter() - t0) * 1e3
    expect(0.0 <= part["pIoU"] <= 1.0 and 0.0 <= part["mpIoU"] <= 1.0,
           f"trainer shapenet: part IoU {part['pIoU']}, {part['mpIoU']}")
    print(f"# trainer shapenet ({CARD}): 1 epoch of {n_steps} steps at "
          f"B{cfg.batch_size}x{cfg.sample_num} with curve jitter + {n_val} "
          f"val batch(es) in {train_s:.2f} s; epoch {epoch_ms:.3f} ms "
          f"({n_steps / epoch_ms * 1e3:.3f} steps/s), val {val_ms:.3f} ms a "
          f"batch; losses {[round(v, 5) for v in losses]}; eval_partseg "
          f"{part_ms:.3f} ms: pIoU {part['pIoU']:.4f}, mpIoU "
          f"{part['mpIoU']:.4f}; peak {peak_gb:.2f} GiB", flush=True)
    del tr
    torch.cuda.empty_cache()
    return {"steps": n_steps, "val_batches": n_val, "train_s": train_s,
            "epoch_ms": epoch_ms, "steps_per_s": n_steps / epoch_ms * 1e3,
            "val_ms_a_batch": val_ms, "losses": losses, "best_miou": best,
            "eval_partseg_ms": part_ms, "pIoU": part["pIoU"],
            "mpIoU": part["mpIoU"], "peak_gib": peak_gb,
            "calls_per_step": only(SCANNET_PER_STEP),
            "calls_per_val_batch": only(SHAPENET_VAL_PER_BATCH)}


def bf16_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 31: the bf16 compute mode on the full-width flagship at B8 x
    8192: a request through Predictor and a train step, under
    ``compute_dtype_scope(torch.bfloat16)`` and in float32, from the same
    weights, pyramid offsets and dropout seed: the same launch counts, each
    kernel call of the bf16 request and step held against its plain
    version (widened, as the wrappers widen), the median |logit|
    difference from float32 below 0.1, the loss float32 and finite, the
    parameters float32, the scope restored; both modes' ms."""
    from crfconv_tpu_torch import (
        Predictor, compute_dtype_scope, cuda_build, get_compute_dtype,
        make_train_step,
    )
    from crfconv_tpu_torch.train.train_state import TRAIN_MODE

    pos, feats = request(rng, dev)
    raw = train_batch(rng, dev)
    step = make_train_step(TRAIN_MODE)
    serve_sites, train_sites = call_sites(), train_call_sites()
    out = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        predictor = Predictor(make_model(dev), device=dev, seed=SEED)
        state = make_train_state(dev)
        with compute_dtype_scope(dtype):
            calls = record_calls(serve_sites, lambda: predictor.predict_logits(
                pos, feats))
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
            logits = predictor.predict_logits(pos, feats)
            serve_counts = cuda_build.launch_counts()
            request_ms = median_ms(
                lambda: predictor.predict_logits(pos, feats), runs=5,
                warmup=1)
            batch, _ = predictor.prepare(pos, feats)
            with torch.inference_mode():
                forward_ms = median_ms(lambda: predictor.model(
                    batch, predictor.mode), runs=5, warmup=1)
            del batch
            tcalls = record_calls(train_sites, lambda: step(
                state, raw, step_generator(dev, 500)))
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
            m = step(state, raw, step_generator(dev, 501))
            step_counts = cuda_build.launch_counts()
            loss = m["loss"]
            step_ms = median_ms(lambda: step(state, raw, step_generator(
                dev, 502)), runs=3, warmup=1)
        expect(get_compute_dtype() is None,
               f"bf16 phase: the compute dtype leaked ({get_compute_dtype()})")
        if dtype is not None:
            record_launches("bf16 serve", serve_counts, only(
                EXPECTED_PER_REQUEST), 1, "requests")
            record_launches("bf16 train", step_counts, only(EXPECTED_PER_STEP),
                            1, "steps")
            hold_calls("bf16 serve", serve_sites, calls)
            hold_calls("bf16 train", train_sites, tcalls)
        del calls, tcalls
        params = list(state.model.parameters())
        expect(loss.dtype == torch.float32 and bool(torch.isfinite(loss))
               and all(p.dtype == torch.float32 for p in params),
               f"bf16 phase {label}: loss {loss} or a parameter not float32")
        out[label] = {"logits": logits.float(), "loss": float(loss),
                      "serve_counts": serve_counts, "step_counts": step_counts,
                      "request_ms": request_ms, "forward_ms": forward_ms,
                      "step_ms": step_ms}
        del predictor, state, m
        torch.cuda.empty_cache()
    f32, bf = out["f32"], out["bf16"]
    expect(f32["serve_counts"] == bf["serve_counts"]
           and f32["step_counts"] == bf["step_counts"],
           f"bf16 phase: launches {bf['serve_counts']}, {bf['step_counts']} "
           f"against float32's {f32['serve_counts']}, {f32['step_counts']}")
    diff = (bf["logits"] - f32["logits"]).abs()
    med, worst = float(diff.median()), float(diff.max())
    expect(med < 0.1, f"bf16 phase: median |dlogit| {med} from float32")
    agree = float((bf["logits"].argmax(-1) == f32["logits"].argmax(-1))
                  .float().mean())
    print(f"# bf16 phase ({CARD}): request {bf['request_ms']:.3f} ms "
          f"(float32 {f32['request_ms']:.3f}), forward {bf['forward_ms']:.3f} "
          f"ms (float32 {f32['forward_ms']:.3f}), train step "
          f"{bf['step_ms']:.3f} ms (float32 {f32['step_ms']:.3f}); logits "
          f"against float32: median |d| {med:.4g}, max {worst:.4g}, argmax "
          f"agreement {agree:.4f}; "
          f"loss {bf['loss']:.6f} (float32 {f32['loss']:.6f})", flush=True)
    return {"request_ms": bf["request_ms"],
            "f32_request_ms": f32["request_ms"],
            "forward_ms": bf["forward_ms"],
            "f32_forward_ms": f32["forward_ms"],
            "step_ms": bf["step_ms"], "f32_step_ms": f32["step_ms"],
            "median_abs_dlogit": med, "max_abs_dlogit": worst,
            "argmax_agreement": agree, "loss": bf["loss"],
            "f32_loss": f32["loss"],
            "calls_per_request": only(EXPECTED_PER_REQUEST),
            "calls_per_step": only(EXPECTED_PER_STEP)}


# --------------------------------------------------------------------------
# the parity harness and the utils
# --------------------------------------------------------------------------

PARITY_ROOMS = 2             # rooms an area of the phase's synthetic corpus
PARITY_ROOM_POINTS = 40_000  # raw points a room
PARITY_EPOCHS = 2
PARITY_STEPS = 3             # train steps an epoch
PARITY_REPORT_KEYS = {"port_full_mIoU", "torch_full_mIoU", "delta",
                      "tolerance", "within_tolerance", "port", "torch",
                      "config"}


def probed_oracle(peaks: dict):
    """The parity harness's oracle class, instrumented: each instance is
    appended to the class's ``made``; each forward records (train or eval,
    a CUDA event, the host's clock) in ``marks`` and, where the input, the
    pyramid or a parameter is not on the card, the devices (each set
    once) in ``off_card``. Making one puts the peak device memory so far
    (the port arm's) in ``peaks["port"]`` and resets the peak."""
    from crfconv_tpu_torch.parity.oracle import TorchPointConvResNet

    made = []

    class Probed(TorchPointConvResNet):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
            self.marks, self.off_card = [], []
            peaks["port"] = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()

        def forward(self, x, scales):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(("train" if self.training else "eval", ev,
                               time.perf_counter()))
            tensors = ([x, *self.parameters()]
                       + [t for s in scales for t in s.values()
                          if t is not None])
            where = sorted({t.device.type for t in tensors})
            if where != ["cuda"] and where not in self.off_card:
                self.off_card.append(where)
            return super().forward(x, scales)

    Probed.made = made
    return Probed


def timed_vote_eval(passes: list):
    """``train.vote.labeled_vote_eval`` whose vote passes are timed (host
    clock between synchronisations; each arm's pass ms appended to a list
    of ``passes``); a pass beyond VOTE_MAX_PASSES raises."""
    from crfconv_tpu_torch.train import vote

    inner = vote.labeled_vote_eval

    def wrapper(ds, vote_epoch_fn, test_probs, num_votes=100, **kw):
        ms = []
        passes.append(ms)

        def timed_pass():
            if len(ms) >= VOTE_MAX_PASSES:
                raise RuntimeError(f"no coverage after {VOTE_MAX_PASSES} "
                                   "vote passes")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vote_epoch_fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)

        return inner(ds, timed_pass, test_probs, num_votes, **kw)

    return wrapper


def oracle_times(marks: list, steps: int, val_batches: int) -> dict:
    """The oracle arm's times from its forwards' marks: each step's event
    ms (one train forward's start to the next's in an epoch, the batch's
    wait included), each epoch's ms (its first train forward to its first
    val forward, host clock) and each val batch's (an epoch's val forwards
    to the next epoch's first train forward, host clock, over the
    batches)."""
    epochs, i = [], 0
    while i < len(marks) and marks[i][0] == "train":
        train = marks[i:i + steps]
        val = marks[i + steps:i + steps + val_batches]
        nxt = marks[i + steps + val_batches:i + steps + val_batches + 1]
        epochs.append((train, val, nxt))
        i += steps + val_batches
    step_ms = [a[1].elapsed_time(b[1]) for train, _, _ in epochs
               for a, b in zip(train, train[1:])]
    epoch_ms = [(val[0][2] - train[0][2]) * 1e3 for train, val, _ in epochs
                if val]
    val_ms = [(nxt[0][2] - val[0][2]) * 1e3 / val_batches
              for _, val, nxt in epochs if val and nxt and nxt[0][0]
              == "train"]
    return {"epochs": len(epochs), "steps_ms": step_ms,
            "step_ms": statistics.median(step_ms) if step_ms else None,
            "epoch_ms": epoch_ms, "val_ms_a_batch": val_ms}


@contextlib.contextmanager
def env_var(name: str, value: str):
    """``os.environ[name]`` set to ``value`` for the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def parity_report_ok(label: str, report: dict) -> None:
    """The report's keys, each arm's mIoUs in [0, 1], the delta their
    difference and the tolerance flag its test."""
    expect(set(report) == PARITY_REPORT_KEYS, f"{label}: report keys "
           f"{sorted(report)}")
    if set(report) != PARITY_REPORT_KEYS:
        return
    for arm in ("port", "torch"):
        expect(vote_result_ok(report[arm])
               and report[f"{arm}_full_mIoU"] == report[arm]["full_mIoU"],
               f"{label}: the {arm} arm's result {report[arm]}")
    expect(report["delta"] == report["port_full_mIoU"]
           - report["torch_full_mIoU"] and report["within_tolerance"]
           == (abs(report["delta"]) <= report["tolerance"]),
           f"{label}: delta {report['delta']}, within "
           f"{report['within_tolerance']}")


def parity_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 32: the parity harness, ``main([...])`` of
    crfconv_tpu_torch.parity.__main__ in this process, both arms on the
    card: a synthetic room corpus (PARITY_ROOMS rooms an area of
    PARITY_ROOM_POINTS points) and S3DISConfig's full-width flagship
    (use_crf, steps 1, B8 x 8192, windowed, 2-view val) through
    ``--scale-kw``: PARITY_EPOCHS epochs of PARITY_STEPS steps and
    TRAINER_VAL_BATCHES val batches, patience 1, 2 votes. The port arm's
    launch counts (the main path: set to 0 before the run, read after; the
    oracle arm launches none), a recorded step and val batch held against
    the plain versions; the oracle and its inputs on the card; the report.
    Then the arms once more as separate calls (CRFCONV_PARITY_ARM port,
    then torch): the combining call's report carries both files."""
    import tempfile

    from crfconv_tpu_torch import cuda_build
    from crfconv_tpu_torch.data.datasets import S3DISRoomDataset
    from crfconv_tpu_torch.parity import __main__ as parity_cli
    from crfconv_tpu_torch.parity import oracle
    from crfconv_tpu_torch.parity.synthetic import make_synthetic_rooms
    from crfconv_tpu_torch.train import trainer as trainer_mod
    from crfconv_tpu_torch.train import vote

    step_sites, eval_sites = train_call_sites(), call_sites()
    cls = probed_trainer("parity port", step_sites, eval_sites,
                         TWO_VIEW_PER_EVAL)
    peaks, passes = {}, []
    ocls = probed_oracle(peaks)
    scale_kw = {"sample_num": N, "batch_size": B, "use_crf": True,
                "steps": 1, "neighbor_regime": "windowed", "eval_views": 2,
                "train_samples_per_epoch": PARITY_STEPS * B,
                "val_samples_per_epoch": TRAINER_VAL_BATCHES * B}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as tmp:
        root = os.path.join(tmp, "rooms")
        t0 = time.perf_counter()
        raw_points = make_synthetic_rooms(
            root, rooms_per_area=PARITY_ROOMS,
            pts_per_room=PARITY_ROOM_POINTS, seed=SEED)
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        S3DISRoomDataset(root, grid_size=0.04, num_points=N)
        parse_s = time.perf_counter() - t0
        argv = ["--root", root, "--corpus", "rooms",
                "--rooms-per-area", str(PARITY_ROOMS),
                "--pts-per-room", str(PARITY_ROOM_POINTS),
                "--epochs", str(PARITY_EPOCHS), "--patience", "1",
                "--num-votes", "2", "--seed", str(SEED),
                "--device", str(dev), "--scale-kw", json.dumps(scale_kw)]
        probes = [(trainer_mod, "Trainer", cls),
                  (oracle, "TorchPointConvResNet", ocls),
                  (vote, "labeled_vote_eval", timed_vote_eval(passes))]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with patched(probes), env_var("CRFCONV_PARITY_ARM", "both"):
                report = parity_cli.main(argv + [
                    "--out", os.path.join(out_dir, "chip_smoke_parity.json")])
        except RuntimeError as e:     # no vote coverage within the cap
            expect(False, f"parity: {e}")
            report = {}
        torch.cuda.synchronize()
        both_s = time.perf_counter() - t0
        counts = cuda_build.launch_counts()
        peaks["torch"] = torch.cuda.max_memory_allocated() / 2 ** 30
        port, orc = cls.made[-1], ocls.made[-1] if ocls.made else None
        probe = port.probe
        n_steps = len(probe["losses"])
        expect(n_steps == PARITY_EPOCHS * PARITY_STEPS
               and probe["val_batches"] == [TRAINER_VAL_BATCHES]
               * PARITY_EPOCHS, f"parity port: {n_steps} steps, val "
               f"batches {probe['val_batches']}")
        cfg = port.cfg
        expect(cfg.sample_num == N and cfg.batch_size == B
               and cfg.eval_views == 2 and port.mode.windowed
               and cfg.model_name == "PointConvBig" and cfg.use_crf
               and cfg.steps == 1, f"parity port: config {cfg}")
        # every launch of the run is the port arm's: the oracle runs none
        record_launches("parity port", counts, {
            k: n_steps * S3DIS_LOADER_PER_STEP.get(k, 0)
            + probe["eval_batches"] * TWO_VIEW_PER_EVAL.get(k, 0)
            for k in REPLACES}, 1, "runs")
        trainer_checks("parity port", port, S3DIS_LOADER_PER_STEP,
                       TWO_VIEW_PER_EVAL)
        hold_calls("parity port train", step_sites, probe["calls"]["step"])
        hold_calls("parity port val", eval_sites, probe["calls"]["eval"])
        probe["calls"] = {"step": None, "eval": None}
        expect(orc is not None and orc.marks and not orc.off_card,
               "parity torch: the oracle ran off the card "
               f"{orc.off_card if orc is not None else 'never'}")
        parity_report_ok("parity", report)
        port_steps = [t for e in range(len(probe["epoch_start"]))
                      for t in step_event_ms(probe, e, PARITY_STEPS)[1:]]
        port_t = {
            "epoch_ms": probe["epoch_ms"], "steps_ms": port_steps,
            "step_ms": statistics.median(port_steps),
            "val_ms_a_batch": [v / n for v, n in zip(probe["val_ms"],
                                                     probe["val_batches"])],
            "vote_ms": passes[0] if passes else []}
        orc_t = oracle_times(orc.marks if orc is not None else [],
                             PARITY_STEPS, TRAINER_VAL_BATCHES)
        orc_t["vote_ms"] = passes[1] if len(passes) > 1 else []
        del port, orc, probe
        cls.made.clear()
        ocls.made.clear()
        torch.cuda.empty_cache()

        # the arms once more, as separate calls in the same root
        for f in ("parity_port.json", "parity_torch.json"):
            os.remove(os.path.join(root, f))
        t0 = time.perf_counter()
        with patched(probes):
            with env_var("CRFCONV_PARITY_ARM", "port"):
                first = parity_cli.main(argv)
            with env_var("CRFCONV_PARITY_ARM", "torch"):
                split = parity_cli.main(argv)
        split_s = time.perf_counter() - t0
        files = {}
        for arm in ("port", "torch"):
            with open(os.path.join(root, f"parity_{arm}.json")) as fh:
                files[arm] = json.load(fh)
    expect(first.get("pending") == "torch" and "torch" not in first,
           f"parity split: the port call returned {sorted(first)}")
    parity_report_ok("parity split", split)
    expect(split.get("port") == files["port"]
           and split.get("torch") == files["torch"],
           "parity split: the report does not carry the arms' files")
    same = {arm: {k: v for k, v in split.get(arm, {}).items()
                  if k != "wall_s"}
            == {k: v for k, v in report.get(arm, {}).items()
                if k != "wall_s"} for arm in ("port", "torch")}
    cls.made.clear()
    ocls.made.clear()

    def fmt(t):
        med = (lambda v: f"{statistics.median(v):.3f}" if v else "n/a")
        return (f"epoch {med(t['epoch_ms'])} ms, step {t['step_ms']:.3f} ms "
                f"(events, median of {len(t['steps_ms'])}), val "
                f"{med(t['val_ms_a_batch'])} ms a batch, vote "
                f"{med(t['vote_ms'])} ms a pass ({len(t['vote_ms'])} passes)"
                if t["step_ms"] is not None else "no steps")

    print(f"# parity ({CARD}): corpus {raw_points} raw points written in "
          f"{corpus_s:.2f} s, parsed in {parse_s:.2f} s; both arms in "
          f"{both_s:.2f} s, the split calls in {split_s:.2f} s", flush=True)
    print(f"# parity port arm (the flagship, windowed, 2-view val; peak "
          f"{peaks.get('port', float('nan')):.2f} GiB): {fmt(port_t)}; "
          f"full mIoU {report.get('port_full_mIoU')}", flush=True)
    print(f"# parity torch arm (the oracle, exact host pyramid; peak "
          f"{peaks['torch']:.2f} GiB): {fmt(orc_t)}; full mIoU "
          f"{report.get('torch_full_mIoU')}", flush=True)
    orc_step = orc_t["step_ms"]
    orc_step = "n/a" if orc_step is None else f"{orc_step:.3f}"
    print(f"# parity: B{B}x{N} step, port {port_t['step_ms']:.3f} ms "
          f"(windowed) beside the oracle's {orc_step} ms (exact host "
          f"pyramid): a yardstick, not like for like; "
          f"delta {report.get('delta')}; the split calls' results equal "
          f"the combined run's {same}", flush=True)
    return {"raw_points": raw_points, "corpus_s": corpus_s,
            "parse_s": parse_s, "both_s": both_s, "split_s": split_s,
            "port": port_t, "torch": orc_t, "peak_gib": peaks,
            "report": {k: v for k, v in report.items()
                       if k not in ("port", "torch")},
            "arm_results": {arm: {k: v for k, v in report.get(arm, {}).items()
                                  if k != "full_IoUs"}
                            for arm in ("port", "torch")},
            "split_equal_to_combined": same,
            "calls_per_step": only(S3DIS_LOADER_PER_STEP),
            "calls_per_val_batch": only(TWO_VIEW_PER_EVAL)}


UTILS_ITERS = 5     # device_time's n: 1 + 9n requests a mode


def utils_phase(dev, rng, out_dir: str, results: dict) -> dict:
    """Phase 33: the utils on the card. ``device_time`` of the flagship's
    request (phase 4's model and batch) in both modes beside ``median_ms``
    of the same request; ``profiling.trace`` around requests writes a trace
    naming K1's device function; ``StepTimer`` over 5 synchronised
    requests."""
    import glob
    import tempfile

    from crfconv_tpu_torch import Predictor
    from crfconv_tpu_torch.utils import device_time
    from crfconv_tpu_torch.utils.profiling import StepTimer, trace

    model = make_model(dev)
    predictor = Predictor(model, device=dev, seed=SEED)
    pos, feats = request(rng, dev)

    def serve(carry, p):
        # the carry orders nothing the stream does not: the requests run
        # in turn on one stream
        return p.predict_logits(pos, feats)

    logits = predictor.predict_logits(pos, feats)
    times = {mode: device_time(serve, logits, iters=UTILS_ITERS, mode=mode,
                               env=predictor) * 1e3
             for mode in ("loop", "chain")}
    times["median_ms"] = median_ms(lambda: predictor.predict_logits(
        pos, feats), runs=10)
    expect(all(np.isfinite(v) and v > 0 for v in times.values()),
           f"utils: device_time and median_ms {times}")

    k1 = kernel_functions("windowed_gather")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        with trace(tmp):
            for _ in range(2):
                time.sleep(0.05)
                predictor.predict_logits(pos, feats)
                torch.cuda.synchronize()
            time.sleep(0.05)
        files = glob.glob(os.path.join(tmp, "*.json"))
        text = ""
        if len(files) == 1:
            with open(files[0]) as fh:
                text = fh.read()
        named = [f for f in k1 if f in text]
        trace_bytes = len(text)
    expect(len(files) == 1 and bool(named), f"utils: trace files {files}, "
           f"K1's functions {k1} named: {named}")

    timer = StepTimer(warmup_steps=1)
    for _ in range(6):
        predictor.predict_logits(pos, feats)
        torch.cuda.synchronize()
        timer.tick(B * N)
    summary = timer.summary()
    expect(summary["steps"] == 5 and np.isfinite(summary["points_per_sec"])
           and summary["points_per_sec"] > 0, f"utils: StepTimer {summary}")
    print(f"# utils ({CARD}): flagship request (B{B}x{N}) device_time loop "
          f"{times['loop']:.3f} ms, chain {times['chain']:.3f} ms, "
          f"median_ms {times['median_ms']:.3f} ms; trace of 2 requests "
          f"{trace_bytes} bytes naming {named}; StepTimer {summary}",
          flush=True)
    return {"device_time_ms": times, "trace_bytes": trace_bytes,
            "trace_names": named, "step_timer": summary}


def main() -> int:
    t_start = time.perf_counter()
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
    from crfconv_tpu_torch import NeighborMode, Predictor, cuda_build
    from crfconv_tpu_torch.serve import SERVING_MODE

    global EXACT, CARD
    EXACT = NeighborMode("exact")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    smi = CARD = smi_line()
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
    for name, got in calls.items():
        per = EXPECTED_PER_REQUEST[name]
        expect(len(got) == per,
               f"{name}: {len(got)} calls per request, expected {per}")

    # kernel phases: {kernel: [one phase per main path that calls it]}
    results = {}
    run_phases(results, "flagship serve", sites, calls)

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
    record_launches("flagship serve", cuda_build.launch_counts(),
                    EXPECTED_PER_REQUEST, REQUESTS, "requests")
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
    p_, f_ = reqs[0]

    def pyramid():
        return predictor.prepare(p_, f_)

    batch, _ = pyramid()
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
    # (~1e-6 relative per layer), carried through 20 layers; 4e-7 of the
    # largest logit was measured on the H100, so 1e-4 leaves a hundredfold
    expect(d_logit <= 1e-4 * scale,
           f"kernel vs plain forward: max |dlogit| {d_logit} (scale {scale})")
    expect(argmax_agree >= 0.999, f"argmax agreement {argmax_agree}")
    print(f"# forward kernels vs plain: max |dlogit| {d_logit:.3g} "
          f"(max |logit| {scale:.3g}), argmax agreement {argmax_agree}",
          flush=True)
    print(f"# one request: {request_ms:.3f} ms (pyramid {pyramid_ms:.3f} ms, "
          f"forward {forward_ms:.3f} ms; plain-version forward "
          f"{plain_forward_ms:.3f} ms)", flush=True)

    with torch.inference_mode():
        profile_rows, busy_ms = profile_phase(
            "profiler", lambda: predictor.predict_logits(p_, f_),
            os.path.join(out_dir, "chip_smoke_trace.json"), "request",
            request_ms,
        )

    paths = {}

    def run_path(key, fn):
        t0 = time.perf_counter()
        paths[key] = fn(dev, rng, out_dir, results)
        torch.cuda.empty_cache()
        seconds[key] = time.perf_counter() - t0
        print(f"# [{time.perf_counter() - t_start:.1f} s] {key} took "
              f"{seconds[key]:.1f} s", flush=True)

    seconds = {"flagship serve": time.perf_counter() - t_start}
    for key, fn in (("train", train_phases), ("scannet", scannet_phases),
                    ("discrete", discrete_phases),
                    ("semantic3d", semantic3d_phases),
                    ("exact", exact_phases), ("two_view", two_view_phase),
                    ("discrete_exact", discrete_exact_phase),
                    ("shapenet", shapenet_phases), ("kitti", kitti_phases),
                    ("scannet_exact", scannet_exact_phases),
                    ("discrete_exact_train", discrete_exact_train_phase),
                    ("s3dis_loader", s3dis_loader_phase),
                    ("shapenet_loader", shapenet_loader_phase),
                    ("trainer_s3dis", trainer_s3dis_phase),
                    ("trainer_shapenet", trainer_shapenet_phase),
                    ("bf16", bf16_phase), ("parity", parity_phase),
                    ("utils", utils_phase)):
        run_path(key, fn)
    # the driver's overhead a step: the Trainer's S3DIS steps against the
    # plain step's in a loop, in turns on the same placed batches,
    # resolved only where their spreads part; beside it the Trainer's
    # steps fed by the loader against phase 27's (the loader's queue and
    # the host's state between the phases in it, not the driver's alone)
    tr, ld = paths["trainer_s3dis"], paths["s3dis_loader"]
    overhead = step_overhead(tr["placed_steps_ms"], tr["loop_steps_ms"])
    fed_gap = step_overhead(tr["steps_ms"], ld["fed_steps_ms"]
                            + ld["fed_again_ms"])
    for what, o in (("on placed batches against the plain loop's", overhead),
                    ("fed by the loader against phase 27's", fed_gap)):
        print(f"# trainer s3dis steps {what}: {o['trainer']} against "
              f"{o['plain']} ms (median, quartiles, range): "
              f"{o['overhead_ms']:+.3f} ms a step, "
              f"{'resolved' if o['resolved'] else 'unresolved'} (the "
              f"interquartile ranges {'part' if o['resolved'] else 'overlap'}"
              f")", flush=True)

    # launches: the sum over the main paths (flagship serve and train,
    # ScanNet serve and train, ScanNet-discrete serve and train, Semantic3D
    # serve, flagship exact serve and train, the 2-view eval,
    # ScanNet-discrete exact serve; ShapeNet serve and train, SemanticKITTI
    # serve and train, ScanNet exact serve and train, ScanNet-discrete exact
    # train; S3DIS and ShapeNet training fed by the loader; the Trainer's
    # S3DIS run and vote test and its ShapeNet run; the bf16 request and
    # step; the parity harness's port arm). The times are those of the
    # first path whose calls were held against the plain version; every
    # path's are in "phases", the calls held outside a kernel phase in
    # "held_on", and max_abs_err is the largest over both
    kernels = []
    for name in REPLACES:
        phases = results[name]
        r = {k: v for k, v in phases[0].items()
             if k not in ("path", "calls", "max_abs_ref", "of_bound",
                          "host_split_us", "plan", "device_kernels",
                          "widths", "steps_vs_launches")}
        r["max_abs_err"] = max([p["max_abs_err"] for p in phases]
                               + [h["max_abs_err"]
                                  for h in HELD[name].values()])
        r["launches"] = sum(LAUNCHES[name].values())
        r["launches_by_path"] = LAUNCHES[name]
        r["timed_on"] = phases[0]["path"]
        if name in BIT_EQUAL:
            r["bit_equal"] = BIT_EQUAL[name]
        r["calls_per_run"] = phases[0]["calls"]
        r["held_on"] = HELD[name]
        r["phases"] = [
            {k: p[k] for k in ("path", "calls", "max_abs_err", "max_abs_ref",
                               "ms", "device_ms", "profiled_launches",
                               "host_us", "plain_ms", "bound_ms", "bound_by",
                               "library_ms",
                               "library_device_ms", "of_bound",
                               "host_split_us", "plan", "device_kernels",
                               "widths", "steps_vs_launches",
                               "step_bound_ms")}
            for p in phases
        ]
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
        "kernel_busy_ms": busy_ms,
        "profile": profile_rows[:40],
        **paths.pop("train"),
        **paths,
        "trainer_overhead": overhead,
        "trainer_fed_gap": fed_gap,
        "path_seconds": seconds,
        "path_units": UNITS,
        "gather_bwd_checks": {
            path: {"calls": c, "reruns_bit_identical": r,
                   "bit_equal_to_cpu_plain": e}
            for path, (c, r, e) in BWD_CHECKS.items()},
        "reverse_step_checks": {
            key: {"calls": c, "reruns_bit_identical": r, "cpu_checked": k,
                  "bit_equal_to_cpu_plain": e}
            for key, (c, r, k, e) in REVERSE_CHECKS.items()},
        "failures": FAILURES,
        "script_s": time.perf_counter() - t_start,
    }
    print(f"# chip_smoke.py took {summary['script_s']:.1f} s", flush=True)
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

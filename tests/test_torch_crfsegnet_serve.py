"""ScanNet's CRFSegNet (20 classes, 10 mean-field steps) served through
``Predictor`` with its configuration's pyramid (the 3-NN up-link), held to
the benchmark's plain reference (``portbench/reference/crfsegnet.py``) at
B2 x 1,024 on the CPU; a ``Predictor`` given no pyramid builds the
flagship's bit for bit; the ``crf`` span and ``profiling.crf_steps()``;
the point-sharded path takes the pyramid it is given and refuses one that
cannot be built."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from crfconv_tpu_torch import Predictor
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.parallel import spatial_build, spatial_forward
from crfconv_tpu_torch.parallel.sharding import Mesh
from crfconv_tpu_torch.utils import profiling
from portbench import checks, harness, rooms
from portbench.reference import crfsegnet
from tests.test_torch_ops import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
B, N = 2, 1024
CFG = {**json.loads(
    (ROOT / "portbench/configs/crfsegnet-scannet.json").read_text()),
    "batch_size": B, "sample_num": N}
PYRAMID = {"kernel_sizes": tuple(CFG["kernel_sizes"]),
           "ratios": tuple(CFG["ratios"]), "k_up": CFG["k_up"]}
# Both sides compute in float32 from the same pyramid and weights and
# differ only in the order of their sums (the fused core's plain version
# and the port's einsums against the reference's own sums), a few float32
# roundings through 10 contracting steps: 1.6e-7 read at this size. 1e-5 leaves that
# sixty times over, and the reference with TF32 products reads 5.7e-5 to
# 1.0e-4 of the same gap at this size, so a TF32 forward would fail.
GAP = 1e-5


def _request(seed: int):
    pos, feats, _ = rooms.make_clouds(seed, B, N, CFG["in_channels"],
                                      CFG["num_classes"], CFG["label_offset"])
    gen = torch.Generator().manual_seed(seed)
    offsets, n = [], N
    for r in CFG["ratios"]:
        offsets.append(torch.randint(0, r, (max(n // r, 1),), generator=gen))
        n = max(n // r, 1)
    return torch.as_tensor(pos), torch.as_tensor(feats), offsets


@pytest.fixture(scope="module")
def weights():
    return harness.make_weights(crfsegnet.param_spec(CFG), 23, "cpu")


@pytest.fixture(scope="module")
def model(weights):
    return harness.program_model(CFG, weights, "cpu")


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_served_scores_match_the_reference(model, weights, seed):
    pos, feats, offsets = _request(seed)
    pred = Predictor(model, device="cpu", **PYRAMID)
    batch, _ = pred.prepare(pos, feats, offsets)
    assert [s.up_idx.shape[-1] for s in batch.scales] == [3] * 5
    got = pred.predict_logits(pos, feats, offsets)
    want = checks.reference_logits(crfsegnet, weights, CFG, pos, feats,
                                   offsets)
    assert checks.served_gap(got, got.argmax(dim=-1), want) < GAP


def test_no_pyramid_arguments_build_the_flagship_pyramid(model):
    pos, feats, offsets = _request(3)
    batch, order = Predictor(model, device="cpu").prepare(pos, feats,
                                                          offsets)
    want_order, want = build_pyramid_windowed(
        pos, offsets=offsets, knn_exact=False, device="cpu")
    assert torch.equal(order, want_order)
    assert torch.equal(batch.x, torch.take_along_dim(feats, order[..., None],
                                                     dim=1))
    for got, w in zip(batch.scales, want, strict=True):
        for a, b in zip(got, w, strict=True):
            assert torch.equal(a, b)


def test_a_forward_runs_forty_steps_in_four_crf_spans(model, monkeypatch):
    pos, feats, offsets = _request(4)
    pred = Predictor(model, device="cpu", **PYRAMID)
    before = profiling.crf_steps()

    def refuse(*a, **k):
        raise AssertionError("made while tracing is off")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "Event", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        pred.predict_logits(pos, feats, offsets)
    assert profiling.crf_steps() == before      # off: nothing counted
    with profiling.tracing() as rec:
        pred.predict_logits(pos, feats, offsets)
    assert profiling.crf_steps() - before == 4 * CFG["steps"]
    crf = [s for s in rec.spans if s.name == "crf"]
    assert len(crf) == 4 and {s.parent.name for s in crf} == {"forward"}


def _mesh():
    return Mesh(world=2, rank=0, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("pyramid", [
    {"kernel_sizes": (16, 16, 16, 16), "ratios": (4, 4, 4, 4, 2)},
    {"ratios": (4, 4, 0, 4, 2)},
    {"k_up": 0},
])
def test_a_point_sharded_predictor_refuses_a_pyramid_it_cannot_build(
        model, pyramid):
    with pytest.raises(ValueError):
        Predictor(model, mesh=_mesh(), **pyramid)


def test_the_point_sharded_path_takes_the_pyramid(model, monkeypatch):
    seen = {}

    def build(pos, mesh, kernel_sizes, ratios, *, k_up, **kw):
        seen.update(kernel_sizes=kernel_sizes, ratios=ratios, k_up=k_up)
        raise RuntimeError("seen")

    def make(model, mesh, lengths, mode):
        seen["lengths"] = lengths
        return None, None

    monkeypatch.setattr(spatial_build, "build_pyramid_windowed_spatial",
                        build)
    monkeypatch.setattr(spatial_forward, "make_spatial_forward", make)
    ratios = (2, 4, 4, 4, 2)
    pred = Predictor(model, mesh=_mesh(), **{**PYRAMID, "ratios": ratios})
    pos, feats, offsets = _request(6)
    with pytest.raises(RuntimeError, match="seen"):
        pred.prepare_spatial(pos, feats, offsets)
    pred.spatial_forward(N)
    assert seen == {"kernel_sizes": PYRAMID["kernel_sizes"],
                    "ratios": ratios, "k_up": 3,
                    "lengths": set(spatial_build.pyramid_lengths(N, ratios))}

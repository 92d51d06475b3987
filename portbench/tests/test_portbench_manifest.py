"""``BENCHMARK.json`` against the files it names and the benchmark's
rules: names and units, the metrics each cell reports, the readers, the
import rule (no JAX, no JAX package, top-level names compared whole) and
the refusal to run without a card."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
FORBIDDEN = ("jax", "jaxlib", "flax", "crfconv_tpu")


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_cells_name_files_that_exist():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        harness.load_mix(w["traffic"])  # every key read by its loop
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        cfg = json.loads(path.read_text())
        assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
        for key in c["reduced"]:
            assert not re.search(r"(_dim|_rank|hidden|layers|width)$", key)
    assert {c["config"] for c in MANIFEST["workloads"]} == set(configs)


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in MANIFEST[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for cell in CELLS:
        assert reports(e2e["setup_s"], cell)
        assert sum(reports(m, cell) for m in e2e.values()) >= 2
        assert any(reports(m, cell) for m in MANIFEST["per_layer"])
    for m in MANIFEST["per_layer"]:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS and reports(e2e[m["moves"]], cell)


@pytest.mark.parametrize("extra", [{"clients": 4}, {"loop": "serve_closed",
                                                   "checked_steps": 3}])
def test_a_traffic_key_that_its_loop_does_not_read_is_refused(extra):
    with pytest.raises(SystemExit, match="not read"):
        harness.load_mix("serve_closed", extra)


def _kind(cell):
    w = {w["name"]: w for w in MANIFEST["workloads"]}[cell]
    return harness.load_mix(w["traffic"])[1].KIND


def test_a_metric_named_for_a_kind_is_read_in_cells_of_that_kind():
    for m in MANIFEST["per_layer"]:
        kind = m["name"].partition(".")[2]
        for cell in m.get("workloads", CELLS):
            assert kind in ("", _kind(cell)), (m["name"], cell)


def test_e2e_metrics_come_from_the_loops():
    src = "".join(p.read_text() for p in (BENCH / "mixes").glob("*.py"))
    for m in MANIFEST["end_to_end"]:
        assert f'"{m["name"]}"' in src, m["name"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _strings(path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant):
            docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_sources_import_no_jax_and_read_no_jax_benchmark():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
        if "tests" in path.parts:
            continue
        for text in _strings(path):
            assert not re.search(r"chip_smoke|bench\.py|benchmarks", text), \
                (path, text)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert not mod.startswith("crfconv_tpu"), (path, mod)


SETUP = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from portbench import harness
few = {{"serve": {{"pool": 2, "rooms": 2, "checked_requests": 1,
                  "warmup_requests": 1}},
       "train": {{"pool": 2, "rooms": 2}}}}
for cell in {cells!r}:
    harness.run(cell, 2**31 + 17, 0.05, False, "cpu",
                overrides={{"batch_size": 1, "sample_num": 1024}},
                mix_overrides=few[harness.load_cell(cell).loop.KIND])
bad = harness.forbidden_modules()
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_a_cpu_pass_of_each_mix_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", SETUP.format(root=str(ROOT), cells=CELLS)],
        capture_output=True, text=True, env=_env(), timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    assert "LOADED []" in out.stdout


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_exits_non_zero_without_a_card(trace):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", trace],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


NUMBERS = {"serve": {"served_gap"},
           "train": {"loss_gap", "loss_gap_first", "grad_gap",
                     "grad_gap_median", "update_gap", "update_gap_median"}}


def test_every_cell_has_limits_for_numbers_it_computes():
    for w in MANIFEST["workloads"]:
        kind = _kind(w["name"])
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and set(limits) <= NUMBERS[kind], w["name"]
        assert all(0 < v < 1 for v in limits.values())

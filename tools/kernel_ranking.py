#!/usr/bin/env python3
"""Rank the port's kernels by their device time above their bound over one
``chip_smoke.py`` run, every main path summed.

For each kernel and each main path whose calls ``chip_smoke.py`` held
against the plain version (a phase: one request, step or eval's calls),
the phase's device ms above its bound, max(device ms - bound ms, 0), times
the path's requests, steps or evals in its main-path run (``path_units``).
Paths that run a kernel without a phase of their own (the 2-view eval's
K2-K4) are not counted. Prints one row a kernel, largest first, with each
path's share, largest first, from the JSON that ``chip_smoke.py`` writes.

    python3 tools/kernel_ranking.py [chiprun_out/chip_smoke.json]
"""

from __future__ import annotations

import json
import sys


def ranking(summary: dict) -> list:
    """[(kernel, total ms above bound, {path: ms})], largest first."""
    units = summary["path_units"]
    rows = []
    for k in summary["kernels"]:
        by_path = {}
        for ph in k["phases"]:
            if ph["path"] in units and ph["device_ms"]:
                excess = max(ph["device_ms"] - ph["bound_ms"], 0.0)
                by_path[ph["path"]] = excess * units[ph["path"]]
        rows.append((k["name"], sum(by_path.values()), by_path))
    return sorted(rows, key=lambda r: -r[1])


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/chip_smoke.json"
    with open(path) as fh:
        summary = json.load(fh)
    print(f"# {summary['nvidia_smi']}: device ms above the bound, one run")
    for name, total, by_path in ranking(summary):
        shares = ", ".join(f"{p} {ms:.2f}" for p, ms in
                        sorted(by_path.items(), key=lambda kv: -kv[1]))
        print(f"{name:26s} {total:9.2f}  {shares}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its limits (`limits/<cell>.json`) and one
reader per metric (`metrics/<metric>.py`). Adding a cell, a mix or a metric
adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    params: dict  # the generator's parameters: the configuration's "data" under the mix
    limits: dict  # number -> limit (`reference/judge.py`)
    end_to_end: list[dict]  # BENCHMARK.json entries this cell reports
    per_layer: list[dict]


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reported(entries: list[dict], cell: str, end_to_end: list[dict] | None = None) -> list[dict]:
    """The entries a cell reports: those that list it under `workloads`, and
    those without the key: an end-to-end metric everywhere, a per-layer one
    wherever the end-to-end metric it moves is reported (`end_to_end`)."""
    moved = None if end_to_end is None else {m["name"] for m in end_to_end}
    return [m for m in entries
            if (cell in m["workloads"] if "workloads" in m else moved is None or m["moves"] in moved)]


def load_cell(name: str, root: str = ROOT) -> Cell:
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(sorted(cells))})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")) as f:
        mix = json.load(f)
    with open(os.path.join(BENCH_DIR, "limits", f"{name}.json")) as f:
        limits = json.load(f)["limits"]
    params = {**config["data"], **mix["params"]}
    end_to_end = _reported(man["end_to_end"], name)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        params=params,
        limits=limits,
        end_to_end=end_to_end,
        per_layer=_reported(man["per_layer"], name, end_to_end),
    )


def reader(metric: str):
    """The `read(ctx)` function of `metrics/<metric>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

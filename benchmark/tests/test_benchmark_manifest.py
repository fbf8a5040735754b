"""`BENCHMARK.json` keeps to the benchmark's contract, and every file it
names is found by name."""

import json
import os
import re

import pytest

from benchmark import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(man):
    assert set(man) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in man["paths"])
    assert all(os.path.isdir(os.path.join(ROOT, p)) for p in man["paths"])
    assert 1 <= len(man["command"]) <= 32 and all(one_line(w) and not w.startswith("/") for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51


def test_names_and_units(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in man[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group if group in ("configs", "workloads") else "metric", entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    assert len(names) == len(set(names))
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert one_line(w["why"])
    for c in man["configs"]:
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"])
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}


def test_every_config_file_is_its_own_and_used(man):
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert set(c["reduced"]) == set(body["reduced"])


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = manifest.load_cell(cell)
    assert c.params["strains_per_contig"] and c.limits
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]))
    moved = {m["moves"] for m in c.per_layer}
    assert moved <= e2e


def test_per_layer_metrics_name_known_cells(man):
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"] + man["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    layers: dict[str, str] = {}
    for m in man["per_layer"]:
        layers.setdefault(m["name"], m["layer"])
    assert len(set(layers.values())) == len(layers)  # one layer name per layer


def test_four_chip_cells_and_check_time(man):
    cells = man["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    full = 24
    check_s = (2 + 14 * full) * (man["run_seconds"] + 60) + full * 2 * 90 + 1200
    assert check_s <= 43200

"""On the card, at each cell's own size: the controls (`benchmark/controls.py`)
come out as not correct on three seeds; TF32 changes no judged number; and
the chi² statistics in bfloat16, the nearest precision below the
program's float32, move the judged numbers but keep each inside its limit,
so the configurations state no precision (PERF.md §2).

    python -m pytest benchmark/tests/test_benchmark_controls.py -m cuda

(about 10 minutes on one H100; `python -m benchmark.readings` gives the
same readings seed by seed).
"""

import pytest

from benchmark import controls, manifest, run

SEEDS = (9001, 9002, 9003)
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the controls are read at the cells' own sizes")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["half_reads_unmapped", "groups_split_at_random"])
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(card, cell_name, control):
    cell = manifest.load_cell(cell_name)
    for seed in SEEDS:
        with controls.applied(control):
            res = run.run(cell, seed, 0, False, card)
        assert not res["correct"], (cell_name, control, seed, res["numbers"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_tf32_changes_no_number(card, cell_name):
    cell = manifest.load_cell(cell_name)
    sound = run.run(cell, SEEDS[0], 0, False, card)
    with controls.applied("tf32"):
        lower = run.run(cell, SEEDS[0], 0, False, card)
    assert lower["numbers"] == sound["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_chi2_bf16_stays_inside_the_limits(card, cell_name):
    cell = manifest.load_cell(cell_name)
    for seed in SEEDS:
        with controls.applied("chi2_bf16"):
            res = run.run(cell, seed, 0, False, card)
        assert res["correct"], (cell_name, seed, res["numbers"])

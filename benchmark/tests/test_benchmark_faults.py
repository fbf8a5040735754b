"""A whole run on the CPU, at a cut size, without the look for a card:
sound, it comes out correct; with the timed path broken underneath
(`benchmark/controls.py`), it does not."""

import dataclasses

import pytest

from benchmark import controls, manifest, run

# a cut of the first cell: two 12 kb contigs with 2 and 3 strains, 3 kb reads
CUT = {"contig_len": 12_000, "read_len": 3000, "pool": 1}


@pytest.fixture(scope="module")
def cell():
    c = manifest.load_cell("strains-ont.even30x")
    c.params.update(CUT)
    return c


def test_sound_run_is_correct(cell):
    res = run.run(cell, 3, 0, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"min_strain_recovery", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"


def test_traced_run_reports_the_layers(cell):
    every = manifest.load_manifest()["per_layer"]  # the other cells' layers too, read off this run
    res = run.run(dataclasses.replace(cell, per_layer=every), 4, 0, True, "cpu")
    assert res["correct"], res["checks"]
    assert {"map.s_per_mbp", "variants.s_per_mbp", "separate.s_per_mbp", "contigs.s_per_mbp",
            "untangle.s_per_mbp", "fused_call.ms_per_kjob", "pipeline.read_kbp_per_s"} <= set(res["metrics"])
    assert "k1_roofline" not in res["metrics"]  # no device kernel on the CPU: nothing to read
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
def test_broken_run_is_not_correct(cell, fault):
    with controls.applied(fault):
        res = run.run(cell, 3, 0, False, "cpu")
    assert not res["correct"], (fault, res["numbers"])

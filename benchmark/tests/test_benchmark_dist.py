"""The readers of a job spread over several processes (`dist.comm.s_per_mbp`,
`dist.shard_skew`) on hand-built jobs, and the four-chip cell that reports
them: the values, and None on jobs without the entries (one process, or a
program that does not write them)."""

import pytest

from benchmark import manifest
from benchmark.trace import RunContext

CELL = "strains-ont-dist4.meta10x30"
DIST_METRICS = ("dist.comm.s_per_mbp", "dist.shard_skew")


def ctx_spread():
    """Two jobs of 10 and 30 Mbp over four processes, as `run_job` keeps
    their `stage_stats.json` (seconds only)."""
    ctx = RunContext(window=(0.0, 30.0))
    ctx.jobs = [
        {"pool": 0, "read_bp": 10_000_000, "start": 0.0, "end": 10.0, "stages": {
            "load_inputs": 0.5, "comm": 0.01, "mapping": 4.0, "mapping.comm": 1.0,
            "call_variants": 2.0, "call_variants.comm": 0.3, "separate_reads": 1.0,
            "separate_reads.comm": 0.2, "shard.p0": 3.0, "shard.p1": 2.0, "shard.p2": 2.0, "shard.p3": 1.0,
        }},
        {"pool": 1, "read_bp": 30_000_000, "start": 10.0, "end": 30.0, "stages": {
            "load_inputs": 1.5, "comm": 0.03, "mapping": 12.0, "mapping.comm": 2.0,
            "call_variants": 4.0, "call_variants.comm": 0.46, "separate_reads": 2.0,
            "separate_reads.comm": 0.0, "shard.p0": 6.0, "shard.p1": 6.0, "shard.p2": 6.0, "shard.p3": 6.0,
        }},
    ]
    return ctx


@pytest.mark.parametrize("metric,want", [
    ("dist.comm.s_per_mbp", (0.01 + 1.0 + 0.3 + 0.2 + 0.03 + 2.0 + 0.46) / 40),
    ("dist.shard_skew", (3.0 + 6.0) / (2.0 + 6.0)),
])
def test_dist_readers(metric, want):
    assert manifest.reader(metric)(ctx_spread()) == pytest.approx(want)


@pytest.mark.parametrize("metric", DIST_METRICS)
def test_dist_readers_on_one_process_return_none(metric):
    """A single-process job (or the parent's program) writes neither entry."""
    ctx = ctx_spread()
    for job in ctx.jobs:
        job["stages"] = {k: v for k, v in job["stages"].items()
                         if not (k == "comm" or k.endswith(".comm") or k.startswith("shard."))}
    assert manifest.reader(metric)(ctx) is None
    assert manifest.reader(metric)(RunContext()) is None


@pytest.mark.parametrize("metric", DIST_METRICS)
def test_dist_readers_read_only_the_jobs_that_hold_the_entries(metric):
    ctx = ctx_spread()
    alone = manifest.reader(metric)(ctx)
    ctx.jobs.append({"pool": 2, "read_bp": 20_000_000, "start": 30.0, "end": 35.0,
                     "stages": {"load_inputs": 1.0, "mapping": 5.0}})
    assert manifest.reader(metric)(ctx) == pytest.approx(alone)


def test_four_chip_cell_reports_the_dist_metrics_alone():
    cell = manifest.load_cell(CELL)
    assert cell.chips == 4 and cell.config["pipeline"]["devices"] == 4
    assert cell.params["strains_per_contig"] == [3, 1, 2, 1, 1, 2, 1, 1, 1, 1]
    # the rate spreads too widely between runs to carry its bound here: as in
    # even30x it is a per-layer metric, and the cell's end-to-end metrics are
    # the strain recovery and the set-up
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "min_strain_recovery"}
    assert set(DIST_METRICS) | {"pipeline.read_kbp_per_s"} == {m["name"] for m in cell.per_layer}
    for m in manifest.load_manifest()["per_layer"]:
        if m["name"] in DIST_METRICS:
            assert m["workloads"] == [CELL] and m["source"] == "program_span"
            assert m["moves"] == "min_strain_recovery"
    for other in ("strains-ont.even30x", "strains-ont.clonal30x"):
        c = manifest.load_cell(other)
        assert c.chips == 1 and "devices" not in c.config["pipeline"]
        assert not set(DIST_METRICS) & {m["name"] for m in c.per_layer}

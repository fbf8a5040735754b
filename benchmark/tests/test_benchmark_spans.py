"""The readers of the program's own span entries in `stage_stats.json`, on
hand-built jobs: each reads its entries per Mbp, counts a missing child as
0, and returns None where no job holds the entries it reads (a program
that records no span inside its stages)."""

import pytest

from benchmark import manifest
from benchmark.trace import RunContext

SPAN_READERS = {
    "io.s_per_mbp": "load_inputs",
    "map.chain.s_per_mbp": "mapping",
    "map.host.s_per_mbp": "mapping",
    "map.align.s_per_mbp": "mapping",
    "map.rescue.s_per_mbp": "mapping",
    "variants.pileup.s_per_mbp": "call_variants",
    "variants.stats.s_per_mbp": "call_variants",
    "variants.filter.s_per_mbp": "call_variants",
    "contigs.remap.s_per_mbp": "create_new_contigs",
    "contigs.poa.s_per_mbp": "create_new_contigs",
    "job.unspanned_share": "load_inputs",
}


def ctx_with_spans():
    """Two jobs of 4 and 6 Mbp with the program's span entries; the second
    polishes nothing and needs no rescue."""
    ctx = RunContext(window=(100.0, 120.0))
    ctx.jobs = [
        {"pool": 0, "read_bp": 4_000_000, "start": 100.0, "end": 110.0, "stages": {
            "load_inputs": 0.2, "write_artifacts": 0.3,
            "mapping": 2.0, "mapping.index": 0.1, "mapping.chain": 0.4,
            "mapping.plan": 0.4, "mapping.align": 0.5, "mapping.assemble": 0.2, "mapping.rescue": 0.3,
            "call_variants": 3.0, "call_variants.pileup": 1.5, "call_variants.stats": 0.5,
            "call_variants.filter": 0.9,
            "separate_reads": 0.5, "separate_reads.phase": 0.5,
            "create_new_contigs": 3.5, "create_new_contigs.consensus": 1.0, "create_new_contigs.remap": 1.2,
            "create_new_contigs.poa": 1.1,
            "untangle": 0.1,
        }},
        {"pool": 1, "read_bp": 6_000_000, "start": 110.0, "end": 120.0, "stages": {
            "load_inputs": 0.3, "write_artifacts": 0.2,
            "mapping": 3.0, "mapping.index": 0.1, "mapping.chain": 0.5,
            "mapping.plan": 0.6, "mapping.align": 1.5, "mapping.assemble": 0.3,
            "call_variants": 2.0, "call_variants.pileup": 1.0, "call_variants.stats": 0.4,
            "call_variants.filter": 0.5,
            "separate_reads": 0.4, "separate_reads.phase": 0.4,
            "create_new_contigs": 3.0, "create_new_contigs.consensus": 2.9,
            "untangle": 0.1,
        }},
    ]
    return ctx


@pytest.mark.parametrize("metric,want", [
    ("io.s_per_mbp", (0.2 + 0.3 + 0.3 + 0.2) / 10),
    ("map.chain.s_per_mbp", (0.1 + 0.4 + 0.1 + 0.5) / 10),
    ("map.host.s_per_mbp", (0.4 + 0.2 + 0.6 + 0.3) / 10),
    ("map.align.s_per_mbp", (0.5 + 1.5) / 10),
    ("map.rescue.s_per_mbp", 0.3 / 10),
    ("variants.pileup.s_per_mbp", (1.5 + 1.0) / 10),
    ("variants.stats.s_per_mbp", (0.5 + 0.4) / 10),
    ("variants.filter.s_per_mbp", (0.9 + 0.5) / 10),
    ("contigs.remap.s_per_mbp", 1.2 / 10),
    ("contigs.poa.s_per_mbp", 1.1 / 10),
    ("job.unspanned_share", 1 - (0.2 + 0.3 + 2.0 + 3.0 + 0.5 + 3.5 + 0.1 + 0.3 + 0.2 + 3.0 + 2.0 + 0.4 + 3.0 + 0.1) / 20),
])
def test_span_readers(metric, want):
    assert manifest.reader(metric)(ctx_with_spans()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers_without_the_program_spans_return_none(metric):
    """Jobs whose `stage_stats.json` holds the stages alone, as a program
    without the recorder's entries writes it, and a window with no job."""
    ctx = ctx_with_spans()
    for job in ctx.jobs:
        job["stages"] = {k: v for k, v in job["stages"].items() if "." not in k and k not in
                         ("load_inputs", "write_artifacts")}
    assert manifest.reader(metric)(ctx) is None
    assert manifest.reader(metric)(RunContext()) is None


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers_read_only_the_jobs_that_hold_their_parent(metric):
    """A job without the parent's entries adds neither seconds nor Mbp."""
    ctx = ctx_with_spans()
    alone = manifest.reader(metric)(ctx)
    parent = SPAN_READERS[metric]
    ctx.jobs.append({"pool": 2, "read_bp": 5_000_000, "start": 120.0, "end": 125.0, "stages": {
        k: v for k, v in ctx.jobs[0]["stages"].items() if k != parent and not k.startswith(parent + ".")}})
    assert manifest.reader(metric)(ctx) == pytest.approx(alone)


def test_every_span_reader_is_in_the_manifest():
    per_layer = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}
    for metric in SPAN_READERS:
        m = per_layer[metric]
        assert m["source"] == "program_span" and m["moves"] == "read_kbp_per_s" and "workloads" not in m

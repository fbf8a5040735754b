"""The roofline, idle and rate arithmetic on synthetic counts and intervals."""

import numpy as np
import pytest

from benchmark import manifest
from benchmark.metrics import _roofline as R
from benchmark.trace import RunContext, breakdown, idle_gaps, span_at, union_length


def test_bound_takes_the_larger_side():
    assert R.bound_s(3.35e12, 0) == (1.0, "bytes")
    s, by = R.bound_s(0, int(R.INT32_OPS_PER_S))
    assert by == "operations" and s == pytest.approx(1.0)


def test_fused_k1_work_counts_inputs_outputs_and_rows():
    B, T, N = 256, 319, 3
    q_lens = np.array([10, 300, 0], dtype=np.int32)
    fused = np.zeros((N, 16 + B), dtype=np.uint8)
    meta = fused[:, :16].view(np.int32)
    meta[:, 2] = [7, 200, 0]  # start_i: rows walked
    n_bytes, n_ops = R.fused_k1_work(q_lens, B, T, fused)
    assert n_bytes == N * (B + T + 12 + 16 + B)
    assert n_ops == (10 + 256 + 0) * R.OPS_FUSED_ROW + (7 + 200) * R.OPS_WALK_ROW


def test_union_and_gaps():
    iv = np.array([[1.0, 2.0], [1.5, 3.0], [5.0, 6.0], [5.2, 5.4]])
    assert union_length(iv) == pytest.approx(3.0)
    assert idle_gaps(iv, (0.0, 7.0)) == [(0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]
    assert union_length(np.zeros((0, 2))) == 0.0
    assert idle_gaps(np.zeros((0, 2)), (0.0, 2.0)) == [(0.0, 2.0)]


def test_span_at_takes_the_innermost():
    spans = [("run_pipeline", 0.0, 10.0), ("mapping", 1.0, 3.0)]
    assert span_at(spans, 2.0) == "mapping"
    assert span_at(spans, 5.0) == "run_pipeline"
    assert span_at(spans, 11.0) == "harness"


def ctx_with_trace():
    ctx = RunContext(setup_s=12.5, window=(100.0, 110.0))
    ctx.jobs = [
        {"pool": 0, "read_bp": 4_000_000, "end": 104.0, "stages": {"mapping": 1.0, "call_variants": 2.0}},
        {"pool": 1, "read_bp": 6_000_000, "end": 109.0, "stages": {"mapping": 2.0, "call_variants": 1.0}},
    ]
    ctx.readings = {0: {"min_recovery": 0.98}, 1: {"min_recovery": 0.99}}
    ctx.fused_calls = [
        {"seconds": 0.004, "jobs": 20_000, "kernel": "myers", "bytes": int(3.35e8), "ops": 0},
        {"seconds": 0.001, "jobs": 5_000, "kernel": "myers", "bytes": int(3.35e8), "ops": 0},
    ]
    ctx.device_ops = {"myers_fused_kernel(...)": 0.0008, "gemm": 0.5}
    ctx.device_intervals = np.array([[101.0, 101.5], [103.0, 104.0]])
    ctx.busy_s = 1.5
    ctx.spans = [("run_pipeline", 100.0, 104.0), ("mapping", 100.0, 101.0)]
    return ctx


@pytest.mark.parametrize("metric,want", [
    ("read_kbp_per_s", 10_000 / 9.0),
    ("pipeline.read_kbp_per_s", 10_000 / 9.0),
    ("min_strain_recovery", 0.98),
    ("setup_s", 12.5),
    ("map.s_per_mbp", 0.3),
    ("variants.s_per_mbp", 0.3),
    ("fused_call.ms_per_kjob", 5.0 / 25.0),
    ("k1_roofline", 100.0 * 2e-4 / 0.0008),
    ("device.idle_share", 0.85),
])
def test_readers(metric, want):
    assert manifest.reader(metric)(ctx_with_trace()) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["k1_roofline", "separate.s_per_mbp", "untangle.s_per_mbp",
                                    "contigs.s_per_mbp", "fused_call.ms_per_kjob", "read_kbp_per_s",
                                    "pipeline.read_kbp_per_s"])
def test_readers_with_nothing_to_read_return_none(metric):
    assert manifest.reader(metric)(RunContext()) is None


def test_breakdown():
    b = breakdown(ctx_with_trace())
    assert b["device_ops"][0] == ["gemm", 0.5]
    assert b["idle_gaps"] == [["harness", 6.0], ["run_pipeline", 1.5], ["mapping", 1.0]]
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10

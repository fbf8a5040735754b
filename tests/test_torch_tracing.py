"""The port's span recorder (`hairsplitter_tpu_torch/utils/tracing.py`) and
the per-job summary it feeds (`pipeline/orchestrate.py:StageStats`,
`stage_stats.json`)."""

import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from hairsplitter_tpu_torch.pipeline import orchestrate
from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_tpu_torch.utils import tracing
from tests.test_torch_pipeline import _two_strain_dataset
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

STAGES = ("mapping", "call_variants", "separate_reads", "create_new_contigs", "untangle")


def _closed_since(first_id: int) -> list[tracing.Span]:
    return [s for s in tracing.spans() if s.id >= first_id]


def test_spans_nest_by_thread_stack():
    with tracing.job() as job:
        with tracing.span("a", n=1) as a:
            with tracing.span("b") as b:
                b.add(k=2)
                b.add(k=3)
            with tracing.span("b"):
                pass
        with tracing.span("c") as c:
            assert tracing.current() is c
    assert tracing.current() is None
    assert job.parent is None and job.job == job.id
    assert a.parent == job.id and b.parent == a.id and c.parent == job.id
    assert {a.job, b.job, c.job} == {job.id}
    assert b.counts == {"k": 5} and a.counts == {"n": 1}
    assert job.start <= a.start <= b.start <= b.end <= a.end <= c.start <= c.end <= job.end
    assert set(job.children) == {"a", "c"} and set(a.children) == {"b"}
    tot = a.children["b"]
    assert tot.calls == 2 and tot.counts == {"k": 5}
    assert tot.seconds == pytest.approx(sum(s.seconds for s in _closed_since(b.id) if s.parent == a.id))
    assert [s.name for s in _closed_since(job.id)] == ["b", "b", "a", "c", "job"]


def test_a_job_inside_a_span_starts_its_own_job_id():
    with tracing.span("outer") as outer:
        with tracing.job() as job:
            with tracing.span("x") as x:
                pass
    assert job.parent == outer.id and job.job == job.id != outer.job
    assert x.job == job.id


def test_a_span_closes_on_an_exception():
    with pytest.raises(ValueError):
        with tracing.span("boom") as sp:
            raise ValueError
    assert tracing.current() is None and sp.end >= sp.start and tracing.spans()[-1] is sp


def test_worker_thread_span_takes_its_explicit_parent():
    with tracing.job() as job:
        with tracing.span("submit") as submit:
            def work(i):
                assert tracing.current() is None  # the worker's own stack is empty
                with tracing.span("item", parent=submit, i=i) as sp:
                    with tracing.span("inner") as inner:
                        pass
                return sp, inner, threading.get_ident()

            with ThreadPoolExecutor(max_workers=3) as ex:
                out = list(ex.map(work, range(6)))
    main = threading.get_ident()
    for sp, inner, tid in out:
        assert sp.parent == submit.id and sp.job == job.id and sp.thread == tid != main
        assert inner.parent == sp.id and inner.job == job.id
    assert submit.children["item"].calls == 6 and submit.children["item"].counts == {"i": 15}


def test_contig_map_runs_each_item_in_a_span_under_the_caller(one_torch_thread):
    items = list(range(5))
    for threads in (1, 3):
        with tracing.span("stage") as stage:
            got = orchestrate._contig_map(threads, items, lambda i: (tracing.current(), i * i))
        assert [v for _, v in got] == [i * i for i in items]
        assert all(sp.name == "contig" and sp.parent == stage.id for sp, _ in got)
        assert stage.children["contig"].calls == 5


def test_counts_and_children_add_up_under_many_threads():
    """More threads than cores, switching often: no count and no child
    close may be lost."""
    n_threads, n_iter = 32, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.span("shared") as shared:
            def work(_):
                for _ in range(n_iter):
                    shared.add(hits=1, twice=2)
                    with tracing.span("child", parent=shared, one=1):
                        pass

            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert shared.counts == {"hits": n_threads * n_iter, "twice": 2 * n_threads * n_iter}
    tot = shared.children["child"]
    assert tot.calls == n_threads * n_iter and tot.counts == {"one": n_threads * n_iter}


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(maxlen=4))
    assert tracing.spans() == [] and tracing.dropped() == 0
    made = []
    for i in range(10):
        with tracing.span(f"s{i}") as sp:
            made.append(sp)
    assert tracing.spans() == made[-4:]
    assert tracing.dropped() == 6


def test_kernel_launch_counts_reads_the_four_kernels():
    from hairsplitter_tpu_torch.ops import _build
    from hairsplitter_tpu_torch.parallel import distributed

    counts = _build.kernel_launch_counts()
    assert distributed._build is _build
    assert list(counts) == ["myers_fused", "myers_rows", "banded_fused", "banded_dp", "window_stats", "chain_seeds",
                            "pileup_cells"]
    assert all(isinstance(v, int) and v >= 0 for v in counts.values())
    counts["myers_fused"] += 1  # the caller gets a copy
    assert _build.kernel_launch_counts()["myers_fused"] == counts["myers_fused"] - 1


def test_launch_counts_each_launch_and_raises_on_a_cuda_error(monkeypatch):
    """`_build.launch` calls `hs_<kernel>` with the current stream last and
    counts the launch; a nonzero return raises and is not counted. The
    library, the device and the stream are stand-ins here."""
    import contextlib
    import types

    import torch

    from hairsplitter_tpu_torch.ops import _build

    calls, rc = [], [0]
    lib = types.SimpleNamespace(hs_window_stats=lambda *args: calls.append(args) or rc[0])
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=77))
    before = _build.kernel_launch_counts()
    _build.launch("window_stats", "cuda:0", 1, None, 2.5)
    assert calls == [(1, None, 2.5, 77)]
    assert _build.kernel_launch_counts() == {**before, "window_stats": before["window_stats"] + 1}
    rc[0] = 700
    with pytest.raises(RuntimeError, match="hs_window_stats launch failed with CUDA error 700"):
        _build.launch("window_stats", "cuda:0")
    assert _build.kernel_launch_counts()["window_stats"] == before["window_stats"] + 1


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = tmp_path_factory.mktemp("traced")
        asm, reads = _two_strain_dataset(str(root))
        first = next(tracing._ids)
        t0 = time.perf_counter()
        run_pipeline(asm, reads, str(root / "out"), PipelineConfig(device="cpu"))
        t1 = time.perf_counter()
    finally:
        torch.set_num_threads(threads)
    stats = json.loads((root / "out" / "stage_stats.json").read_text())
    return stats, [s for s in tracing.spans() if s.id > first], (t0, t1)


def test_pipeline_spans_form_one_job_inside_the_call(pipeline_run):
    _, spans, (t0, t1) = pipeline_run
    jobs = [s for s in spans if s.name == "job"]
    assert len(jobs) == 1
    job = jobs[0]
    assert {s.job for s in spans} == {job.id}
    assert all(t0 <= s.start <= s.end <= t1 for s in spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s is not job:
            up = by_id[s.parent]
            assert up.start <= s.start <= s.end <= up.end
    assert 20 <= len(spans) <= 400  # spans at layer boundaries, not per read


def test_stage_stats_entries(pipeline_run):
    stats, spans, _ = pipeline_run
    assert all(isinstance(v, dict) and isinstance(v["seconds"], float) for v in stats.values())
    job = next(s for s in spans if s.name == "job")
    top = {s.name: s for s in spans if s.parent == job.id}
    assert set(top) == {"load_inputs", "write_artifacts", *STAGES}
    for stage in STAGES:
        assert stats[stage]["seconds"] == round(top[stage].seconds, 6)
        children = {k: v for k, v in stats.items() if k.startswith(stage + ".")}
        assert sum(v["seconds"] for v in children.values()) <= stats[stage]["seconds"] + 1e-3
        for k, v in children.items():
            tot = top[stage].children[k.split(".", 1)[1]]
            assert v == {"seconds": round(tot.seconds, 6), "calls": tot.calls, **tot.counts}
    writes = [s for s in spans if s.name == "write_artifacts"]
    assert stats["write_artifacts"] == {"seconds": round(sum(s.seconds for s in writes), 6), "calls": len(writes)}
    assert stats["load_inputs"]["calls"] == 1
    # the stage entries keep their counters and rates
    assert set(stats["mapping"]) == {"seconds", "read_kbp", "read_kbp_per_s"}
    assert set(stats["call_variants"]) == {"seconds", "pileup_cells", "pileup_cells_per_s", "snps", "snps_per_s"}
    assert stats["call_variants.filter"]["snps"] == stats["call_variants"]["snps"]
    for name in ("mapping.index", "mapping.chain", "mapping.plan", "mapping.align", "mapping.assemble",
                 "call_variants.pileup", "call_variants.stats", "call_variants.filter",
                 "create_new_contigs.cells", "create_new_contigs.consensus", "create_new_contigs.remap",
                 "create_new_contigs.poa"):
        assert stats[name]["calls"] >= 1, name
    assert stats["mapping.chain"]["reads"] > 0 and stats["mapping.align"]["jobs"] > 0
    assert stats["create_new_contigs.poa"]["windows"] > 0


def test_stats_entry_counts_the_window_blocks_by_route(pipeline_run):
    """`call_variants.stats` holds the seconds and the one call of the
    window-stats route; its device_pass span takes every block of the
    fixture's one 20 kb contig."""
    from hairsplitter_tpu_torch.pipeline.pileup import WINDOW

    stats, spans, _ = pipeline_run
    entry = stats["call_variants.stats"]
    assert set(entry) == {"seconds", "calls"}
    assert entry["seconds"] > 0 and entry["calls"] == 1
    assert [s.counts for s in spans if s.name == "device_pass"] == [{"blocks": -(-20_000 // WINDOW)}]


def test_map_reads_spans_nest_under_their_caller(pipeline_run):
    """Stage 5's remap runs `map_reads`: its steps sit one level down."""
    _, spans, _ = pipeline_run
    by_id = {s.id: s for s in spans}
    remap = [s for s in spans if s.name == "remap"]
    assert remap and all(by_id[s.parent].name == "create_new_contigs" for s in remap)
    under = {s.name for s in spans if s.parent in {r.id for r in remap}}
    assert {"index", "chain", "plan", "align", "assemble"} <= under

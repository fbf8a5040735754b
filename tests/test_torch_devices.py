"""One job over several devices from one call (`PipelineConfig.devices`,
the CLI's `--devices`; `parallel/distributed.py:WorkerGroup`), on the CPU:
the calling process is process 0 and the worker processes it starts join
it over gloo.

A small three-species metagenome (two strains in the first species) goes
through `run_pipeline` with `devices` 2 and 3. Every artifact process 0
writes is byte-identical to the single-process run's, the SAM compared as
sorted lines, and the output passes the benchmark's plain judge
(`benchmark/reference/judge.py`, NumPy and PyTorch only) against the
generator's truth, under the limits of the benchmark cell that runs this
path. Each test runs under a time limit of its own (`time_limit`), and the
worker group's collectives under a short timeout, so that a hang fails the
test instead of stalling the run."""

from __future__ import annotations

import json
import os
import signal
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch.distributed as tdist

from benchmark import manifest
from benchmark.reference import judge as J
from benchmark.traffic import generate
from hairsplitter_tpu_torch import cli
from hairsplitter_tpu_torch.parallel import distributed
from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig, run_pipeline
from tests.test_torch_pipeline import ARTIFACTS as PIPELINE_ARTIFACTS
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "short_group_timeout")

SAM = "tmp/reads_on_asm.sam"
ARTIFACTS = [name for name in PIPELINE_ARTIFACTS if name != SAM]
CELL = "strains-ont-dist4.meta10x30"
MIX = {
    "divergence": 0.01, "first_is_backbone": True, "assembly": "strain0", "sub_rate": 0.06,
    "ins_rate": 0.02, "del_rate": 0.02, "uniform_edges": True, "strains_per_contig": [2, 1, 1],
}
JUDGED = {**MIX, "contig_len": 30_000, "read_len": 6000, "coverage": 30}  # ~2.8 Mbp of reads
SMALL = {**MIX, "contig_len": 20_000, "read_len": 4000, "coverage": 20}  # ~1.2 Mbp


@contextmanager
def time_limit(seconds: int):
    """Fail the block after `seconds` (SIGALRM, main thread)."""
    def expired(signum, frame):
        raise TimeoutError(f"over the test's limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def short_group_timeout():
    """A collective that waits longer than this fails; the group is closed
    once the module's tests are done."""
    saved = distributed.GROUP_TIMEOUT_S
    distributed.GROUP_TIMEOUT_S = 120.0
    yield
    distributed._close_group()
    distributed.GROUP_TIMEOUT_S = saved


def _job(tmp_path_factory, params, seed):
    job = generate.make_job(params, seed)
    generate.write_job(job, str(tmp_path_factory.mktemp("job")))
    return job


@pytest.fixture(scope="module")
def judged_job(tmp_path_factory):
    return _job(tmp_path_factory, JUDGED, 0)


@pytest.fixture(scope="module")
def small_job(tmp_path_factory):
    return _job(tmp_path_factory, SMALL, 5)


@pytest.fixture(scope="module")
def single_run(judged_job, tmp_path_factory):
    """The single-process run of the judged job, in this process."""
    out = tmp_path_factory.mktemp("single")
    with time_limit(240):
        run_pipeline(judged_job.paths["assembly"], judged_job.paths["reads"], str(out),
                     PipelineConfig(no_clean=True, device="cpu"))
    return out


def _run(job, out, devices, limit=240, **kw):
    with time_limit(limit):
        return run_pipeline(job.paths["assembly"], job.paths["reads"], str(out),
                            PipelineConfig(no_clean=True, device="cpu", devices=devices, **kw))


def _sam_parts(path):
    lines = open(path).read().splitlines()
    return [l for l in lines if l.startswith("@")], sorted(l for l in lines if not l.startswith("@"))


def _worker_pids() -> list[int]:
    return [p.pid for p in distributed._GROUP.procs] if distributed._GROUP else []


@pytest.fixture(scope="module")
def runs(judged_job, single_run, tmp_path_factory):
    """The judged job over 2 and then 3 CPU processes."""
    out = {}
    for n in (2, 3):
        out[n] = tmp_path_factory.mktemp(f"devices{n}")
        gfa = _run(judged_job, out[n], n)
        assert gfa == str(out[n] / "hairsplitter_final_assembly.gfa")
    return out


@pytest.mark.parametrize("devices", [2, 3])
def test_devices_output_equals_single_process_and_is_judged_correct(devices, runs, single_run, judged_job):
    out = runs[devices]
    for name in ARTIFACTS:
        got = (out / name).read_bytes()
        assert got == (single_run / name).read_bytes() and got, name
    head, body = _sam_parts(out / SAM)
    assert (head, body) == _sam_parts(single_run / SAM) and body
    # process 0 writes what a single process writes; worker i its own log and statistics
    top = sorted(os.listdir(out))
    workers = [f"{kind}.p{i}.{ext}" for i in range(1, devices) for kind, ext in
               (("hairsplitter", "log"), ("stage_stats", "json"))]
    assert sorted(n for n in top if ".p" in n) == sorted(workers)
    assert set(os.listdir(single_run)) | set(workers) == set(top)
    for i in range(devices):
        log = (out / (f"hairsplitter.p{i}.log" if i else "hairsplitter.log")).read_text()
        assert f"distributed run: process {i}/{devices}" in log and "device: cpu" in log
        assert "kernel launches: myers_fused=0" in log.splitlines()[-1]

    files = {key: (out / rel).read_text() for key, rel in J.ARTIFACTS.items()}
    truth = J.truth_of(judged_job, np.random.default_rng(7))
    J.reference_costs([truth], "cpu")
    numbers = J.judge(truth, files)
    ok, rows = J.verdict(numbers, manifest.load_cell(CELL).limits)
    assert ok, rows


def test_stage_stats_hold_collectives_and_shard_seconds(runs):
    for devices, out in runs.items():
        stats = json.loads((out / "stage_stats.json").read_text())
        for stage in ("mapping", "call_variants", "separate_reads"):
            entry = stats[f"{stage}.comm"]
            assert entry["calls"] >= 1 and entry["bytes"] > 0 and 0 <= entry["seconds"] <= stats[stage]["seconds"]
        shards = [stats[f"shard.p{i}"]["seconds"] for i in range(devices)]
        assert all(s > 0 for s in shards) and f"shard.p{devices}" not in stats
        assert all(set(stats[f"shard.p{i}"]) == {"seconds"} for i in range(devices))
        worker = json.loads((out / "stage_stats.p1.json").read_text())
        assert "mapping.comm" in worker and not any(k.startswith("shard.") for k in worker)


def test_one_device_run_has_no_collectives(single_run):
    stats = json.loads((single_run / "stage_stats.json").read_text())
    assert not any(k.endswith(".comm") or k.startswith("shard.") or k == "comm" for k in stats)
    assert "distributed run" not in (single_run / "hairsplitter.log").read_text()


def test_one_device_call_leaves_no_group(small_job, tmp_path):
    """With devices == 1 no process is spawned and no process group made,
    even from a process that has no group up yet."""
    distributed._close_group()
    _run(small_job, tmp_path / "one", 1, limit=120)
    assert distributed._GROUP is None and not tdist.is_initialized()


def test_two_calls_reuse_one_worker_group(small_job, tmp_path):
    """The CLI's --devices, then run_pipeline: the same worker processes
    serve both calls, and both outputs are the same."""
    with time_limit(180):
        assert cli.main(["-i", small_job.paths["assembly"], "-f", small_job.paths["reads"],
                         "-o", str(tmp_path / "a"), "--device", "cpu", "--devices", "2", "--no_clean"]) == 0
    pids = _worker_pids()
    assert len(pids) == 1 and tdist.is_initialized() and tdist.get_world_size() == 2
    _run(small_job, tmp_path / "b", 2, limit=120)
    assert _worker_pids() == pids
    for name in ARTIFACTS:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes(), name


def test_worker_that_raises_fails_the_call_and_the_next_call_runs(small_job, tmp_path):
    """Worker 1 cannot write its log (a directory holds the name): the call
    raises its traceback within the limit instead of waiting in a
    collective, and the next call starts a new group and succeeds."""
    bad = tmp_path / "bad"
    (bad / "hairsplitter.p1.log").mkdir(parents=True)
    _run(small_job, tmp_path / "warm", 3, limit=120)
    before = _worker_pids()
    t0 = time.perf_counter()
    with pytest.raises(distributed.WorkerFailed, match="worker 1 raised(.|\n)*IsADirectoryError"):
        _run(small_job, bad, 3, limit=60)
    assert time.perf_counter() - t0 < 60
    assert distributed._GROUP is None and not tdist.is_initialized()
    _run(small_job, tmp_path / "after", 3, limit=120)
    after = _worker_pids()
    assert len(after) == 2 and not set(after) & set(before)
    assert (tmp_path / "after" / "hairsplitter_final_assembly.fasta").read_bytes() == \
        (tmp_path / "warm" / "hairsplitter_final_assembly.fasta").read_bytes()


def test_dead_worker_is_replaced_at_the_next_call(small_job, tmp_path):
    _run(small_job, tmp_path / "first", 2, limit=120)
    proc = distributed._GROUP.procs[0]
    os.kill(proc.pid, signal.SIGKILL)
    proc.join(timeout=30)
    _run(small_job, tmp_path / "second", 2, limit=120)
    assert _worker_pids() != [proc.pid]
    assert (tmp_path / "second" / "hairsplitter_final_assembly.fasta").read_bytes() == \
        (tmp_path / "first" / "hairsplitter_final_assembly.fasta").read_bytes()


@pytest.mark.parametrize("device,process_id,visible,want", [
    ("cuda", 0, 4, "cuda:0"),
    ("cuda", 1, 4, "cuda:1"),
    ("cuda", 3, 4, "cuda:3"),
    ("cuda", 1, 1, "cuda"),  # one card: every process on it
    ("cuda", 2, 2, "cuda"),
    ("cuda:2", 1, 4, "cuda:3"),  # counted from the card named
    ("cpu", 1, 4, "cpu"),
])
def test_launcher_puts_each_process_on_its_card(device, process_id, visible, want):
    assert distributed.card_of(device, process_id, visible) == want


@pytest.mark.parametrize("device,rank,want", [
    ("cuda", 0, "cuda:0"), ("cuda", 3, "cuda:3"), ("cuda:1", 2, "cuda:3"), ("cpu", 2, "cpu"),
])
def test_worker_group_card_of_each_rank(device, rank, want):
    assert distributed.card_of(device, rank, 4) == want


@pytest.mark.parametrize("devices", [1, 2, 4, 64])
def test_processes_share_the_cores(devices, monkeypatch):
    monkeypatch.setattr(distributed.os, "sched_getaffinity", lambda pid: set(range(32)))
    assert distributed.thread_share(devices) == {1: 32, 2: 16, 4: 8, 64: 1}[devices]


def test_call_over_devices_splits_and_restores_the_callers_threads(small_job, tmp_path, monkeypatch):
    """During the call process 0 takes its share of the cores, as each worker
    does; after it the caller's own setting is back."""
    import torch

    from hairsplitter_tpu_torch.pipeline import orchestrate

    seen = []
    inner = orchestrate._run_pipeline

    def recording(*args, **kwargs):
        seen.append(torch.get_num_threads())
        return inner(*args, **kwargs)

    monkeypatch.setattr(orchestrate, "_run_pipeline", recording)
    monkeypatch.setattr(distributed, "thread_share", lambda devices: 2)
    assert torch.get_num_threads() == 1
    _run(small_job, tmp_path / "out", 2, limit=120)
    assert seen == [2] and torch.get_num_threads() == 1


def test_each_job_logs_its_own_kernel_launches(tmp_path, monkeypatch):
    """A long-lived process logs the launches of the job just run, not the
    sum over every job it ran."""
    totals = iter([{"myers_fused": 5, "myers_rows": 0}, {"myers_fused": 12, "myers_rows": 0}])
    monkeypatch.setattr(distributed._build, "kernel_launch_counts", lambda: next(totals))
    distributed._log_launches(str(tmp_path), "hairsplitter.log", {"myers_fused": 4, "myers_rows": 0})
    distributed._log_launches(str(tmp_path), "hairsplitter.log", {"myers_fused": 5, "myers_rows": 0})
    logged = [l.split("kernel launches: ")[1] for l in (tmp_path / "hairsplitter.log").read_text().splitlines()]
    assert logged == ["myers_fused=1 myers_rows=0", "myers_fused=7 myers_rows=0"]


def test_contig_threads_run_on_the_callers_card(monkeypatch):
    """With `-t` above 1 every pool thread enters the card the calling thread
    is set to (a new thread starts on card 0), on CUDA; off CUDA nothing."""
    import threading

    import torch

    from hairsplitter_tpu_torch.pipeline import orchestrate

    entered = []

    @contextmanager
    def card(index):
        entered.append((index, threading.get_ident()))
        yield

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "device", card)
    got = orchestrate._contig_map(3, range(6), lambda i: (i * i, threading.get_ident()))
    assert [v for v, _ in got] == [i * i for i in range(6)]
    assert sorted(entered) == sorted((3, t) for _, t in got)
    assert all(t != threading.get_ident() for _, t in got)
    entered.clear()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert [v for v, _ in orchestrate._contig_map(3, range(6), lambda i: (i, 0))] == list(range(6))
    assert entered == []


def test_every_kernel_launch_enters_its_tensors_card():
    """Every launch goes through `ops/_build.py:launch`, which takes the
    current stream inside `torch.cuda.device(device)`, and each wrapper
    passes the device of its tensors: a thread set to another card still
    launches on the card of its tensors, on that card's stream."""
    import ast

    from hairsplitter_tpu_torch.ops import _build

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "hairsplitter_tpu_torch", "ops")
    found, launched = 0, set()
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(root, name)).read())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    ast.unparse(item.context_expr).startswith("torch.cuda.device(") for item in node.items):
                guarded |= {id(n) for n in ast.walk(node)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and ast.unparse(node.func) == "torch.cuda.current_stream" \
                    and not node.args:
                found += 1
                assert id(node) in guarded, f"{name}:{node.lineno}: current_stream() outside torch.cuda.device"
            if isinstance(node, ast.Call) and ast.unparse(node.func) == "launch":
                kernel, device = node.args[:2]
                launched.add(kernel.value)
                assert ast.unparse(device).endswith(".device"), f"{name}:{node.lineno}: launch on {ast.unparse(device)}"
    assert found == 1  # in `launch` alone
    assert launched == set(_build.kernel_launch_counts())


def test_worker_group_refuses_more_cards_than_the_host_has():
    distributed._close_group()
    with pytest.raises(ValueError, match="need card 63"):
        distributed.WorkerGroup(64, "cuda", 10.0)
    assert not tdist.is_initialized()

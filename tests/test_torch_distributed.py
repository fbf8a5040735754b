"""The port's distributed runtime (`hairsplitter_tpu_torch/parallel/
distributed.py`): two processes of its entry point on the CPU, joined by
gloo over 127.0.0.1, against the port's own single-process `run_pipeline`
on the same inputs.

Mirrors tests/test_distributed.py with its two datasets, and holds more:
every artifact process 0 writes is byte-identical to the single-process
run's, except the SAM, whose alignment lines come in the gathered order
(process 0's reads, then process 1's) and are compared as a sorted list
under an equal header. Tolerance: zero everywhere."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from dataclasses import fields, is_dataclass

import numpy as np
import pytest
import torch

from hairsplitter_tpu.parallel.distributed import shard_items as jax_shard_items
from hairsplitter_tpu_torch.parallel.distributed import Comm, DistConfig, init_runtime, shard_items
from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_tpu_torch.utils.sim import make_haplotypes, simulate_reads
from tests.test_torch_pipeline import ARTIFACTS as PIPELINE_ARTIFACTS
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAM = "tmp/reads_on_asm.sam"
ARTIFACTS = [name for name in PIPELINE_ARTIFACTS if name != SAM]  # the SAM is compared as sorted lines
WORKER_TIMEOUT = 600


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_dataset(tmp_path, tag, seed, n_contigs, length, coverage, read_len, sub, indel):
    """`n_contigs` two-strain chromosomes (3% apart), the assembly is each
    one's first strain; reads of all of them in one file."""
    rng = np.random.default_rng(seed)
    contigs = {}
    all_names, all_seqs = [], []
    for chrom in range(n_contigs):
        haps = make_haplotypes(length, 2, 0.03, rng)
        contigs[f"chr{chrom}"] = haps[0]
        sim = simulate_reads(
            haps, coverage=coverage, read_len=read_len, rng=rng,
            sub_rate=sub, ins_rate=indel, del_rate=indel, len_sd=200,
        )
        all_names += [f"c{chrom}_{n}" for n in sim.names]
        all_seqs += sim.seqs
    asm = tmp_path / f"asm{tag}.fa"
    with open(asm, "w") as f:
        for n, s in contigs.items():
            f.write(f">{n}\n{s}\n")
    reads = tmp_path / f"reads{tag}.fa"
    with open(reads, "w") as f:
        for n, s in zip(all_names, all_seqs):
            f.write(f">{n}\n{s}\n")
    return str(asm), str(reads)


@pytest.fixture
def dataset(tmp_path):
    return _write_dataset(tmp_path, "", 11, 2, 6000, 14, 1600, 0.02, 0.01)


@pytest.fixture
def noisy_dataset(tmp_path):
    """~14% read error: the pooled rate exceeds the 0.08 POA-ladder trigger,
    so stage 5 runs the vote+POA polish in both runs."""
    return _write_dataset(tmp_path, "_noisy", 23, 2, 5000, 12, 1500, 0.08, 0.03)


def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["MKL_NUM_THREADS"] = "1"
    return env


def _run_workers(argvs):
    """Start one process per argv, wait for all with a time limit, kill all
    of them if one fails or hangs; returns their outputs."""
    procs = [
        subprocess.Popen(argv, env=_worker_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for argv in argvs
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{o[-3000:]}"
    return outs


def _run_two_process(asm, reads, out2, extra_args=()):
    port = _free_port()
    return _run_workers([
        [
            sys.executable, "-m", "hairsplitter_tpu_torch.parallel.distributed",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(pid),
            "--cpu-devices", "2", "--device", "cpu",
            "-i", asm, "-f", reads, "-o", str(out2), *extra_args,
        ]
        for pid in range(2)
    ])


def _norm(path):
    segs, links = {}, set()
    for line in open(path):
        f = line.rstrip("\n").split("\t")
        if f[0] == "S":
            segs[f[1]] = f[2]
        elif f[0] == "L":
            links.add(tuple(f[1:6]))
    return segs, links


def _sam_parts(path):
    lines = open(path).read().splitlines()
    return [l for l in lines if l.startswith("@")], sorted(l for l in lines if not l.startswith("@"))


def _assert_same_as_single(out2, out1, extra=()):
    """Process 0's artifacts against the single-process run's; process 1
    wrote nothing but its log and its stage statistics."""
    for name in ARTIFACTS + list(extra):
        got = (out2 / name).read_bytes()
        assert got == (out1 / name).read_bytes(), name
        assert len(got) > 0, name
    head2, body2 = _sam_parts(out2 / SAM)
    head1, body1 = _sam_parts(out1 / SAM)
    assert head2 == head1 and body2 == body1 and body1
    assert _norm(out2 / "hairsplitter_final_assembly.gfa") == _norm(out1 / "hairsplitter_final_assembly.gfa")
    top = sorted(os.listdir(out2))
    assert [n for n in top if ".p1." in n] == ["hairsplitter.p1.log", "stage_stats.p1.json"]
    # process 0 writes the names a single process writes
    assert "hairsplitter.log" in top and "stage_stats.json" in top and not [n for n in top if ".p0." in n]
    assert sorted(os.listdir(out2 / "tmp")) == sorted(os.listdir(out1 / "tmp"))
    log1 = (out2 / "hairsplitter.p1.log").read_text()
    assert "process 0 finishes the graph stages" in log1 and "STAGE 5" not in log1


def _global_error_rate(log_text):
    return [l for l in log_text.splitlines() if "global error rate" in l][0].split()[-1]


def test_two_process_pipeline_matches_single(dataset, tmp_path):
    asm, reads = dataset
    out2 = tmp_path / "out2p"
    _run_two_process(asm, reads, out2)
    out1 = tmp_path / "out1p"
    gfa1 = run_pipeline(asm, reads, str(out1), PipelineConfig(no_clean=True, device="cpu"))
    assert gfa1 == str(out1 / "hairsplitter_final_assembly.gfa")
    _assert_same_as_single(out2, out1)

    # both processes logged the same global error rate, the single-process
    # run the same value as its pooled one
    log0 = (out2 / "hairsplitter.log").read_text()
    log1 = (out2 / "hairsplitter.p1.log").read_text()
    assert _global_error_rate(log0) == _global_error_rate(log1)
    single = [l for l in (out1 / "hairsplitter.log").read_text().splitlines() if "pooled error rate" in l]
    assert single[0].split()[-1] == _global_error_rate(log0)
    assert "distributed run: process 0/2" in log0 and "distributed run: process 1/2" in log1
    for log in (log0, log1):  # the CPU run launched no CUDA kernel, and says so
        assert "kernel launches: myers_fused=0 myers_rows=0 banded_fused=0 banded_dp=0" in log


def test_two_process_noisy_with_ploidy_cap_matches_single(noisy_dataset, tmp_path):
    asm, reads = noisy_dataset
    out2 = tmp_path / "out2p_noisy"
    _run_two_process(asm, reads, out2, extra_args=("-c", "12"))
    out1 = tmp_path / "out1p_noisy"
    run_pipeline(
        asm, reads, str(out1), PipelineConfig(haploid_coverage=12.0, no_clean=True, device="cpu")
    )
    # the ladder actually ran: pooled error above the 0.08 trigger
    err = float((out2 / "tmp" / "error_rate.txt").read_text().strip())
    assert err > 0.08, err
    # ploidy file written by process 0 with the same caps as single-process
    p2 = dict(l.split("\t") for l in (out2 / "tmp" / "ploidy.txt").read_text().splitlines())
    p1 = dict(l.split("\t") for l in (out1 / "tmp" / "ploidy.txt").read_text().splitlines())
    assert p1 == p2 and p1
    _assert_same_as_single(out2, out1, extra=["tmp/ploidy.txt"])


def test_two_process_resume(dataset, tmp_path):
    """--resume: the second two-process run loads every stage artifact
    process 0 wrote (fingerprint match) and ends in the same files."""
    asm, reads = dataset
    out2 = tmp_path / "out2p_resume"
    _run_two_process(asm, reads, out2)
    first = {n: (out2 / n).read_bytes() for n in ARTIFACTS + [SAM]}
    sam_mtime = (out2 / SAM).stat().st_mtime
    (out2 / "hairsplitter_final_assembly.gfa").unlink()
    _run_two_process(asm, reads, out2, extra_args=("--resume",))
    # stage-2 artifact untouched: mapping was skipped, not recomputed
    assert (out2 / SAM).stat().st_mtime == sam_mtime
    for n, data in first.items():
        assert (out2 / n).read_bytes() == data, n
    log0 = (out2 / "hairsplitter.log").read_text()
    log1 = (out2 / "hairsplitter.p1.log").read_text()
    for log in (log0, log1):
        assert "resume: " in log and "alignments loaded from" in log and "read groups loaded from" in log
    # with the final assembly still there, a resumed run has nothing to do
    _run_two_process(asm, reads, out2, extra_args=("--resume",))
    assert "nothing to do" in (out2 / "hairsplitter.log").read_text()


def test_one_contig_two_processes_empty_shard(tmp_path):
    """One contig and two processes: process 1 owns no contig, so its
    stages 3 and 4 run over nothing and it gathers empty dicts."""
    asm, reads = _write_dataset(tmp_path, "_one", 5, 1, 6000, 14, 1600, 0.02, 0.01)
    out2 = tmp_path / "out2p_one"
    _run_two_process(asm, reads, out2)
    out1 = tmp_path / "out1p_one"
    run_pipeline(asm, reads, str(out1), PipelineConfig(no_clean=True, device="cpu"))
    _assert_same_as_single(out2, out1)
    assert _global_error_rate((out2 / "hairsplitter.log").read_text()) == _global_error_rate(
        (out2 / "hairsplitter.p1.log").read_text())


_COMM_WORKER = """
import pickle, sys
import numpy as np
from hairsplitter_tpu_torch.parallel.distributed import (
    Comm, DistConfig, allgather_blobs, init_runtime)
import torch.distributed as tdist

port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_runtime(DistConfig(f"127.0.0.1:{port}", 2, rank, timeout_seconds=120))
comm = Comm()
res = {"me": comm.me, "nproc": comm.nproc}
res["gathered"] = comm.allgather_obj({"rank": comm.me, "arr": np.arange(3 + 5 * comm.me)})
res["empty"] = comm.allgather_obj({})
res["bcast0"] = comm.bcast_obj(("from", comm.me) if comm.me == 0 else None)
res["bcast1"] = comm.bcast_obj(("from", comm.me) if comm.me == 1 else None, root=1)
res["sum"] = comm.allreduce_sum(np.asarray([2.0 ** 53 - 3 * comm.me, 7 + comm.me], np.float64))
res["blobs"] = allgather_blobs(b"" if comm.me == 0 else b"xyz" * 1000)
res["owned"] = comm.owned({"a": 10, "b": 9, "c": 3, "d": 3})
comm.barrier()
tdist.destroy_process_group()
pickle.dump(res, open(out, "wb"))
"""


def test_comm_collectives_over_two_gloo_processes(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"comm{r}.pkl") for r in range(2)]
    _run_workers([[sys.executable, "-c", _COMM_WORKER, str(port), str(r), outs[r]] for r in range(2)])
    res = [pickle.load(open(o, "rb")) for o in outs]
    for r, got in enumerate(res):
        assert got["me"] == r and got["nproc"] == 2
        assert [g["rank"] for g in got["gathered"]] == [0, 1]  # by process id
        assert [g["arr"].tolist() for g in got["gathered"]] == [[0, 1, 2], list(range(8))]
        assert got["empty"] == [{}, {}]
        assert got["bcast0"] == ("from", 0) and got["bcast1"] == ("from", 1)
        assert got["sum"].dtype == np.float64
        assert got["sum"].tolist() == [2.0 ** 54 - 3, 15.0]
        assert got["blobs"] == [b"", b"xyz" * 1000]
    assert res[0]["owned"] == ["a", "d"] and res[1]["owned"] == ["b", "c"]


def test_comm_of_one_process_needs_no_group():
    """Without a process group `Comm` is one process of one, every collective
    returns at once, and `init_runtime` of one process starts nothing."""
    init_runtime(DistConfig(num_processes=1))
    assert not torch.distributed.is_initialized()
    comm = Comm()
    assert (comm.me, comm.nproc) == (0, 1)
    assert comm.allgather_obj({"x": 1}) == [{"x": 1}]
    assert comm.bcast_obj("g") == "g"
    assert comm.allreduce_sum(np.asarray([3, 4])).tolist() == [3.0, 4.0]
    comm.barrier()
    assert comm.owned({"a": 2, "b": 1}) == ["a", "b"]
    with pytest.raises(ValueError):
        init_runtime(DistConfig(num_processes=2))


@pytest.mark.parametrize("seed", range(6))
def test_shard_items_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    # few distinct sizes, so that ties in size and in load are common
    sizes = {f"ctg{int(i)}": int(rng.integers(1, 6)) * 1000 for i in rng.permutation(n)}
    for nproc in (1, 2, 3, 5):
        parts = [shard_items(sizes, nproc, p) for p in range(nproc)]
        assert parts == [jax_shard_items(sizes, nproc, p) for p in range(nproc)]
        assert sorted(sum(parts, [])) == sorted(sizes)


def _leaves(obj, path="obj"):
    """Every leaf of a gathered object with its path; containers, dataclasses
    and numpy arrays are walked or accepted, anything else is a leaf."""
    if is_dataclass(obj) and not isinstance(obj, type):
        for f in fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(k, f"{path}.key")
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, obj


def test_gathered_objects_are_host_data(dataset, tmp_path):
    """What a distributed run all-gathers (alignments, variants, groups) and
    broadcasts (one graph on the wire) is numpy and Python data on every
    leaf, never a tensor, and survives a pickle round trip."""
    import hairsplitter_tpu_torch.pipeline.orchestrate as orch
    from hairsplitter_tpu_torch.io.gfa import parse_gfa

    asm, reads = dataset

    class Recorder:
        me, nproc = 0, 2  # process 0 of two, with the other's part left out
        seen = []

        def owned(self, sizes):
            return list(sizes)

        def allreduce_sum(self, values):
            return np.asarray(values, np.float64)

        def allgather_obj(self, obj):
            self.seen.append(obj)
            return [pickle.loads(pickle.dumps(obj)), type(obj)()]

        def bcast_obj(self, obj, root=0):
            return self.allgather_obj(obj)[root]

        def barrier(self):
            self.fingerprint_written.append((out / "tmp" / "run_fingerprint.txt").exists())

    comm = Recorder()
    comm.fingerprint_written = []
    out = tmp_path / "rec"
    # process 0 maps reads 0, 2, 4, ... only: the run goes on at half the coverage
    run_pipeline(asm, reads, str(out), PipelineConfig(no_clean=True, device="cpu"), comm=comm)
    # alignments, variants, read groups, then this process's own stage 2-4 seconds
    assert len(comm.seen) == 4 and all(len(s) > 0 for s in comm.seen[:3])
    assert isinstance(comm.seen[3], float) and comm.seen[3] > 0
    # process 0 writes the run's fingerprint only after a barrier: the others
    # have read the previous run's by then (they decide on --resume from it)
    assert comm.fingerprint_written == [False]
    comm.seen.append(orch._graph_to_wire(parse_gfa(str(out / "tmp" / "zipped_assembly.gfa"))))
    allowed = (str, int, float, bool, type(None), np.ndarray, np.generic)
    n_leaves = 0
    for obj in comm.seen:
        for path, leaf in _leaves(obj):
            n_leaves += 1
            assert not isinstance(leaf, torch.Tensor), path
            assert isinstance(leaf, allowed), (path, type(leaf))
    assert n_leaves > 1000

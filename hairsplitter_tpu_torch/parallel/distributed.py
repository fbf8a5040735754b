"""Multi-process distributed runtime (torch.distributed over gloo).

Counterpart of `hairsplitter_tpu/parallel/distributed.py`, same names. The
reference is strictly single-node shared-memory: an OpenMP `parallel for`
over contigs with one critical-section reduction for the global error rate
(`src/call_variants.cpp:1276-1371,1310-1316`) and no distributed backend of
any kind. This module provides the missing layer — as a small `Comm`
collective surface that `pipeline.orchestrate.run_pipeline` consumes
directly, so the distributed pipeline IS the single-process pipeline (same
presets, low-memory mode, ploidy capping, POA polish ladder, COL/GRO
artifacts and resume; nothing forked):

  stage 2 (mapping)      — READ data parallelism: every process maps its
                           slice of the read set against the full minimizer
                           index, then alignments are all-gathered.
  stages 3-4 (variants / — CONTIG data parallelism (the reference's OpenMP
  separation)              axis): contigs greedily size-balanced across
                           processes; the global error rate is an all-reduce
                           of (mismatch, cell) sums — the distributed form
                           of the reference's omp-critical accumulation.
  stages 5-6 (new contigs— process 0: graph surgery and untangling are
  / untangling)            pointer-chasing host work on data already reduced
                           by orders of magnitude; process 0 also writes
                           every artifact.

Every collective is gloo over TCP, whatever device the stages run on:
what `Comm` moves is pickled host data (alignments, variants, read groups,
one graph: numpy and Python objects, never a tensor) and one float64 pair.
The result on process 0 is identical to a single-process `run_pipeline` on
the same inputs, the SAM up to the order of its alignment lines
(tests/test_torch_distributed.py).

On one host, one call runs a job over N cards: `run_pipeline` with
`PipelineConfig(devices=N)` (the CLI's `--devices N`) runs the job as
process 0 on the caller's card and hands it to N - 1 worker processes on the
next cards (`WorkerGroup`). The workers start at the first such call, each
pinned to its card with the kernels loaded, and stay up for later calls; a
failed job tears the group down and the next call starts a new one.

Launch by hand (one command per host / process):
  python -m hairsplitter_tpu_torch.parallel.distributed \
      --coordinator HOST:PORT --num-processes N --process-id I \
      -i assembly.gfa -f reads.fa -o outdir [--device cpu]
Process I runs on the I-th card from --device's (`card_of`) when the host
shows that many.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import datetime
import multiprocessing
import os
import pickle
import sys
import time
import traceback
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as tdist

from ..ops import _build
from ..pipeline.orchestrate import Logger, PipelineConfig, run_pipeline
from ..utils import tracing


@dataclass(frozen=True)
class DistConfig:
    coordinator: str = ""  # "host:port" of process 0
    num_processes: int = 1
    process_id: int = 0
    # the JAX package's virtual-CPU-device switch: accepted, without effect
    cpu_devices_per_process: int = 0
    # a process that dies or takes another branch leaves the others in a
    # collective: they give up after this many seconds
    timeout_seconds: float = 1800.0


def init_runtime(cfg: DistConfig) -> None:
    """Join the process group (gloo, on every device) when there is more
    than one process; nothing otherwise."""
    if cfg.num_processes > 1:
        if not cfg.coordinator:
            raise ValueError("--coordinator HOST:PORT is required with more than one process")
        tdist.init_process_group(
            "gloo",
            init_method=f"tcp://{cfg.coordinator}",
            rank=cfg.process_id,
            world_size=cfg.num_processes,
            timeout=datetime.timedelta(seconds=cfg.timeout_seconds),
        )


def shard_items(sizes: dict[str, int], num_processes: int, process_id: int) -> list[str]:
    """Deterministic size-balanced partition (greedy largest-first)."""
    loads = [0] * num_processes
    owner: dict[str, int] = {}
    for name in sorted(sizes, key=lambda n: (-sizes[n], n)):
        p = int(np.argmin(loads))
        loads[p] += sizes[name]
        owner[name] = p
    return [n for n, p in owner.items() if p == process_id]


def allgather_blobs(blob: bytes) -> list[bytes]:
    """All-gather variable-length byte strings, by process id."""
    if not tdist.is_initialized():
        return [blob]
    out: list = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, blob)
    return out


def allreduce_sum(values: np.ndarray) -> np.ndarray:
    """Sum a small fixed-shape float array across all processes: the float64
    vectors are gathered and added in process order. What the pipeline sums
    are integer counts, exact in float64, so any order gives the same."""
    v = np.asarray(values, np.float64)
    parts = [np.frombuffer(b, np.float64).reshape(v.shape) for b in allgather_blobs(v.tobytes())]
    return np.stack(parts).sum(axis=0)


class Comm:
    """The communication surface `pipeline.orchestrate.run_pipeline` uses to
    run distributed — a handful of collectives over the gloo process group.
    Single code path: run_pipeline(comm=Comm()) is the WHOLE distributed
    pipeline; there is no separate stage sequence to drift.

    Each collective is one span "comm" (`utils/tracing.py`) under the stage
    or part that calls it, with the count `bytes`: what this process sent
    and received, pickled. The span holds the pickling, the transfer and
    the wait for the slowest process."""

    def __init__(self):
        up = tdist.is_initialized()
        self.me = tdist.get_rank() if up else 0
        self.nproc = tdist.get_world_size() if up else 1

    def owned(self, sizes: dict[str, int]) -> list[str]:
        """This process's contig shard (deterministic size-balanced)."""
        return shard_items(sizes, self.nproc, self.me)

    def allreduce_sum(self, values: np.ndarray) -> np.ndarray:
        v = np.asarray(values, np.float64)
        with tracing.span("comm") as sp:
            out = allreduce_sum(v)
            sp.add(bytes=v.nbytes * (1 + self.nproc))
        return out

    def allgather_obj(self, obj) -> list:
        """All-gather one picklable object per process (by process id)."""
        with tracing.span("comm") as sp:
            blob = pickle.dumps(obj)
            blobs = allgather_blobs(blob)
            sp.add(bytes=len(blob) + sum(len(b) for b in blobs))
            return [pickle.loads(b) for b in blobs]

    def bcast_obj(self, obj, root: int = 0):
        """Broadcast a picklable object from `root` (collective: every
        process must call; non-root may pass None)."""
        return self.allgather_obj(obj)[root]

    def barrier(self) -> None:
        self.allreduce_sum(np.zeros(1))


def run_pipeline_distributed(
    assembly_path: str,
    reads_path: str,
    out_dir: str,
    cfg=None,
    dist: DistConfig = DistConfig(),
):
    """Run the ONE pipeline code path across the process group: reads
    sharded for mapping, contigs for variants/separation, error rate
    all-reduced, graph stages + every artifact on process 0. All flags
    (presets, low-memory, ploidy, POA ladder, resume, COL/GRO) behave
    exactly as `run_pipeline` single-process, because it IS `run_pipeline`.
    Returns the final GFA path on process 0, None elsewhere."""
    return run_pipeline(
        assembly_path, reads_path, out_dir, cfg or PipelineConfig(), comm=Comm()
    )


def card_of(device: str, rank: int, visible: int) -> str:
    """The device of process `rank` of a job over several processes: on CUDA
    the card `rank` places after the one `device` names ("cuda" is card 0)
    when the host shows `visible` cards or more up to it, else `device` as
    given (every process on it); off CUDA, `device`. The launcher (`main`)
    and `WorkerGroup` both place their processes with it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return device
    card = (dev.index or 0) + rank
    return f"cuda:{card}" if card < visible else device


def thread_share(devices: int) -> int:
    """Torch's intra-op threads for each of `devices` processes on one host:
    the cores this process may run on, split evenly, so that the processes
    together take no more threads than there are cores."""
    return max(1, len(os.sched_getaffinity(0)) // devices)


def load_program(device: str) -> None:
    """Load the native library and, on CUDA, the kernels (building them at
    a checkout's first use)."""
    from .. import native

    native.get_lib()
    if torch.device(device).type == "cuda":
        _build.load_kernels()


def _log_launches(out_dir: str, log_name: str, before: dict[str, int]) -> None:
    """Log the job's CUDA kernel launches: the counts since `before`, so
    that each job of a long-lived process counts its own."""
    counts = {k: v - before.get(k, 0) for k, v in _build.kernel_launch_counts().items()}
    Logger(os.path.join(out_dir, log_name)).log(
        "kernel launches: " + " ".join(f"{k}={v}" for k, v in counts.items()))


class WorkerFailed(RuntimeError):
    """A worker of a job spread over several cards raised or died."""


def _worker(rank: int, world: int, port: int, device: str, threads: int, timeout_s: float, conn) -> None:
    """One worker process: bound to its card, program loaded, joined to the
    caller's gloo group as `rank`; then one job per message until None (or
    until the caller is gone). A job that raises sends its traceback and
    ends the process, which closes its sockets: every peer still in a
    collective with it raises at once instead of waiting out the timeout."""
    sys.stdout = open(os.devnull, "w")  # the worker's lines go to its own log file
    torch.set_num_threads(threads)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        load_program(device)
        conn.send(("loaded", device))
        store = tdist.TCPStore("127.0.0.1", port, world, False,
                               timeout=datetime.timedelta(seconds=timeout_s))
        tdist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                 timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        os._exit(1)
    while True:
        try:
            job = conn.recv()
        except EOFError:
            break
        if job is None:
            break
        assembly_path, reads_path, out_dir, cfg = job
        try:
            before = _build.kernel_launch_counts()
            run_pipeline(assembly_path, reads_path, out_dir, replace(cfg, device=device), comm=Comm())
            _log_launches(out_dir, f"hairsplitter.p{rank}.log", before)
        except BaseException:
            conn.send(("error", traceback.format_exc()))
            os._exit(1)
        conn.send(("done", None))
    tdist.destroy_process_group()


class WorkerGroup:
    """`devices - 1` worker processes (`_worker`), worker i on
    `card_of(device, i, ...)` with `thread_share(devices)` intra-op threads,
    joined over gloo with the calling process as rank 0 in the default
    process group."""

    def __init__(self, devices: int, device: str, timeout_s: float):
        self.devices, self.device = devices, device
        self.procs: list = []
        self.conns: list = []
        self.visible = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
        if torch.device(device).type == "cuda":
            last = (torch.device(device).index or 0) + devices - 1
            if last >= self.visible:
                raise ValueError(f"{devices} cards from {device} need card {last}; "
                                 f"torch sees {self.visible}")
        if tdist.is_initialized():
            raise RuntimeError("a process group is already up in this process")
        load_program(self.card(0))  # build once here, before the workers load
        store = tdist.TCPStore("127.0.0.1", 0, devices, True, wait_for_workers=False,
                               timeout=datetime.timedelta(seconds=timeout_s))
        ctx = multiprocessing.get_context("spawn")
        try:
            for rank in range(1, devices):
                mine, theirs = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker, daemon=True, name=f"hairsplitter-worker-{rank}",
                    args=(rank, devices, store.port, self.card(rank), thread_share(devices),
                          timeout_s, theirs),
                )
                proc.start()
                theirs.close()
                self.procs.append(proc)
                self.conns.append(mine)
            for rank in range(1, devices):
                self._reply(rank, "loaded")
            tdist.init_process_group("gloo", store=store, rank=0, world_size=devices,
                                     timeout=datetime.timedelta(seconds=timeout_s))
        except BaseException:
            self.close()
            raise

    def card(self, rank: int) -> str:
        return card_of(self.device, rank, self.visible)

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def _reply(self, rank: int, want: str):
        """The next message of worker `rank`, which must be `want`; raises
        WorkerFailed on an error, or once the worker is gone without one."""
        conn, proc = self.conns[rank - 1], self.procs[rank - 1]
        while not conn.poll(0.5):
            if not proc.is_alive() and not conn.poll(0):
                raise WorkerFailed(f"worker {rank} exited with code {proc.exitcode}")
        try:
            kind, payload = conn.recv()
        except EOFError:
            raise WorkerFailed(f"worker {rank} exited with code {proc.exitcode}") from None
        if kind == "error":
            raise WorkerFailed(f"worker {rank} raised:\n{payload}")
        if kind != want:
            raise WorkerFailed(f"worker {rank} sent {kind!r} where {want!r} was due")
        return payload

    def _first_failure(self, grace_s: float) -> WorkerFailed | None:
        """The failure of the first worker that raised or died within
        `grace_s` seconds, if any."""
        until = time.monotonic() + grace_s
        while True:
            for rank, (conn, proc) in enumerate(zip(self.conns, self.procs), start=1):
                if conn.poll(0) or not proc.is_alive():
                    try:
                        self._reply(rank, "done")
                    except WorkerFailed as exc:
                        return exc
            if time.monotonic() >= until:
                return None
            time.sleep(0.1)

    def run(self, assembly_path: str, reads_path: str, out_dir: str, cfg: PipelineConfig):
        """One job over every card; returns once every worker has finished
        it and closed its files in `out_dir`. Any failure closes the group
        and raises (WorkerFailed when a worker's)."""
        job = (assembly_path, reads_path, out_dir, cfg)
        dev = self.card(0)
        threads = torch.get_num_threads()
        try:
            for conn in self.conns:
                conn.send(job)
            torch.set_num_threads(thread_share(self.devices))
            before = _build.kernel_launch_counts()
            with torch.cuda.device(torch.device(dev)) if dev.startswith("cuda") else contextlib.nullcontext():
                out = run_pipeline(assembly_path, reads_path, out_dir, replace(cfg, device=dev), comm=Comm())
            for rank in range(1, self.devices):
                self._reply(rank, "done")
            _log_launches(out_dir, "hairsplitter.log", before)
            return out
        except BaseException as exc:
            failure = None if isinstance(exc, WorkerFailed) else self._first_failure(grace_s=5.0)
            self.close()
            if failure is not None:
                raise failure from exc
            raise
        finally:
            torch.set_num_threads(threads)

    def close(self) -> None:
        """Stop the workers (politely, then by force) and leave the group."""
        for conn in self.conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for proc in self.procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self.conns:
            conn.close()
        self.procs, self.conns = [], []
        if tdist.is_initialized():
            tdist.destroy_process_group()
        global _GROUP
        if _GROUP is self:
            _GROUP = None


_GROUP: WorkerGroup | None = None
# the worker group's collective timeout: only a process that hangs waits
# this long, since one that raises or dies closes its sockets at once
GROUP_TIMEOUT_S = DistConfig.timeout_seconds


def worker_group(devices: int, device: str) -> WorkerGroup:
    """The process's worker group for `devices` cards from `device`: the
    one already up when it matches and every worker lives, else a new one."""
    global _GROUP
    if _GROUP is not None and not (
        _GROUP.devices == devices and _GROUP.device == device and _GROUP.alive()
    ):
        _GROUP.close()
    if _GROUP is None:
        _GROUP = WorkerGroup(devices, device, GROUP_TIMEOUT_S)
    return _GROUP


def _close_group() -> None:
    if _GROUP is not None:
        _GROUP.close()


atexit.register(_close_group)


def run_on_devices(assembly_path: str, reads_path: str, out_dir: str, cfg: PipelineConfig):
    """`run_pipeline` of one job over `cfg.devices` cards (or CPU
    processes): this process is process 0 and writes every artifact,
    `hairsplitter.log` and `stage_stats.json`; worker i writes only its
    `hairsplitter.p<i>.log` and `stage_stats.p<i>.json`."""
    return worker_group(cfg.devices, cfg.device).run(assembly_path, reads_path, out_dir, cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description="distributed hairsplitter_tpu_torch")
    ap.add_argument("--coordinator", default="", help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="accepted for the JAX package's launch line; without effect")
    ap.add_argument("-i", dest="assembly", required=True)
    ap.add_argument("-f", dest="reads", required=True)
    ap.add_argument("-o", dest="out", required=True)
    ap.add_argument("-c", dest="haploid_coverage", type=float, default=0.0)
    ap.add_argument("-x", dest="technology", default="ont")
    ap.add_argument("-s", dest="dont_simplify", action="store_true")
    ap.add_argument("-l", dest="low_memory", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device stages on every process (default cuda: "
                    "process I on the I-th card from this one when the host has that many; cpu "
                    "runs the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    cfg_dist = DistConfig(args.coordinator, args.num_processes, args.process_id, args.cpu_devices)
    visible = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
    device = card_of(args.device, args.process_id, visible)
    if device != args.device:
        torch.cuda.set_device(torch.device(device))
    cfg = PipelineConfig(
        technology=args.technology,
        haploid_coverage=args.haploid_coverage,
        dont_simplify=args.dont_simplify,
        low_memory=args.low_memory,
        resume=args.resume,
        no_clean=True,
        device=device,
    )
    if args.cpu_devices:
        print("note: --cpu-devices has no effect here (the device is chosen with --device)",
              file=sys.stderr, flush=True)
    init_runtime(cfg_dist)
    try:
        before = _build.kernel_launch_counts()
        run_pipeline_distributed(args.assembly, args.reads, args.out, cfg, dist=cfg_dist)
        worker = args.num_processes > 1 and args.process_id > 0
        _log_launches(args.out, f"hairsplitter.p{args.process_id}.log" if worker else "hairsplitter.log", before)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

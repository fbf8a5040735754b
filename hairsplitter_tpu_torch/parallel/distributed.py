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

Launch (one command per host / process):
  python -m hairsplitter_tpu_torch.parallel.distributed \
      --coordinator HOST:PORT --num-processes N --process-id I \
      -i assembly.gfa -f reads.fa -o outdir [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import sys
from dataclasses import dataclass

import numpy as np
import torch.distributed as tdist

from ..pipeline.orchestrate import Logger, PipelineConfig, run_pipeline


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
    pipeline; there is no separate stage sequence to drift."""

    def __init__(self):
        up = tdist.is_initialized()
        self.me = tdist.get_rank() if up else 0
        self.nproc = tdist.get_world_size() if up else 1

    def owned(self, sizes: dict[str, int]) -> list[str]:
        """This process's contig shard (deterministic size-balanced)."""
        return shard_items(sizes, self.nproc, self.me)

    def allreduce_sum(self, values: np.ndarray) -> np.ndarray:
        return allreduce_sum(values)

    def allgather_obj(self, obj) -> list:
        """All-gather one picklable object per process (by process id)."""
        return [pickle.loads(b) for b in allgather_blobs(pickle.dumps(obj))]

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


def kernel_launch_counts() -> dict[str, int]:
    """This process's CUDA kernel launches so far, by kernel."""
    from ..ops import align_dp_cuda, align_myers_cuda

    return {
        "myers_fused": align_myers_cuda.myers_fused_cuda.launches,
        "myers_rows": align_myers_cuda.myers_rows.launches,
        "banded_fused": align_dp_cuda.banded_fused_cuda.launches,
        "banded_dp": align_dp_cuda.banded_align_batch_dp.launches,
    }


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
                    help="torch device of the device stages on every process (default cuda; "
                    "cpu runs the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    cfg_dist = DistConfig(args.coordinator, args.num_processes, args.process_id, args.cpu_devices)
    cfg = PipelineConfig(
        technology=args.technology,
        haploid_coverage=args.haploid_coverage,
        dont_simplify=args.dont_simplify,
        low_memory=args.low_memory,
        resume=args.resume,
        no_clean=True,
        device=args.device,
    )
    if args.cpu_devices:
        print("note: --cpu-devices has no effect here (the device is chosen with --device)",
              file=sys.stderr, flush=True)
    init_runtime(cfg_dist)
    try:
        run_pipeline_distributed(args.assembly, args.reads, args.out, cfg, dist=cfg_dist)
        many = args.num_processes > 1
        log_name = f"hairsplitter.p{args.process_id}.log" if many else "hairsplitter.log"
        log = Logger(os.path.join(args.out, log_name))
        counts = kernel_launch_counts()
        log.log("kernel launches: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`hairsplitter_tpu_torch`) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py
    python3 chip_smoke.py --only devices    # phases 1, 2 and 10's cards part alone

Phases (each prints its result; any failure raises and exits non-zero):
  1. environment: a CUDA device is required; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the CUDA kernels from `hairsplitter_tpu_torch/csrc/`
     with nvcc for sm_90a (one nvcc per source, in parallel), and the port's
     own native host library (`csrc/hs_native.cpp`) with g++, both into the
     package's build directory; the native library must load, so that no
     run on the card quietly takes the pure-Python twins;
  3. kernels vs plain versions, on 8,192 seeded random jobs at the main
     path's shape (B = 256, W = 128, edge cases included): K1's check mode,
     `myers_rows`, must equal `myers_rows_torch` in its four word streams;
     K1's main-path mode, the fused kernel `myers_fused_cuda`, must equal
     the plain composition `myers_fused_plain` byte for byte on those jobs
     and on hand-made edge jobs, each with alternating, all-global and
     all-extension modes; K2's check mode, `banded_align_batch_dp`, must
     equal `banded_align_batch_torch` in all four outputs in both plane
     modes (uint8 bp, int16 enc), bit for bit; K2's main-path mode, the
     fused kernel `banded_fused_cuda`, must equal the plain composition
     `banded_fused_plain` byte for byte on the same jobs and mode patterns
     as K1's; all are timed with CUDA events and held against their bounds.
     At 32,768 jobs the fused mapping call with K2 (kernel="pallas") must
     equal the call with K1 byte for byte, one call of either must be
     exactly one device launch of its fused kernel (torch.profiler), and
     the calls are timed, K1's also with its host copies. Stage 3's
     window-stats kernel, `window_stats_cuda`, must equal
     `window_stats_plain` and the numpy twins block by block at clonal30x's
     blocks (26 x 64 rows x 8,192) and an amplicon sample's (2 x 2,000
     rows), one launch a call, timed alone beside its bound and beside the
     staged round trip that `finish_preps` makes. Seeding and chaining on the
     card (`ops/chain_seeds.py:find_chains_cuda`, `csrc/chain_seeds.cu`) on a
     clonal30x pool job must give the host route's chains
     (`find_chains_batch`) read by read, one launch a call; the kernel is
     timed alone with CUDA events beside its bound, the whole card route
     (packing, copies, unpacking) and the host route on the host clock. The
     CIGAR walk on the card (`ops/pileup_cells.py`, `csrc/pileup_cells.cu`)
     on that job, mapped on the card, must give the host copies' cells,
     insertions, window blocks and stats, one launch of the walk and one of
     the window stats a call; the walk is timed alone with CUDA events
     beside its bound, the card route and the host copies on the host clock;
  4. main path, K1: builds the 300 kb x 3-strain, 30x, 10%-error dataset
     (seed 7) and runs the port's CLI on cuda; the fused kernel's launch
     counter must be > 0 and the check-mode kernel's must stay 0, the
     window-stats kernel and the CIGAR walk must launch once for the job
     (stage 5 walks nothing: its `cells` span reads `walked` 0) and the
     chain kernel once for each `map_reads` call that seeds (every count here is a
     difference of `kernel_launch_counts()` over the run), the final GFA
     must exist and every strain's recovery must be >= 0.95;
  5. main path, K2: the same dataset through `run_pipeline` with
     `PipelineConfig(map=MapConfig(use_myers=False))` on cuda; the fused
     K2 kernel's launch counter must be > 0, K2's check-mode kernel must not
     launch at all, and K1's counter must not move during stage 2, the mapping
     that `PipelineConfig.map` configures (the stage-5 and stage-6 remaps
     map with the default MapConfig, K1, in the JAX package too); the SAM
     and the final GFA must be byte-identical to phase 4's and every
     strain's recovery must be >= 0.95;
  6. medaka+tailor: the same dataset with its assembly broken on purpose (a
     chimeric contig that joins two distant pieces, the piece between them
     and the end as contigs of their own, no link) through the CLI with
     `--correct-assembly -p medaka` on cuda: stage 1b must report more
     end-to-end reads after than before, at least one cut and one new link,
     and launch the fused K1 kernel; no check-mode kernel may launch; the NN
     caller must be called, on the card; every strain's recovery must be
     >= 0.95 and within 0.005 of phase 4's;
  7. polisher: `PolisherCNN` with the shipped weights on the card against
     itself on the CPU on seeded features at L = 256, 4,096 and 65,536
     (logits within atol 1e-4; bases equal where the top-two margin is above
     1e-3; TF32 must be off);
  8. graphunzip: a 20 kb two-strain dataset whose stage 6 duplicates a contig
     runs through the CLI on cuda; then `graphunzip unzip -g -l -r` on that
     run's zipped graph and GAF, and `graphunzip hic-im` on simulated mate
     pairs, each on cuda and with `--device cpu`: the outputs must be equal
     (GFA byte for byte, the matrix exactly) and K1 must launch on cuda;
  9. bihap: `spectral_phase` on the card against the CPU on a seeded
     two-haplotype allele matrix: the same partition of the reads;
 10. distributed (run after phase 6, on its dataset): the 300 kb assembly as
     three contigs of 100 kb with their two links, through the CLI in this
     process, through one new process of
     `python -m hairsplitter_tpu_torch.parallel.distributed` (for a wall
     time that carries the same start-up) and then through two, both on
     cuda:0, joined by gloo over 127.0.0.1: process 0's artifacts must be
     byte-identical to the single-process run's (the SAM as sorted lines
     under an equal header), process 1 must write nothing but its log and
     stage statistics, every strain's recovery must be >= 0.95, and each
     process must report at least one fused K1 launch and no check-mode
     launch in its log. On a host with N >= 2 cards (up to 4), then one job
     of the benchmark cell `strains-ont-dist4.meta10x30`'s pool on cuda:0
     in this process, and through `run_pipeline` with
     `PipelineConfig(devices=N)` twice (the worker group started, then
     reused) and the CLI's `--devices N` once (the same group): every
     artifact byte-identical to the one-card run's (the SAM as sorted lines;
     the CLI's fingerprint file aside, whose -q reads "0" for "0.0"), the
     log of process i naming `device: cuda:i` and ending with that job's
     launches: at least one fused K1 launch and none of a check mode,
     process 0's count equal to this process's launches during the run;
     process 0's `stage_stats.json` holding the collectives and
     `shard.p<i>`; the output judged correct under the cell's limits by
     `benchmark/reference/judge.py`. `--only devices` runs phases 1, 2 and
     this part alone;
 11. mesh: on `make_mesh(["cuda:0"])`, `phase_shard_step` at C = 2, Rr = 512,
     Pp = 2048, S = 256, K = 8, `column_stats_shard_step` on its pileup and
     `map_shard_step` at 8,192 jobs of the default BandSpec with K1's and
     K2's kernel: each must equal the same call on `make_mesh(["cpu"])` (the
     plain versions) bit for bit, the map steps must launch the fused K1 and
     K2 kernels once each; all are timed with CUDA events;
 12. train: the polisher's training on the card. (a) Two realistic training
     pairs (plain and hp-biased reads, L = 2048) mapped on cuda must equal
     the pairs mapped on the CPU byte for byte; (b) one Adam step from the
     same initial weights on one seeded batch (4 x 256): loss and every
     parameter on cuda within 1e-5 of the CPU's (a batch of 8 x 512, where
     some gradients cancel to within Adam's eps, is printed beside the CPU's
     own distance from the float64 step); (c) two 20-step trainings on cuda with
     one seed must give bit-identical weights; (d) the training of
     `scripts/train_polisher.py` at its full size (800 steps, 48 realistic
     pairs) through `scripts/torch_train_polisher.py` into a temporary file:
     its held-out column accuracy must beat plain majority and reach 0.99;
     K1 must launch, its check mode never;
 13. quality: the 1 Mbp metagenome of `scripts/torch_eval_quality.py`
     (4 of its 10 species x 100 kb, 30x of 8 kb reads, 10% error) on cuda:
     min strain recovery >= 0.95 and at most 1 switch error
     (`eval_quality.py`'s targets); K1 must launch, its check mode never;
 14. bench: the kernel blocks of `bench_torch.py` on cuda at their sizes
     (`fused_production_rate` with K1 and with K2, `transfer_profile`,
     `raw_kernel_rate`, which launches K1's check mode), their dicts printed;
     then `bench_torch.main` with its size table cut to `BENCH_TOY` must print
     exactly one JSON line with a positive headline and no failed or skipped
     block. This phase is no path: its launches, counted from just before
     it, go on a `[launches]` line of their own and into no path's count;
then prints the kernel table as one JSON line, the card line, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from benchmark.metrics._roofline import (
    HBM_BYTES_PER_S, OPS_DP_CELL, OPS_FUSED_ROW, OPS_MYERS_ROW, OPS_WALK_ROW, bound_s)
from hairsplitter_tpu_torch.ops._build import kernel_launch_counts

B = 256  # main-path chunk (BandSpec.chunk)
N_CHECK = 8192  # jobs of the kernel-vs-plain check
N_FUSED = 32768  # jobs of the fused-call timing (~ stage 2 of the smoke dataset)
MIN_RECOVERY = 0.95
MIN_HELD_OUT = 0.99  # the polisher's held-out column accuracy (JAX record 0.9934)
# the metagenome's species: 4 of scripts/eval_quality.py's 10 (10 strains, ~12
# Mbp of reads), its depth cut so that the whole script stays near 300 s of
# command time (at 10 species it took 349.5 s, PERF.md §4); contig length,
# coverage and error are the scenario's own
QUALITY_SPECIES = 4
# bench_torch.main's sizes in the bench phase: the contract, not a measurement
BENCH_TOY = {
    "fused_jobs": 2048,
    "fused_single_jobs": 256,
    "raw_kernel_jobs": 256,
    "mapping": dict(size=20_000, coverage=4, read_len=4000),
    "pipeline": dict(length=20_000, strains=2, coverage=8, read_len=4000),
    "quality": dict(length=20_000, coverage=20, read_len=4000),
}


def random_jobs(rng: np.random.Generator, n: int, spec):
    """Seeded mapping-like jobs: noisy target copies of random queries, with
    empty queries, full-length queries, targets far shorter than the query
    and all-sentinel rows mixed in."""
    from hairsplitter_tpu_torch.ops.align import Q_SENTINEL, T_SENTINEL

    B, T = spec.chunk, spec.t_width
    q = np.full((n, B), Q_SENTINEL, np.int8)
    t = np.full((n, T), T_SENTINEL, np.int8)
    qlens = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    for i in range(n):
        kind = i % 8
        if kind == 7:  # all-sentinel row
            continue
        ql = 0 if kind == 0 else B if kind == 1 else int(rng.integers(1, B + 1))
        base = rng.integers(0, 4, ql).astype(np.int8)
        if kind == 2:  # target much shorter than the query
            tl = max(0, ql - 64 - int(rng.integers(1, 64)))
            ts = base[:tl].copy()
        elif kind == 3:  # unrelated target
            tl = int(rng.integers(0, T + 1))
            ts = rng.integers(0, 4, tl).astype(np.int8)
        else:  # noisy copy with indels
            keep = rng.random(ql) > 0.05
            ts = base[keep]
            ins = rng.random(ts.size) < 0.05
            ts = np.insert(ts, np.nonzero(ins)[0], rng.integers(0, 4, int(ins.sum())).astype(np.int8))
            sub = rng.random(ts.size) < 0.06
            ts[sub] = rng.integers(0, 4, int(sub.sum()))
            ts = ts[:T]
            tl = ts.size
        q[i, :ql] = base
        t[i, :tl] = ts[:tl]
        qlens[i], tlens[i] = ql, tl
    return q, qlens, t, tlens


def edge_jobs(spec, seed: int = 11):
    """Hand-made jobs at the corners of the fused call's definition: every
    pair of qlen in {0, 1, 2, B/2, B-1, B, B+1} and tlen in {0, 1, qlen,
    qlen-64-5 (the corner leaves the band on the left), qlen+63, qlen+64
    (leaves it on the right), T}, each once with the target an exact copy of
    the query as far as it reaches and once with an unrelated target.
    qlen = B+1 is a length the packer never makes; the plain version defines
    it (an all-INF extension row) and the kernel must agree."""
    from hairsplitter_tpu_torch.ops.align import Q_SENTINEL, T_SENTINEL

    rng = np.random.default_rng(seed)
    B, T = spec.chunk, spec.t_width
    jobs = []
    for ql in (0, 1, 2, B // 2, B - 1, B, B + 1):
        for tl in (0, 1, ql, ql - 64 - 5, ql + 63, ql + 64, T):
            if not 0 <= tl <= T:
                continue
            for related in (True, False):
                jobs.append((ql, tl, related))
    n = len(jobs)
    q = np.full((n, B), Q_SENTINEL, np.int8)
    t = np.full((n, T), T_SENTINEL, np.int8)
    qlens = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    for i, (ql, tl, related) in enumerate(jobs):
        base = rng.integers(0, 4, max(ql, tl)).astype(np.int8)
        q[i, : min(ql, B)] = base[: min(ql, B)]
        t[i, :tl] = base[:tl] if related else rng.integers(0, 4, tl)
        qlens[i], tlens[i] = ql, tl
    return q, qlens, t, tlens


MODE_PATTERNS = ("alternating", "global", "extension")


def mode_pattern(name: str, n: int) -> np.ndarray:
    """int32 modes [n]: 0 = global, 1 = extension."""
    if name == "alternating":
        return (np.arange(n) % 2).astype(np.int32)
    return np.full(n, 0 if name == "global" else 1, np.int32)


def window_blocks(rng: np.random.Generator, rows, P: int):
    """Seeded stage-3 window blocks, one per entry of `rows` (its row count),
    with the contig codes under each: int8 trimer codes [R, P] and int8
    contig codes [P]. 60% of cells are present, drawn from four codes a
    column so that counts tie often; every 7th column is absent in all rows,
    the columns past the block's length (the last fifth) are absent with
    contig code 5 (PAD), columns 1 mod 7 alternate a large and a small code
    from the first row, so that with an even row count their counts tie and
    the smaller code must win; a block of more than 65,535 rows puts one
    code in every row of columns 2 to 5."""
    TRIMER_ABSENT = 127
    length = P - P // 5
    tris, codes = [], []
    for R in rows:
        alphabet = rng.integers(0, 125, (P, 4))
        tri = alphabet[np.arange(P)[None, :], rng.integers(0, 4, (R, P))].astype(np.int8)
        tri[rng.random((R, P)) >= 0.6] = TRIMER_ABSENT
        tri[:, ::7] = TRIMER_ABSENT
        tie = np.arange(1, P, 7)
        tri[:, tie] = np.where(np.arange(R)[:, None] % 2 == 0, 120, 3)
        if R > 65_535:
            tri[:, 2:6] = 62
        tri[:, length:] = TRIMER_ABSENT
        code = rng.integers(0, 4, P).astype(np.int8)
        code[length:] = 5
        tris.append(tri)
        codes.append(code)
    return tris, codes


def break_assembly(hap: str) -> dict[str, str]:
    """The 300 kb assembly broken the way tests/test_tailor.py breaks its
    assemblies: `chim` joins the first 100 kb to the distant piece
    200-250 kb (a misjoin), and what lies between and after them are contigs
    of their own, every link left out."""
    return {
        "chim": hap[:100_000] + hap[200_000:250_000],
        "mid": hap[100_000:200_000],
        "end": hap[250_000:],
    }


def two_strain_dataset(root: str, length=20_000, shared=(7800, 12200), read_len=7000, coverage=15, seed=1):
    """A 20 kb genome in two strains that differ by 1% outside `shared`,
    where they are identical, so that stage 6 duplicates the shared contig
    and re-polishes the copies; 10% read error. The assembly is strain 1.
    Returns (assembly path, reads path, haplotypes)."""
    from hairsplitter_tpu_torch.io.fasta import write_fasta
    from hairsplitter_tpu_torch.utils import sim

    rng = np.random.default_rng(seed)
    backbone = sim.random_genome(length, rng)
    lo, hi = shared
    left, _ = sim.mutate(backbone[:lo], 0.01, rng)
    right, _ = sim.mutate(backbone[hi:], 0.01, rng)
    haps = [backbone, left + backbone[lo:hi] + right]
    reads = sim.simulate_reads(
        haps, coverage=coverage, read_len=read_len, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
    )
    asm_path = os.path.join(root, "assembly.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm_path, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, haps


def partition(labels: np.ndarray) -> set:
    return {frozenset(np.nonzero(labels == g)[0].tolist()) for g in set(labels.tolist())}


DIST_ARTIFACTS = (
    "tmp/variants.col", "tmp/error_rate.txt", "tmp/reads_haplo.gro", "tmp/zipped_assembly.gfa",
    "tmp/reads_on_new_contig.gaf", "variants.vcf", "hairsplitter_final_assembly.gfa",
    "hairsplitter_final_assembly.fasta", "hairsplitter_summary.txt",
)
DIST_TIMEOUT = 600  # seconds for the two workers together


def sam_parts(path: str):
    """(header lines, sorted alignment lines) of a SAM file."""
    with open(path) as f:
        lines = f.read().splitlines()
    return [l for l in lines if l.startswith("@")], sorted(l for l in lines if not l.startswith("@"))


def run_processes(repo: str, asm_path: str, reads_path: str, out: str, nproc: int) -> float:
    """`nproc` new processes of the distributed entry point on cuda:0,
    rendezvous on a free local port; all are killed if one fails or outlasts
    the limit. Returns the wall seconds from the first start to the last exit."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "hairsplitter_tpu_torch.parallel.distributed",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(nproc), "--process-id", str(rank),
             "-i", asm_path, "-f", reads_path, "-o", out],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(nproc)
    ]
    outs = []
    try:
        for proc in procs:
            left = DIST_TIMEOUT - (time.perf_counter() - t0)
            outs.append(proc.communicate(timeout=max(left, 1))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    for rank, (proc, text) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"distributed process {rank} exited with {proc.returncode}:\n{text[-3000:]}"
    return wall


def devices_phase(n: int, device: str = "cuda") -> dict:
    """One pool job of the four-card cell on `device` here, then over `n`
    cards (run_pipeline twice, the CLI once): equal outputs, each process on
    its own card with its own launches (process 0's equal to this process's
    during the run), judged correct. With device "cpu" the same runs go
    over CPU processes, with no launch to count (a rehearsal off the card)."""
    import torch

    from benchmark import manifest
    from benchmark.reference import judge as J
    from benchmark.traffic import generate
    from hairsplitter_tpu_torch import cli
    from hairsplitter_tpu_torch.parallel import distributed
    from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig, run_pipeline

    cell = manifest.load_cell("strains-ont-dist4.meta10x30")
    job = generate.make_job(cell.params, [int(cell.params.get("content_seed", 0)), 0, 0])
    pipeline = {k: v for k, v in cell.config["pipeline"].items() if k != "devices"}
    logs = ("hairsplitter.log", "stage_stats.json")

    def outputs(out):
        return sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs
                      if os.path.relpath(os.path.join(d, f), out) not in logs)

    with tempfile.TemporaryDirectory(prefix="hs_devices_") as root:
        generate.write_job(job, os.path.join(root, "job"))
        asm, reads = job.paths["assembly"], job.paths["reads"]
        walls, outs = {}, {}
        one = os.path.join(root, "one")
        t0 = time.perf_counter()
        run_pipeline(asm, reads, one, PipelineConfig(**pipeline, device=device))
        walls["one card"] = time.perf_counter() - t0
        for label in ("cards, group started", "cards, group reused", "cli --devices"):
            outs[label] = os.path.join(root, re.sub(r"\W+", "_", label))
            base = kernel_launch_counts()
            t0 = time.perf_counter()
            if label.startswith("cli"):
                pids = [p.pid for p in distributed._GROUP.procs]
                assert cli.main(["-i", asm, "-f", reads, "-o", outs[label], "--devices", str(n),
                                 "--device", device]) == 0
                assert [p.pid for p in distributed._GROUP.procs] == pids, "the CLI call started another group"
            else:
                run_pipeline(asm, reads, outs[label], PipelineConfig(**pipeline, device=device, devices=n))
            walls[label] = time.perf_counter() - t0
            here = launches_since(base)
            names = outputs(one)
            assert outputs(outs[label]) == sorted(names + [f"{k}.p{i}.{e}" for i in range(1, n) for k, e in
                                                           (("hairsplitter", "log"), ("stage_stats", "json"))])
            for rel in names:
                a, b = os.path.join(one, rel), os.path.join(outs[label], rel)
                if rel.endswith(".sam"):
                    assert sam_parts(a) == sam_parts(b), f"{label}: {rel} differs beyond the order of its lines"
                elif not (label.startswith("cli") and rel == "tmp/run_fingerprint.txt"):
                    assert open(a, "rb").read() == open(b, "rb").read(), f"{label}: {rel} differs from one card's"
            launches = []
            for i in range(n):
                with open(os.path.join(outs[label], f"hairsplitter.p{i}.log" if i else "hairsplitter.log")) as f:
                    text = f.read()
                card = distributed.card_of(device, i, torch.cuda.device_count())
                assert f"device: {card}\n" in text, f"{label}: process {i} did not run on {card}"
                counts = dict((k, int(v)) for k, v in re.findall(r"(\w+)=(\d+)", text.splitlines()[-1]))
                assert counts["myers_fused"] > 0 or device == "cpu", f"{label}: process {i} launched no fused K1"
                assert counts["myers_rows"] == 0 and counts["banded_dp"] == 0, f"{label}: process {i} check mode"
                if i == 0:
                    assert all(counts[k] == v for k, v in here.items()), f"{label}: log {counts}, this process {here}"
                launches.append(counts["myers_fused"])
            print(f"[devices] {label}: {walls[label]:.3f} s against {walls['one card']:.3f} s on one card; "
                  f"{len(names)} artifacts equal; fused K1 launches by process {launches}", flush=True)
        with open(os.path.join(outs["cards, group reused"], "stage_stats.json")) as f:
            stats = json.load(f)
        comm = {k: v["seconds"] for k, v in stats.items() if k == "comm" or k.endswith(".comm")}
        assert {"mapping.comm", "call_variants.comm", "separate_reads.comm"} <= set(comm), comm
        shards = [stats[f"shard.p{i}"]["seconds"] for i in range(n)]
        files = {}
        for key, rel in J.ARTIFACTS.items():
            with open(os.path.join(outs["cards, group reused"], rel)) as f:
                files[key] = f.read()
        truth = J.truth_of(job, np.random.default_rng(1))
        J.reference_costs([truth], device)
        numbers = J.judge(truth, files)
        ok, rows = J.verdict(numbers, cell.limits)
        assert ok, rows
    distributed._close_group()
    summary = {"devices": n, "read_bp": job.reads.bases, "seconds": walls, "comm": comm, "shards": shards,
               "numbers": numbers}
    print(f"[devices] {json.dumps(summary)}", flush=True)
    return summary


def build_dataset(root: str):
    """The smoke dataset (`scripts/bench_pipeline.py:build_dataset` defaults):
    300 kb x 3 strains at 1% divergence, 30x of 8 kb reads, 10% error
    (60% substitutions), seed 7; the assembly is the first strain.
    Returns (assembly path, reads path, haplotypes, reads)."""
    from hairsplitter_tpu_torch.io.fasta import write_fasta
    from hairsplitter_tpu_torch.utils import sim

    rng = np.random.default_rng(7)
    haps = sim.make_haplotypes(300_000, 3, 0.01, rng)
    reads = sim.simulate_reads(
        haps, coverage=30.0 / 3, read_len=8000, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
    )
    asm_path = os.path.join(root, "assembly.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm_path, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, haps, reads


def load_script(name: str):
    """A module of the repo's `scripts/` folder, loaded by its path (the
    folder is no package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """Each kernel's launches in this process since `before`, a
    `kernel_launch_counts()` table."""
    return {k: v - before[k] for k, v in kernel_launch_counts().items()}


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# stage 3's window blocks: clonal30x's (~26 blocks of 64 rows a job) and an
# amplicon sample's (2,000 reads over a 9.7 kb genome: 2 blocks)
WS_SHAPES = {"clonal30x": ((64,) * 26, 8192), "amplicon": ((2000,) * 2, 8192)}


def window_stats_phase(dev) -> dict:
    """The window-stats kernel (`ops/variants.py:window_stats_cuda`) at each
    of `WS_SHAPES`: equal to the plain version on the card and to the numpy
    twins, block by block; one launch a call (its counter and the profiler);
    timed alone with CUDA events and in the profiler's trace, beside its bound
    (bytes read once and written once over 3.35 TB/s), the plain version on
    the dense batch, the numpy twins over the blocks and the whole staged
    round trip that `finish_preps` makes (`window_stats_blocks`; host
    clock). Returns the numbers by shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hairsplitter_tpu_torch.ops import variants as V

    report = {}
    for label, (rows, P) in WS_SHAPES.items():
        nb, R = len(rows), rows[0]
        tris, codes = window_blocks(np.random.default_rng(len(rows)), rows, P)
        staging, offsets = V.pack_window_blocks(tris, codes)
        n = int(offsets[-1])
        on_dev = staging.to(dev)
        offs = torch.from_numpy(offsets).to(dev)
        flat, code = on_dev[:n], on_dev[n:]
        before = kernel_launch_counts()
        got = [x.cpu() for x in V.unpack_window_stats(V.window_stats_packed(flat, offs, code), nb, P)]
        torch.cuda.synchronize()
        assert launches_since(before)["window_stats"] == 1
        plain = [x.cpu() for x in V.window_stats_plain(flat.view(nb, R, P), code)]
        for g, r in zip(got, plain):
            assert torch.equal(g, r), f"window_stats_cuda differs from window_stats_plain at {label}"
        t0 = time.perf_counter()
        for b, (tri, c) in enumerate(zip(tris, codes)):
            tc, tn, cov = V.column_stats_host(tri)
            mm, cc = V.window_error_stats_host(tri, c)
            assert (got[0][b].numpy() == tc).all() and (got[1][b].numpy() == tn).all()
            assert (got[2][b].numpy() == cov).all() and (int(got[3][b]), int(got[4][b])) == (mm, cc)
        twins_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            V.window_stats_packed(flat, offs, code)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "window_stats" in e.name]
        assert len(kernels) == 1, f"one call must launch the kernel once: {[e.name for e in kernels]}"
        trace_ms = kernels[0].time_range.elapsed_us() / 1e3
        out = V.unpack_window_stats(torch.empty(V.window_stats_bytes(nb, P), dtype=torch.uint8, device=dev), nb, P)
        before = kernel_launch_counts()
        k_ms = cuda_ms(lambda: V.window_stats_cuda(flat, offs, code, out), 50)
        assert launches_since(before)["window_stats"] == 51  # a warm-up call, then 50
        p_ms = cuda_ms(lambda: V.window_stats_plain(flat.view(nb, R, P), code), 5)
        V.window_stats_blocks(tris, codes, dev)
        t0 = time.perf_counter()
        for _ in range(5):
            V.window_stats_blocks(tris, codes, dev)
        staged_ms = (time.perf_counter() - t0) / 5 * 1e3
        n_bytes = (n + nb) * P + 8 * (nb + 1) + V.window_stats_bytes(nb, P)
        seconds, by = bound_s(n_bytes, 0)
        bound = (seconds * 1e3, by)
        report[label] = dict(ms=k_ms, trace_ms=trace_ms, plain_ms=p_ms, twins_ms=twins_ms, staged_ms=staged_ms,
                             bound=bound, bytes=n_bytes)
        print(f"[kernel window_stats] {label}: {nb} blocks x {R} rows x {P}: == window_stats_plain and the "
              f"numpy twins (block by block), one launch a call; kernel {k_ms:.4f} ms "
              f"(the profiler's kernel: {trace_ms:.4f} ms), bound "
              f"{bound[0]:.4f} ms ({n_bytes / 1e6:.2f} MB read and written once, "
              f"{100 * bound[0] / k_ms:.1f}%), plain version {p_ms:.3f} ms, numpy twins {twins_ms:.1f} ms "
              f"(host), staged round trip (pack, pinned copies, kernel) {staged_ms:.3f} ms (host)", flush=True)
    return report


# integer operations the chain route needs, per unit of work (`bound_s`):
# a k-mer position's rolling 2-bit forward and reverse k-mers and its mix64
# hash, and a sliding-window minimum; a binary-search step of a minimizer's
# lookup; a hit's sort compare per level, and its sweep and LIS steps
OPS_KMER_POSITION = 24
OPS_SEARCH_STEP = 3
OPS_HIT = 12


def chain_phase(dev) -> dict:
    """Seeding and chaining on the card (`ops/chain_seeds.py`) on one job of
    the clonal30x cell's pool: the card route's chains equal to the host
    route's (`core/seeding.py:find_chains_batch`) read by read, one launch a
    call; the kernel timed alone with CUDA events beside its bound (reads'
    and index bytes once, against the integer operations above), the whole
    card route (pack, pinned copies, kernel, unpack) and the host route on
    the host clock. Returns the numbers."""
    import torch

    from benchmark import manifest
    from benchmark.traffic import generate
    from hairsplitter_tpu_torch.core.mapping import MapConfig
    from hairsplitter_tpu_torch.core.seeding import MinimizerIndex, find_chains_batch, minimizers
    from hairsplitter_tpu_torch.ops import chain_seeds as CS

    cell = manifest.load_cell("strains-ont.clonal30x")
    job = generate.make_job(cell.params, [int(cell.params.get("content_seed", 0)), 0, 0])
    reads = [s.astype(np.int8) for s in job.reads.seqs]
    cfg = MapConfig()
    index = MinimizerIndex.build({c.name: c.assembly.astype(np.int8) for c in job.contigs}, k=cfg.k, w=cfg.w,
                                 max_occ=cfg.max_occ)
    t0 = time.perf_counter()
    ref = find_chains_batch(index, reads, min_anchors=cfg.min_anchors)
    host_ms = (time.perf_counter() - t0) * 1e3
    before = kernel_launch_counts()
    got = CS.find_chains_cuda(index, reads, min_anchors=cfg.min_anchors, device=dev)
    assert launches_since(before)["chain_seeds"] == 1
    for r, (g, e) in enumerate(zip(got, ref)):
        assert [(c.contig_id, c.strand, c.score) for c in g] == [(c.contig_id, c.strand, c.score) for c in e], \
            f"read {r}: the card route's chains differ from the host route's"
        for a, b in zip(g, e):
            assert np.array_equal(a.q_anchors, b.q_anchors) and np.array_equal(a.t_anchors, b.t_anchors), \
                f"read {r}: the card route's anchors differ from the host route's"
    assert len(got) == len(ref)
    find_chains = lambda: CS.find_chains_cuda(index, reads, min_anchors=cfg.min_anchors, device=dev)  # noqa: E731
    t0 = time.perf_counter()
    for _ in range(5):
        find_chains()
    route_ms = (time.perf_counter() - t0) / 5 * 1e3
    # the kernel alone, on the staged reads, at the job's exact scratch size
    minis = [minimizers(r, index.k, index.w)[1] for r in reads]
    per_read = [index.lookup(h)[0].size for h in minis]
    hits = sum(per_read)
    staging, at = CS.pack_reads(reads, index.hpc, None, pin=True)
    on_dev = staging.to(dev)
    idx = CS.device_index(index, dev)
    scratch = torch.empty(hits * CS.SCRATCH_BYTES_PER_HIT, dtype=torch.uint8, device=dev)
    result = torch.empty(CS.result_bytes(len(reads), hits, cfg.min_anchors), dtype=torch.uint8, device=dev)
    launch = lambda: CS.chain_seeds_cuda(on_dev, at, len(reads), idx, index, cfg.min_anchors, 0.1, 0.5,  # noqa: E731
                                         scratch, hits, result)
    k_ms = cuda_ms(launch, 20)
    n_anchors = sum(c.score for read in ref for c in read)
    positions = sum(max(0, r.size - index.k + 1) for r in reads)
    n_bytes = int(staging.numel()) + int(idx.numel()) + 8 * CS.N_TOTALS + 8 * len(reads) \
        + 16 * sum(map(len, ref)) + 8 * n_anchors
    n_ops = OPS_KMER_POSITION * positions \
        + OPS_SEARCH_STEP * int(np.ceil(np.log2(max(2, index._hash.size)))) * sum(h.size for h in minis) \
        + sum(OPS_HIT * max(1, int(np.ceil(np.log2(max(2, h))))) * h for h in per_read)
    seconds, by = bound_s(n_bytes, n_ops)
    bound = (seconds * 1e3, by)
    print(f"[kernel chain_seeds] clonal30x pool job 0: {len(reads)} reads, {positions / 1e6:.2f} M positions, "
          f"{hits} hits, {sum(map(len, ref))} chains of {n_anchors} anchors: == find_chains_batch read by read, "
          f"one launch a call; kernel {k_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} M integer operations; {100 * bound[0] / k_ms:.1f}%), "
          f"card route (pack, copies, kernel, unpack) {route_ms:.2f} ms, host route {host_ms:.1f} ms (host)",
          flush=True)
    return dict(ms=k_ms, bound=bound, route_ms=route_ms, host_ms=host_ms, reads=len(reads), hits=hits)


def pileup_cells_phase(dev) -> dict:
    """The CIGAR walk on the card (`ops/pileup_cells.py`, `csrc/pileup_cells.cu`)
    on one job of the clonal30x cell's pool, mapped on the card: the card
    route's store (every alignment's cells and insertions, every window block
    and its stats) equal to the host copies' (`alignment_cells_full`,
    `build_window_blocks`, `window_stats_blocks`), one launch of the walk and
    one of the window stats a call; the walk timed alone with CUDA events
    beside its bound (its inputs read once and its outputs written once over
    3.35 TB/s), the whole card route (pack, copies, both kernels, unpack) and
    the host copies on the host clock. Returns the numbers."""
    import torch

    from benchmark import manifest
    from benchmark.traffic import generate
    from hairsplitter_tpu_torch.constants import decode_seq
    from hairsplitter_tpu_torch.core.mapping import MapConfig, map_reads
    from hairsplitter_tpu_torch.ops import pileup_cells as PC
    from hairsplitter_tpu_torch.ops._build import launch
    from hairsplitter_tpu_torch.pipeline import call_variants as cv

    cell = manifest.load_cell("strains-ont.clonal30x")
    job = generate.make_job(cell.params, [int(cell.params.get("content_seed", 0)), 0, 0])
    contigs = {c.name: decode_seq(c.assembly) for c in job.contigs}
    read_seqs = dict(enumerate(decode_seq(s) for s in job.reads.seqs))
    alns = map_reads(contigs, [read_seqs[i] for i in range(len(read_seqs))], MapConfig(), device=dev)
    per_contig = {c: sorted((a for a in alns if a.contig == c), key=lambda a: (a.read_idx, a.t_start, a.q_start))
                  for c in contigs}
    vcfg = cv.VariantCallConfig()
    pending = [cv.prepare_contig_host(c, seq, per_contig[c], read_seqs, vcfg) for c, seq in contigs.items()]
    walks = [pp.walk for pp in pending]
    codes_ws = [c for pp in pending for c in pp.codes_ws]
    t0 = time.perf_counter()
    ref = PC._walk_host(walks, read_seqs, "cpu", codes_ws)
    host_ms = (time.perf_counter() - t0) * 1e3
    before = kernel_launch_counts()
    got = PC.walk_alignments(walks, read_seqs, dev, codes_ws=codes_ws)
    during = launches_since(before)
    assert (during["pileup_cells"], during["window_stats"]) == (1, 1), f"one launch of each kernel a call: {during}"
    for name in ("t_start", "n_cells", "tri_off", "ins_off", "tri", "central", "ins_t", "ins_c"):
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == r.dtype and np.array_equal(g, r), f"the card route's {name} differs from the host copies'"
    for g, r in zip(got.stats, ref.stats, strict=True):
        assert np.array_equal(g, r), "the card route's window stats differ from the host copies'"
    for gb, rb in zip(got.blocks, ref.blocks, strict=True):
        for g, r in zip(gb, rb, strict=True):
            assert (g.start, g.length, g.contig) == (r.start, r.length, r.contig)
            assert np.array_equal(g.rows, r.rows) and np.array_equal(g.tri, r.tri), \
                f"the card route's block at {g.start} differs from build_window_blocks'"
    t0 = time.perf_counter()
    for _ in range(5):
        PC.walk_alignments(walks, read_seqs, dev, codes_ws=codes_ws)
    route_ms = (time.perf_counter() - t0) / 5 * 1e3
    pk = PC.JobPack(walks, read_seqs, codes_ws, pin=True)
    inb = pk.staging.to(dev)
    out = torch.empty(pk.out_bytes, dtype=torch.uint8, device=dev)
    k_ms = cuda_ms(lambda: launch("pileup_cells", out.device, *pk.kernel_args(inb.data_ptr(), out.data_ptr())), 20)
    # read once: the alignment records, the rows, the runs and the reads' codes;
    # written once: the blocks, the trimers, the central bases, the insertions
    n_read = sum(pk.at[b] - pk.at[a] for a, b in zip(pk.IN, pk.IN[1:]) if a not in ("block_off", "codes_w"))
    n_bytes = n_read + pk.rows * pk.window + 2 * pk.n_tri + 9 * pk.n_ins
    seconds, by = bound_s(n_bytes, 0)
    bound = (seconds * 1e3, by)
    n_alns = sum(len(w.alns) for w in walks)
    print(f"[kernel pileup_cells] clonal30x pool job 0: {n_alns} alignments, {int(got.n_cells.sum())} cells, "
          f"{pk.n_ins} insertions, {pk.n_blocks} blocks of {pk.rows} rows: == the host copies (cells, blocks, "
          f"stats), one launch of the walk and one of the window stats a call; kernel {k_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({n_bytes / 1e6:.2f} MB read and written once, {100 * bound[0] / k_ms:.1f}%), "
          f"card route (pack, copies, walk, stats, unpack) {route_ms:.2f} ms, host copies {host_ms:.1f} ms (host)",
          flush=True)
    return dict(ms=k_ms, bound=bound, route_ms=route_ms, host_ms=host_ms, alignments=n_alns, bytes=n_bytes)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["devices"], default=None,
                    help="devices: the environment, the build and phase 10's job over the host's cards alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    # ---- 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; card: {card}", flush=True)

    import hairsplitter_tpu_torch  # noqa: F401  (sets full-precision f32 matmuls)
    from hairsplitter_tpu_torch import native
    from hairsplitter_tpu_torch.ops import _build
    from hairsplitter_tpu_torch.core.mapping import fused_call_host
    from hairsplitter_tpu_torch.ops.align import BandSpec
    from hairsplitter_tpu_torch.ops import align_dp_cuda as ad
    from hairsplitter_tpu_torch.ops import align_myers_cuda as am
    from hairsplitter_tpu_torch.ops.align_device import (
        align_traceback_rows, banded_fused_plain, myers_fused_plain, readout_device, traceback_scan)

    # ---- 2. build
    _build.build(force=True)  # always from the checkout's sources
    _build.load_kernels()
    print(f"[build] nvcc sm_90a: {_build.build_info['seconds']:.2f} s "
          f"(cached={_build.build_info['cached']}) -> {_build.build_info['path']}", flush=True)
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    t0 = time.perf_counter()
    assert native.get_lib() is not None, \
        "native host library (hairsplitter_tpu_torch/csrc/hs_native.cpp, g++) did not build"
    native_so = _build.build_native()
    assert os.path.dirname(native_so) == _build.BUILD_DIR, native_so
    print(f"[build] native host library (g++, built now: {'native_seconds' in _build.build_info}): "
          f"{time.perf_counter() - t0:.2f} s -> {native_so}", flush=True)
    if args.only == "devices":
        assert torch.cuda.device_count() >= 2, f"one job over several cards needs 2 or more; torch sees " \
            f"{torch.cuda.device_count()}"
        devices_phase(min(4, torch.cuda.device_count()))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. kernels vs plain versions
    dev = torch.device("cuda")
    spec = BandSpec(chunk=B, band=128)
    T = spec.t_width
    rng = np.random.default_rng(0)
    check_jobs = random_jobs(rng, N_CHECK, spec)
    q, qlens, t, tlens = check_jobs
    qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    qld, tld = torch.from_numpy(qlens).to(dev), torch.from_numpy(tlens).to(dev)
    got = am.myers_rows(qd, td, spec, emit_tb=True)
    ref = am.myers_rows_torch(qd, td, spec, emit_tb=True)
    torch.cuda.synchronize()
    max_err = 0
    for name, a, b in zip(("P", "M", "nonleft", "isup"), got, ref):
        assert a.shape == (N_CHECK, B, 4) and b.shape == a.shape
        diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
        max_err = max(max_err, diff)
        assert torch.equal(a, b), f"K1 stream {name} differs from the plain version"
    del got, ref
    k_ms = cuda_ms(lambda: am.myers_rows(qd, td, spec, emit_tb=True), 50)
    p_ms = cuda_ms(lambda: am.myers_rows_torch(qd, td, spec, emit_tb=True), 2)
    print(f"[kernel] myers_rows == myers_rows_torch on {N_CHECK} jobs x B={B} (4 streams, bit for bit); "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms", flush=True)

    def check_fused(tag, kernel_fn, plain_fn):
        """A fused kernel against its plain composition, byte for byte, on the
        edge jobs and the check jobs with every mode pattern."""
        err = 0
        for label, jobs in (("edge", edge_jobs(spec)), (str(N_CHECK), check_jobs)):
            n = jobs[0].shape[0]
            arrays = [torch.from_numpy(x).to(dev) for x in jobs]
            for pattern in MODE_PATTERNS:
                md = torch.from_numpy(mode_pattern(pattern, n)).to(dev)
                got = kernel_fn(*arrays, md, spec)
                torch.cuda.synchronize()
                ref = plain_fn(*arrays, md, spec)
                assert got.dtype == ref.dtype == torch.uint8 and got.shape == ref.shape == (n, 16 + B)
                err = max(err, int((got.to(torch.int16) - ref.to(torch.int16)).abs().max()))
                assert torch.equal(got, ref), (
                    f"{kernel_fn.__name__} differs from {plain_fn.__name__} on the {label} jobs, "
                    f"{pattern} modes: rows {(got != ref).any(dim=1).nonzero()[:8, 0].tolist()}")
            print(f"[kernel {tag}] {kernel_fn.__name__} == {plain_fn.__name__} on the {label} jobs "
                  f"({n} x B={B}; modes {', '.join(MODE_PATTERNS)}; byte for byte)", flush=True)
        return err

    # K1's main-path mode: the fused kernel against the plain composition
    # (myers_rows_torch -> myers_word_readout -> readout_device ->
    # traceback_scan_words)
    fused_err = check_fused("K1 fused", am.myers_fused_cuda, myers_fused_plain)
    modes_check = torch.from_numpy(mode_pattern("alternating", N_CHECK)).to(dev)
    fused_check = [qd, qld, td, tld, modes_check]
    f_ms = cuda_ms(lambda: am.myers_fused_cuda(*fused_check, spec), 50)
    fp_ms = cuda_ms(lambda: myers_fused_plain(*fused_check, spec), 1)
    meta_check = am.myers_fused_cuda(*fused_check, spec)[:, :16].contiguous().view(torch.int32)
    rows_fwd = int(qld.clamp(0, B).sum())  # rows the forward pass steps
    rows_bwd = int(meta_check[:, 2].sum())  # rows the walk visits (start_i)
    del meta_check

    k2_err = 0
    k2_ms, k2_plain_ms = {}, {}
    for emit_enc in (False, True):
        got = ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=emit_enc)
        ref = ad.banded_align_batch_torch(qd, qld, td, tld, spec, emit_enc=emit_enc)
        torch.cuda.synchronize()
        assert got.keys() == ref.keys()
        for key in ref:
            a, b = got[key], ref[key]
            assert a.dtype == b.dtype and a.shape == b.shape, f"K2 {key}: {a.dtype}{tuple(a.shape)}"
            k2_err = max(k2_err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
            assert torch.equal(a, b), f"K2 output {key} (emit_enc={emit_enc}) differs from the plain version"
        mode = "enc" if emit_enc else "bp"
        k2_ms[mode] = cuda_ms(lambda: ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=emit_enc), 20)
        k2_plain_ms[mode] = cuda_ms(lambda: ad.banded_align_batch_torch(qd, qld, td, tld, spec, emit_enc=emit_enc), 2)
        del got, ref
    print(f"[kernel K2 check mode] banded_align_batch_dp == banded_align_batch_torch on {N_CHECK} jobs x B={B} "
          f"(bp, enc, row_at_q, colmin_val, colmin_i; bit for bit); "
          + ", ".join(f"{m}: kernel {k2_ms[m]:.4f} ms, plain {k2_plain_ms[m]:.2f} ms" for m in k2_ms),
          flush=True)

    # K2's main-path mode: the fused kernel against the plain composition
    # (banded_align_batch_torch with the run encoding -> readout_device ->
    # traceback_scan)
    k2f_err = check_fused("K2 fused", ad.banded_fused_cuda, banded_fused_plain)
    k2f_ms = cuda_ms(lambda: ad.banded_fused_cuda(*fused_check, spec), 50)
    k2fp_ms = cuda_ms(lambda: banded_fused_plain(*fused_check, spec), 1)

    # bounds of the four kernels on the check jobs: the larger of the bytes
    # each function must move (inputs read once, outputs written once) over
    # the memory rate, and its integer operations over the int32 rate
    # (ms, by what). The fused int32 kernel spends more than the function's
    # operations: about 10.5 instructions a cell and, because a row's classes
    # lie across the 32 lanes, 8 in every lane plus 14 for each walked row;
    # its bound is counted with the function's 8 and 30 all the same
    in_bytes = N_CHECK * (B + T)
    bounds = {name: (seconds * 1e3, by) for name, (seconds, by) in {
        "myers_rows": bound_s(in_bytes + 4 * N_CHECK * B * 16, N_CHECK * B * OPS_MYERS_ROW),
        "myers_fused": bound_s(in_bytes + 12 * N_CHECK + N_CHECK * (16 + B),
                               rows_fwd * OPS_FUSED_ROW + rows_bwd * OPS_WALK_ROW),
        "banded_dp": bound_s(in_bytes + 8 * N_CHECK + N_CHECK * B * 128 * 2 + N_CHECK * (128 + 2) * 4,
                             N_CHECK * B * 128 * OPS_DP_CELL),
        "banded_fused": bound_s(in_bytes + 12 * N_CHECK + N_CHECK * (16 + B),
                                rows_fwd * 128 * OPS_DP_CELL + rows_bwd * OPS_WALK_ROW),
    }.items()}
    scratch_ms = (rows_fwd + rows_bwd) * 32 / HBM_BYTES_PER_S * 1e3
    print(f"[kernel K1 fused] {N_CHECK} jobs (modes alternating): kernel {f_ms:.4f} ms, plain composition "
          f"{fp_ms:.2f} ms; bound {bounds['myers_fused'][0]:.4f} ms by {bounds['myers_fused'][1]} "
          f"({rows_fwd} forward rows, {rows_bwd} walked rows); its scratch through device memory "
          f"(32 B written per forward row, 32 B read per walked row) would take {scratch_ms:.4f} ms", flush=True)

    print(f"[kernel K2 fused] {N_CHECK} jobs (modes alternating): kernel {k2f_ms:.4f} ms, plain composition "
          f"{k2fp_ms:.2f} ms; bound {bounds['banded_fused'][0]:.4f} ms by {bounds['banded_fused'][1]} "
          f"({rows_fwd} forward rows x 128 cells, {rows_bwd} walked rows)", flush=True)

    # the fused mapping call at ~stage-2 size
    q, qlens, t, tlens = random_jobs(np.random.default_rng(1), N_FUSED, spec)
    modes_np = mode_pattern("alternating", N_FUSED)
    qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    qld, tld = torch.from_numpy(qlens).to(dev), torch.from_numpy(tlens).to(dev)
    modes = torch.from_numpy(modes_np).to(dev)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    fused_k1 = align_traceback_rows(qd, qld, td, tld, modes, spec, "myers")
    torch.cuda.synchronize()
    fused_peak = torch.cuda.max_memory_allocated() - mem0
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    fused_k2 = align_traceback_rows(qd, qld, td, tld, modes, spec, "pallas")
    torch.cuda.synchronize()
    fused_k2_peak = torch.cuda.max_memory_allocated() - mem0
    assert torch.equal(fused_k2, fused_k1), "the fused buffer with K2 differs from the buffer with K1"
    print("[fused] K2 buffer == K1 buffer (one fused kernel each) on %d jobs (byte for byte)" % N_FUSED, flush=True)
    meta = fused_k1[:, :16].contiguous().view(torch.int32)
    rows_fwd32, rows_bwd32 = int(qld.clamp(0, B).sum()), int(meta[:, 2].sum())
    del fused_k1, fused_k2, meta

    # device launches inside one fused call, by the profiler
    from torch.profiler import ProfilerActivity, profile
    for kernel, kernel_name in (("myers", "myers_fused"), ("pallas", "banded_fused")):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            align_traceback_rows(qd, qld, td, tld, modes, spec, kernel)
            torch.cuda.synchronize()
        on_device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"[fused] device activities inside one align_traceback_rows(kernel='{kernel}') call "
              f"(torch.profiler): {len(on_device)}: {on_device}", flush=True)
        assert len(on_device) == 1 and kernel_name in on_device[0], \
            "the fused call must be one launch of the fused kernel and nothing else"

    def call_as_run_jobs():
        """The copies and the call as `core/mapping.py:run_jobs` makes them."""
        return fused_call_host((q, qlens, t, tlens, modes_np), spec, "myers", dev)

    call_as_run_jobs()
    t0 = time.perf_counter()
    for _ in range(3):
        call_as_run_jobs()
    with_copies_ms = (time.perf_counter() - t0) / 3 * 1e3
    parts = {
        "kernel": cuda_ms(lambda: am.myers_fused_cuda(qd, qld, td, tld, modes, spec), 20),
        "fused_call": cuda_ms(lambda: align_traceback_rows(qd, qld, td, tld, modes, spec, "myers"), 20),
        "plain_composition": cuda_ms(lambda: myers_fused_plain(qd, qld, td, tld, modes, spec), 1),
        "check_mode_kernel": cuda_ms(lambda: am.myers_rows(qd, td, spec, emit_tb=True), 10),
    }
    b32 = bound_s(N_FUSED * (B + T + 12 + 16 + B), rows_fwd32 * OPS_FUSED_ROW + rows_bwd32 * OPS_WALK_ROW)
    print("[fused] K1 at %d jobs: %s; bound %.4f ms by %s; scratch traffic %.4f ms; "
          "device memory of one call %.1f MB" % (
              N_FUSED, ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()), b32[0] * 1e3, b32[1],
              (rows_fwd32 + rows_bwd32) * 32 / HBM_BYTES_PER_S * 1e3, fused_peak / 1e6), flush=True)
    print("[fused] K1 call with its copies as run_jobs makes them (pageable host to device, call, "
          "device to host; host clock): %.3f ms at %d jobs" % (with_copies_ms, N_FUSED), flush=True)
    occ = _build.load_kernels().hs_myers_fused_occupancy(B, T)
    print(f"[fused] occupancy of the fused kernel at B={B}, T={T}: {occ} blocks of 32 threads per SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)", flush=True)

    k2_parts = {
        "kernel": cuda_ms(lambda: ad.banded_fused_cuda(qd, qld, td, tld, modes, spec), 20),
        "fused_call": cuda_ms(lambda: align_traceback_rows(qd, qld, td, tld, modes, spec, "pallas"), 20),
        "plain_composition": cuda_ms(lambda: banded_fused_plain(qd, qld, td, tld, modes, spec), 1),
    }
    b32_k2 = bound_s(N_FUSED * (B + T + 12 + 16 + B),
                     rows_fwd32 * 128 * OPS_DP_CELL + rows_bwd32 * OPS_WALK_ROW)
    print("[fused] K2 at %d jobs: %s; bound %.4f ms by %s (%d forward rows, %d walked rows); "
          "device memory of one call %.1f MB" % (
              N_FUSED, ", ".join(f"{k} {v:.4f} ms" for k, v in k2_parts.items()), b32_k2[0] * 1e3, b32_k2[1],
              rows_fwd32, rows_bwd32, fused_k2_peak / 1e6), flush=True)
    occ = _build.load_kernels().hs_banded_fused_occupancy(B)
    print(f"[fused] occupancy of the fused K2 kernel at B={B}: {occ} blocks of one warp per SM, "
          f"{_build.load_kernels().hs_banded_fused_smem_bytes(B)} B of shared memory each "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)", flush=True)

    # the parts of the plain composition, with the check-mode kernel in the DP's place
    res = ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=True)
    cost, si, sb, clip = readout_device(res, qld, tld, modes, spec)
    k2_check_parts = {
        "check_mode_kernel": cuda_ms(lambda: ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=True), 10),
        "readout": cuda_ms(lambda: readout_device(res, qld, tld, modes, spec), 5),
        "traceback_scan": cuda_ms(lambda: traceback_scan(res["enc"], si, sb), 1),
    }
    enc_bytes = res["enc"].numel() * res["enc"].element_size()
    print("[fused] K2 check mode and the plain walk at %d jobs: %s; enc plane %.3f GB, %.3f TB/s "
          "(%.1f%% of 3.35 TB/s)" % (
              N_FUSED, ", ".join(f"{k} {v:.3f} ms" for k, v in k2_check_parts.items()),
              enc_bytes / 1e9, enc_bytes / k2_check_parts["check_mode_kernel"] / 1e9,
              100 * enc_bytes / k2_check_parts["check_mode_kernel"] / 1e9 / 3.35), flush=True)
    del res, cost, si, sb, clip

    # stage 3's window statistics, one launch over every block
    ws = window_stats_phase(dev)
    bounds["window_stats"] = ws["clonal30x"]["bound"]
    cs = chain_phase(dev)
    bounds["chain_seeds"] = cs["bound"]
    pc = pileup_cells_phase(dev)
    bounds["pileup_cells"] = pc["bound"]

    # ---- 4. main path through the CLI
    from hairsplitter_tpu_torch.io.gfa import parse_gfa
    from hairsplitter_tpu_torch.utils.evaluate import evaluate_phasing
    from hairsplitter_tpu_torch import cli
    from hairsplitter_tpu_torch.core import mapping
    from hairsplitter_tpu_torch.core.mapping import MapConfig
    from hairsplitter_tpu_torch.pipeline import orchestrate

    def check_run(out, wall, label):
        """Final GFA present, strain recovery >= MIN_RECOVERY; prints the
        stage table. Returns the recovery list."""
        final = os.path.join(out, "hairsplitter_final_assembly.gfa")
        assert os.path.exists(final), f"{label}: no final GFA"
        g = parse_gfa(final)
        assert g.segments and all(len(s) > 0 for s in g.segments.values())
        ev = evaluate_phasing(g.segments, haps)
        recovery = [float(r) for r in ev.haplotype_recovery]
        stats = json.load(open(os.path.join(out, "stage_stats.json")))
        print(f"[{label}] {wall:.1f} s wall, {len(g.segments)} contigs, "
              f"recovery {recovery}, switch errors {ev.total_switch_errors}", flush=True)
        for stage, entry in stats.items():
            extra = ", ".join(f"{k}={v}" for k, v in entry.items() if k != "seconds")
            print(f"[{label}]   {stage:20s} {entry['seconds']:8.3f} s  {extra}")
        assert min(recovery) >= MIN_RECOVERY, f"{label}: strain recovery {recovery} < {MIN_RECOVERY}"
        return recovery

    with tempfile.TemporaryDirectory(prefix="hs_smoke_") as root:
        t0 = time.perf_counter()
        asm_path, reads_path, haps, reads = build_dataset(root)
        print(f"[data] 300 kb x 3 strains, 30x, 10% error, seed 7: {len(reads.seqs)} reads, "
              f"{sum(map(len, reads.seqs)) / 1e3:.0f} read-kbp ({time.perf_counter() - t0:.1f} s)",
              flush=True)

        out = os.path.join(root, "out")
        seeding = []  # reads of each call that seeds (every map_reads call without pins)
        route = mapping.find_chains

        def counted_find_chains(index, reads_codes, *args, **kwargs):
            seeding.append(len(reads_codes))
            return route(index, reads_codes, *args, **kwargs)

        mapping.find_chains = counted_find_chains  # the seeding call site
        try:
            base = kernel_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["-i", asm_path, "-f", reads_path, "-o", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            mapping.find_chains = route
        main_launches = launches_since(base)
        launches = main_launches["myers_fused"]
        check_mode_launches = main_launches["myers_rows"]
        assert rc == 0, f"CLI returned {rc}"
        assert launches > 0, "the main path never launched the fused Myers kernel"
        assert check_mode_launches == 0, "the main path launched K1's check-mode kernel"
        print(f"[main] CLI on cuda: K1 fused launches {launches}, K1 check-mode launches "
              f"{check_mode_launches}, K2 fused launches {main_launches['banded_fused']}, K2 check-mode "
              f"launches {main_launches['banded_dp']}", flush=True)
        recovery_main = check_run(out, wall, "main")
        ws_main = main_launches["window_stats"]
        assert ws_main == 1, f"stage 3 launched the window-stats kernel {ws_main} times, not once for the job"
        cs_main = main_launches["chain_seeds"]
        seeding_calls = sum(1 for n in seeding if n)
        assert cs_main == seeding_calls > 0, \
            f"{cs_main} chain launches for {seeding_calls} map_reads calls that seed, not one each"
        print(f"[main] window-stats launches {ws_main} for the job; chain launches {cs_main}, one for each of "
              f"the {seeding_calls} map_reads calls that seed ({sum(seeding)} reads)", flush=True)
        pc_main = main_launches["pileup_cells"]
        cells5 = json.load(open(os.path.join(out, "stage_stats.json")))["create_new_contigs.cells"]
        assert pc_main == 1, f"the job launched the CIGAR walk {pc_main} times, not once"
        assert cells5["walked"] == 0 and cells5["reused"] > 0, f"stage 5 walked alignments again: {cells5}"
        print(f"[main] CIGAR-walk launches {pc_main} for the job (stage 3); stage 5 reused the cells of "
              f"{cells5['reused']:.0f} alignments and walked {cells5['walked']:.0f}", flush=True)

        # ---- 5. main path with MapConfig(use_myers=False): stage 2 on K2
        out_k2 = os.path.join(root, "out_k2")
        stage2 = {"k1": 0, "k2": 0}
        stage2_map_reads = orchestrate.map_reads

        def counted_map_reads(*args, **kwargs):
            before = kernel_launch_counts()
            alns = stage2_map_reads(*args, **kwargs)
            during = launches_since(before)
            stage2["k1"] += during["myers_fused"]
            stage2["k2"] += during["banded_fused"]
            return alns

        orchestrate.map_reads = counted_map_reads  # the stage-2 call site
        try:
            base = kernel_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orchestrate.run_pipeline(
                asm_path, reads_path, out_k2,
                orchestrate.PipelineConfig(map=MapConfig(use_myers=False)),
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            orchestrate.map_reads = stage2_map_reads
        k2_run = launches_since(base)
        k2_launches = k2_run["banded_fused"]
        k2_check_launches = k2_run["banded_dp"]
        k1_later = k2_run["myers_fused"]
        assert k2_run["myers_rows"] == 0, "the use_myers=False run launched K1's check-mode kernel"
        print(f"[main K2] run_pipeline(map=MapConfig(use_myers=False)) on cuda: K2 fused launches "
              f"{k2_launches} (stage 2: {stage2['k2']}), K2 check-mode launches {k2_check_launches}, "
              f"K1 launches in stage 2 {stage2['k1']}, "
              f"K1 launches of the stage-5/6 remaps (default MapConfig) {k1_later - stage2['k1']}",
              flush=True)
        assert k2_launches > 0 and stage2["k2"] > 0, "the use_myers=False path never launched the fused K2 kernel"
        assert k2_check_launches == 0, "the use_myers=False run launched K2's check-mode kernel"
        assert stage2["k1"] == 0, "K1 launched during the use_myers=False stage-2 mapping"
        for name in ("tmp/reads_on_asm.sam", "hairsplitter_final_assembly.gfa"):
            with open(os.path.join(out, name), "rb") as f1, open(os.path.join(out_k2, name), "rb") as f2:
                assert f1.read() == f2.read(), f"{name} of the K2 run differs from the K1 run's"
        print("[main K2] tmp/reads_on_asm.sam and hairsplitter_final_assembly.gfa byte-identical "
              "to the K1 run's", flush=True)
        check_run(out_k2, wall, "main K2")

        # ---- 6. --correct-assembly -p medaka on a broken assembly
        from hairsplitter_tpu_torch.io.fasta import write_fasta
        from hairsplitter_tpu_torch.models import polisher

        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32, \
            "TF32 must be off: the polisher's convolutions are held to the CPU's at 1e-4"
        broken_path = os.path.join(root, "broken_assembly.fasta")
        write_fasta(broken_path, break_assembly(haps[0]))
        out_mt = os.path.join(root, "out_medaka_tailor")
        stage1b = {}
        tailor = orchestrate.correct_assembly

        def counted_correct_assembly(*args, **kwargs):
            before = kernel_launch_counts()
            t1 = time.perf_counter()
            graph, report = tailor(*args, **kwargs)
            stage1b.update(report=report, launches=launches_since(before)["myers_fused"],
                           seconds=time.perf_counter() - t1)
            return graph, report

        nn = polisher.default_polisher(dev)
        assert next(nn.model.parameters()).is_cuda, "the NN caller's weights are not on the card"
        nn_calls0, nn_seconds0 = nn.calls, nn.seconds
        orchestrate.correct_assembly = counted_correct_assembly  # the stage-1b call site
        try:
            base = kernel_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["-i", broken_path, "-f", reads_path, "-o", out_mt, "--correct-assembly", "-p", "medaka"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            orchestrate.correct_assembly = tailor
        assert rc == 0, f"CLI returned {rc}"
        mt_run = launches_since(base)
        rep = stage1b["report"]
        nn_calls, nn_ms = nn.calls - nn_calls0, (nn.seconds - nn_seconds0) * 1e3
        nn_rest = (nn_ms - nn.slowest * 1e3) / max(nn_calls - 1, 1)
        print(f"[medaka+tailor] CLI --correct-assembly -p medaka on cuda ({card}): stage 1b "
              f"{stage1b['seconds']:.2f} s, K1 fused launches in stage 1b {stage1b['launches']} "
              f"(whole run {mt_run['myers_fused']}), check-mode launches K1 {mt_run['myers_rows']} "
              f"K2 {mt_run['banded_dp']}; tailor: end-to-end reads {rep.end_to_end_before} -> "
              f"{rep.end_to_end_after} of {rep.n_reads} (history {rep.e2e_history}), {rep.iterations} iterations, "
              f"cuts {rep.cuts}, new links {rep.new_links}, dropped {rep.dropped_low_coverage}; "
              f"NN calls {nn_calls}, total {nn_ms:.1f} ms, mean {nn_ms / max(nn_calls, 1):.3f} ms "
              f"(slowest call {nn.slowest * 1e3:.1f} ms, mean of the others {nn_rest:.3f} ms)", flush=True)
        assert rep.end_to_end_after > rep.end_to_end_before, "tailor did not raise the end-to-end reads"
        assert len(rep.cuts) >= 1 and len(rep.new_links) >= 1, "tailor made no cut or no link"
        assert stage1b["launches"] > 0, "stage 1b never launched the fused Myers kernel"
        assert mt_run["myers_rows"] == 0 and mt_run["banded_dp"] == 0, \
            "the --correct-assembly -p medaka run launched a check-mode kernel"
        assert nn_calls > 0, "-p medaka never called the NN caller"
        stats_mt = json.load(open(os.path.join(out_mt, "stage_stats.json")))
        assert stats_mt["nn_caller"]["calls"] == nn_calls and "correct_assembly" in stats_mt
        recovery_mt = check_run(out_mt, wall, "medaka+tailor")
        worst = max(a - b for a, b in zip(recovery_main, recovery_mt))
        assert worst <= 0.005, f"recovery fell by {worst:.4f} against the default run's {recovery_main}"

        # ---- 10. two processes on cuda:0 against one, on three contigs
        from hairsplitter_tpu_torch.io.gfa import AssemblyGraph, Link, write_gfa

        three = AssemblyGraph()
        for k in range(3):
            three.add_segment(f"ctg{k}", haps[0][100_000 * k : 100_000 * (k + 1)])
        three.add_link(Link("ctg0", "+", "ctg1", "+"))
        three.add_link(Link("ctg1", "+", "ctg2", "+"))
        three_path = os.path.join(root, "assembly_three_contigs.gfa")
        write_gfa(three, three_path)
        out_one, out_two = os.path.join(root, "out_three_single"), os.path.join(root, "out_three_two_processes")
        base = kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["-i", three_path, "-f", reads_path, "-o", out_one, "--no_clean"])
        torch.cuda.synchronize()
        wall_one = time.perf_counter() - t0
        single_run = launches_since(base)
        dist_single_launches = single_run["myers_fused"]
        assert rc == 0 and dist_single_launches > 0
        assert single_run["myers_rows"] == 0 and single_run["banded_dp"] == 0
        print(f"[distributed] single process, three contigs: K1 fused launches {dist_single_launches}", flush=True)
        check_run(out_one, wall_one, "distributed single")

        repo = os.path.dirname(os.path.abspath(__file__))
        # the same single-process run from a new process, as the two workers
        # start: interpreter, torch and CUDA start-up are in its wall time too
        out_cold = os.path.join(root, "out_three_single_new_process")
        wall_cold = run_processes(repo, three_path, reads_path, out_cold, 1)
        with open(os.path.join(out_cold, "hairsplitter_final_assembly.gfa"), "rb") as f1, \
                open(os.path.join(out_one, "hairsplitter_final_assembly.gfa"), "rb") as f2:
            assert f1.read() == f2.read(), "the single-process run from a new process gave another final GFA"
        stats = json.load(open(os.path.join(out_cold, "stage_stats.json")))
        top = {k: v for k, v in stats.items() if "." not in k}  # a stage's children are inside it
        print(f"[distributed] single process from a new process: {wall_cold:.1f} s from start to exit; stage seconds "
              + ", ".join(f"{k} {v['seconds']:.3f}" for k, v in top.items())
              + f" (sum {sum(v['seconds'] for v in top.values()):.3f})", flush=True)
        wall_two = run_processes(repo, three_path, reads_path, out_two, 2)
        for name in DIST_ARTIFACTS:
            with open(os.path.join(out_one, name), "rb") as f1, open(os.path.join(out_two, name), "rb") as f2:
                one, two = f1.read(), f2.read()
            assert two == one and len(two) > 0, f"{name} of the two-process run differs from the single-process run's"
        head_one, body_one = sam_parts(os.path.join(out_one, "tmp/reads_on_asm.sam"))
        head_two, body_two = sam_parts(os.path.join(out_two, "tmp/reads_on_asm.sam"))
        assert head_two == head_one and body_two == body_one and body_one, \
            "the two-process SAM differs from the single-process SAM beyond the order of its lines"
        listing = sorted(os.listdir(out_two))
        assert [n for n in listing if ".p1." in n] == ["hairsplitter.p1.log", "stage_stats.p1.json"], listing
        assert sorted(os.listdir(os.path.join(out_two, "tmp"))) == sorted(os.listdir(os.path.join(out_one, "tmp")))
        dist_launches = []
        error_rates = []
        for rank in range(2):
            with open(os.path.join(out_two, f"hairsplitter.p{rank}.log" if rank else "hairsplitter.log")) as f:
                log_text = f.read()
            counts = dict((k, int(v)) for k, v in re.findall(r"(\w+)=(\d+)", re.findall(r"kernel launches: (.*)", log_text)[-1]))
            error_rates.append(re.findall(r"global error rate (\S+)", log_text)[0])
            assert "device: cuda" in log_text, f"process {rank} did not run on the card"
            assert counts["myers_fused"] > 0, f"process {rank} never launched the fused Myers kernel"
            assert counts["myers_rows"] == 0 and counts["banded_dp"] == 0, f"process {rank} launched a check-mode kernel"
            dist_launches.append(counts["myers_fused"])
            stats = json.load(open(os.path.join(out_two, f"stage_stats.p{rank}.json" if rank else "stage_stats.json")))
            top = {k: v for k, v in stats.items() if "." not in k}
            print(f"[distributed] process {rank} on cuda:0: K1 fused launches {counts['myers_fused']}, check-mode "
                  f"launches K1 {counts['myers_rows']} K2 {counts['banded_dp']}; stage seconds "
                  + ", ".join(f"{k} {v['seconds']:.3f}" for k, v in top.items())
                  + f" (sum {sum(v['seconds'] for v in top.values()):.3f})", flush=True)
        assert error_rates[0] == error_rates[1], f"the processes logged different global error rates: {error_rates}"
        check_run(out_two, wall_two, "distributed two processes")
        print(f"[distributed] two processes on one card ({card}): {wall_two:.1f} s from the first start to the last "
              f"exit (interpreter, torch and CUDA start-up of both included) against {wall_cold:.1f} s for one "
              f"new process and {wall_one:.1f} s for the single process inside this one; {len(DIST_ARTIFACTS)} artifacts byte-identical, SAM equal as "
              f"sorted lines ({len(body_one)}), global error rate {error_rates[0]} on both", flush=True)
        if torch.cuda.device_count() >= 2:
            devices_phase(min(4, torch.cuda.device_count()))

    # ---- 7. the polisher CNN on the card against the CPU
    on_cpu, on_card = polisher.load_weights(device="cpu"), polisher.load_weights(device=dev)
    for L in (256, 4096, 65536):
        feats, _ = polisher._simulate_training_batch(
            np.random.default_rng(L), L=L, cov_lo=4, cov_hi=20, err=0.12, div=0.02)
        ref, got = on_cpu.logits(feats), on_card.logits(feats)
        assert got.shape == ref.shape == (L, polisher.N_CLASSES) and np.isfinite(got).all()
        err = float(np.abs(got - ref).max())
        top = np.sort(ref, axis=1)
        clear = top[:, -1] - top[:, -2] > 1e-3
        assert np.allclose(got, ref, atol=1e-4, rtol=1e-4), f"polisher logits differ by {err:.3e} at L={L}"
        assert (got.argmax(axis=1)[clear] == ref.argmax(axis=1)[clear]).all(), f"polisher bases differ at L={L}"
        x = torch.from_numpy(feats).to(dev)[None]
        with torch.no_grad():
            ms = cuda_ms(lambda: on_card.model(x), 20)
        print(f"[polisher] L={L}: cuda == cpu (max |logit difference| {err:.2e}, atol 1e-4; bases equal at the "
              f"{int(clear.sum())} of {L} positions with a top-two margin above 1e-3); forward pass "
              f"{ms:.4f} ms on the card", flush=True)

    # ---- 8. graphunzip on the card against --device cpu
    from hairsplitter_tpu_torch import graphunzip

    with tempfile.TemporaryDirectory(prefix="hs_smoke_gz_") as root:
        asm_path, reads_path, haps2 = two_strain_dataset(root)
        out = os.path.join(root, "out")
        assert cli.main(["-i", asm_path, "-f", reads_path, "-o", out]) == 0
        zipped = os.path.join(out, "tmp", "zipped_assembly.gfa")
        gaf = os.path.join(out, "tmp", "reads_on_new_contig.gaf")
        results = {}
        for device in ("cuda", "cpu"):
            base = kernel_launch_counts()
            gfa_out = os.path.join(root, f"unzipped_{device}.gfa")
            t0 = time.perf_counter()
            assert graphunzip.main(["unzip", "-g", zipped, "-l", gaf, "-r", reads_path, "-o", gfa_out,
                                    "--supercontigs", os.path.join(root, f"super_{device}.txt"),
                                    "--device", device]) == 0
            during = launches_since(base)
            results[device] = (open(gfa_out, "rb").read(), during["myers_fused"], time.perf_counter() - t0)
            assert during["myers_rows"] == 0
        assert results["cuda"][1] > 0, "graphunzip unzip -r on cuda never launched the fused Myers kernel"
        assert results["cpu"][1] == 0, "graphunzip unzip --device cpu launched a CUDA kernel"
        assert results["cuda"][0] == results["cpu"][0] and len(results["cuda"][0]) > 0, \
            "graphunzip unzip: the GFA on cuda differs from the GFA with --device cpu"
        print(f"[graphunzip] unzip -g -l -r on the run's zipped graph: cuda GFA == cpu GFA byte for byte "
              f"({len(results['cuda'][0])} bytes); K1 fused launches on cuda {results['cuda'][1]}; "
              f"{results['cuda'][2]:.2f} s on cuda, {results['cpu'][2]:.2f} s on cpu", flush=True)

        # mate pairs 2-4 kb apart on one haplotype, 400 bp each
        rng = np.random.default_rng(5)
        r1_path, r2_path = os.path.join(root, "hic_R1.fasta"), os.path.join(root, "hic_R2.fasta")
        with open(r1_path, "w") as f1, open(r2_path, "w") as f2:
            for k in range(400):
                hap = haps2[k % 2]
                a = int(rng.integers(0, len(hap) - 4400))
                b = a + int(rng.integers(2000, 4000))
                f1.write(f">p{k}\n{hap[a:a + 400]}\n")
                f2.write(f">p{k}\n{hap[b:b + 400]}\n")
        mats = {}
        for device in ("cuda", "cpu"):
            base = kernel_launch_counts()
            im_out = os.path.join(root, f"im_{device}.npz")
            assert graphunzip.main(["hic-im", "-g", zipped, "-1", r1_path, "-2", r2_path, "-o", im_out,
                                    "--device", device]) == 0
            data = np.load(im_out, allow_pickle=True)
            mats[device] = (list(data["names"]), data["m"], launches_since(base)["myers_fused"])
        assert mats["cuda"][2] > 0, "graphunzip hic-im on cuda never launched the fused Myers kernel"
        assert mats["cuda"][0] == mats["cpu"][0] and np.array_equal(mats["cuda"][1], mats["cpu"][1]), \
            "graphunzip hic-im: the matrix on cuda differs from the matrix with --device cpu"
        assert mats["cuda"][1].sum() > 0, "graphunzip hic-im counted no pair"
        print(f"[graphunzip] hic-im on 400 mate pairs: cuda matrix == cpu matrix "
              f"({len(mats['cuda'][0])} contigs, {int(mats['cuda'][1].sum() // 2)} contacts between contigs); "
              f"K1 fused launches on cuda {mats['cuda'][2]}", flush=True)

    # ---- 9. the spectral phaser on the card against the CPU
    from hairsplitter_tpu_torch.models.bihap import allele_matrix, spectral_phase
    from hairsplitter_tpu_torch.pipeline.call_variants import SparseColumn

    rng = np.random.default_rng(4)
    n_reads, n_snps = 400, 300
    hap_of = np.repeat(np.arange(2), n_reads // 2)
    columns = []
    for snp in range(n_snps):
        present = rng.random(n_reads) > 0.1
        alleles = np.where((hap_of == 1) ^ (rng.random(n_reads) < 0.05), 7, 3).astype(np.int16)
        columns.append(SparseColumn(pos=100 * snp, top1=3, top2=7,
                                    rows=np.nonzero(present)[0], alleles=alleles[present]))
    sv = np.linalg.svd(allele_matrix(columns, n_reads), compute_uv=False)
    assert sv[0] > 3 * sv[1], f"the allele matrix has no clear spectral gap: {sv[:3]}"
    labels = {d: spectral_phase(columns, n_reads, n_haplotypes=2, device=d) for d in ("cpu", "cuda")}
    assert partition(labels["cuda"]) == partition(labels["cpu"]), "spectral_phase: cuda and cpu partitions differ"
    assert partition(labels["cuda"]) == partition(hap_of), "spectral_phase did not recover the two haplotypes"
    print(f"[bihap] spectral_phase on a {n_reads} x {n_snps} allele matrix (singular values {sv[0]:.1f}, "
          f"{sv[1]:.1f}): cuda partition == cpu partition == the two haplotypes", flush=True)

    # ---- 11. the sharded steps on a mesh of the one card against a mesh of the CPU
    from hairsplitter_tpu_torch.parallel.mesh import (
        column_stats_shard_step, make_mesh, make_phase_example, map_shard_step, phase_shard_step)

    on_card, on_cpu = make_mesh(["cuda:0"]), make_mesh(["cpu"])
    assert on_card.shape == (1, 1) and on_card.flat() == [torch.device("cuda:0")]
    example = make_phase_example(C=2, Rr=512, Pp=2048, S=256, K=8)
    steps = {
        "phase_shard_step": lambda mesh: phase_shard_step(mesh, example),
        "column_stats_shard_step": lambda mesh: column_stats_shard_step(mesh, example[0]),
        "map_shard_step K1": lambda mesh: map_shard_step(mesh, n_per_device=N_CHECK, spec=BandSpec(), kernel="myers"),
        "map_shard_step K2": lambda mesh: map_shard_step(mesh, n_per_device=N_CHECK, spec=BandSpec(), kernel="pallas"),
    }
    base = kernel_launch_counts()
    placed = {name: make(on_card) for name, make in steps.items()}
    results = {name: fn(*args) for name, (fn, args) in placed.items()}
    torch.cuda.synchronize()
    mesh_run = launches_since(base)
    mesh_k1, mesh_k2 = mesh_run["myers_fused"], mesh_run["banded_fused"]
    assert mesh_k1 == 1 and mesh_k2 == 1, f"map_shard_step launched K1 {mesh_k1} and K2 {mesh_k2} times, not once each"
    assert mesh_run["myers_rows"] == 0 and mesh_run["banded_dp"] == 0, \
        "a sharded step launched a check-mode kernel"
    for name, make in steps.items():
        t0 = time.perf_counter()
        fn_cpu, args_cpu = make(on_cpu)
        ref, got = fn_cpu(*args_cpu), results[name]
        cpu_s = time.perf_counter() - t0
        if name == "phase_shard_step":
            assert np.float32(got[0]).tobytes() == np.float32(ref[0]).tobytes(), f"err {got[0]!r} != {ref[0]!r}"
            ref, got = ref[1:], got[1:]
        elif name.startswith("map"):
            ref, got = (ref,), (got,)
        for k, (a, b) in enumerate(zip(got, ref)):
            assert a.device.type == "cpu" and a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b), f"{name}: output {k} on the card differs from the CPU's"
        fn, args = placed[name]
        ms = cuda_ms(lambda: fn(*args), 10)
        shapes = ", ".join(str(tuple(a.shape)) for a in got)
        print(f"[mesh] {name} on ['cuda:0'] == on ['cpu'] bit for bit ({shapes}); {ms:.4f} ms on the card with "
              f"its copy to the host (CUDA events), {cpu_s:.2f} s on the CPU with its set-up", flush=True)
    err_rate = float(results["phase_shard_step"][0])
    labels = results["phase_shard_step"][2]
    assert 0.0 < err_rate < 1.0 and all(len(set(l.tolist())) >= 2 for l in labels.reshape(-1, labels.shape[-1]))
    print(f"[mesh] phase step: err {err_rate:.6f}, every one of the {labels.shape[0] * labels.shape[1]} seeded "
          f"CW runs splits its {labels.shape[2]} reads; K1 fused launches {mesh_k1}, K2 fused launches {mesh_k2}, "
          f"check-mode launches 0", flush=True)

    # ---- 12. training the polisher on the card
    train_mod = load_script("torch_train_polisher")
    # (a) the realistic corpus is integer work up to the features: a pair
    # mapped on the card equals the pair mapped on the CPU byte for byte
    for hp_bias in (False, True):
        pairs = [polisher._realistic_training_pair(np.random.default_rng(21), L=2048, hp_bias=hp_bias, device=d)
                 for d in ("cpu", dev)]
        for name, a, b in zip(("features", "labels", "weights"), *pairs):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), \
                f"realistic training pair (hp_bias={hp_bias}): {name} on the card differ from the CPU's"
        print(f"[train] (a) realistic pair, hp_bias={hp_bias}, L=2048 -> {pairs[0][1].size} columns: features, "
              f"labels and weights mapped on cuda == on cpu byte for byte", flush=True)
    # (b) one Adam step from the same initial weights (seed 0) on a seeded
    # batch, on the card and on the CPU, and on the CPU in float64
    def one_adam_step(seed, n, L, keep, d, dtype=torch.float32):
        rng = np.random.default_rng(seed)
        xs, ys = zip(*(polisher._simulate_training_batch(rng, L=L) for _ in range(n)))
        x, y, w = (torch.from_numpy(a) for a in (np.stack(xs), np.stack(ys), (rng.random((n, L)) < keep).astype(np.float32)))
        model = polisher.PolisherCNN()
        polisher.init_params(model, torch.Generator().manual_seed(0))
        model.to(device=d, dtype=dtype)
        opt = polisher.make_optimizer(model, 1e-3)
        with polisher.deterministic_convolutions():
            loss = polisher.train_step(model, opt, x.to(d, dtype), y.to(d), w.to(d, dtype))
        grads = {k: p.grad.double().cpu() for k, p in model.named_parameters()}
        return float(loss), {k: v.detach().double().cpu() for k, v in model.state_dict().items()}, grads

    def step_diff(a, b):
        """Largest difference of the loss and of any parameter after the step,
        and the parameter and the gradient of `b` where the largest is."""
        worst = (abs(a[0] - b[0]), "loss", 0.0)
        for k in a[1]:
            d = (a[1][k] - b[1][k]).abs()
            i = int(d.argmax())
            worst = max(worst, (float(d.flatten()[i]), k, float(b[2][k].flatten()[i])))
        return worst

    step_err, where, _ = step_diff(one_adam_step(11, 4, 256, 0.8, dev), one_adam_step(11, 4, 256, 0.8, "cpu"))
    assert step_err <= 1e-5, f"one Adam step on the card differs from the CPU's by {step_err:.3e} at {where} (limit 1e-5)"
    print(f"[train] (b) one Adam step from the same initial weights, batch 4 x 256: loss and every parameter "
          f"cuda vs cpu within {step_err:.3e} (largest at {where}; limit 1e-5)", flush=True)
    # The first Adam step moves a weight by lr * g / (|g| + eps): where a
    # gradient is a sum that cancels to within a few eps of zero, its float
    # noise is magnified up to lr / (4 eps) = 25,000 times. This larger batch
    # has such weights; the card is shown beside the CPU's own float32 error.
    big = {d: one_adam_step(31, 8, 512, 0.9, d) for d in ("cpu", dev)}
    exact = one_adam_step(31, 8, 512, 0.9, "cpu", torch.float64)
    card_cpu = step_diff(big[dev], big["cpu"])
    print(f"[train] (b) the same at batch 8 x 512: cuda vs cpu {card_cpu[0]:.3e} at {card_cpu[1]} (gradient there "
          f"{card_cpu[2]:.2e}); cuda vs the float64 step {step_diff(big[dev], exact)[0]:.3e}, cpu vs the float64 "
          f"step {step_diff(big['cpu'], exact)[0]:.3e} (Adam's eps 1e-8)", flush=True)
    # (c) one seed, two runs on the card: the same weights bit for bit
    runs = [polisher.train_polisher(seed=0, steps=20, device=dev).model.state_dict() for _ in range(2)]
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0]), \
        "two 20-step trainings on the card with one seed gave different weights"
    print("[train] (c) two 20-step synthetic trainings on cuda with seed 0: every parameter bit-identical", flush=True)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cudnn.deterministic, \
        "training left cuDNN's flags changed"
    # (d) scripts/train_polisher.py's training at its full size, on the card
    with tempfile.TemporaryDirectory(prefix="hs_smoke_train_") as root:
        base = kernel_launch_counts()
        trained = train_mod.train_and_check(os.path.join(root, "w.npz"), device=dev)
        train_run = launches_since(base)
        train_k1 = train_run["myers_fused"]
        assert train_run["myers_rows"] == 0 and train_run["banded_dp"] == 0, \
            "the training launched a check-mode kernel"
        assert os.path.getsize(os.path.join(root, "w.npz")) > 0
    print(f"[train] (d) {trained['steps']} steps on {trained['pairs']} realistic pairs on cuda ({card}): "
          f"training {trained['training_s']:.2f} s = corpus {trained['corpus_s']:.3f} s "
          f"({trained['corpus_k1_launches']} K1 fused launches) + steps {trained['steps_s']:.3f} s "
          f"({trained['ms_per_step']:.4f} ms per step); held-out accuracy {trained['held_out_accuracy']:.5f} "
          f"vs majority {trained['held_out_majority']:.5f} ({trained['held_out_k1_launches']} K1 fused launches, "
          f"{trained['held_out_s']:.2f} s); JAX record 0.9934 vs 0.9894", flush=True)
    assert train_k1 == trained["corpus_k1_launches"] + trained["held_out_k1_launches"] and train_k1 > 0
    assert trained["held_out_accuracy"] > trained["held_out_majority"], "the trained net does not beat majority"
    assert trained["held_out_accuracy"] >= MIN_HELD_OUT, \
        f"held-out accuracy {trained['held_out_accuracy']:.5f} < {MIN_HELD_OUT}"

    # ---- 13. the 1 Mbp metagenome of scripts/torch_eval_quality.py
    quality_mod = load_script("torch_eval_quality")
    with tempfile.TemporaryDirectory(prefix="hs_smoke_quality_") as root:
        base = kernel_launch_counts()
        quality = quality_mod.run_scenario("metagenome", root, 0, device="cuda", n_species=QUALITY_SPECIES)
        quality_run = launches_since(base)
        quality_k1 = quality_run["myers_fused"]
        assert quality_run["myers_rows"] == 0 and quality_run["banded_dp"] == 0, \
            "the metagenome run launched a check-mode kernel"
    assert quality_k1 == quality["k1_launches"] and quality_k1 > 0, "the metagenome run never launched K1"
    print(f"[quality] metagenome, {QUALITY_SPECIES} species x 100 kb, 30x of 8 kb reads, 10% error, seed 0: "
          f"{quality['reads']} reads, {quality['read_mbp']:.2f} Mbp; {quality['wall_s']:.1f} s wall on cuda ({card}), "
          f"K1 fused launches {quality_k1}; contigs {quality['contigs']}, N50 {quality['n50']} "
          f"(JAX record at 10 species: 35 contigs, N50 100000), recovery mean {quality['recovery_mean']}, "
          f"min {quality['recovery_min']}, switch errors {quality['switches']}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in quality["stages"].items()), flush=True)
    assert quality["recovery_min"] >= MIN_RECOVERY, f"metagenome: min recovery {quality['recovery_min']}"
    assert quality["switches"] <= 1, f"metagenome: {quality['switches']} switch errors"

    # ---- 14. bench_torch.py's kernel blocks and its one-line contract; no
    # path: its launches are counted apart
    import bench_torch

    base = kernel_launch_counts()
    bench_blocks = {
        "fused_production_rate K1": bench_torch.fused_production_rate(spec, "myers", dev),
        "fused_production_rate K2": bench_torch.fused_production_rate(spec, "pallas", dev),
        "transfer_profile": bench_torch.transfer_profile(spec, dev),
        "raw_kernel_rate": bench_torch.raw_kernel_rate(spec, dev),
    }
    for name, res in bench_blocks.items():
        print(f"[bench] {name} on cuda ({card}): {res}", flush=True)
    assert bench_blocks["fused_production_rate K1"]["cells_per_s"] > 0
    assert bench_blocks["raw_kernel_rate"]["raw_kernel_cells_per_s"] > 0
    cuda_sizes = bench_torch.SIZES["cuda"]
    bench_torch.SIZES["cuda"] = BENCH_TOY
    printed = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = bench_torch.main([])
        bench_s = time.perf_counter() - t0
    finally:
        bench_torch.SIZES["cuda"] = cuda_sizes
    lines = printed.getvalue().splitlines()
    assert rc == 0 and len(lines) == 1, f"bench_torch.main returned {rc} and printed {len(lines)} lines: {lines[-3:]}"
    line = json.loads(lines[0])
    failed = [k for k in line["detail"] if k.endswith(("_error", "_skipped"))]
    assert line["metric"] == "banded_align_DP_cells_per_s" and line["value"] > 0 and not failed, failed
    assert line["detail"]["device"] == card
    print(f"[bench] bench_torch.main at toy sizes on cuda: one JSON line, headline {line['value']} cells/s at "
          f"{BENCH_TOY['fused_jobs']} jobs, no failed or skipped block, {bench_s:.1f} s", flush=True)
    bench_run = launches_since(base)
    print(f"[launches] bench phase (no path): K1 fused {bench_run['myers_fused']}, K1 check mode "
          f"{bench_run['myers_rows']}, K2 fused {bench_run['banded_fused']}, K2 check mode "
          f"{bench_run['banded_dp']}", flush=True)
    assert bench_run["myers_rows"] > 0, "raw_kernel_rate never launched K1's check mode"

    def entry(name, source, replaces, n_launches, err, ms, plain_ms):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None,  # no single PyTorch call computes any of these functions
        }

    # times, errors and bounds are the check jobs' (8,192 x B=256); launches
    # sum the paths this script drives, each counted from just before it: for
    # K1 the default CLI run, the three-contig single-process run, both
    # processes of the distributed run (read from their logs) and the K1 map
    # step on the mesh; for K2 the use_myers=False run and the K2 map step on
    # the mesh, the polisher's training (its corpus and held-out check) and the
    # metagenome (myers_rows and banded_dp are the check modes of K1 and K2,
    # off every path)
    k1_paths = (launches, dist_single_launches, *dist_launches, mesh_k1, train_k1, quality_k1)
    k2_paths = (k2_launches, mesh_k2)
    print(f"[launches] K1 fused by path (default run, three contigs single, process 0, process 1, mesh, "
          f"training, metagenome): "
          f"{k1_paths}; K2 fused (use_myers=False run, mesh): {k2_paths}", flush=True)
    k1_at = "hairsplitter_tpu/ops/align_myers_pallas.py:50"
    k2_at = "hairsplitter_tpu/ops/align_pallas.py:50"
    print(json.dumps({"kernels": [
        entry("myers_rows", "hairsplitter_tpu_torch/csrc/myers_rows.cu", k1_at,
              check_mode_launches, max_err, k_ms, p_ms),
        entry("myers_fused", "hairsplitter_tpu_torch/csrc/myers_fused.cu", k1_at,
              sum(k1_paths), fused_err, f_ms, fp_ms),
        entry("banded_dp", "hairsplitter_tpu_torch/csrc/banded_dp.cu", k2_at,
              k2_check_launches, k2_err, k2_ms["enc"], k2_plain_ms["enc"]),
        entry("banded_fused", "hairsplitter_tpu_torch/csrc/banded_fused.cu", k2_at,
              sum(k2_paths), k2f_err, k2f_ms, k2fp_ms),
        # no TPU kernel: the JAX package's column stats are jnp; times at clonal30x's blocks
        entry("window_stats", "hairsplitter_tpu_torch/csrc/window_stats.cu", None,
              ws_main, 0, ws["clonal30x"]["ms"], ws["clonal30x"]["plain_ms"]),
        # no TPU kernel: seeding is host code in the JAX package; its plain
        # version is the host route (numpy and native C++), timed on the host
        entry("chain_seeds", "hairsplitter_tpu_torch/csrc/chain_seeds.cu", None,
              cs_main, 0, cs["ms"], cs["host_ms"]),
        # no TPU kernel: the CIGAR walk is host numpy in the JAX package; its
        # plain version is the host copies, timed on the host
        entry("pileup_cells", "hairsplitter_tpu_torch/csrc/pileup_cells.cu", None,
              pc_main, 0, pc["ms"], pc["host_ms"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

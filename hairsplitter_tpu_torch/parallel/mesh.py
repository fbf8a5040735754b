"""Sharding of the PRODUCTION phasing step over a list of torch devices
(contigs x SNPs).

Counterpart of `hairsplitter_tpu/parallel/mesh.py`, with a plain grid of
torch devices in the place of a `jax.sharding.Mesh` and the collectives
XLA inserts there written out. The reference is single-node OpenMP: a
`parallel for` over contigs with one critical-section reduction for the
global error rate (`src/call_variants.cpp:1276-1371`). Here the same
structure is a 2-D grid over `ops.phase.phase_contigs_batch` — the device
code the pipeline runs per window (`pipeline/separate_reads.py` routes its
device branch through `phase_window_core`):

  axis 'ctg'  — data parallelism over contig windows, the OpenMP-loop axis;
  axis 'pos'  — sequence parallelism over pileup positions / SNP columns
                (the reference's 300 kb chunking + 2000 bp windowing axis).

Two reductions cross shards, both of integers: the (mismatch, cell) sums of
the global error rate, and the sims/diffs contraction over the sharded SNP
axis (0/1 indicator products — exact in f32, added as int32 on each row's
first device). So sharded == unsharded bit for bit
(tests/test_torch_sharding.py). A device may appear in the list more than
once (`["cpu"] * 8`, or one card): its shards then run one after the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import N_TRIMERS, TRIMER_ABSENT
from ..ops.phase import (
    error_rate_f32,
    phase_window_core,
    sims_diffs_core,
    window_error_sums,
)


class Mesh:
    """A (ctg, pos) grid of torch devices."""

    axis_names = ("ctg", "pos")

    def __init__(self, devices, ctg: int):
        devs = [torch.device(d) for d in devices]
        self.devices = [devs[i : i + len(devs) // ctg] for i in range(0, len(devs), len(devs) // ctg)]
        self.shape = (ctg, len(devs) // ctg)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def flat(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]


def make_mesh(devices) -> Mesh:
    """Arrange `devices` (names or torch devices) as a (ctg, pos) grid, as
    square as possible, 'ctg' the smaller factor."""
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh needs at least one device")
    ctg = 1
    for f in range(int(np.sqrt(n)), 0, -1):
        if n % f == 0:
            ctg = f
            break
    return Mesh(devices, ctg)


def make_phase_example(C=4, Rr=64, Pp=512, S=64, K=8, seed=0):
    """A nontrivial two-haplotype example: reads split into two groups whose
    allele indicators disagree at the S SNP columns (with noise), so the
    production knee-rule graph and CW actually separate them."""
    rng = np.random.default_rng(seed)
    group = (np.arange(Rr) % 2).astype(np.int8)  # alternating haplotypes
    # pileup: central base differs from the contig where a read carries the
    # alt; ~20% of cells uncovered
    contig_codes = rng.integers(0, 4, (C, Pp)).astype(np.int8)
    pileup = np.broadcast_to(contig_codes[:, None, :] * 25, (C, Rr, Pp)).astype(np.int8).copy()
    err_cells = rng.random((C, Rr, Pp)) < 0.03
    pileup[err_cells] = rng.integers(0, N_TRIMERS, int(err_cells.sum())).astype(np.int8)
    pileup[rng.random((C, Rr, Pp)) < 0.2] = TRIMER_ABSENT
    # allele indicators at SNPs: group 1 carries the second allele, with 5%
    # noise; both groups always covered at ~85% of SNPs
    covered = rng.random((C, Rr, S)) < 0.85
    carries_alt = (group[None, :, None] == 1) ^ (rng.random((C, Rr, S)) < 0.05)
    A = (covered & carries_alt).astype(np.float32)
    R = (covered & ~carries_alt).astype(np.float32)
    # seeds: per (contig, seed-SNP) the reference labels each read with the
    # first read sharing its allele (`src/separate_reads.cpp:1674-1693`)
    inits = np.zeros((C, K, Rr), dtype=np.int32)
    for c in range(C):
        for k in range(K):
            col = rng.integers(0, S)
            alt = A[c, :, col] > 0
            first_alt = int(np.argmax(alt)) if alt.any() else 0
            first_ref = int(np.argmax(~alt)) if (~alt).any() else 0
            inits[c, k] = np.where(alt, first_alt, first_ref)
    mask = np.ones((C, Rr), dtype=bool)
    return pileup, contig_codes, A, R, mask, inits


def _split(x: np.ndarray, axis: int, parts: int) -> list[np.ndarray]:
    if x.shape[axis] % parts:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not divide over {parts} devices")
    return np.split(x, parts, axis=axis)


def _place(mesh: Mesh, x, pos_axis: int | None) -> list[list[torch.Tensor]]:
    """Split axis 0 over 'ctg' and `pos_axis` over 'pos'; with no `pos_axis`
    the row's block lives on the row's first device only."""
    x = np.asarray(x)
    grid = []
    for i, block in enumerate(_split(x, 0, mesh.shape[0])):
        parts = _split(block, pos_axis, mesh.shape[1]) if pos_axis is not None else [block]
        grid.append([torch.from_numpy(np.ascontiguousarray(p)).to(mesh.devices[i][j]) for j, p in enumerate(parts)])
    return grid


def phase_shard_step(mesh: Mesh, example=None, n_iters: int = 30):
    """The production phase step over the mesh: contigs split over 'ctg';
    pileup positions (for the error sums) and SNP columns (for the four
    products) split over 'pos'. Returns (fn, device-placed example args);
    `fn(*args)` gives (err np.float32, adj, labels) on the host, equal to
    `phase_contigs_batch` on the unsplit example bit for bit."""
    if example is None:
        example = make_phase_example()
    pileup, contig_codes, A, Rm, mask, inits = example
    args = (
        _place(mesh, pileup, 2),
        _place(mesh, contig_codes, 1),
        _place(mesh, A, 2),  # SNP axis over 'pos'
        _place(mesh, Rm, 2),
        _place(mesh, mask, None),
        _place(mesh, inits, None),
    )

    def fn(pileup, contig_codes, A, Rm, mask, inits):
        ctg, pos = mesh.shape
        # every shard's partial results first, then the reductions: devices
        # that run on their own are not held up by a host read in between
        sums = [[window_error_sums(pileup[i][j], contig_codes[i][j]) for j in range(pos)] for i in range(ctg)]
        prods = [[sims_diffs_core(A[i][j], Rm[i][j]) for j in range(pos)] for i in range(ctg)]
        # the all-reduce of the error sums: over 'pos' on each row's first
        # device, over 'ctg' on the host; err is formed once, for every row
        mism = cov = 0
        for i in range(ctg):
            first = mesh.devices[i][0]
            row = torch.stack([torch.stack(s).to(first) for s in sums[i]]).sum(dim=0)
            mism += int(row[0])
            cov += int(row[1])
        err = error_rate_f32(mism, cov)
        adjs, labels = [], []
        for i in range(ctg):
            first = mesh.devices[i][0]
            # the reduce of the SNP contraction: int32 partial sims/diffs
            sim = torch.stack([p[0].to(first) for p in prods[i]]).sum(dim=0, dtype=torch.int32)
            diff = torch.stack([p[1].to(first) for p in prods[i]]).sum(dim=0, dtype=torch.int32)
            a, l = phase_window_core(sim, diff, mask[i][0], inits[i][0], float(err), n_iters)
            adjs.append(a)
            labels.append(l)
        return err, torch.cat([a.cpu() for a in adjs]), torch.cat([l.cpu() for l in labels])

    return fn, args


def column_stats_shard_step(mesh: Mesh, pileup: np.ndarray):
    """Stage-3's window column stats (`ops/variants.py:window_stats_batch`:
    per-position top-3 trimer counts + coverage) under the mesh: contigs
    over 'ctg', pileup positions over 'pos'. Every statistic is
    position-local, so nothing crosses shards and sharded == unsharded holds
    bit for bit. Returns (fn, device-placed args); `fn(*args)` gives (top
    codes [C, P, 3], top counts [C, P, 3], coverage [C, P]) on the host."""
    from ..ops.variants import window_stats_batch

    pileup = np.asarray(pileup)
    args = (_place(mesh, pileup, 2),)

    def fn(pileup):
        rows = []
        for row in pileup:
            # the error counts of the same pass are not read: any contig codes do
            parts = [
                window_stats_batch(p, torch.zeros((p.shape[0], p.shape[2]), dtype=torch.int8, device=p.device))
                for p in row
            ]
            rows.append([torch.cat([part[k].cpu() for part in parts], dim=1) for k in range(3)])
        return tuple(torch.cat([r[k] for r in rows]) for k in range(3))

    return fn, args


def make_map_example(n: int, spec, seed: int = 0, err: float = 0.05):
    """A batch of realistic DP jobs: queries + mutated targets with varied
    lengths (exercises the readout masks and traceback)."""
    from ..ops.align import Q_SENTINEL, T_SENTINEL

    rng = np.random.default_rng(seed)
    B, T = spec.chunk, spec.t_width
    q = np.full((n, B), Q_SENTINEL, np.int8)
    t = np.full((n, T), T_SENTINEL, np.int8)
    qlens = rng.integers(B // 2, B + 1, n).astype(np.int32)
    tlens = np.zeros(n, np.int32)
    for i in range(n):
        base = rng.integers(0, 4, qlens[i]).astype(np.int8)
        q[i, : qlens[i]] = base
        mut = np.where(rng.random(qlens[i]) < err, rng.integers(0, 4, qlens[i]), base)
        tl = min(T, qlens[i] + int(rng.integers(-4, 5)))
        t[i, :tl] = np.resize(mut, tl)
        tlens[i] = tl
    modes = (np.arange(n) % 2).astype(np.int32)
    return q, qlens, t, tlens, modes


def map_shard_step(mesh: Mesh, n_per_device: int = 8, spec=None, kernel: str = "jnp"):
    """The OTHER production device path under the mesh: the fused mapping
    call (DP + readout + row-lockstep traceback, `ops/align_device.py:
    align_traceback_rows` — the call `core/mapping.py` dispatches per
    bucket) with the batch axis split over EVERY device of the grid. Chunk
    alignments are independent, so mapping is pure data parallelism:
    nothing crosses shards. kernel='jnp' is the plain DP at any band (the
    default, with `BandSpec(chunk=64, band=32)`); 'myers' and 'pallas' with
    the default `BandSpec()` launch the fused K1 / K2 CUDA kernels on the
    shards that lie on a card, and take their plain versions on the CPU.

    Returns (fn, device-placed sharded args); `fn(*args)` gives the fused
    buffer uint8 [N, 16 + B] on the host."""
    from ..ops.align import BandSpec
    from ..ops.align_device import align_traceback_rows

    spec = spec or BandSpec(chunk=64, band=32)
    devices = mesh.flat()
    example = make_map_example(n_per_device * len(devices), spec)
    args = tuple(
        [torch.from_numpy(np.ascontiguousarray(p)).to(d) for p, d in zip(_split(a, 0, len(devices)), devices)]
        for a in example
    )

    def fn(q, q_lens, t, t_lens, modes):
        shards = [
            align_traceback_rows(q[k], q_lens[k], t[k], t_lens[k], modes[k], spec, kernel)
            for k in range(len(devices))
        ]
        return torch.cat([s.cpu() for s in shards])

    return fn, args

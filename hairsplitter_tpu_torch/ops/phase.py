"""Device phasing core: the knee-rule read graph and the seeded
Chinese-Whispers runs of a batch of windows.

Counterpart of `hairsplitter_tpu/ops/phase.py` (`sims_diffs_core`,
`read_graph_device`, `phase_window_core`, `phase_windows_sub_jit`,
`phase_windows_jit`, `phase_contigs_batch`), with the JAX `vmap` over
windows written out as a leading batch axis. Float32
arithmetic and operation order follow the JAX twin, which is bit-identical
to the native host twin (`native/hs_native.cpp:hs_create_read_graph`).
"""

from __future__ import annotations

import numpy as np
import torch

from .cluster import chinese_whispers_multi
from .variants import window_stats_batch

_F32_07 = float(np.float32(0.7))
_F32_099 = float(np.float32(0.99))
# MIN_OVERLAP_CAP of pipeline/separate_reads.py (kept in sync, as in the JAX package)
_OVERLAP_CAP = 18.0


def sims_diffs_core(A: torch.Tensor, R: torch.Tensor):
    """sim = 3*A*At + R*Rt, diff = A*Rt + R*At with zero diagonals
    (`src/separate_reads.cpp:399-433`) from unpacked f32 0/1 indicators
    [..., n, S]; int32 [..., n, n] results. Exact at full f32 matmul
    precision, and additive over a split of the S axis."""
    At, Rt = A.transpose(-1, -2), R.transpose(-1, -2)
    sim = 3.0 * (A @ At) + R @ Rt
    diff = A @ Rt + R @ At
    off = 1 - torch.eye(A.shape[-2], dtype=torch.float32, device=A.device)
    return (sim * off).to(torch.int32), (diff * off).to(torch.int32)


def read_graph_device(
    sim: torch.Tensor,  # int32 [G, n, n]
    diff: torch.Tensor,  # int32 [G, n, n]
    mask: torch.Tensor,  # bool [G, n]
    err: float,  # global error rate (f32)
) -> torch.Tensor:
    """Reference read-graph rules per window (`ops/phase.py:
    read_graph_device`); returns int8 [G, n, n] symmetric adjacency.

    The rank-order `lax.scan` of the JAX twin (accept a neighbor when it
    passes the floor and is unconditional or fewer than 5 were accepted
    before it) has the closed form accept = ok & (unc | excl_cumsum(ok) < 5):
    the first 5 passing neighbors are always accepted, so "fewer than 5
    accepted before" equals "fewer than 5 passing before"."""
    G, n, _ = sim.shape
    dev = sim.device
    idx = torch.arange(n, device=dev)
    s = sim.to(torch.float32)
    d = diff.to(torch.float32)
    valid = mask[:, None, :] & (idx[None, :] != idx[:, None]) & (sim > 0)
    dd = torch.clamp(d - 1.0, min=0.0)
    dist = torch.where(valid, 1.0 - dd / (s + d), 0.0)
    max_compat = torch.where(valid, s, 0.0).amax(dim=-1).clamp(min=5.0)
    floor_compat = torch.clamp(torch.clamp(max_compat * _F32_07, max=_OVERLAP_CAP), min=5.0)
    dist = torch.where(valid & ((s + d) < floor_compat[..., None]), 0.0, dist)

    order = torch.argsort(-dist, dim=-1, stable=True)
    dsorted = dist.gather(-1, order)
    if n > 1:
        link_thr = dsorted[..., 0] - (dsorted[..., 0] - dsorted[..., 1]) * 3.0
    else:
        link_thr = torch.ones((G, n), dtype=torch.float32, device=dev)
    k = (dsorted == 1.0).sum(dim=-1)
    k2 = torch.clamp(k + 4, max=n - 1)
    fb = dsorted.gather(-1, k2[..., None])[..., 0]
    link_thr = torch.where((link_thr == 1.0) & (k < n), fb, link_thr)

    err32 = torch.tensor(err, dtype=torch.float32)
    d_floor = float(torch.clamp(1.0 - 2.0 * err32, max=_F32_099))
    uncond = (dsorted == 1.0) | (dsorted >= link_thr[..., None])
    mask_j = mask[:, None, :].expand(G, n, n).gather(-1, order)
    ok = (dsorted > d_floor) & mask_j
    before = torch.cumsum(ok.to(torch.int32), dim=-1) - ok.to(torch.int32)
    accepts = ok & (uncond | (before < 5))
    adj_dir = torch.zeros((G, n, n), dtype=torch.bool, device=dev).scatter_(-1, order, accepts)
    adj_dir &= mask[..., None]  # only masked rows propose links
    return (adj_dir | adj_dir.transpose(-1, -2)).to(torch.int8)


def phase_window_core(sim, diff, mask, inits, err: float, n_iters: int = 30):
    """Windows' device phasing: read graph + all seeded CW runs. sim/diff
    [G, n, n], mask [G, n], inits [G, K, n]; returns (adj int8 [G, n, n],
    labels int64 [G, K, n])."""
    adj = read_graph_device(sim, diff, mask, err)
    labels = chinese_whispers_multi(adj, inits, mask, n_iters=n_iters)
    return adj, labels


def phase_windows_sub(sims, diffs, masks, inits, err: float, n_iters: int = 30):
    """Row-compacted window batch (`phase_windows_sub_jit`): each window
    carries only the reads spanning it, sims/diffs [G, r, r]."""
    return phase_window_core(sims, diffs, masks, inits, err, n_iters)


def phase_windows(sim, diff, masks, inits, err: float, n_iters: int = 30):
    """Every window of one contig over the contig-level sim/diff [n, n]
    (`phase_windows_jit`): only masks [G, n] and seeds [G, K, n] vary."""
    G = masks.shape[0]
    n = sim.shape[0]
    return phase_window_core(
        sim.expand(G, n, n), diff.expand(G, n, n), masks, inits, err, n_iters
    )


def window_error_sums(pileup: torch.Tensor, contig_codes: torch.Tensor):
    """(mismatched cells, covered cells) of a batch of pileup windows, or of
    any shard of it, as int64 scalars on the pileup's device: the integer
    sums of `ops/variants.py:window_stats_batch`."""
    _, _, _, mism, cov = window_stats_batch(pileup, contig_codes)
    return mism.sum(), cov.sum()


def error_rate_f32(mism: int, cov: int) -> np.float32:
    """The global error rate from the integer sums: a float32 division, as
    the JAX twin's (a double division rounded afterwards can differ in the
    last bit)."""
    return np.float32(mism) / max(np.float32(cov), np.float32(1.0))


def phase_contigs_batch(
    pileup: torch.Tensor,  # int8 [C, R, P] trimer codes (TRIMER_ABSENT = none)
    contig_codes: torch.Tensor,  # int8 [C, P]
    A: torch.Tensor,  # f32 [C, R, S] second-allele indicators
    Rm: torch.Tensor,  # f32 [C, R, S] majority-allele indicators
    mask: torch.Tensor,  # bool [C, R]
    inits: torch.Tensor,  # int32 [C, K, R]
    n_iters: int = 30,
):
    """The full stage-3/4 device step over a batch of contig windows
    (`ops/phase.py:phase_contigs_batch`): the global error-rate reduction
    (the reference's omp-critical sum, `src/call_variants.cpp:1310-1316`),
    contig-level sims/diffs matmuls, and the per-window graph + CW. Returns
    (err np.float32, adj int8 [C, R, R], labels int64 [C, K, R]).
    `parallel/mesh.py` runs the same four functions per shard, around its
    reductions."""
    mism, cov = window_error_sums(pileup, contig_codes)
    err = error_rate_f32(int(mism), int(cov))
    sim, diff = sims_diffs_core(A, Rm)
    adj, labels = phase_window_core(sim, diff, mask, inits, float(err), n_iters)
    return err, adj, labels

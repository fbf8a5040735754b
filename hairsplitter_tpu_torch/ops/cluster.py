"""Read-separation ops: similarity matmuls and Chinese-Whispers label
propagation.

Counterpart of `hairsplitter_tpu/ops/cluster.py`. The seeded CW runs of all
windows go through one batched adjacency x one-hot vote matmul per
half-sweep; every run keeps its own stop state (a done mask), so a run
freezes exactly where the JAX `lax.while_loop` of that run would stop.
"""

from __future__ import annotations

import numpy as np
import torch

# memory budget of one batch of CW runs (bytes of live [R, R] f32 buffers)
_CW_BATCH_BYTES = 1 << 31


def sims_diffs_packed(Ap: torch.Tensor, Rp: torch.Tensor):
    """sim = 3·A·Aᵀ + R·Rᵀ, diff = A·Rᵀ + R·Aᵀ with zero diagonals
    (`ops/cluster.py:sims_diffs_packed`) from bit-packed indicators
    uint8 [n_reads, n_snps/8]; int32 [n_reads, n_reads] results (exact:
    f32 sums of 0/1 products at full matmul precision)."""
    sh = torch.arange(8, dtype=torch.uint8, device=Ap.device)
    A = ((Ap[:, :, None] >> sh) & 1).reshape(Ap.shape[0], -1).to(torch.float32)
    R = ((Rp[:, :, None] >> sh) & 1).reshape(Rp.shape[0], -1).to(torch.float32)
    sim = 3.0 * (A @ A.T) + R @ R.T
    diff = A @ R.T + R @ A.T
    off = 1 - torch.eye(A.shape[0], dtype=torch.float32, device=A.device)
    return (sim * off).to(torch.int32), (diff * off).to(torch.int32)


def cw_jitter(n: int, device) -> torch.Tensor:
    """Tie-break jitter in [0, 0.5) per (node, label): the low 16 bits of
    i*2654435761 + j*40503 + 12345 (the uint32 hash of the JAX twin, whose
    wrap mod 2^32 does not touch the low 16 bits)."""
    ij = torch.arange(n, dtype=torch.int64, device=device)
    h = (ij[:, None] * 2654435761 + ij[None, :] * 40503 + 12345) & 0xFFFF
    return h.to(torch.float32) / (2.0 * 65536.0)


def chinese_whispers_multi(
    adj: torch.Tensor,  # [G, R, R], nonzero = edge (weights ignored)
    inits: torch.Tensor,  # int [G, K, R] seed labelings in [0, R) (or -2)
    mask: torch.Tensor,  # bool [G, R]; False nodes keep label -2
    n_iters: int = 30,
) -> torch.Tensor:
    """Deterministic Chinese Whispers of K seeds on each of G graphs
    (`ops/cluster.py:chinese_whispers_matmul`, `chinese_whispers_multi`):
    half-sweeps update one index parity to the most-voted neighbor label,
    ties broken by the hashed jitter; a run stops once 4 half-sweeps are
    done and a full sweep changed fewer than 3 labels, or after n_iters.
    Returns int64 labels [G, K, R]."""
    G, K, R = inits.shape
    out = torch.empty((G, K, R), dtype=torch.int64, device=inits.device)
    per = max(1, _CW_BATCH_BYTES // (4 * 4 * K * R * R))  # ~4 live [R, R] f32 per run
    jitter = cw_jitter(R, adj.device)
    for lo in range(0, G, per):
        out[lo : lo + per] = _cw_batch(
            adj[lo : lo + per], inits[lo : lo + per], mask[lo : lo + per], jitter, n_iters
        )
    return out


def _cw_batch(adj, inits, mask, jitter, n_iters: int) -> torch.Tensor:
    G, K, R = inits.shape
    edge = (adj > 0).to(torch.float32)[:, None]  # [G, 1, R, R]
    parity = torch.arange(R, device=adj.device) % 2
    node_mask = mask[:, None, :]
    labels = torch.where(node_mask, inits.to(torch.int64), -2)
    changes = torch.zeros((G, K), dtype=torch.int64, device=adj.device)
    running = torch.ones((G, K), dtype=torch.bool, device=adj.device)
    for it in range(n_iters):
        # the while_loop condition of each run, evaluated before its sweep
        running &= (it < 4) | (changes >= 3 * (it // 2) // 2)
        if not bool(running.any()):
            break
        onehot = torch.nn.functional.one_hot(labels.clamp(min=0), R).to(torch.float32)
        onehot *= (labels >= 0)[..., None]
        scores = edge @ onehot + jitter  # [G, K, R, R] votes per label + jitter
        best = torch.argmax(scores, dim=-1)
        best_val = (scores - jitter).amax(dim=-1)
        upd = node_mask & (best_val > 0) & (parity == it % 2) & running[..., None]
        new = torch.where(upd, best, labels)
        changes += (new != labels).sum(dim=-1)
        labels = new
    return labels


def cw_numpy(
    adj: np.ndarray, init: np.ndarray, mask: np.ndarray, n_iters: int = 15, seed: int = 0
) -> np.ndarray:
    """Host Chinese Whispers with seeded random node order (copy of
    `ops/cluster.py:cw_numpy`; the native twin is used when available)."""
    rng = np.random.default_rng(seed)
    labels = np.where(mask, init, -2).astype(np.int64)
    nz = [np.nonzero(adj[i])[0] for i in range(adj.shape[0])]
    order = np.arange(adj.shape[0])
    for _ in range(n_iters):
        changes = 0
        rng.shuffle(order)
        for i in order:
            if not mask[i]:
                continue
            neigh = nz[i]
            if neigh.size == 0:
                continue
            lab = labels[neigh]
            lab = lab[lab >= 0]
            if lab.size == 0:
                continue
            counts = np.bincount(lab)
            top = np.nonzero(counts == counts.max())[0]
            best = int(top[rng.integers(top.size)]) if top.size > 1 else int(top[0])
            if counts[best] > 0 and labels[i] != best:
                labels[i] = best
                changes += 1
        if changes < 3:
            break
    return labels

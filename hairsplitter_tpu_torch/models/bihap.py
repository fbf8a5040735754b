"""Spectral read-by-SNP biclustering phaser (the BiHap-equivalent).

Counterpart of `hairsplitter_tpu/models/bihap.py`: build the +-1 read x SNP
allele matrix (the same indicators stage 4 uses), take its leading singular
vectors with `torch.linalg.svd` on the caller's device, and cluster reads by
sign patterns: spectral co-clustering without external solvers. Everything
after the SVD is that module's numpy code, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline.call_variants import SparseColumn


def allele_matrix(columns: list[SparseColumn], n_reads: int) -> np.ndarray:
    """Read x SNP matrix: +1 second allele, -1 majority allele, 0 absent."""
    M = np.zeros((n_reads, len(columns)), dtype=np.float32)
    for s, c in enumerate(columns):
        M[c.rows[c.alleles == c.top2], s] = 1.0
        M[c.rows[c.alleles == c.top1], s] = -1.0
    return M


def spectral_phase(
    columns: list[SparseColumn], n_reads: int, n_haplotypes: int = 0, max_k: int = 8, *, device
) -> np.ndarray:
    """Cluster reads into haplotypes by the signs of the leading singular
    vectors of the allele matrix (SVD on `device`). n_haplotypes 0 ->
    inferred from the singular-value spectrum. Returns labels (-1 =
    unassignable).

    What two SVD implementations may disagree on, and what that does here: a
    singular vector's sign is free, but flipping one only permutes the sign
    codes, and labels are renumbered by first appearance, so the labels
    survive it. What does not survive: an entry of `u` that is zero within
    rounding (its sign is arbitrary), equal singular values (their vectors
    are any basis of the shared subspace), and, with `n_haplotypes` given,
    the unstable `np.argsort(counts)` of the merge loop when counts tie."""
    M = allele_matrix(columns, n_reads)
    present = (np.abs(M).sum(axis=1) > 0)
    if not present.any() or not columns:
        return np.full(n_reads, -1, dtype=np.int64)
    u, s, vt = (
        x.cpu().numpy()
        for x in torch.linalg.svd(torch.from_numpy(M).to(device), full_matrices=False)
    )
    if n_haplotypes <= 0:
        # spectral gap: components clearly above the noise floor
        floor = np.median(s) + 1e-9
        k_dims = int(np.sum(s > 3 * floor))
        k_dims = max(1, min(k_dims, int(np.ceil(np.log2(max_k)))))
    else:
        k_dims = max(1, int(np.ceil(np.log2(max(2, n_haplotypes)))))
    signs = (u[:, :k_dims] > 0).astype(np.int64)
    labels = np.full(n_reads, -1, dtype=np.int64)
    code = np.zeros(n_reads, dtype=np.int64)
    for d in range(k_dims):
        code = code * 2 + signs[:, d]
    # renumber codes of present reads
    renum: dict[int, int] = {}
    for r in range(n_reads):
        if present[r]:
            c = int(code[r])
            if c not in renum:
                renum[c] = len(renum)
            labels[r] = renum[c]
    if n_haplotypes > 0:
        # merge smallest clusters until within the cap
        while len(set(labels[labels >= 0].tolist())) > n_haplotypes:
            vals, counts = np.unique(labels[labels >= 0], return_counts=True)
            order = np.argsort(counts)
            small, target = vals[order[0]], vals[order[1]]
            labels[labels == small] = target
    return labels


def write_bihap_solution(path: str, contig: str, read_names: list[str], labels: np.ndarray) -> None:
    """BiHap-style CONTIG/READ/LABELS solution file (`BiHap/BiHap.py:500-554`)."""
    with open(path, "w") as f:
        f.write(f"CONTIG\t{contig}\n")
        for n in read_names:
            f.write(f"READ\t{n}\n")
        f.write("LABELS\t" + ",".join(str(int(l)) for l in labels) + "\n")

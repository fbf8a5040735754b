"""Strain recovery and switch errors of an assembly against the truth
strains: a frozen NumPy copy of `hairsplitter_tpu_torch/utils/evaluate.py:
evaluate_phasing` (k-mer containment per 2 kb window on both strands,
switches between confidently assigned windows, and the share of each
strain's k-mers found anywhere in the output), with k-mers packed into
integers instead of kept as Python strings. Same numbers as the original
on ACGT sequences. A k-mer holding any other letter can match no truth
k-mer (the truth strains are ACGT only) and is left out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _LUT[_ch] = _i
    _LUT[ord(chr(_ch).lower())] = _i


def codes_of(seq: str | np.ndarray) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8)
    return _LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]


def kmer_codes(codes: np.ndarray, k: int, step: int = 1) -> np.ndarray:
    """Every `step`-th k-mer of 2-bit codes, packed big-end first into
    uint64, leaving out each k-mer that holds a code outside 0..3."""
    n = codes.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    c = (codes & 3).astype(np.uint64)
    acc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        acc = (acc << np.uint64(2)) | c[j : j + n]
    bad = np.concatenate([[0], np.cumsum(codes > 3)])
    ok = bad[k:] == bad[:-k]
    return acc[::step][ok[::step]]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)  # a code over 3 stays over 3


def _count_in(q: np.ndarray, sorted_ref: np.ndarray) -> int:
    if q.size == 0 or sorted_ref.size == 0:
        return 0
    idx = np.searchsorted(sorted_ref, q)
    idx[idx >= sorted_ref.size] = 0
    return int(np.count_nonzero(sorted_ref[idx] == q))


@dataclass
class Score:
    recovery: list[float]  # per truth strain
    switches: int
    contigs_scored: int


def _call(scores: list[float]) -> int:
    best = max(range(len(scores)), key=lambda i: scores[i])
    second = max((s for i, s in enumerate(scores) if i != best), default=0.0)
    return best if scores[best] > 0.5 and scores[best] - second > 0.1 else -1


def _switches(calls: list[int]) -> int:
    confident = [c for c in calls if c >= 0]
    return sum(1 for a, b in zip(confident[:-1], confident[1:]) if a != b)


def score_assembly(contigs: dict[str, str], haps: list[str], k: int = 31, window: int = 2000,
                   min_contig: int = 1000) -> Score:
    """Recovery of each truth strain and switch errors of `contigs`
    (`evaluate_phasing`'s `haplotype_recovery` and `total_switch_errors`)."""
    if k > 32:
        raise ValueError("k-mers are packed into 64 bits: k <= 32")
    hap_codes = [codes_of(h) for h in haps]
    out_codes = {n: codes_of(s) for n, s in contigs.items()}
    hk = [np.unique(kmer_codes(c, k)) for c in hap_codes]
    all_out = np.unique(np.concatenate(
        [np.zeros(0, np.uint64)]
        + [kmer_codes(c, k) for c in out_codes.values()]
        + [kmer_codes(revcomp_codes(c), k) for c in out_codes.values()]
    ))
    switches, scored = 0, 0
    for c in out_codes.values():
        if c.size < min_contig:
            continue
        scored += 1
        calls = []
        for lo in range(0, max(1, c.size - window + 1), window):
            w = c[lo : lo + window]
            qk = np.unique(kmer_codes(w, k, 7))
            qr = np.unique(kmer_codes(revcomp_codes(w), k, 7))
            scores = [
                max(_count_in(qk, h) / max(1, qk.size), _count_in(qr, h) / max(1, qr.size)) for h in hk
            ]
            calls.append(_call(scores))
        switches += _switches(calls)
    rec = [_count_in(h, all_out) / h.size if h.size else 0.0 for h in hk]
    return Score(rec, switches, scored)

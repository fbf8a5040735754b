"""Minimizer seeding and chaining: the host route (vectorized numpy and the
native C++ twins), which is the CPU route and the twin of the card route.
On a CUDA device `core/mapping.py:map_reads` chains a call's reads with one
launch of `csrc/chain_seeds.cu` (`ops/chain_seeds.py:find_chains_cuda`),
whose chains equal `find_chains_batch`'s bit for bit; `find_chains`, one
read at a time, stays on the host.

Replaces the reference's dependence on minimap2 for read→assembly mapping
(`hairsplitter.py:629-630` shells out `minimap2 -a --secondary=no -M 0.05 -Y`).
The reference even carries an unused minimizer routine
(`src/sequence.cpp:98-165`) — here it is the real seeder: minimizers are
matched against a global index over all contigs, anchors are chained per
(contig, strand) diagonal band, and the chains drive the batched banded-DP
device aligner (`hairsplitter_tpu_torch.ops.align`).

Copy of `hairsplitter_tpu/core/seeding.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field

import numpy as np


def _kmer_codes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement 2-bit packed k-mers at every position.

    Returns (fwd, rc) uint64 arrays of length n-k+1; positions containing a
    non-ACGT base are flagged by fwd == np.iinfo(uint64).max.
    """
    n = len(codes)
    if n < k:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    c = codes.astype(np.uint64)
    bad = codes > 3
    fwd = np.zeros(n - k + 1, dtype=np.uint64)
    rc = np.zeros(n - k + 1, dtype=np.uint64)
    anybad = np.zeros(n - k + 1, dtype=bool)
    for j in range(k):
        fwd |= (c[j : n - k + 1 + j] & np.uint64(3)) << np.uint64(2 * (k - 1 - j))
        rc |= ((np.uint64(3) - (c[k - 1 - j : n - j] & np.uint64(3)))) << np.uint64(2 * (k - 1 - j))
        anybad |= bad[j : n - k + 1 + j]
    fwd[anybad] = np.iinfo(np.uint64).max
    return fwd, rc


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — invertible hash so minimizer choice is pseudorandom."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def hpc_compress(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Homopolymer-compress a code array: runs of the same base collapse to
    one. Returns (compressed codes, original position of each compressed
    base — the run start). minimap2's `-H` (the map-pb preset the reference
    relies on for PacBio CLR, `hairsplitter.py:629`): CLR errors are
    indel-dominated inside homopolymer runs, so seeding in HPC space
    recovers anchors raw k-mers lose."""
    if codes.size == 0:
        return codes, np.zeros(0, np.int64)
    keep = np.empty(codes.size, dtype=bool)
    keep[0] = True
    np.not_equal(codes[1:], codes[:-1], out=keep[1:])
    orig = np.nonzero(keep)[0].astype(np.int64)
    return np.ascontiguousarray(codes[keep]), orig


def minimizers(
    codes: np.ndarray, k: int, w: int, hpc: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions, canonical k-mer hashes, strand) of the sequence's minimizers.

    strand: 0 if the forward k-mer is canonical, 1 if the reverse complement is.
    With hpc, minimizers are extracted from the homopolymer-compressed
    sequence and positions map back to ORIGINAL coordinates (run starts);
    the few-base positional slack vs the nominal k-mer span is absorbed by
    the DP band like the interpolated pins are. Dispatches to the native
    rolling implementation when available (bit-identical; ~10x the numpy
    path, tests/test_native.py)."""
    from .. import native as _native

    if hpc:
        comp, orig = hpc_compress(np.asarray(codes, dtype=np.int8))
        p, h, s = minimizers(comp, k, w, hpc=False)
        return orig[p], h, s
    out = _native.minimizers(np.ascontiguousarray(codes, dtype=np.int8), k, w)
    if out is not None:
        return out
    return _minimizers_numpy(codes, k, w)


def _minimizers_numpy(codes: np.ndarray, k: int, w: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-numpy reference implementation of :func:`minimizers`."""
    fwd, rc = _kmer_codes(codes, k)
    if fwd.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64), np.zeros(0, np.int8)
    bad = fwd == np.iinfo(np.uint64).max
    strand = (rc < fwd).astype(np.int8)
    canon = np.minimum(fwd, rc)
    ambiguous = fwd == rc  # palindromic k-mer: strand undefined, skip (as minimap2 does)
    h = _mix64(canon)
    h[bad | ambiguous] = np.iinfo(np.uint64).max
    if h.size <= w:
        p = np.array([int(np.argmin(h))])
    else:
        win = np.lib.stride_tricks.sliding_window_view(h, w)
        p = np.unique(win.argmin(axis=1) + np.arange(win.shape[0]))
    keep = h[p] != np.iinfo(np.uint64).max
    p = p[keep]
    return p, h[p], strand[p]


@dataclass
class MinimizerIndex:
    """Global minimizer index over a set of contigs (hash → sorted hit arrays)."""

    k: int = 15
    w: int = 10
    contig_names: list[str] = field(default_factory=list)
    # parallel arrays sorted by hash: hash, contig id, position, strand
    _hash: np.ndarray = None
    _cid: np.ndarray = None
    _pos: np.ndarray = None
    _strand: np.ndarray = None
    max_occ: int = 64  # drop repetitive seeds occurring more often than this
    hpc: bool = False  # homopolymer-compressed seeding (minimap2 -H / map-pb)

    @classmethod
    def build(
        cls,
        contigs: dict[str, np.ndarray],
        k: int = 15,
        w: int = 10,
        max_occ: int = 64,
        hpc: bool = False,
    ) -> "MinimizerIndex":
        """contigs: name -> int8 base-code array."""
        idx = cls(k=k, w=w, max_occ=max_occ, hpc=hpc)
        hs, cids, poss, strs = [], [], [], []
        for cid, (name, codes) in enumerate(contigs.items()):
            idx.contig_names.append(name)
            p, h, s = minimizers(codes, k, w, hpc=hpc)
            hs.append(h)
            cids.append(np.full(p.size, cid, dtype=np.int32))
            poss.append(p.astype(np.int64))
            strs.append(s)
        h = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
        order = np.argsort(h, kind="stable")
        idx._hash = h[order]
        idx._cid = np.concatenate(cids)[order] if hs else np.zeros(0, np.int32)
        idx._pos = np.concatenate(poss)[order] if hs else np.zeros(0, np.int64)
        idx._strand = np.concatenate(strs)[order] if hs else np.zeros(0, np.int8)
        return idx

    def lookup(self, hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """For each query hash return hits: (query_idx, contig_id, pos, strand)."""
        from .. import native as _native

        nat = _native.index_lookup(self._hash, hashes, self.max_occ)
        if nat is not None:
            qidx, at = nat
            return qidx, self._cid[at], self._pos[at], self._strand[at]
        lo = np.searchsorted(self._hash, hashes, side="left")
        hi = np.searchsorted(self._hash, hashes, side="right")
        counts = hi - lo
        keep = counts <= self.max_occ
        counts = np.where(keep, counts, 0)
        total = int(counts.sum())
        qidx = np.repeat(np.arange(hashes.size), counts)
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z.astype(np.int32), z, z.astype(np.int8)
        # offsets into the sorted arrays for every hit
        starts = np.repeat(lo, counts)
        within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        at = starts + within
        return qidx, self._cid[at], self._pos[at], self._strand[at]


@dataclass
class Chain:
    """A chained set of anchors placing a read interval on a contig."""

    contig_id: int
    strand: int  # 1 = read forward, 0 = read reverse-complemented
    # anchors in the coordinates of the (oriented) read: both increasing
    q_anchors: np.ndarray  # int64 [n]
    t_anchors: np.ndarray  # int64 [n]
    score: int = 0

    @property
    def q_span(self) -> tuple[int, int]:
        return int(self.q_anchors[0]), int(self.q_anchors[-1])


def _lis_monotonic(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Indices of a longest subsequence strictly increasing in both q and t
    (anchors pre-sorted by t; patience LIS on q)."""
    n = q.size
    if n == 0:
        return np.zeros(0, np.int64)
    if n > 64:  # native C++ LIS for larger anchor sets
        from .. import native

        out = native.lis_monotonic(np.asarray(q, dtype=np.int64))
        if out is not None:
            return out
    tails: list[int] = []  # q values
    tails_idx: list[int] = []
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        j = bisect_left(tails, q[i])
        if j > 0:
            parent[i] = tails_idx[j - 1]
        if j == len(tails):
            tails.append(q[i])
            tails_idx.append(i)
        elif q[i] < tails[j]:
            tails[j] = q[i]
            tails_idx[j] = i
    out = []
    cur = tails_idx[-1]
    while cur >= 0:
        out.append(cur)
        cur = parent[cur]
    return np.asarray(out[::-1], dtype=np.int64)


def chain_anchors(
    qpos: np.ndarray,
    tpos: np.ndarray,
    max_diag_diff: int = 500,
    max_gap: int = 5000,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Split anchors (one contig+strand) into co-diagonal, co-local chains.

    Returns a list of (q, t) anchor arrays, each strictly increasing in both.
    """
    if qpos.size == 0:
        return []
    order = np.argsort(tpos, kind="stable")
    q, t = qpos[order], tpos[order]

    def _segment(qs: np.ndarray, ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        keep = _lis_monotonic(qs, ts)
        qs, ts = qs[keep], ts[keep]
        # drop duplicate q/t values that survive LIS ties
        ok = np.ones(qs.size, dtype=bool)
        ok[1:] = (np.diff(qs) > 0) & (np.diff(ts) > 0)
        return qs[ok], ts[ok]

    from .. import native as _native

    breaks = _native.chain_sweep(q, t, max_gap, max_diag_diff)
    if breaks is not None:
        return [
            _segment(q[s0:s1], t[s0:s1])
            for s0, s1 in zip(breaks[:-1], breaks[1:])
            if s1 > s0
        ]

    diag = t - q
    chains = []
    # greedy sweep: break where the target jumps or the diagonal drifts too far
    start = 0
    ref_diag = diag[0]
    for i in range(1, q.size + 1):
        if (
            i == q.size
            or t[i] - t[i - 1] > max_gap
            or abs(int(diag[i]) - int(ref_diag)) > max_diag_diff
        ):
            chains.append(_segment(q[start:i], t[start:i]))
            if i < q.size:
                start = i
                ref_diag = diag[i]
        else:
            # slowly follow the local diagonal so long reads can drift
            ref_diag = (ref_diag * 3 + diag[i]) // 4
    return chains


def find_chains(
    index: MinimizerIndex,
    read_codes: np.ndarray,
    min_anchors: int = 4,
    min_score_frac: float = 0.1,
    max_overlap_frac: float = 0.5,
) -> list[Chain]:
    """All accepted chains of one read, best-first (primary + supplementary).

    Mirrors the reference's SAM filtering: secondary alignments are dropped but
    split/supplementary placements on disjoint read intervals are kept
    (`src/input_output.cpp:472-476`).
    """
    p, h, s = minimizers(read_codes, index.k, index.w, hpc=index.hpc)
    qidx, cid, tpos, tstr = index.lookup(h)
    return _chains_from_hits(
        index, len(read_codes), p, s, qidx, cid, tpos, tstr,
        min_anchors, min_score_frac, max_overlap_frac,
    )


def find_chains_batch(
    index: MinimizerIndex,
    reads_codes: list[np.ndarray],
    min_anchors: int = 4,
    min_score_frac: float = 0.1,
    max_overlap_frac: float = 0.5,
    allowed_cids: list[int] | None = None,
    _threaded: bool = True,
) -> list[list[Chain]]:
    """`find_chains` over many reads with ONE concatenated index lookup —
    the per-read searchsorted calls dominate the host seeding cost
    otherwise. Bit-identical to calling find_chains per read.

    allowed_cids: optional per-read contig-id restriction. Hits on other
    contigs are dropped BEFORE chaining, so secondary-chain suppression
    cannot discard the allowed contig in favor of a better-scoring
    homologous one (the multi-draft polish case).

    Large batches split across a small thread pool: the native minimizer /
    lookup / LIS calls release the GIL, so host seeding scales with cores
    (it is the dominant warm-mapping cost once device dispatch is batched)."""
    if _threaded and len(reads_codes) >= 64:
        import os
        from concurrent.futures import ThreadPoolExecutor

        n_threads = min(4, os.cpu_count() or 1)
        if n_threads > 1:
            step = -(-len(reads_codes) // n_threads)
            spans = [
                (lo, min(lo + step, len(reads_codes)))
                for lo in range(0, len(reads_codes), step)
            ]
            with ThreadPoolExecutor(n_threads) as ex:
                parts = list(
                    ex.map(
                        lambda se: find_chains_batch(
                            index,
                            reads_codes[se[0] : se[1]],
                            min_anchors,
                            min_score_frac,
                            max_overlap_frac,
                            allowed_cids[se[0] : se[1]] if allowed_cids is not None else None,
                            _threaded=False,
                        ),
                        spans,
                    )
                )
            return [c for part in parts for c in part]
    minis = [minimizers(c, index.k, index.w, hpc=index.hpc) for c in reads_codes]
    sizes = np.array([m[1].size for m in minis], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    h_all = (
        np.concatenate([m[1] for m in minis]) if minis else np.zeros(0, np.uint64)
    )
    qidx, cid, tpos, tstr = index.lookup(h_all)
    # hits are emitted in query order -> contiguous per read
    bounds = np.searchsorted(qidx, offsets)
    out: list[list[Chain]] = []
    for r, (p, _h, s) in enumerate(minis):
        lo, hi = bounds[r], bounds[r + 1]
        qi, ci, tp, ts = (
            qidx[lo:hi] - offsets[r],
            cid[lo:hi],
            tpos[lo:hi],
            tstr[lo:hi],
        )
        if allowed_cids is not None and allowed_cids[r] >= 0:
            keep = ci == allowed_cids[r]
            qi, ci, tp, ts = qi[keep], ci[keep], tp[keep], ts[keep]
        out.append(
            _chains_from_hits(
                index,
                len(reads_codes[r]),
                p,
                s,
                qi,
                ci,
                tp,
                ts,
                min_anchors,
                min_score_frac,
                max_overlap_frac,
            )
        )
    return out


def _chains_from_hits(
    index: MinimizerIndex,
    qlen: int,
    p: np.ndarray,
    s: np.ndarray,
    qidx: np.ndarray,
    cid: np.ndarray,
    tpos: np.ndarray,
    tstr: np.ndarray,
    min_anchors: int,
    min_score_frac: float,
    max_overlap_frac: float,
) -> list[Chain]:
    k = index.k
    if qidx.size == 0:
        return []
    rpos = p[qidx]
    rstr = s[qidx]
    # match strand: 0 → read aligns forward, 1 → reverse-complemented
    mstrand = (rstr != tstr).astype(np.int8)
    # work in oriented-read coordinates so both axes increase along the contig
    q_oriented = np.where(mstrand == 0, rpos, qlen - k - rpos)
    candidates: list[Chain] = []
    for c in np.unique(cid):
        for ms in (0, 1):
            sel = (cid == c) & (mstrand == ms)
            if int(sel.sum()) < min_anchors:
                continue
            for q_arr, t_arr in chain_anchors(q_oriented[sel], tpos[sel]):
                if q_arr.size >= min_anchors:
                    candidates.append(
                        Chain(int(c), 1 - ms, q_arr, t_arr, score=int(q_arr.size))
                    )
    if not candidates:
        return []
    candidates.sort(key=lambda ch: -ch.score)
    best = candidates[0].score
    kept: list[Chain] = []
    covered: list[tuple[int, int]] = []  # merged intervals on the forward read
    for ch in candidates:
        if ch.score < max(min_anchors, best * min_score_frac):
            break
        a, b = ch.q_span
        # convert to forward-read interval for overlap accounting
        if ch.strand == 0:
            a, b = qlen - k - b, qlen - k - a
        span = max(1, b - a)
        ov = sum(max(0, min(b, e) - max(a, st)) for st, e in covered)
        if ov > max_overlap_frac * span:
            continue
        # merge the new interval into the covered set (no double counting)
        merged = [(a, b)]
        for st, e in covered:
            if st <= merged[0][1] and e >= merged[0][0]:
                merged[0] = (min(st, merged[0][0]), max(e, merged[0][1]))
            else:
                merged.append((st, e))
        covered = merged
        kept.append(ch)
    return kept

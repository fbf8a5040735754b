"""Per-cluster consensus from aligned reads (the polishing step).

Port of `hairsplitter_tpu/ops/consensus.py` (host numpy; the port owns it
because the JAX module loads JAX): the pileup majority vote with insertion
recovery, and the racon-style remap-and-vote loop on the port's mapper.
`base_caller` swaps the per-column vote for a learned caller (the NN of
`models/polisher.py`, `-p medaka`).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..constants import GAP, PAD, encode_seq
from ..pipeline.pileup import alignment_cells_full, orient_read

_ALPHABET_BYTES = np.frombuffer(b"ACGT-N", dtype=np.uint8)


def consensus_from_cells(
    backbone: np.ndarray,  # int8 contig codes for [start, end]
    start: int,
    rows_cells: list[tuple[np.ndarray, np.ndarray]],  # per read: (tpos, central codes)
    rows_insertions: list[tuple[np.ndarray, np.ndarray]],  # per read: (ins tpos, codes)
    min_cov: int = 1,
    base_caller=None,  # optional fn(counts, cover, ins_rate, backbone) -> bases
) -> str:
    """Consensus of one read group over one interval
    (`ops/consensus.py:consensus_from_cells`). `base_caller` swaps the
    per-column majority vote for a learned caller; insertion recovery stays
    rule-based either way."""
    L = len(backbone)
    counts = np.zeros((L, 5), dtype=np.int32)
    cover = np.zeros(L, dtype=np.int32)
    for tpos, cents in rows_cells:
        lo = np.searchsorted(tpos, start)
        hi = np.searchsorted(tpos, start + L)
        idx = tpos[lo:hi] - start
        c = cents[lo:hi]
        counts[idx, c] += 1
        cover[idx] += 1

    if base_caller is not None:
        ins_events = np.zeros(L, dtype=np.int32)
        for ins_tpos, _ in rows_insertions:
            if ins_tpos.size:
                sel = ins_tpos[(ins_tpos >= start) & (ins_tpos < start + L)] - start
                np.add.at(ins_events, np.unique(sel), 1)
        ins_rate = ins_events / np.maximum(cover, 1)
        best = np.asarray(base_caller(counts, cover, ins_rate, backbone))
    else:
        best = counts.argmax(axis=1)
    # no/low coverage -> keep the backbone base
    use_backbone = cover < min_cov
    out_base = np.where(use_backbone, backbone, best)

    # insertion recovery: majority inserted string before position p
    ins_by_pos: dict[int, list[str]] = {}
    for ins_tpos, ins_codes in rows_insertions:
        if ins_tpos.size == 0:
            continue
        sel = (ins_tpos >= start) & (ins_tpos < start + L)
        it, ic = ins_tpos[sel], ins_codes[sel]
        # group consecutive same-position insertions into strings
        if it.size == 0:
            continue
        brk = np.nonzero(np.diff(it) != 0)[0] + 1
        decoded = _ALPHABET_BYTES[ic].tobytes().decode()  # one decode, sliced per segment
        for seg_lo, seg_hi in zip(np.concatenate([[0], brk]), np.concatenate([brk, [it.size]])):
            p = int(it[seg_lo])
            ins_by_pos.setdefault(p, []).append(decoded[seg_lo:seg_hi])

    # kept bases become one byte string; the (few) accepted insertion strings
    # are spliced in at their filtered offsets
    keep = (out_base != GAP) & (out_base != PAD)
    base_str = _ALPHABET_BYTES[out_base[keep]].tobytes().decode()
    accepted: list[tuple[int, str]] = []
    for gp, cand in ins_by_pos.items():
        p = gp - start
        if cover[p] >= min_cov and len(cand) * 2 > cover[p]:
            s = sorted(Counter(cand).items(), key=lambda kv: (-kv[1], kv[0]))[0][0]
            accepted.append((p, s.replace("-", "").replace("N", "")))
    if not accepted:
        return base_str
    kept_before = np.concatenate([[0], np.cumsum(keep)])  # filtered offset of p
    accepted.sort()
    pieces: list[str] = []
    last = 0
    for p, s in accepted:
        cut = int(kept_before[p])
        pieces.append(base_str[last:cut])
        pieces.append(s)
        last = cut
    pieces.append(base_str[last:])
    return "".join(pieces)


def polish_iterative(
    draft: str,
    reads: list[str],
    rounds: int = 2,
    map_cfg=None,
    base_caller=None,
    min_len: int = 300,
    *,
    device,
) -> str:
    """racon-style convergence polish (`ops/consensus.py:polish_iterative`):
    remap the group's reads to the current draft on `device` and rebuild the
    pileup consensus, to a fixpoint."""
    from ..core.mapping import MapConfig, map_reads

    cur = draft
    if len(cur) < min_len or not reads:
        return cur
    cfg = map_cfg or MapConfig()
    codes = [encode_seq(r) for r in reads]
    for _ in range(rounds):
        alns = map_reads({"d": cur}, reads, cfg, device=device)
        if not alns:
            break
        cells, inss = [], []
        for a in alns:
            oriented = orient_read(codes[a.read_idx], a.strand)
            tpos, tri, it, ic = alignment_cells_full(a, oriented)
            cells.append((tpos, (np.asarray(tri, np.int16) // 25).astype(np.int8)))
            inss.append((it, ic))
        new = consensus_from_cells(
            encode_seq(cur), 0, cells, inss, base_caller=base_caller
        )
        if new == cur or len(new) < min_len:
            break
        cur = new
    return cur

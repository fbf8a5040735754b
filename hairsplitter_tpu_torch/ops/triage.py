"""Polishing triage: backbone checks, repairs and the map-backed ladder.

Counterpart of `hairsplitter_tpu/ops/triage.py`. The host helpers
(`check_backbone`, `alternative_backbone`, `indel_region`,
`splice_backbone`, the BACKBONE_* codes) are copies of that module's; the
functions that reach the mapper (`iterative_repair`, `_backbone_badness`,
`_orient_like_backbone`, `select_backbone`) go through the port's
`map_reads`.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..constants import GAP, encode_seq, revcomp
from ..core.assembler import greedy_assemble
from ..core.datatypes import Alignment
from ..core.mapping import MapConfig, map_reads
from ..io.cigar import OP_D, OP_I
from ..pipeline.pileup import alignment_cells_full, orient_read
from .consensus import polish_iterative

BACKBONE_GOOD = 0
BACKBONE_BIG_INDELS = 1
BACKBONE_BREAKPOINTS = 2

_BIG = 30  # indel/clip size that counts as structural (tools.cpp:998,1020)
_RECURRENT = 2  # votes at one position must exceed this (tools.cpp:1007,1028)


def check_backbone(
    alns: list[Alignment],
    read_lens: list[int],
    iv_start: int,
    iv_end: int,
    interior_margin: int = 60,
) -> int:
    """Classify the backbone of one interval for one read group.

    Mirrors `check_alignment` (tools.cpp:914-1049): >=30 bp indel runs vote a
    putative breakpoint (insertions position-rounded to 100 as in the
    reference since their placement is arbitrary); a position with more than
    2 votes means the *backbone* carries the indel -> code 1. Reads whose
    alignment stops inside the interval interior with >=30 unaligned bases
    left are clip evidence (the reference sees these as S/H ops because it
    maps clipped reads onto the window); recurrent clips -> code 2. Fewer
    than 2 reads -> code 2. Deviation: clip votes pool on a 50 bp grid and
    only interior clips count, because our alignments run against the full
    contig rather than the window slice.
    """
    if len(alns) < 2:
        return BACKBONE_BREAKPOINTS
    indel_votes: Counter = Counter()
    clip_votes: Counter = Counter()
    lo, hi = iv_start + interior_margin, iv_end - interior_margin
    for a, rlen in zip(alns, read_lens):
        # deviation from the reference's single-run >=30 test: our unit-cost
        # banded DP fragments a big indel into small runs interleaved with
        # spurious matches (no affine gap penalty), so count the NET indel
        # mass per 100 bp of target instead — same signal, robust encoding
        ops = np.asarray(a.cigar_ops)
        lens = np.asarray(a.cigar_lens, dtype=np.int64)
        adv = np.where(ops != OP_I, lens, 0)  # '=','X','M','D' consume target
        pos = a.t_start + np.concatenate([[0], np.cumsum(adv)[:-1]])
        for mask in (ops == OP_D, ops == OP_I):  # separate mass pools, as the
            if not mask.any():  # reference keeps separate del/ins runs
                continue
            bucket = (pos[mask] // 100) * 100
            u, inv = np.unique(bucket, return_inverse=True)
            mass = np.bincount(inv, weights=lens[mask])
            for b_, m_ in zip(u, mass):
                if m_ >= _BIG and iv_start <= b_ <= iv_end:
                    indel_votes[int(b_)] += 1
        # clip breakpoints at either alignment end (contig orientation)
        left_rest = a.q_start if a.strand == 1 else rlen - a.q_end
        right_rest = rlen - a.q_end if a.strand == 1 else a.q_start
        if left_rest >= _BIG and lo < a.t_start < hi:
            clip_votes[(a.t_start // 50) * 50] += 1
        if right_rest >= _BIG and lo < a.t_end < hi:
            clip_votes[(a.t_end // 50) * 50] += 1
    # votes only grow, so evaluating after the loop matches the reference's
    # incremental checks (clip recurrence dominates, tools.cpp:1028-1049)
    if clip_votes and max(clip_votes.values()) > _RECURRENT:
        return BACKBONE_BREAKPOINTS
    if indel_votes and max(indel_votes.values()) > _RECURRENT:
        return BACKBONE_BIG_INDELS
    return BACKBONE_GOOD


def alternative_backbone(
    backbone_codes: np.ndarray,
    iv_start: int,
    cells: list[tuple[np.ndarray, np.ndarray]],
    inss: list[tuple[np.ndarray, np.ndarray]],
) -> str:
    """Patch the backbone from the reads' own alignment walks.

    Mirrors `alternative_backbone` (tools.cpp:1058-1155): the first read to
    cover a backbone position decides its content — match keeps the backbone
    base, deletion removes it, insertions append read bases — and positions
    no read covers are dropped. The effect is a backbone that carries the
    group's structural variants so a realignment can band through them.
    `cells`/`inss` are the per-read (tpos, central-base-code) and insertion
    records from `pileup.alignment_cells_full`, interval-relative via
    `iv_start`.
    """
    L = backbone_codes.size
    replaced = np.zeros(L, dtype=bool)
    content = np.full(L, -1, dtype=np.int16)  # base code, GAP = deleted
    ins_strs: dict[int, str] = {}
    for (tpos, bases), (ins_t, ins_c) in zip(cells, inss):
        rel = np.asarray(tpos) - iv_start
        ok = (rel >= 0) & (rel < L)
        rel, b = rel[ok], np.asarray(bases)[ok]
        fresh = ~replaced[rel]
        newly = rel[fresh]
        replaced[newly] = True
        content[newly] = b[fresh]
        if len(ins_t) and newly.size:
            owned = set(newly.tolist())
            irel = np.asarray(ins_t) - iv_start
            for p, c in zip(irel, np.asarray(ins_c)):
                p = int(p)
                # insertion attaches before position p, owned with it
                if p in owned and 0 <= int(c) < 4:
                    ins_strs[p] = ins_strs.get(p, "") + "ACGT"[int(c)]
    pieces: list[str] = []
    for i in range(L):
        if i in ins_strs:
            pieces.append(ins_strs[i])
        c = int(content[i])
        if replaced[i] and 0 <= c < GAP:
            pieces.append("ACGT"[c])
    return "".join(pieces)


def iterative_repair(
    draft: str, group_reads: list[str], map_cfg=None, max_iter: int = 4, *, device
) -> str:
    """Re-patch the draft until its reads stop showing structural breaks
    (`ops/triage.py:iterative_repair`)."""
    cfg = map_cfg or MapConfig()
    for _ in range(max_iter):
        if len(draft) < 50:
            break
        alns = map_reads({"d": draft}, group_reads, cfg, device=device)
        if len(alns) < 2:
            break
        rlens = [len(group_reads[a.read_idx]) for a in alns]
        if check_backbone(alns, rlens, 0, len(draft) - 1) == BACKBONE_GOOD:
            break
        cells, inss = [], []
        for a in alns:
            oriented = orient_read(encode_seq(group_reads[a.read_idx]), a.strand)
            tpos, tri, it, ic = alignment_cells_full(a, oriented)
            cells.append((tpos, (np.asarray(tri, np.int16) // 25).astype(np.int8)))
            inss.append((it, ic))
        new = alternative_backbone(encode_seq(draft), 0, cells, inss)
        if len(new) < 50 or new == draft:
            break
        draft = new
    return draft


def indel_region(
    alns: list[Alignment], iv_start: int, iv_end: int
) -> tuple[int, int] | None:
    """The target span carrying recurrent structural indel mass: buckets
    where >=2 reads each accumulate >=15 bp of net indel, padded one bucket
    each side. None when no such region exists."""
    votes: Counter = Counter()
    for a in alns:
        pos = a.t_start
        mass: Counter = Counter()
        for op, ln in zip(a.cigar_ops, a.cigar_lens):
            op, ln = int(op), int(ln)
            if op == OP_D:
                mass[(pos // 100) * 100] += ln
                pos += ln
            elif op == OP_I:
                mass[(pos // 100) * 100] += ln
            else:
                pos += ln
        for bucket, m in mass.items():
            if m >= 15 and iv_start <= bucket <= iv_end:
                votes[bucket] += 1
    hot = sorted(b for b, v in votes.items() if v >= 2)
    if not hot:
        return None
    return max(iv_start, hot[0] - 100), min(iv_end, hot[-1] + 200)


def splice_backbone(
    backbone_codes: np.ndarray,
    iv_start: int,
    alns: list[Alignment],
    group_reads: list[str],
    region: tuple[int, int],
) -> str:
    """Replace the backbone across a structural-variant region with the
    best-anchored read's own sequence — the reference's structural-variant
    fallback (`GraphUnzip/repolish.py:295-453`: cut reads between flanking
    anchors and polish the best-anchored read). Unlike the CIGAR patch,
    this carries indels of ANY size, because the read sequence between its
    flank anchors is taken verbatim."""
    from ..constants import decode_seq, encode_seq
    from ..io.cigar import OP_D, OP_I, expand_cigar
    from ..pipeline.pileup import orient_read

    lo, hi = region
    best = None
    best_read = None
    best_key = None
    for a, rd in zip(alns, group_reads):
        if a.t_start > lo - 30 or a.t_end < hi + 30:
            continue  # must anchor both flanks
        err = a.nm / max(1, a.t_end - a.t_start)
        if best is None or err < best_key:
            best, best_read, best_key = a, rd, err
    if best is None:
        return ""
    exp = expand_cigar(best.cigar_ops, best.cigar_lens)
    consumes_q = exp != OP_D
    consumes_t = exp != OP_I
    tpos = best.t_start + np.cumsum(consumes_t) - consumes_t
    oriented = orient_read(encode_seq(best_read), best.strand)
    q0 = best.q_start if best.strand == 1 else len(oriented) - best.q_end
    qpos = q0 + np.cumsum(consumes_q) - consumes_q
    i_lo = int(np.searchsorted(tpos, lo))
    i_hi = int(np.searchsorted(tpos, hi))
    if i_lo >= len(qpos) or i_hi >= len(qpos):
        return ""
    q_lo, q_hi = int(qpos[i_lo]), int(qpos[i_hi])
    if q_hi <= q_lo:
        return ""
    mid = decode_seq(oriented[q_lo:q_hi])
    left = decode_seq(backbone_codes[: max(0, lo - iv_start)])
    right = decode_seq(backbone_codes[max(0, hi - iv_start) :])
    return left + mid + right



def _backbone_badness(draft: str, group_reads: list[str], map_cfg=None, *, device) -> float:
    """Edit distance plus unaligned read bases, per read base, of the
    group's reads against a candidate backbone (`ops/triage.py:
    _backbone_badness`). Lower = better fit."""
    if len(draft) < 50:
        return float("inf")
    alns = map_reads({"d": draft}, group_reads, map_cfg or MapConfig(), device=device)
    total = sum(len(r) for r in group_reads)
    aligned = sum(a.q_end - a.q_start for a in alns)
    nm = sum(a.nm for a in alns)
    return (nm + (total - aligned)) / max(1, total)


def _orient_like_backbone(
    draft: str, group_reads: list[str], strands: list[int], map_cfg=None, *, device
) -> str:
    """Flip the draft if the group's reads align to it mostly on the other
    strand than on the original backbone (`ops/triage.py:
    _orient_like_backbone`)."""
    alns = map_reads({"d": draft}, group_reads, map_cfg or MapConfig(), device=device)
    votes = sum(1 if a.strand == strands[a.read_idx] else -1 for a in alns)
    return draft if votes >= 0 else revcomp(draft)


def select_backbone(
    code: int,
    backbone_codes: np.ndarray,
    iv_start: int,
    iv_end: int,
    cells,
    inss,
    alns: list[Alignment],
    group_reads: list[str],
    strands: list[int],
    baseline: str,
    base_caller=None,
    *,
    device,
) -> str:
    """The triage candidate tournament (`ops/triage.py:select_backbone`):
    splice, CIGAR patch and assembled unitigs, each polished and scored by
    how well the group's reads fit, against the plain consensus `baseline`."""
    candidates: list[str] = []
    if code == BACKBONE_BIG_INDELS:
        region = indel_region(alns, iv_start, iv_end)
        if region is not None:
            candidates.append(
                splice_backbone(backbone_codes, iv_start, alns, group_reads, region)
            )
        candidates.append(
            iterative_repair(
                alternative_backbone(backbone_codes, iv_start, cells, inss),
                group_reads,
                device=device,
            )
        )
    contigs = greedy_assemble(
        {f"r{k}": s for k, s in enumerate(group_reads)},
        min_overlap=min(300, max(50, min(len(s) for s in group_reads) // 4)),
        min_len=min(500, backbone_codes.size // 2),
    )
    candidates.extend(sorted(contigs, key=len, reverse=True)[:3])
    candidates = [c for c in candidates if len(c) >= 50]
    scored: list[tuple[float, str]] = [
        (_backbone_badness(baseline, group_reads, device=device), baseline)
    ]
    for c in candidates:
        p = polish_iterative(
            c, group_reads, rounds=2, base_caller=base_caller, min_len=50, device=device
        )
        scored.append((_backbone_badness(p, group_reads, device=device), p))
    best_score, best = min(scored, key=lambda t: t[0])
    if best is not baseline:
        best = _orient_like_backbone(best, group_reads, strands, device=device)
    return best

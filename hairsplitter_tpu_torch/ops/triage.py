"""The map-backed half of the polishing triage ladder.

Port of the functions of `hairsplitter_tpu/ops/triage.py` that reach the
mapper (`iterative_repair`, `_backbone_badness`, `_orient_like_backbone`,
`select_backbone`), routed to the port's `map_reads`. The pure host helpers
(`check_backbone`, `alternative_backbone`, `indel_region`,
`splice_backbone`, the BACKBONE_* codes) are reused from the JAX package's
module, which loads without JAX.
"""

from __future__ import annotations

import numpy as np

from hairsplitter_tpu.constants import encode_seq, revcomp
from hairsplitter_tpu.core.assembler import greedy_assemble
from hairsplitter_tpu.core.datatypes import Alignment
from hairsplitter_tpu.ops.triage import (
    BACKBONE_BIG_INDELS,
    BACKBONE_GOOD,
    alternative_backbone,
    check_backbone,
    indel_region,
    splice_backbone,
)
from hairsplitter_tpu.pipeline.pileup import alignment_cells_full, orient_read

from ..core.mapping import MapConfig, map_reads
from .consensus import polish_iterative


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
        p = polish_iterative(c, group_reads, rounds=2, min_len=50, device=device)
        scored.append((_backbone_badness(p, group_reads, device=device), p))
    best_score, best = min(scored, key=lambda t: t[0])
    if best is not baseline:
        best = _orient_like_backbone(best, group_reads, strands, device=device)
    return best

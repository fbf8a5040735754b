"""Host-side pileup tensorization: CIGAR walks → dense window blocks.

Mirrors the reference's `generate_msa` (`src/call_variants.cpp:50-437`) with
the same cell semantics — each covered (contig) position stores the trimer
(base[i-2], base[i-1], base[i]) of the read in contig orientation; deletions
record '-' as the current base and shift the context; insertions are not
recorded and do not touch the context (the reference's insertion handling is
fully commented out, `src/call_variants.cpp:236-330`) — but produces dense
[reads, positions] int8 blocks of fixed window size, ready for the device
column-stat kernels.

Copy of `hairsplitter_tpu/pipeline/pileup.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import GAP, TRIMER_ABSENT, revcomp_codes
from ..core.datatypes import Alignment
from ..io.cigar import expand_cigar

WINDOW = 8192


def alignment_cells(aln: Alignment, oriented_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(contig positions, trimer codes) of all pileup cells of one alignment.

    oriented_codes: the read's base codes in contig orientation."""
    tpos, tri, _, _ = alignment_cells_full(aln, oriented_codes)
    return tpos, tri


def alignment_cells_full(
    aln: Alignment, oriented_codes: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """As :func:`alignment_cells`, plus insertion records.

    Returns (tpos, trimer, ins_tpos, ins_codes): insertions are read bases
    absent from the contig, attached *before* contig position ins_tpos
    (one entry per inserted base, in read order)."""
    exp = expand_cigar(aln.cigar_ops, aln.cigar_lens)
    consumes_q = exp != 3  # '=','X','I'
    consumes_t = exp != 2  # '=','X','D'
    qpos = aln.q_start + np.cumsum(consumes_q) - consumes_q
    tpos = aln.t_start + np.cumsum(consumes_t) - consumes_t
    if aln.strand == 0:
        # q_start/q_end are forward-read coords; oriented coords run from
        # len - q_end. Recompute qpos in oriented space.
        qlen = len(oriented_codes)
        q0 = qlen - aln.q_end
        qpos = q0 + np.cumsum(consumes_q) - consumes_q

    recorded = exp != 2  # all but insertions produce a cell
    cur = np.where(exp == 3, GAP, oriented_codes[np.clip(qpos, 0, len(oriented_codes) - 1)])
    cur_rec = cur[recorded].astype(np.int16)
    # context = previous two recorded symbols of this read
    prev1 = np.concatenate([[0], cur_rec[:-1]])
    prev2 = np.concatenate([[0, 1], cur_rec[:-2]])
    tri = (cur_rec * 25 + prev1 * 5 + prev2).astype(np.int8)
    ins = exp == 2
    ins_tpos = tpos[ins]
    ins_codes = oriented_codes[qpos[ins]]
    return tpos[recorded], tri, ins_tpos, ins_codes


@dataclass
class WindowBlock:
    contig: str
    start: int
    length: int  # actual positions covered (<= window size)
    rows: np.ndarray  # alignment indices (into the contig's alignment list)
    tri: np.ndarray  # int8 [R, W] trimer codes, TRIMER_ABSENT where absent


def build_window_blocks(
    contig_len: int,
    alignments: list[Alignment],
    oriented_codes: list[np.ndarray],
    window: int = WINDOW,
) -> list[WindowBlock]:
    """Distribute all alignment cells of one contig into dense window blocks."""
    cells = [alignment_cells(a, oc) for a, oc in zip(alignments, oriented_codes)]
    n_windows = max(1, -(-contig_len // window))
    blocks = []
    for wi in range(n_windows):
        ws, we = wi * window, min((wi + 1) * window, contig_len)
        rows = [
            i
            for i, a in enumerate(alignments)
            if a.t_start < we and a.t_end > ws
        ]
        tri = np.full((max(1, len(rows)), window), TRIMER_ABSENT, dtype=np.int8)
        for r, i in enumerate(rows):
            tpos, tcodes = cells[i]
            lo = np.searchsorted(tpos, ws)
            hi = np.searchsorted(tpos, we)
            tri[r, tpos[lo:hi] - ws] = tcodes[lo:hi]
        blocks.append(
            WindowBlock(
                contig=alignments[0].contig if alignments else "",
                start=ws,
                length=we - ws,
                rows=np.asarray(rows, dtype=np.int64),
                tri=tri,
            )
        )
    return blocks


def orient_read(seq_codes: np.ndarray, strand: int) -> np.ndarray:
    return seq_codes if strand == 1 else revcomp_codes(seq_codes)

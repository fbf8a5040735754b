"""Greedy overlap assembler for unaligned reads.

Replaces the reference's de-novo fallbacks: `basic_assembly` (all-vs-all
minimap2 PAF + greedy merge, `src/tools.cpp:1167`) and the raven shell-out for
reads that align nowhere on the assembly (`HS_GenomeTailor/scaffold.cpp:154,
2160-2166`). Overlaps come from the same minimizer chains as read mapping;
unitigs grow greedily from the longest unused read, rightwards, then the
contig is reverse-complemented and extended rightwards again (= leftwards).

Intended for modest read sets (the unaligned leftovers), not whole-genome
assembly.

Copy of `hairsplitter_tpu/core/assembler.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from ..constants import encode_seq, revcomp
from .seeding import MinimizerIndex, find_chains


def _best_right_extension(index, seqs, used, contig, min_overlap, k=15, min_anchors=6):
    """Best unused read overlapping the contig's right end and extending it.

    Returns (name, oriented read, start offset of the read on the contig)."""
    codes = encode_seq(contig)
    chains = find_chains(index, codes, min_anchors=min_anchors, max_overlap_frac=1.1)
    best = None
    for ch in chains:
        name = index.contig_names[ch.contig_id]
        if used.get(name):
            continue
        other = seqs[name]
        q0, q1 = int(ch.q_anchors[0]), int(ch.q_anchors[-1])
        t0, t1 = int(ch.t_anchors[0]), int(ch.t_anchors[-1])
        oriented = other if ch.strand == 1 else revcomp(other)
        if ch.strand == 0:
            t0, t1 = len(other) - k - t1, len(other) - k - t0
        offset = q0 - t0  # read start position in contig coordinates
        if offset < 0:
            continue  # read sticks out on the left: not a right extension
        extension = offset + len(oriented) - len(contig)
        overlap = len(contig) - offset
        if extension <= 0 or overlap < min_overlap:
            continue
        if q1 - q0 < 0.5 * overlap:  # anchors must actually cover the overlap
            continue
        if best is None or extension > best[0]:
            best = (extension, name, oriented, offset)
    return best


def greedy_assemble(
    read_seqs: dict[str, str], min_overlap: int = 300, min_len: int = 1000
) -> list[str]:
    """Assemble reads into unitigs greedily. Returns contig sequences."""
    seqs = dict(read_seqs)
    if not seqs:
        return []
    index = MinimizerIndex.build({n: encode_seq(s) for n, s in seqs.items()})
    used: dict[str, bool] = {n: False for n in seqs}
    contigs: list[str] = []
    for seed in sorted(seqs, key=lambda n: -len(seqs[n])):
        if used[seed]:
            continue
        used[seed] = True
        contig = seqs[seed]
        for _ in range(2):  # extend right, then (reverse-complemented) left
            while True:
                best = _best_right_extension(index, seqs, used, contig, min_overlap)
                if best is None:
                    break
                _, name, oriented, offset = best
                used[name] = True
                contig = contig[:offset] + oriented
            contig = revcomp(contig)
        if len(contig) >= min_len:
            contigs.append(contig)
    return contigs

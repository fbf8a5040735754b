"""SAM interop: parse external alignments / write our alignments as SAM.

Mirrors the reference's `parse_SAM` (`src/input_output.cpp:274-536`): drops
unmapped (flag&4) and secondary (flag&256) records, keeps supplementary ones,
rejects alignments clipped >20% unless supplementary, and reads NM tags.
Lets users bring minimap2 SAM files instead of the built-in mapper, exactly
like the reference pipeline consumes `reads_on_asm.sam`.

Copy of `hairsplitter_tpu/io/sam.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

import numpy as np

from ..core.datatypes import Alignment
from .cigar import (
    OPS,
    cigar_query_len,
    cigar_target_len,
    cigar_to_string,
    parse_cigar,
)


def parse_sam(path: str, read_name_to_idx: dict[str, int], max_clip_frac: float = 0.2):
    """Yield Alignments from a SAM file."""
    out: list[Alignment] = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 11:
                continue
            qname, flag_s, rname, pos_s, _, cigar = parts[:6]
            flag = int(flag_s)
            if flag & 4 or rname == "*" or cigar == "*":
                continue
            if flag & 256:  # secondary
                continue
            if qname not in read_name_to_idx:
                continue
            ops, lens = parse_cigar(cigar)
            strand = 0 if flag & 16 else 1
            supplementary = bool(flag & 2048)
            # clip accounting (H/S at the ends)
            clip_start = int(lens[0]) if ops.size and OPS[ops[0]] in "SH" else 0
            clip_end = int(lens[-1]) if ops.size and OPS[ops[-1]] in "SH" else 0
            qlen_aligned = cigar_query_len(ops, lens)
            total_q = qlen_aligned  # S counts in query len; H does not
            read_len = total_q + sum(
                int(l) for o, l in zip(ops, lens) if OPS[o] == "H"
            )
            if (clip_start + clip_end) > max_clip_frac * max(1, read_len) and not supplementary:
                continue
            # strip terminal clips
            keep = np.array([OPS[o] not in "SH" for o in ops])
            ops_k, lens_k = ops[keep], lens[keep]
            t_start = int(pos_s) - 1
            t_end = t_start + cigar_target_len(ops_k, lens_k)
            q_start_oriented = clip_start
            q_span = cigar_query_len(ops_k, lens_k)
            if strand == 1:
                q_start = q_start_oriented
                q_end = q_start + q_span
            else:
                q_end = read_len - q_start_oriented
                q_start = q_end - q_span
            nm = 0
            for tag in parts[11:]:
                if tag.startswith("NM:i:"):
                    nm = int(tag[5:])
            out.append(
                Alignment(
                    read_idx=read_name_to_idx[qname],
                    contig=rname,
                    strand=strand,
                    q_start=q_start,
                    q_end=q_end,
                    t_start=t_start,
                    t_end=t_end,
                    cigar_ops=ops_k,
                    cigar_lens=lens_k,
                    nm=nm,
                )
            )
    return out


def write_sam(
    path: str,
    alignments: list[Alignment],
    contig_lengths: dict[str, int],
    read_names: dict[int, str],
    read_seqs: dict[int, str] | None = None,
) -> None:
    """Write alignments as SAM (sequences omitted unless provided — the
    reference also strips SEQ/QUAL with awk, `hairsplitter.py:629`)."""
    from ..constants import revcomp

    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for name, L in contig_lengths.items():
            f.write(f"@SQ\tSN:{name}\tLN:{L}\n")
        for a in alignments:
            flag = 0 if a.strand == 1 else 16
            name = read_names.get(a.read_idx, f"read_{a.read_idx}")
            cig = cigar_to_string(a.cigar_ops, a.cigar_lens)
            seq = "*"
            clip_left = clip_right = 0
            if read_seqs is not None:
                s = read_seqs[a.read_idx]
                oriented = s if a.strand == 1 else revcomp(s)
                # soft clips in oriented-read coordinates so q_start/q_end
                # roundtrip through parse_sam
                if a.strand == 1:
                    clip_left, clip_right = a.q_start, len(s) - a.q_end
                else:
                    clip_left, clip_right = len(s) - a.q_end, a.q_start
                seq = oriented
            pre = f"{clip_left}S" if clip_left else ""
            post = f"{clip_right}S" if clip_right else ""
            f.write(
                f"{name}\t{flag}\t{a.contig}\t{a.t_start + 1}\t60\t{pre}{cig}{post}\t*\t0\t0\t{seq}\t*"
                f"\tNM:i:{a.nm}\tLN:i:{contig_lengths.get(a.contig, 0)}\n"
            )

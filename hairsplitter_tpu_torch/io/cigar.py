"""CIGAR utilities (run-length numpy representation).

Replaces the reference's string CIGAR helpers
(`src/tools.cpp:27-80` convert_cigar/convert_cigar2) with vectorized numpy.

Ops use the SAM/minimap2 extended alphabet: '=' match, 'X' mismatch,
'I' insertion (in read, absent from contig), 'D' deletion (in contig, absent
from read), 'M' match-or-mismatch, 'S'/'H' clips.

Copy of `hairsplitter_tpu/io/cigar.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

import re

import numpy as np

OPS = "=XIDMSH"
OP_EQ, OP_X, OP_I, OP_D, OP_M, OP_S, OP_H = range(7)
_OP_TO_IDX = {c: i for i, c in enumerate(OPS)}

# which ops consume query (read) / target (contig) bases
CONSUMES_QUERY = np.array([1, 1, 1, 0, 1, 1, 0], dtype=bool)
CONSUMES_TARGET = np.array([1, 1, 0, 1, 1, 0, 0], dtype=bool)

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cig: str) -> tuple[np.ndarray, np.ndarray]:
    """CIGAR string -> (ops int8 array, lengths int32 array)."""
    ops, lens = [], []
    for m in _CIG_RE.finditer(cig):
        ops.append(_OP_TO_IDX[m.group(2)])
        lens.append(int(m.group(1)))
    return np.asarray(ops, dtype=np.int8), np.asarray(lens, dtype=np.int32)


_LEN_STRS = [str(i) for i in range(512)]  # SAM writing hot path: cached run lengths


def cigar_to_string(ops: np.ndarray, lens: np.ndarray) -> str:
    return "".join(
        [
            (_LEN_STRS[l] if l < 512 else str(l)) + OPS[o]
            for o, l in zip(np.asarray(ops).tolist(), np.asarray(lens).tolist())
            if l > 0
        ]
    )


def expand_cigar(ops: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Run-length -> one op code per column."""
    return np.repeat(ops, lens)


def compress_cigar(expanded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One op per column -> run-length (ops, lens)."""
    expanded = np.asarray(expanded, dtype=np.int8)
    if expanded.size == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.int32)
    change = np.nonzero(np.diff(expanded))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [expanded.size]])
    return expanded[starts], (ends - starts).astype(np.int32)


def cigar_query_len(ops: np.ndarray, lens: np.ndarray) -> int:
    return int(lens[CONSUMES_QUERY[ops]].sum())


def cigar_target_len(ops: np.ndarray, lens: np.ndarray) -> int:
    return int(lens[CONSUMES_TARGET[ops]].sum())


def merge_cigars(parts: list[tuple[np.ndarray, np.ndarray]]) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate several (ops, lens) runs, fusing equal ops at the seams."""
    parts = [p for p in parts if p[0].size]
    if not parts:
        return np.zeros(0, np.int8), np.zeros(0, np.int32)
    ops = np.concatenate([p[0] for p in parts])
    lens = np.concatenate([p[1] for p in parts])
    return compress_cigar_runs(ops, lens)


def compress_cigar_runs(ops: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fuse adjacent runs with equal op, drop zero-length runs."""
    keep = lens > 0
    ops, lens = ops[keep], lens[keep]
    if ops.size == 0:
        return ops, lens
    boundary = np.concatenate([[True], np.diff(ops) != 0])
    group = np.cumsum(boundary) - 1
    out_ops = ops[boundary]
    out_lens = np.bincount(group, weights=lens).astype(np.int32)
    return out_ops, out_lens

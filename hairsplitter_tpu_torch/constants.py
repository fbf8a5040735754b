"""Base / allele encodings shared by host and device code.

The reference pipeline encodes each pileup cell as a printable byte packing a
3-mer of read context ("ACGT-" alphabet; reference `src/call_variants.cpp:238`).
We keep the same *semantics* — two pileup cells carry the same allele iff the
(base[i-2], base[i-1], base[i]) triple of the read at that contig position is
identical — but use a clean integer packing that decodes the central base
exactly.

Codes:
    bases      A=0 C=1 G=2 T=3 GAP=4 (deletion), PAD=5 (no coverage / N)
    trimer     t = cur*25 + prev1*5 + prev2   in [0, 125)
    absent     TRIMER_ABSENT = 127 (read does not cover the position)

Copy of `hairsplitter_tpu/constants.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, GAP = 0, 1, 2, 3, 4
PAD = 5  # no base / unknown
N_BASES = 5  # ACGT-
N_TRIMERS = 125
TRIMER_ABSENT = 127

_BASE_CHARS = "ACGT-"

# ASCII -> code lookup (everything unknown maps to PAD).
BASE_LUT = np.full(256, PAD, dtype=np.int8)
for _i, _ch in enumerate(_BASE_CHARS):
    BASE_LUT[ord(_ch)] = _i
    BASE_LUT[ord(_ch.lower())] = _i

# complement in code space (gap/pad map to themselves)
COMP = np.array([T, G, C, A, GAP, PAD], dtype=np.int8)

CODE_TO_CHAR = np.frombuffer(b"ACGT-N", dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 code array (A=0..T=3, anything else PAD)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    """int8 code array -> ASCII string (gaps '-' and PAD 'N' included)."""
    return CODE_TO_CHAR[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return COMP[codes][::-1]


def revcomp(seq: str) -> str:
    return decode_seq(revcomp_codes(encode_seq(seq)))


def trimer_pack(cur: np.ndarray, prev1: np.ndarray, prev2: np.ndarray) -> np.ndarray:
    """Pack (current, previous, previous-previous) read bases into one code."""
    return (cur.astype(np.int16) * 25 + prev1.astype(np.int16) * 5 + prev2.astype(np.int16)).astype(np.int8)


def trimer_central(code: np.ndarray) -> np.ndarray:
    """Central (current) base of a trimer code."""
    return (np.asarray(code, dtype=np.int16) // 25).astype(np.int8)

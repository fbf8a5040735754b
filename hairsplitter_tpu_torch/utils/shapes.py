"""Shape bucketing for device calls.

Copy of `hairsplitter_tpu/utils/shapes.py:pow2_bucket`, the one function of
that module the port calls: ragged operands (reads per window, SNPs per
contig) are padded up to a power-of-two bucket so that byte-identical
artifacts come out of the same padded shapes as the JAX package's.
"""

from __future__ import annotations


def pow2_bucket(n: int, minimum: int = 32) -> int:
    """Smallest power of two >= n (and >= minimum)."""
    n = max(int(n), 1)
    return max(minimum, 1 << (n - 1).bit_length())

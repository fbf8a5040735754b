"""Shape bucketing for device calls.

Copies of `hairsplitter_tpu/utils/shapes.py:pow2_bucket` and `pad_axis`, the
two functions of that module the port calls: ragged operands (reads per
window, SNPs per contig, positions per polished interval) are padded up to a
power-of-two bucket so that the same results come out of the same padded
shapes as the JAX package's.
"""

from __future__ import annotations

import numpy as np


def pow2_bucket(n: int, minimum: int = 32) -> int:
    """Smallest power of two >= n (and >= minimum)."""
    n = max(int(n), 1)
    return max(minimum, 1 << (n - 1).bit_length())


def pad_axis(arr: np.ndarray, axis: int, size: int, fill) -> np.ndarray:
    """Pad `arr` with `fill` along `axis` up to `size` (no-op if already)."""
    if arr.shape[axis] >= size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - arr.shape[axis])
    return np.pad(arr, widths, constant_values=fill)

"""The least time one H100 could take for a fused K1 call: a frozen copy of
`chip_smoke.py`'s bound arithmetic, so that a change to the program cannot
change the yardstick. The bound counts what the call's function needs
(its inputs read once, its outputs written once, and the integer
operations of the rows it steps and walks), not what a design spends.
"""

from __future__ import annotations

import numpy as np

# peaks of one H100 SXM for the kernels' bounds: device memory rate, and the
# int32 rate outside the tensor cores (132 SMs x 64 INT32 lanes x 1.98 GHz,
# the card's maximum SM clock as nvidia-smi reports it)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations the kernels' functions need (not what a design spends),
# counted as three-input logic ops, shifts, adds and selects: one Myers row
# over the 4-word band with the backpointer classes and the window slide
# (150), the same plus the readout's running quantities (160); one step of a
# traceback walk, which in either kernel finds the highest non-LEFT bit at or
# below b in a 128-bit row, takes its UP bit and forms the token (mask, clz,
# token: 30); one int32 DP cell (code compare, two adds, two minima, two
# selects, and the run code in the check mode or the two class compares in the
# fused mode: 8).
OPS_MYERS_ROW = 150
OPS_FUSED_ROW = 160
OPS_WALK_ROW = 30
OPS_DP_CELL = 8


def bound_s(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """Least time in seconds the card could take: the larger of bytes over
    the memory rate and integer operations over the int32 rate, and which."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = n_ops / INT32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def fused_k1_work(q_lens: np.ndarray, B: int, T: int, fused: np.ndarray) -> tuple[int, int]:
    """Bytes and operations of one fused K1 call of N jobs, from its
    inputs and its output buffer uint8 [N, 16 + B] (int32 cost, clip,
    start_i, start_b, then one token per row): q [N, B] and t [N, T] int8,
    q_lens, t_lens and modes int32 read once, the buffer written once; every
    job steps min(q_len, B) forward rows and walks start_i rows."""
    n = int(q_lens.shape[0])
    rows_fwd = int(np.clip(q_lens, 0, B).sum())
    rows_walk = int(np.ascontiguousarray(fused[:, :16]).view(np.int32)[:, 2].astype(np.int64).sum()) if n else 0
    n_bytes = n * (B + T + 12 + 16 + B)
    n_ops = rows_fwd * OPS_FUSED_ROW + rows_walk * OPS_WALK_ROW
    return n_bytes, n_ops

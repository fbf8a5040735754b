"""The fused mapping call: DP + end-cell readout + row-lockstep traceback in
one device pass, decoded on host. On a GPU the whole call is one CUDA kernel:
`csrc/myers_fused.cu` with the Myers DP (the default), `csrc/banded_fused.cu`
with the int32 banded DP. Their plain versions, `myers_fused_plain` and
`banded_fused_plain`, are the same functions composed from torch ops.

Counterpart of `hairsplitter_tpu/ops/align_device.py`: `readout_device`
(:36-65), `traceback_rows_device`, `encode_runs` and `traceback_scan`
(:116-188), the three kernel branches of `_align_traceback_rows_impl`
(:286-320) and a copy of the host decoder `expand_rows_host` (:323-379). A
chunk alignment ships home as 16 + B bytes: int32 cost, clip, start_i and
start_b, then one token per query row, `d | up << 7`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native as _native

from .align import BP_LEFT, BP_UP, INF, TB_D, TB_EQ, TB_I, TB_X, BandSpec
from . import align_dp_cuda as _dp  # called through the module, so that a test can wrap its functions
from .align_myers_cuda import myers_fused_cuda, myers_rows_torch, myers_word_readout, traceback_scan_words


def readout_device(res: dict, q_lens, t_lens, modes, spec: BandSpec):
    """End-cell choice (`align_device.py:readout_device`): the global corner,
    the best cell of the extension row, or the target-exhausted column;
    first-index argmin. Returns int64 (cost, start_i, start_b, clip)."""
    row_at_q = res["row_at_q"].to(torch.int64)  # int32 from the DP kernels
    colmin_val = res["colmin_val"].to(torch.int64)
    colmin_i = res["colmin_i"].to(torch.int64)
    N, W = row_at_q.shape
    dl = spec.dl
    inf = int(INF)
    q_lens = q_lens.to(torch.int64)
    t_lens = t_lens.to(torch.int64)
    bar = torch.arange(W, dtype=torch.int64, device=row_at_q.device)[None, :]
    j = q_lens[:, None] + bar - dl
    b_corner = t_lens - q_lens + dl
    corner = row_at_q.gather(1, b_corner.clamp(0, W - 1)[:, None])[:, 0]
    corner = torch.where((b_corner >= 0) & (b_corner < W), corner, inf)
    masked = torch.where((j >= 0) & (j <= t_lens[:, None]), row_at_q, inf)
    b_row = torch.argmin(masked, dim=1)
    rowbest = masked.gather(1, b_row[:, None])[:, 0]

    is_ext = modes.to(torch.int64) == 1
    use_col = is_ext & (colmin_val < rowbest)
    cost = torch.where(is_ext, torch.minimum(rowbest, colmin_val), corner)
    start_i = torch.where(use_col, colmin_i, q_lens)
    start_b = torch.where(use_col, t_lens - colmin_i + dl, torch.where(is_ext, b_row, b_corner))
    clip = torch.where(use_col, q_lens - colmin_i, 0)
    # unreachable end cell: empty walk
    dead = cost >= inf
    start_i = torch.where(dead, 0, start_i)
    start_b = torch.where(dead, dl, start_b)
    clip = torch.where(dead, 0, clip)
    return cost, start_i, start_b, clip


def traceback_rows_device(bp, start_i, start_b, spec: BandSpec) -> torch.Tensor:
    """Row-lockstep traceback over a backpointer plane (`align_device.py:
    traceback_rows_device`): run-encode the plane, then walk it one query row
    per step. Returns uint8 tokens [N, B], `d | (up << 7)` per row."""
    return traceback_scan(encode_runs(bp), start_i, start_b)


def encode_runs(bp: torch.Tensor) -> torch.Tensor:
    """int16 run encoding of backpointers [..., W] (`align_device.py:
    encode_runs`): (position+1, is_up) of every non-LEFT cell, then a prefix
    max along the band finds, for every cell, the non-LEFT cell its LEFT-run
    ends at. log2(W) doubling passes, one temporary each."""
    W = bp.shape[-1]
    lane = torch.arange(W, dtype=torch.int16, device=bp.device)
    enc = torch.where(bp != BP_LEFT, ((lane + 1) << 1) | (bp == BP_UP).to(torch.int16), 0).to(torch.int16)
    k = 1
    while k < W:
        enc[..., k:] = torch.maximum(enc[..., k:], enc[..., : W - k])  # right side read first
        k *= 2
    return enc


def traceback_scan(enc: torch.Tensor, start_i, start_b) -> torch.Tensor:
    """The row-lockstep walk over a run-encoded plane [N, B, W]
    (`align_device.py:traceback_scan`): B row steps, each reading one cell
    per alignment (0 outside the band, as the JAX masked sum gives).
    Returns uint8 tokens [N, B]."""
    N, B, W = enc.shape
    si = start_i.to(torch.int64)
    b = start_b.to(torch.int64)
    toks = torch.zeros((B, N), dtype=torch.uint8, device=enc.device)
    for r in range(B, 0, -1):
        active = r <= si
        v = enc[:, r - 1, :].gather(1, b.clamp(0, W - 1)[:, None])[:, 0].to(torch.int64)
        v = torch.where((b >= 0) & (b < W), v, 0)
        nl = ((v >> 1) - 1).clamp(min=0)  # non-LEFT cell the run ends at
        up = v & 1
        d = (b - nl).clamp(min=0)
        toks[r - 1] = torch.where(active, d | (up << 7), 0).to(torch.uint8)
        b = torch.where(active, nl + up, b)
    return toks.t()


def _fused_buffer(cost, clip, start_i, start_b, toks) -> torch.Tensor:
    """uint8 [N, 16 + B]: int32 cost, clip, start_i, start_b, then the tokens."""
    meta = torch.stack([cost, clip, start_i, start_b], dim=1).to(torch.int32).contiguous()
    return torch.cat([meta.view(torch.uint8).reshape(meta.shape[0], 16), toks], dim=1)


def myers_fused_plain(q, q_lens, t, t_lens, modes, spec: BandSpec = BandSpec()) -> torch.Tensor:
    """Plain PyTorch version of the fused Myers kernel, on any device:
    `myers_rows_torch` -> `myers_word_readout` -> `readout_device` ->
    `traceback_scan_words`. Nothing of size [N, B, W] is materialised.

    Exactness (kept from `align_myers_pallas.py:myers_traceback_device`): the
    (nonleft, isup) bits equal the int32 kernel's op classification on every
    cell a traceback can visit — visited cells satisfy 1 <= i <= start_i <=
    qlen and the prefix-max a visited cell reads only covers lanes with
    0 <= j' <= j <= tlen (j is non-increasing along the walk), where the
    pure-bitvector recurrence is exact; the j == 0 column is forced UP
    (provably its classification in the masked DP), so the j < 0 sentinel
    region can never capture a run. Matches edlib's traceback over its own
    P/M blocks (`src/edlib/src/edlib.cpp`, obtainAlignmentTraceback) rather
    than re-deriving cell scores."""
    P, M, nl, up = myers_rows_torch(q, t, spec, emit_tb=True)
    res = myers_word_readout(P, M, q_lens, t_lens, spec)
    cost, start_i, start_b, clip = readout_device(res, q_lens, t_lens, modes, spec)
    # the walk takes row-major [B, N, 4] streams: undo the public layout's view
    toks = traceback_scan_words(nl.permute(1, 0, 2), up.permute(1, 0, 2), start_i, start_b)
    return _fused_buffer(cost, clip, start_i, start_b, toks)


def banded_fused_plain(q, q_lens, t, t_lens, modes, spec: BandSpec = BandSpec()) -> torch.Tensor:
    """Plain PyTorch version of the fused int32 banded-DP kernel
    (`csrc/banded_fused.cu`), on any device: `banded_align_batch_torch` with
    the run encoding -> `readout_device` -> `traceback_scan`. It materialises
    the int16 [N, B, W] plane, which the kernel never does."""
    if spec.band != _dp.LANES:
        raise ValueError(f"the int32 banded-DP kernel is specialised to band {_dp.LANES}, got {spec.band}")
    res = _dp.banded_align_batch_torch(q, q_lens, t, t_lens, spec, emit_enc=True)
    cost, start_i, start_b, clip = readout_device(res, q_lens, t_lens, modes, spec)
    toks = traceback_scan(res["enc"], start_i, start_b)
    return _fused_buffer(cost, clip, start_i, start_b, toks)


_FUSED = {  # kernel -> (CUDA kernel's wrapper, plain version)
    "myers": (myers_fused_cuda, myers_fused_plain),
    "pallas": (_dp.banded_fused_cuda, banded_fused_plain),
}


def align_traceback_rows(q, q_lens, t, t_lens, modes, spec: BandSpec, kernel: str = "myers") -> torch.Tensor:
    """One fused pass per batch on q's device: DP, readout and row-lockstep
    traceback. kernel: "myers" (K1, the Myers bit-vector DP), "pallas" (K2,
    the int32 banded DP) or "jnp" (the plain DP in torch ops, any band). With
    the first two, CUDA tensors launch the one fused CUDA kernel and nothing
    else, and CPU tensors take its plain version. Returns uint8 [N, 16 + B],
    byte-identical to the JAX package's `align_traceback_rows` with the same
    kernel; decode with `expand_rows_host`."""
    if kernel in _FUSED:
        on_cuda, plain = _FUSED[kernel]
        # a CUDA tensor launches the kernel or raises; only a CPU tensor
        # takes the plain composition
        if q.device.type == "cuda":
            return on_cuda(q, q_lens, t, t_lens, modes, spec)
        if q.device.type == "cpu":
            return plain(q, q_lens, t, t_lens, modes, spec)
        raise ValueError(f"unsupported device {q.device}")
    if kernel != "jnp":
        raise ValueError(f"kernel must be 'myers', 'pallas' or 'jnp', got {kernel!r}")
    res = _dp.banded_align_batch_torch(q, q_lens, t, t_lens, spec)
    cost, start_i, start_b, clip = readout_device(res, q_lens, t_lens, modes, spec)
    toks = traceback_rows_device(res["bp"], start_i, start_b, spec)
    return _fused_buffer(cost, clip, start_i, start_b, toks)


def expand_rows_host(fused, qb, tb, spec: BandSpec):
    """Host decode of `align_traceback_rows` (copy of the JAX package's
    `ops/align_device.py:expand_rows_host`): rebuild the forward op streams
    from the per-row (d, up) tokens; the native twin when available, else
    vectorised numpy. Returns (ops_list, cost, clip)."""
    fused = np.asarray(fused)
    meta = fused[:, :16].copy().view(np.int32)  # cost, clip, start_i, start_b
    toks = fused[:, 16:]
    N, B = toks.shape

    nat = _native.expand_rows(toks, meta, qb, tb, spec.dl)
    if nat is not None:
        flat, offsets = nat
        ops_list = [flat[offsets[i] : offsets[i + 1]] for i in range(N)]
        return ops_list, meta[:, 0], meta[:, 1]
    dl = spec.dl
    start_i = meta[:, 2].astype(np.int64)
    start_b = meta[:, 3].astype(np.int64)
    d = (toks & 0x7F).astype(np.int64)
    up = (toks >> 7).astype(np.int64)
    rows = np.arange(1, B + 1, dtype=np.int64)[None, :]
    active = rows <= start_i[:, None]
    d *= active
    up *= active
    # band position on arrival at row r: b_{r-1} = b_r - d_r + up_r
    move = d - up
    cums = np.cumsum(move, axis=1)
    b_r = start_b[:, None] - (cums[:, -1:] - cums)
    nl = b_r - d
    b0 = np.where(start_i > 0, nl[:, 0] + up[:, 0], start_b)
    jf = np.maximum(b0 - dl, 0)  # leading deletions once the query is spent
    jcol = rows + nl - dl
    tj = np.take_along_axis(tb, np.clip(jcol - 1, 0, tb.shape[1] - 1).astype(np.int64), axis=1)
    same = qb[:, :B] == tj
    opv = np.where(up == 1, TB_I, np.where(same, TB_EQ, TB_X)).astype(np.int8)
    # interleave (counts, values): [D x jf, op_1, D x d_1, op_2, D x d_2, ...]
    V = np.empty((N, 2 * B + 1), np.int8)
    C = np.empty((N, 2 * B + 1), np.int64)
    V[:, 0] = TB_D
    C[:, 0] = jf
    V[:, 1::2] = opv
    C[:, 1::2] = active
    V[:, 2::2] = TB_D
    C[:, 2::2] = d
    flat = np.repeat(V.ravel(), C.ravel())
    totals = C.sum(axis=1)
    ops_list = np.split(flat, np.cumsum(totals)[:-1])
    return ops_list, meta[:, 0], meta[:, 1]

"""Int32 banded edit-distance DP (K2): the wrappers of its two CUDA kernels
and the plain PyTorch twin of the DP.

Counterpart of `hairsplitter_tpu/ops/align_pallas.py` (the Pallas kernel
`_dp_kernel`) and of the jnp scan `hairsplitter_tpu/ops/align.py:
banded_align_batch`, which the JAX package holds bit-identical to each
other. `banded_fused_cuda` is the main-path mode (`csrc/banded_fused.cu`):
DP, readout and traceback in one launch, straight to the fused buffer of
`ops/align_device.py:align_traceback_rows`; its plain version is
`ops/align_device.py:banded_fused_plain`. `banded_align_batch_dp` is the
check mode (`csrc/banded_dp.cu`), which emits what the Pallas kernel emits;
it and its plain twin `banded_align_batch_torch` return the JAX dict: `bp` (uint8 [N, B, W]
backpointers, 0 diag, 1 up/I, 2 left/D) or, with emit_enc, `enc` (the int16
traceback run encoding of `align_device.encode_runs`), plus `row_at_q`
(int32 [N, W], the DP row at i == qlen), `colmin_val` and `colmin_i` (int32
[N], the best j == tlen cell and its row, ties to the earliest row).
"""

from __future__ import annotations

import torch

from ._build import launch, load_kernels
from .align import BP_DIAG, BP_LEFT, BP_UP, INF, T_SENTINEL, BandSpec

LANES = 128  # the kernel's band width


def _check_shapes(q, q_lens, t, t_lens) -> None:
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"q [N, B] and t [N, T] expected, got {tuple(q.shape)} and {tuple(t.shape)}")
    if q_lens.shape != (q.shape[0],) or t_lens.shape != (q.shape[0],):
        raise ValueError("q_lens and t_lens must be [N]")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError("q and t must be int8 code tensors")
    if len({x.device for x in (q, q_lens, t, t_lens)}) != 1:
        raise ValueError("q, q_lens, t and t_lens must lie on one device")


# ---------------------------------------------------------------- plain twin


def banded_align_batch_torch(q, q_lens, t, t_lens, spec: BandSpec = BandSpec(), emit_enc: bool = False) -> dict:
    """The row loop of `banded_align_batch` in torch ops on q's device, any
    band: per row the diagonal and up candidates, the exact D-run prefix min
    (`torch.cummin`), the [0, tlen] x [.., qlen] mask and the backpointers;
    with emit_enc each row's backpointers are run-encoded (`encode_runs`)."""
    from .align_device import encode_runs

    _check_shapes(q, q_lens, t, t_lens)
    N, B = q.shape
    T = t.shape[1]
    W, dl = spec.band, spec.dl
    dev = q.device
    inf = int(INF)
    ql = q_lens.to(torch.int32)
    tl = t_lens.to(torch.int32)

    # dl sentinels at the left so row i reads t_padded[:, (i-1) + b]
    tp = torch.full((N, dl + max(T, B + W)), T_SENTINEL, dtype=torch.int8, device=dev)
    tp[:, dl : dl + T] = t
    bar = torch.arange(W, dtype=torch.int32, device=dev)

    # row 0: D[0][j] = j (leading deletions), j = b - dl
    j0 = bar - dl
    row0 = torch.where((j0 >= 0) & (j0[None, :] <= tl[:, None]), j0[None, :], inf)
    prev = row0
    row_at_q = torch.where((ql == 0)[:, None], row0, inf)
    colmin_val = torch.full((N,), inf, dtype=torch.int32, device=dev)
    colmin_i = torch.zeros((N,), dtype=torch.int32, device=dev)
    inf_col = torch.full((N, 1), inf, dtype=torch.int32, device=dev)
    plane = torch.empty((N, B, W), dtype=torch.int16 if emit_enc else torch.uint8, device=dev)

    for i in range(1, B + 1):
        sub = (q[:, i - 1 : i] != tp[:, i - 1 : i - 1 + W]).to(torch.int32)
        diag = prev + sub
        up = torch.cat([prev[:, 1:], inf_col], dim=1) + 1
        row = torch.cummin(torch.minimum(diag, up) - bar, dim=1).values + bar
        # cells outside [0, tlen] (j = i + b - dl) or beyond qlen are INF
        j = bar + (i - dl)
        valid = (j >= 0) & (j[None, :] <= tl[:, None]) & (ql >= i)[:, None]
        row = torch.where(valid, row.clamp(max=inf), inf)
        op = torch.where(row == diag, BP_DIAG, torch.where(row == up, BP_UP, BP_LEFT)).to(torch.uint8)
        plane[:, i - 1] = encode_runs(op) if emit_enc else op

        row_at_q = torch.where((ql == i)[:, None], row, row_at_q)
        # best cell of the j == tlen column (target-exhausted soft clips)
        b_col = tl - i + dl
        colv = row.gather(1, b_col.clamp(0, W - 1).to(torch.int64)[:, None])[:, 0]
        colv = torch.where((b_col >= 0) & (b_col < W) & (ql >= i), colv, inf)
        better = colv < colmin_val
        colmin_val = torch.where(better, colv, colmin_val)
        colmin_i = torch.where(better, i, colmin_i)
        prev = row
    return {
        ("enc" if emit_enc else "bp"): plane,
        "row_at_q": row_at_q,
        "colmin_val": colmin_val,
        "colmin_i": colmin_i,
    }


# ---------------------------------------------------------------- CUDA kernel


def _banded_dp_cuda(q, q_lens, t, t_lens, emit_enc: bool) -> dict:
    N, B = q.shape
    T = t.shape[1]
    dev = q.device
    plane = torch.empty((N, B, LANES), dtype=torch.int16 if emit_enc else torch.uint8, device=dev)
    row_at_q = torch.empty((N, LANES), dtype=torch.int32, device=dev)
    colmin_val = torch.empty((N,), dtype=torch.int32, device=dev)
    colmin_i = torch.empty((N,), dtype=torch.int32, device=dev)
    out = {
        ("enc" if emit_enc else "bp"): plane,
        "row_at_q": row_at_q,
        "colmin_val": colmin_val,
        "colmin_i": colmin_i,
    }
    if N == 0:  # nothing to launch, and nothing counted
        return out
    launch(
        "banded_dp", q.device,
        q.data_ptr(), t.data_ptr(), q_lens.data_ptr(), t_lens.data_ptr(), N, B, T, int(emit_enc),
        plane.data_ptr(), row_at_q.data_ptr(), colmin_val.data_ptr(), colmin_i.data_ptr(),
    )
    return out


def banded_align_batch_dp(q, q_lens, t, t_lens, spec: BandSpec = BandSpec(), emit_enc: bool = False) -> dict:
    """The int32 banded DP in its check mode, bit-identical to
    `banded_align_batch_pallas` of the JAX package; off the mapping path. CUDA tensors launch
    `csrc/banded_dp.cu`; CPU tensors take `banded_align_batch_torch`. Like the Pallas kernel,
    it is specialised to band 128. Takes int8 q [N, B] and t [N, T], int32 q_lens
    and t_lens [N], all contiguous on one device."""
    _check_shapes(q, q_lens, t, t_lens)
    if spec.band != LANES:
        raise ValueError(f"the int32 banded-DP kernel is specialised to band {LANES}, got {spec.band}")
    if q_lens.dtype != torch.int32 or t_lens.dtype != torch.int32:
        raise TypeError("q_lens and t_lens must be int32")
    if not all(x.is_contiguous() for x in (q, q_lens, t, t_lens)):
        raise ValueError("q, q_lens, t and t_lens must be contiguous")
    if q.device.type == "cuda":
        return _banded_dp_cuda(q, q_lens, t, t_lens, emit_enc)
    if q.device.type == "cpu":
        return banded_align_batch_torch(q, q_lens, t, t_lens, spec, emit_enc)
    raise ValueError(f"unsupported device {q.device}")


# shared memory a block may ask for on Hopper (227 KB)
MAX_BLOCK_SMEM = 232_448


def banded_fused_cuda(q, q_lens, t, t_lens, modes, spec: BandSpec = BandSpec()) -> torch.Tensor:
    """K2's main-path mode: ONE launch of `csrc/banded_fused.cu` from the
    code tensors to the fused buffer uint8 [N, 16 + B] (int32 cost, clip,
    start_i, start_b, then one token per query row), byte-identical to
    `ops/align_device.py:banded_fused_plain`. The backpointer classes the
    walk reads stay in shared memory, so the call allocates nothing but its
    output. Takes CUDA tensors only: int8 q [N, B] and t [N, T], int32
    q_lens, t_lens and modes [N], contiguous on one device; B a multiple of
    16, band 128."""
    _check_shapes(q, q_lens, t, t_lens)
    N, B = q.shape
    T = t.shape[1]
    if spec.band != LANES:
        raise ValueError(f"the int32 banded-DP kernel is specialised to band {LANES}, got {spec.band}")
    if B % 16 != 0:
        raise ValueError(f"the fused int32 banded-DP kernel needs a chunk that is a multiple of 16, got {B}")
    for name, x in (("q_lens", q_lens), ("t_lens", t_lens), ("modes", modes)):
        if x.dtype != torch.int32 or x.shape != (N,) or x.device != q.device:
            raise TypeError(f"{name} must be an int32 tensor of shape [{N}] on {q.device}")
    tensors = (q, t, q_lens, t_lens, modes)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, t, q_lens, t_lens and modes must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"banded_fused_cuda takes CUDA tensors, got {q.device}")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    smem = load_kernels().hs_banded_fused_smem_bytes(B)
    if smem > MAX_BLOCK_SMEM:
        raise ValueError(
            f"chunk {B} needs {smem} bytes of shared memory per block for the walk's scratch, "
            f"more than the {MAX_BLOCK_SMEM} a block may have"
        )
    out = torch.empty((N, 16 + B), dtype=torch.uint8, device=q.device)
    if N == 0:  # nothing to launch, and nothing counted
        return out
    launch("banded_fused", q.device, *(x.data_ptr() for x in tensors), N, B, T, out.data_ptr())
    return out

"""Myers bit-vector banded DP: the wrappers of its two CUDA kernels, its plain
PyTorch twin, and the word-level readout and traceback in torch ops.

Counterpart of `hairsplitter_tpu/ops/align_myers_pallas.py`. K1 has two
modes on the card: `myers_fused_cuda` (`csrc/myers_fused.cu`, the main path:
DP, readout and traceback in one launch, straight to the fused buffer) and
`myers_rows` (`csrc/myers_rows.cu`, the check mode: the four word streams of
the Pallas kernel). The torch-op readout and walk below are the plain
version of what the fused kernel does in registers; `ops/align_device.py:
myers_fused_plain` composes them. Words are 32-bit bit patterns stored in
int32 tensors; arithmetic on them runs in int64 masked to 32 bits, so `>>`
stays a logical shift and `~x` is masked back.

Layouts: the kernel and the plain twin both produce row-major streams
[B, N, 4] (row r of every alignment is one contiguous [N, 4] slab, which
is what the row-lockstep traceback walks); the public functions return the
JAX package's [N, B, 4] layout as a permuted view of them.
"""

from __future__ import annotations

import torch

from ._build import launch
from .align import INF, BandSpec

NW = 4  # 128-bit band = 4 uint32 words
LANES = 128
MASK32 = 0xFFFFFFFF
_DL = 64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 tensors holding 32-bit values (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def highest_bit32(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of 32-bit values (-1 for 0): bit smearing
    then a popcount — `31 - clz(x)`."""
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return popcount32(x) - 1


def mask_le(off: torch.Tensor) -> torch.Tensor:
    """32-bit mask of bits [0 .. off] (off < 0 -> 0, off >= 31 -> all ones)."""
    sh = (off + 1).clamp(0, 31)
    part = (torch.ones_like(sh) << sh) - 1
    return torch.where(off >= 31, MASK32, torch.where(off < 0, 0, part))


def _check_inputs(q: torch.Tensor, t: torch.Tensor, spec: BandSpec) -> None:
    if spec.band != LANES:
        raise ValueError("the Myers kernel is specialised to band = 128")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"q [N, B] and t [N, T] expected, got {tuple(q.shape)} and {tuple(t.shape)}")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError("q and t must be int8 code tensors")
    if q.device != t.device:
        raise ValueError("q and t must lie on one device")


# ---------------------------------------------------------------- plain twin


def _shr1(x: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """[N, 4] 128-bit vectors shifted right one cell; top (0/1) fills bit 127."""
    nxt = torch.cat([x[:, 1:] & 1, top[:, None]], dim=1)
    return (x >> 1) | (nxt << 31)


def _shl1(x: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """[N, 4] 128-bit vectors shifted left one cell; bot (0/1) fills bit 0."""
    prv = torch.cat([bot[:, None], x[:, :-1] >> 31], dim=1)
    return ((x << 1) & MASK32) | prv


def _add128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact 128-bit add mod 2^128 of [N, 4] word vectors."""
    out = []
    carry = torch.zeros_like(a[:, 0])
    for w in range(NW):
        s = a[:, w] + b[:, w] + carry
        carry = s >> 32
        out.append(s & MASK32)
    return torch.stack(out, dim=1)


def _pad_target(t: torch.Tensor, B: int) -> torch.Tensor:
    """t padded with dl sentinels on the left and up to B + W on the right
    (the Pallas wrapper's `t_padded`), as int64."""
    N, T = t.shape
    left = torch.full((N, _DL), 6, dtype=torch.int64, device=t.device)
    right = torch.full((N, max(0, B + LANES - T)), 6, dtype=torch.int64, device=t.device)
    return torch.cat([left, t.to(torch.int64), right], dim=1)


def _myers_rows_plain(q: torch.Tensor, t: torch.Tensor, emit_tb: bool) -> list[torch.Tensor]:
    """The recurrence of `_myers_kernel` in torch ops, row by row.
    Returns 2 or 4 int32 streams of shape [B, N, 4]."""
    N, B = q.shape
    dev = q.device
    tp = _pad_target(t, B)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    t0 = tp[:, :LANES].reshape(N, NW, 32)
    planes = [((t0 == c).to(torch.int64) * weights).sum(-1) for c in range(4)]  # [N, 4] each
    inj = tp[:, LANES : LANES + B]
    qc_all = q.to(torch.int64)

    word = torch.arange(NW, dtype=torch.int64, device=dev)
    base = 32 * word[None, :]
    top_ok = torch.where(word == NW - 1, 0x7FFFFFFF, MASK32)[None, :]
    one = torch.ones(N, dtype=torch.int64, device=dev)
    zero = torch.zeros(N, dtype=torch.int64, device=dev)
    P = torch.tensor([0, 0, 0xFFFFFFFE, MASK32], dtype=torch.int64, device=dev).repeat(N, 1)
    M = torch.tensor([0xFFFFFFFE, MASK32, 1, 0], dtype=torch.int64, device=dev).repeat(N, 1)

    outs = [torch.empty((B, N, NW), dtype=torch.int32, device=dev) for _ in range(4 if emit_tb else 2)]
    for r in range(B):
        qc = qc_all[:, r : r + 1]
        eq = torch.zeros_like(P)
        for c in range(4):
            eq = eq | torch.where(qc == c, planes[c], 0)
        eP = _shr1(P, one)
        eM = _shr1(M, zero)
        Xv = eq | eM
        s = _add128(eq & eP, eP)
        Xh = (s ^ eP) | eq
        Ph = (eM | ~(Xh | eP)) & MASK32
        Mh = eP & Xh
        if emit_tb:
            not_h = ~(Ph | Mh) & MASK32
            not_e = ~(eP | eM) & MASK32
            d1 = (Ph & eM) | (Mh & eP) | (not_h & not_e)
            d0 = (Ph & not_e) | (eP & not_h)
            diag = (eq & d1) | ((~eq & MASK32) & d0)
            i_row = r + 1
            off1 = (_DL + 1 - i_row) - base  # j >= 1 suffix mask per word
            sh1 = off1.clamp(0, 31)
            m_ge1 = torch.where(
                off1 <= 0, MASK32, torch.where(off1 >= 32, 0, (torch.full_like(sh1, MASK32) << sh1) & MASK32)
            )
            pos0 = (_DL - i_row) - base  # the j == 0 bit, if in this word
            m_j0 = torch.where((pos0 >= 0) & (pos0 < 32), torch.ones_like(pos0) << pos0.clamp(0, 31), 0)
            diag = diag & m_ge1
            up = ((Ph & top_ok) | m_j0) & (~diag & MASK32)
            outs[2][r] = (diag | up).to(torch.int32)
            outs[3][r] = up.to(torch.int32)
        Ph1 = _shl1(Ph, one)
        Mh1 = _shl1(Mh, zero)
        P = (Mh1 | ~(Xv | Ph1)) & MASK32
        M = Ph1 & Xv
        outs[0][r] = P.to(torch.int32)
        outs[1][r] = M.to(torch.int32)
        inj_r = inj[:, r]
        planes = [_shr1(planes[c], (inj_r == c).to(torch.int64)) for c in range(4)]
    return outs


def myers_rows_torch(q: torch.Tensor, t: torch.Tensor, spec: BandSpec = BandSpec(), emit_tb: bool = False):
    """Plain PyTorch version of the Myers row loop on any device: (P, M) or
    (P, M, nonleft, isup) int32 word streams [N, B, 4], bit-identical to
    `myers_rows_pallas` after `_words_from_device_jnp`."""
    _check_inputs(q, t, spec)
    return tuple(x.permute(1, 0, 2) for x in _myers_rows_plain(q, t, emit_tb))


# ---------------------------------------------------------------- CUDA kernel


def _myers_rows_cuda(q: torch.Tensor, t: torch.Tensor, emit_tb: bool) -> list[torch.Tensor]:
    N, B = q.shape
    T = t.shape[1]
    qT = q.t().contiguous()
    tT = t.t().contiguous()
    outs = [torch.empty((B, N, NW), dtype=torch.int32, device=q.device) for _ in range(4 if emit_tb else 2)]
    if N == 0:  # nothing to launch, and nothing counted
        return outs
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    launch("myers_rows", q.device, qT.data_ptr(), tT.data_ptr(), N, B, T, *ptrs)
    return outs


def _myers_rows_rowmajor(q, t, spec: BandSpec, emit_tb: bool) -> list[torch.Tensor]:
    """[B, N, 4] streams: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors (and nothing else)."""
    _check_inputs(q, t, spec)
    if q.device.type == "cuda":
        return _myers_rows_cuda(q, t, emit_tb)
    if q.device.type == "cpu":
        return _myers_rows_plain(q, t, emit_tb)
    raise ValueError(f"unsupported device {q.device}")


def myers_rows(q: torch.Tensor, t: torch.Tensor, spec: BandSpec = BandSpec(), emit_tb: bool = False):
    """Device Myers row loop (the K1 wrapper): (P, M) or with emit_tb
    (P, M, nonleft, isup) int32 word streams [N, B, 4], identical to
    `myers_rows_pallas` + `_words_from_device_jnp`. CUDA tensors launch
    `csrc/myers_rows.cu`; CPU tensors take `myers_rows_torch`'s recurrence."""
    return tuple(x.permute(1, 0, 2) for x in _myers_rows_rowmajor(q, t, spec, emit_tb))


def myers_fused_cuda(q, q_lens, t, t_lens, modes, spec: BandSpec = BandSpec()) -> torch.Tensor:
    """The fused K1 launch (`csrc/myers_fused.cu`) on CUDA tensors: DP,
    end-cell readout and traceback walk in one kernel. Returns the fused
    buffer uint8 [N, 16 + B] (int32 cost, clip, start_i, start_b, then one
    token `d | up << 7` per query row). One launch per call; nothing else
    runs on the device but the allocation of the output and of the walk's
    scratch (32 B per row and job: the nonleft and isup words)."""
    _check_inputs(q, t, spec)
    N, B = q.shape
    T = t.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"myers_fused_cuda takes CUDA tensors, got {q.device}")
    if B % 16 != 0:
        raise ValueError(f"the fused Myers kernel needs a chunk that is a multiple of 16, got {B}")
    for name, x in (("q_lens", q_lens), ("t_lens", t_lens), ("modes", modes)):
        if x.dtype != torch.int32 or x.shape != (N,) or x.device != q.device:
            raise TypeError(f"{name} must be an int32 tensor of shape [{N}] on {q.device}")
    tensors = (q, t, q_lens, t_lens, modes)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, t, q_lens, t_lens and modes must be contiguous")
    if q.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("q and t must be 16-byte aligned")
    out = torch.empty((N, 16 + B), dtype=torch.uint8, device=q.device)
    if N == 0:  # nothing to launch, and nothing counted
        return out
    scratch = torch.empty((B, N, 2, NW), dtype=torch.int32, device=q.device)  # (nonleft, isup) per row and job
    launch("myers_fused", q.device, *(x.data_ptr() for x in tensors), N, B, T, scratch.data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------- readout


def _unpack_bits(words: torch.Tensor, W: int) -> torch.Tensor:
    """[..., nw] 32-bit words -> [..., W] int64 bits (little-endian)."""
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (_u32(words)[..., None] >> sh) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :W]


def myers_word_readout(P, M, q_lens, t_lens, spec: BandSpec = BandSpec()) -> dict:
    """`banded_align_batch`'s readout quantities (row_at_q, colmin) straight
    from the delta words (`align_myers_pallas.py:myers_word_readout`): [N, B]
    bit extracts and popcounts, first-index argmin. Returns int64 tensors."""
    N, B, nw = P.shape
    W = spec.band
    dl = spec.dl
    dev = P.device
    q_lens = q_lens.to(torch.int64)
    t_lens = t_lens.to(torch.int64)
    ar = torch.arange(N, device=dev)

    # per-row anchor C_i[0] = dl + cumsum(1 + P_i[0] - M_i[0])
    p0 = (P[:, :, 0] & 1).to(torch.int64)
    m0 = (M[:, :, 0] & 1).to(torch.int64)
    score0 = dl + torch.cumsum(1 + p0 - m0, dim=1)  # [N, B], rows 1..B

    # row at i == qlen: unpack ONE row per alignment
    idx = (q_lens - 1).clamp(0, B - 1)
    dq = _unpack_bits(P[ar, idx], W) - _unpack_bits(M[ar, idx], W)  # [N, W]
    dq[:, 0] = 0
    s0q = score0.gather(1, idx[:, None])
    crow = s0q + torch.cumsum(dq, dim=1)
    bar = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    jq = q_lens[:, None] + bar - dl
    valid = (jq >= 0) & (jq <= t_lens[:, None])
    inf = int(INF)
    row_at_q = torch.where(valid, crow.clamp(max=inf), inf)
    j0 = bar - dl
    row0 = torch.where((j0 >= 0) & (j0 <= t_lens[:, None]), j0, inf)
    row_at_q = torch.where((q_lens == 0)[:, None], row0, row_at_q)
    row_at_q = torch.where((q_lens > B)[:, None], inf, row_at_q)

    # j == tlen column: C_i[b_col] = score0_i + popcount-prefix of the row
    # deltas up to b_col (bit 0 excluded — it is the anchor's own delta)
    i = torch.arange(1, B + 1, dtype=torch.int64, device=dev)[None, :]
    b_col = t_lens[:, None] - i + dl  # [N, B]
    base = 32 * torch.arange(nw, dtype=torch.int64, device=dev)[None, None, :]
    m_le = mask_le(b_col[:, :, None] - base)
    m_le[:, :, 0] &= 0xFFFFFFFE
    colv = score0 + (popcount32(_u32(P) & m_le) - popcount32(_u32(M) & m_le)).sum(dim=2)
    ok = (b_col >= 0) & (b_col < W) & (i <= q_lens[:, None])
    colv = torch.where(ok, colv.clamp(max=inf), inf)
    colmin_i = torch.argmin(colv, dim=1)
    colmin_val = colv.gather(1, colmin_i[:, None])[:, 0]
    colmin_i = torch.where(colmin_val >= inf, 0, colmin_i + 1)
    colmin_val = colmin_val.clamp(max=inf)
    return {"row_at_q": row_at_q, "colmin_val": colmin_val, "colmin_i": colmin_i}


def traceback_scan_words(nl_rows, up_rows, start_i, start_b) -> torch.Tensor:
    """Row-lockstep traceback over the (nonleft, isup) streams
    (`align_myers_pallas.py:traceback_scan_words`), given ROW-MAJOR [B, N, 4]
    streams: per row, the nearest non-LEFT cell at-or-left-of the current
    band position is the highest set bit of the masked nonleft words.
    Returns uint8 tokens [N, B], `d | (up << 7)` per row."""
    B, N, nw = nl_rows.shape
    dev = nl_rows.device
    word = torch.arange(nw, dtype=torch.int64, device=dev)
    base = (32 * word)[None, :]
    si = start_i.to(torch.int64)
    b = start_b.to(torch.int64)
    toks = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    for r in range(B, 0, -1):
        active = r <= si
        x = _u32(nl_rows[r - 1]) & mask_le(b[:, None] - base)
        nz = x != 0
        found = nz.any(dim=1)
        w_hi = torch.where(nz, word[None, :], -1).amax(dim=1).clamp(min=0)  # last nonzero word
        xw = x.gather(1, w_hi[:, None])[:, 0]
        uw = _u32(up_rows[r - 1]).gather(1, w_hi[:, None])[:, 0]
        hsb = highest_bit32(xw).clamp(0, 31)
        upbit = (uw >> hsb) & 1
        pos = torch.where(found, 32 * w_hi + hsb, 0)
        upv = torch.where(found, upbit, 0)
        d = (b - pos).clamp(min=0)
        toks[r - 1] = torch.where(active, (d | (upv << 7)) & 0xFF, 0).to(torch.uint8)
        b = torch.where(active, pos + upv, b)
    return toks.t()

"""Device ops for pileup column statistics and the chi² robust filter.

Counterpart of `hairsplitter_tpu/ops/variants.py`: per-column top-3 trimer
counts and coverage, window error counts, the four contingency matmuls of
the pairwise column correlation with its gates, and the partition keep and
rescue scans, as torch ops on any device. The numpy twins
(`column_stats_host`, `window_error_stats_host`, `suspect_mask`) are copied
because the JAX module loads JAX; the first two are the tests' reference
for the window statistics.

The window statistics have a CUDA kernel (`csrc/window_stats.cu`) that takes
the window blocks as one ragged batch, each block at its own row count
(`window_stats_packed`); `window_stats_plain` is its plain PyTorch version,
which CPU tensors take, and `window_stats_blocks` stages numpy blocks
through either with one copy each way: stage 3's one route on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import GAP, N_TRIMERS, TRIMER_ABSENT
from ._build import launch

# int32 flat-index budget of one bincount pass (elements of the pileup)
_STATS_CHUNK_CELLS = 1 << 27


def window_stats_batch(tri: torch.Tensor, codes_w: torch.Tensor):
    """Column stats + error counts of a batch of pileup windows
    (`column_stats` and `window_error_stats` of the JAX package, vmapped).

    tri: int8 [nb, R, P] trimer codes (TRIMER_ABSENT = absent);
    codes_w: int8 [nb, P] contig codes. Returns (top codes int32 [nb, P, 3],
    top counts int32 [nb, P, 3], coverage int32 [nb, P], mismatched cells
    int64 [nb], covered cells int64 [nb]). Ties in the top-3 go to the
    smaller code. CUDA tensors go through the kernel as a ragged batch of
    equal blocks (one launch); other devices take `window_stats_plain`."""
    if tri.device.type != "cuda":
        return window_stats_plain(tri, codes_w)
    nb, R, P = tri.shape
    offsets = torch.arange(nb + 1, dtype=torch.int64, device=tri.device) * R
    return unpack_window_stats(window_stats_packed(tri.reshape(nb * R, P), offsets, codes_w), nb, P)


def window_stats_plain(tri: torch.Tensor, codes_w: torch.Tensor):
    """`window_stats_batch` in torch ops on any device: a bincount per chunk
    of windows and a top-3 by `topk` over keys unique per column."""
    nb, R, P = tri.shape
    dev = tri.device
    bins = N_TRIMERS + 1  # last bin collects absent cells
    per = max(1, _STATS_CHUNK_CELLS // max(1, R * P))
    tcs, tns, covs, mms, ccs = [], [], [], [], []
    code_rank = torch.arange(N_TRIMERS, dtype=torch.int64, device=dev)
    for lo in range(0, nb, per):
        t = tri[lo : lo + per].to(torch.int32)
        n = t.shape[0]
        present = t != TRIMER_ABSENT
        t = torch.where(present, t, N_TRIMERS)
        offs = torch.arange(n * P, dtype=torch.int32, device=dev).view(n, 1, P) * bins
        counts = torch.bincount((t + offs).reshape(-1), minlength=n * P * bins)
        counts = counts.view(n, P, bins)[..., :N_TRIMERS]
        # stable top-3 by (count desc, code asc): keys are unique per column
        key = counts * N_TRIMERS - code_rank
        topi = torch.topk(key, 3, dim=-1).indices
        tcs.append(topi.to(torch.int32))
        tns.append(counts.gather(-1, topi).to(torch.int32))
        covs.append(present.sum(dim=1, dtype=torch.int32))
        central = t // 25
        mism = present & (central != codes_w[lo : lo + n, None, :].to(torch.int32))
        mms.append(mism.sum(dim=(1, 2)))
        ccs.append(present.sum(dim=(1, 2)))
    return tuple(torch.cat(x) for x in (tcs, tns, covs, mms, ccs))


def window_stats_bytes(nb: int, P: int) -> int:
    """Size of the byte buffer that holds the statistics of nb blocks."""
    return 16 * nb + 28 * nb * P


def unpack_window_stats(buf: torch.Tensor, nb: int, P: int):
    """Views of `window_stats_batch`'s five results in a uint8 buffer of
    `window_stats_bytes(nb, P)` bytes, laid out as mismatched cells and
    covered cells (int64 [nb] each), top codes and top counts (int32
    [nb, P, 3] each), then coverage (int32 [nb, P])."""
    sums = buf[: 16 * nb].view(torch.int64)
    o, n3 = 16 * nb, 12 * nb * P
    tc = buf[o : o + n3].view(torch.int32).view(nb, P, 3)
    tn = buf[o + n3 : o + 2 * n3].view(torch.int32).view(nb, P, 3)
    cov = buf[o + 2 * n3 :].view(torch.int32).view(nb, P)
    return tc, tn, cov, sums[:nb], sums[nb:]


def window_stats_packed(flat: torch.Tensor, offsets: torch.Tensor, codes_w: torch.Tensor) -> torch.Tensor:
    """Statistics of a ragged batch of window blocks, in one byte buffer that
    `unpack_window_stats` reads: block b is flat[offsets[b]:offsets[b + 1]].

    flat: int8 [sum of rows, P] every block's rows one after another;
    offsets: int64 [nb + 1], rising from 0 to the row count; codes_w: int8
    [nb, P]. CUDA tensors launch `csrc/window_stats.cu` once
    (`window_stats_cuda`); CPU tensors take `window_stats_plain` block by
    block. The results are those of `window_stats_batch` on each block."""
    nb, P = codes_w.shape
    if flat.dim() != 2 or flat.shape[1] != P or offsets.shape != (nb + 1,):
        raise ValueError(
            f"flat [rows, {P}] and offsets [{nb + 1}] expected, got {tuple(flat.shape)} and {tuple(offsets.shape)}"
        )
    if flat.dtype != torch.int8 or codes_w.dtype != torch.int8 or offsets.dtype != torch.int64:
        raise TypeError("flat and codes_w must be int8 and offsets int64")
    buf = torch.empty(window_stats_bytes(nb, P), dtype=torch.uint8, device=flat.device)
    out = unpack_window_stats(buf, nb, P)
    if flat.device.type == "cuda":
        window_stats_cuda(flat, offsets, codes_w, out)
    elif flat.device.type == "cpu":
        bounds = offsets.tolist()
        for b in range(nb):
            got = window_stats_plain(flat[bounds[b] : bounds[b + 1]][None], codes_w[b : b + 1])
            for o, g in zip(out, got):
                o[b] = g[0]
    else:
        raise ValueError(f"unsupported device {flat.device}")
    return buf


def window_stats_cuda(flat, offsets, codes_w, out) -> None:
    """One launch of `csrc/window_stats.cu` on CUDA tensors, writing the five
    results into `out` (`unpack_window_stats`' views)."""
    nb, P = codes_w.shape
    if not (flat.device == offsets.device == codes_w.device and flat.device.type == "cuda"):
        raise ValueError("window_stats_cuda takes CUDA tensors on one device")
    if flat.shape[0] >= 1 << 27:
        raise ValueError(f"{flat.shape[0]} rows: a warp's sums of a column block are 32-bit")
    flat, offsets, codes_w = (x.contiguous() for x in (flat, offsets, codes_w))
    if nb == 0:  # nothing to launch, and nothing counted
        return
    launch(
        "window_stats", flat.device, flat.data_ptr(), offsets.data_ptr(), codes_w.data_ptr(), nb, P,
        *(x.data_ptr() for x in out),
    )


def pack_window_blocks(tris: list[np.ndarray], codes_ws: list[np.ndarray], pin: bool = False):
    """The ragged batch of window blocks in one host buffer: int8
    [sum of rows + nb, P] with every block's rows one after another, then
    one row of contig codes per block, pinned if asked; and the int64
    [nb + 1] row offsets of the blocks (numpy)."""
    nb, P = len(tris), codes_ws[0].shape[0]
    offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum([t.shape[0] for t in tris], out=offsets[1:])
    rows = int(offsets[-1])
    staging = torch.empty((rows + nb, P), dtype=torch.int8, pin_memory=pin)
    host = staging.numpy()
    np.concatenate(tris, axis=0, out=host[:rows])
    np.stack(codes_ws, out=host[rows:])
    return staging, offsets


def window_stats_blocks(tris: list[np.ndarray], codes_ws: list[np.ndarray], device):
    """`window_stats_packed` over numpy window blocks on `device`: tris int8
    [R_b, P] (any R_b), codes_ws int8 [P]. The packed batch (pinned for
    CUDA) goes to the device in one copy and the results come back in one.
    Returns numpy (top codes [nb, P, 3], top counts [nb, P, 3], coverage
    [nb, P], mismatched cells [nb], covered cells [nb])."""
    device = torch.device(device)
    pin = device.type == "cuda"
    staging, offsets = pack_window_blocks(tris, codes_ws, pin)
    nb, rows, P = len(tris), int(offsets[-1]), staging.shape[1]
    on_dev = staging.to(device, non_blocking=pin)
    buf = window_stats_packed(on_dev[:rows], torch.from_numpy(offsets).to(device), on_dev[rows:])
    back = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=pin)
    back.copy_(buf, non_blocking=pin)
    if pin:
        torch.cuda.current_stream(device).synchronize()
    return tuple(x.numpy() for x in unpack_window_stats(back, nb, P))


def column_stats_host(tri: np.ndarray):
    """Numpy column stats (copy of the JAX package's `column_stats_host`)."""
    R, P = tri.shape
    t = tri.astype(np.int64)
    t[t == TRIMER_ABSENT] = N_TRIMERS  # trash bin
    flat = np.arange(P, dtype=np.int64) * (N_TRIMERS + 1)
    counts = np.bincount(
        (t + flat[None, :]).ravel(), minlength=P * (N_TRIMERS + 1)
    ).reshape(P, N_TRIMERS + 1)[:, :N_TRIMERS]
    key = counts * N_TRIMERS - np.arange(N_TRIMERS, dtype=np.int64)[None, :]
    topi = np.argsort(-key, axis=1, kind="stable")[:, :3].astype(np.int32)
    topc = np.take_along_axis(counts, topi, axis=1).astype(np.int32)
    coverage = counts.sum(axis=1).astype(np.int32)
    return topi, topc, coverage


def window_error_stats_host(tri: np.ndarray, contig_codes: np.ndarray):
    """Numpy window error counts (copy of `window_error_stats_host`)."""
    present = tri != TRIMER_ABSENT
    central = tri.astype(np.int32) // 25
    mism = present & (central != contig_codes[None, :].astype(np.int32))
    return int(mism.sum()), int(present.sum())


def suspect_mask(
    top_codes,
    top_counts,
    min_reads,
    auto_frac,
    min_reads_low=None,
    err_rate=0.0,
):
    """Suspect / automatic column masks (copy of `ops/variants.py:
    suspect_mask`; host numpy on [P, 3] arrays)."""
    top_codes = np.asarray(top_codes)
    top_counts = np.asarray(top_counts)
    c1, c2, c3 = top_counts[:, 0], top_counts[:, 1], top_counts[:, 2]
    t1, t2 = top_codes[:, 0], top_codes[:, 1]
    central1, central2 = t1 // 25, t2 // 25
    prev1_2, prev2_2 = (t2 // 5) % 5, t2 % 5
    not_homopolymer_indel = (central2 != GAP) | (
        (prev1_2 != central1) & (prev2_2 != central1)
    )
    if min_reads_low is None:
        min_reads_low = min_reads
    base = (central1 != central2) & not_homopolymer_indel
    cov = (c1 + c2 + c3).astype(np.float32)
    noise_floor = np.maximum(
        np.float32(min_reads_low), 1.5 * cov * np.float32(err_rate) / 3.0
    )
    suspect = (c2.astype(np.float32) > noise_floor) & (c2 > 2 * c3) & base
    strong = (c2 > min_reads) & (c2 > 5 * c3) & base
    suspect |= strong
    automatic = strong & (c2.astype(np.float32) > np.float32(auto_frac) * c1.astype(np.float32))
    return suspect, automatic


def chi2_tables(n00, n01, n10, n11):
    """Float32 Pearson chi² on 2x2 tables (`ops/variants.py:_chi2_dev`): 0
    when a margin is degenerate. Same operation order as the JAX twin."""
    n = n00 + n01 + n10 + n11
    nn = torch.clamp(n, min=1.0)
    p1 = (n10 + n11) / nn
    p2 = (n01 + n11) / nn
    e00 = (1 - p1) * (1 - p2) * n
    e01 = (1 - p1) * p2 * n
    e10 = p1 * (1 - p2) * n
    e11 = p1 * p2 * n

    def term(obs, exp):
        return torch.where(exp > 0, (obs - exp) ** 2 / torch.clamp(exp, min=1e-9), 0.0)

    chi = term(n00, e00) + term(n01, e01) + term(n10, e10) + term(n11, e11)
    degenerate = (p1 * (1 - p1) == 0) | (p2 * (1 - p2) == 0)
    return torch.where((n == 0) | degenerate, 0.0, chi)


def unpack_bits_f32(p: torch.Tensor) -> torch.Tensor:
    """uint8 [S, n/8] little-endian bit-packed rows -> f32 0/1 [S, n]."""
    sh = torch.arange(8, dtype=torch.uint8, device=p.device)
    bits = (p[:, :, None] >> sh) & 1
    return bits.reshape(p.shape[0], p.shape[1] * 8).to(torch.float32)


def pairwise_column_correlation_packed(
    Ap, Rp, pos, chi2_keep: float, max_span: int, margin: float = 0.1, margin_min: float = 0.0
):
    """The robust filter's pairwise column step (`pairwise_column_correlation
    _packed`): four S x S contingency matmuls over bit-packed indicators,
    allele-flip phasing, f32 Pearson chi², margin / f11 / span gates.
    Returns bool (corr [S, S], flip [S, S])."""
    A = unpack_bits_f32(Ap)
    Rf = unpack_bits_f32(Rp)
    n11 = A @ A.T
    n10 = A @ Rf.T
    n01 = Rf @ A.T
    n00 = Rf @ Rf.T
    flip = (n11 + n00) < (n10 + n01)
    f11 = torch.where(flip, n10, n11)
    f10 = torch.where(flip, n11, n10)
    f01 = torch.where(flip, n00, n01)
    f00 = torch.where(flip, n01, n00)
    chi = chi2_tables(f00, f01, f10, f11)
    comparable = n00 + n01 + n10 + n11
    m1 = f10 + f11
    m2 = f01 + f11
    lo = torch.clamp(comparable * float(np.float32(margin)), min=float(np.float32(margin_min)))
    balanced = (m1 > lo) & (m1 < comparable - lo) & (m2 > lo) & (m2 < comparable - lo)
    balanced &= f11 >= 3.0
    near = (pos[:, None] - pos[None, :]).abs() <= max_span
    eye = torch.eye(A.shape[0], dtype=torch.bool, device=A.device)
    corr = (chi > float(np.float32(chi2_keep))) & balanced & near & ~eye
    return corr, flip


def partition_column_keep_packed(P1, P0, Ap, Rp, col_size, chi2_keep: float):
    """Final-keep scan (`partition_column_keep_packed`): suspect columns
    correlating with any kept partition. Returns keep bool [S]."""
    A = unpack_bits_f32(Ap)
    Rf = unpack_bits_f32(Rp)
    k11 = P1 @ A.T
    k10 = P1 @ Rf.T
    k01 = P0 @ A.T
    k00 = P0 @ Rf.T
    chi = chi2_tables(k00, k01, k10, k11)
    enough = (k00 + k01 + k10 + k11) > 0.5 * col_size[None, :]
    return ((chi > float(np.float32(chi2_keep))) & enough).any(dim=0)


def partition_rescue_keep_packed(P1, P0, Arp, Rrp, chi2_rescue: float):
    """Rescue scan (`partition_rescue_keep_packed`): chi² above the rescue
    threshold with >4 reads on both margin sides. Returns ok bool [S]."""
    Ar = unpack_bits_f32(Arp)
    Rr = unpack_bits_f32(Rrp)
    r11 = P1 @ Ar.T
    r10 = P1 @ Rr.T
    r01 = P0 @ Ar.T
    r00 = P0 @ Rr.T
    chi = chi2_tables(r00, r01, r10, r11)
    ok = (chi > float(np.float32(chi2_rescue))) & (r10 + r00 > 4) & (r01 + r11 > 4)
    return ok.any(dim=0)

"""Device ops for pileup column statistics and the chi² robust filter.

Counterpart of `hairsplitter_tpu/ops/variants.py`: per-column top-3 trimer
counts and coverage, window error counts, the four contingency matmuls of
the pairwise column correlation with its gates, and the partition keep and
rescue scans, as torch ops on any device. The numpy twins the size gates
select (`column_stats_host`, `window_error_stats_host`, `suspect_mask`) are
copied because the JAX module loads JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import GAP, N_TRIMERS, TRIMER_ABSENT

# int32 flat-index budget of one bincount pass (elements of the pileup)
_STATS_CHUNK_CELLS = 1 << 27


def window_stats_batch(tri: torch.Tensor, codes_w: torch.Tensor):
    """Column stats + error counts of a batch of pileup windows
    (`column_stats` and `window_error_stats` of the JAX package, vmapped).

    tri: int8 [nb, R, P] trimer codes (TRIMER_ABSENT = absent);
    codes_w: int8 [nb, P] contig codes. Returns (top codes int32 [nb, P, 3],
    top counts int32 [nb, P, 3], coverage int32 [nb, P], mismatched cells
    int64 [nb], covered cells int64 [nb]). Ties in the top-3 go to the
    smaller code."""
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

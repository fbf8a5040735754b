"""Stage 3: variant calling + robust filtering (reference `HS_call_variants`).

Port of `hairsplitter_tpu/pipeline/call_variants.py`. It follows the JAX
package's accelerator branches on every device, with the same size gates:
the device chi² path for >= 512 suspect columns (rescue: >= 512 candidates).
The pileup of every pending contig and its window column stats take one
route on every device: `finish_preps` hands every contig's alignments to
`ops/pileup_cells.py:walk_alignments`, which walks their CIGARs into the
window blocks and every alignment's cells and computes the blocks' stats;
on a CUDA device that is one copy in, one launch of `csrc/pileup_cells.cu`,
one of `csrc/window_stats.cu` and one copy back, elsewhere the host copies
of `pipeline/pileup.py` and the stats' plain PyTorch version. It gives the
JAX package's blocks and the integers of its column stats. The cells stay
in the job's store (`ContigPrep.store`), which stage 5 reads.

Per contig: build dense pileup windows, run the device column-stat kernels,
apply the suspect rules, then keep only *robust* variants — columns whose
read partition recurs across columns. The reference does this with a
sequential partition-augmentation loop (`src/call_variants.cpp:577-768`,
`src/Partition.cpp`); here the same statistics are computed order-independently:
all suspect columns are correlated pairwise with chi² on 2x2 contingency
tables (dense matmuls over the read x column allele indicators), clustered by
correlation, and clusters are scored with the reference's binomial p-value
(`src/Partition.cpp:197-233`) and informativeness test (`:141-179`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

import torch

from .. import native as _native
from ..constants import GAP, TRIMER_ABSENT, encode_seq
from ..core.datatypes import Alignment
from ..ops.pileup_cells import CellStore, ContigWalk, pack_contig, walk_alignments
from ..pipeline.pileup import WINDOW
from ..utils import tracing

from ..ops.cluster import cw_numpy
from ..ops.variants import (
    pairwise_column_correlation_packed,
    partition_column_keep_packed,
    partition_rescue_keep_packed,
    suspect_mask,
)


@dataclass
class SparseColumn:
    """One pileup column restricted to present reads (reference `Column`,
    `src/Partition.h:8-30`). rows index the contig's alignment list."""

    pos: int
    top1: int  # trimer code of the majority allele
    top2: int  # trimer code of the second allele
    rows: np.ndarray
    alleles: np.ndarray  # trimer codes, parallel to rows


def build_allele_indicators(
    columns: list[SparseColumn], n_rows: int
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized (second-allele, majority-allele) indicator matrices,
    uint8 [S, n_rows]: one flat scatter over all columns' cells instead of
    a Python loop per column (the loop dominated robust_filter at 3k+
    suspect columns)."""
    S = len(columns)
    A = np.zeros((S, n_rows), dtype=np.uint8)
    R = np.zeros((S, n_rows), dtype=np.uint8)
    if S == 0:
        return A, R
    sizes = np.array([c.rows.size for c in columns], dtype=np.int64)
    if sizes.sum() == 0:
        return A, R
    all_rows = np.concatenate([c.rows for c in columns])
    all_al = np.concatenate([c.alleles for c in columns])
    col_id = np.repeat(np.arange(S, dtype=np.int64), sizes)
    top2 = np.repeat(np.array([c.top2 for c in columns]), sizes)
    top1 = np.repeat(np.array([c.top1 for c in columns]), sizes)
    m2 = all_al == top2
    A[col_id[m2], all_rows[m2]] = 1
    m1 = all_al == top1
    R[col_id[m1], all_rows[m1]] = 1
    return A, R


@dataclass
class ContigVariants:
    """Copy of `hairsplitter_tpu/pipeline/call_variants.py:ContigVariants`."""
    contig: str
    length: int
    depth: float
    error_rate: float  # this contig's share (subs+dels over covered cells)
    columns: list[SparseColumn] = field(default_factory=list)
    n_reads: int = 0


@dataclass
class VariantCallConfig:
    """Copy of `hairsplitter_tpu/pipeline/call_variants.py:VariantCallConfig`."""
    window: int = WINDOW
    min_reads_suspect: int = 5
    min_reads_suspect_hifi: int = 3
    # lower ADMISSION floor for the robust filter (c2 > this): columns with
    # 3-5 ALT reads — a ~5x strain's private SNPs, through local coverage
    # dips — enter partition discovery and must earn their keep through
    # partition recurrence + significance; automatics keep the reference
    # floor (round-5 low-coverage frontier; reference flat bar
    # `call_variants.cpp:526`)
    min_reads_suspect_low: int = 3
    # pairwise-correlation margin gate (reference [0.1, 0.9],
    # `call_variants.cpp:606-607`): fraction + absolute read floor.
    # Defaults match the reference — measured: relaxing to 5% admits
    # systematically-correlated hp-indel noise partitions at high coverage
    # (hard-mode rare strain 0.987 -> 0.902) while the low-coverage rescue
    # the relaxation was meant for is carried by the CW partition
    # clustering (skewed ~5x rare 0.912 with reference margins)
    corr_margin: float = 0.1
    corr_margin_min: float = 0.0
    # minimum genomic span of a multi-column partition: real haplotype
    # partitions recur over kilobases, while locally-correlated error
    # BURSTS (the dominant real-ONT noise mode the i.i.d. model misses)
    # produce column clusters confined to one ~60-100 bp burst — sharing
    # the same bursting reads, they pass every per-pair gate. Span is the
    # cheap discriminator.
    min_partition_span: int = 150
    hifi_error_threshold: float = 0.015
    auto_frac: float = 0.33  # reference -u (hairsplitter.py:36)
    min_snp_spacing: int = 5
    chi2_keep: float = 15.0
    chi2_rescue: float = 20.0
    max_partition_span: int = 50_000
    p_value: float = 1e-3
    error_cap: float = 0.15  # hairsplitter.py:691-692


def _chi2_tables(n00, n01, n10, n11):
    """Vectorized Pearson chi² on 2x2 tables (reference `computeChiSquare`,
    `src/call_variants.cpp:1135-1163`): 0 when one margin is degenerate."""
    n = n00 + n01 + n10 + n11
    with np.errstate(divide="ignore", invalid="ignore"):
        p1 = (n10 + n11) / np.maximum(n, 1)
        p2 = (n01 + n11) / np.maximum(n, 1)
        e00 = (1 - p1) * (1 - p2) * n
        e01 = (1 - p1) * p2 * n
        e10 = p1 * (1 - p2) * n
        e11 = p1 * p2 * n
        chi = (
            np.where(e00 > 0, (n00 - e00) ** 2 / np.maximum(e00, 1e-9), 0)
            + np.where(e01 > 0, (n01 - e01) ** 2 / np.maximum(e01, 1e-9), 0)
            + np.where(e10 > 0, (n10 - e10) ** 2 / np.maximum(e10, 1e-9), 0)
            + np.where(e11 > 0, (n11 - e11) ** 2 / np.maximum(e11, 1e-9), 0)
        )
    degenerate = (p1 * (1 - p1) == 0) | (p2 * (1 - p2) == 0)
    return np.where((n == 0) | degenerate, 0.0, chi)


def _lncomb(n, k):
    """Copy of `hairsplitter_tpu/pipeline/call_variants.py:_lncomb`."""
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def robust_filter(
    columns: list[SparseColumn],
    rescue_pool: list[SparseColumn],
    n_rows: int,
    mean_error: float,
    cfg: VariantCallConfig,
    *,
    device,
) -> tuple[list[SparseColumn], list[np.ndarray]]:
    """Keep columns whose read partition recurs; returns (kept, partitions).
    The chi² matmuls of >= 512 columns run on `device`.

    partitions: per kept cluster, an int8 vector over contig rows with
    +1 (second allele side), -1 (majority side), 0 (unseen/ambiguous)."""
    S = len(columns)
    if S == 0:
        return [], []
    # A: second-allele indicator, Rf: majority-allele indicator [S, n_rows]
    A, Rf = build_allele_indicators(columns, n_rows)
    pos = np.array([c.pos for c in columns])
    use_dev = S >= 512
    Ap_dev = Rp_dev = None
    if use_dev:
        # the S x S contingency matmuls + f32 chi² gates on the device; the
        # indicators upload bit-packed on the read axis and stay resident for
        # the final-keep scan. f32 chi² vs the host path differs only at exact
        # threshold boundaries
        Ap_dev = torch.from_numpy(np.packbits(A, axis=1, bitorder="little")).to(device)
        Rp_dev = torch.from_numpy(np.packbits(Rf, axis=1, bitorder="little")).to(device)
        corr_d, flip_d = pairwise_column_correlation_packed(
            Ap_dev,
            Rp_dev,
            torch.from_numpy(pos.astype(np.int64)).to(device),
            cfg.chi2_keep,
            cfg.max_partition_span,
            cfg.corr_margin,
            cfg.corr_margin_min,
        )
        corr = corr_d.cpu().numpy()
        flip = flip_d.cpu().numpy()
    else:
        Af = A.astype(np.float32)
        Rff = Rf.astype(np.float32)
        n11 = Af @ Af.T
        n10 = Af @ Rff.T
        n01 = Rff @ Af.T
        n00 = Rff @ Rff.T
        # phase: anti-correlated columns compare allele-flipped
        flip = (n11 + n00) < (n10 + n01)
        f11 = np.where(flip, n10, n11)
        f10 = np.where(flip, n11, n10)
        f01 = np.where(flip, n00, n01)
        f00 = np.where(flip, n01, n00)
        chi = _chi2_tables(f00, f01, f10, f11)
        comparable = n00 + n01 + n10 + n11
        m1 = f10 + f11
        m2 = f01 + f11
        # margin gate with an absolute floor (see
        # ops/variants.py:pairwise_column_correlation — twins kept in sync):
        # the reference's [0.1, 0.9] margins reject every column pair of a
        # <=10%-abundance strain
        lo = np.maximum(cfg.corr_margin_min, cfg.corr_margin * comparable)
        balanced = (m1 > lo) & (m1 < comparable - lo) & (m2 > lo) & (m2 < comparable - lo)
        # chance-bridge guard (twin of ops/variants.py): minimum absolute
        # phase-aligned alt-side agreement
        balanced &= f11 >= 3
        near = np.abs(pos[:, None] - pos[None, :]) <= cfg.max_partition_span
        corr = (chi > cfg.chi2_keep) & balanced & near
        np.fill_diagonal(corr, False)

    # cluster the correlation graph into partitions by label propagation
    # (Chinese Whispers, the same kernel stage 4 uses on the read graph).
    # Transitive closure (connected components) is wrong here: in a
    # multi-strain mixture, columns of DIFFERENT bipartitions correlate
    # pairwise (strain-1 alt reads are a subset of the strain-0-site alt
    # side), so A-corr-B-corr-C chains weld every strain's columns into one
    # hairball whose consensus is the majority split — low-abundance
    # partitions never surface (measured: one 548-column component holding
    # 62 rare-strain columns). CW assigns each column to the label carried
    # by most of its correlated neighbors, which splits the hairball into
    # per-bipartition clusters; the reference's sequential
    # partition-augmentation (`call_variants.cpp:589-707`) achieves the
    # same separation through its distance thresholds, order-dependently.
    adjS = np.ascontiguousarray((corr | corr.T).astype(np.int8))
    initS = np.arange(S, dtype=np.int64)
    maskS = np.ones(S, dtype=bool)
    comp = _native.chinese_whispers(adjS, initS, maskS, seed=0)
    if comp is None:
        comp = cw_numpy(adjS, initS, maskS, seed=0)
    clusters: dict[int, list[int]] = {}
    for s in range(S):
        clusters.setdefault(int(comp[s]), []).append(s)

    partitions: list[np.ndarray] = []
    part_votes: list[tuple[np.ndarray, np.ndarray]] = []  # (alt votes, ref votes) per read
    for members in clusters.values():
        members.sort(key=lambda s: columns[s].pos)
        if (
            len(members) >= 2
            and columns[members[-1]].pos - columns[members[0]].pos < cfg.min_partition_span
        ):
            continue  # burst-confined cluster (see min_partition_span)
        anchor = members[0]
        midx = np.asarray(members)
        flips = flip[anchor, midx].copy()
        flips[midx == anchor] = False
        wa = (~flips).astype(np.float32)
        wf = flips.astype(np.float32)
        sub_a, sub_r = A[midx].astype(np.float32), Rf[midx].astype(np.float32)
        # sums of 0/1 indicators: exact in f32
        alt_votes = (wa @ sub_a + wf @ sub_r).astype(np.int32)
        ref_votes = (wf @ sub_a + wa @ sub_r).astype(np.int32)
        consensus = np.zeros(n_rows, dtype=np.int8)
        consensus[alt_votes > ref_votes] = 1
        consensus[ref_votes > alt_votes] = -1

        if len(members) >= 2:
            # the reference's binomial p-value (Partition::isSignificant)
            more = np.maximum(alt_votes, ref_votes)
            less = np.minimum(alt_votes, ref_votes)
            consistent = (more > 1) & (less == 0)
            m = int(np.sum(consistent & (consensus == 1)))
            n = int(np.sum(consistent))
            c = int(np.max(np.where(consistent & (consensus == 1), more, 0), initial=0))
            if m == 0 or n == 0:
                p_val = 0.0  # matches the reference's NaN->0 fall-through
            else:
                p_val = math.exp(
                    math.log(m / n) * c * m + _lncomb(n, m) + _lncomb(S, c)
                )
            significant = p_val < cfg.p_value or len(members) > 2
        else:
            significant = True  # singleton partitions pass (reference behavior)
        if not significant:
            continue
        # informativeness (Partition::isInformative): enough consistently
        # deviating reads on both sides
        votes = alt_votes + ref_votes
        with np.errstate(invalid="ignore"):
            thr = np.minimum(
                0.5 * votes + 3 * np.sqrt(votes * 0.25), votes - 1
            )
        more = np.maximum(alt_votes, ref_votes)
        suspicious = (votes > 0) & (more > thr)
        side_alt = int(np.sum(suspicious & (consensus == 1)))
        side_ref = int(np.sum(suspicious & (consensus == -1)))
        total = side_alt + side_ref
        need = mean_error * total / 2
        if side_alt < need or side_ref < need:
            continue
        partitions.append(consensus)
        part_votes.append((alt_votes, ref_votes))

    if not partitions:
        return [], []

    # final keep: suspect columns correlating with a kept partition
    P1 = np.stack([(p == 1).astype(np.float32) for p in partitions])  # [K, R]
    P0 = np.stack([(p == -1).astype(np.float32) for p in partitions])
    if use_dev:
        # device copies padded to the bit-packed read axis (zero columns are no-ops)
        width = -(-n_rows // 8) * 8
        P1_dev = torch.from_numpy(np.pad(P1, ((0, 0), (0, width - n_rows)))).to(device)
        P0_dev = torch.from_numpy(np.pad(P0, ((0, 0), (0, width - n_rows)))).to(device)
    kept: list[SparseColumn] = []
    kept_pos: set[int] = set()

    col_size = np.array([c.rows.size for c in columns])
    if use_dev:
        # Ap_dev/Rp_dev: the bit-packed indicators already on the device
        keep_col = partition_column_keep_packed(
            P1_dev,
            P0_dev,
            Ap_dev,
            Rp_dev,
            torch.from_numpy(col_size.astype(np.float32)).to(device),
            cfg.chi2_keep,
        ).cpu().numpy()
    else:
        Af = A.astype(np.float32)
        Rff = Rf.astype(np.float32)
        k11 = P1 @ Af.T
        k10 = P1 @ Rff.T
        k01 = P0 @ Af.T
        k00 = P0 @ Rff.T
        chi_fin = _chi2_tables(k00, k01, k10, k11)  # [K, S]
        enough = (k00 + k01 + k10 + k11) > 0.5 * col_size[None, :]
        keep_col = ((chi_fin > cfg.chi2_keep) & enough).any(axis=0)
    for s in np.nonzero(keep_col)[0]:
        kept.append(columns[s])
        kept_pos.add(columns[s].pos)

    # rescue pass over non-suspect candidates (chi² > 20 vs a kept partition)
    if rescue_pool:
        Ar, Rr = build_allele_indicators(rescue_pool, n_rows)
        if use_dev and len(rescue_pool) >= 512:
            ok = partition_rescue_keep_packed(
                P1_dev,
                P0_dev,
                torch.from_numpy(np.packbits(Ar, axis=1, bitorder="little")).to(device),
                torch.from_numpy(np.packbits(Rr, axis=1, bitorder="little")).to(device),
                cfg.chi2_rescue,
            ).cpu().numpy()
        else:
            Arf = Ar.astype(np.float32)
            Rrf = Rr.astype(np.float32)
            r11 = P1 @ Arf.T
            r10 = P1 @ Rrf.T
            r01 = P0 @ Arf.T
            r00 = P0 @ Rrf.T
            chi_r = _chi2_tables(r00, r01, r10, r11)
            ok = (
                (chi_r > cfg.chi2_rescue) & (r10 + r00 > 4) & (r01 + r11 > 4)
            ).any(axis=0)
        for s in np.nonzero(ok)[0]:
            if rescue_pool[s].pos not in kept_pos:
                kept.append(rescue_pool[s])
                kept_pos.add(rescue_pool[s].pos)

    kept.sort(key=lambda c: c.pos)
    return kept, partitions


@dataclass
class ContigPrep:
    """Pass-1 product per contig: pileup window blocks + device column stats.

    Splitting prep from calling lets the orchestrator pool the error rate
    across all contigs before thresholds are applied (the reference computes a
    global error rate in an omp-critical reduction, `call_variants.cpp:1310-1316`
    — on a mesh this is the psum point)."""

    contig: str
    length: int
    n_reads: int
    mismatches: int
    cells: int
    win_stats: list = field(default_factory=list)
    # contig positions whose base equals a neighbor (inside a homopolymer
    # run): deletion alleles here are run-length miscalls, the dominant
    # systematic long-read error — the trimer-context guard only catches
    # deletions placed at the run INTERIOR, while the DP may place them at
    # the run start where the context is the preceding non-run bases
    hp_mask: np.ndarray | None = None
    # the job's cell store (every pending contig's cells and blocks), which
    # this contig's window blocks are views of and stage 5 reads
    store: CellStore | None = None

    @property
    def error_rate(self) -> float:
        return self.mismatches / max(1, self.cells)


@dataclass
class PendingPrep:
    """Host half of contig preparation: the contig's alignments packed for
    the walk, and the contig codes under each window block."""

    prep: ContigPrep
    walk: ContigWalk
    read_seqs: dict[int, str]
    codes_ws: list[np.ndarray]


def prepare_contig_host(
    contig_name: str,
    contig_seq: str,
    alignments: list[Alignment],
    read_seqs: dict[int, str],
    cfg: VariantCallConfig = VariantCallConfig(),
) -> PendingPrep:
    """Host-side packing of one contig (threadable): its alignments' runs and
    window rows (`ops/pileup_cells.py:pack_contig`), its homopolymer mask and
    contig codes. The walk and the column stats run later in
    :func:`finish_preps`, for *all* contigs at once."""
    contig_codes = encode_seq(contig_seq)
    walk = pack_contig(contig_name, len(contig_seq), alignments, cfg.window)
    hp = np.zeros(len(contig_seq), dtype=bool)
    if len(contig_seq) > 1:
        same = contig_codes[1:] == contig_codes[:-1]
        hp[1:] |= same
        hp[:-1] |= same
    prep = ContigPrep(
        contig=contig_name,
        length=len(contig_seq),
        n_reads=len(alignments),
        mismatches=0,
        cells=0,
        hp_mask=hp,
    )
    codes_ws: list[np.ndarray] = []
    for b in range(walk.block_rows.size):
        start = b * cfg.window
        codes_w = np.full(cfg.window, 5, dtype=np.int8)
        codes_w[: min(cfg.window, len(contig_seq) - start)] = contig_codes[start : start + cfg.window]
        codes_ws.append(codes_w)
    return PendingPrep(prep=prep, walk=walk, read_seqs=read_seqs, codes_ws=codes_ws)


def finish_preps(
    pending: list[PendingPrep],
    cfg: VariantCallConfig = VariantCallConfig(),
    *,
    device,
) -> dict[str, ContigPrep]:
    """Pileup and column stats of every pending contig: the alignments of
    ALL contigs go to `walk_alignments` on `device` in one call (one
    "device_pass" span), which returns the job's cell store with every
    window block and its stats; they are then collected into the
    ContigPreps ("host_pass"). The contigs of one job share their reads.
    `cfg` stays in the signature, as in the JAX package's; nothing here
    reads it."""
    store = None
    if pending:
        if any(pp.read_seqs is not pending[0].read_seqs for pp in pending):
            raise ValueError("the pending contigs of one job share one read_seqs")
        with tracing.span("device_pass", blocks=sum(len(pp.codes_ws) for pp in pending)):
            store = walk_alignments([pp.walk for pp in pending], pending[0].read_seqs, device,
                                    codes_ws=[c for pp in pending for c in pp.codes_ws])
        tc, tn, cov, mm, cc = store.stats
    out: dict[str, ContigPrep] = {}
    with tracing.span("host_pass"):
        b = 0
        for pp, blocks in zip(pending, store.blocks if store else []):
            prep = pp.prep
            prep.store = store
            for blk in blocks:
                prep.mismatches += int(mm[b])
                prep.cells += int(cc[b])
                prep.win_stats.append((blk, tc[b], tn[b], cov[b]))
                b += 1
            out[prep.contig] = prep
    return out


def call_variants_from_prep(
    prep: ContigPrep,
    error_rate: float,
    cfg: VariantCallConfig = VariantCallConfig(),
    *,
    device,
) -> ContigVariants:
    """Pass 2: suspect columns ("scan" span) + robust filter ("robust"), with
    a (possibly pooled) error rate."""
    win_stats = prep.win_stats
    error_rate = min(error_rate, cfg.error_cap)
    min_reads = (
        cfg.min_reads_suspect_hifi
        if error_rate < cfg.hifi_error_threshold
        else cfg.min_reads_suspect
    )

    suspects: list[SparseColumn] = []
    autos: list[SparseColumn] = []
    rescue_pool: list[SparseColumn] = []
    last_snp = -cfg.min_snp_spacing - 1
    with tracing.span("scan"):
        for blk, tc, tn, cov in win_stats:
            sus, auto = suspect_mask(
                tc.astype(np.int32),
                tn.astype(np.int32),
                np.int32(min_reads),
                np.float32(cfg.auto_frac),
                min_reads_low=np.int32(min(min_reads, cfg.min_reads_suspect_low)),
                err_rate=np.float32(error_rate),
            )
            sus = np.asarray(sus)
            auto = np.asarray(auto)
            # contig-level homopolymer guard (see ContigPrep.hp_mask): deletion
            # alleles inside hp runs are run-length miscalls whatever their
            # trimer context says
            t2 = tc[:, 1]
            if prep.hp_mask is not None:
                is_del = (t2 // 25) == GAP
                hp_w = np.zeros(sus.size, dtype=bool)
                span = prep.hp_mask[blk.start : blk.start + blk.length]
                hp_w[: span.size] = span[: sus.size]
                blocked = is_del & hp_w
                sus &= ~blocked
                auto &= ~blocked
            # rescue candidates: enough second-allele support to correlate, but
            # not suspect (reference re-scans the whole MSA, :699-760)
            central_ok = (tc[:, 0] // 25) != (tc[:, 1] // 25)
            hp_ok = ((t2 // 25) != GAP) | (
                (((t2 // 5) % 5) != (tc[:, 0] // 25)) & ((t2 % 5) != (tc[:, 0] // 25))
            )
            resc = (~sus) & central_ok & hp_ok & (tn[:, 1] >= 3)
            if prep.hp_mask is not None:
                resc &= ~blocked
            for p in np.nonzero(sus[: blk.length])[0]:
                gpos = blk.start + int(p)
                if gpos - last_snp <= cfg.min_snp_spacing:
                    continue
                last_snp = gpos
                col = _extract_column(blk, int(p), gpos, tc, tn)
                suspects.append(col)
                if auto[p]:
                    autos.append(col)
            for p in np.nonzero(resc[: blk.length])[0]:
                rescue_pool.append(_extract_column(blk, int(p), blk.start + int(p), tc, tn))

    n_rows = prep.n_reads
    with tracing.span("robust", suspects=len(suspects), rescue=len(rescue_pool)):
        kept, partitions = robust_filter(
            suspects, rescue_pool, n_rows, error_rate, cfg, device=device
        )
    merged: dict[int, SparseColumn] = {c.pos: c for c in kept}
    for c in autos:  # automatic SNPs always pass (reference :531,1334-1352)
        merged[c.pos] = c
    columns = [merged[p] for p in sorted(merged)]

    depth = prep.cells / max(1, prep.length)
    cv = ContigVariants(
        contig=prep.contig,
        length=prep.length,
        depth=depth,
        error_rate=error_rate,
        columns=columns,
        n_reads=n_rows,
    )
    return cv


def _extract_column(blk, p: int, gpos: int, tc, tn) -> SparseColumn:
    """Copy of `hairsplitter_tpu/pipeline/call_variants.py:_extract_column`."""
    col = blk.tri[:, p]
    present = col != TRIMER_ABSENT
    return SparseColumn(
        pos=gpos,
        top1=int(tc[p, 0]),
        top2=int(tc[p, 1]),
        rows=blk.rows[present],
        alleles=col[present].copy(),
    )

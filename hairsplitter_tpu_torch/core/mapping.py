"""Read→assembly mapping: seeding + chaining + batched banded DP + stitching.

Counterpart of `hairsplitter_tpu/core/mapping.py`. Seeding and chaining run
on the card for a CUDA device (`ops/chain_seeds.py`, one launch a call) and
on the host otherwise (`core/seeding.py`, native C++); the chunk jobs
between pins go through ONE fused mapping call per `map_reads` (up to a
memory cap of `MAX_JOBS_PER_LAUNCH` jobs): a DP kernel, readout and
row-lockstep traceback (`ops/align_device.py`), decoded on host. The DP is
chosen as the JAX package's accelerator path chooses it (`dp_kernel`): the
Myers kernel at band 128, else the int32 banded-DP kernel, else the plain
DP. The TPU path's fixed 2048-row buckets, K-tier scan and nibble-packed
uploads are not carried over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .. import native as _native
from ..constants import encode_seq, revcomp_codes
from ..core.datatypes import Alignment
from ..core.seeding import MinimizerIndex, find_chains_batch
from ..io.cigar import compress_cigar

from ..ops.align import Q_SENTINEL, T_SENTINEL, BandSpec
from ..ops.align_device import align_traceback_rows, expand_rows_host
from ..ops.chain_seeds import find_chains_cuda
from ..utils import tracing

# jobs per fused call. At B = 256 the fused Myers kernel allocates 0.6 GB for
# a full call (its walk scratch is 32 B per row and job, plus inputs and the
# fused buffer); the fused int32 DP kernel keeps its scratch in shared memory
# and allocates only the fused buffer
MAX_JOBS_PER_LAUNCH = 1 << 16


@dataclass(frozen=True)
class MapConfig:
    """The JAX package's `MapConfig` fields that select behaviour in the
    port, with the same names and defaults. `use_myers` and `use_pallas`
    pick the fused call's DP kernel (`dp_kernel`). The TPU-era switches
    `batch`, `device_traceback` and `use_native_cpu` are absent: the port
    always runs one fused device call per `map_reads`."""

    k: int = 15
    w: int = 10
    spec: BandSpec = field(default_factory=BandSpec)
    min_anchors: int = 4
    max_occ: int = 64
    # minimum identity to keep an alignment (minimap2 -M-ish sanity filter)
    max_divergence: float = 0.35
    # the int32 banded-DP kernel (csrc/banded_fused.cu), when the Myers kernel
    # is off or the band is not its 128; False runs the plain DP (any band)
    use_pallas: bool = True
    # the Myers bit-vector kernel (csrc/myers_fused.cu), the default DP at band 128
    use_myers: bool = True
    # reads with no accepted alignment get a second pass with shorter, denser
    # minimizers
    rescue: bool = True
    rescue_k: int = 11
    rescue_w: int = 6
    # homopolymer-compressed seeding (minimap2 -H)
    hpc: bool = False

    @property
    def maxdrift(self) -> int:
        return min(self.spec.dl, self.spec.dr) - 8


def select_pins(qa: np.ndarray, ta: np.ndarray, cfg: MapConfig) -> list[tuple[int, int]]:
    """Subset of chain anchors used as exact pins between DP chunks
    (copy of `core/mapping.py:select_pins`; native twin when available)."""
    B = cfg.spec.chunk
    T = cfg.spec.t_width
    md = cfg.maxdrift

    pairs = _native.select_pins(np.asarray(qa), np.asarray(ta), B, T, md)
    if pairs is not None:
        pins = [(int(a), int(b)) for a, b in pairs]
        out = [pins[0]]
        for p in pins[1:]:
            if p[0] > out[-1][0] and p[1] > out[-1][1]:
                out.append(p)
        return out

    pins = [(int(qa[0]), int(ta[0]))]
    idx = 0
    n = qa.size
    while idx < n - 1:
        best = None
        for j2 in range(idx + 1, n):
            dq = int(qa[j2] - qa[idx])
            dt = int(ta[j2] - ta[idx])
            if dq > B or dt > T or abs(dt - dq) > md:
                break
            best = j2
        if best is None:
            nxt = idx + 1
            dq = int(qa[nxt] - qa[idx])
            dt = int(ta[nxt] - ta[idx])
            npieces = max(
                math.ceil(dq / B), math.ceil(dt / T), math.ceil(abs(dt - dq) / max(1, md)), 1
            )
            for m in range(1, npieces + 1):
                pins.append(
                    (int(qa[idx] + round(dq * m / npieces)), int(ta[idx] + round(dt * m / npieces)))
                )
            idx = nxt
        else:
            pins.append((int(qa[best]), int(ta[best])))
            idx = best
    out = [pins[0]]
    for p in pins[1:]:
        if p[0] > out[-1][0] and p[1] > out[-1][1]:
            out.append(p)
    return out


@dataclass
class _Job:
    q: np.ndarray  # int8, len <= B
    t: np.ndarray  # int8, len <= T
    mode: int  # 0 global, 1 extension
    reversed_: bool  # ops must be reversed before stitching (left extension)


def _pack_jobs(jobs: list[_Job], B: int, T: int):
    n = len(jobs)
    qb = np.full((n, B), Q_SENTINEL, dtype=np.int8)
    tb = np.full((n, T), T_SENTINEL, dtype=np.int8)
    qlens = np.zeros(n, dtype=np.int32)
    tlens = np.zeros(n, dtype=np.int32)
    modes = np.zeros(n, dtype=np.int32)
    for i, job in enumerate(jobs):
        qb[i, : len(job.q)] = job.q
        tb[i, : len(job.t)] = job.t
        qlens[i] = len(job.q)
        tlens[i] = len(job.t)
        modes[i] = job.mode
    return qb, tb, qlens, tlens, modes


def dp_kernel(cfg: MapConfig) -> str:
    """The fused call's DP for `cfg`, as the JAX package's accelerator path
    picks it (`core/mapping.py:314-332`): "myers" (K1) when `use_myers` and
    the band is 128, else "pallas" (K2, the int32 banded-DP kernel) when
    `use_pallas`, else "jnp" (the plain DP in torch ops, any band)."""
    band = cfg.spec.band
    if cfg.use_myers and band == 128:
        return "myers"
    if not cfg.use_pallas:
        return "jnp"
    if band != 128:
        raise ValueError(
            f"MapConfig(use_pallas=True) runs the int32 banded-DP kernel K2 (csrc/banded_fused.cu), "
            f"which is specialised to band 128 like the JAX package's Pallas kernel; for band "
            f"{band} set MapConfig(use_pallas=False) to run the plain DP"
        )
    return "pallas"


def fused_call_host(arrays, spec: BandSpec, kernel: str, device) -> np.ndarray:
    """One fused call with its copies, as `run_jobs` makes it: the packed
    host arrays (q, q_lens, t, t_lens, modes) copied to `device` from
    pageable memory, `align_traceback_rows`, and the fused rows copied back
    into a numpy array."""
    dev = [torch.from_numpy(x).to(device) for x in arrays]
    return align_traceback_rows(*dev, spec, kernel).cpu().numpy()


def run_jobs(jobs: list[_Job], cfg: MapConfig, device) -> list[dict]:
    """Align all jobs with the fused call on `device`; per-job expanded ops,
    cost and trailing-query soft clip."""
    spec = cfg.spec
    kernel = dp_kernel(cfg)
    B, T = spec.chunk, spec.t_width
    results: list[dict] = [None] * len(jobs)
    for lo in range(0, len(jobs), MAX_JOBS_PER_LAUNCH):
        sub = jobs[lo : lo + MAX_JOBS_PER_LAUNCH]
        qb, tb, qlens, tlens, modes = _pack_jobs(sub, B, T)
        fused = fused_call_host((qb, qlens, tb, tlens, modes), spec, kernel, device)
        ops_list, cost, clip = expand_rows_host(fused, qb, tb, spec)
        for i, job in enumerate(sub):
            ops = ops_list[i]
            if job.reversed_:
                ops = ops[::-1]
            results[lo + i] = {"ops": ops, "cost": int(cost[i]), "clip": int(clip[i])}
    return results


def map_reads(
    contigs: dict[str, str],
    read_seqs: list[str],
    cfg: MapConfig = MapConfig(),
    read_indices: list[int] | None = None,
    index: MinimizerIndex | None = None,
    restrict: list[str] | None = None,
    pinned: list[list[tuple[str, int, np.ndarray, np.ndarray]]] | None = None,
    read_codes: list[np.ndarray] | None = None,
    *,
    device,
) -> list[Alignment]:
    """Map every read against the contig set; returns accepted Alignments
    (`core/mapping.py:map_reads`: same restrict=, pinned= and short-minimizer
    rescue semantics). The DP runs on `device`. Its steps are spans
    (`utils/tracing.py`) under the caller's: index, chain (with the reads'
    encoding), plan, align, assemble and rescue."""
    with tracing.span("index"):
        contig_codes = {n: encode_seq(s) for n, s in contigs.items()}
        if index is None and pinned is None:
            # with restriction, homologous drafts share minimizers: scale the
            # repetitiveness cutoff so shared seeds survive the joint index
            occ = cfg.max_occ * (max(1, len(contigs)) if restrict is not None else 1)
            index = MinimizerIndex.build(contig_codes, k=cfg.k, w=cfg.w, max_occ=occ, hpc=cfg.hpc)
    if read_indices is None:
        read_indices = list(range(len(read_seqs)))
    restrict_by_idx = (
        dict(zip(read_indices, restrict)) if restrict is not None else None
    )

    jobs: list[_Job] = []
    plans: list[dict] = []
    B = cfg.spec.chunk
    dr = cfg.spec.dr

    with tracing.span("chain", reads=len(read_seqs)) as sp:
        all_codes = (
            read_codes
            if read_codes is not None
            else [encode_seq(seq) for seq in read_seqs]
        )
        if pinned is not None:
            named_chains = [
                [
                    (cname, strand, qa, ta)
                    for cname, strand, qa, ta in read_pins
                    if cname in contig_codes and qa.size >= 2
                ]
                for read_pins in pinned
            ]
        else:
            allowed_cids = None
            if restrict_by_idx is not None:
                name_to_cid = {n: i for i, n in enumerate(index.contig_names)}
                allowed_cids = [
                    name_to_cid.get(restrict_by_idx[ridx], -1) for ridx in read_indices
                ]
            if torch.device(device).type == "cuda":
                all_chains, on_card = find_chains_cuda(
                    index, all_codes, min_anchors=cfg.min_anchors, allowed_cids=allowed_cids, device=device
                )
                sp.add(device_reads=on_card)
            else:
                all_chains = find_chains_batch(
                    index, all_codes, min_anchors=cfg.min_anchors, allowed_cids=allowed_cids
                )
            named_chains = [
                [
                    (index.contig_names[ch.contig_id], ch.strand, ch.q_anchors, ch.t_anchors)
                    for ch in read_chains
                ]
                for read_chains in all_chains
            ]
    with tracing.span("plan") as sp:
        for ridx, codes, read_chains in zip(read_indices, all_codes, named_chains):
            for cname, strand, q_anchors, t_anchors in read_chains:
                if restrict_by_idx is not None and cname != restrict_by_idx[ridx]:
                    continue
                oriented = codes if strand == 1 else revcomp_codes(codes)
                tcodes = contig_codes[cname]
                pins = select_pins(q_anchors, t_anchors, cfg)
                plan = {
                    "read_idx": ridx,
                    "contig": cname,
                    "strand": strand,
                    "qlen": len(codes),
                    "pins": pins,
                    "jobs": [],  # (job_index, kind)
                }
                q0, t0 = pins[0]
                # left extension (reversed), pinned at the first anchor
                p_used = min(q0, B)
                if p_used > 0 and t0 > 0:
                    t_lo = max(0, t0 - (p_used + dr))
                    jobs.append(
                        _Job(
                            q=oriented[q0 - p_used : q0][::-1].copy(),
                            t=tcodes[t_lo:t0][::-1].copy(),
                            mode=1,
                            reversed_=True,
                        )
                    )
                    plan["jobs"].append((len(jobs) - 1, "left"))
                # global chunks between pins
                for (qa, ta), (qb2, tb2) in zip(pins[:-1], pins[1:]):
                    jobs.append(
                        _Job(q=oriented[qa:qb2].copy(), t=tcodes[ta:tb2].copy(), mode=0, reversed_=False)
                    )
                    plan["jobs"].append((len(jobs) - 1, "mid"))
                # right extension from the last pin to the read end
                qe, te = pins[-1]
                s_used = min(len(codes) - qe, B)
                if s_used > 0 and te < len(tcodes):
                    t_hi = min(len(tcodes), te + s_used + dr)
                    jobs.append(
                        _Job(q=oriented[qe : qe + s_used].copy(), t=tcodes[te:t_hi].copy(), mode=1, reversed_=False)
                    )
                    plan["jobs"].append((len(jobs) - 1, "right"))
                plans.append(plan)
        sp.add(jobs=len(jobs))

    with tracing.span("align", jobs=len(jobs)):
        job_results = run_jobs(jobs, cfg, device)

    with tracing.span("assemble"):
        alignments: list[Alignment] = []
        for plan in plans:
            pins = plan["pins"]
            qlen = plan["qlen"]
            q_start_o, t_start = pins[0]
            q_end_o, t_end = pins[-1]
            parts = []
            nm = 0
            # order: left first (so q_start/t_start are fixed before mids), then right
            for jid, kind in plan["jobs"]:
                r = job_results[jid]
                ops = r["ops"]
                nm += r["cost"]
                if kind == "left":
                    # ops were reversed already; any soft clip falls off the far
                    # (left) end of the walk, so consumption is just what's in ops
                    cq = int(np.sum(ops != 3))  # '=','X','I' consume query
                    ct = int(np.sum(ops != 2))  # '=','X','D' consume target
                    q_start_o = pins[0][0] - cq
                    t_start = pins[0][1] - ct
                    parts.insert(0, ops)
                elif kind == "mid":
                    parts.append(ops)
                else:  # right
                    cq = int(np.sum(ops != 3))
                    ct = int(np.sum(ops != 2))
                    q_end_o = pins[-1][0] + cq
                    t_end = pins[-1][1] + ct
                    parts.append(ops)
            expanded = np.concatenate(parts) if parts else np.zeros(0, np.int8)
            if expanded.size == 0:
                continue
            cops, clens = compress_cigar(expanded)
            aligned_len = int(expanded.size)
            if aligned_len == 0 or nm > cfg.max_divergence * aligned_len:
                continue
            # convert oriented-read coords to forward-read coords
            if plan["strand"] == 1:
                q_start, q_end = q_start_o, q_end_o
            else:
                q_start, q_end = qlen - q_end_o, qlen - q_start_o
            alignments.append(
                Alignment(
                    read_idx=plan["read_idx"],
                    contig=plan["contig"],
                    strand=plan["strand"],
                    q_start=int(q_start),
                    q_end=int(q_end),
                    t_start=int(t_start),
                    t_end=int(t_end),
                    cigar_ops=cops,
                    cigar_lens=clens,
                    nm=int(nm),
                )
            )

    rescue_cfg = None
    if pinned is not None:
        # pinned chains are a fast path, not a filter: reads whose pins
        # produced nothing get the full seeded pipeline (incl. its rescue)
        if cfg.rescue:
            rescue_cfg = cfg
    elif cfg.rescue and (cfg.k, cfg.w) != (cfg.rescue_k, cfg.rescue_w):
        rescue_cfg = replace(cfg, k=cfg.rescue_k, w=cfg.rescue_w, rescue=False)
    if rescue_cfg is not None:
        mapped = {a.read_idx for a in alignments}
        unmapped = [i for i in read_indices if i not in mapped]
        if unmapped:
            by_idx = dict(zip(read_indices, read_seqs))
            with tracing.span("rescue", reads=len(unmapped)):
                alignments.extend(
                    map_reads(
                        contigs,
                        [by_idx[i] for i in unmapped],
                        rescue_cfg,
                        read_indices=unmapped,
                        restrict=(
                            [restrict_by_idx[i] for i in unmapped]
                            if restrict_by_idx is not None
                            else None
                        ),
                        device=device,
                    )
                )
    return alignments

"""racon-equivalent windowed POA polish, on the port's mapper.

Counterpart of `hairsplitter_tpu/ops/poa.py`: `polish_poa` and
`polish_poa_multi` run their remap rounds through the port's `map_reads`;
the native POA entry points and the window / pin helpers (`poa_available`,
`poa_consensus_codes`, `_window_cuts`, `_pin_anchors`, the POA_* scores) are
copies of that module's.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..constants import decode_seq, encode_seq
from ..core.mapping import MapConfig, map_reads
from ..io.cigar import expand_cigar
from ..pipeline.pileup import orient_read
from ..utils import tracing
from .consensus import polish_iterative


# racon CLI defaults: --match 3 --mismatch -5 --gap -4
POA_MATCH, POA_MISMATCH, POA_GAP = 3, -5, -4
# racon drops window fragments shorter than 2% of the window
MIN_FRAG_FRACTION = 0.02


def poa_available() -> bool:
    return native.get_lib() is not None


def poa_consensus_codes(layers: list[np.ndarray], min_cov: int = 0) -> np.ndarray | None:
    """POA consensus over int8 code layers (first = backbone window)."""
    return native.poa_consensus(layers, POA_MATCH, POA_MISMATCH, POA_GAP, min_cov)


def _window_cuts(aln, oriented_len: int, window: int, L: int):
    """Query cut positions (oriented coords) of this alignment at every
    window boundary it crosses. Returns (w_first, cuts) where cuts[i] is the
    cut at boundary (w_first + i) * window, including both fragment ends."""
    exp = expand_cigar(aln.cigar_ops, aln.cigar_lens)
    consumes_q = exp != 3  # '=','X','I'
    consumes_t = exp != 2  # '=','X','D'
    q0 = aln.q_start if aln.strand == 1 else oriented_len - aln.q_end
    qpos = q0 + np.cumsum(consumes_q) - consumes_q
    tpos = aln.t_start + np.cumsum(consumes_t) - consumes_t
    tpos_t = tpos[consumes_t]
    qpos_t = qpos[consumes_t]
    w_first = aln.t_start // window
    w_last = max(w_first, (aln.t_end - 1) // window)
    bounds = np.arange(w_first, w_last + 2) * window
    bounds[0] = max(bounds[0], aln.t_start)
    bounds[-1] = min(bounds[-1], aln.t_end)
    idx = np.searchsorted(tpos_t, bounds, side="left")
    cuts = np.where(
        idx < tpos_t.size, qpos_t[np.clip(idx, 0, max(0, tpos_t.size - 1))], q0 + (aln.q_end - aln.q_start)
    )
    cuts[0] = q0
    cuts[-1] = q0 + (aln.q_end - aln.q_start)
    return w_first, cuts


def _pin_anchors(aln, read_len: int, t_off: int, t_len_old: int, new_len: int, step: int = 192):
    """Sample exact (q, t) match pairs from a previous-round alignment every
    ~step target bases and rescale t from the old target's frame
    [t_off, t_off + t_len_old) onto the new draft of length new_len.

    Feeds `map_reads(pinned=...)` so polish remap rounds skip re-seeding
    (racon re-maps each round, but the read's placement on the draft is the
    placement it already had). The rescale drift between adjacent exact
    anchors is smooth and absorbed by the DP band; window cuts partition
    each read exactly, so a shared cut-position shift cannot corrupt the
    POA consensus. Returns (q_anchors, t_anchors) in oriented-read coords
    or None when fewer than two usable anchors remain."""
    exp = expand_cigar(aln.cigar_ops, aln.cigar_lens)
    consumes_q = exp != 3
    consumes_t = exp != 2
    q0 = aln.q_start if aln.strand == 1 else (read_len - aln.q_end)
    qpos = q0 + np.cumsum(consumes_q) - consumes_q
    tpos = aln.t_start + np.cumsum(consumes_t) - consumes_t
    m = np.nonzero(exp == 0)[0]  # '=' — exact pairs only
    if m.size < 2:
        return None
    pm, qm = tpos[m], qpos[m]
    inside = (pm >= t_off) & (pm < t_off + t_len_old)
    pm, qm = pm[inside], qm[inside]
    if pm.size < 2:
        return None
    grid = np.arange(int(pm[0]), int(pm[-1]) + step, step)
    sel = np.unique(
        np.concatenate([np.clip(np.searchsorted(pm, grid), 0, pm.size - 1), [pm.size - 1]])
    )
    scale = new_len / float(t_len_old)
    ta = np.clip(np.rint((pm[sel] - t_off) * scale), 0, new_len - 1).astype(np.int64)
    qa = qm[sel].astype(np.int64)
    keep = np.concatenate([[True], ta[1:] > ta[:-1]])
    qa, ta = qa[keep], ta[keep]
    if qa.size < 2:
        return None
    return qa, ta


def polish_poa(
    draft: str,
    reads: list[str],
    rounds: int = 1,
    window: int = 500,
    map_cfg=None,
    min_len: int = 300,
    end_trim: bool = True,
    *,
    device,
) -> str:
    """racon-equivalent polish (`ops/poa.py:polish_poa`): remap the group's reads to the draft with the
    device mapper, POA-consensus each window, concatenate; iterate.

    end_trim=False keeps the terminal windows' low-coverage end columns
    (draft-length preserving — for junction fills, where the reference
    re-attaches racon-dropped ends with edlib, tools.cpp:515-534).
    Falls back to the pileup-vote polish when the native library is absent."""
    return polish_poa_multi([draft], [reads], rounds=rounds, window=window,
                            map_cfg=map_cfg, min_len=min_len, end_trim=end_trim,
                            device=device)[0]


def polish_poa_multi(
    drafts: list[str],
    read_lists: list[list[str]],
    rounds: int = 1,
    window: int = 500,
    map_cfg=None,
    min_len: int = 300,
    init_alns: list[list] | None = None,
    init_frames: list[tuple[int, int]] | None = None,
    end_trim: bool = True,
    *,
    device,
) -> list[str]:
    """racon-equivalent polish of MANY independent (draft, read group) jobs
    per round: one restricted device mapping call covers every group's remap
    (each read pinned to its own draft so homologous haplotype drafts don't
    cross-map), and every group's windows go through one threaded native POA
    batch. Per-group results match :func:`polish_poa` up to seed-occurrence
    filtering in the shared minimizer index.

    init_alns/init_frames: optional per-group alignments of each group's
    reads to the ORIGINAL backbone (parallel to read_lists; entries may be
    None) plus the draft's (t_off, t_len) frame on that backbone. When
    given, every remap round runs with precomputed pin chains
    (`_pin_anchors`) instead of re-seeding — subsequent rounds pin from the
    previous round's own alignments."""
    if not poa_available():
        return [
            polish_iterative(d, rs, rounds=rounds, map_cfg=map_cfg, min_len=min_len, device=device)
            for d, rs in zip(drafts, read_lists)
        ]
    cfg = map_cfg or MapConfig()
    cur = list(drafts)
    G = len(cur)
    active = [len(cur[g]) >= min_len and bool(read_lists[g]) for g in range(G)]
    flat_codes_cache: dict[int, list[np.ndarray]] = {}
    min_frag = max(8, int(MIN_FRAG_FRACTION * window))
    # per group: previous-round alignments per local read (for pin chains)
    prev_alns: dict[int, list[list]] | None = None
    prev_len: dict[int, int] = {}
    for rnd in range(rounds):
        act = [g for g in range(G) if active[g]]
        if not act:
            break
        with tracing.span("pins"):
            contigs = {f"d{g}": cur[g] for g in act}
            flat_reads: list[str] = []
            flat_codes: list[np.ndarray] = []
            owner: list[int] = []
            restrict: list[str] = []
            flat_base: dict[int, int] = {}
            for g in act:
                if g not in flat_codes_cache:
                    flat_codes_cache[g] = [encode_seq(r) for r in read_lists[g]]
                flat_base[g] = len(flat_reads)
                flat_reads.extend(read_lists[g])
                flat_codes.extend(flat_codes_cache[g])
                owner.extend([g] * len(read_lists[g]))
                restrict.extend([f"d{g}"] * len(read_lists[g]))
            pinned = None
            if rnd == 0 and init_alns is not None and init_frames is not None:
                pinned = []
                for g in act:
                    t_off, t_len = init_frames[g]
                    for i, r in enumerate(read_lists[g]):
                        a = init_alns[g][i] if i < len(init_alns[g]) else None
                        pair = (
                            _pin_anchors(a, len(r), t_off, t_len, len(cur[g]))
                            if a is not None
                            else None
                        )
                        pinned.append(
                            [(f"d{g}", a.strand, pair[0], pair[1])] if pair is not None else []
                        )
            elif prev_alns is not None:
                pinned = [[] for _ in flat_reads]
                for g in act:
                    if g not in prev_alns:
                        continue
                    for i, per_read in enumerate(prev_alns[g]):
                        chains = []
                        for a in per_read:
                            pair = _pin_anchors(
                                a, len(read_lists[g][i]), 0, prev_len[g], len(cur[g])
                            )
                            if pair is not None:
                                chains.append((f"d{g}", a.strand, pair[0], pair[1]))
                        pinned[flat_base[g] + i] = chains
        draft_len_now = {g: len(cur[g]) for g in act}
        with tracing.span("remap", reads=len(flat_reads)):
            alns = map_reads(
                contigs, flat_reads, cfg, restrict=restrict, pinned=pinned,
                read_codes=flat_codes, device=device,
            )
        with tracing.span("cut"):
            prev_alns = {g: [[] for _ in read_lists[g]] for g in act}
            for a in alns:
                g = owner[a.read_idx]
                prev_alns[g][a.read_idx - flat_base[g]].append(a)
            prev_len = draft_len_now

            dcodes = {g: encode_seq(cur[g]) for g in act}
            nwin = {g: (len(dcodes[g]) + window - 1) // window for g in act}
            frags: dict[int, list[list[np.ndarray]]] = {
                g: [[] for _ in range(nwin[g])] for g in act
            }
            seen_alns = {g: False for g in act}
            for a in alns:
                g = owner[a.read_idx]
                seen_alns[g] = True
                L = len(dcodes[g])
                oriented = orient_read(flat_codes[a.read_idx], a.strand)
                w_first, cuts = _window_cuts(a, len(oriented), window, L)
                for i in range(len(cuts) - 1):
                    w = w_first + i
                    if w >= nwin[g]:
                        break
                    lo, hi = int(cuts[i]), int(cuts[i + 1])
                    if hi - lo >= min_frag:
                        frags[g][w].append(oriented[lo:hi])
        with tracing.span("poa") as sp:
            # collect every group's POA windows into one threaded native batch
            pieces: dict[int, list[np.ndarray | None]] = {g: [None] * nwin[g] for g in act}
            jobs: list[list[np.ndarray]] = []
            job_key: list[tuple[int, int]] = []
            job_cov: list[int] = []
            for g in act:
                L = len(dcodes[g])
                for w in range(nwin[g]):
                    backbone = dcodes[g][w * window : min(L, (w + 1) * window)]
                    layers = frags[g][w]
                    if len(layers) < 2:  # racon: windows with <3 layers keep the backbone
                        pieces[g][w] = backbone
                        continue
                    jobs.append([backbone] + layers)
                    job_key.append((g, w))
                    cov = max(0, len(layers) // 2)  # racon's window coverage trim
                    if not end_trim and (w == 0 or w == nwin[g] - 1):
                        cov = 1  # keep covered terminal columns (junction fills)
                    job_cov.append(cov)
            if jobs:
                res = native.poa_consensus_batch(
                    jobs, POA_MATCH, POA_MISMATCH, POA_GAP, min_covs=job_cov
                )
                if res is None:
                    res = [poa_consensus_codes(ls, min_cov=c) for ls, c in zip(jobs, job_cov)]
                for (g, w), cons in zip(job_key, res):
                    L = len(dcodes[g])
                    backbone = dcodes[g][w * window : min(L, (w + 1) * window)]
                    pieces[g][w] = cons if cons is not None and cons.size else backbone
            sp.add(windows=len(jobs))
        for g in act:
            if not seen_alns[g]:
                active[g] = False
                continue
            cat = np.concatenate(pieces[g])
            new = decode_seq(cat[cat < 4])
            if new == cur[g] or len(new) < min_len:
                active[g] = False
            else:
                cur[g] = new
    return cur

"""Stage 5: build the zipped assembly (reference `HS_create_new_contigs`).

From the per-window read groups (stage 4): fuse trivially-stitched adjacent
windows (`merge_intervals`, reference `src/create_new_contigs.cpp:1427-1533`),
polish one new contig per (interval, group) with the in-process consensus op,
recompute proportional depths (:907-944), wire graph links — interval-to-
interval stitches (:833-903) and original contig-boundary links — and emit
per-read paths through the new contigs (GAF semantics, :1128-1420) for the
untangling stage.

New contig naming: `<contig>_<intervalStart>_<group>` (:642).

Port of `hairsplitter_tpu/pipeline/new_contigs.py` (the JAX module loads
JAX through `ops.consensus`); polishing remaps run on the port's mapper,
and `base_caller` (`-p medaka`, the NN of `models/polisher.py`) takes the
vote's place per column and adds a gated pass after the POA ladder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import decode_seq, encode_seq
from ..core.datatypes import Alignment
from ..io.gfa import AssemblyGraph, Link
from ..ops.consensus import consensus_from_cells, polish_iterative
from ..ops.pileup_cells import CellStore, pack_contig, walk_alignments
from ..ops.poa import polish_poa_multi
from ..ops.triage import _backbone_badness, check_backbone, select_backbone
from ..utils import tracing
from .separate_reads import ContigGroups
from .unzip import DUMMY


@dataclass
class Interval:
    """Copy of `hairsplitter_tpu/pipeline/new_contigs.py:Interval`."""
    start: int
    end: int  # inclusive
    labels: np.ndarray  # group per contig read row


@dataclass
class ContigZip:
    """New contigs and read paths of one original contig."""

    contig: str
    intervals: list[Interval]
    names: dict[tuple[int, int], str] = field(default_factory=dict)  # (start, group) -> name


def stitch_groups(par: np.ndarray, neighbor: np.ndarray) -> dict[int, set[int]]:
    """Which left group continues into which right group(s)
    (`src/create_new_contigs.cpp:833-903`): counted over reads present on both
    sides; accepted when shared reads >= min(5, 0.7*cluster size)."""
    both = (par > -1) & (neighbor > -1)
    out: dict[int, set[int]] = {int(g): set() for g in np.unique(par[par > -1])}
    if not both.any():
        return out
    fit: dict[tuple[int, int], int] = {}
    cluster_size: dict[int, int] = {}
    for g1, g2 in zip(par[both], neighbor[both]):
        fit[(int(g1), int(g2))] = fit.get((int(g1), int(g2)), 0) + 1
        cluster_size[int(g1)] = cluster_size.get(int(g1), 0) + 1
    for (g1, g2), n in fit.items():
        if n >= min(5.0, 0.7 * cluster_size[g1]):
            out.setdefault(g1, set()).add(g2)
    return out


def merge_intervals(intervals: list[Interval]) -> list[Interval]:
    """Fuse adjacent intervals whose stitch is a perfect bijection
    (`src/create_new_contigs.cpp:1427-1533`); the left labels win and reads
    unassigned on the left inherit the converted right label."""
    if not intervals:
        return []
    out: list[Interval] = []
    cur = Interval(intervals[0].start, intervals[0].end, intervals[0].labels.copy())
    for nxt in intervals[1:]:
        left = set(int(g) for g in np.unique(cur.labels[cur.labels > -1]))
        right = set(int(g) for g in np.unique(nxt.labels[nxt.labels > -1]))
        st = stitch_groups(cur.labels, nxt.labels)
        # unstitched left groups map everywhere (reference behavior)
        for g in st:
            if not st[g]:
                st[g] = set(left)
        stitched_right = set().union(*st.values()) if st else set()
        # right groups nobody claimed: every left group claims them
        unclaimed = right - stitched_right
        for g in st:
            st[g] |= unclaimed
        trivial = bool(st) and len(left) == len(right)
        seen: set[int] = set()
        conversion: dict[int, int] = {}
        for g, targets in st.items():
            if len(targets) != 1:
                trivial = False
                break
            t = next(iter(targets))
            if t in seen:
                trivial = False
                break
            seen.add(t)
            conversion[t] = g
        if trivial and len(seen) < len(left):
            trivial = False
        if not trivial:
            out.append(cur)
            cur = Interval(nxt.start, nxt.end, nxt.labels.copy())
        else:
            cur.end = nxt.end
            fill = (cur.labels < 0) & (nxt.labels > -1)
            if fill.any():
                conv = np.array(
                    [conversion.get(int(g), -1) for g in nxt.labels], dtype=cur.labels.dtype
                )
                cur.labels[fill] = conv[fill]
    out.append(cur)
    return out


def recompute_depths(
    interval: Interval, spans: np.ndarray
) -> dict[int, float]:
    """Per-group coverage of the interval from fractional read overlaps
    (`src/create_new_contigs.cpp:907-944`)."""
    L = interval.end - interval.start + 1
    depths: dict[int, float] = {}
    for r, g in enumerate(interval.labels):
        g = int(g)
        depths.setdefault(g, 0.0)
        ov = min(int(spans[r, 1]), interval.end) - max(int(spans[r, 0]), interval.start)
        depths[g] += max(0.0, ov / L)
    return depths


@dataclass
class GafPart:
    """One GAF record: a read's traversal of linked new contigs, with the
    real per-path alignment fields (the reference emits one GAF line per
    merged path, `create_new_contigs.cpp:1296-1420`)."""

    elems: list[tuple[str, int]]
    q_start: int
    q_end: int
    nm: int
    alen: int
    path_off: int  # start offset within the path (col 8)


@dataclass
class ZipResult:
    """Copy of `hairsplitter_tpu/pipeline/new_contigs.py:ZipResult`."""
    graph: AssemblyGraph
    read_paths: dict[int, list[tuple[str, int]]]  # read_idx -> [(new contig, orient)]
    summary: list[str]
    # per-read GAF parts; read_paths is their concatenation (for the untangler)
    read_path_parts: dict[int, list[GafPart]] | None = None


def create_new_contigs(
    assembly: AssemblyGraph,
    per_contig: dict[str, tuple[list[Alignment], ContigGroups]],
    read_seqs: dict[int, str],
    polish_everything: bool = False,
    polish_rounds: int = 0,  # extra racon-style polish rounds (noisy reads)
    polish_mode: str = "vote",  # "vote" (remap+vote) | "poa" (racon-equivalent)
    base_caller=None,  # medaka-equivalent NN caller (models/polisher.py)
    *,
    device,
    cell_store: CellStore | None = None,
) -> ZipResult:
    """Build the zipped assembly graph from all contigs' window groups;
    polishing remaps run on `device`.

    Every read row's cells come from `cell_store` (stage 3's walk) where it
    walked the contig's very alignment list; the alignments of the other
    contigs with groups are walked here, in one `walk_alignments` call on
    `device`. The "cells" spans count `reused` and `walked` alignments."""
    walks, walked = [], None
    for contig, seq in assembly.segments.items():
        alns, groups = per_contig.get(contig, ([], None))
        if groups is not None and alns and (cell_store is None or cell_store.find(contig, alns) is None):
            walks.append(pack_contig(contig, len(seq), alns, 0))
    if walks:
        with tracing.span("cells"):
            walked = walk_alignments(walks, read_seqs, device)
    new_graph = AssemblyGraph()
    summary: list[str] = []
    zips: dict[str, ContigZip] = {}
    # POA polish jobs deferred across ALL contigs/groups: one restricted
    # device mapping + one threaded native POA batch per round (ops/poa.py:
    # polish_poa_multi) instead of a device round-trip per group
    # (segment, draft, reads, stage-2 alns, (t_off, t_len) backbone frame)
    poa_jobs: list[tuple[str, str, list[str], list, tuple[int, int]]] = []

    for contig, seq in assembly.segments.items():
        alns, groups = per_contig.get(contig, ([], None))
        contig_codes = encode_seq(seq)
        if groups is None or not alns:
            # no reads: keep the contig as-is
            cz = ContigZip(contig, [Interval(0, len(seq) - 1, np.zeros(0, np.int64))])
            cz.names[(0, 0)] = f"{contig}_0_0"
            new_graph.add_segment(cz.names[(0, 0)], seq, assembly.depths.get(contig, 0.0))
            zips[contig] = cz
            continue

        with tracing.span("cells") as sp:
            # cells (positions + central bases + insertions) per read row
            at = cell_store.find(contig, alns) if cell_store is not None else None
            if at is not None:
                cells = cell_store.cells(at, central=True)
                sp.add(reused=len(alns), walked=0)
            else:
                cells = walked.cells(walked.find(contig, alns), central=True)
                sp.add(reused=0, walked=len(alns))

        with tracing.span("consensus"):
            intervals = merge_intervals(
                [Interval(w.start, w.end, w.labels) for w in groups.windows]
            )
            cz = ContigZip(contig, intervals)
            zips[contig] = cz
            spans = np.array(
                [[a.t_start, a.t_end] for a in alns], dtype=np.int64
            )

            for iv in intervals:
                glist = sorted(set(int(g) for g in np.unique(iv.labels[iv.labels > -1])))
                if not glist:
                    glist = [0]
                    member_rows = {0: np.zeros(0, np.int64)}
                else:
                    member_rows = {g: np.nonzero(iv.labels == g)[0] for g in glist}
                depths = recompute_depths(iv, spans) if iv.labels.size else {0: assembly.depths.get(contig, 0.0)}
                separated = len(glist) > 1
                backbone = contig_codes[iv.start : iv.end + 1]
                for g in glist:
                    name = f"{contig}_{iv.start}_{g}"
                    cz.names[(iv.start, g)] = name
                    rows = member_rows[g]
                    if (separated or polish_everything) and rows.size:
                        rc = [(cells[r][0], cells[r][1]) for r in rows]
                        ri = [(cells[r][2], cells[r][3]) for r in rows]
                        # polishing triage ladder (reference tools.cpp:397-444):
                        # a structurally bad backbone is rebuilt before voting;
                        # groups with <2 reads route to code 2 / reassembly like
                        # the reference (`nb_reads < 2` -> 2, tools.cpp:1045-1047)
                        code = check_backbone(
                            [alns[r] for r in rows],
                            [len(read_seqs[alns[r].read_idx]) for r in rows],
                            iv.start,
                            iv.end,
                        )
                        if code != 0:
                            baseline = consensus_from_cells(
                                backbone, iv.start, rc, ri, base_caller=base_caller
                            )
                            seq_g = select_backbone(
                                code,
                                backbone,
                                iv.start,
                                iv.end,
                                rc,
                                ri,
                                [alns[r] for r in rows],
                                [read_seqs[alns[r].read_idx] for r in rows],
                                [alns[r].strand for r in rows],
                                baseline,
                                base_caller=base_caller,
                                device=device,
                            )
                            new_graph.add_segment(name, seq_g, depths.get(g, 0.0))
                            continue
                        seq_g = consensus_from_cells(
                            backbone, iv.start, rc, ri, base_caller=base_caller
                        )
                        if polish_rounds > 0:
                            group_reads = [read_seqs[alns[r].read_idx] for r in rows]
                            if polish_mode == "poa":
                                poa_jobs.append(
                                    (name, seq_g, group_reads,
                                     [alns[r] for r in rows],
                                     (iv.start, iv.end + 1 - iv.start))
                                )
                            else:
                                seq_g = polish_iterative(
                                    seq_g,
                                    group_reads,
                                    rounds=polish_rounds,
                                    base_caller=base_caller,
                                    device=device,
                                )
                    else:
                        seq_g = decode_seq(backbone)
                    new_graph.add_segment(name, seq_g, depths.get(g, 0.0))
                if separated:
                    summary.append(
                        f"{contig}[{iv.start}:{iv.end}] -> {len(glist)} haplotypes"
                    )

            # links between adjacent intervals
            for iv1, iv2 in zip(intervals[:-1], intervals[1:]):
                st = stitch_groups(iv1.labels, iv2.labels)
                g1s = sorted(set(int(g) for g in np.unique(iv1.labels[iv1.labels > -1]))) or [0]
                g2s = sorted(set(int(g) for g in np.unique(iv2.labels[iv2.labels > -1]))) or [0]
                linked_any = False
                for g1, targets in st.items():
                    for g2 in sorted(targets):
                        if (iv2.start, g2) in cz.names and (iv1.start, g1) in cz.names:
                            new_graph.add_link(
                                Link(cz.names[(iv1.start, g1)], "+", cz.names[(iv2.start, g2)], "+")
                            )
                            linked_any = True
                if not linked_any:
                    # never disconnect the contig: all-to-all fallback
                    for g1 in g1s:
                        for g2 in g2s:
                            new_graph.add_link(
                                Link(cz.names[(iv1.start, g1)], "+", cz.names[(iv2.start, g2)], "+")
                            )

    if poa_jobs:
        polished = polish_poa_multi(
            [j[1] for j in poa_jobs],
            [j[2] for j in poa_jobs],
            rounds=polish_rounds,
            # the stage-2 alignments already place every read on its
            # interval: pin the remap instead of re-seeding (ops/poa.py)
            init_alns=[j[3] for j in poa_jobs],
            init_frames=[j[4] for j in poa_jobs],
            device=device,
        )
        for job, seq_p in zip(poa_jobs, polished):
            new_graph.segments[job[0]] = seq_p
        if base_caller is not None:
            # -p medaka composes WITH the ladder (vote -> POA -> NN), the
            # topology real medaka deployments use (polish racon output);
            # the reference instead swaps the whole ladder for medaka
            # (tools.cpp:594-689). A read-fit tournament keeps the NN pass
            # from ever regressing below the ladder's output.
            with tracing.span("nn_polish"):
                for job in poa_jobs:
                    name, reads_g = job[0], job[2]
                    cur = new_graph.segments[name]
                    nn_seq = polish_iterative(
                        cur, reads_g, rounds=1, base_caller=base_caller, device=device
                    )
                    # acceptance: read fit must not worsen AND the output must
                    # not shrink: reads that systematically undercall
                    # homopolymer runs FIT a shortened draft better, so the fit
                    # gate alone happily accepts deletions of true hp bases.
                    # The per-column caller cannot insert, so net shrinkage is
                    # exactly the failure signature.
                    if (
                        nn_seq != cur
                        and len(nn_seq) >= len(cur) - max(2, 0.0005 * len(cur))
                        and _backbone_badness(nn_seq, reads_g, device=device)
                        <= _backbone_badness(cur, reads_g, device=device)
                    ):
                        new_graph.segments[name] = nn_seq

    with tracing.span("paths"):
        # original inter-contig links -> attach to terminal interval groups
        for l in assembly.links:
            ends1 = _terminal_names(zips.get(l.name1), l.orient1, True)
            ends2 = _terminal_names(zips.get(l.name2), l.orient2, False)
            for n1 in ends1:
                for n2 in ends2:
                    new_graph.add_link(Link(n1, l.orient1, n2, l.orient2, l.cigar))
        new_graph.dedupe_links()

        # per-read paths through the new contigs: within a contig, the ordered
        # interval groups of the read; across contigs, ordered by read coordinate.
        # Cross-contig parts are merged only when a graph link actually connects
        # them (the reference merges only when `find_paths` returns exactly one
        # connecting path, `create_new_contigs.cpp:1296-1420`); unmergeable parts
        # become separate GAF records, separated by a cancel slot in the flat
        # untangler path so no phantom adjacency is asserted.

        read_paths: dict[int, list[tuple[str, int]]] = {}
        read_path_parts: dict[int, list[GafPart]] = {}
        path_elems: dict[int, list[GafPart]] = {}
        for contig, (alns, groups) in per_contig.items():
            if groups is None:
                continue
            cz = zips[contig]
            for row, a in enumerate(alns):
                elems: list[tuple[str, int]] = []
                ivs = []
                for iv in cz.intervals:
                    if row < iv.labels.size and iv.labels[row] > -1:
                        nm = cz.names.get((iv.start, int(iv.labels[row])))
                        if nm is not None:
                            elems.append((nm, 1))
                            ivs.append(iv)
                if not elems:
                    continue
                if a.strand == 0:
                    elems = [(nm, 0) for nm, _ in reversed(elems)]
                    # path walked against the contig: starts inside the LAST
                    # traversed interval, at its far end
                    path_off = max(0, int(ivs[-1].end) - a.t_end)
                else:
                    path_off = max(0, a.t_start - int(ivs[0].start))
                path_elems.setdefault(a.read_idx, []).append(
                    GafPart(
                        elems=elems,
                        q_start=a.q_start,
                        q_end=a.q_end,
                        nm=a.nm,
                        alen=a.q_end - a.q_start,
                        path_off=path_off,
                    )
                )
        # canonical link keys of the new graph for the merge test
        def _lkey(n1: str, o1: str, n2: str, o2: str) -> tuple:
            flip = {"+": "-", "-": "+"}
            a = (n1, o1, n2, o2)
            b = (n2, flip[o2], n1, flip[o1])
            return min(a, b)

        linkset = {_lkey(l.name1, l.orient1, l.name2, l.orient2) for l in new_graph.links}
        for ridx, parts in path_elems.items():
            parts.sort(key=lambda t: t.q_start)
            merged: list[GafPart] = [parts[0]]
            for nxt in parts[1:]:
                prev = merged[-1]
                tn, ts = prev.elems[-1]
                hn, hs = nxt.elems[0]
                connected = _lkey(tn, "+" if ts == 1 else "-", hn, "+" if hs == 1 else "-") in linkset
                if connected:
                    merged[-1] = GafPart(
                        elems=prev.elems + nxt.elems,
                        q_start=prev.q_start,
                        q_end=max(prev.q_end, nxt.q_end),
                        nm=prev.nm + nxt.nm,
                        alen=prev.alen + nxt.alen,
                        path_off=prev.path_off,
                    )
                else:
                    merged.append(nxt)
            read_path_parts[ridx] = merged
            path: list[tuple[str, int]] = []
            for i, part in enumerate(merged):
                if i > 0:
                    path.append((DUMMY, 1))
                path.extend(part.elems)
            read_paths[ridx] = path

    return ZipResult(
        graph=new_graph,
        read_paths=read_paths,
        summary=summary,
        read_path_parts=read_path_parts,
    )


def _terminal_names(cz: ContigZip | None, orient: str, is_first_endpoint: bool) -> list[str]:
    """Names of the interval-group contigs sitting at the linked end of an
    original contig: '+' leaves from its end (last interval) and enters at the
    start (first interval)."""
    if cz is None:
        return []
    if is_first_endpoint:
        iv = cz.intervals[-1] if orient == "+" else cz.intervals[0]
    else:
        iv = cz.intervals[0] if orient == "+" else cz.intervals[-1]
    gl = (
        sorted(set(int(g) for g in np.unique(iv.labels[iv.labels > -1])))
        if iv.labels.size
        else [0]
    ) or [0]
    return [cz.names[(iv.start, g)] for g in gl if (iv.start, g) in cz.names]


def write_gaf(
    path: str,
    read_names: dict[int, str],
    graph: AssemblyGraph,
    read_lens: dict[int, int],
    read_path_parts: dict[int, list[GafPart]],
) -> None:
    """Write read paths in GAF (`doc/README.md` / `create_new_contigs.cpp:
    1128-1420`): one record per merged path, like the reference, with that
    path's real query span, start offset within the path, and residue
    matches from the contributing alignments' NM counts (the per-part form
    of `pipeline/new_contigs.py:write_gaf`)."""
    with open(path, "w") as f:
        for ridx, parts in sorted(read_path_parts.items()):
            for part in parts:
                if not part.elems:
                    continue
                pstr = "".join((">" if o == 1 else "<") + nm for nm, o in part.elems)
                plen = sum(len(graph.segments.get(nm, "")) for nm, _o in part.elems)
                qlen = int(read_lens.get(ridx, part.q_end))
                matches = max(0, part.alen - part.nm)
                off = min(part.path_off, max(plen - 1, 0))
                f.write(
                    f"{read_names.get(ridx, f'read_{ridx}')}\t{qlen}\t"
                    f"{part.q_start}\t{part.q_end}\t+\t"
                    f"{pstr}\t{plen}\t{off}\t{min(off + part.alen, plen)}\t"
                    f"{matches}\t{max(part.alen, 1)}\t60\n"
                )

"""Stage 1 (opt-in `--correct-assembly`): assembly correction before splitting.

Equivalent of the reference's GenomeTailor (`src/HS_GenomeTailor/scaffold.cpp`):
iteratively edit the assembly graph until reads align end-to-end
(scaffold.cpp:2181-2284 loops detect -> correct until no solid bridges
remain). Detected evidence, as in the reference:

  * bridges — a read whose alignment jumps from the middle/end of one contig
    to another mid-read (`inventoriate_bridges_and_piers`, scaffold.cpp:341):
    the junction gets a link, contigs are cut at mid-contig junction points
    (`transform_bridges_in_links`, scaffold.cpp:763), and the link attaches to
    the cut piece at the junction;
  * piers — a read whose alignment stops abruptly inside a contig
    (breakpoint): with enough support the contig is cut there.

Evidence is pooled per position window and requires >=5 supporting reads
(scaffold.cpp:1926,2231). After every correction pass the graph is shaved of
dead ends <60 bp and bubbles <20 bp are popped (`shave_and_pop`,
scaffold.cpp:1507, invoked :2261 with (60, 20)). After the loop a final
coverage cleanup drops contigs with re-mapped coverage <=1 and rewrites
depths from measured coverage (`last_cleanup`, scaffold.cpp:1729, invoked
:2304). A before/after table of end-to-end aligned reads is reported like
the reference's self-metric (scaffold.cpp:2304-2357).

Bridge junctions with read sequence between the contigs are gap-filled with
a consensus polished from all supporting read inserts (the reference
racon-polishes these inside `transform_bridges_in_links`), and reads that
align nowhere are reassembled into new contigs with the greedy overlap
assembler before the correction loop (`core/assembler.py`; the reference
shells out to raven first, scaffold.cpp:154,2160-2166).

Counterpart of `hairsplitter_tpu/pipeline/tailor.py`: the same functions,
names, iteration orders and results; every mapping (the loop's remaps and the
gap-fill polish) runs through the port's `map_reads` on the caller's `device`.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field, replace

import numpy as np

from ..constants import revcomp
from ..core.assembler import greedy_assemble
from ..core.datatypes import Alignment
from ..core.mapping import MapConfig, map_reads
from ..io.cigar import CONSUMES_QUERY, CONSUMES_TARGET, OP_EQ, OP_M, compress_cigar, expand_cigar
from ..io.gfa import AssemblyGraph, Link, parse_gfa, write_gfa
from ..ops.consensus import polish_iterative
from ..ops.poa import poa_available, polish_poa


@dataclass
class TailorConfig:
    min_support: int = 5
    end_margin: int = 150  # clip tolerance at read/contig ends
    window: int = 100  # breakpoint pooling window
    max_junction_gap: int = 500  # read-side gap allowed inside a bridge
    min_junction_fill: int = 20  # junction inserts shorter than this become 0M links
    reassemble_unaligned: bool = True  # assemble never-aligning reads into new contigs
    min_unaligned_contig: int = 1000
    # the loop exits when a pass applies no correction — the reference's
    # no-solid-bridges criterion (scaffold.cpp:2181-2284); this is only an
    # oscillation safety bound, not an operating cap (an earlier cap of 5
    # could abandon nested misjoins mid-repair)
    max_iterations: int = 100
    shave_dead_end: int = 60  # scaffold.cpp:2261 shave_and_pop(..., 60, 20)
    pop_bubble: int = 20
    last_cleanup: bool = True  # scaffold.cpp:2304 coverage cleanup
    min_cleanup_coverage: float = 1.0  # keep contigs with coverage > 1 (scaffold.cpp last_cleanup)


@dataclass
class TailorReport:
    end_to_end_before: int = 0
    end_to_end_after: int = 0
    n_reads: int = 0
    cuts: list[tuple[str, int]] = field(default_factory=list)
    new_links: list[tuple] = field(default_factory=list)
    unaligned_reads: int = 0
    reassembled_contigs: int = 0
    iterations: int = 0
    e2e_history: list[int] = field(default_factory=list)  # end-to-end count at each remap
    shaved_contigs: int = 0
    dropped_low_coverage: int = 0


def _trim_noisy_ends(a: Alignment) -> Alignment:
    """Trim low-identity alignment ends before reading junction evidence.

    The reference gets soft-clipped junctions for free from minimap2; our
    banded mapper force-extends through divergent sequence (e.g. an insert
    aligned against an unrelated contig continuation), which would blur the
    junction position and swallow gap-fill sequence. Keep the max-scoring
    sub-alignment with match +1 / error -2 (minimap2 z-drop-like)."""
    cols = expand_cigar(a.cigar_ops, a.cigar_lens)
    if cols.size == 0:
        return a
    score = np.where((cols == OP_EQ) | (cols == OP_M), 1, -2)
    # max-scoring contiguous column interval (Kadane)
    pref = np.concatenate([[0], np.cumsum(score)])
    run_min = np.minimum.accumulate(pref[:-1])
    gains = pref[1:] - run_min
    j = int(np.argmax(gains)) + 1
    i = int(np.argmin(pref[:j]))
    if i == 0 and j == cols.size:
        return a
    dq_head = int(CONSUMES_QUERY[cols[:i]].sum())
    dq_tail = int(CONSUMES_QUERY[cols[j:]].sum())
    dt_head = int(CONSUMES_TARGET[cols[:i]].sum())
    dt_tail = int(CONSUMES_TARGET[cols[j:]].sum())
    ops, lens = compress_cigar(cols[i:j])
    if a.strand == 1:
        q_start, q_end = a.q_start + dq_head, a.q_end - dq_tail
    else:  # CIGAR is in contig orientation: head trims the read's right end
        q_start, q_end = a.q_start + dq_tail, a.q_end - dq_head
    return replace(
        a,
        q_start=q_start,
        q_end=q_end,
        t_start=a.t_start + dt_head,
        t_end=a.t_end - dt_tail,
        cigar_ops=ops,
        cigar_lens=lens,
    )


def _collect_breakpoints(
    alns_by_read: dict[int, list[Alignment]],
    read_lens: dict[int, int],
    contig_lens: dict[str, int],
    cfg: TailorConfig,
):
    """Breakpoint and bridge evidence from read alignments."""
    bp_votes: dict[str, list[int]] = defaultdict(list)  # contig -> positions
    # (c1, side1, c2, side2) -> [(read, q-lo, q-hi, flipped, pos1, pos2)]
    bridge_votes: dict[tuple, list] = defaultdict(list)
    for ridx, alns in alns_by_read.items():
        L = read_lens[ridx]
        alns = sorted((_trim_noisy_ends(a) for a in alns), key=lambda a: a.q_start)
        for a in alns:
            cl = contig_lens[a.contig]
            # pier: read continues but the alignment stops inside the contig
            if a.strand == 1:
                ends = [(a.q_start, a.t_start, "start"), (L - a.q_end, cl - a.t_end, "end")]
            else:
                ends = [(a.q_start, cl - a.t_end, "end"), (L - a.q_end, a.t_start, "start")]
            for read_overhang, contig_rest, side in ends:
                if read_overhang > cfg.end_margin and contig_rest > cfg.end_margin:
                    pos = a.t_end if (side == "end") == (a.strand == 1) else a.t_start
                    bp_votes[a.contig].append(int(pos))
        # bridges: consecutive alignments on the read; the read sequence
        # between them is the junction gap, consensus-polished from all
        # supporting inserts (the reference racon-polishes,
        # transform_bridges_in_links scaffold.cpp:763)
        for a1, a2 in zip(alns[:-1], alns[1:]):
            if a2.q_start - a1.q_end > cfg.max_junction_gap:
                continue
            if a1.contig == a2.contig:
                continue
            # which end of each contig faces the junction, and the junction
            # position on each contig (mid-contig junctions get the link
            # attached at the cut piece, scaffold.cpp:763)
            side1 = "+" if a1.strand == 1 else "-"  # leaving a1 through its aligned end
            side2 = "+" if a2.strand == 1 else "-"
            pos1 = a1.t_end if a1.strand == 1 else a1.t_start
            pos2 = a2.t_start if a2.strand == 1 else a2.t_end
            flip = {"+": "-", "-": "+"}
            fwd = (a1.contig, side1, a2.contig, side2)
            rev = (a2.contig, flip[side2], a1.contig, flip[side1])
            # canonicalize so both read strands vote for the same junction;
            # flipped evidence contributes its insert reverse-complemented
            if fwd <= rev:
                bridge_votes[fwd].append((ridx, a1.q_end, a2.q_start, False, int(pos1), int(pos2)))
            else:
                bridge_votes[rev].append((ridx, a1.q_end, a2.q_start, True, int(pos2), int(pos1)))
    return bp_votes, bridge_votes


def _pool_positions(votes: list[int], window: int, min_support: int) -> list[int]:
    votes = sorted(votes)
    out = []
    i = 0
    while i < len(votes):
        j = i
        while j < len(votes) and votes[j] - votes[i] <= window:
            j += 1
        if j - i >= min_support:
            out.append(int(np.median(votes[i:j])))
        i = j
    return out


def _attach_piece(pieces: list[tuple[str, int, int]], side: str, pos: int, entering: bool) -> str:
    """Piece of a cut contig a junction link attaches to: the piece whose
    facing end is nearest the junction position (the reference cuts at the
    junction and links the cut piece, scaffold.cpp:763). For the source
    contig (leaving) '+' faces the piece's right end; for the destination
    contig (entering) '+' means entering at the piece's left end."""
    at_right_end = (side == "+") != entering
    if at_right_end:
        return min(pieces, key=lambda t: abs(t[2] - pos))[0]
    return min(pieces, key=lambda t: abs(t[1] - pos))[0]


def _consensus_fill(inserts: list[str], map_cfg: MapConfig, *, device) -> str:
    """Junction gap-fill polished from every supporting read insert.

    The reference racon-polishes the junction sequence from the supporting
    reads (scaffold.cpp:763+ via tools); here the median-length insert is
    the draft and the racon-grade windowed POA (`ops/poa.polish_poa`, the
    same engine the stage-5 ladder uses) converges it on the other inserts
    — on noisy reads the gap-fill is the one output sequence assembled
    purely from raw reads, so it gets the full-strength polisher, not just
    the vote. Very short fills keep the representative
    insert (too short to seed a mapping)."""
    draft = sorted(inserts, key=len)[len(inserts) // 2]
    if len(draft) < 100 or len(inserts) < 3:
        return draft
    if poa_available():
        return polish_poa(draft, inserts, rounds=1, end_trim=False, device=device)
    return polish_iterative(
        draft, inserts, rounds=2, map_cfg=map_cfg, min_len=50, device=device
    )


def _apply_corrections(
    graph: AssemblyGraph,
    bp_votes,
    bridge_votes,
    read_seqs: dict[int, str],
    map_cfg: MapConfig,
    cfg: TailorConfig,
    report: TailorReport,
    *,
    device,
) -> tuple[AssemblyGraph, bool]:
    """One detect->correct pass: cut at breakpoints, add bridge links and
    gap-fills. Returns (new graph, whether anything changed)."""
    changed = False
    out = AssemblyGraph()
    piece_of: dict[str, list[tuple[str, int, int]]] = {}  # contig -> [(piece, start, end)]
    for name, seq in graph.segments.items():
        cuts = _pool_positions(bp_votes.get(name, []), cfg.window, cfg.min_support)
        cuts = [c for c in cuts if cfg.end_margin < c < len(seq) - cfg.end_margin]
        bounds = [0] + sorted(set(cuts)) + [len(seq)]
        pieces = []
        for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            pname = name if len(bounds) == 2 else f"{name}&{k}"
            out.add_segment(pname, seq[lo:hi], graph.depths.get(name))
            pieces.append((pname, lo, hi))
            if k > 0:
                report.cuts.append((name, lo))
                changed = True
        piece_of[name] = pieces

    # original links re-attach to terminal pieces; cut points stay linked so
    # the original walk is preserved
    for name, pieces in piece_of.items():
        for (p1, _, _), (p2, _, _) in zip(pieces[:-1], pieces[1:]):
            out.add_link(Link(p1, "+", p2, "+", "0M"))
    for l in graph.links:
        n1 = piece_of[l.name1][-1][0] if l.orient1 == "+" else piece_of[l.name1][0][0]
        n2 = piece_of[l.name2][0][0] if l.orient2 == "+" else piece_of[l.name2][-1][0]
        out.add_link(Link(n1, l.orient1, n2, l.orient2, l.cigar))

    # bridge links with enough support; junctions with sequence in between
    # get a gap-fill contig consensus-polished from all supporting inserts
    existing = {l.key() for l in out.links}
    for (c1, s1, c2, s2), evidence in bridge_votes.items():
        n = len(evidence)
        if n < cfg.min_support:
            continue
        p1 = _attach_piece(piece_of[c1], s1, int(np.median([e[4] for e in evidence])), entering=False)
        p2 = _attach_piece(piece_of[c2], s2, int(np.median([e[5] for e in evidence])), entering=True)
        gaps = sorted(evidence, key=lambda e: e[2] - e[1])
        med_len = gaps[len(gaps) // 2][2] - gaps[len(gaps) // 2][1]
        if med_len >= cfg.min_junction_fill:
            inserts = []
            for ridx, qlo, qhi, flipped, _, _ in evidence:
                s = read_seqs[ridx][qlo:qhi]
                inserts.append(revcomp(s) if flipped else s)
            jname = f"junction_{p1}_{p2}"
            if jname in out.segments:
                continue
            out.add_segment(jname, _consensus_fill(inserts, map_cfg, device=device), depth=float(n))
            link1 = Link(p1, s1, jname, "+", "0M")
            link2 = Link(jname, "+", p2, s2, "0M")
            for link in (link1, link2):
                if link.key() not in existing:
                    out.add_link(link)
                    existing.add(link.key())
            report.new_links.append((p1, s1, p2, s2, n))
            changed = True
        else:
            link = Link(p1, s1, p2, s2, "0M")
            if link.key() not in existing:
                out.add_link(link)
                existing.add(link.key())
                report.new_links.append((p1, s1, p2, s2, n))
                changed = True
    out.dedupe_links()
    return out, changed


def _side_links(graph: AssemblyGraph) -> dict[str, tuple[list, list]]:
    """Per contig, the (left-end, right-end) neighbor lists as
    (name, relative-orientation-flag) pairs — the reference's
    `links_of_contigs` structure (scaffold.cpp shave_and_pop)."""
    sides: dict[str, tuple[list, list]] = {n: ([], []) for n in graph.segments}
    for l in graph.links:
        if l.name1 in sides:
            sides[l.name1][1 if l.orient1 == "+" else 0].append((l.name2, l.orient2 == "-"))
        if l.name2 in sides:
            sides[l.name2][0 if l.orient2 == "+" else 1].append((l.name1, l.orient1 == "+"))
    return sides


def shave_and_pop(graph: AssemblyGraph, max_dead_end: int, max_bubble: int) -> int:
    """Shave dead ends shorter than `max_dead_end` and pop one side of
    bubbles shorter than `max_bubble` — polishing-error cleanup after each
    correction pass (reference `shave_and_pop`, scaffold.cpp:1507, invoked
    with (60, 20) at :2261). Returns the number of contigs removed."""
    sides = _side_links(graph)
    lens = {n: len(s) for n, s in graph.segments.items()}
    bad: set[str] = set()
    for name, (left, right) in sides.items():
        # small dead end: missing links on either side
        if (not left or not right) and lens[name] < max_dead_end:
            bad.add(name)
        # bubble at either end of this contig: two short parallel neighbors
        # with identical single-link endpoints on both sides
        for nbrs in (left, right):
            for n1, f1 in nbrs:
                for n2, f2 in nbrs:
                    if n1 == n2 or n1 in bad or n2 in bad:
                        continue
                    if lens.get(n1, 1 << 30) >= max_bubble or lens.get(n2, 1 << 30) >= max_bubble:
                        continue
                    l1, r1 = sides[n1]
                    l2, r2 = sides[n2]
                    if not (len(l1) == len(r1) == len(l2) == len(r2) == 1):
                        continue
                    if f1 == f2 and l1[0][0] == l2[0][0] and r1[0][0] == r2[0][0]:
                        bad.add(n1)
                    elif f1 != f2 and l1[0][0] == r2[0][0] and r1[0][0] == l2[0][0]:
                        bad.add(n1)
    for name in bad:
        graph.remove_segment(name)
    return len(bad)


def last_cleanup(
    graph: AssemblyGraph,
    alns_by_read: dict[int, list[Alignment]],
    min_coverage: float,
) -> int:
    """Final coverage pass: re-measure per-contig coverage from the last
    read alignment, drop contigs whose coverage is <= `min_coverage` (and
    their links), and rewrite depths from the measured coverage — the
    reference's `last_cleanup` (scaffold.cpp:1729, DP:f tags + the
    `coverage > 1` keep rule). Returns the number of contigs dropped."""
    cov: dict[str, float] = defaultdict(float)
    for alns in alns_by_read.values():
        for a in alns:
            clen = len(graph.segments.get(a.contig, ""))
            if clen:
                cov[a.contig] += (a.t_end - a.t_start) / clen
    dropped = [n for n in graph.segments if cov[n] <= min_coverage]
    for name in dropped:
        graph.remove_segment(name)
    for name in graph.segments:
        graph.depths[name] = round(cov[name], 2)
    return len(dropped)


def correct_assembly(
    assembly: AssemblyGraph,
    read_seqs: dict[int, str],
    map_cfg: MapConfig = MapConfig(),
    cfg: TailorConfig = TailorConfig(),
    artifact_dir: str | None = None,
    resume: bool = False,
    *,
    device,
) -> tuple[AssemblyGraph, TailorReport]:
    """Detect and correct assembly errors until reads align end-to-end; every
    mapping runs on `device`.

    Mirrors the reference GenomeTailor main loop (scaffold.cpp:2100-2360):
    reassemble unaligned reads first, then iterate detect -> correct ->
    shave_and_pop -> realign until a pass changes nothing, then run the
    final coverage cleanup.

    With `artifact_dir` set, the graph after the reassembly pass and after
    every correction iteration is checkpointed as `tailor_iter_<k>.gfa`
    (+ a `tailor_state.json` with the running report); `resume=True`
    restarts the loop from the newest checkpoint instead of iteration 0 —
    the intra-stage analogue of the reference's stage-level `--resume`
    (`hairsplitter.py:456-826`).
    """
    report = TailorReport(n_reads=len(read_seqs))
    seqs = [read_seqs[i] for i in sorted(read_seqs)]
    idxs = sorted(read_seqs)
    read_lens = {i: len(read_seqs[i]) for i in read_seqs}

    def _map(g: AssemblyGraph) -> dict[int, list[Alignment]]:
        by_read: dict[int, list[Alignment]] = defaultdict(list)
        for a in map_reads(g.segments, seqs, map_cfg, read_indices=idxs, device=device):
            by_read[a.read_idx].append(a)
        return by_read

    def _count_e2e(g: AssemblyGraph, by_read) -> int:
        # the reference's self-metric counts reads whose full length aligns
        # as one GAF path (scaffold.cpp:2304-2357): a chain of alignments
        # hopping only across existing links
        linkset = _link_keys(g)
        return sum(
            1
            for ridx, al in by_read.items()
            if _spans_via_bridge(al, read_lens[ridx], cfg, linkset)
        )

    graph = AssemblyGraph()
    for name, seq in assembly.segments.items():
        graph.add_segment(name, seq, assembly.depths.get(name))
    for l in assembly.links:
        graph.add_link(Link(l.name1, l.orient1, l.name2, l.orient2, l.cigar))

    def _checkpoint(k: int) -> None:
        if artifact_dir is None:
            return
        write_gfa(graph, os.path.join(artifact_dir, f"tailor_iter_{k}.gfa"))
        state = {
            "iterations": report.iterations,
            "end_to_end_before": report.end_to_end_before,
            "e2e_history": report.e2e_history,
            "unaligned_reads": report.unaligned_reads,
            "reassembled_contigs": report.reassembled_contigs,
            "shaved_contigs": report.shaved_contigs,
            "n_cuts": len(report.cuts),
            "n_new_links": len(report.new_links),
        }
        with open(os.path.join(artifact_dir, "tailor_state.json"), "w") as f:
            json.dump(state, f)

    resumed_from = -1
    if resume and artifact_dir is not None:
        arts = sorted(
            glob.glob(os.path.join(artifact_dir, "tailor_iter_*.gfa")),
            key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]),
        )
        state_path = os.path.join(artifact_dir, "tailor_state.json")
        if arts and os.path.exists(state_path):
            graph = parse_gfa(arts[-1])
            with open(state_path) as f:
                state = json.load(f)
            report.iterations = state["iterations"]
            report.end_to_end_before = state["end_to_end_before"]
            report.e2e_history = list(state["e2e_history"])
            report.unaligned_reads = state["unaligned_reads"]
            report.reassembled_contigs = state["reassembled_contigs"]
            report.shaved_contigs = state["shaved_contigs"]
            resumed_from = int(arts[-1].rsplit("_", 1)[1].split(".")[0])

    remap_needed = False
    if resumed_from < 0:
        alns_by_read = _map(graph)
        report.unaligned_reads = len(read_seqs) - len(alns_by_read)
        report.end_to_end_before = _count_e2e(graph, alns_by_read)
        report.e2e_history.append(report.end_to_end_before)

        # reassemble reads that aligned nowhere into new contigs — the
        # reference runs raven on unaligned reads before the correction loop
        # (scaffold.cpp:2160-2166)
        if cfg.reassemble_unaligned:
            unaligned = {
                f"u{ridx}": read_seqs[ridx]
                for ridx in read_seqs
                if ridx not in alns_by_read and len(read_seqs[ridx]) >= 500
            }
            if len(unaligned) >= cfg.min_support:
                new_contigs = greedy_assemble(unaligned, min_len=cfg.min_unaligned_contig)
                for k, seq in enumerate(new_contigs):
                    graph.add_segment(f"reassembled_{k}", seq, depth=0.0)
                report.reassembled_contigs = len(new_contigs)
                remap_needed = bool(new_contigs)
        _checkpoint(0)
    else:
        remap_needed = True  # alignments against the checkpoint are not stored

    for it in range(report.iterations, cfg.max_iterations):
        if remap_needed:
            alns_by_read = _map(graph)
            report.e2e_history.append(_count_e2e(graph, alns_by_read))
        contig_lens = {n: len(s) for n, s in graph.segments.items()}
        bp_votes, bridge_votes = _collect_breakpoints(alns_by_read, read_lens, contig_lens, cfg)
        graph, changed = _apply_corrections(
            graph, bp_votes, bridge_votes, read_seqs, map_cfg, cfg, report, device=device
        )
        if not changed:
            break
        report.iterations += 1
        report.shaved_contigs += shave_and_pop(graph, cfg.shave_dead_end, cfg.pop_bubble)
        remap_needed = True
        _checkpoint(report.iterations)

    # re-map against the corrected assembly for the after-metric and the
    # final coverage cleanup
    by_read2 = _map(graph)
    report.end_to_end_after = _count_e2e(graph, by_read2)
    report.e2e_history.append(report.end_to_end_after)
    if cfg.last_cleanup:
        report.dropped_low_coverage = last_cleanup(graph, by_read2, cfg.min_cleanup_coverage)
    return graph, report


def _link_keys(g: AssemblyGraph) -> set[tuple]:
    """Directed (contig, leave-side, contig, enter-side) adjacency keys."""
    keys = set()
    flip = {"+": "-", "-": "+"}
    for l in g.links:
        keys.add((l.name1, l.orient1, l.name2, l.orient2))
        keys.add((l.name2, flip[l.orient2], l.name1, flip[l.orient1]))
    return keys


def _spans_via_bridge(
    alns: list[Alignment], read_len: int, cfg: TailorConfig, linkset: set[tuple] | None = None
) -> bool:
    """Read covered end-to-end by a chain of alignments with small gaps,
    each hop crossing an actual graph link (the reference's end-to-end
    criterion is a single minigraph GAF path, which can only chain across
    existing links)."""
    alns = sorted(alns, key=lambda a: a.q_start)
    if not alns or alns[0].q_start > cfg.end_margin:
        return False
    reach = alns[0].q_end
    prev = alns[0]
    for a in alns[1:]:
        if a.q_start - reach > cfg.max_junction_gap:
            return False
        if linkset is not None and a.q_start >= reach - cfg.end_margin:
            same = prev.contig == a.contig and prev.strand == a.strand
            s1 = "+" if prev.strand == 1 else "-"
            s2 = "+" if a.strand == 1 else "-"
            if not same and (prev.contig, s1, a.contig, s2) not in linkset:
                return False
        reach = max(reach, a.q_end)
        prev = a
    return read_len - reach <= cfg.end_margin

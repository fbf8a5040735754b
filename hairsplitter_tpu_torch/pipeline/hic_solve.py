"""Iterative Hi-C / linked-reads knot solver.

Rebuild of GraphUnzip's `solve_with_HiC.py` machinery (975 LoC; invoked via
the `graphunzip.py HiC` path, unreachable from the HairSplitter CLI but part
of the vendored capability — SURVEY §2.1 row 24). The pipeline, matching the
reference stage for stage:

1. Sinkhorn-normalize the interaction matrix (`normalize`,
   solve_with_HiC.py:503-531: 10 alternating row/column normalizations plus
   a final row pass) — dense numpy; the contig x contig matrix is small.
2. Pick haploid anchor contigs from coverage + topology
   (solve_with_HiC.py:54-100): reference coverage from contigs with <=1
   link per side, anchors = contigs at ~1x reference coverage not
   out-covered by their neighbors (or, without confident coverage, contigs
   with <=1 link per side), plus contigs longer than the mean anchor.
3. Find knots: groups of anchor ENDS mutually reachable through non-anchor
   contigs (`determine_list_of_knots` / `find_neighbors`,
   solve_with_HiC.py:183-405, bounded BFS). Anchors with zero interaction
   signal toward every reachable anchor are uninformative and dropped
   (:249-262).
4. Match anchor ends within each knot by strongest normalized interaction;
   a knot is solved only when every end finds a non-zero partner
   (`match_haploidContigs`, solve_with_HiC.py:408-500); redundant contacts
   whose both endpoints are already matched twice are pruned (:480-484).
5. For each matched pair, find the path through the knot's non-anchor
   contigs (`find_paths`/`dispatch_contigs`, solve_with_HiC.py:534-786 —
   intermediate contigs go to the pair they interact with most; here:
   BFS shortest path weighted by interaction with the pair's anchors).
6. Untangle: duplicate the intermediate contigs of each path into fresh
   copies chained anchor-to-anchor, split depth proportionally, and delete
   the claimed originals (`untangle_knots`, solve_with_HiC.py:789-975).
7. Iterate (the reference caps at 2 rounds, solve_with_HiC.py:125-175).

Copy of `hairsplitter_tpu/pipeline/hic_solve.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..io.gfa import AssemblyGraph, Link
from .unzip import _flip, _neighbors


def sinkhorn_normalize(m: np.ndarray, rounds: int = 10) -> np.ndarray:
    """Alternating row/column normalization + final row pass
    (reference `normalize`, solve_with_HiC.py:503-531); diagonal zeroed."""
    w = np.asarray(m, dtype=np.float64).copy()
    np.fill_diagonal(w, 0.0)
    for _ in range(rounds):
        rs = w.sum(axis=1, keepdims=True)
        np.divide(w, rs, out=w, where=rs != 0)
        cs = w.sum(axis=0, keepdims=True)
        np.divide(w, cs, out=w, where=cs != 0)
    rs = w.sum(axis=1, keepdims=True)
    np.divide(w, rs, out=w, where=rs != 0)
    return w


@dataclass
class SolveReport:
    rounds: int = 0
    knots_seen: int = 0
    knots_solved: int = 0
    contigs_duplicated: int = 0
    anchors: list[str] = field(default_factory=list)


def find_anchor_contigs(g: AssemblyGraph, confident_coverage: bool = True) -> list[str]:
    """Haploid anchor contigs (solve_with_HiC.py:54-100)."""
    # reference coverage from contigs with <=1 link per side
    total_depth = total_len = 0.0
    for name, seq in g.segments.items():
        if len(_neighbors(g, name, "-")) <= 1 and len(_neighbors(g, name, "+")) <= 1:
            d = g.depths.get(name, 1.0)
            total_depth += d * max(1, len(seq))
            total_len += max(1, len(seq))
    ref_cov = (total_depth / total_len) if (confident_coverage and total_len) else 1.0

    anchors: list[str] = []
    lengths: list[int] = []
    for name, seq in g.segments.items():
        left = _neighbors(g, name, "-")
        right = _neighbors(g, name, "+")
        d = g.depths.get(name, 1.0)
        if confident_coverage:
            if round(d / max(ref_cov, 1e-9)) <= 1:
                m1 = max([g.depths.get(n, 1.0) for n, _ in left], default=0.0)
                m2 = max([g.depths.get(n, 1.0) for n, _ in right], default=0.0)
                if d < 1.5 * max(m1, m2, 1e-9) and (len(seq) > 1000 or (left and right)):
                    anchors.append(name)
                    lengths.append(len(seq))
        else:
            if len(left) <= 1 and len(right) <= 1 and (len(seq) > 1000 or (left and right)):
                anchors.append(name)
                lengths.append(len(seq))
    # long contigs are anchors too, worst case ruled out next round (:95-99)
    if lengths:
        ref_len = float(np.mean(lengths))
        aset = set(anchors)
        for name, seq in g.segments.items():
            if len(seq) > ref_len and name not in aset:
                anchors.append(name)
    return anchors


def _reachable_anchor_ends(
    g: AssemblyGraph, anchors: set[str], name: str, side: str, max_depth: int = 100
) -> tuple[set[tuple[str, str]], set[str]]:
    """Anchor ends reachable from (name, side) through non-anchor contigs,
    plus the traversed non-anchor contigs (reference `find_neighbors`,
    solve_with_HiC.py:383-405)."""
    found: set[tuple[str, str]] = set()
    through: set[str] = set()
    seen: set[tuple[str, str]] = set()
    queue: deque = deque()
    for n, o in _neighbors(g, name, side):
        queue.append((n, o, 0))
    while queue:
        n, enter, depth = queue.popleft()
        if (n, enter) in seen or depth > max_depth:
            continue
        seen.add((n, enter))
        if n in anchors:
            # entering orientation '+' means we touched its left ('-') end
            found.add((n, "-" if enter == "+" else "+"))
            continue
        through.add(n)
        # continue out the other end
        for n2, o2 in _neighbors(g, n, enter):
            queue.append((n2, o2, depth + 1))
    return found, through


def _interaction(im_names: dict[str, int], w: np.ndarray, a: str, b: str) -> float:
    ia, ib = im_names.get(_base_name(a)), im_names.get(_base_name(b))
    if ia is None or ib is None:
        return 0.0
    return float(w[ia, ib] + w[ib, ia])


def _base_name(name: str) -> str:
    """Copies made by untangling keep interacting as their original."""
    return name.split("*")[0]


def solve_with_interactions(
    g: AssemblyGraph,
    names: list[str],
    matrix: np.ndarray,
    confident_coverage: bool = True,
    max_rounds: int = 2,
) -> SolveReport:
    """Iteratively solve interaction knots, reference solve_with_HiC
    (solve_with_HiC.py:37-180). Mutates `g`; returns a report."""
    rep = SolveReport()
    w = sinkhorn_normalize(matrix)
    im_names = {n: i for i, n in enumerate(names)}

    for _ in range(max_rounds):
        anchors = find_anchor_contigs(g, confident_coverage)
        rep.anchors = anchors
        aset = set(anchors)
        if len(anchors) < 2:
            break

        # anchors with an all-zero interaction row can never be matched:
        # drop them before reachability so knots see through them (the
        # reference sheds not-actually-haploid contigs between rounds,
        # match_haploidContigs solve_with_HiC.py:441-446; a collapsed repeat
        # misclassified as haploid has no Hi-C identity of its own)
        aset = {
            n
            for n in aset
            if _base_name(n) in im_names
            and (w[im_names[_base_name(n)], :].sum() + w[:, im_names[_base_name(n)]].sum()) > 0
        }

        # per anchor end: reachable anchor ends + traversed contigs, with
        # zero-signal anchors shed iteratively (reachability stops at
        # anchors, so each drop can expose new reachability)
        reach: dict[tuple[str, str], set[tuple[str, str]]] = {}
        through: dict[tuple[str, str], set[str]] = {}
        while True:
            ends = [(n, s) for n in aset for s in ("-", "+")]
            for e in ends:
                reach[e], through[e] = _reachable_anchor_ends(g, aset, *e)
            uninformative = set()
            for n in aset:
                reachable = reach[(n, "-")] | reach[(n, "+")]
                sig = sum(_interaction(im_names, w, n, m) for (m, _) in reachable)
                if reachable and sig <= 0:
                    uninformative.add(n)
            if not uninformative:
                break
            aset -= uninformative

        # knots: union-find over mutually reachable anchor ends
        parent: dict[tuple[str, str], tuple[str, str]] = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        def union(x, y):
            parent.setdefault(x, x)
            parent.setdefault(y, y)
            rx, ry = find(x), find(y)
            if rx != ry:
                parent[rx] = ry

        for e in ends:
            if e[0] not in aset:
                continue
            for f in reach[e]:
                if f[0] in aset:
                    union(e, f)
        knots: dict[tuple, list[tuple[str, str]]] = {}
        for e in ends:
            if e[0] in aset and reach[e]:
                knots.setdefault(find(e), []).append(e)

        solved_paths: list[tuple[tuple[str, str], tuple[str, str], list[tuple[str, str]]]] = []
        claimed: set[str] = set()
        for knot_ends in knots.values():
            if len(knot_ends) < 2:
                continue
            # a knot with no branching anywhere is already a resolved linear
            # chain — nothing to untangle
            knot_through = set().union(*(through[e] for e in knot_ends))
            branching = any(
                len(_neighbors(g, n, s)) > 1 for n in knot_through for s in ("-", "+")
            ) or any(len(_neighbors(g, *e)) > 1 for e in knot_ends)
            if not branching:
                continue
            rep.knots_seen += 1
            # match each end to its strongest-interacting reachable partner
            contacts: set[tuple] = set()
            solved = True
            for e in knot_ends:
                cands = [f for f in reach[e] if f[0] in aset and f[0] != e[0]]
                scores = [_interaction(im_names, w, e[0], f[0]) for f in cands]
                if not scores or max(scores) <= 0:
                    solved = False
                    break
                best = cands[int(np.argmax(scores))]
                contacts.add((min(e, best), max(e, best)))
            if not solved:
                continue
            # prune contacts whose both endpoints are already matched twice
            # (spurious big-contig links, solve_with_HiC.py:480-484)
            deg: dict[tuple[str, str], int] = {}
            for c in contacts:
                for e in c:
                    deg[e] = deg.get(e, 0) + 1
            for c in sorted(contacts):
                if deg[c[0]] > 1 and deg[c[1]] > 1:
                    contacts.discard(c)
                    deg[c[0]] -= 1
                    deg[c[1]] -= 1
            rep.knots_solved += 1
            for e1, e2 in contacts:
                path = _path_between(g, aset, e1, e2, im_names, w)
                if path is not None:
                    solved_paths.append((e1, e2, path))
                    claimed.update(n for n, _ in path)

        if not solved_paths:
            break
        rep.rounds += 1
        rep.contigs_duplicated += _untangle_paths(g, solved_paths, claimed)

    return rep


def _path_between(
    g: AssemblyGraph,
    anchors: set[str],
    e1: tuple[str, str],
    e2: tuple[str, str],
    im_names,
    w,
) -> list[tuple[str, str]] | None:
    """Path of (contig, orientation) through non-anchor contigs from anchor
    end e1 to anchor end e2. BFS shortest; among equal-length expansions the
    contig interacting most with the two anchors wins (the reference
    dispatches intermediate contigs to pairs by interaction,
    solve_with_HiC.py:643-712)."""
    target = e2
    best_at: dict[tuple[str, str], tuple[int, float, list]] = {}
    queue: deque = deque()
    queue.append((e1[0], e1[1], 0, 0.0, []))
    while queue:
        n, side, depth, score, path = queue.popleft()
        if depth > 60:
            continue
        for n2, enter in _neighbors(g, n, side):
            if (n2, "-" if enter == "+" else "+") == target:
                return path
            if n2 in anchors:
                continue
            key = (n2, enter)
            sc = score + _interaction(im_names, w, n2, e1[0]) + _interaction(im_names, w, n2, e2[0])
            prev = best_at.get(key)
            if prev is not None and (prev[0] < depth + 1 or (prev[0] == depth + 1 and prev[1] >= sc)):
                continue
            best_at[key] = (depth + 1, sc, path)
            queue.append((n2, enter, depth + 1, sc, path + [(n2, enter)]))
    return None


def _untangle_paths(g: AssemblyGraph, solved_paths, claimed: set[str]) -> int:
    """Duplicate each solved path's intermediate contigs into fresh copies
    chained anchor end to anchor end, split depth proportionally among the
    copies of a contig, then delete the claimed originals and their links
    (reference `untangle_knots`, solve_with_HiC.py:789-975)."""
    copy_count: dict[str, int] = {}
    for _, _, path in solved_paths:
        for n, _ in path:
            copy_count[n] = copy_count.get(n, 0) + 1
    made = 0
    serial: dict[str, int] = {}
    for e1, e2, path in solved_paths:
        prev_name, prev_side = e1
        for n, enter in path:
            serial[n] = serial.get(n, 0) + 1
            cname = f"{n}*{serial[n]}"
            g.add_segment(cname, g.segments[n], g.depths.get(n, 1.0) / max(1, copy_count[n]))
            made += 1
            # entering orientation on n becomes the copy's orientation
            g.add_link(Link(prev_name, prev_side, cname, enter, "0M"))
            prev_name, prev_side = cname, enter
        g.add_link(Link(prev_name, prev_side, e2[0], _flip(e2[1]), "0M"))
    for n in claimed:
        g.remove_segment(n)
    g.dedupe_links()
    return made

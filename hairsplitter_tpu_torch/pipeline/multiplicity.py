"""Contig multiplicity (ploidy) estimation from coverage + graph topology.

Equivalent of GraphUnzip's `determine_multiplicity`
(`src/GraphUnzip/determine_multiplicity.py:16-241`), used by the reference
when `-c/--haploid-coverage` is given (`hairsplitter.py:704-722`) to cap the
number of haplotypes per contig in stage 4.

Reference semantics ported here (round-4 parity fix):
- haploid reference coverage = length-weighted *average* depth of contigs
  with <=1 neighbor per end (`determine_multiplicity.py:20-32`); a value of
  0 or 1 marks coverage as unreliable and disables every depth guard
  (`:34-38`).
- haploid seeds: simple contigs whose depth rounds to <=1 copy (`:41-46`).
- greedy propagation with a *confidence* rule: an unknown contig takes the
  sum of one side's known-neighbor multiplicities only when both sides
  agree (`new_multiplicity1 == new_multiplicity2`, high confidence,
  `:66-68`) or the contig's depth supports it
  (`depth/refCoverage > mult/1.5`, `:74`); a side only counts when every
  neighbor on it is known AND attaches to this contig exclusively
  (`:60-64`).
- subtraction inference: a known trunk with exactly one unknown branch
  gives that branch `trunk - sum(known branches)` copies, gated by the same
  depth/1.5 guard (`:89-109`).
- `supported_links` bookkeeping: every (contig-end, neighbor-end) pair whose
  multiplicity was used or inferred is recorded (`:80-87,108-109`).
- leftover contigs get coverage-proportional spreads from known neighbors
  (`:118-138`) and finally `max(1, minLeft, minRight)` (`:140-162`), so the
  result is a *minimum* multiplicity (`:157`).

Copy of `hairsplitter_tpu/pipeline/multiplicity.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from ..io.gfa import AssemblyGraph

# An end index: 0 = the 5' / '-' side of a segment, 1 = the 3' / '+' side
# (matches GraphUnzip's links[0]/links[1] convention, segment.py:8-197).
EndMap = dict[str, tuple[list[tuple[str, int]], list[tuple[str, int]]]]


def _build_ends(g: AssemblyGraph) -> EndMap:
    ends: EndMap = {n: ([], []) for n in g.segments}
    for l in g.links:
        if l.name1 not in ends or l.name2 not in ends:
            continue
        e1 = 1 if l.orient1 == "+" else 0
        e2 = 0 if l.orient2 == "+" else 1
        ends[l.name1][e1].append((l.name2, e2))
        if not (l.name1 == l.name2 and e1 == e2):  # don't double a self-loop
            ends[l.name2][e2].append((l.name1, e1))
    return ends


def _is_simple(ends: EndMap, name: str) -> bool:
    return len(ends[name][0]) <= 1 and len(ends[name][1]) <= 1


def estimate_haploid_coverage(g: AssemblyGraph) -> float:
    """Length-weighted average depth of 'simple' contigs (<=1 neighbor per
    end) — the reference haploid coverage (`determine_multiplicity.py:20-32`,
    including the +1 in the denominator that guards division by zero)."""
    ends = _build_ends(g)
    num = 0.0
    den = 1.0
    for name, seq in g.segments.items():
        if name in g.depths and _is_simple(ends, name):
            num += len(seq) * g.depths[name]
            den += len(seq)
    return num / den


def _set_support(
    supported: dict, a: tuple[str, int], b: tuple[str, int], value: int
) -> None:
    key = (a, b) if a <= b else (b, a)
    supported[key] = value


def determine_multiplicity(
    g: AssemblyGraph,
    haploid_coverage: float = 0.0,
    supported_links: dict | None = None,
) -> dict[str, int]:
    """Integer (minimum) copy number per contig.

    haploid_coverage <= 0 -> estimated from the graph; a reference coverage
    of <=1 marks depths unreliable and disables the depth guards, exactly as
    the reference does (`determine_multiplicity.py:34-38`). Pass a dict as
    `supported_links` to collect the reference's supported-link bookkeeping
    keyed by canonicalized ((name, end), (name, end)) pairs.
    """
    names = list(g.segments)
    if not names:
        return {}
    ends = _build_ends(g)
    depth = {n: g.depths.get(n, 0.0) for n in names}
    if supported_links is None:
        supported_links = {}

    if haploid_coverage > 0:
        ref_cov = float(haploid_coverage)
    else:
        ref_cov = estimate_haploid_coverage(g)
    if ref_cov <= 1.0:  # unreliable coverage (`:34-38`)
        ref_cov = 1.0

    mult = {n: 0 for n in names}
    for n in names:  # haploid seeds (`:41-46`)
        if _is_simple(ends, n) and (round(depth[n] / ref_cov) <= 1 or ref_cov == 1):
            mult[n] = 1

    def exclusive(nbrs: list[tuple[str, int]]) -> bool:
        # every neighbor attaches to us through its only link on that end
        return all(len(ends[o][oe]) == 1 for o, oe in nbrs)

    # --- greedy propagation to fixpoint (`:50-113`) ---
    i = 0
    unchanged = 0
    while unchanged < len(names):
        n = names[i % len(names)]
        if mult[n] == 0:
            side = [0, 0]
            for end in (0, 1):
                nbrs = ends[n][end]
                if nbrs and all(mult[o] > 0 for o, _ in nbrs) and exclusive(nbrs):
                    side[end] = sum(mult[o] for o, _ in nbrs)
            m1, m2 = side
            confidence = m1 == m2  # two-sided agreement (`:66-68`)
            new = m1 if confidence else max(m1, m2)
            if new > 0 and (
                depth[n] / ref_cov > new / 1.5 or confidence or ref_cov == 1
            ):
                mult[n] = new
                unchanged = -1
            if new > 0:
                for end, m_end in ((0, m1), (1, m2)):
                    if m_end == new:
                        for o, oe in ends[n][end]:
                            _set_support(supported_links, (n, end), (o, oe), mult[o])
        else:
            # subtraction inference from a known trunk (`:89-109`)
            for end in (0, 1):
                nbrs = ends[n][end]
                if not nbrs or not exclusive(nbrs):
                    continue
                unknown = [(o, oe) for o, oe in nbrs if mult[o] == 0]
                if len(unknown) != 1:
                    continue
                new = mult[n] - sum(mult[o] for o, _ in nbrs)
                if new > 0 and (depth[n] / ref_cov >= new / 1.5 or ref_cov == 1):
                    o0, oe0 = unknown[0]
                    mult[o0] = new
                    unchanged = -1
                    _set_support(supported_links, (n, end), (o0, oe0), new)
        i += 1
        unchanged += 1

    def propagate(start: str) -> None:
        """Worklist version of the reference's recursive
        `propagate_multiplicity` (`determine_multiplicity.py:170-238`)."""
        work = [start]
        while work:
            c = work.pop()
            for end in (0, 1):
                for o, oe in ends[c][end]:
                    if mult[o] == 0:
                        far = ends[o][oe]
                        if far and all(mult[x] > 0 for x, _ in far) and exclusive(far):
                            mult[o] = sum(mult[x] for x, _ in far)
                            for x, xe in far:
                                _set_support(supported_links, (o, oe), (x, xe), mult[x])
                            work.append(o)
                    else:
                        far = ends[o][oe]
                        if not far or not exclusive(far):
                            continue
                        unknown = [(x, xe) for x, xe in far if mult[x] == 0]
                        if len(unknown) != 1:
                            continue
                        new = mult[o] - sum(mult[x] for x, _ in far)
                        x0, xe0 = unknown[0]
                        if new > 0 and (
                            depth[x0] / ref_cov >= new / 1.5 or ref_cov == 1
                        ):
                            mult[x0] = new
                            _set_support(supported_links, (o, oe), (x0, xe0), new)
                            work.append(x0)
            if ref_cov != 1:  # coverage-proportional spread (`:218-238`)
                for end in (0, 1):
                    nbrs = ends[c][end]
                    if not nbrs or not exclusive(nbrs):
                        continue
                    cov_tot = sum(depth[o] for o, _ in nbrs)
                    if cov_tot <= 0:
                        continue
                    for o, oe in nbrs:
                        if mult[o] != 0:
                            continue
                        new = max(
                            min(
                                round(mult[c] * depth[o] / cov_tot),
                                mult[c] - len(nbrs) + 1,
                            ),
                            1,
                        )
                        mult[o] = new
                        _set_support(supported_links, (c, end), (o, oe), new)
                        work.append(o)

    # --- coverage-based inference for leftovers (`:118-138`) ---
    if ref_cov != 1:
        for n in names:
            if mult[n] <= 0:
                continue
            for end in (0, 1):
                nbrs = ends[n][end]
                if not nbrs or not exclusive(nbrs):
                    continue
                cov_tot = sum(depth[o] for o, _ in nbrs)
                if cov_tot <= 0:
                    continue
                for o, oe in nbrs:
                    if mult[o] == 0:
                        v = round(mult[n] * depth[o] / cov_tot)
                        mult[o] = v
                        if v > 0:
                            _set_support(supported_links, (n, end), (o, oe), v)
                        propagate(o)

    # --- final: largest-first minimum multiplicity (`:140-162`) ---
    for n in sorted(names, key=lambda x: len(g.segments[x]), reverse=True):
        if mult[n] != 0:
            continue
        side_min = [0, 0]
        for end in (0, 1):
            for o, oe in ends[n][end]:
                if len(ends[o][oe]) == 1:
                    side_min[end] += mult[o]
        mult[n] = max(1, side_min[0], side_min[1])
        propagate(n)

    return {n: max(1, m) for n, m in mult.items()}


def write_ploidy(path: str, mult: dict[str, int]) -> None:
    """ploidy.txt: 'contig<TAB>multiplicity' (consumed by stage 4 as the
    haplotype cap, reference `separate_reads.cpp:1442-1458`)."""
    with open(path, "w") as f:
        for name, m in mult.items():
            f.write(f"{name}\t{m}\n")

"""Contig-space de Bruijn untangling from long-read paths.

Capability parity with GraphUnzip's DBG long-read engines
(`src/GraphUnzip/contig_DBG.py:373` `DBG_long_reads` and
the haploid-bridging ideas of `solve_with_long_reads.py:27`): read paths
over the assembly graph become strings of CONTIG-CHUNK symbols (contigs
split into ~1 kb chunks so partially-traversed long contigs still seed
k-mers), a de Bruijn graph over those symbols is iterated from k=1 up —
each round's unitigs feeding the next round as pseudo-reads, so evidence
chains ACROSS reads — and the final unitigs become the new assembly, with
(k-1)-symbol overlap links. This resolves orderings that no single read
path supports (the path-support untangler's blind spot: ambiguity longer
than any one read), by assembling maximal unambiguous walks instead of
duplicating per observed (left, right) pair.

Original implementation (oriented-kmer successor map; the reference uses
per-end neighbor sets and Python `hash()` for canonicalization, which is
process-salted — lexicographic canonicalization here is deterministic).

Copy of `hairsplitter_tpu/pipeline/dbg.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import revcomp
from ..io.gfa import AssemblyGraph, Link

Sym = tuple[str, int, int]  # (contig, chunk index, orient 1/0)
OKmer = tuple[tuple, bool]  # (canonical kmer tuple, traversed-reversed)


def _rc_syms(syms: tuple) -> tuple:
    return tuple((c, ci, 1 - o) for c, ci, o in reversed(syms))


def _rc(u: OKmer) -> OKmer:
    return (u[0], not u[1])


def _observed(u: OKmer) -> tuple:
    return _rc_syms(u[0]) if u[1] else u[0]


def paths_to_chunk_paths(
    g: AssemblyGraph, read_paths: dict[int, list[tuple[str, int]]], chunk: int = 1000
) -> list[list[Sym]]:
    """Read paths of (contig, orient) -> chunk-symbol paths (the reference's
    size_of_chunks=1000 expansion, `contig_DBG.py:381-401`)."""
    n_chunks = {name: len(seq) // chunk + 1 for name, seq in g.segments.items()}
    out: list[list[Sym]] = []
    for path in read_paths.values():
        syms: list[Sym] = []
        for name, o in path:
            nc = n_chunks.get(name)
            if nc is None:
                continue
            rng = range(nc) if o == 1 else range(nc - 1, -1, -1)
            syms.extend((name, ci, o) for ci in rng)
        if len(syms) >= 2:
            out.append(syms)
    return out


@dataclass
class Dbg:
    succ: dict[OKmer, set]
    abundance: dict[tuple, int]

    def nodes(self):
        return self.abundance.keys()


def build_dbg(k: int, paths: list[list[Sym]]) -> Dbg:
    succ: dict[OKmer, set] = {}
    abundance: dict[tuple, int] = {}
    for path in paths:
        prev: OKmer | None = None
        for s in range(len(path) - k + 1):
            fwd = tuple(path[s : s + k])
            rcv = _rc_syms(fwd)
            if fwd <= rcv:
                cur: OKmer = (fwd, False)
            else:
                cur = (rcv, True)
            abundance[cur[0]] = abundance.get(cur[0], 0) + 1
            succ.setdefault(cur, set())
            succ.setdefault(_rc(cur), set())
            if prev is not None:
                succ[prev].add(cur)
                succ[_rc(cur)].add(_rc(prev))
            prev = cur
    return Dbg(succ, abundance)


def _preds(dbg: Dbg, u: OKmer) -> list[OKmer]:
    return [_rc(x) for x in dbg.succ.get(_rc(u), ())]


def n_components(dbg: Dbg) -> int:
    """Connected components over canonical kmers (orientation-blind)."""
    parent: dict[tuple, tuple] = {K: K for K in dbg.abundance}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, vs in dbg.succ.items():
        for v in vs:
            ra, rb = find(u[0]), find(v[0])
            if ra != rb:
                parent[ra] = rb
    return len({find(K) for K in dbg.abundance})


def unitigs(dbg: Dbg, k: int) -> list[list[OKmer]]:
    """Maximal unbranched walks (every internal junction has unique
    successor AND unique predecessor), loop-safe."""
    out: list[list[OKmer]] = []
    visited: set[tuple] = set()
    for K in sorted(dbg.abundance):
        if K in visited:
            continue
        u: OKmer = (K, False)
        # walk back to the start of the unbranched stretch
        start = u
        seen = {K}
        while True:
            ps = _preds(dbg, start)
            if len(ps) != 1 or len(dbg.succ.get(ps[0], ())) != 1:
                break
            if ps[0][0] in seen:  # circular
                break
            seen.add(ps[0][0])
            start = ps[0]
        walk = [start]
        visited.add(start[0])
        cur = start
        while True:
            ss = dbg.succ.get(cur, ())
            if len(ss) != 1:
                break
            nxt = next(iter(ss))
            if len(_preds(dbg, nxt)) != 1 or nxt[0] in visited:
                break
            walk.append(nxt)
            visited.add(nxt[0])
            cur = nxt
        out.append(walk)
    return out


def _unitig_syms(walk: list[OKmer], k: int) -> list[Sym]:
    syms = list(_observed(walk[0]))
    for u in walk[1:]:
        syms.append(_observed(u)[k - 1])
    return syms


def dbg_unzip(
    g: AssemblyGraph,
    read_paths: dict[int, list[tuple[str, int]]],
    k_max: int = 9,
    chunk: int = 1000,
    min_abundance: int = 1,
) -> AssemblyGraph:
    """Iterated contig-space DBG (k = 1..k_max, each round's unitigs feed
    the next as pseudo-reads, `contig_DBG.py:414-448`); the final round's
    unitigs become the new assembly with (k-1)-symbol overlap links."""
    paths = paths_to_chunk_paths(g, read_paths, chunk)
    if not paths:
        return g
    extra: list[list[Sym]] = []
    dbg: Dbg | None = None
    k_used = 1
    base_comp = None
    for k in range(1, k_max + 1):
        cand = [p for p in paths + extra if len(p) >= k]
        if not cand:
            break
        d = build_dbg(k, cand)
        if min_abundance > 1:
            drop = {K for K, a in d.abundance.items() if a < min_abundance}
            if drop:
                for K in drop:
                    d.abundance.pop(K)
                    d.succ.pop((K, False), None)
                    d.succ.pop((K, True), None)
                for u in d.succ:
                    d.succ[u] = {v for v in d.succ[u] if v[0] in d.abundance}
        nc = n_components(d)
        if base_comp is None and k >= 2:
            base_comp = nc
        if base_comp is not None and nc > base_comp:
            # raising k beyond the reads' mutual overlap SHATTERS the graph
            # into disconnected read-sized pieces (the reference marches to
            # k=10 regardless, `contig_DBG.py:446-448`); keep the largest k
            # that preserves the k=2 connectivity
            break
        dbg, k_used = d, k
        extra = [_unitig_syms(w, k) for w in unitigs(d, k)]
    assert dbg is not None
    k = k_used

    walks = unitigs(dbg, k)
    out = AssemblyGraph()
    ends: dict[OKmer, tuple[str, str]] = {}  # oriented kmer -> (unitig, leaving orient)
    chunk_len = lambda c, ci: len(g.segments[c][ci * chunk : (ci + 1) * chunk])  # noqa: E731

    def sym_seq(sym: Sym) -> str:
        c, ci, o = sym
        piece = g.segments[c][ci * chunk : (ci + 1) * chunk]
        return piece if o == 1 else revcomp(piece)

    usyms: dict[str, list[Sym]] = {}
    for idx, walk in enumerate(walks):
        syms = _unitig_syms(walk, k)
        name = f"dbg_{idx}"
        seq = "".join(sym_seq(s) for s in syms)
        if not seq:
            continue
        ab = [dbg.abundance[u[0]] for u in walk]
        out.add_segment(name, seq, depth=sum(ab) / len(ab))
        usyms[name] = syms
        # leaving the unitig forward = through the last kmer; backward =
        # through the RC of the first
        ends[walk[-1]] = (name, "+")
        ends[_rc(walk[0])] = (name, "-")

    # remaining DBG edges between different unitig ends -> overlap links
    seen_links: set = set()
    for u, vs in dbg.succ.items():
        if u not in ends:
            continue
        n1, o1 = ends[u]
        for v in vs:
            got = ends.get(_rc(v))
            if got is None:
                continue
            n2, o2 = got
            # arriving INTO v: flip its leaving orientation
            o2 = "+" if o2 == "-" else "-"
            flip = {"+": "-", "-": "+"}
            key = min((n1, o1, n2, o2), (n2, flip[o2], n1, flip[o1]))
            if key in seen_links:
                continue
            seen_links.add(key)
            # overlap = the shared k-1 symbols' sequence length
            ov_syms = _observed(v)[: k - 1]
            ov = sum(chunk_len(c, ci) for c, ci, _o in ov_syms)
            out.add_link(Link(n1, o1, n2, o2, f"{ov}M"))
    out.dedupe_links()
    return out

"""Every host module that the port copied from the JAX package gives the same
results as its original: each case runs one function (or a small group that
belongs together) of `hairsplitter_tpu` and of `hairsplitter_tpu_torch` on
the same seeded numpy inputs. Native entry points are compared with both
packages' libraries loaded and with both switched off (the pure-Python
twins, as `HS_NATIVE=0` selects them).

Tolerance: none — integers, strings and bytes are compared exactly, and so
are the floats (both sides run the same arithmetic in the same order)."""

import dataclasses
import importlib
import os

import numpy as np
import pytest

from tests.torch_parity_data import strain_mix

JAX_PKG, PORT_PKG = "hairsplitter_tpu", "hairsplitter_tpu_torch"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(x):
    """Nested lists / tuples / dicts / dataclasses / arrays -> comparable form."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {repr(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    return x


@pytest.fixture(scope="module")
def mapped():
    """A small two-strain dataset and its alignments as plain field dicts,
    from which each package builds its own `Alignment` objects."""
    from hairsplitter_tpu_torch.core.mapping import map_reads

    haps, reads = strain_mix(6000, 2, 10, 2000, 0.08, seed=9)
    alns = map_reads({"c": haps[0]}, reads.seqs, device="cpu")
    assert len(alns) > 10
    fields = [{f.name: getattr(a, f.name) for f in dataclasses.fields(a)} for a in alns]
    return haps, reads, fields


def _alignments(pkg, mapped):
    Alignment = _mod(pkg, "core.datatypes").Alignment
    return [Alignment(**f) for f in mapped[2]]


def _read_codes(pkg, n=40, lo=200, hi=3000, seed=0):
    c = _mod(pkg, "constants")
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=20_000))
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(genome) - ln))
        r = genome[s : s + ln]
        reads.append(c.revcomp(r) if rng.random() < 0.5 else r)
    return genome, reads


# ---------------------------------------------------------------- the cases
# each takes the package name (and the shared dataset) and returns its result


def case_constants(pkg, mapped):
    c = _mod(pkg, "constants")
    rng = np.random.default_rng(1)
    s = "".join(rng.choice(list("ACGTNacgtn"), size=500))
    codes = c.encode_seq(s)
    return codes, c.decode_seq(codes), c.revcomp(s), c.revcomp_codes(codes), c.GAP, c.PAD, c.N_TRIMERS, c.TRIMER_ABSENT


def case_pow2_bucket(pkg, mapped):
    f = _mod(pkg, "utils.shapes").pow2_bucket
    return [f(n) for n in (0, 1, 31, 32, 33, 1000, 4096, 4097)] + [f(5, minimum=8), f(9, minimum=8)]


def case_minimizers(pkg, mapped):
    s = _mod(pkg, "core.seeding")
    genome, _ = _read_codes(pkg)
    codes = _mod(pkg, "constants").encode_seq(genome[:6000] + "NNN" + genome[6000:7000])
    return [s.minimizers(codes, k, w, hpc=hpc) for k, w, hpc in ((15, 10, False), (11, 6, False), (15, 10, True))]


def case_find_chains_batch(pkg, mapped):
    s = _mod(pkg, "core.seeding")
    enc = _mod(pkg, "constants").encode_seq
    genome, reads = _read_codes(pkg)
    index = s.MinimizerIndex.build({"g": enc(genome), "h": enc(genome[5000:9000])}, k=15, w=10, max_occ=64)
    chains = s.find_chains_batch(index, [enc(r) for r in reads], min_anchors=4)
    one = s.find_chains(index, enc(reads[0]))
    return chains, one


def case_select_pins_native(pkg, mapped):
    nat = _mod(pkg, "native")
    rng = np.random.default_rng(3)
    out = []
    for _ in range(10):
        n = int(rng.integers(2, 120))
        qa = np.cumsum(rng.integers(1, 700, n)).astype(np.int64)
        ta = np.maximum.accumulate((qa + rng.integers(-40, 40, n)).astype(np.int64) + np.arange(n))
        keep = np.ones(n, bool)
        keep[1:] = (np.diff(qa) > 0) & (np.diff(ta) > 0)
        out.append(nat.select_pins(qa[keep], ta[keep], 256, 319, 55))
    return out


def case_cigar(pkg, mapped):
    c = _mod(pkg, "io.cigar")
    rng = np.random.default_rng(4)
    expanded = np.repeat(rng.integers(0, 4, 300), rng.integers(1, 9, 300)).astype(np.int8)
    ops, lens = c.compress_cigar(expanded)
    s = c.cigar_to_string(ops, lens)
    return (ops, lens, s, c.parse_cigar(s), c.expand_cigar(ops, lens), c.cigar_query_len(ops, lens),
            c.cigar_target_len(ops, lens), c.merge_cigars([(ops[:50], lens[:50]), (ops[50:], lens[50:])]),
            c.compress_cigar_runs(np.repeat(ops, 2), np.repeat(lens, 2)))


def case_gfa(pkg, mapped, tmp_path):
    g = _mod(pkg, "io.gfa")
    rng = np.random.default_rng(5)
    seqs = {f"s{i}": "".join(rng.choice(list("ACGT"), size=int(rng.integers(50, 900)))) for i in range(6)}
    graph = g.fasta_to_gfa(seqs)
    for a, b, oa, ob in (("s0", "s1", "+", "+"), ("s1", "s2", "+", "-"), ("s2", "s3", "-", "+"), ("s0", "s4", "-", "-")):
        graph.add_link(g.Link(a, oa, b, ob, "0M"))
    path = str(tmp_path / f"{pkg}.gfa")
    g.write_gfa(graph, path)
    back = g.parse_gfa(path)
    cut = g.cut_assembly(back, max_len=400)
    with open(path, "rb") as f:
        raw = f.read()
    return raw, back.normalized(), cut.normalized(), g.gfa_to_fasta(cut)


def case_fasta(pkg, mapped, tmp_path):
    fa = _mod(pkg, "io.fasta")
    rng = np.random.default_rng(6)
    seqs = {f"r{i}": "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 400)))) for i in range(20)}
    path = str(tmp_path / f"{pkg}.fa")
    fa.write_fasta(path, seqs, width=60)
    store = fa.ReadStore(path)
    lazy = fa.LazyReadSeqs(store)
    with open(path, "rb") as f:
        raw = f.read()
    return raw, fa.read_fasta(path), len(store), store.total_bases(), [store.get_seq(i) for i in range(len(store))], \
        [lazy[i] for i in (3, 0, 19)], store.index_of("r7")


def case_sam(pkg, mapped, tmp_path):
    sam = _mod(pkg, "io.sam")
    haps, reads, _ = mapped
    alns = _alignments(pkg, mapped)
    names = dict(enumerate(reads.names))
    path = str(tmp_path / f"{pkg}.sam")
    sam.write_sam(path, alns, {"c": len(haps[0])}, names, dict(enumerate(reads.seqs)))
    back = sam.parse_sam(path, {n: i for i, n in names.items()})
    with open(path, "rb") as f:
        raw = f.read()
    return raw, back


def case_alignment_datatype(pkg, mapped):
    alns = _alignments(pkg, mapped)
    return [(a.cigar, a.aligned_query_span(), a.aligned_target_span()) for a in alns]


def case_build_window_blocks(pkg, mapped):
    p = _mod(pkg, "pipeline.pileup")
    enc = _mod(pkg, "constants").encode_seq
    haps, reads, _ = mapped
    alns = _alignments(pkg, mapped)
    oriented = [p.orient_read(enc(reads.seqs[a.read_idx]), a.strand) for a in alns]
    blocks = p.build_window_blocks(len(haps[0]), alns, oriented)
    full = [p.alignment_cells_full(a, oc) for a, oc in zip(alns[:5], oriented[:5])]
    return blocks, full


def case_greedy_assemble(pkg, mapped):
    asm = _mod(pkg, "core.assembler")
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    reads = {f"r{i}": genome[s : s + 1500] for i, s in enumerate(range(0, 4600, 450))}
    return asm.greedy_assemble(reads, min_overlap=300, min_len=1000)


def case_determine_multiplicity(pkg, mapped):
    g = _mod(pkg, "io.gfa")
    m = _mod(pkg, "pipeline.multiplicity")
    graph = g.AssemblyGraph()
    for name, ln, depth in (("a", 5000, 30.0), ("b", 3000, 15.0), ("c", 3000, 16.0), ("d", 6000, 31.0),
                            ("e", 800, 60.0), ("f", 4000, 29.0)):
        graph.add_segment(name, "A" * ln, depth=depth)
    for a, b in (("a", "b"), ("a", "c"), ("b", "d"), ("c", "d"), ("d", "e"), ("e", "f")):
        graph.add_link(g.Link(a, "+", b, "+", "0M"))
    links = {}
    mult = m.determine_multiplicity(graph, supported_links=links)
    return mult, sorted(repr(k) for k in links), m.estimate_haploid_coverage(graph)


def case_check_backbone(pkg, mapped):
    t = _mod(pkg, "ops.triage")
    haps, reads, _ = mapped
    alns = _alignments(pkg, mapped)
    rlens = [len(reads.seqs[a.read_idx]) for a in alns]
    L = len(haps[0])
    codes = [t.check_backbone(alns, rlens, s, e) for s, e in ((0, L - 1), (1000, 3000), (2500, 5900))]
    return codes, t.indel_region(alns, 0, L - 1), (t.BACKBONE_GOOD, t.BACKBONE_BIG_INDELS, t.BACKBONE_BREAKPOINTS)


def case_alternative_and_splice_backbone(pkg, mapped):
    t = _mod(pkg, "ops.triage")
    p = _mod(pkg, "pipeline.pileup")
    enc = _mod(pkg, "constants").encode_seq
    haps, reads, _ = mapped
    alns = _alignments(pkg, mapped)
    cells, inss = [], []
    for a in alns:
        oriented = p.orient_read(enc(reads.seqs[a.read_idx]), a.strand)
        tpos, tri, it, ic = p.alignment_cells_full(a, oriented)
        cells.append((tpos, (np.asarray(tri, np.int16) // 25).astype(np.int8)))
        inss.append((it, ic))
    alt = t.alternative_backbone(enc(haps[0]), 0, cells, inss)
    spliced = t.splice_backbone(enc(haps[0][1000:4000]), 1000, alns, reads.seqs, (1500, 2500))
    return alt, spliced


def case_poa_consensus_codes(pkg, mapped):
    poa = _mod(pkg, "ops.poa")
    rng = np.random.default_rng(8)
    out = []
    for _ in range(4):
        truth = rng.integers(0, 4, 300).astype(np.int8)
        layers = []
        for _ in range(9):
            keep = rng.random(truth.size) > 0.04
            layer = truth[keep].copy()
            sub = rng.random(layer.size) < 0.04
            layer[sub] = rng.integers(0, 4, int(sub.sum()))
            layers.append(layer)
        out.append(poa.poa_consensus_codes(layers, min_cov=3))
    return out, poa.poa_available(), (poa.POA_MATCH, poa.POA_MISMATCH, poa.POA_GAP, poa.MIN_FRAG_FRACTION)


def case_pin_anchors_and_window_cuts(pkg, mapped):
    poa = _mod(pkg, "ops.poa")
    haps, reads, _ = mapped
    alns = _alignments(pkg, mapped)
    L = len(haps[0])
    return [(poa._pin_anchors(a, len(reads.seqs[a.read_idx]), 0, L, L + 7),
             poa._window_cuts(a, len(reads.seqs[a.read_idx]), 500, L)) for a in alns[:8]]


def case_unzip_graph_helpers(pkg, mapped):
    g = _mod(pkg, "io.gfa")
    u = _mod(pkg, "pipeline.unzip")
    rng = np.random.default_rng(10)
    graph = g.AssemblyGraph()
    for name in ("l1", "l2", "mid", "r1", "r2", "tip", "tail"):
        graph.add_segment(name, "".join(rng.choice(list("ACGT"), size=1500 if name != "tip" else 200)))
    for a, b in (("l1", "mid"), ("l2", "mid"), ("mid", "r1"), ("mid", "r2"), ("r1", "tip"), ("r1", "tail")):
        graph.add_link(g.Link(a, "+", b, "+", "0M"))
    paths = {}
    for i in range(6):
        paths[i] = [("l1", 1), ("mid", 1), ("r1", 1), ("tail", 1)] if i % 2 else [("l2", 1), ("mid", 1), ("r2", 1)]
    paths[6] = [("r2", 0), ("mid", 0), ("l2", 0)]
    support = u.count_link_support(paths)
    removed = u.remove_unsupported_links(graph, support)
    copy_of = u.duplicate_contigs(graph, paths)
    tips = u.remove_tips(graph)
    composition = u.merge_linear_chains(graph)
    return sorted(repr(k) for k in support.items()), removed, copy_of, tips, composition, graph.normalized(), paths, u.DUMMY


def case_sim(pkg, mapped):
    s = _mod(pkg, "utils.sim")
    rng = np.random.default_rng(11)
    haps = s.make_haplotypes(5000, 3, 0.01, rng)
    reads = s.simulate_reads(haps, coverage=4, read_len=1200, rng=rng, sub_rate=0.03, ins_rate=0.01,
                             del_rate=0.01, homopolymer_bias=1.0)
    return haps, reads, s.random_genome(100, rng), s.mutate(haps[0][:500], 0.05, rng)


def case_evaluate_phasing(pkg, mapped):
    ev = _mod(pkg, "utils.evaluate")
    haps = mapped[0]
    contigs = {"x": haps[0][:4000] + haps[1][4000:], "y": haps[1], "short": haps[0][:500]}
    return ev.evaluate_phasing(contigs, haps)


def case_native_lis_graph_cw_merge(pkg, mapped):
    nat = _mod(pkg, "native")
    rng = np.random.default_rng(12)
    lis = [nat.lis_monotonic(rng.integers(0, 1000, int(rng.integers(1, 60))).astype(np.int64)) for _ in range(10)]
    n = 40
    A = (rng.random((n, 12)) < 0.3).astype(np.float32)
    R = ((rng.random((n, 12)) < 0.6) & (A == 0)).astype(np.float32)
    sim = (3 * A @ A.T + R @ R.T).astype(np.int32)
    diff = (A @ R.T + R @ A.T).astype(np.int32)
    np.fill_diagonal(sim, 0)
    np.fill_diagonal(diff, 0)
    mask = rng.random(n) < 0.9
    adj = nat.create_read_graph(sim, diff, mask, 0.05)
    adj2 = (rng.random((n, n)) < 0.15).astype(np.int8)
    adj2 = np.maximum(adj2, adj2.T)
    np.fill_diagonal(adj2, 0)
    labels = nat.chinese_whispers(adj2, np.arange(n), mask)
    lab = rng.integers(0, 6, n).astype(np.int64)
    lab[~mask] = -2
    merged = nat.merge_close_clusters(adj2, lab, mask.astype(np.uint8))
    return lis, adj, labels, merged


def case_native_seeding_entries(pkg, mapped):
    nat = _mod(pkg, "native")
    enc = _mod(pkg, "constants").encode_seq
    genome, _ = _read_codes(pkg)
    mins = nat.minimizers(enc(genome[:5000]), 15, 10)
    rng = np.random.default_rng(13)
    t = np.sort(rng.integers(0, 20000, 300)).astype(np.int64)
    q = (t - 1000 + rng.integers(-600, 600, 300)).astype(np.int64)
    sweep = nat.chain_sweep(q, t, 5000, 500)
    ih = np.sort(rng.integers(0, 5000, 4000).astype(np.uint64))
    look = nat.index_lookup(ih, rng.integers(0, 5000, 500).astype(np.uint64), 8)
    return mins, sweep, look


def case_native_dp_poa_expand(pkg, mapped):
    from chip_smoke import edge_jobs, mode_pattern, random_jobs
    from hairsplitter_tpu_torch.ops.align import BandSpec

    nat = _mod(pkg, "native")
    spec = BandSpec(chunk=64, band=128)
    q, ql, t, tl = (np.concatenate(p) for p in zip(edge_jobs(spec), random_jobs(np.random.default_rng(14), 64, spec)))
    keep = ql <= spec.chunk  # lengths the packer can make
    q, ql, t, tl = q[keep], ql[keep], t[keep], tl[keep]
    modes = mode_pattern("alternating", q.shape[0])
    tb = nat.banded_align_tb(q, ql, t, tl, modes, spec.band)
    rng = np.random.default_rng(15)
    windows = [[rng.integers(0, 4, int(rng.integers(80, 120))).astype(np.int8) for _ in range(6)] for _ in range(5)]
    one = nat.poa_consensus(windows[0], min_cov=2)
    batch = nat.poa_consensus_batch(windows, min_covs=[2] * 5, n_threads=2)
    # expand_rows on a fused buffer of the plain composition
    import torch

    from hairsplitter_tpu_torch.ops.align_device import myers_fused_plain

    fused = myers_fused_plain(*(torch.from_numpy(x) for x in (q, ql, t, tl, modes)), spec).numpy()
    meta = fused[:, :16].copy().view(np.int32)
    rows = nat.expand_rows(fused[:, 16:], meta, q, t, spec.dl)
    return tb, one, batch, rows


def case_pad_axis(pkg, mapped):
    f = _mod(pkg, "utils.shapes").pad_axis
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    return [f(a, 0, 5, 0), f(a, 1, 8, -1), f(a, 0, 3, 9), f(a, 1, 2, 9), f(np.arange(3.0), 0, 256, 0.0)]


def case_gaf(pkg, mapped, tmp_path):
    gaf = _mod(pkg, "io.gaf")
    path = str(tmp_path / f"{pkg}.gaf")
    rows = [
        ("r0", 1000, 0, 1000, ">a>b<c", "id:f:0.95"), ("r1", 1000, 0, 300, ">a", "id:f:0.99"),
        ("r2", 2000, 100, 1900, "<c<b", "id:f:0.80"), ("r3", 500, 0, 100, ">b>c", "id:f:0.97"),
        ("r4", 0, 0, 10, ">a>c", "id:f:0.97"),
    ]
    with open(path, "w") as f:
        f.write("short\tline\n")
        for name, ql, qs, qe, p, tag in rows:
            f.write(f"{name}\t{ql}\t{qs}\t{qe}\t+\t{p}\t3000\t0\t3000\t950\t1000\t60\t{tag}\n")
    return (gaf.parse_gaf_path(">x<y>z_1"), gaf.parse_gaf(path), gaf.parse_gaf(path, similarity_threshold=0.9),
            gaf.parse_gaf(path, whole_mapping_threshold=0.5), gaf.parse_gaf(path, min_contigs=1))


def case_sim2(pkg, mapped, tmp_path):
    s2 = _mod(pkg, "utils.sim2")
    haps = [h[:4000] for h in mapped[0]]
    reads = s2.generate(haps, coverage=5, cfg=s2.Sim2Config(mean_len=1200, min_len=300, junk_rate=0.05), seed=3,
                        abundances=[1.0, 0.5])
    path = str(tmp_path / f"{pkg}_sim2.fa")
    s2.write_fasta(path, reads)
    with open(path, "rb") as f:
        raw = f.read()
    return reads, raw, s2.generate(haps[:1], coverage=2, seed=4), list(s2._hp_runs("AAACGGTTTTT"))


def _diamond(pkg, mid=("S",), depth_mid=20.0):
    g = _mod(pkg, "io.gfa")
    graph = g.AssemblyGraph()
    for n in "ABCD":
        graph.add_segment(n, "ACGT" * 500, depth=10)
    for m in mid:
        graph.add_segment(m, "TTTT" * 500, depth=depth_mid)
    for a, b in [("A", mid[0]), ("C", mid[0]), (mid[-1], "B"), (mid[-1], "D")] + list(zip(mid[:-1], mid[1:])):
        graph.add_link(g.Link(a, "+", b, "+"))
    return graph


def case_duplicate_multiway(pkg, mapped):
    u = _mod(pkg, "pipeline.unzip")
    out = []
    for depth_mid, depth_b in ((20.0, 10.0), (5.0, 10.0), (20.0, 1.0)):
        graph = _diamond(pkg, depth_mid=depth_mid)
        graph.depths["B"] = depth_b
        out.append((u.duplicate_multiway(graph), graph.normalized(), dict(graph.depths)))
    return out


def case_dbg(pkg, mapped):
    g = _mod(pkg, "io.gfa")
    d = _mod(pkg, "pipeline.dbg")
    rng = np.random.default_rng(0)
    graph = g.AssemblyGraph()
    names = ["A", "B", "R1", "R2", "R3", "C", "D"]
    for n in names:
        graph.add_segment(n, "".join(rng.choice(list("ACGT"), size=2000)), depth=20.0 if n[0] == "R" else 10.0)
    for a, b in (("A", "R1"), ("B", "R1"), ("R1", "R2"), ("R2", "R3"), ("R3", "C"), ("R3", "D")):
        graph.add_link(g.Link(a, "+", b, "+"))
    paths = {}
    for i, p in enumerate(3 * [["A", "R1", "R2"], ["B", "R1", "R2"], ["R1", "R2", "R3"], ["R2", "R3", "C"],
                               ["R2", "R3", "D"]]):
        paths[i] = [(n, 1) for n in p] if i % 4 else [(n, 0) for n in reversed(p)]
    chunked = d.paths_to_chunk_paths(graph, paths, 1000)
    dbg2 = d.build_dbg(2, chunked)
    out = d.dbg_unzip(graph, paths, k_max=9, chunk=1000)
    return (chunked, sorted(dbg2.abundance.items()), d.n_components(dbg2), d.unitigs(dbg2, 2),
            list(out.segments.items()), [(l.name1, l.orient1, l.name2, l.orient2, l.cigar) for l in out.links],
            dict(out.depths))


def case_hic(pkg, mapped):
    h = _mod(pkg, "pipeline.hic")
    graph = _diamond(pkg)
    pairs = [("A", "B")] * 30 + [("C", "D")] * 30 + [("A", "D")] * 2 + [("A", "A"), ("A", "nope")]
    im = h.interaction_matrix_from_pairs(list(graph.segments), pairs)
    resolved = h.untangle_with_interactions(graph, im)
    weak = _diamond(pkg)
    none = h.untangle_with_interactions(weak, h.interaction_matrix_from_pairs(list(weak.segments), pairs[:2]))
    return im.names, im.m, resolved, graph.normalized(), dict(graph.depths), none, weak.normalized()


def case_hic_solve(pkg, mapped):
    h = _mod(pkg, "pipeline.hic")
    hs = _mod(pkg, "pipeline.hic_solve")
    m = np.array([[0, 8, 1], [8, 0, 3], [1, 3, 0]], dtype=float)
    graph = _diamond(pkg, mid=("S", "T"))
    names = list(graph.segments)
    pairs = [("A", "B")] * 30 + [("C", "D")] * 30 + [("A", "D")] * 2
    rep = hs.solve_with_interactions(graph, names, h.interaction_matrix_from_pairs(names, pairs).m)
    quiet = _diamond(pkg)
    rep0 = hs.solve_with_interactions(quiet, list(quiet.segments), np.zeros((5, 5)))
    return (hs.sinkhorn_normalize(m), rep, graph.normalized(), dict(graph.depths), rep0, quiet.normalized(),
            hs.find_anchor_contigs(_diamond(pkg), confident_coverage=True),
            hs.find_anchor_contigs(_diamond(pkg), confident_coverage=False))


def case_shard_items(pkg, mapped):
    d = _mod(pkg, "parallel.distributed")
    rng = np.random.default_rng(3)
    out = []
    for n in (1, 2, 7, 30):
        # few distinct sizes: ties in size and in load
        sizes = {f"ctg{int(i)}": int(rng.integers(1, 5)) * 500 for i in rng.permutation(n)}
        out.append([[d.shard_items(sizes, nproc, p) for p in range(nproc)] for nproc in (1, 2, 3, 4)])
    return out


def case_graph_wire(pkg, mapped):
    """`_graph_to_wire` / `_graph_from_wire` on a graph with links, depths and
    tags: the wire form, its pickle, and the graph that comes back."""
    import pickle

    o = _mod(pkg, "pipeline.orchestrate")
    graph = _diamond(pkg, mid=("S", "T"))
    graph.tags["A"] = ["LN:i:2000", "dp:f:10.0"]
    graph.tags["T"] = ["xx:Z:tag"]
    graph.add_link(_mod(pkg, "io.gfa").Link("D", "-", "A", "+", "5M"))
    wire = o._graph_to_wire(graph)
    back = o._graph_from_wire(pickle.loads(pickle.dumps(wire)))
    assert back is not graph and back.normalized() == graph.normalized()
    return (wire, pickle.dumps(wire), list(back.segments.items()), dict(back.depths), dict(back.tags),
            [(l.name1, l.orient1, l.name2, l.orient2, l.cigar) for l in back.links], back.normalized())


def case_mesh_examples(pkg, mapped):
    m = _mod(pkg, "parallel.mesh")
    spec = _mod(pkg, "ops.align").BandSpec
    return (m.make_phase_example(), m.make_phase_example(C=2, Rr=24, Pp=96, S=16, K=3, seed=4),
            m.make_map_example(48, spec(chunk=64, band=32)), m.make_map_example(8, spec(), seed=2, err=0.1))


CASES = [
    case_constants, case_pow2_bucket, case_minimizers, case_find_chains_batch, case_select_pins_native,
    case_cigar, case_gfa, case_fasta, case_sam, case_alignment_datatype, case_build_window_blocks,
    case_greedy_assemble, case_determine_multiplicity, case_check_backbone,
    case_alternative_and_splice_backbone, case_poa_consensus_codes, case_pin_anchors_and_window_cuts,
    case_unzip_graph_helpers, case_sim, case_evaluate_phasing, case_native_lis_graph_cw_merge,
    case_native_seeding_entries, case_native_dp_poa_expand, case_pad_axis, case_gaf, case_sim2,
    case_duplicate_multiway, case_dbg, case_hic, case_hic_solve, case_shard_items, case_graph_wire,
    case_mesh_examples,
]
# cases whose functions reach the native library: run with it and without it
USES_NATIVE = {
    case_minimizers, case_find_chains_batch, case_select_pins_native, case_greedy_assemble,
    case_poa_consensus_codes, case_native_lis_graph_cw_merge, case_native_seeding_entries,
    case_native_dp_poa_expand,
}
PARAMS = [(c, True) for c in CASES] + [(c, False) for c in CASES if c in USES_NATIVE]


@pytest.fixture
def native_switch(monkeypatch):
    """Switches both packages' native libraries on (loaded) or off (the state
    `HS_NATIVE=0` leaves: `get_lib()` returns None, callers take their
    Python twins)."""
    def switch(on: bool):
        for pkg in (JAX_PKG, PORT_PKG):
            nat = _mod(pkg, "native")
            if on:
                assert nat.get_lib() is not None, f"{pkg}: the native library did not build"
            else:
                monkeypatch.setattr(nat, "_LIB", None)
                monkeypatch.setattr(nat, "_TRIED", True)
                assert nat.get_lib() is None
    return switch


@pytest.mark.parametrize(
    "case,native_on", PARAMS, ids=[f"{c.__name__[5:]}-{'native' if on else 'python'}" for c, on in PARAMS]
)
def test_copy_equals_original(case, native_on, native_switch, mapped, tmp_path):
    native_switch(native_on)
    args = (mapped, tmp_path) if "tmp_path" in case.__code__.co_varnames[: case.__code__.co_argcount] else (mapped,)
    ref = _plain(case(JAX_PKG, *args))
    got = _plain(case(PORT_PKG, *args))
    assert got == ref


def test_port_builds_its_own_native_library():
    from hairsplitter_tpu_torch import native
    from hairsplitter_tpu_torch.ops import _build

    assert native.get_lib() is not None
    so = _build.build_native()
    assert os.path.dirname(so) == _build.BUILD_DIR and os.path.basename(so).startswith("libhs_native_")
    assert native.get_lib()._name == so
    with open(os.path.join(_build.CSRC_DIR, "hs_native.cpp"), "rb") as f:
        assert len(f.read()) > 10_000

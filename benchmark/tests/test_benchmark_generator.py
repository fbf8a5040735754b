"""The traffic generator keeps its truth and its rates."""

import numpy as np

from benchmark.traffic import generate as G

BASE = dict(contig_len=20_000, divergence=0.01, first_is_backbone=True, assembly="strain0", read_len=3000,
            sub_rate=0.06, ins_rate=0.02, del_rate=0.02, uniform_edges=True, strains_per_contig=[2, 3],
            coverage=20)


def test_same_seed_same_job_and_another_seed_another():
    a, b, c = G.make_job(BASE, 5), G.make_job(BASE, 5), G.make_job(BASE, 6)
    assert len(a.reads.seqs) == len(b.reads.seqs)
    assert all(np.array_equal(x, y) for x, y in zip(a.reads.seqs, b.reads.seqs))
    assert not np.array_equal(a.contigs[0].assembly, c.contigs[0].assembly)


def test_large_seeds():
    job = G.make_job(dict(BASE, contig_len=8000, strains_per_contig=[1]), [2**40 + 3, 0, 1])
    assert job.reads.bases > 0


def test_strain_truth():
    job = G.make_job(BASE, 1)
    for contig, ns in zip(job.contigs, BASE["strains_per_contig"]):
        assert len(contig.strains) == ns and np.array_equal(contig.strains[0], contig.assembly)
        differs = np.zeros(contig.assembly.size, dtype=bool)
        for s in contig.strains[1:]:
            d = (s != contig.assembly).mean()
            assert 0.009 <= d <= 0.011  # the divergence
            differs |= s != contig.assembly
        assert np.array_equal(np.flatnonzero(differs), contig.variant_positions)


def test_backbone_assembly_and_full_reads():
    p = dict(BASE, contig_len=5000, first_is_backbone=False, assembly="backbone", read_len="full",
             reads_per_contig=100, strains_per_contig=[5], divergence=0.02,
             abundances=[0.3, 0.25, 0.2, 0.15, 0.1], uniform_edges=False)
    job = G.make_job(p, 2)
    r = job.reads
    assert np.bincount(r.strain).tolist() == [30, 25, 20, 15, 10]
    assert (r.start == 0).all() and (r.end == 5000).all()
    c = job.contigs[0]
    assert all(0.019 <= (s != c.assembly).mean() <= 0.021 for s in c.strains)


def _error_rates(job):
    """Edit counts of each non-chimeric read against its fragment, by a
    plain DP on a few reads."""
    from benchmark.reference.align import semiglobal_costs

    r = job.reads
    idx = [i for i in range(len(r.seqs)) if not r.chimeric[i]][:12]
    q = [r.seqs[i] if r.strand[i] == 1 else (3 - r.seqs[i][::-1]).astype(np.int8) for i in idx]
    t = [job.contigs[r.contig[i]].strains[r.strain[i]][r.start[i] : r.end[i]] for i in idx]
    costs = semiglobal_costs(q, t, [0] * len(idx), band=96)
    return costs.sum() / sum(x.size for x in t)


def test_read_truth_and_error_rate():
    job = G.make_job(BASE, 3)
    r = job.reads
    assert len(r.seqs) == r.contig.size == r.strain.size == r.start.size == r.end.size
    assert ((r.end - r.start) <= 3000).all() and (r.start >= 0).all()
    for c in range(2):
        assert (r.end[r.contig == c] <= job.contigs[c].assembly.size).all()
    # coverage: ~20x of each contig, the strains at equal abundance
    for c, ns in enumerate(BASE["strains_per_contig"]):
        bp = (r.end - r.start)[r.contig == c].sum()
        assert 18 <= bp / 20_000 <= 22
        counts = np.bincount(r.strain[r.contig == c], minlength=ns)
        assert counts.max() - counts.min() <= 0.2 * counts.mean()
    # the sequenced bases: ~10% edits (6/2/2 substitutions/insertions/deletions)
    assert 0.08 <= _error_rates(job) <= 0.105
    assert 0.4 <= r.strand.mean() <= 0.6
    assert (r.start == 0).sum() >= 5  # uniform edges: reads truncated at the contig start


def test_apply_errors_rates_and_homopolymer_bias():
    rng = np.random.default_rng(0)
    n = 200_000
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    breaks = np.array([0, n // 2])
    out, nb = G.apply_errors(codes, breaks, 0.0, 0.05, 0.0, 0.0, np.random.default_rng(1))
    assert nb[0] == 0 and 0.045 <= out.size / n - 1 <= 0.055
    out, _ = G.apply_errors(codes, breaks, 0.0, 0.0, 0.05, 0.0, np.random.default_rng(1))
    assert 0.045 <= 1 - out.size / n <= 0.055
    runs = np.repeat(np.arange(n // 10) % 4, 10).astype(np.int8)  # homopolymers of 10
    plain, _ = G.apply_errors(runs, np.array([0]), 0.0, 0.0, 0.02, 0.0, np.random.default_rng(2))
    biased, _ = G.apply_errors(runs, np.array([0]), 0.0, 0.0, 0.02, 1.0, np.random.default_rng(2))
    assert (n - biased.size) > 3 * (n - plain.size)


def test_run_position_breaks_at_fragments():
    codes = np.array([0, 0, 0, 1, 1, 1], dtype=np.int8)
    assert G.run_position(codes, np.array([0, 2])).tolist() == [1, 2, 1, 1, 2, 3]


def test_chimeras():
    p = dict(BASE, chimera_rate=0.5, strains_per_contig=[2])
    job = G.make_job(p, 4)
    share = job.reads.chimeric.mean()
    assert 0.4 <= share <= 0.6
    assert all(job.reads.seqs[i].size >= 1000 for i in np.flatnonzero(job.reads.chimeric))


def test_write_job(tmp_path):
    p = dict(BASE, strains_per_contig=[1], contig_len=6000)
    job = G.make_job(p, 9)
    G.write_job(job, str(tmp_path))
    text = open(job.paths["reads"]).read().split("\n")
    assert text[0] == ">r0" and len(text[1]) == job.reads.seqs[0].size
    assert open(job.paths["assembly"]).read().startswith(">sp0\n")

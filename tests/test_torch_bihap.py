"""Parity of the port's spectral phaser (`hairsplitter_tpu_torch/models/
bihap.py`) with the JAX package's.

The allele columns are made from a seed with numpy (those of
`tests/test_hic_bihap.py:test_spectral_phase_two_haplotypes`, and a seeded
three-haplotype matrix). `allele_matrix` and the solution file are compared
exactly. The labels come out of two different SVD implementations, so they
are compared as partitions of the reads (a singular vector's free sign only
renames the labels); on these inputs, whose spectral gap is clear, the
partitions are equal, no tolerance."""

import numpy as np
import pytest

from hairsplitter_tpu.core.mapping import map_reads as jax_map_reads
from hairsplitter_tpu.models import bihap as JB
from hairsplitter_tpu.pipeline.call_variants import SparseColumn as JaxSparseColumn
from hairsplitter_tpu.pipeline.call_variants import call_variants_for_contig
from hairsplitter_tpu.utils.sim import make_haplotypes, mutate, simulate_reads
from hairsplitter_tpu_torch.models import bihap as TB
from hairsplitter_tpu_torch.pipeline.call_variants import SparseColumn
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _partition(labels: np.ndarray) -> set[frozenset]:
    return {frozenset(np.nonzero(labels == g)[0].tolist()) for g in set(labels.tolist())}


def _columns(cls, specs):
    return [cls(**spec) for spec in specs]


def _specs(columns):
    import dataclasses

    return [{f.name: getattr(c, f.name) for f in dataclasses.fields(c)} for c in columns]


@pytest.fixture(scope="module")
def two_haplotype_columns():
    rng = np.random.default_rng(0)
    consensus = make_haplotypes(3000, 1, 0.001, rng)[0]
    hap2, _ = mutate(consensus, 0.01, rng)
    sim = simulate_reads([consensus, hap2], coverage=20, read_len=3000, rng=rng, sub_rate=0.01)
    alns = jax_map_reads({"ctg": consensus}, sim.seqs)
    cv = call_variants_for_contig("ctg", consensus, alns, dict(enumerate(sim.seqs)))
    truth = np.array([sim.hap_of_read[a.read_idx] for a in alns])
    return _specs(cv.columns), len(alns), truth


def _three_haplotype_specs(seed=4, n_reads=90, n_snps=60):
    """Three haplotypes of 30 reads each; every SNP separates one haplotype
    from the other two; 5% of the cells are flipped and 10% are absent."""
    rng = np.random.default_rng(seed)
    hap = np.repeat(np.arange(3), n_reads // 3)
    specs = []
    for s in range(n_snps):
        alt = hap == s % 3
        flip = rng.random(n_reads) < 0.05
        present = rng.random(n_reads) > 0.10
        alleles = np.where(alt ^ flip, 7, 3).astype(np.int16)
        specs.append(dict(pos=100 * s, rows=np.nonzero(present)[0].astype(np.int64),
                          alleles=alleles[present], top1=3, top2=7))
    return specs, n_reads, hap


def test_allele_matrix_equals_jax_exactly(two_haplotype_columns):
    specs, n, _ = two_haplotype_columns
    for sp, nr in ((specs, n), _three_haplotype_specs()[:2]):
        ref = JB.allele_matrix(_columns(JaxSparseColumn, sp), nr)
        got = TB.allele_matrix(_columns(SparseColumn, sp), nr)
        assert got.dtype == ref.dtype == np.float32 and got.shape == (nr, len(sp))
        np.testing.assert_array_equal(got, ref)
        assert set(np.unique(got)) <= {-1.0, 0.0, 1.0} and (got != 0).any()


@pytest.mark.parametrize("n_haplotypes", [2, 0])
def test_spectral_phase_two_haplotypes_equals_jax(two_haplotype_columns, n_haplotypes):
    specs, n, truth = two_haplotype_columns
    ref = JB.spectral_phase(_columns(JaxSparseColumn, specs), n, n_haplotypes=n_haplotypes)
    got = TB.spectral_phase(_columns(SparseColumn, specs), n, n_haplotypes=n_haplotypes, device="cpu")
    assert got.dtype == ref.dtype == np.int64 and got.shape == (n,)
    assert _partition(got) == _partition(ref)
    present = got >= 0
    assert present.sum() > 0.8 * n
    if n_haplotypes == 2:  # the assertion of tests/test_hic_bihap.py
        impure = sum(h.size - np.bincount(h).max() for h in (truth[got == g] for g in set(got[present].tolist())))
        assert impure <= 0.1 * present.sum()


@pytest.mark.parametrize("n_haplotypes", [3, 4, 0])
def test_spectral_phase_three_haplotypes_equals_jax(n_haplotypes):
    specs, n, hap = _three_haplotype_specs()
    ref = JB.spectral_phase(_columns(JaxSparseColumn, specs), n, n_haplotypes=n_haplotypes)
    got = TB.spectral_phase(_columns(SparseColumn, specs), n, n_haplotypes=n_haplotypes, device="cpu")
    assert _partition(got) == _partition(ref)
    if n_haplotypes == 4:  # two sign dimensions, no merge: the haplotypes come apart
        groups = [set(hap[got == g].tolist()) for g in set(got.tolist())]
        assert sum(len(g) == 1 for g in groups) >= 3


def test_no_columns_and_absent_reads_equal_jax():
    assert (TB.spectral_phase([], 5, device="cpu") == JB.spectral_phase([], 5)).all()
    specs, n, _ = _three_haplotype_specs()
    for sp in specs:  # reads 0..4 are in no column
        keep = sp["rows"] >= 5
        sp["rows"], sp["alleles"] = sp["rows"][keep], sp["alleles"][keep]
    ref = JB.spectral_phase(_columns(JaxSparseColumn, specs), n, n_haplotypes=4)
    got = TB.spectral_phase(_columns(SparseColumn, specs), n, n_haplotypes=4, device="cpu")
    assert (got[:5] == -1).all() and (got[5:] >= 0).all()
    assert _partition(got) == _partition(ref)


def test_solution_file_equals_jax(tmp_path, two_haplotype_columns):
    specs, n, _ = two_haplotype_columns
    labels = TB.spectral_phase(_columns(SparseColumn, specs), n, n_haplotypes=2, device="cpu")
    names = [f"read_{i}" for i in range(n)]
    JB.write_bihap_solution(str(tmp_path / "jax.txt"), "ctg", names, labels)
    TB.write_bihap_solution(str(tmp_path / "port.txt"), "ctg", names, labels)
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert got.startswith(b"CONTIG\tctg\nREAD\tread_0\n") and b"LABELS\t" in got

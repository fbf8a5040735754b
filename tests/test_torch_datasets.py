"""End-to-end parity of the port's pipeline with the JAX package on the JAX
package's own end-to-end datasets: every artifact byte-identical.

The cases are built exactly as the JAX package's tests build them (the same
simulators, seeds and configurations; the `rng` fixture there is
`default_rng(0)`):
  * two_strains: tests/test_pipeline_e2e.py:test_full_pipeline_two_strains
    (12 kb, two strains, a GFA input);
  * hifi: tests/test_pipeline_e2e.py:test_hifi_preset_end_to_end (15 kb,
    `-x hifi`);
  * sim2_diploid: tests/test_sim2_evidence.py:test_sim2_diploid_split (50 kb,
    reads of the independent simulator `utils/sim2`);
  * mock_metagenome: tests/test_metagenome.py:test_mock_metagenome (4 species
    x 15 kb, exact HiFi-like reads, `-x hifi`);
  * stress: tests/test_stress_quality.py:stress_dataset (three strains at
    1.0/0.3/0.05, homopolymer-biased indels, 2% chimeras, uniform edges),
    the scored dataset of `bench.py:quality_block`, cut in length and
    coverage only;
  * robust: tests/test_robustness.py:test_pipeline_with_n_bases_and_gz_reads
    (N bases and lowercase in the assembly, gzipped reads).
The reduced scenarios of `scripts/torch_eval_quality.py` are the cases of
tests/test_torch_datasets_quality.py.

The JAX run forces its accelerator branches (device chi², device CW), as in
tests/test_torch_pipeline_flags.py; the port runs the same configuration on
the CPU. Tolerance: every artifact byte-identical, the same files in both
output trees."""

import gzip
import os

import numpy as np
import pytest

import hairsplitter_tpu.pipeline.call_variants as jax_cv
from hairsplitter_tpu.constants import revcomp
from hairsplitter_tpu.io.fasta import write_fasta
from hairsplitter_tpu.io.gfa import AssemblyGraph, write_gfa
from hairsplitter_tpu.pipeline.orchestrate import PipelineConfig, run_pipeline as jax_run_pipeline
from hairsplitter_tpu.pipeline.separate_reads import SeparateConfig
from hairsplitter_tpu.utils import sim, sim2
from hairsplitter_tpu_torch.compat import config_from_jax
from hairsplitter_tpu_torch.pipeline.orchestrate import run_pipeline
from tests.test_torch_pipeline import ARTIFACTS
from tests.test_torch_pipeline_flags import _tree
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _two_strains(root):
    rng = np.random.default_rng(0)
    consensus = sim.make_haplotypes(12000, 1, 0.001, rng)[0]
    hap2, _ = sim.mutate(consensus, 0.01, rng)
    reads = sim.simulate_reads(
        [consensus, hap2], coverage=20, read_len=3000, rng=rng,
        sub_rate=0.02, ins_rate=0.01, del_rate=0.01,
    )
    asm = AssemblyGraph()
    asm.add_segment("ctg", consensus, depth=40.0)
    asm_path, reads_path = os.path.join(root, "assembly.gfa"), os.path.join(root, "reads.fasta")
    write_gfa(asm, asm_path)
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, {}


def _hifi(root):
    rng = np.random.default_rng(0)
    hap1 = sim.make_haplotypes(15_000, 1, 0.001, rng)[0]
    hap2, _ = sim.mutate(hap1, 0.01, rng)
    reads = sim.simulate_reads(
        [hap1, hap2], coverage=12, read_len=6000, rng=rng,
        sub_rate=0.006, ins_rate=0.002, del_rate=0.002, uniform_edges=True,
    )
    asm_path, reads_path = os.path.join(root, "asm.fa"), os.path.join(root, "reads.fa")
    write_fasta(asm_path, {"chrI": hap1})
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, dict(technology="hifi")


def _sim2_diploid(root):
    rng = np.random.default_rng(5)
    haps = sim.make_haplotypes(50_000, 2, 0.01, rng)
    reads = sim2.generate(haps, coverage=15.0, seed=7)
    asm_path, reads_path = os.path.join(root, "a.fa"), os.path.join(root, "r.fa")
    write_fasta(asm_path, {"collapsed": haps[0]})
    sim2.write_fasta(reads_path, reads)
    return asm_path, reads_path, {}


def _mock_metagenome(root):
    rng = np.random.default_rng(0)
    species = []
    for ns in [2, 2, 3, 1]:
        base = sim.random_genome(15_000, rng)
        species.append([base] + [sim.mutate(base, 0.01, rng)[0] for _ in range(ns - 1)])
    asm = AssemblyGraph()
    names, seqs = [], []
    for si, strains in enumerate(species):
        asm.add_segment(f"sp{si}", strains[0], depth=15.0 * len(strains))
        for hi, strain in enumerate(strains):
            for _ in range(int(np.ceil(15 * len(strain) / 6000))):
                s = int(rng.integers(0, max(1, len(strain) - 6000)))
                frag = strain[s : s + 6000]
                if rng.random() < 0.5:
                    frag = revcomp(frag)
                names.append(f"r{len(names)}_s{si}h{hi}")
                seqs.append(frag)
    reads = sim.SimReads(names, seqs, [0] * len(seqs), [0] * len(seqs), [1] * len(seqs))
    asm_path, reads_path = os.path.join(root, "asm.gfa"), os.path.join(root, "reads.fa")
    write_gfa(asm, asm_path)
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, dict(technology="hifi")


def _stress(root):
    # the stress dataset at 10 kb and 100x base coverage (5x on the rare
    # strain) in place of 30 kb at 280x, so that the case stays near 30 s
    # on one thread; strains, abundances, error model, read length and seed
    # are tests/test_stress_quality.py's own
    rng = np.random.default_rng(3)
    haps = sim.make_haplotypes(10_000, 3, 0.01, rng)
    reads = sim.simulate_reads(
        haps, coverage=100, read_len=8000, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
        abundances=[1.0, 0.3, 0.05], homopolymer_bias=1.0, chimera_rate=0.02,
        uniform_edges=True,
    )
    asm_path, reads_path = os.path.join(root, "asm.fa"), os.path.join(root, "reads.fa")
    write_fasta(asm_path, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, {}


def _robust(root):
    # tests/test_robustness.py's dataset, drawn from seed 0 (its `rng`
    # fixture is default_rng(0))
    rng = np.random.default_rng(0)
    consensus = sim.make_haplotypes(4000, 1, 0.001, rng)[0]
    hap2, _ = sim.mutate(consensus, 0.01, rng)
    reads = sim.simulate_reads([consensus, hap2], coverage=12, read_len=1500, rng=rng)
    dirty = consensus[:100] + "NNNN" + consensus[104:2000].lower() + consensus[2000:]
    asm = AssemblyGraph()
    asm.add_segment("ctg", dirty, depth=24)
    asm_path, reads_path = os.path.join(root, "a.gfa"), os.path.join(root, "r.fa.gz")
    write_gfa(asm, asm_path)
    with gzip.open(reads_path, "wt") as f:
        for name, seq in zip(reads.names, reads.seqs):
            f.write(f">{name}\n{seq}\n")
    return asm_path, reads_path, {}


DATASETS = {
    "two_strains": _two_strains,
    "hifi": _hifi,
    "sim2_diploid": _sim2_diploid,
    "mock_metagenome": _mock_metagenome,
    "stress": _stress,
    "robust": _robust,
}


def assert_runs_equal(tmp_path, monkeypatch, asm_path: str, reads_path: str, **flags) -> None:
    """The JAX package (accelerator branches forced) and the port on the CPU
    on one input: the same files, every artifact byte-identical."""
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    cfg = PipelineConfig(separate=SeparateConfig(use_device_cw=True), **flags)
    out_jax, out_port = tmp_path / "jax", tmp_path / "port"
    jax_run_pipeline(asm_path, reads_path, str(out_jax), cfg)
    run_pipeline(asm_path, reads_path, str(out_port), config_from_jax(cfg))
    assert _tree(out_port) == _tree(out_jax)
    for name in ARTIFACTS:
        got = (out_port / name).read_bytes()
        assert got == (out_jax / name).read_bytes(), name
        assert len(got) > 0, name


@pytest.mark.parametrize("case", list(DATASETS))
def test_dataset_artifacts_equal_jax(case, tmp_path, monkeypatch):
    asm_path, reads_path, flags = DATASETS[case](str(tmp_path))
    assert_runs_equal(tmp_path, monkeypatch, asm_path, reads_path, **flags)

"""End-to-end parity of the port's pipeline with the JAX package, and the
no-JAX check of the port's CLI.

The JAX run forces its accelerator branches (device chi², device CW); the
port runs the same configuration (`compat.config_from_jax`) on the CPU.
Tolerance: every artifact byte-identical."""

import json
import os
from dataclasses import replace
import subprocess
import sys

import numpy as np
import pytest

import hairsplitter_tpu.pipeline.call_variants as jax_cv
import hairsplitter_tpu_torch.pipeline.unzip as port_unzip
from hairsplitter_tpu.io.fasta import write_fasta
from hairsplitter_tpu.pipeline.orchestrate import PipelineConfig, run_pipeline as jax_run_pipeline
from hairsplitter_tpu.pipeline.separate_reads import SeparateConfig
from hairsplitter_tpu.utils import sim
from hairsplitter_tpu_torch.compat import config_from_jax
from hairsplitter_tpu_torch.pipeline.orchestrate import run_pipeline
from tests.torch_parity_data import one_torch_thread, spy_calls  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = [
    "tmp/reads_on_asm.sam",
    "tmp/variants.col",
    "tmp/error_rate.txt",
    "tmp/reads_haplo.gro",
    "tmp/zipped_assembly.gfa",
    "tmp/reads_on_new_contig.gaf",
    "variants.vcf",
    "hairsplitter_final_assembly.gfa",
    "hairsplitter_final_assembly.fasta",
    "hairsplitter_summary.txt",
]


def _two_strain_dataset(root, length=20_000, shared=(7800, 12200), read_len=7000, coverage=15, seed=1):
    """Assembly = strain 1; strain 2 differs at 1% outside `shared`, where the
    strains are identical — so stage 6 duplicates the shared contig and
    re-polishes the copies. 10% read error (above 0.08, so the POA ladder
    runs)."""
    rng = np.random.default_rng(seed)
    backbone = sim.random_genome(length, rng)
    lo, hi = shared
    left, _ = sim.mutate(backbone[:lo], 0.01, rng)
    right, _ = sim.mutate(backbone[hi:], 0.01, rng)
    haps = [backbone, left + backbone[lo:hi] + right]
    reads = sim.simulate_reads(
        haps, coverage=coverage, read_len=read_len, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
    )
    asm = os.path.join(root, "assembly.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm, reads_path


def test_pipeline_artifacts_equal_jax(tmp_path, monkeypatch):
    asm, reads = _two_strain_dataset(str(tmp_path))
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    repolished = []
    orig = port_unzip.repolish_copies
    monkeypatch.setattr(
        port_unzip, "repolish_copies", lambda *a, **k: repolished.append(1) or orig(*a, **k)
    )
    cfg = PipelineConfig(separate=SeparateConfig(use_device_cw=True))
    jax_run_pipeline(asm, reads, str(tmp_path / "jax"), cfg)
    run_pipeline(asm, reads, str(tmp_path / "port"), config_from_jax(cfg))
    assert repolished, "stage 6 did not re-polish duplicated copies"
    assert float((tmp_path / "port/tmp/error_rate.txt").read_text()) > 0.08
    for name in ARTIFACTS:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert len(got) > 0, name


_NO_JAX = """
import sys

class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked in this process: " + name)
        return None

sys.meta_path.insert(0, _BlockJax())
from hairsplitter_tpu_torch.cli import main

rc = main(sys.argv[1:])
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
sys.exit(rc)
"""


def test_cli_runs_without_jax(tmp_path):
    asm, reads = _two_strain_dataset(
        str(tmp_path), length=8000, shared=(3000, 5000), read_len=3000, coverage=10, seed=2
    )
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-i", asm, "-f", reads, "-o", str(out), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (out / "hairsplitter_final_assembly.gfa").stat().st_size > 0
    assert (out / "stage_stats.json").exists()


def _broken_assembly_dataset(root, seed=3):
    """A 16 kb genome in two strains (1% apart) whose assembly is broken the
    way tests/test_tailor.py breaks its assemblies: contig `chim` joins the
    first 9 kb to 3 kb of unrelated sequence (a misjoin), contig `tail` is
    the rest, and the link between them is left out."""
    rng = np.random.default_rng(seed)
    haps = sim.make_haplotypes(16_000, 2, 0.01, rng)
    decoy = sim.random_genome(3000, rng)
    reads = sim.simulate_reads(
        haps, coverage=15, read_len=5000, rng=rng, sub_rate=0.03, ins_rate=0.01, del_rate=0.01,
    )
    asm = os.path.join(root, "assembly.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm, {"chim": haps[0][:9000] + decoy, "tail": haps[0][9000:]})
    sim.write_sim_fasta(reads_path, reads)
    return asm, reads_path


def _assert_artifacts_equal(tmp_path, names):
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert len(got) > 0, name


def test_correct_assembly_artifacts_equal_jax(tmp_path, monkeypatch):
    """`--correct-assembly` on an assembly with a misjoin and a missing link:
    stage 1b cuts the chimera, links the pieces and drops the unrelated
    piece, in both packages alike; then `--resume` after stage 1b reloads
    `tmp/corrected_assembly.gfa` and ends in the same artifacts."""
    import hairsplitter_tpu_torch.pipeline.orchestrate as port_orch

    asm, reads = _broken_assembly_dataset(str(tmp_path))
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    cfg = PipelineConfig(correct_assembly=True, separate=SeparateConfig(use_device_cw=True))
    jax_run_pipeline(asm, reads, str(tmp_path / "jax"), cfg)
    run_pipeline(asm, reads, str(tmp_path / "port"), config_from_jax(cfg))
    corrected = (tmp_path / "port/tmp/corrected_assembly.gfa").read_text()
    assert "chim&0" in corrected and "chim&1" not in corrected  # cut; the unrelated piece dropped
    log = (tmp_path / "port/hairsplitter.log").read_text()
    assert "STAGE 1b" in log and "1 cuts, 1 new links" in log
    _assert_artifacts_equal(tmp_path, ARTIFACTS + ["tmp/corrected_assembly.gfa"])

    # --resume after stage 1b: later artifacts removed, stage 1b not run again
    final = {n: (tmp_path / "port" / n).read_bytes() for n in ARTIFACTS}
    for n in ARTIFACTS:
        (tmp_path / "port" / n).unlink()
    tailor_runs = spy_calls(monkeypatch, port_orch, "correct_assembly")
    run_pipeline(asm, reads, str(tmp_path / "port"), replace(config_from_jax(cfg), resume=True))
    assert not tailor_runs, "stage 1b ran again on --resume"
    assert "resume: corrected assembly loaded" in (tmp_path / "port/hairsplitter.log").read_text()
    for n in ARTIFACTS:
        assert (tmp_path / "port" / n).read_bytes() == final[n], n


def test_medaka_artifacts_equal_jax(tmp_path, monkeypatch):
    """`-p medaka`: the NN caller votes every column of stage 5 and polishes
    once more after the POA ladder. Its logits are float (within 1e-4 of the
    JAX package's, tests/test_torch_polisher.py), so a base could differ
    where the two best logits are closer than that: the test reads the
    smallest top-two margin over every position the JAX run called and holds
    it above 1e-3, so that a differing artifact would name its cause."""
    from hairsplitter_tpu.models import polisher as jax_polisher
    from hairsplitter_tpu_torch.models import polisher as port_polisher
    from hairsplitter_tpu_torch.pipeline import new_contigs as port_new_contigs

    asm, reads = _two_strain_dataset(
        str(tmp_path), length=8000, shared=(3000, 5000), read_len=3000, coverage=10, seed=2
    )
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    margins = []
    jax_logits = jax_polisher.NNPolisher.logits

    def logits_with_margin(self, feats):
        out = jax_logits(self, feats)
        top = np.sort(out, axis=1)
        margins.append(top[:, -1] - top[:, -2])
        return out

    def polish_counts_with_margin(self, counts, ins_rate, backbone):
        bases = jax_polish_counts(self, counts, ins_rate, backbone)
        margins[-1] = margins[-1][: counts.shape[0]]  # the padded tail is cut off
        return bases

    jax_polish_counts = jax_polisher.NNPolisher.polish_counts
    monkeypatch.setattr(jax_polisher.NNPolisher, "logits", logits_with_margin)
    monkeypatch.setattr(jax_polisher.NNPolisher, "polish_counts", polish_counts_with_margin)
    cfg = PipelineConfig(polisher="medaka", separate=SeparateConfig(use_device_cw=True))
    jax_run_pipeline(asm, reads, str(tmp_path / "jax"), cfg)
    nn = port_polisher.default_polisher("cpu")
    calls0 = nn.calls
    after_poa = spy_calls(monkeypatch, port_new_contigs, "_backbone_badness")
    run_pipeline(asm, reads, str(tmp_path / "port"), config_from_jax(cfg))
    assert len(margins) > 0 and nn.calls - calls0 == len(margins)
    smallest = min(float(m.min()) for m in margins)
    print(f"{len(margins)} NN calls, {sum(m.size for m in margins)} positions, smallest top-two margin {smallest:.3e}")
    assert smallest > 1e-3
    assert after_poa, "the NN pass after the POA ladder never reached its read-fit gate"
    assert "NN base caller" in (tmp_path / "port/hairsplitter.log").read_text()
    stats = json.loads((tmp_path / "port/stage_stats.json").read_text())
    assert stats["nn_caller"]["calls"] == len(margins)
    assert float((tmp_path / "port/tmp/error_rate.txt").read_text()) > 0.08  # the POA ladder ran
    _assert_artifacts_equal(tmp_path, ARTIFACTS)

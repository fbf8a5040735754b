"""End-to-end parity of the port's pipeline with the JAX package, and the
no-JAX check of the port's CLI.

The JAX run forces its accelerator branches (device chi², device CW); the
port runs the same configuration (`compat.config_from_jax`) on the CPU.
Tolerance: every artifact byte-identical."""

import os
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


@pytest.mark.parametrize(
    "flags,item",
    [(["--correct-assembly"], "--correct-assembly"), (["-p", "medaka"], "-p medaka")],
)
def test_cli_rejects_unported_flags(tmp_path, capsys, flags, item):
    from hairsplitter_tpu_torch.cli import main

    rc = main(["-i", "a.fa", "-f", "r.fa", "-o", str(tmp_path / "o"), "--device", "cpu", *flags])
    err = capsys.readouterr().err
    assert rc != 0 and item in err and "ROADMAP.md Queue 1" in err

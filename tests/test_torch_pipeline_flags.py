"""End-to-end parity of the port's pipeline with the JAX package under the
flags that tests/test_torch_pipeline.py does not run: low-memory mode, the
technology presets, the ploidy cap, `-s`, host threads, `-P`, the FASTQ
quality filter, contig chunking, `-d`, and `--resume` from every stage.

One dataset (the 20 kb two-strain genome of tests/test_torch_pipeline.py),
one parametrised test. The JAX run forces its accelerator branches (device
chi², device CW); the port runs the same configuration on the CPU.
Tolerance: every artifact byte-identical, the same files in both output
trees."""

import os
import shutil

import pytest

import hairsplitter_tpu.pipeline.call_variants as jax_cv
from hairsplitter_tpu.pipeline.orchestrate import PipelineConfig, run_pipeline as jax_run_pipeline
from hairsplitter_tpu.pipeline.separate_reads import SeparateConfig
from hairsplitter_tpu_torch.compat import config_from_jax
from hairsplitter_tpu_torch.pipeline.orchestrate import run_pipeline
from tests.test_torch_pipeline import ARTIFACTS, _two_strain_dataset
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the artifacts each stage leaves, in stage order; `--resume` after stage N
# finds those of stages 2..N and recomputes the rest
STAGE_FILES = {
    2: ["tmp/reads_on_asm.sam"],
    3: ["tmp/variants.col", "tmp/error_rate.txt", "variants.vcf"],
    4: ["tmp/reads_haplo.gro"],
    5: ["tmp/zipped_assembly.gfa", "tmp/reads_on_new_contig.gaf"],
    6: ["hairsplitter_final_assembly.gfa", "hairsplitter_final_assembly.fasta", "hairsplitter_summary.txt"],
}

FLAGS = {
    "low_memory": dict(low_memory=True, low_memory_read_batch=10),
    "hifi": dict(technology="hifi"),
    "pacbio": dict(technology="pacbio"),
    "amplicon": dict(technology="amplicon"),
    "haploid_coverage": dict(haploid_coverage=7.0),
    "dont_simplify": dict(dont_simplify=True),
    "threads": dict(threads=2),
    "polish_everything": dict(polish_everything=True),
    "min_read_quality": dict(min_read_quality=12.0),
    "max_contig_chunk": dict(max_contig_chunk=6000),
    "debug": dict(debug=True),
    "resume_after_stage_2": dict(resume=True),
    "resume_after_stage_3": dict(resume=True),
    "resume_after_stage_4": dict(resume=True),
    "resume_after_stage_5": dict(resume=True),
    "resume_after_stage_6": dict(resume=True),
}


def _tree(root) -> list[str]:
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files
    )


def _write_fastq(reads_fasta: str, path: str) -> int:
    """The dataset's reads as FASTQ; every third read with a mean quality of
    8, the others 20. Returns the number of low-quality reads."""
    names, seqs = [], []
    for line in open(reads_fasta):
        (names if line.startswith(">") else seqs).append(line.strip().lstrip(">"))
    with open(path, "w") as f:
        for i, (n, s) in enumerate(zip(names, seqs)):
            f.write(f"@{n}\n{s}\n+\n{chr(33 + (8 if i % 3 == 0 else 20)) * len(s)}\n")
    return len(range(0, len(names), 3))


def _cfg(**flags) -> PipelineConfig:
    return PipelineConfig(separate=SeparateConfig(use_device_cw=True), **flags)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("flags_data")
    asm, reads = _two_strain_dataset(str(root))
    return asm, reads, root


@pytest.fixture(scope="module")
def finished_runs(dataset):
    """One default run of each package, for the resume cases to start from."""
    asm, reads, root = dataset
    accel = jax_cv._accel_available
    jax_cv._accel_available = lambda: True
    try:
        jax_run_pipeline(asm, reads, str(root / "base_jax"), _cfg())
    finally:
        jax_cv._accel_available = accel
    run_pipeline(asm, reads, str(root / "base_port"), config_from_jax(_cfg()))
    return root / "base_jax", root / "base_port"


@pytest.mark.parametrize("case", list(FLAGS))
def test_flag_artifacts_equal_jax(case, dataset, tmp_path, monkeypatch, request):
    asm, reads, _ = dataset
    flags = FLAGS[case]
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    out_jax, out_port = tmp_path / "jax", tmp_path / "port"
    if case == "min_read_quality":
        fastq = str(tmp_path / "reads.fastq")
        n_low = _write_fastq(reads, fastq)
        reads = fastq
    if case.startswith("resume"):
        done = int(case[-1])
        for base, out in zip(request.getfixturevalue("finished_runs"), (out_jax, out_port)):
            shutil.copytree(base, out)
            for stage, names in STAGE_FILES.items():
                if stage > done:
                    for name in names:
                        (out / name).unlink()
            (out / "hairsplitter.log").unlink()

    cfg = _cfg(**flags)
    jax_run_pipeline(asm, reads, str(out_jax), cfg)
    run_pipeline(asm, reads, str(out_port), config_from_jax(cfg))

    assert _tree(out_port) == _tree(out_jax)
    names = ARTIFACTS + (["tmp/ploidy.txt"] if case == "haploid_coverage" else [])
    for name in names:
        got = (out_port / name).read_bytes()
        assert got == (out_jax / name).read_bytes(), name
        assert len(got) > 0, name
    log = (out_port / "hairsplitter.log").read_text()
    log_jax = (out_jax / "hairsplitter.log").read_text()

    if case == "low_memory":
        n_reads = sum(1 for l in open(reads) if l.startswith(">"))
        assert n_reads > 10  # more than one batch
    elif case == "haploid_coverage":
        ploidy = dict(l.split("\t") for l in (out_port / "tmp/ploidy.txt").read_text().splitlines())
        assert ploidy and max(int(v) for v in ploidy.values()) >= 2  # caps stage 4 at a count
    elif case == "dont_simplify":
        assert "(no chain merge: -s)" in log
    elif case == "min_read_quality":
        total = sum(1 for l in open(reads)) // 4
        assert 0 < n_low < total
        assert f"quality filter: kept {total - n_low} reads" in log  # the low-quality third was dropped
        assert f"alignments for {total - n_low} reads" in log
    elif case == "max_contig_chunk":
        assert "4 contigs after chunking at 6000" in log  # 20 kb cut in four
    elif case.startswith("resume"):
        n_resume = sum("resume: " in l for l in log.splitlines())
        assert n_resume == sum("resume: " in l for l in log_jax.splitlines())
        assert n_resume == (1 if done == 6 else min(done, 4) - 1)
        base_port = request.getfixturevalue("finished_runs")[1]
        for name in ARTIFACTS:  # and the resumed run ends where the whole run did
            assert (out_port / name).read_bytes() == (base_port / name).read_bytes(), name

"""The port stands alone: no file of `hairsplitter_tpu_torch`, nor the scripts
that drive it on a machine without JAX, imports `jax`, `jaxlib`, `flax`,
`optax` or anything of the JAX package `hairsplitter_tpu`, at load time or
lazily; and the port's two CLIs run to the end in a process where all of
them are blocked."""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hairsplitter_tpu_torch.io.fasta import write_fasta
from hairsplitter_tpu_torch.utils import sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hairsplitter_tpu")

PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "hairsplitter_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py", "scripts/profile_torch_pipeline.py", "scripts/torch_stage_times.py",
     "scripts/kernel_variants.py", "scripts/myers_fused_variants.py", "scripts/banded_fused_variants.py",
     "scripts/torch_two_process_cold_build.py"]


def _imported_roots(path: str) -> set[tuple[str, int]]:
    """(top-level package, line) of every absolute import in the file, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update((alias.name.split(".")[0], node.lineno) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add((node.module.split(".")[0], node.lineno))
    return found


def test_the_port_has_files_to_check():
    assert len(PORT_FILES) > 30
    assert "hairsplitter_tpu_torch/native.py" in PORT_FILES
    assert "hairsplitter_tpu_torch/utils/sim.py" in PORT_FILES
    for new in ("parallel/distributed.py", "parallel/mesh.py", "graphunzip.py", "models/polisher.py", "models/bihap.py", "pipeline/tailor.py", "pipeline/dbg.py",
                "pipeline/hic.py", "pipeline/hic_solve.py", "io/gaf.py", "utils/sim2.py"):
        assert f"hairsplitter_tpu_torch/{new}" in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_file_imports_nothing_of_jax_or_the_jax_package(rel):
    bad = sorted((root, line) for root, line in _imported_roots(os.path.join(REPO, rel)) if root in FORBIDDEN)
    assert not bad, f"{rel} imports {bad}"


def test_the_import_walker_sees_nested_and_dotted_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\n"
        "def f():\n"
        "    from hairsplitter_tpu.io import gfa\n"
        "    import jax.numpy as jnp\n"
        "    import flax.linen as nn\n"
        "from . import sibling\n"
        "from hairsplitter_tpu_torch import native\n"
    )
    roots = {root for root, _ in _imported_roots(str(src))}
    assert roots == {"os", "hairsplitter_tpu", "jax", "flax", "hairsplitter_tpu_torch"}


_BLOCKED = """
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "hairsplitter_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None

sys.meta_path.insert(0, _Block())
from hairsplitter_tpu_torch.%s import main
import hairsplitter_tpu_torch.parallel.mesh  # noqa: F401  (the one module no entry point loads)

rc = main(sys.argv[1:])
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
sys.exit(rc)
"""


def _run_blocked(module: str, argv: list[str]):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED % module, *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _small_dataset(tmp_path):
    rng = np.random.default_rng(2)
    haps = sim.make_haplotypes(8000, 2, 0.01, rng)
    reads = sim.simulate_reads(haps, coverage=10, read_len=3000, rng=rng,
                               sub_rate=0.03, ins_rate=0.01, del_rate=0.01)
    asm, reads_path = str(tmp_path / "asm.fasta"), str(tmp_path / "reads.fasta")
    write_fasta(asm, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm, reads_path


def _check_cli_blocked(tmp_path, flags):
    asm, reads_path = _small_dataset(tmp_path)
    out = tmp_path / "out"
    _run_blocked("cli", ["-i", asm, "-f", reads_path, "-o", str(out), "--device", "cpu", *flags])
    assert (out / "hairsplitter_final_assembly.gfa").stat().st_size > 0
    stats = json.loads((out / "stage_stats.json").read_text())
    assert ("correct_assembly" in stats) == bool(flags)
    assert (out / "tmp" / "corrected_assembly.gfa").exists() == bool(flags)
    return out


def test_cli_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    _check_cli_blocked(tmp_path, [])


def test_cli_with_tailor_and_medaka_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    out = _check_cli_blocked(tmp_path, ["--correct-assembly", "-p", "medaka"])
    assert "NN base caller" in (out / "hairsplitter.log").read_text()


def test_graphunzip_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """`graphunzip unzip -r` on the artifacts of a pipeline run (zipped
    graph, GAF, reads), mapping on the CPU."""
    asm, reads_path = _small_dataset(tmp_path)
    out = tmp_path / "out"
    _run_blocked("cli", ["-i", asm, "-f", reads_path, "-o", str(out), "--device", "cpu"])
    unzipped = tmp_path / "unzipped.gfa"
    proc = _run_blocked("graphunzip", [
        "unzip", "-g", str(out / "tmp" / "zipped_assembly.gfa"), "-l", str(out / "tmp" / "reads_on_new_contig.gaf"),
        "-r", reads_path, "-o", str(unzipped), "--supercontigs", str(tmp_path / "super.txt"), "--device", "cpu"])
    assert unzipped.stat().st_size > 0 and "done:" in proc.stdout


def test_distributed_entry_point_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """`python -m hairsplitter_tpu_torch.parallel.distributed` as one process
    of one: no process group, the single-process file names."""
    asm, reads_path = _small_dataset(tmp_path)
    out = tmp_path / "out"
    _run_blocked("parallel.distributed", ["--num-processes", "1", "--process-id", "0", "--device", "cpu",
                                          "-i", asm, "-f", reads_path, "-o", str(out)])
    assert (out / "hairsplitter_final_assembly.gfa").stat().st_size > 0
    assert (out / "stage_stats.json").exists() and not (out / "stage_stats.p0.json").exists()
    assert "kernel launches: myers_fused=0" in (out / "hairsplitter.log").read_text()

"""The port stands alone: no file of `hairsplitter_tpu_torch`, nor the scripts
that drive it on a machine without JAX, imports `jax`, `jaxlib`, `flax`,
`optax` or anything of the JAX package `hairsplitter_tpu`, at load time or
lazily; and the port's two CLIs, its distributed entry point, its bench
`bench_torch.py` and its scripts `scripts/torch_train_polisher.py`,
`torch_eval_quality.py` and `torch_demo.py` run to the end in a process where
all of them are blocked."""

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
) + ["chip_smoke.py", "bench_torch.py", "scripts/profile_torch_pipeline.py",
     "scripts/kernel_variants.py", "scripts/myers_fused_variants.py", "scripts/banded_fused_variants.py",
     "scripts/torch_two_process_cold_build.py", "scripts/torch_train_polisher.py",
     "scripts/torch_eval_quality.py", "scripts/torch_demo.py", "scripts/profile_torch_training.py"]


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


def _device_choices(tree: ast.AST) -> list[int]:
    """Lines that compare a `.type` with "cuda" or touch `torch.cuda`."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            if any(isinstance(x, ast.Attribute) and x.attr == "type" for x in sides) and \
                    any(isinstance(x, ast.Constant) and x.value == "cuda" for x in sides):
                found.append(node.lineno)
        elif isinstance(node, ast.Attribute) and node.attr == "cuda" and \
                isinstance(node.value, ast.Name) and node.value.id == "torch":
            found.append(node.lineno)
    return found


def _ops_imports(tree: ast.AST) -> list[int]:
    """Lines that import the port's `ops` package or a module of it, from a
    module one level below the package root."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names = {a.name for a in node.names}
            mod = {2: "hairsplitter_tpu_torch", 0: ""}.get(node.level)
            if mod is None:
                continue
            mod = ".".join(x for x in (mod, node.module) if x)
            if mod == "hairsplitter_tpu_torch.ops" or mod.startswith("hairsplitter_tpu_torch.ops.") or \
                    (mod == "hairsplitter_tpu_torch" and "ops" in names):
                found.append(node.lineno)
        elif isinstance(node, ast.Import):
            if any(a.name.startswith("hairsplitter_tpu_torch.ops") for a in node.names):
                found.append(node.lineno)
    return found


def test_device_choice_and_kernel_plumbing_live_in_ops():
    """`ops/` alone chooses a route by device: no module of `core/`,
    `utils/` or `pipeline/` but `orchestrate.py` (which checks that the
    asked device exists and enters the caller's card) compares a device's
    `.type` with "cuda" or calls `torch.cuda`; and `utils/`, the bottom
    layer, imports nothing of `ops/`."""
    sample = ast.parse(
        "import torch\n"
        "from ..ops import _build\n"
        "from .. import ops\n"
        "from ..ops.variants import window_stats_blocks\n"
        "import hairsplitter_tpu_torch.ops.chain_seeds\n"
        "def f(device):\n"
        "    if torch.device(device).type == 'cuda':\n"
        "        return torch.cuda.current_stream()\n"
        "    return 'cuda' != device.type\n"
    )
    assert sorted(_device_choices(sample)) == [7, 8, 9]
    assert sorted(_ops_imports(sample)) == [2, 3, 4, 5]
    bad = {}
    for layer in ("core", "utils", "pipeline"):
        for path in sorted(glob.glob(os.path.join(REPO, "hairsplitter_tpu_torch", layer, "*.py"))):
            rel = os.path.relpath(path, REPO)
            if rel == "hairsplitter_tpu_torch/pipeline/orchestrate.py":
                continue
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            lines = _device_choices(tree) + (_ops_imports(tree) if layer == "utils" else [])
            if lines:
                bad[rel] = sorted(lines)
    assert not bad, f"device choices or ops imports outside ops/: {bad}"


_BLOCKER = """
import runpy
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "hairsplitter_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None

sys.meta_path.insert(0, _Block())
"""
_NOTHING_BLOCKED_LOADED = """
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
"""
# an entry point of the port, `main(argv)`
_BLOCKED = _BLOCKER + """
from hairsplitter_tpu_torch.%s import main
import hairsplitter_tpu_torch.parallel.mesh  # noqa: F401  (the one module no entry point loads)

rc = main(sys.argv[1:])
""" + _NOTHING_BLOCKED_LOADED + """
sys.exit(rc)
"""
# a script, run as `__main__` with the arguments after its path
_BLOCKED_SCRIPT = _BLOCKER + """
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as stop:
    assert stop.code in (0, None), stop.code
""" + _NOTHING_BLOCKED_LOADED

# the port's bench, `bench_torch.main`, with the CPU's sizes from the first
# argument and every timer at one window of one call
_BLOCKED_BENCH = _BLOCKER + """
import json

import bench_torch

bench_torch.SIZES["cpu"] = json.loads(sys.argv[1])
timer = bench_torch.time_calls
bench_torch.time_calls = lambda fn, device, windows, iters, host_clock=False: timer(fn, device, 1, 1, host_clock)
rc = bench_torch.main(sys.argv[2:])
""" + _NOTHING_BLOCKED_LOADED + """
sys.exit(rc)
"""


def _run_blocked(module: str, argv: list[str]):
    """`hairsplitter_tpu_torch.<module>:main`, the script at `scripts/<module>`
    run as `__main__`, or with `module` "bench_torch" the bench, with `argv`,
    in a new process that blocks every forbidden package."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if module == "bench_torch":
        code = (_BLOCKED_BENCH,)
    elif module.endswith(".py"):
        code = (_BLOCKED_SCRIPT, os.path.join(REPO, "scripts", module))
    else:
        code = (_BLOCKED % module,)
    proc = subprocess.run(
        [sys.executable, "-c", *code, *argv],
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


def test_train_polisher_script_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    out = tmp_path / "w.npz"
    proc = _run_blocked("torch_train_polisher.py", ["--device", "cpu", "--steps", "2", "--pairs", "1", "--out", str(out)])
    assert out.stat().st_size > 0
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["steps"] == 2 and 0 < res["held_out_accuracy"] <= 1


@pytest.mark.parametrize("scenario", ["metagenome", "skewed"])
def test_eval_quality_script_runs_with_jax_and_the_jax_package_blocked(scenario):
    """Each scenario at a toy size (two 8 kb species; three 8 kb strains)."""
    size = ["--species", "2"] if scenario == "metagenome" else ["--rare-cov", "8"]
    proc = _run_blocked("torch_eval_quality.py", [scenario, "--device", "cpu", "--length", "8000", *size])
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["scenario"] == scenario and res["device"] == "cpu" and res["contigs"] > 0
    assert res["k1_launches"] == 0 and "separate_reads" in res["stages"]
    assert len(res["recovery"]) == 3 if scenario == "skewed" else res["recovery_min"] > 0


def test_demo_script_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    proc = _run_blocked("torch_demo.py", ["--device", "cpu", "--length", "8000", "--strains", "2",
                                          "--coverage", "8", "--out", str(tmp_path)])
    assert "switch errors:" in proc.stdout and "on cpu" in proc.stdout
    assert (tmp_path / "out" / "hairsplitter_final_assembly.gfa").stat().st_size > 0


def test_bench_runs_with_jax_and_the_jax_package_blocked():
    """`bench_torch.py --device cpu` at the toy size of tests/test_torch_bench.py."""
    from tests.test_torch_bench import TOY

    proc = _run_blocked("bench_torch", [json.dumps(TOY), "--device", "cpu"])
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] > 0 and line["detail"]["device"] == "cpu"
    assert not [k for k in line["detail"] if k.endswith(("_error", "_skipped"))]

"""What the benchmark may import, and how a run ends where it cannot measure."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest, run

BENCH = manifest.BENCH_DIR
BANNED = {"jax", "jaxlib", "flax", "optax", "hairsplitter_tpu"}


def modules_imported(path: str) -> set[str]:
    """Top-level names of every module a file imports (absolute imports)."""
    tree = ast.parse(open(path).read(), filename=path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def python_files(sub: str = "") -> list[str]:
    root = os.path.join(BENCH, sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]


def test_nothing_imports_jax_or_the_jax_package():
    files = python_files()
    assert len(files) > 20
    for path in files:
        found = modules_imported(path) & BANNED
        assert not found, f"{path} imports {found}"


def test_the_yardstick_imports_nothing_of_the_port():
    for sub in ("reference", "traffic"):
        for path in python_files(sub):
            assert "hairsplitter_tpu_torch" not in modules_imported(path), path
    for path in [os.path.join(BENCH, "metrics", f) for f in os.listdir(os.path.join(BENCH, "metrics"))]:
        if path.endswith(".py"):
            assert "hairsplitter_tpu_torch" not in modules_imported(path), path


def test_banned_modules_are_compared_by_whole_top_level_name():
    assert run.banned_loaded(["hairsplitter_tpu_torch.ops._build", "numpy", "jaxtyping", "flaxy"]) == []
    assert run.banned_loaded(["jax.numpy", "hairsplitter_tpu.cli", "optax"]) == ["hairsplitter_tpu", "jax", "optax"]


def _run_benchmark(cwd: str, env_extra: dict | None = None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "strains-ont.even30x", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_no_card_no_result():
    proc = _run_benchmark(manifest.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_without_the_port_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run stops where it would import the port."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_benchmark(str(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    code = (
        "import sys; from benchmark import manifest, run\n"
        "cell = manifest.load_cell('strains-ont.even30x')\n"
        "run.run(cell, 1, 0, False, 'cpu')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "hairsplitter_tpu_torch" in proc.stderr
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_the_command_on_the_card(tmp_path):
    """On a GPU machine: one short run of the first cell prints one result
    line with every end-to-end metric of the cell and `correct` true."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "strains-ont.even30x", "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {m["name"] for m in manifest.load_cell("strains-ont.even30x").end_to_end}
    assert res["correct"] and set(res["metrics"]) == want

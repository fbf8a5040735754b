"""`bench_torch.py`, the port's bench, on the CPU: its operands equal
`bench.py`'s byte for byte, and `main` keeps the one-line contract at a toy
size (the size table patched), reports a failed block and exits 1, and
refuses to run without the card it was asked for."""

import json
import re

import numpy as np
import pytest

import bench
import bench_torch
from hairsplitter_tpu.ops.align import BandSpec as JaxBandSpec
from hairsplitter_tpu_torch.ops.align import BandSpec
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# every block at a size the plain versions run in seconds on one thread
TOY = {
    "fused_jobs": 48,
    "fused_single_jobs": 16,
    "raw_kernel_jobs": 8,
    "mapping": dict(size=4000, coverage=4, read_len=1500),
    "pipeline": dict(length=6000, strains=2, coverage=8, read_len=2000),
    "quality": dict(length=6000, coverage=10, read_len=2000),
}


@pytest.fixture
def toy(monkeypatch):
    """The CPU column of the size table at `TOY`, and every timer at one
    window of one call: the plain fused composition is a Python loop over
    the 256 query rows, ~0.3 s a call at any batch size."""
    monkeypatch.setitem(bench_torch.SIZES, "cpu", TOY)
    timer = bench_torch.time_calls
    monkeypatch.setattr(bench_torch, "time_calls",
                        lambda fn, device, windows, iters, host_clock=False: timer(fn, device, 1, 1, host_clock))


def documented_keys() -> set[str]:
    """The keys of `detail` the module docstring lists on the right of its
    `bench.py key -> key here` lines (nested ones as `block.key`)."""
    found = re.findall(r"^    \S+ -> (\S+)", bench_torch.__doc__, flags=re.M)
    return {k for k in found if k != "-"}


def flat_keys(detail: dict) -> set[str]:
    return {f"{k}.{sub}" for k, v in detail.items() if isinstance(v, dict) for sub in v} | {
        k for k, v in detail.items() if not isinstance(v, dict)}


def run_main(argv, capsys):
    rc = bench_torch.main(argv)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("n", [16, 2048])
def test_bench_batch_equals_bench_py(n):
    ours = bench_torch.bench_batch(BandSpec(chunk=256, band=128), n, "cpu")
    theirs = bench._bench_batch(JaxBandSpec(chunk=256, band=128), n)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.tobytes()


def test_main_prints_one_line_with_the_documented_keys(toy, capsys):
    rc, out = run_main(["--device", "cpu"], capsys)
    assert rc == 0, out.err[-3000:]
    lines = out.out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "banded_align_DP_cells_per_s" and line["unit"] == "cells/s"
    assert line["value"] > 0 and line["vs_baseline"] == 1.0
    detail = line["detail"]
    assert flat_keys(detail) == documented_keys()
    assert detail["device"] == "cpu" and detail["fused_kernel"] == "myers" and detail["fused_jobs"] == 48
    assert detail["k2_cells_per_s"] > 0 and detail["raw_kernel_batch"] == 8
    assert all(v > 0 for v in detail["transfer"].values())
    assert detail["mapping_alignments"] > 0 and len(detail["mapping_wall_s"]) == 2
    assert detail["pipeline_read_kbp_per_s"] > 0
    assert len(detail["quality"]["strain_recovery"]) == 3


def test_a_failed_block_is_reported_and_exits_1(toy, monkeypatch, capsys):
    def broken(device):
        raise RuntimeError("mapping broke")

    monkeypatch.setattr(bench_torch, "mapping_kbps", broken)
    rc, out = run_main(["--device", "cpu"], capsys)
    assert rc == 1
    lines = out.out.splitlines()
    assert len(lines) == 1
    detail = json.loads(lines[0])["detail"]
    assert detail["mapping_error"] == "RuntimeError: mapping broke"
    assert "pipeline_read_kbp_per_s" in detail and "mapping_read_kbp_per_s" not in detail
    assert "mapping_error" in out.err


def test_blocks_past_the_budget_are_skipped_and_exit_1(toy, monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "BUDGET_S", -1.0)
    rc, out = run_main(["--device", "cpu"], capsys)
    assert rc == 1
    line = json.loads(out.out)
    assert line["value"] > 0
    skipped = sorted(k for k in line["detail"] if k.endswith("_skipped"))
    assert skipped == sorted(f"{b}_skipped" for b in ("k2", "transfer", "raw_kernel", "mapping", "pipeline", "quality"))


def test_no_cuda_device_exits_1_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch.torch.cuda, "is_available", lambda: False)
    rc, out = run_main([], capsys)
    assert rc == 1 and out.out == ""
    assert "no CUDA device" in out.err

"""The fused int32 banded-DP call (`align_traceback_rows(kernel="pallas")`): on
the CPU it is the plain composition `banded_fused_plain`, which must stay
byte-identical to the JAX package's fused call with its Pallas kernel in
interpret mode, on the hand-made edge jobs of `chip_smoke.py` and on random
jobs, with alternating, all-global and all-extension modes.

The CUDA kernel itself cannot run here. Its bodies (`csrc/banded_fused.cu`
and the row recurrence of `csrc/banded_common.cuh`: staging, forward pass,
end-cell choice, walk, output copy) compile for the host with
`-DHS_HOST_EMULATION`, where the 32 lanes of a warp step in turn between the
warp's exchange points; that build is held against the plain composition
here, so the kernel's arithmetic and control flow are tested on every
machine, and its launch on the card by `chip_smoke.py` and
`tests/test_torch_cuda.py`.

Tolerance: none (bytes)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import MODE_PATTERNS, edge_jobs, mode_pattern, random_jobs
from hairsplitter_tpu.ops.align import BandSpec as JaxBandSpec
from hairsplitter_tpu.ops.align_device import align_traceback_rows as jax_align_traceback_rows
from hairsplitter_tpu_torch.ops import _build
from hairsplitter_tpu_torch.ops import align_dp_cuda as ad
from hairsplitter_tpu_torch.ops.align import BandSpec
from hairsplitter_tpu_torch.ops.align_device import (
    align_traceback_rows,
    banded_fused_plain,
    myers_fused_plain,
    traceback_rows_device,
)

CHUNK = 64
SPEC = BandSpec(chunk=CHUNK, band=128)
JSPEC = JaxBandSpec(chunk=CHUNK, band=128)


def _jobs(kind: str, spec):
    if kind == "edge":
        return edge_jobs(spec)
    return random_jobs(np.random.default_rng(21), 77, spec)


@pytest.mark.parametrize("pattern", MODE_PATTERNS)
@pytest.mark.parametrize("kind", ["edge", "random"])
def test_fused_cpu_call_equals_jax(kind, pattern):
    q, ql, t, tl = _jobs(kind, SPEC)
    keep = ql <= CHUNK  # the JAX call takes lengths up to the chunk
    idx = np.arange(-(-int(keep.sum()) // 32) * 32) % int(keep.sum())  # the Pallas call takes batches of 32
    q, ql, t, tl = q[keep][idx], ql[keep][idx], t[keep][idx], tl[keep][idx]
    modes = mode_pattern(pattern, q.shape[0])
    ref = np.asarray(jax_align_traceback_rows(q, ql, t, tl, modes, JSPEC, "pallas", interpret=True))
    tensors = [torch.from_numpy(x) for x in (q, ql, t, tl, modes)]
    before = _build.kernel_launch_counts()
    got = align_traceback_rows(*tensors, SPEC, "pallas").numpy()
    assert _build.kernel_launch_counts() == before  # CPU tensors never launch
    assert got.dtype == np.uint8 and got.shape == (q.shape[0], 16 + CHUNK)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(banded_fused_plain(*tensors, SPEC).numpy(), ref)


@pytest.mark.parametrize("chunk", [64, 256])
def test_plain_composition_equals_the_myers_one_on_every_defined_length(chunk):
    """The two DPs agree on the whole fused buffer, also on the lengths the
    JAX call does not take (qlen = B + 1: an all-INF extension row, a live
    column)."""
    spec = BandSpec(chunk=chunk, band=128)
    q, ql, t, tl = edge_jobs(spec)
    assert (ql > chunk).any()
    tensors = [torch.from_numpy(x) for x in (q, ql, t, tl, mode_pattern("alternating", ql.size))]
    assert torch.equal(banded_fused_plain(*tensors, spec), myers_fused_plain(*tensors, spec))


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    q, ql, t, tl = (torch.from_numpy(x) for x in _jobs("random", SPEC))
    modes = torch.zeros(q.shape[0], dtype=torch.int32)
    before = _build.kernel_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ad.banded_fused_cuda(q, ql, t, tl, modes, SPEC)
    with pytest.raises(ValueError, match="band 128"):
        ad.banded_fused_cuda(q, ql, t, tl, modes, BandSpec(chunk=CHUNK, band=64))
    with pytest.raises(ValueError, match="contiguous"):
        ad.banded_fused_cuda(q, ql, t[:, ::2][:, : t.shape[1] // 2], tl, modes, SPEC)
    with pytest.raises(ValueError, match="multiple of 16"):
        ad.banded_fused_cuda(q[:, :40].contiguous(), ql, t, tl, modes, BandSpec(chunk=40, band=128))
    with pytest.raises(TypeError, match="modes"):
        ad.banded_fused_cuda(q, ql, t, tl, modes.to(torch.int64), SPEC)
    assert _build.kernel_launch_counts() == before


def test_fused_call_rejects_other_devices_and_other_bands():
    q, ql, t, tl = (torch.from_numpy(x) for x in _jobs("random", SPEC))
    modes = torch.zeros(q.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        align_traceback_rows(q.to("meta"), ql, t, tl, modes, SPEC, "pallas")
    with pytest.raises(ValueError, match="band 128"):
        align_traceback_rows(q, ql, t, tl, modes, BandSpec(chunk=CHUNK, band=64), "pallas")


def test_kernel_sources_are_part_of_the_build():
    assert "banded_fused.cu" in _build.SOURCES and "banded_dp.cu" in _build.SOURCES
    assert "banded_common.cuh" in _build.HEADERS
    for name in _build.SOURCES + _build.HEADERS:
        assert os.path.exists(os.path.join(_build.CSRC_DIR, name)), name


# ---------------------------------------------------------------- host build of the kernel bodies


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel bodies for the host")
    so = str(tmp_path_factory.mktemp("banded_host") / "libbanded_fused_host.so")
    src = os.path.join(_build.CSRC_DIR, "banded_fused.cu")
    subprocess.run(
        [gxx, "-x", "c++", "-DHS_HOST_EMULATION", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so, src],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(so)
    lib.hs_banded_fused_host.restype = ctypes.c_int
    lib.hs_banded_fused_host.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.hs_banded_walk_host.restype = ctypes.c_int
    lib.hs_banded_walk_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def run(q, ql, t, tl, modes):
        n, B = q.shape
        arrays = [np.ascontiguousarray(x) for x in (q, t, ql, tl, modes)]
        out = np.full((n, 16 + B), 0xCD, np.uint8)  # the kernel must write every byte of a row
        rc = lib.hs_banded_fused_host(*(a.ctypes.data for a in arrays), n, B, t.shape[1], out.ctypes.data)
        assert rc == 0
        return out

    def walk(bp, start_i, start_b):
        n, B, _ = bp.shape
        toks = np.full((n, B), 0xCD, np.uint8)
        rc = lib.hs_banded_walk_host(bp.ctypes.data, start_i.ctypes.data, start_b.ctypes.data, n, B, toks.ctypes.data)
        assert rc == 0
        return toks

    run.walk = walk
    return run


@pytest.mark.parametrize("pattern", MODE_PATTERNS)
@pytest.mark.parametrize("kind", ["edge", "random"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_kernel_bodies_on_host_equal_plain_composition(host_kernel, chunk, kind, pattern):
    spec = BandSpec(chunk=chunk, band=128)
    q, ql, t, tl = _jobs(kind, spec)  # 77 random jobs, a block of one warp each
    modes = mode_pattern(pattern, q.shape[0])
    ref = banded_fused_plain(*(torch.from_numpy(x) for x in (q, ql, t, tl, modes)), spec).numpy()
    got = host_kernel(q, ql, t, tl, modes)
    bad = np.nonzero((got != ref).any(axis=1))[0]
    assert bad.size == 0, f"jobs {bad[:8].tolist()}: qlen {ql[bad[:8]].tolist()}, tlen {tl[bad[:8]].tolist()}"


def test_host_build_covers_ties_dead_jobs_and_clipped_walks(host_kernel):
    """What the comparison above rests on: the jobs hold ties of the
    extension row's minimum and of the column minimum, dead jobs, clipped
    extensions and walks that cross a LEFT run."""
    spec = BandSpec(chunk=256, band=128)
    q, ql, t, tl = (np.concatenate(pair) for pair in zip(edge_jobs(spec), _jobs("random", spec)))
    tensors = [torch.from_numpy(x) for x in (q, ql, t, tl)]
    res = ad.banded_align_batch_torch(*tensors, spec)
    row, bar = res["row_at_q"].numpy().astype(np.int64), np.arange(128)
    j = ql[:, None] + bar[None, :] - 64
    masked = np.where((j >= 0) & (j <= tl[:, None]), row, 1 << 20)
    live = masked.min(axis=1) < (1 << 20)
    assert ((masked == masked.min(axis=1, keepdims=True)).sum(axis=1)[live] > 1).any()  # argmin ties
    modes = mode_pattern("alternating", ql.size)  # a global job dies when its corner leaves the band
    fused = host_kernel(q, ql, t, tl, modes)
    meta = fused[:, :16].copy().view(np.int32)
    dead = meta[:, 0] >= (1 << 20)
    assert dead.any() and (~dead).any()
    assert (meta[~dead, 1] > 0).any()  # a clipped extension: the column minimum won
    assert (fused[dead, 16:] == 0).all() and (meta[dead, 2] == 0).all() and (meta[dead, 3] == 64).all()
    toks = fused[:, 16:]
    assert ((toks & 0x7F) > 0).any() and ((toks >> 7) > 0).any()  # deletions and insertions on the walks


@pytest.mark.parametrize("left_share", [0.2, 0.9, 1.0])
def test_walk_on_host_equals_traceback_scan_on_any_plane(host_kernel, left_share):
    """The walk alone, on planes and start cells that no alignment produces:
    rows with no non-LEFT cell at or below the walk (run code 0: the walk
    falls to cell 0), an UP at the band's top cell (the walk leaves the band
    and reads 0 from then on) and starts outside [0, W)."""
    rng = np.random.default_rng(int(left_share * 10))
    n, B, W = 96, 64, 128
    bp = np.where(rng.random((n, B, W)) < left_share, 2, rng.integers(0, 2, (n, B, W))).astype(np.uint8)
    bp[::3, :, W - 1] = 1  # UP at the top cell
    start_i = rng.integers(0, B + 1, n).astype(np.int32)
    start_b = rng.integers(-3, W + 3, n).astype(np.int32)
    start_b[::3] = W - 1
    ref = traceback_rows_device(torch.from_numpy(bp), torch.from_numpy(start_i), torch.from_numpy(start_b), SPEC)
    got = host_kernel.walk(bp, start_i, start_b)
    np.testing.assert_array_equal(got, ref.numpy())

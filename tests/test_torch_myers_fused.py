"""The fused Myers call (`align_traceback_rows(kernel="myers")`): on the CPU it
is the plain composition `myers_fused_plain`, which must stay byte-identical
to the JAX package's fused call with its Pallas kernel in interpret mode, on
the hand-made edge jobs of `chip_smoke.py` and on random jobs, with
alternating, all-global and all-extension modes.

The CUDA kernel itself cannot run here. Its bodies (`csrc/myers_fused.cu`:
staging, forward pass with the readout, end-cell choice, walk) compile for
the host with `-DHS_HOST_EMULATION`, where a block's threads run one after
another; that build is held against the plain composition here, so the
kernel's arithmetic and control flow are tested on every machine, and its
launch on the card by `chip_smoke.py` and `tests/test_torch_cuda.py`.

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
from hairsplitter_tpu_torch.ops import align_myers_cuda as am
from hairsplitter_tpu_torch.ops.align import BandSpec
from hairsplitter_tpu_torch.ops.align_device import align_traceback_rows, myers_fused_plain

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
    ref = np.asarray(jax_align_traceback_rows(q, ql, t, tl, modes, JSPEC, "myers", interpret=True))
    before = _build.kernel_launch_counts()
    got = align_traceback_rows(*(torch.from_numpy(x) for x in (q, ql, t, tl, modes)), SPEC, "myers").numpy()
    assert _build.kernel_launch_counts() == before  # CPU tensors never launch
    assert got.dtype == np.uint8 and got.shape == (q.shape[0], 16 + CHUNK)
    np.testing.assert_array_equal(got, ref)


def test_edge_jobs_cover_the_corners():
    q, ql, t, tl = edge_jobs(BandSpec())
    B, T = 256, 319
    assert q.shape[1] == B and t.shape[1] == T
    assert {0, 1, B, B + 1} <= set(ql.tolist()) and {0, T} <= set(tl.tolist())
    assert ((tl < ql - 64) & (ql <= B)).any()  # corner left of the band
    assert (tl > ql + 63).any()  # corner right of the band
    modes = mode_pattern("alternating", ql.size)
    fused = myers_fused_plain(*(torch.from_numpy(x) for x in (q, ql, t, tl, modes)), BandSpec()).numpy()
    meta = fused[:, :16].copy().view(np.int32)
    dead = meta[:, 0] >= (1 << 20)
    assert dead.any() and (~dead).any()  # unreachable end cells and real walks
    assert (meta[~dead, 1] > 0).any()  # a clipped extension (target-exhausted column)
    assert (fused[dead, 16:] == 0).all() and (meta[dead, 2] == 0).all() and (meta[dead, 3] == 64).all()


def test_fused_call_rejects_other_devices_and_cuda_wrapper_rejects_cpu():
    q, ql, t, tl = (torch.from_numpy(x) for x in _jobs("random", SPEC))
    modes = torch.zeros(q.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError):
        am.myers_fused_cuda(q, ql, t, tl, modes, SPEC)
    with pytest.raises(ValueError):
        align_traceback_rows(q.to("meta"), ql, t, tl, modes, SPEC, "myers")
    with pytest.raises(ValueError):
        align_traceback_rows(q, ql, t, tl, modes, BandSpec(chunk=CHUNK, band=64), "myers")


# ---------------------------------------------------------------- host build of the kernel bodies


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel bodies for the host")
    so = str(tmp_path_factory.mktemp("fused_host") / "libmyers_fused_host.so")
    src = os.path.join(_build.CSRC_DIR, "myers_fused.cu")
    subprocess.run(
        [gxx, "-x", "c++", "-DHS_HOST_EMULATION", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so, src],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(so)
    lib.hs_myers_fused_host.restype = ctypes.c_int
    lib.hs_myers_fused_host.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2

    def run(q, ql, t, tl, modes, spec):
        n, B = q.shape
        arrays = [np.ascontiguousarray(x) for x in (q, t, ql, tl, modes)]
        scratch = np.full((B, n, 2, 4), 0xDEADBEEF, np.uint32)  # the kernel may read only what it wrote
        out = np.full((n, 16 + B), 0xCD, np.uint8)
        rc = lib.hs_myers_fused_host(*(a.ctypes.data for a in arrays), n, B, t.shape[1],
                                     scratch.ctypes.data, out.ctypes.data)
        assert rc == 0
        return out

    return run


@pytest.mark.parametrize("pattern", MODE_PATTERNS)
@pytest.mark.parametrize("kind", ["edge", "random"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_kernel_bodies_on_host_equal_plain_composition(host_kernel, chunk, kind, pattern):
    spec = BandSpec(chunk=chunk, band=128)
    q, ql, t, tl = _jobs(kind, spec)  # 77 random jobs: two full blocks and a ragged one
    modes = mode_pattern(pattern, q.shape[0])
    ref = myers_fused_plain(*(torch.from_numpy(x) for x in (q, ql, t, tl, modes)), spec).numpy()
    got = host_kernel(q, ql, t, tl, modes, spec)
    bad = np.nonzero((got != ref).any(axis=1))[0]
    assert bad.size == 0, f"jobs {bad[:8].tolist()}: qlen {ql[bad[:8]].tolist()}, tlen {tl[bad[:8]].tolist()}"

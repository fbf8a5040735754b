"""Stage 3's window statistics as a ragged batch (`ops/variants.py`:
`pack_window_blocks`, `window_stats_packed`, `window_stats_blocks`) and the
one route of `pipeline/call_variants.py:finish_preps` on every device.

The CUDA kernel itself cannot run here. Its body (`csrc/window_stats.cu`:
histogram, top-3, coverage and the per-column error counts) compiles for
the host with `-DHS_HOST_EMULATION`, where a block's threads run one after
another; that build and the plain PyTorch composition are held against the
numpy twins `column_stats_host` and `window_error_stats_host`, block by
block, on ragged batches of 1 to 70,000 rows (`chip_smoke.py:
window_blocks`: all-absent columns, columns past a block's length, forced
count ties, counts above 65,535). The launch on the card is tested by
`tests/test_torch_cuda.py` and `chip_smoke.py`.

Tolerance: none (integers)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import window_blocks
from hairsplitter_tpu_torch.ops import _build
from hairsplitter_tpu_torch.ops import variants as V
from hairsplitter_tpu_torch.pipeline import call_variants as cv
from hairsplitter_tpu_torch.utils import tracing

BATCHES = {
    "mixed": ((1, 31, 64, 257, 2000, 64), 1000),  # P not a multiple of the kernel's 64 columns
    "deep": ((70_000, 3, 1), 8),  # a narrow window whose counts pass 65,535
}


@pytest.fixture(params=sorted(BATCHES))
def batch(request):
    rows, P = BATCHES[request.param]
    return window_blocks(np.random.default_rng(len(rows)), rows, P)


def _twins(tri, code):
    tc, tn, cov = V.column_stats_host(tri)
    mm, cc = V.window_error_stats_host(tri, code)
    return tc, tn, cov, mm, cc


def _assert_equal_to_twins(got, tris, codes):
    """got: (top codes, top counts, coverage, mismatched, covered), one
    entry per block on the first axis."""
    for b, (tri, code) in enumerate(zip(tris, codes)):
        ref = _twins(tri, code)
        for name, g, r in zip(("top codes", "top counts", "coverage"), got[:3], ref[:3]):
            assert g[b].dtype == np.int32, name
            np.testing.assert_array_equal(g[b], r, err_msg=f"block {b}: {name}")
        assert (int(got[3][b]), int(got[4][b])) == ref[3:], f"block {b}: error counts"


def test_batches_hold_the_edge_cases(batch):
    tris, codes = batch
    for tri in tris:
        R, P = tri.shape
        tc, tn, cov = V.column_stats_host(tri)
        assert (cov[::7] == 0).all() and (tc[::7] == [0, 1, 2]).all()  # all-absent columns
        assert (cov[P - P // 5 :] == 0).all()  # past the block's length
        tie = np.arange(1, P, 7)
        tie = tie[tie < P - P // 5]
        if R % 2 == 0:  # equal counts: the smaller code first
            assert (tc[tie, :2] == [3, 120]).all() and (tn[tie, 0] == tn[tie, 1]).all()
        if R > 65_535:
            assert (tn[2:6, 0] == R).all()


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the host")
    so = str(tmp_path_factory.mktemp("window_stats_host") / "libwindow_stats_host.so")
    src = os.path.join(_build.CSRC_DIR, "window_stats.cu")
    subprocess.run(
        [gxx, "-x", "c++", "-DHS_HOST_EMULATION", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so, src],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(so)
    lib.hs_window_stats_host.restype = ctypes.c_int
    lib.hs_window_stats_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5

    def run(tris, codes):
        staging, offsets = V.pack_window_blocks(tris, codes)
        rows, (nb, P) = int(offsets[-1]), (len(tris), codes[0].shape[0])
        flat = np.ascontiguousarray(staging.numpy()[:rows])
        code = np.ascontiguousarray(staging.numpy()[rows:])
        out = [np.full((nb, P, 3), -7, np.int32), np.full((nb, P, 3), -7, np.int32),
               np.full((nb, P), -7, np.int32), np.full(nb, -7, np.int64), np.full(nb, -7, np.int64)]
        rc = lib.hs_window_stats_host(flat.ctypes.data, offsets.ctypes.data, code.ctypes.data, nb, P,
                                      *(o.ctypes.data for o in out))
        assert rc == 0
        return out

    return run


def test_kernel_body_equals_numpy_twins(host_kernel, batch):
    tris, codes = batch
    _assert_equal_to_twins(host_kernel(tris, codes), tris, codes)


def test_packed_plain_composition_equals_numpy_twins(batch):
    tris, codes = batch
    staging, offsets = V.pack_window_blocks(tris, codes)
    rows = int(offsets[-1])
    buf = V.window_stats_packed(staging[:rows], torch.from_numpy(offsets), staging[rows:])
    assert buf.dtype == torch.uint8 and buf.shape == (V.window_stats_bytes(len(tris), codes[0].shape[0]),)
    got = [x.numpy() for x in V.unpack_window_stats(buf, len(tris), codes[0].shape[0])]
    _assert_equal_to_twins(got, tris, codes)
    _assert_equal_to_twins(V.window_stats_blocks(tris, codes, "cpu"), tris, codes)


def test_ragged_packing_round_trips(batch):
    tris, codes = batch
    staging, offsets = V.pack_window_blocks(tris, codes)
    host = staging.numpy()
    assert offsets.dtype == np.int64 and offsets.shape == (len(tris) + 1,) and offsets[0] == 0
    assert staging.dtype == torch.int8 and staging.shape == (int(offsets[-1]) + len(tris), codes[0].shape[0])
    for b, (tri, code) in enumerate(zip(tris, codes)):
        np.testing.assert_array_equal(host[offsets[b] : offsets[b + 1]], tri)
        np.testing.assert_array_equal(host[offsets[-1] + b], code)


def test_dense_batch_on_cpu_is_the_plain_composition():
    tris, codes = window_blocks(np.random.default_rng(5), (48, 48, 48), 300)
    tri, code = torch.from_numpy(np.stack(tris)), torch.from_numpy(np.stack(codes))
    for g, r in zip(V.window_stats_batch(tri, code), V.window_stats_plain(tri, code)):
        assert torch.equal(g, r)


def test_wrappers_reject_what_they_do_not_take():
    tris, codes = window_blocks(np.random.default_rng(6), (4, 5), 64)
    staging, offsets = V.pack_window_blocks(tris, codes)
    flat, code, offs = staging[:9], staging[9:], torch.from_numpy(offsets)
    with pytest.raises(TypeError):
        V.window_stats_packed(flat.to(torch.int32), offs, code)
    with pytest.raises(ValueError):
        V.window_stats_packed(flat, offs[:2], code)
    with pytest.raises(ValueError):
        V.window_stats_packed(flat[:, :32], offs, code)
    out = V.unpack_window_stats(torch.empty(V.window_stats_bytes(2, 64), dtype=torch.uint8), 2, 64)
    before = _build.kernel_launch_counts()["window_stats"]
    with pytest.raises(ValueError):
        V.window_stats_cuda(flat, offs, code, out)
    assert _build.kernel_launch_counts()["window_stats"] == before


# ---------------------------------------------------------------- finish_preps' route


def _pending(rows_per_contig, P=512, seed=9):
    """PendingPreps of contigs made of `window_blocks`."""
    from hairsplitter_tpu_torch.pipeline.pileup import WindowBlock

    rng = np.random.default_rng(seed)
    pending = []
    for ci, rows in enumerate(rows_per_contig):
        tris, codes = window_blocks(rng, rows, P)
        blocks = [WindowBlock(f"c{ci}", b * P, P, np.arange(t.shape[0]), t) for b, t in enumerate(tris)]
        prep = cv.ContigPrep(contig=f"c{ci}", length=P * len(rows), n_reads=max(rows), mismatches=0, cells=0)
        pending.append(cv.PendingPrep(prep, blocks, codes))
    return pending


def _run_finish(rows_per_contig, device):
    first = next(tracing._ids)
    with tracing.span("stats") as sp:
        preps = cv.finish_preps(_pending(rows_per_contig), cv.VariantCallConfig(window=512), device=device)
    under = [(s.name, s.counts) for s in tracing.spans() if s.id > first and s.parent == sp.id]
    return preps, sp.counts, under


def _fields(preps):
    return {
        name: (p.mismatches, p.cells, [(blk.start, tc.tolist(), tn.tolist(), cov.tolist())
                                      for blk, tc, tn, cov in p.win_stats])
        for name, p in preps.items()
    }


ROWS = ((60, 64, 300), (257, 31))  # two contigs of ragged blocks, 31 to 300 rows


def test_cpu_route_sends_every_block_in_one_pass(monkeypatch):
    """On the CPU, as on CUDA, every block of every contig goes to one
    `window_stats_blocks` call in one device_pass span; every field of
    every ContigPrep equals the numpy twins', block by block."""
    calls = []
    inner = cv.window_stats_blocks

    def spy(tris, codes, device):
        calls.append((len(tris), torch.device(device).type))
        return inner(tris, codes, device)

    monkeypatch.setattr(cv, "window_stats_blocks", spy)
    preps, counts, under = _run_finish(ROWS, "cpu")
    assert calls == [(5, "cpu")]
    assert counts == {} and under == [("device_pass", {"blocks": 5}), ("host_pass", {})]
    for pp in _pending(ROWS):
        p = preps[pp.prep.contig]
        for (blk, tc, tn, cov), tri, code in zip(p.win_stats, [b.tri for b in pp.blocks], pp.codes_ws, strict=True):
            ref = _twins(tri, code)
            for g, r in zip((tc, tn, cov), ref):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, r)
        assert (p.mismatches, p.cells) == tuple(
            map(sum, zip(*[_twins(b.tri, c)[3:] for b, c in zip(pp.blocks, pp.codes_ws)])))


def test_cuda_route_sends_every_block_in_one_pass(monkeypatch):
    """On CUDA every block of every contig goes to `window_stats_blocks` in
    one call and one device_pass span: here the call is made on the CPU's
    plain composition, so the route's packing and collection are held
    against the CPU route, field for field."""
    calls = []

    def on_cpu(tris, codes, device):
        calls.append((len(tris), torch.device(device).type))
        return V.window_stats_blocks(tris, codes, "cpu")

    ref, _, _ = _run_finish(ROWS, "cpu")
    monkeypatch.setattr(cv, "window_stats_blocks", on_cpu)
    got, _, under = _run_finish(ROWS, "cuda")
    assert calls == [(5, "cuda")]
    assert under == [("device_pass", {"blocks": 5}), ("host_pass", {})]
    assert _fields(got) == _fields(ref)


def test_finish_preps_with_no_contig_passes_nothing(monkeypatch):
    """A process that owns no contig (a shard of a job over several
    devices can be empty) sends nothing to the device."""
    def refuse(*a, **k):
        raise AssertionError("window_stats_blocks called with no block")

    monkeypatch.setattr(cv, "window_stats_blocks", refuse)
    preps, _, under = _run_finish((), "cpu")
    assert preps == {} and under == [("host_pass", {})]

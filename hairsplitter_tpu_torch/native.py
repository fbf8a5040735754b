"""ctypes bindings for the native host-runtime library.

Builds `csrc/hs_native.cpp` with g++ on first use into the package's
git-ignored `build/` directory (`ops/_build.py:build_native`, under a name
that carries a hash of the source) and exposes the accelerated host loops.
Every entry point has a pure-Python fallback, so the engine works without a
toolchain; set HS_NATIVE=0 to disable.

Copy of `hairsplitter_tpu/native.py`: same functions, names and results; only
the library's source and build location are this package's own.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .ops import _build

_LIB = None
_TRIED = False


def get_lib():
    """The loaded native library, building it if needed; None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("HS_NATIVE", "1") == "0":
        return None
    try:
        lib = ctypes.CDLL(_build.build_native())
    except (OSError, RuntimeError):
        return None
    lib.hs_lis_monotonic.restype = ctypes.c_int64
    lib.hs_lis_monotonic.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hs_create_read_graph.restype = None
    lib.hs_create_read_graph.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int8),
    ]
    lib.hs_chinese_whispers.restype = None
    lib.hs_chinese_whispers.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_uint64,
    ]
    lib.hs_banded_align_tb.restype = None
    lib.hs_banded_align_tb.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.hs_merge_close_clusters.restype = None
    lib.hs_merge_close_clusters.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.hs_minimizers.restype = ctypes.c_int64
    lib.hs_minimizers.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int8),
    ]
    lib.hs_chain_sweep.restype = ctypes.c_int64
    lib.hs_chain_sweep.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hs_select_pins.restype = ctypes.c_int64
    lib.hs_select_pins.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hs_poa_consensus.restype = ctypes.c_int64
    lib.hs_poa_consensus.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64,
    ]
    lib.hs_index_lookup.restype = ctypes.c_int64
    lib.hs_index_lookup.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hs_poa_consensus_batch.restype = ctypes.c_int64
    lib.hs_poa_consensus_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.hs_expand_rows.restype = ctypes.c_int64
    lib.hs_expand_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _LIB = lib
    return _LIB


def _ptr(arr, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def lis_monotonic(q: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.int64)
    out = np.empty(q.size, dtype=np.int64)
    n = lib.hs_lis_monotonic(_ptr(q, ctypes.c_int64), q.size, _ptr(out, ctypes.c_int64))
    return out[:n]


def create_read_graph(sim: np.ndarray, diff: np.ndarray, mask: np.ndarray, error_rate: float):
    lib = get_lib()
    if lib is None:
        return None
    n = mask.size
    sim = np.ascontiguousarray(sim, dtype=np.int32)
    diff = np.ascontiguousarray(diff, dtype=np.int32)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    adj = np.zeros((n, n), dtype=np.int8)
    lib.hs_create_read_graph(
        _ptr(sim, ctypes.c_int32),
        _ptr(diff, ctypes.c_int32),
        _ptr(m, ctypes.c_uint8),
        n,
        float(error_rate),
        _ptr(adj, ctypes.c_int8),
    )
    return adj


def chinese_whispers(adj: np.ndarray, init: np.ndarray, mask: np.ndarray, n_iters: int = 15, seed: int = 0):
    lib = get_lib()
    if lib is None:
        return None
    n = mask.size
    a = np.ascontiguousarray(adj, dtype=np.int8)
    labels = np.ascontiguousarray(init, dtype=np.int64).copy()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    lib.hs_chinese_whispers(
        _ptr(a, ctypes.c_int8),
        n,
        _ptr(labels, ctypes.c_int64),
        _ptr(m, ctypes.c_uint8),
        n_iters,
        seed,
    )
    return labels


def banded_align_tb(qb, qlens, tb, tlens, modes, band: int, n_threads: int = 0):
    """Fused banded DP + readout + traceback for the CPU backend —
    bit-identical to `banded_align_batch` + `readout` + `traceback_batch`
    (ops/align.py). Returns (ops_list, cost[int64], clip[int64]) or None if
    the library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "hs_banded_align_tb"):
        return None
    qb = np.ascontiguousarray(qb, dtype=np.int8)
    tb = np.ascontiguousarray(tb, dtype=np.int8)
    ql = np.ascontiguousarray(qlens, dtype=np.int32)
    tl = np.ascontiguousarray(tlens, dtype=np.int32)
    md = np.ascontiguousarray(modes, dtype=np.int32)
    n, B = qb.shape
    T = tb.shape[1]
    stride = B + T + 1
    ops = np.empty((n, stride), dtype=np.int8)
    n_ops = np.zeros(n, dtype=np.int32)
    cost = np.zeros(n, dtype=np.int64)
    clip = np.zeros(n, dtype=np.int64)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    lib.hs_banded_align_tb(
        _ptr(qb, ctypes.c_int8),
        _ptr(ql, ctypes.c_int32),
        _ptr(tb, ctypes.c_int8),
        _ptr(tl, ctypes.c_int32),
        _ptr(md, ctypes.c_int32),
        n,
        B,
        T,
        band,
        _ptr(ops, ctypes.c_int8),
        stride,
        _ptr(n_ops, ctypes.c_int32),
        _ptr(cost, ctypes.c_int64),
        _ptr(clip, ctypes.c_int64),
        n_threads,
    )
    return [ops[i, : n_ops[i]] for i in range(n)], cost, clip


def merge_close_clusters(adj: np.ndarray, labels: np.ndarray, mask: np.ndarray):
    """Native twin of `pipeline.separate_reads.merge_close_clusters`
    (bit-identical; reference `cluster_graph.cpp:402-501`); None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "hs_merge_close_clusters"):
        return None
    n = mask.size
    a = np.ascontiguousarray(adj, dtype=np.int8)
    out = np.ascontiguousarray(labels, dtype=np.int64).copy()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    lib.hs_merge_close_clusters(
        _ptr(a, ctypes.c_int8), n, _ptr(out, ctypes.c_int64), _ptr(m, ctypes.c_uint8)
    )
    return out


def minimizers(codes: np.ndarray, k: int, w: int):
    """Native twin of `core.seeding.minimizers` (bit-identical); None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    m = max(0, codes.size - k + 1)
    pos = np.empty(m, dtype=np.int64)
    h = np.empty(m, dtype=np.uint64)
    strand = np.empty(m, dtype=np.int8)
    cnt = lib.hs_minimizers(
        _ptr(codes, ctypes.c_int8),
        codes.size,
        k,
        w,
        _ptr(pos, ctypes.c_int64),
        _ptr(h, ctypes.c_uint64),
        _ptr(strand, ctypes.c_int8),
    )
    return pos[:cnt], h[:cnt], strand[:cnt]


def chain_sweep(q: np.ndarray, t: np.ndarray, max_gap: int, max_diag_diff: int):
    """Native twin of the chain_anchors break loop; returns boundary indices
    [0, b1, ..., n], or None."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.int64)
    t = np.ascontiguousarray(t, dtype=np.int64)
    breaks = np.empty(q.size + 2, dtype=np.int64)
    nb = lib.hs_chain_sweep(
        _ptr(q, ctypes.c_int64),
        _ptr(t, ctypes.c_int64),
        q.size,
        int(max_gap),
        int(max_diag_diff),
        _ptr(breaks, ctypes.c_int64),
    )
    return breaks[:nb]


def index_lookup(index_hashes: np.ndarray, query_hashes: np.ndarray, max_occ: int):
    """Native twin of `MinimizerIndex.lookup`'s probe (bit-identical hit
    order: by query, then index offset). Returns (qidx, at) or None."""
    lib = get_lib()
    if lib is None:
        return None
    ih = np.ascontiguousarray(index_hashes, dtype=np.uint64)
    qh = np.ascontiguousarray(query_hashes, dtype=np.uint64)
    cap = int(4 * qh.size + 1024)
    for _ in range(2):
        qidx = np.empty(cap, dtype=np.int64)
        at = np.empty(cap, dtype=np.int64)
        n = lib.hs_index_lookup(
            _ptr(ih, ctypes.c_uint64),
            ih.size,
            _ptr(qh, ctypes.c_uint64),
            qh.size,
            int(max_occ),
            cap,
            _ptr(qidx, ctypes.c_int64),
            _ptr(at, ctypes.c_int64),
        )
        if n >= 0:
            return qidx[:n], at[:n]
        cap = int(qh.size * max_occ + 1024)  # worst case, one retry
    return None


def poa_consensus(
    seqs: list[np.ndarray],
    match: int = 3,
    mismatch: int = -5,
    gap: int = -4,
    min_cov: int = 0,
) -> np.ndarray | None:
    """Partial-order-alignment consensus over int8 code sequences (first =
    backbone window layer). racon/spoa equivalent with racon's default
    scores; None if the native library is unavailable."""
    lib = get_lib()
    if lib is None or not seqs:
        return None
    flat = np.concatenate([np.ascontiguousarray(s, dtype=np.int8) for s in seqs])
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    cap = int(flat.size + 16)
    out = np.empty(cap, dtype=np.int8)
    n = lib.hs_poa_consensus(
        _ptr(flat, ctypes.c_int8),
        _ptr(offsets, ctypes.c_int64),
        len(seqs),
        int(match),
        int(mismatch),
        int(gap),
        int(min_cov),
        _ptr(out, ctypes.c_int8),
        cap,
    )
    if n < 0:
        return None
    return out[:n]


def poa_consensus_batch(
    windows: list[list[np.ndarray]],
    match: int = 3,
    mismatch: int = -5,
    gap: int = -4,
    min_covs: list[int] | None = None,
    n_threads: int | None = None,
) -> list[np.ndarray | None] | None:
    """POA consensus over many independent windows in one native call,
    striped across host threads (each window = one `poa_consensus` job,
    identical results). None if the library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "hs_poa_consensus_batch"):
        return None
    W = len(windows)
    if W == 0:
        return []
    layers: list[np.ndarray] = []
    win_layer_off = np.zeros(W + 1, dtype=np.int64)
    for w, ls in enumerate(windows):
        layers.extend(np.ascontiguousarray(s, dtype=np.int8) for s in ls)
        win_layer_off[w + 1] = win_layer_off[w] + len(ls)
    flat = np.concatenate(layers) if layers else np.zeros(0, dtype=np.int8)
    offsets = np.zeros(len(layers) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in layers], out=offsets[1:])
    covs = np.asarray(
        min_covs if min_covs is not None else [0] * W, dtype=np.int32
    )
    out_off = np.zeros(W + 1, dtype=np.int64)
    np.cumsum(
        [int(offsets[win_layer_off[w + 1]] - offsets[win_layer_off[w]]) + 16 for w in range(W)],
        out=out_off[1:],
    )
    out = np.empty(int(out_off[-1]), dtype=np.int8)
    out_lens = np.empty(W, dtype=np.int64)
    if n_threads is None:
        n_threads = min(int(os.environ.get("HS_THREADS", "0")) or (os.cpu_count() or 1), W)
    lib.hs_poa_consensus_batch(
        _ptr(flat, ctypes.c_int8),
        _ptr(offsets, ctypes.c_int64),
        _ptr(win_layer_off, ctypes.c_int64),
        W,
        int(match),
        int(mismatch),
        int(gap),
        _ptr(covs, ctypes.c_int32),
        _ptr(out, ctypes.c_int8),
        _ptr(out_off, ctypes.c_int64),
        _ptr(out_lens, ctypes.c_int64),
        int(n_threads),
    )
    return [
        (out[out_off[w] : out_off[w] + out_lens[w]].copy() if out_lens[w] >= 0 else None)
        for w in range(W)
    ]


def expand_rows(toks: np.ndarray, meta: np.ndarray, qb: np.ndarray, tb: np.ndarray, dl: int):
    """Native twin of `ops.align_device.expand_rows_host`'s numpy decode
    (bit-identical): per-row traceback tokens -> concatenated forward op
    streams + N+1 prefix offsets. None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    toks = np.ascontiguousarray(toks, dtype=np.uint8)
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    qb = np.ascontiguousarray(qb, dtype=np.int8)
    tb = np.ascontiguousarray(tb, dtype=np.int8)
    N, B = toks.shape
    T = tb.shape[1]
    # every walk is <= B rows + a <= t_width deletion tail (see traceback docs)
    cap = N * (B + T + 1)
    ops_out = np.empty(cap, dtype=np.int8)
    offsets = np.empty(N + 1, dtype=np.int64)
    total = lib.hs_expand_rows(
        _ptr(toks, ctypes.c_uint8),
        _ptr(meta, ctypes.c_int32),
        _ptr(qb, ctypes.c_int8),
        _ptr(tb, ctypes.c_int8),
        N,
        B,
        T,
        int(dl),
        cap,
        _ptr(ops_out, ctypes.c_int8),
        _ptr(offsets, ctypes.c_int64),
    )
    if total < 0:
        return None
    return ops_out[:total], offsets


def select_pins(qa: np.ndarray, ta: np.ndarray, B: int, T: int, md: int):
    """Native twin of `core.mapping.select_pins` (pre-dedupe); None if
    unavailable or if the conservative capacity bound is exceeded."""
    lib = get_lib()
    if lib is None:
        return None
    qa = np.ascontiguousarray(qa, dtype=np.int64)
    ta = np.ascontiguousarray(ta, dtype=np.int64)
    n = qa.size
    span_q = int(qa[-1] - qa[0])
    span_t = int(ta[-1] - ta[0])
    cap = 2 * n + span_q // max(1, B) + span_t // max(1, T) + (span_q + span_t) // max(1, md) + 16
    out = np.empty(2 * cap, dtype=np.int64)
    cnt = lib.hs_select_pins(
        _ptr(qa, ctypes.c_int64),
        _ptr(ta, ctypes.c_int64),
        n,
        int(B),
        int(T),
        int(md),
        cap,
        _ptr(out, ctypes.c_int64),
    )
    if cnt < 0:
        return None
    pairs = out[: 2 * cnt].reshape(cnt, 2)
    return pairs

"""Seeding and chaining on the card: one launch of `csrc/chain_seeds.cu`
turns a batch of reads' base codes into every read's accepted chains.

The chains are those of `core/seeding.py:find_chains_batch`, bit for bit:
that host route (numpy and the native C++ twins) is the CPU route and the
kernel's twin. `find_chains_cuda` packs the reads into one pinned buffer
(homopolymer-compressed on the host when the index is, with each
compressed base's original offset), copies it in once, launches the kernel
once and copies one packed result back (`unpack_chains`). The index's four
sorted arrays go to the card once per index object and device
(`device_index`), so the batches of one index reuse them. The kernel
counts a read's hits before it places them; when the scratch estimated
from the reads' lengths is too small, the result says how many hits there
are and the call launches again at that size. An output that does not fit
raises; it is never cut, and a CUDA call never falls back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.seeding import Chain, MinimizerIndex

N_TOTALS = 8  # the result's uint64 totals: hits, anchors, chains, reads done, overflow
T_HITS, T_ANCHORS, T_CHAINS, T_READS, T_OVERFLOW = range(5)
SCRATCH_BYTES_PER_HIT = 8 + 4 + 4 * 16  # csrc/chain_seeds.cu: hs_chain_seeds_scratch_bytes


def _align8(n: int) -> int:
    return (n + 7) // 8 * 8


def chain_capacity(cap_hits: int, min_anchors: int) -> int:
    """Chain records the result holds for `cap_hits` hits: every accepted
    chain has at least max(1, min_anchors) anchors, each a distinct hit."""
    return cap_hits // max(1, min_anchors) + 1


def result_bytes(n_reads: int, cap_hits: int, min_anchors: int) -> int:
    """Size of the packed result: uint64 totals [8], int32 (first chain,
    chain count) [n_reads, 2], int32 chain records (contig, strand, anchor
    count, first anchor) [cap_chains, 4], int32 (q, t) anchors [cap_hits, 2]."""
    return 8 * N_TOTALS + 8 * n_reads + 16 * chain_capacity(cap_hits, min_anchors) + 8 * cap_hits


def _result_views(buf: np.ndarray, n_reads: int, cap_hits: int, min_anchors: int):
    cap_c = chain_capacity(cap_hits, min_anchors)
    o1 = 8 * N_TOTALS
    o2 = o1 + 8 * n_reads
    o3 = o2 + 16 * cap_c
    totals = buf[:o1].view(np.uint64)
    hdr = buf[o1:o2].view(np.int32).reshape(n_reads, 2)
    chains = buf[o2:o3].view(np.int32).reshape(cap_c, 4)
    anchors = buf[o3 : o3 + 8 * cap_hits].view(np.int32).reshape(cap_hits, 2)
    return totals, hdr, chains, anchors


def unpack_chains(buf: np.ndarray, n_reads: int, cap_hits: int, min_anchors: int) -> list[list[Chain]]:
    """Every read's `Chain` list from a packed result (uint8 numpy of
    `result_bytes`): read r's chains are records hdr[r, 0] to hdr[r, 0] +
    hdr[r, 1], each naming its anchors' first row and count. The anchors
    come back as int64 views of one array, as the host route's are int64."""
    totals, hdr, chains, anchors = _result_views(buf, n_reads, cap_hits, min_anchors)
    n_anchors, n_chains = int(totals[T_ANCHORS]), int(totals[T_CHAINS])
    q = anchors[:n_anchors, 0].astype(np.int64)
    t = anchors[:n_anchors, 1].astype(np.int64)
    recs = chains[:n_chains].tolist()
    out: list[list[Chain]] = []
    for first, count in hdr.tolist():
        read = []
        for cid, strand, cnt, at in recs[first : first + count]:
            read.append(Chain(cid, strand, q[at : at + cnt], t[at : at + cnt], score=cnt))
        out.append(read)
    return out


def index_bytes(index: MinimizerIndex) -> np.ndarray:
    """The index's four sorted arrays in one uint8 buffer: hashes (uint64),
    positions and contig ids (int32), strands (int8)."""
    n = int(index._hash.size)
    if n >= 1 << 31 or (n and int(index._pos.max()) >= 1 << 31):
        raise ValueError("the kernel takes fewer than 2**31 index entries, at positions below 2**31")
    buf = np.empty(17 * n, np.uint8)
    buf[: 8 * n].view(np.uint64)[:] = index._hash
    buf[8 * n : 12 * n].view(np.int32)[:] = index._pos
    buf[12 * n : 16 * n].view(np.int32)[:] = index._cid
    buf[16 * n :].view(np.int8)[:] = index._strand
    return buf


def _index_pointers(base: int, n: int) -> tuple[int, int, int, int]:
    return base, base + 8 * n, base + 12 * n, base + 16 * n


def device_index(index: MinimizerIndex, device: torch.device) -> torch.Tensor:
    """`index_bytes` on `device`, copied once per index object and device
    and kept beside the index."""
    cache = index.__dict__.setdefault("_on_device", {})
    key = str(device)
    if key not in cache:
        cache[key] = torch.from_numpy(index_bytes(index)).to(device)
    return cache[key]


def pack_reads(reads_codes: list[np.ndarray], hpc: bool, allowed_cids, pin: bool = False):
    """The reads as one uint8 buffer (pinned if asked) and the byte offset of
    each part: `read_off` int64 [n + 1] into `codes`, `qlen` int32 [n] the
    original lengths, `allowed` int32 [n] (if given), `orig` int32 (with
    hpc: each compressed base's offset in its read, as
    `core/seeding.py:hpc_compress` gives it), `codes` int8."""
    n = len(reads_codes)
    lens = np.fromiter((c.size for c in reads_codes), np.int64, n)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    flat = np.concatenate(reads_codes).astype(np.int8, copy=False) if n else np.zeros(0, np.int8)
    if lens.size and int(lens.max()) >= 1 << 31:
        raise ValueError("the kernel takes reads shorter than 2**31 bases")
    orig = None
    read_off = starts
    if hpc:
        keep = np.ones(flat.size, bool)
        np.not_equal(flat[1:], flat[:-1], out=keep[1:])
        keep[starts[:-1][lens > 0]] = True
        orig = (np.arange(flat.size, dtype=np.int64) - np.repeat(starts[:-1], lens))[keep].astype(np.int32)
        flat = flat[keep]
        kept = np.zeros(keep.size + 1, np.int64)
        np.cumsum(keep, out=kept[1:])
        read_off = kept[starts]
    parts = [("read_off", read_off, np.int64), ("qlen", lens, np.int32)]
    if allowed_cids is not None:
        parts.append(("allowed", np.asarray(allowed_cids), np.int32))
    if orig is not None:
        parts.append(("orig", orig, np.int32))
    parts.append(("codes", flat, np.int8))
    at, size = {}, 0
    for name, arr, dt in parts:
        at[name] = size
        size = _align8(size + arr.size * np.dtype(dt).itemsize)
    staging = torch.empty(max(size, 8), dtype=torch.uint8, pin_memory=pin)
    host = staging.numpy()
    for name, arr, dt in parts:
        nbytes = arr.size * np.dtype(dt).itemsize
        host[at[name] : at[name] + nbytes].view(dt)[:] = arr
    return staging, at


def hits_estimate(index: MinimizerIndex, reads_codes: list[np.ndarray]) -> int:
    """Scratch slots to try first: a random sequence's minimizer density,
    2 / (w + 1) a position, times the index's mean entries a hash weighted
    by entries, plus a margin. Low-complexity reads can need more: the
    kernel then reports the exact count."""
    ih = index._hash
    occ = 1.0
    if ih.size:
        runs = np.diff(np.flatnonzero(np.concatenate(([True], ih[1:] != ih[:-1], [True]))))
        runs = runs[runs <= index.max_occ]
        if runs.size:
            occ = float((runs * runs).sum() / runs.sum())
    positions = sum(max(0, c.size - index.k + 1) for c in reads_codes)
    return int(positions * 2 / (index.w + 1) * occ * 1.25) + 4096


def chains_from_packed(run, n_reads: int, cap_hits: int, min_anchors: int):
    """Drives one batch: `run(cap)` launches the kernel with `cap` scratch
    slots and returns the packed result (uint8 numpy); if the reads' hits
    pass `cap`, it runs once more with their count. Returns (every read's
    chains, the reads the kernel finished)."""
    for _ in range(2):
        buf = run(cap_hits)
        totals = buf[: 8 * N_TOTALS].view(np.uint64)
        if int(totals[T_HITS]) <= cap_hits:
            break
        cap_hits = int(totals[T_HITS])
    else:
        raise RuntimeError(f"chain_seeds: {int(totals[T_HITS])} hits still pass the scratch of {cap_hits}")
    if int(totals[T_OVERFLOW]):
        raise RuntimeError("chain_seeds: the chains did not fit their output (no result is cut)")
    done = int(totals[T_READS])
    if done != n_reads:
        raise RuntimeError(f"chain_seeds: the kernel finished {done} of {n_reads} reads")
    return unpack_chains(buf, n_reads, cap_hits, min_anchors), done


def _check(index: MinimizerIndex, reads_codes) -> None:
    if not 1 <= index.k <= 32 or not 1 <= index.w <= 4096:
        raise ValueError(f"the kernel takes 1 <= k <= 32 and 1 <= w <= 4096, not k={index.k} w={index.w}")
    longest = max((c.size for c in reads_codes), default=0)
    if index.max_occ < 0 or longest * max(1, index.max_occ) >= 1 << 31:
        raise ValueError("a read's hits must stay below 2**31 (read length x max_occ)")
    if len(index.contig_names) >= 1 << 30:
        raise ValueError("the kernel takes fewer than 2**30 contigs")


def find_chains_cuda(
    index: MinimizerIndex,
    reads_codes: list[np.ndarray],
    min_anchors: int = 4,
    min_score_frac: float = 0.1,
    max_overlap_frac: float = 0.5,
    allowed_cids: list[int] | None = None,
    device="cuda",
) -> tuple[list[list[Chain]], int]:
    """`find_chains_batch(index, reads_codes, ...)` on a CUDA device: one
    copy in, one launch (two when the scratch estimate is short), one copy
    back. Returns (every read's chains, the reads the kernel finished)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"find_chains_cuda runs on a CUDA device, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = len(reads_codes)
    if n == 0:
        return [], 0
    _check(index, reads_codes)
    staging, at = pack_reads(reads_codes, index.hpc, allowed_cids, pin=True)
    reads = staging.to(device, non_blocking=True)
    idx = device_index(index, device)

    def run(cap: int) -> np.ndarray:
        scratch = torch.empty(cap * SCRATCH_BYTES_PER_HIT, dtype=torch.uint8, device=device)
        result = torch.empty(result_bytes(n, cap, min_anchors), dtype=torch.uint8, device=device)
        chain_seeds_cuda(reads, at, n, idx, index, min_anchors, min_score_frac, max_overlap_frac, scratch, cap,
                         result)
        back = torch.empty(result.shape, dtype=torch.uint8, pin_memory=True)
        back.copy_(result, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        return back.numpy()

    return chains_from_packed(run, n, hits_estimate(index, reads_codes), min_anchors)


def chain_seeds_cuda(reads, at, n_reads, idx, index, min_anchors, min_score_frac, max_overlap_frac, scratch, cap,
                     result) -> None:
    """One launch of `csrc/chain_seeds.cu` on CUDA tensors: `reads` is
    `pack_reads`' buffer (parts at `at`), `idx` `device_index`'s, `scratch`
    `cap * SCRATCH_BYTES_PER_HIT` bytes and `result` `result_bytes(n_reads,
    cap, min_anchors)` bytes. Counted in `chain_seeds_cuda.launches`."""
    from ._build import load_kernels

    tensors = (reads, idx, scratch, result)
    if not all(x.device == reads.device and x.is_contiguous() and x.dtype == torch.uint8 for x in tensors) \
            or reads.device.type != "cuda":
        raise ValueError("chain_seeds_cuda takes contiguous uint8 CUDA tensors on one device")
    if scratch.numel() < cap * SCRATCH_BYTES_PER_HIT or result.numel() < result_bytes(n_reads, cap, min_anchors):
        raise ValueError("chain_seeds_cuda: scratch or result smaller than the capacity")
    lib = load_kernels()
    ptr = {name: reads.data_ptr() + offset for name, offset in at.items()}
    with torch.cuda.device(reads.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hs_chain_seeds(
            ptr["codes"], ptr["read_off"], ptr["qlen"], ptr.get("orig"), ptr.get("allowed"), n_reads,
            *_index_pointers(idx.data_ptr(), int(index._hash.size)), int(index._hash.size),
            index.k, index.w, index.max_occ, min_anchors, float(min_score_frac), float(max_overlap_frac),
            scratch.data_ptr(), cap, chain_capacity(cap, min_anchors), result.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"hs_chain_seeds launch failed with CUDA error {rc}")
    chain_seeds_cuda.launches += 1


chain_seeds_cuda.launches = 0

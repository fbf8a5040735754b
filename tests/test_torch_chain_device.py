"""Seeding and chaining on the card (`ops/chain_seeds.py`,
`csrc/chain_seeds.cu`) against the host route, `core/seeding.py:
find_chains_batch`: contig, strand, score and every q / t anchor, read by
read.

Cases: a clonal30x-shaped and an even30x-shaped job of
`benchmark/traffic/generate.py`, the rescue pass's k / w, an hpc index on
CLR-like reads (`tests/test_hpc_seeding.py`'s profile), allowed contigs
beside a homologous decoy, and the edge cases (no reads, one read, a read
shorter than k, a read of N, palindromic k-mers, hashes over max_occ, a
read without hits, reads with more hits than a block sorts in shared
memory).

The CUDA kernel cannot run here. Its body builds for the host with
`-DHS_HOST_EMULATION`, where a block's threads run one after another, and
goes through the same packing, relaunch and unpacking as the card route
(`chains_from_packed`): those tests run on the CPU, on fewer reads of the
jobs. The tests marked `cuda` run the card route on the whole jobs, and
`map_reads` on the card; they skip without a GPU. This file imports nothing
of JAX:

    python -m pytest --noconftest tests/test_torch_chain_device.py -q

Tolerance: none (integers)."""

import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from benchmark.traffic import generate
from hairsplitter_tpu_torch.constants import encode_seq
from hairsplitter_tpu_torch.core.seeding import MinimizerIndex, find_chains_batch, hpc_compress, minimizers
from hairsplitter_tpu_torch.ops import _build
from hairsplitter_tpu_torch.ops import chain_seeds as CS
from hairsplitter_tpu_torch.utils.sim import random_genome, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_READS = 96  # reads of a job that the host build of the kernel takes


def _job(mix: str, seed: int = 12345):
    """A job of the benchmark's strains-ont configuration under `mix`:
    (contig codes by name, read codes)."""
    with open(os.path.join(ROOT, "benchmark", "configs", "strains-ont.json")) as f:
        params = json.load(f)["data"]
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{mix}.json")) as f:
        params = dict(params, **json.load(f)["params"])
    job = generate.make_job(params, seed)
    return {c.name: c.assembly.astype(np.int8) for c in job.contigs}, [s.astype(np.int8) for s in job.reads.seqs]


def _job_case(mix, k=15, w=10, limit=None):
    contigs, reads = _job(mix)
    return MinimizerIndex.build(contigs, k=k, w=w), reads[:limit], None


def _hpc_case(limit=None):
    rng = np.random.default_rng(0)
    genome = random_genome(30_000, rng)
    sim = simulate_reads([genome], coverage=8, read_len=6000, rng=rng,
                         sub_rate=0.06, ins_rate=0.07, del_rate=0.06, homopolymer_bias=1.5)
    index = MinimizerIndex.build({"c": encode_seq(genome)}, k=19, w=10, hpc=True)
    return index, [encode_seq(s) for s in sim.seqs[:limit]], None


def _allowed_case(limit=None):
    """Reads of a contig and of its homologous decoy (3% substituted), each
    restricted to one of them, to the other, or to none; the index built
    with max_occ scaled as `map_reads` scales it under `restrict`."""
    rng = np.random.default_rng(1)
    genome = random_genome(40_000, rng)
    codes = encode_seq(genome)
    decoy = codes.copy()
    sub = rng.random(decoy.size) < 0.03
    decoy[sub] = (decoy[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    sim = simulate_reads([genome], coverage=6, read_len=5000, rng=rng, sub_rate=0.04, ins_rate=0.01, del_rate=0.01)
    reads = [encode_seq(s) for s in sim.seqs[:limit]]
    index = MinimizerIndex.build({"real": codes, "decoy": decoy}, k=15, w=10, max_occ=64 * 2)
    allowed = [(-1, 0, 1)[i % 3] for i in range(len(reads))]
    return index, reads, allowed


def _edge_case(limit=None):
    """Edge reads around ordinary ones: empty, shorter than k, all N, one
    without hits, one inside a repeat whose hashes pass max_occ, one of
    palindromes, one 24 kb exact copy (more hits than a block sorts in
    shared memory), one through the repeat's edge; an even k so that
    palindromic k-mers exist."""
    rng = np.random.default_rng(2)
    unit = encode_seq(random_genome(900, rng))
    main = encode_seq(random_genome(30_000, rng))
    contig = np.concatenate([main, np.tile(unit, 70), encode_seq(random_genome(3000, rng))])
    index = MinimizerIndex.build({"c": contig, "p": encode_seq("ACGTACGT" * 200 + random_genome(2000, rng))},
                                 k=12, w=5, max_occ=64)
    sim = simulate_reads([decode(main)], coverage=3, read_len=4000, rng=rng, sub_rate=0.03, ins_rate=0.01,
                         del_rate=0.01)
    reads = [
        np.zeros(0, np.int8),
        main[100:110].copy(),
        np.full(3000, 5, np.int8),
        encode_seq(random_genome(5000, rng)),
        np.tile(unit, 4),
        encode_seq("ACGTACGT" * 150),
        main[2000:26000].copy(),
        np.concatenate([main[-3000:], np.tile(unit, 3)]),
        main[500:520].copy(),
    ] + [encode_seq(s) for s in sim.seqs]
    return index, reads[:limit], None


def decode(codes):
    return np.frombuffer(b"ACGTNN", np.uint8)[codes].tobytes().decode()


CASES = {
    "clonal30x": lambda limit: _job_case("clonal30x", limit=limit),
    "even30x": lambda limit: _job_case("even30x", limit=limit),
    "rescue": lambda limit: _job_case("clonal30x", k=11, w=6, limit=limit),
    "hpc": _hpc_case,
    "allowed": _allowed_case,
    "edges": _edge_case,
    "one_read": lambda limit: _job_case("clonal30x", limit=1),
    "no_reads": lambda limit: _job_case("clonal30x", limit=0),
}


def host_chains(index, reads, allowed):
    return find_chains_batch(index, reads, min_anchors=4, allowed_cids=allowed)


def assert_same_chains(got, ref):
    assert len(got) == len(ref)
    for r, (g, e) in enumerate(zip(got, ref)):
        assert [(c.contig_id, c.strand, c.score) for c in g] == [(c.contig_id, c.strand, c.score) for c in e], \
            f"read {r}"
        for a, b in zip(g, e):
            assert a.q_anchors.dtype == b.q_anchors.dtype and a.t_anchors.dtype == b.t_anchors.dtype
            np.testing.assert_array_equal(a.q_anchors, b.q_anchors, err_msg=f"read {r}: q")
            np.testing.assert_array_equal(a.t_anchors, b.t_anchors, err_msg=f"read {r}: t")


def pack_chains(chains, min_anchors: int):
    """The packed result that holds `chains` (read by read, in order), and
    its hit capacity: the layout `unpack_chains` reads, made on the host."""
    n_reads = len(chains)
    cap = max(1, sum(c.q_anchors.size for read in chains for c in read))
    buf = np.zeros(CS.result_bytes(n_reads, cap, min_anchors), np.uint8)
    totals, hdr, recs, anchors = CS._result_views(buf, n_reads, cap, min_anchors)
    n_c = n_a = 0
    for r, read in enumerate(chains):
        hdr[r] = (n_c, len(read))
        for c in read:
            cnt = c.q_anchors.size
            recs[n_c] = (c.contig_id, c.strand, cnt, n_a)
            anchors[n_a : n_a + cnt, 0] = c.q_anchors
            anchors[n_a : n_a + cnt, 1] = c.t_anchors
            n_c += 1
            n_a += cnt
    totals[CS.T_ANCHORS], totals[CS.T_CHAINS], totals[CS.T_READS] = n_a, n_c, n_reads
    return buf, cap


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """`find_chains_cuda`'s driver over the host build of the kernel:
    returns (chains, reads finished, scratch sizes run)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the host")
    so = str(tmp_path_factory.mktemp("chain_seeds_host") / "libchain_seeds_host.so")
    src = os.path.join(_build.CSRC_DIR, "chain_seeds.cu")
    subprocess.run([gxx, "-x", "c++", "-DHS_HOST_EMULATION", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.hs_chain_seeds_host.restype = ctypes.c_int
    lib.hs_chain_seeds_host.argtypes = _build.CHAIN_SEEDS_ARGTYPES
    lib.hs_chain_seeds_scratch_bytes.restype = ctypes.c_int64
    lib.hs_chain_seeds_scratch_bytes.argtypes = [ctypes.c_int64]
    lib.hs_chain_seeds_result_bytes.restype = ctypes.c_int64
    lib.hs_chain_seeds_result_bytes.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64]

    def run_batch(index, reads, allowed, cap=None, min_anchors=4):
        n = len(reads)
        staging, at = CS.pack_reads(reads, index.hpc, allowed)
        host = staging.numpy()
        base = host.ctypes.data
        idx = CS.index_bytes(index)
        caps = []

        def run(cap):
            caps.append(cap)
            scratch = np.full(CS.SCRATCH_BYTES_PER_HIT * cap, 0xCD, np.uint8)
            result = np.full(CS.result_bytes(n, cap, min_anchors), 0xCD, np.uint8)
            assert lib.hs_chain_seeds_scratch_bytes(cap) == scratch.size
            assert lib.hs_chain_seeds_result_bytes(n, cap, CS.chain_capacity(cap, min_anchors)) == result.size
            rc = lib.hs_chain_seeds_host(
                base + at["codes"], base + at["read_off"], base + at["qlen"],
                base + at["orig"] if "orig" in at else None, base + at["allowed"] if "allowed" in at else None, n,
                *CS._index_pointers(idx.ctypes.data, index._hash.size), index._hash.size,
                index.k, index.w, index.max_occ, min_anchors, 0.1, 0.5,
                scratch.ctypes.data, cap, CS.chain_capacity(cap, min_anchors), result.ctypes.data)
            assert rc == 0
            return result

        chains, done = CS.chains_from_packed(run, n, cap or CS.hits_estimate(index, reads), min_anchors)
        return chains, done, caps

    return run_batch


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_body_equals_host_route(host_kernel, case):
    index, reads, allowed = CASES[case](CPU_READS)
    chains, done, caps = host_kernel(index, reads, allowed)
    assert done == len(reads) and len(caps) == 1
    assert_same_chains(chains, host_chains(index, reads, allowed))


def test_edge_case_holds_its_edges():
    """The edge reads reach what they are for: a read past the shared-memory
    sort, no hits from the repeat (over max_occ), palindromes masked."""
    index, reads, _ = _edge_case()
    p, h, _ = minimizers(reads[6], index.k, index.w)
    assert index.lookup(h)[0].size > 2048  # sorted in the read's scratch
    assert index.lookup(minimizers(reads[4], index.k, index.w)[1])[0].size == 0  # repeat over max_occ
    pal = reads[5]  # the k-mers at even offsets are their own reverse complement, and never minimizers
    rc = lambda x: decode(np.array([3, 2, 1, 0], np.int8)[x[::-1]])  # noqa: E731
    assert all((rc(pal[i : i + index.k]) == decode(pal[i : i + index.k])) == (i % 2 == 0) for i in range(8))
    p = minimizers(pal, index.k, index.w)[0]
    assert p.size and (p % 2 == 1).all()
    chains = host_chains(index, reads, None)
    assert [len(c) for c in chains[:6]] == [0, 0, 0, 0, 0, 0] and len(chains[6]) >= 1


def test_kernel_body_relaunches_when_the_scratch_is_short(host_kernel):
    index, reads, allowed = CASES["clonal30x"](24)
    chains, done, caps = host_kernel(index, reads, allowed, cap=100)
    ref = host_chains(index, reads, allowed)
    hits = sum(index.lookup(minimizers(r, index.k, index.w)[1])[0].size for r in reads)
    assert caps == [100, hits] and done == len(reads)
    assert_same_chains(chains, ref)


@pytest.mark.parametrize("case", ["allowed", "edges", "hpc"])
def test_packed_result_round_trips(case):
    index, reads, allowed = CASES[case](CPU_READS)
    ref = host_chains(index, reads, allowed)
    buf, cap = pack_chains(ref, 4)
    assert buf.dtype == np.uint8 and buf.size == CS.result_bytes(len(reads), cap, 4)
    assert_same_chains(CS.unpack_chains(buf, len(reads), cap, 4), ref)


def test_a_result_that_does_not_fit_raises():
    index, reads, allowed = CASES["one_read"](None)
    buf, cap = pack_chains(host_chains(index, reads, allowed), 4)
    flagged = buf.copy()
    flagged[8 * CS.T_OVERFLOW] = 1
    with pytest.raises(RuntimeError, match="did not fit"):
        CS.chains_from_packed(lambda c: flagged, 1, cap, 4)
    with pytest.raises(RuntimeError, match="finished 1 of 2"):
        CS.chains_from_packed(lambda c: buf, 2, cap, 4)

    def grows(c):  # a result whose hits always pass the scratch it had
        out = buf.copy()
        out[:8].view(np.uint64)[0] = c + 1
        return out

    with pytest.raises(RuntimeError, match="still pass"):
        CS.chains_from_packed(grows, 1, cap, 4)


def test_packed_reads_hold_each_read_compressed():
    index, reads, allowed = _hpc_case(12)
    reads = [np.zeros(0, np.int8)] + reads + [encode_seq("AAAA")]
    staging, at = CS.pack_reads(reads, True, [3] * len(reads))
    host = staging.numpy()
    n = len(reads)
    off = host[at["read_off"] : at["read_off"] + 8 * (n + 1)].view(np.int64)
    qlen = host[at["qlen"] : at["qlen"] + 4 * n].view(np.int32)
    orig = host[at["orig"] : at["orig"] + 4 * int(off[-1])].view(np.int32)
    codes = host[at["codes"] : at["codes"] + int(off[-1])].view(np.int8)
    assert (host[at["allowed"] : at["allowed"] + 4 * n].view(np.int32) == 3).all()
    for r, read in enumerate(reads):
        comp, o = hpc_compress(read)
        assert qlen[r] == read.size
        np.testing.assert_array_equal(codes[off[r] : off[r + 1]], comp)
        np.testing.assert_array_equal(orig[off[r] : off[r + 1]], o)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    index, reads, _ = CASES["one_read"](None)
    with pytest.raises(ValueError, match="CUDA device"):
        CS.find_chains_cuda(index, reads, device="cpu")
    wide = MinimizerIndex.build({"c": reads[0]}, k=33, w=10)
    with pytest.raises(ValueError, match="k <= 32"):
        CS._check(wide, reads)


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_route_equals_host_route(cuda, case):
    index, reads, allowed = CASES[case](None)
    before = CS.chain_seeds_cuda.launches
    chains, done = CS.find_chains_cuda(index, reads, allowed_cids=allowed, device=cuda)
    assert done == len(reads)
    assert CS.chain_seeds_cuda.launches == before + (1 if reads else 0)
    assert_same_chains(chains, host_chains(index, reads, allowed))
    if reads:  # the index went to the card once, and a second batch reuses it
        cached = index._on_device[str(torch.device("cuda", torch.cuda.current_device()))]
        CS.find_chains_cuda(index, reads[:1], allowed_cids=allowed and allowed[:1], device=cuda)
        assert list(index._on_device) == [str(cached.device)] and index._on_device[str(cached.device)] is cached


@pytest.mark.cuda
def test_card_route_relaunches_when_the_scratch_is_short(cuda, monkeypatch):
    index, reads, allowed = CASES["clonal30x"](40)
    monkeypatch.setattr(CS, "hits_estimate", lambda index, reads: 100)
    before = CS.chain_seeds_cuda.launches
    chains, done = CS.find_chains_cuda(index, reads, device=cuda)
    assert CS.chain_seeds_cuda.launches == before + 2 and done == len(reads)
    assert_same_chains(chains, host_chains(index, reads, allowed))


@pytest.mark.cuda
def test_map_reads_on_the_card_chains_every_read_there(cuda):
    from hairsplitter_tpu_torch.core.mapping import map_reads
    from hairsplitter_tpu_torch.utils import tracing

    contigs, reads = _job("clonal30x")
    contigs = {n: decode(c) for n, c in contigs.items()}
    seqs = [decode(r) for r in reads[:200]]
    before = CS.chain_seeds_cuda.launches
    with tracing.span("mapping") as sp:
        card = map_reads(contigs, seqs, device=cuda)
    chain = sp.children.get("chain")
    host = map_reads(contigs, seqs, device="cpu")
    assert CS.chain_seeds_cuda.launches > before
    assert chain is not None and chain.counts["device_reads"] == chain.counts["reads"]
    key = lambda a: (a.read_idx, a.contig, a.t_start, a.q_start)  # noqa: E731
    assert [(a.read_idx, a.contig, a.strand, a.q_start, a.q_end, a.t_start, a.t_end, a.nm, a.cigar)
            for a in sorted(card, key=key)] == \
        [(a.read_idx, a.contig, a.strand, a.q_start, a.q_end, a.t_start, a.t_end, a.nm, a.cigar)
         for a in sorted(host, key=key)]

"""The CIGAR walk of a job (`ops/pileup_cells.py`, `csrc/pileup_cells.cu`)
against the host copies it replaces, `pipeline/pileup.py:
alignment_cells_full` and `build_window_blocks`: every alignment's cell
positions, trimers (and central bases) and insertion records, and every
window block's rows and cells, array for array, dtypes included.

Cases: alignments on both strands with soft and hard clips on either side,
leading and trailing 'I' and 'D' runs; runs longer than a tile and
alignments of more runs than a chunk; reads of N and '-' (trimers that
wrap in int8); alignments of one cell; query ranges past the read (the
clip, and numpy's negative indexing for insertions), contig ranges past
the contig and t_end unlike the CIGAR, runs of length 0; a contig without
alignments; and what the host raises on (no
cell, an insertion past the read, an empty read).

The CUDA kernel cannot run here. Its body builds for the host with
`-DHS_HOST_EMULATION`, where a block's threads run one after another, and
goes through the card route's packing and unpacking (`JobPack`); the
blocks' statistics then take the plain version. The tests marked `cuda`
run the card route against that build; they skip without a GPU. A small
simulated job runs through `run_pipeline` on the CPU with stage 3's store,
without it, through the kernel's host build and on the resume path: every
artifact byte-identical. This file imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_pileup_cells.py -q

Tolerance: none (integers and bytes)."""

import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hairsplitter_tpu_torch.constants import encode_seq
from hairsplitter_tpu_torch.core.datatypes import Alignment
from hairsplitter_tpu_torch.io.fasta import write_fasta
from hairsplitter_tpu_torch.ops import _build
from hairsplitter_tpu_torch.ops import pileup_cells as PC
from hairsplitter_tpu_torch.ops import variants as V
from hairsplitter_tpu_torch.pipeline import new_contigs as nc
from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig, run_pipeline
from hairsplitter_tpu_torch.pipeline.pileup import alignment_cells_full, build_window_blocks, orient_read
from hairsplitter_tpu_torch.utils import sim
from torch_parity_data import one_torch_thread  # noqa: F401  (fixture; tests/ is on the path)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EQ, X, I, D, M, S, H = range(7)  # io/cigar.py's ops


def _alignment(rng, read_idx, read_len, ops, lens, strand, contig="c", contig_len=1000, q_shift=0, t_start=None,
               t_end_shift=0):
    ops, lens = np.asarray(ops, np.int8), np.asarray(lens, np.int32)
    q_cons = int(lens[ops != D].sum())
    q_start = int(rng.integers(0, max(1, read_len - q_cons + 1))) + q_shift
    t_cons = int(lens[ops != I].sum())
    if t_start is None:
        t_start = int(rng.integers(0, max(1, contig_len - t_cons // 2)))
    return Alignment(read_idx, contig, strand, q_start, q_start + q_cons, t_start, t_start + t_cons + t_end_shift,
                     ops, lens)


def _random_runs(rng, n_runs, max_len):
    ops = rng.choice([EQ, X, I, D, M], n_runs, p=[0.5, 0.15, 0.1, 0.1, 0.15])
    lens = rng.integers(1, max_len + 1, n_runs)
    head, tail = rng.integers(0, 5, 2)  # nothing, S, H, I, D on either side
    pre = [[], [S], [H], [I], [D]][head]
    post = [[], [S], [H], [I], [D]][tail]
    ops = np.concatenate([pre, ops, post]).astype(np.int8)
    lens = np.concatenate([rng.integers(1, 40, len(pre)), lens, rng.integers(1, 40, len(post))]).astype(np.int32)
    return ops, lens


def _reads(rng, n, length, alphabet="ACGT", p=None):
    return {i: "".join(rng.choice(list(alphabet), length, p=p)) for i in range(n)}


def _case_mixed(rng):
    reads = _reads(rng, 40, 3000)
    alns = {"c1": [], "c2": []}
    for k in range(70):
        ops, lens = _random_runs(rng, int(rng.integers(3, 80)), 30)
        contig = "c1" if k % 3 else "c2"
        alns[contig].append(_alignment(rng, int(rng.integers(0, 40)), 3000, ops, lens, int(rng.integers(0, 2)),
                                       contig=contig, contig_len=1700 if contig == "c1" else 900))
    return {"c1": 1700, "c2": 900}, alns, reads, 64


def _case_long_runs(rng):
    reads = _reads(rng, 6, 30_000)
    alns = []
    for k in range(6):
        if k % 2:  # more runs than a chunk, and more cells than a tile
            ops, lens = _random_runs(rng, 700, 12)
        else:  # runs far longer than a tile
            ops = np.array([S, EQ, I, EQ, D, X, EQ, I], np.int8)
            lens = np.array([30, 2500, 3, 1300, 2, 1, 3100, 12], np.int32)
        alns.append(_alignment(rng, k, 30_000, ops, lens, k % 2, contig_len=20_000))
    return {"c": 20_000}, {"c": alns}, reads, 8192


def _case_pad_reads(rng):
    reads = _reads(rng, 12, 1500, "ACGTN-", p=[0.15, 0.15, 0.15, 0.15, 0.3, 0.1])
    alns = []
    for k in range(24):
        ops, lens = _random_runs(rng, int(rng.integers(5, 40)), 20)
        alns.append(_alignment(rng, k % 12, 1500, ops, lens, k % 2, contig_len=800))
    return {"c": 800}, {"c": alns}, reads, 100


def _case_one_cell(rng):
    reads = _reads(rng, 4, 50, "ACGTN", p=[0.2, 0.2, 0.2, 0.2, 0.2])
    shapes = [([EQ], [1]), ([I, EQ], [3, 1]), ([D], [1]), ([S], [1]), ([EQ, I], [1, 2]), ([I, X, I], [1, 1, 1])]
    alns = [_alignment(rng, k % 4, 50, ops, lens, k % 2, contig_len=40) for k, (ops, lens) in enumerate(shapes * 2)]
    return {"c": 40}, {"c": alns}, reads, 16


def _case_overhang(rng):
    """Query ranges past either end of the read (matches there: the clip;
    insertions before its start: numpy's negative indexing), contig ranges
    past the contig, t_end unlike the CIGAR, runs of length 0, and a contig
    without alignments."""
    reads = _reads(rng, 5, 400)
    alns = [
        _alignment(rng, 0, 400, [EQ, I, EQ], [50, 2, 390], 1, q_shift=0),  # 440 query bases from a 400-base read
        _alignment(rng, 1, 400, [EQ, I, EQ], [50, 2, 390], 0),
        _alignment(rng, 2, 400, [EQ, 0, D, 0, EQ], [100, 0, 5, 0, 80], 1, contig_len=600, t_start=560),
        _alignment(rng, 3, 400, [EQ, D, EQ], [100, 3, 100], 0, t_start=30, t_end_shift=200),
        _alignment(rng, 4, 400, [EQ, I, EQ], [100, 4, 100], 1, t_start=300, t_end_shift=-150),
        _alignment(rng, 2, 400, [I, EQ, I, EQ], [3, 30, 2, 300], 0),  # insertions before the read: numpy's wrap
    ]
    alns[0].q_start, alns[0].q_end = 0, 440
    alns[1].q_start, alns[1].q_end = 0, 440
    alns[5].q_start, alns[5].q_end = 0, 450  # strand 0: the first query position is 400 - 450
    return {"c": 600, "empty": 300}, {"c": alns, "empty": []}, reads, 128


CASES = {
    "mixed": _case_mixed, "long_runs": _case_long_runs, "pad_reads": _case_pad_reads,
    "one_cell": _case_one_cell, "overhang": _case_overhang,
}


def _case(name):
    lengths, alns, reads, window = CASES[name](np.random.default_rng(sorted(CASES).index(name)))
    walks = [PC.pack_contig(c, lengths[c], alns[c], window) for c in lengths]
    codes_ws = [np.random.default_rng(k).integers(0, 5, window).astype(np.int8)
                for k in range(sum(w.block_rows.size for w in walks))]
    if name == "pad_reads":  # the statistics' plain version takes no code outside 0..124 and 127
        codes_ws = None
    return walks, reads, codes_ws


def _host_copies(walks, reads):
    """alignment_cells_full per alignment and build_window_blocks per contig."""
    cells, blocks = [], []
    for w in walks:
        oriented = [orient_read(encode_seq(reads[a.read_idx]), a.strand) for a in w.alns]
        cells.append([alignment_cells_full(a, oc) for a, oc in zip(w.alns, oriented)])
        blocks.append(build_window_blocks(w.length, w.alns, oriented, w.window))
    return cells, blocks


def _assert_store_equals_host(store, walks, reads, codes_ws=None):
    cells, blocks = _host_copies(walks, reads)
    for i, w in enumerate(walks):
        for k, (got, cen, ref) in enumerate(zip(store.cells(i), store.cells(i, central=True), cells[i], strict=True)):
            for name, g, r in zip(("tpos", "trimer", "ins_tpos", "ins_codes"), got, ref):
                assert g.dtype == r.dtype, (w.contig, k, name)
                np.testing.assert_array_equal(g, r, err_msg=f"{w.contig} alignment {k}: {name}")
            assert cen[1].dtype == np.int8
            np.testing.assert_array_equal(cen[1], (ref[1].astype(np.int16) // 25).astype(np.int8))
        for b, (g, r) in enumerate(zip(store.blocks[i], blocks[i], strict=True)):
            assert (g.contig, g.start, g.length) == (r.contig, r.start, r.length), (w.contig, b)
            assert g.rows.dtype == r.rows.dtype and g.tri.dtype == r.tri.dtype
            np.testing.assert_array_equal(g.rows, r.rows, err_msg=f"{w.contig} block {b}: rows")
            np.testing.assert_array_equal(g.tri, r.tri, err_msg=f"{w.contig} block {b}: cells")
    if codes_ws is not None:
        ref = V.window_stats_blocks([b.tri for bl in blocks for b in bl], codes_ws, "cpu")
        for g, r in zip(store.stats, ref, strict=True):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The card route's packing, launch and unpacking over the host build of
    the kernel (and the blocks' statistics by the plain version)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the host")
    so = str(tmp_path_factory.mktemp("pileup_cells_host") / "libpileup_cells_host.so")
    src = os.path.join(_build.CSRC_DIR, "pileup_cells.cu")
    subprocess.run([gxx, "-x", "c++", "-DHS_HOST_EMULATION", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.hs_pileup_cells_host.restype = ctypes.c_int
    lib.hs_pileup_cells_host.argtypes = _build.PILEUP_CELLS_ARGTYPES

    def run(walks, reads, device=None, codes_ws=None):
        pk = PC.JobPack(walks, reads, codes_ws)
        out = torch.full((max(1, pk.out_bytes),), 0xCD, dtype=torch.uint8)
        assert lib.hs_pileup_cells_host(*pk.kernel_args(pk.staging.data_ptr(), out.data_ptr())) == 0
        pk.window_stats(pk.staging, out)
        return pk.unpack(out.numpy())

    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_body_equals_host_copies(host_kernel, case):
    walks, reads, codes_ws = _case(case)
    _assert_store_equals_host(host_kernel(walks, reads, codes_ws=codes_ws), walks, reads, codes_ws)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_route_equals_host_copies(case):
    walks, reads, codes_ws = _case(case)
    before = _build.kernel_launch_counts()
    store = PC.walk_alignments(walks, reads, "cpu", codes_ws=codes_ws)
    assert _build.kernel_launch_counts() == before
    _assert_store_equals_host(store, walks, reads, codes_ws)


def test_cases_hold_what_they_are_for():
    walks, reads, _ = _case("pad_reads")
    cells, _ = _host_copies(walks, reads)
    assert any((c[1] < 0).any() for c in cells[0])  # trimers past 127 wrapped
    walks, _, _ = _case("long_runs")
    w = walks[0]
    assert int(np.diff(w.run_off).max()) > 256 and int(w.lens.max()) > 1024 and int(w.block_rows.size) == 3
    walks, reads, _ = _case("one_cell")
    cells, _ = _host_copies(walks, reads)
    assert all(c[0].size == 1 and c[1].size == 2 for c in cells[0])
    walks, reads, _ = _case("mixed")
    assert {a.strand for w in walks for a in w.alns} == {0, 1}
    assert {int(a.cigar_ops[0]) for w in walks for a in w.alns} >= {S, H, I, D}
    assert {int(a.cigar_ops[-1]) for w in walks for a in w.alns} >= {S, H, I, D}
    assert all(w.length % w.window for w in walks)  # a last partial window
    walks, reads, _ = _case("overhang")
    assert walks[1].alns == [] and [b.tri.shape for b in _host_copies(walks, reads)[1][1]] == [(1, 128)] * 3


def _bad(ops, lens, read_len=100, q_start=0):
    a = Alignment(0, "c", 1, q_start, q_start + int(np.sum(np.asarray(lens)[np.asarray(ops) != D])), 0, 50,
                  np.asarray(ops, np.int8), np.asarray(lens, np.int32))
    return a, {0: "A" * read_len}


@pytest.mark.parametrize("shape,error", [
    (([], []), ValueError),  # no cell
    (([I], [5]), ValueError),
    (([EQ, I], [95, 10]), IndexError),  # an insertion past the read
    (([EQ], [3]), IndexError),  # an empty read
])
def test_what_the_host_raises_on_raises(host_kernel, shape, error):
    a, reads = _bad(*shape)
    if shape == ([EQ], [3]):
        reads = {0: ""}
    with pytest.raises(error):
        alignment_cells_full(a, encode_seq(reads[0]))
    walks = [PC.pack_contig("c", 100, [a], 32)]
    for route in (lambda: PC.walk_alignments(walks, reads, "cpu"), lambda: host_kernel(walks, reads)):
        with pytest.raises(error):
            route()


# ---------------------------------------------------------------- stage 5 and the job


def _create(store, alns_by_contig, reads, monkeypatch):
    """create_new_contigs on two contigs with one group a window each, with
    `store`; returns the cells handed to the consensus and the cells spans'
    counts."""
    from hairsplitter_tpu_torch.io.gfa import AssemblyGraph
    from hairsplitter_tpu_torch.pipeline.separate_reads import ContigGroups, WindowGroups
    from hairsplitter_tpu_torch.utils import tracing

    seen = []
    monkeypatch.setattr(nc, "consensus_from_cells", lambda bb, start, rc, ri, base_caller=None: (
        seen.append([(a.tolist(), b.tolist(), c.tolist(), d.tolist()) for (a, b), (c, d) in zip(rc, ri)])
        or "ACGT"))
    monkeypatch.setattr(nc, "check_backbone", lambda *a, **k: 0)
    asm = AssemblyGraph()
    groups = {}
    for c, alns in alns_by_contig.items():
        asm.add_segment(c, "A" * 600)
        groups[c] = ContigGroups(c, 600, 30.0, [WindowGroups(0, 599, np.zeros(len(alns), np.int64))])
    first = next(tracing._ids)
    with tracing.span("create_new_contigs") as st:
        nc.create_new_contigs(asm, {c: (alns_by_contig[c], groups[c]) for c in asm.segments}, reads, True,
                              device="cpu", cell_store=store)
    counts = {}
    for s in tracing.spans():
        if s.id > first and s.parent == st.id and s.name == "cells":
            for k, v in s.counts.items():
                counts[k] = counts.get(k, 0) + v
    return seen, counts


def test_stage5_reuses_what_stage3_walked_and_walks_the_rest(monkeypatch):
    """A store of one contig (a process's shard): its alignments' cells are
    sliced from it, the other contig's walked in stage 5, and the consensus
    sees the same cells as without a store."""
    rng = np.random.default_rng(11)
    reads = _reads(rng, 8, 700)
    alns = {c: [_alignment(rng, k, 700, *_random_runs(rng, 20, 20), k % 2, contig=c, contig_len=600) for k in range(4)]
            for c in ("a", "b")}
    store = PC.walk_alignments([PC.pack_contig("a", 600, alns["a"], 0)], reads, "cpu")
    with_store, counts = _create(store, alns, reads, monkeypatch)
    assert counts == {"reused": 4, "walked": 4}
    without, counts = _create(None, alns, reads, monkeypatch)
    assert counts == {"reused": 0, "walked": 8}
    assert with_store == without and len(with_store) == 2
    other_list = list(alns["a"])  # the same alignments in another list: walked again
    _, counts = _create(store, {"a": other_list, "b": alns["b"]}, reads, monkeypatch)
    assert counts == {"reused": 0, "walked": 8}


FILES = ["tmp/variants.col", "variants.vcf", "tmp/reads_haplo.gro", "tmp/reads_on_new_contig.gaf",
         "tmp/zipped_assembly.gfa", "hairsplitter_final_assembly.gfa", "hairsplitter_final_assembly.fasta"]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Two 12 kb contigs, the first of two strains at 1%: 30x of 4 kb reads at
    6% error."""
    root = tmp_path_factory.mktemp("pileup_job")
    rng = np.random.default_rng(5)
    haps = {"ctg1": sim.make_haplotypes(12_000, 2, 0.01, rng), "ctg2": sim.make_haplotypes(12_000, 1, 0.0, rng)}
    names, seqs = [], []
    for c, h in haps.items():
        r = sim.simulate_reads(h, coverage=30 / len(h), read_len=4000, rng=rng, sub_rate=0.04, ins_rate=0.01,
                               del_rate=0.01)
        names += [f"{c}_{n}" for n in r.names]
        seqs += r.seqs
    write_fasta(str(root / "asm.fa"), {c: h[0] for c, h in haps.items()})
    write_fasta(str(root / "reads.fa"), dict(zip(names, seqs)))
    return root


def _run(job, out, **flags):
    run_pipeline(str(job / "asm.fa"), str(job / "reads.fa"), str(out), PipelineConfig(device="cpu", **flags))
    with open(out / "stage_stats.json") as f:
        return json.load(f)


def test_job_artifacts_equal_with_and_without_the_store(job, tmp_path, monkeypatch, host_kernel):
    """One job four ways: stage 5 reading stage 3's store (reused = every
    alignment, walked 0); stage 5 given no store (it walks every contig);
    the walk through the kernel's host build; a resume after stage 4, where
    stage 3 is skipped and stage 5 walks everything. Every artifact equal."""
    ref = _run(job, tmp_path / "store")
    n_alns = ref["call_variants.pileup"]["alignments"]
    assert n_alns > 100 and ref["call_variants.pileup"]["cells"] > 300_000
    assert ref["create_new_contigs.cells"]["reused"] == n_alns and ref["create_new_contigs.cells"]["walked"] == 0

    inner = nc.create_new_contigs
    monkeypatch.setattr("hairsplitter_tpu_torch.pipeline.orchestrate.create_new_contigs",
                        lambda *a, **k: inner(*a, **{**k, "cell_store": None}))
    alone = _run(job, tmp_path / "alone")
    assert alone["create_new_contigs.cells"]["walked"] == n_alns and alone["create_new_contigs.cells"]["reused"] == 0
    monkeypatch.undo()

    monkeypatch.setattr(PC, "_walk_host", lambda walks, reads, device, codes_ws: host_kernel(walks, reads,
                                                                                            codes_ws=codes_ws))
    body = _run(job, tmp_path / "kernel_body")
    assert body["create_new_contigs.cells"]["reused"] == n_alns
    monkeypatch.undo()

    shutil.copytree(tmp_path / "store", tmp_path / "resumed")
    for name in ("tmp/zipped_assembly.gfa", "tmp/reads_on_new_contig.gaf", "hairsplitter_final_assembly.gfa",
                 "hairsplitter_final_assembly.fasta"):
        os.remove(tmp_path / "resumed" / name)
    resumed = _run(job, tmp_path / "resumed", resume=True)
    assert "call_variants" not in resumed and resumed["create_new_contigs.cells"]["walked"] == n_alns

    for name in FILES:
        want = (tmp_path / "store" / name).read_bytes()
        assert len(want) > 0, name
        for other in ("alone", "kernel_body", "resumed"):
            assert (tmp_path / other / name).read_bytes() == want, (other, name)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_route_equals_kernel_body(cuda, host_kernel, case):
    walks, reads, codes_ws = _case(case)
    before = _build.kernel_launch_counts()
    got = PC.walk_alignments(walks, reads, cuda, codes_ws=codes_ws)
    after = _build.kernel_launch_counts()
    stats = {} if codes_ws is None else {"window_stats": 1}
    assert {k: v - before[k] for k, v in after.items() if v != before[k]} == {"pileup_cells": 1, **stats}
    want = host_kernel(walks, reads, codes_ws=codes_ws)
    for name in ("t_start", "n_cells", "tri_off", "ins_off", "tri", "central", "ins_t", "ins_c"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert (got.stats is None) == (want.stats is None)
    for g, w in zip(got.stats or (), want.stats or (), strict=True):
        assert np.array_equal(g, w)
    for gb, wb in zip(got.blocks, want.blocks, strict=True):
        for g, w in zip(gb, wb, strict=True):
            assert np.array_equal(g.tri, w.tri) and np.array_equal(g.rows, w.rows)
    _assert_store_equals_host(got, walks, reads, codes_ws)


@pytest.mark.cuda
def test_card_route_raises_an_insertion_past_the_read(cuda):
    a, reads = _bad([EQ, I], [95, 10])
    with pytest.raises(IndexError):
        PC.walk_alignments([PC.pack_contig("c", 100, [a], 32)], reads, cuda)

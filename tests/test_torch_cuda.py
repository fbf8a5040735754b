"""On-card checks of the PyTorch port: the CUDA kernels (K1 Myers and K2 int32
banded DP, each in its check mode and its fused main-path mode) against their
plain PyTorch versions, and the fused call and
`map_reads` on the GPU against the same functions on the CPU, for both DP
kernels; and the paths off the main one on the GPU against the CPU: the
polisher CNN (logits atol/rtol 1e-4, bases above a top-two margin of 1e-3),
`correct_assembly` and `spectral_phase` (equal), and the polisher's
training: its realistic corpus (equal byte for byte), one Adam step (within
1e-5) and two trainings with one seed (equal bit for bit); and the headline
block of `bench_torch.py` (a positive rate, the buffer of the call it times
equal to the plain composition's). Stage 3's window-stats kernel against
its plain version and the numpy twins on ragged batches, and
`finish_preps` on the card against the CPU (every field, and the COL file
of the stage byte for byte). Every test is marked `cuda` and skips
without a GPU (the kernels have no CPU mode).

This file imports nothing of JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import MODE_PATTERNS, edge_jobs, mode_pattern, random_jobs, window_blocks
from hairsplitter_tpu_torch.utils.sim import make_haplotypes, simulate_reads
from hairsplitter_tpu_torch.core.mapping import MapConfig, map_reads
from hairsplitter_tpu_torch.ops import _build
from hairsplitter_tpu_torch.ops import align_dp_cuda as ad
from hairsplitter_tpu_torch.ops import align_myers_cuda as am
from hairsplitter_tpu_torch.ops.align import BandSpec
from hairsplitter_tpu_torch.ops.align_device import align_traceback_rows, banded_fused_plain, myers_fused_plain

pytestmark = pytest.mark.cuda

SPEC = BandSpec(chunk=256, band=128)


def _launches(kernel: str) -> int:
    return _build.kernel_launch_counts()[kernel]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _jobs(seed: int, n: int):
    """`chip_smoke.py`'s seeded jobs: noisy target copies of random queries,
    plus empty, full-length, short-target, unrelated and all-sentinel rows."""
    return random_jobs(np.random.default_rng(seed), n, SPEC)


@pytest.mark.parametrize("n", [1, 33, 4096])
def test_kernel_equals_plain_version(cuda, n):
    q, _, t, _ = _jobs(n, n)
    qd, td = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    before = _launches("myers_rows")
    got = am.myers_rows(qd, td, SPEC, emit_tb=True)
    ref = am.myers_rows_torch(qd, td, SPEC, emit_tb=True)
    assert _launches("myers_rows") == before + 1
    for g, r in zip(got, ref):
        assert g.shape == (n, SPEC.chunk, 4)
        assert torch.equal(g, r)
    pm = am.myers_rows(qd, td, SPEC, emit_tb=False)
    assert len(pm) == 2 and torch.equal(pm[0], got[0]) and torch.equal(pm[1], got[1])


@pytest.mark.parametrize("pattern", MODE_PATTERNS)
@pytest.mark.parametrize("jobs", ["edge", 1, 33, 4096])
def test_fused_kernel_equals_plain_composition(cuda, jobs, pattern):
    """K1's main-path mode against myers_rows_torch -> myers_word_readout ->
    readout_device -> traceback_scan_words, all on the card, byte for byte;
    one call is exactly one launch."""
    q, ql, t, tl = edge_jobs(SPEC) if jobs == "edge" else _jobs(jobs, jobs)
    n = q.shape[0]
    arrays = [torch.from_numpy(x).to(cuda) for x in (q, ql, t, tl, mode_pattern(pattern, n))]
    before, rows_before = _launches("myers_fused"), _launches("myers_rows")
    got = align_traceback_rows(*arrays, SPEC, "myers")
    torch.cuda.synchronize()
    assert _launches("myers_fused") == before + 1
    assert _launches("myers_rows") == rows_before  # the check-mode kernel is not on this path
    ref = myers_fused_plain(*arrays, SPEC)
    assert got.dtype == torch.uint8 and got.shape == (n, 16 + SPEC.chunk)
    assert torch.equal(got, ref), (got != ref).any(dim=1).nonzero()[:8, 0].tolist()


def test_fused_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, ql, t, tl = (torch.from_numpy(x).to(cuda) for x in _jobs(5, 64))
    modes = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        am.myers_fused_cuda(q, ql.to(torch.int64), t, tl, modes, SPEC)
    with pytest.raises(ValueError):
        am.myers_fused_cuda(q[:, :250], ql, t, tl, modes, SPEC)  # not contiguous, not a multiple of 16
    with pytest.raises(ValueError):
        am.myers_fused_cuda(q, ql, t, tl, modes, BandSpec(chunk=256, band=64))


@pytest.mark.parametrize("n", [1, 33, 4096])
@pytest.mark.parametrize("emit_enc", [False, True], ids=["bp", "enc"])
def test_k2_kernel_equals_plain_version(cuda, n, emit_enc):
    arrays = [torch.from_numpy(x).to(cuda) for x in _jobs(n, n)]
    before = _launches("banded_dp")
    got = ad.banded_align_batch_dp(*arrays, SPEC, emit_enc=emit_enc)
    torch.cuda.synchronize()
    assert _launches("banded_dp") == before + 1
    ref = ad.banded_align_batch_torch(*arrays, SPEC, emit_enc=emit_enc)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype and torch.equal(got[key], ref[key]), key


@pytest.mark.parametrize("pattern", MODE_PATTERNS)
@pytest.mark.parametrize("jobs", ["edge", 1, 33, 4096])
def test_k2_fused_kernel_equals_plain_composition(cuda, jobs, pattern):
    """K2's main-path mode against banded_align_batch_torch (enc) ->
    readout_device -> traceback_scan, all on the card, byte for byte; one
    call is exactly one launch, and none of the check-mode kernel."""
    q, ql, t, tl = edge_jobs(SPEC) if jobs == "edge" else _jobs(jobs, jobs)
    n = q.shape[0]
    arrays = [torch.from_numpy(x).to(cuda) for x in (q, ql, t, tl, mode_pattern(pattern, n))]
    before, check_before = _launches("banded_fused"), _launches("banded_dp")
    got = align_traceback_rows(*arrays, SPEC, "pallas")
    torch.cuda.synchronize()
    assert _launches("banded_fused") == before + 1
    assert _launches("banded_dp") == check_before
    ref = banded_fused_plain(*arrays, SPEC)
    assert got.dtype == torch.uint8 and got.shape == (n, 16 + SPEC.chunk)
    assert torch.equal(got, ref), (got != ref).any(dim=1).nonzero()[:8, 0].tolist()


@pytest.mark.parametrize("chunk", [64, 2048])  # 2048: 69.8 KB of dynamic shared memory, above the default 48 KB
def test_k2_fused_kernel_at_other_chunks(cuda, chunk):
    spec = BandSpec(chunk=chunk, band=128)
    n = 515 if chunk == 64 else 40
    q, ql, t, tl = random_jobs(np.random.default_rng(9), n, spec)
    arrays = [torch.from_numpy(x).to(cuda) for x in (q, ql, t, tl, mode_pattern("alternating", n))]
    assert torch.equal(ad.banded_fused_cuda(*arrays, spec), banded_fused_plain(*arrays, spec))


def test_k2_fused_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, ql, t, tl = (torch.from_numpy(x).to(cuda) for x in _jobs(5, 64))
    modes = torch.zeros(64, dtype=torch.int32, device=cuda)
    before = _launches("banded_fused")
    with pytest.raises(TypeError):
        ad.banded_fused_cuda(q, ql.to(torch.int64), t, tl, modes, SPEC)
    with pytest.raises(ValueError, match="contiguous"):
        ad.banded_fused_cuda(q[:, ::2], ql, t, tl, modes, BandSpec(chunk=128, band=128))
    with pytest.raises(ValueError, match="multiple of 16"):
        ad.banded_fused_cuda(q[:, :250].contiguous(), ql, t, tl, modes, BandSpec(chunk=250, band=128))
    with pytest.raises(ValueError, match="band 128"):
        ad.banded_fused_cuda(q, ql, t, tl, modes, BandSpec(chunk=256, band=64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ad.banded_fused_cuda(q.cpu(), ql.cpu(), t.cpu(), tl.cpu(), modes.cpu(), SPEC)
    big = BandSpec(chunk=8192, band=128)  # a block's scratch would pass the shared memory of an SM
    with pytest.raises(ValueError, match="chunk 8192"):
        ad.banded_fused_cuda(torch.zeros((4, 8192), dtype=torch.int8, device=cuda), ql[:4],
                             torch.zeros((4, big.t_width), dtype=torch.int8, device=cuda), tl[:4], modes[:4], big)
    assert _launches("banded_fused") == before


FUSED_KERNEL = {"myers": "myers_fused", "pallas": "banded_fused"}


def test_empty_batch_launches_nothing_and_counts_nothing(cuda):
    """A launch counter moves only where a kernel is launched: no job, no
    launch, an empty result of the right shape and no count."""
    q, ql, t, tl = (torch.from_numpy(x[:0]).to(cuda) for x in _jobs(5, 16))
    modes = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = _build.kernel_launch_counts()
    assert [x.shape for x in am.myers_rows(q, t, SPEC, emit_tb=True)] == [(0, SPEC.chunk, 4)] * 4
    assert am.myers_fused_cuda(q, ql, t, tl, modes, SPEC).shape == (0, 16 + SPEC.chunk)
    assert ad.banded_align_batch_dp(q, ql, t, tl, SPEC, emit_enc=True)["enc"].shape == (0, SPEC.chunk, 128)
    assert ad.banded_fused_cuda(q, ql, t, tl, modes, SPEC).shape == (0, 16 + SPEC.chunk)
    assert _build.kernel_launch_counts() == before


@pytest.mark.parametrize("kernel", ["myers", "pallas"])
def test_fused_call_on_card_equals_cpu(cuda, kernel):
    arrays = _jobs(7, 2048)
    modes = (np.arange(2048) % 2).astype(np.int32)
    host = [torch.from_numpy(x) for x in (*arrays, modes)]
    cpu = align_traceback_rows(*host, SPEC, kernel)
    before = _launches(FUSED_KERNEL[kernel])
    gpu = align_traceback_rows(*(x.to(cuda) for x in host), SPEC, kernel)
    assert _launches(FUSED_KERNEL[kernel]) == before + 1  # the call went through the fused kernel
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.parametrize("cfg", [MapConfig(), MapConfig(use_myers=False)], ids=["myers", "pallas"])
def test_map_reads_on_card_equals_cpu(cuda, cfg):
    rng = np.random.default_rng(3)
    haps = make_haplotypes(12_000, 2, 0.01, rng)
    reads = simulate_reads(haps, coverage=8, read_len=3000, rng=rng,
                           sub_rate=0.06, ins_rate=0.02, del_rate=0.02).seqs
    key = lambda a: (a.read_idx, a.strand, a.q_start, a.q_end, a.t_start, a.t_end,  # noqa: E731
                     a.cigar_ops.tolist(), a.cigar_lens.tolist(), a.nm)
    fused = "myers_fused" if cfg.use_myers else "banded_fused"
    cpu = [key(a) for a in map_reads({"c": haps[0]}, reads, cfg, device="cpu")]
    before, check_before = _launches(fused), _launches("banded_dp")
    gpu = [key(a) for a in map_reads({"c": haps[0]}, reads, cfg, device=cuda)]
    assert _launches(fused) > before  # mapping on the card went through the fused kernel
    assert _launches("banded_dp") == check_before
    assert len(cpu) > 0 and gpu == cpu


@pytest.mark.parametrize("L", [256, 4096])
def test_polisher_on_the_card_equals_the_cpu(cuda, L):
    """`PolisherCNN` with the shipped weights: logits within atol 1e-4 of the
    CPU's (full float32 convolutions, TF32 off), bases equal wherever the two
    best logits differ by more than 1e-3."""
    from hairsplitter_tpu_torch.models import polisher as P

    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(L)
    feats, _ = P._simulate_training_batch(rng, L=L, cov_lo=4, cov_hi=20, err=0.12, div=0.02)
    on_cpu, on_card = P.load_weights(device="cpu"), P.load_weights(device=cuda)
    assert next(on_card.model.parameters()).is_cuda
    ref, got = on_cpu.logits(feats), on_card.logits(feats)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    top = np.sort(ref, axis=1)
    clear = top[:, -1] - top[:, -2] > 1e-3
    np.testing.assert_array_equal(got.argmax(axis=1)[clear], ref.argmax(axis=1)[clear])
    assert on_card.calls == 1


def test_correct_assembly_on_the_card_equals_the_cpu(cuda):
    """A misjoin and a gap (tests/test_torch_tailor.py:data_misjoin_and_gap):
    the corrected graph and the report are the CPU's, and every mapping of
    the loop launched the fused kernel."""
    import dataclasses

    from hairsplitter_tpu_torch.io.gfa import AssemblyGraph
    from hairsplitter_tpu_torch.pipeline.tailor import correct_assembly
    from hairsplitter_tpu_torch.utils.sim import random_genome

    rng = np.random.default_rng(0)
    A, decoy, B = random_genome(4000, rng), random_genome(3000, rng), random_genome(4000, rng)
    sim = simulate_reads([A + random_genome(300, rng) + B], coverage=15, read_len=2500, rng=rng)
    reads = dict(enumerate(sim.seqs))

    def run(device):
        asm = AssemblyGraph()
        asm.add_segment("chim", A + decoy, depth=15)
        asm.add_segment("B", B, depth=15)
        g, rep = correct_assembly(asm, reads, device=device)
        links = [(l.name1, l.orient1, l.name2, l.orient2, l.cigar) for l in g.links]
        return list(g.segments.items()), links, dict(g.depths), dataclasses.asdict(rep)

    ref = run("cpu")
    before = _launches("myers_fused")
    got = run(cuda)
    assert _launches("myers_fused") - before >= 3  # before, after one pass, after
    assert ref[3]["cuts"] and ref[3]["new_links"]
    assert got == ref


def test_spectral_phase_on_the_card_equals_the_cpu(cuda):
    from hairsplitter_tpu_torch.models.bihap import spectral_phase
    from hairsplitter_tpu_torch.pipeline.call_variants import SparseColumn

    rng = np.random.default_rng(4)
    hap = np.repeat(np.arange(2), 40)
    cols = []
    for s in range(50):
        present = rng.random(80) > 0.1
        alleles = np.where((hap == 1) ^ (rng.random(80) < 0.05), 7, 3).astype(np.int16)
        cols.append(SparseColumn(pos=100 * s, top1=3, top2=7, rows=np.nonzero(present)[0], alleles=alleles[present]))
    parts = [
        {frozenset(np.nonzero(lab == g)[0].tolist()) for g in set(lab.tolist())}
        for lab in (spectral_phase(cols, 80, n_haplotypes=2, device=d) for d in ("cpu", cuda))
    ]
    assert parts[0] == parts[1] and len(parts[0]) == 2


@pytest.mark.parametrize("hp_bias", [False, True], ids=["sim", "sim2"])
def test_realistic_training_pair_on_the_card_equals_the_cpu(cuda, hp_bias):
    """The corpus is integer work up to the features: mapped on the card, a
    pair equals the CPU's byte for byte, and the mapping went through K1."""
    from hairsplitter_tpu_torch.models import polisher as P

    ref = P._realistic_training_pair(np.random.default_rng(2), L=1024, hp_bias=hp_bias, device="cpu")
    before = _launches("myers_fused")
    got = P._realistic_training_pair(np.random.default_rng(2), L=1024, hp_bias=hp_bias, device=cuda)
    assert _launches("myers_fused") > before
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_one_adam_step_on_the_card_equals_the_cpu(cuda):
    from hairsplitter_tpu_torch.models import polisher as P

    rng = np.random.default_rng(11)
    xs, ys = zip(*(P._simulate_training_batch(rng, L=256) for _ in range(4)))
    batch = (np.stack(xs), np.stack(ys), (rng.random((4, 256)) < 0.8).astype(np.float32))
    results = []
    for device in ("cpu", cuda):
        model = P.PolisherCNN()
        P.init_params(model, torch.Generator().manual_seed(0))
        model.to(device)
        opt = P.make_optimizer(model, 1e-3)
        with P.deterministic_convolutions():
            loss = P.train_step(model, opt, *(torch.from_numpy(a).to(device) for a in batch))
        assert loss.device.type == torch.device(device).type  # the loss stays on its device
        results.append((float(loss), P.params_to_jax(model.state_dict())))
    (ref_loss, ref), (got_loss, got) = results
    assert abs(got_loss - ref_loss) < 1e-5
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0, err_msg=k)


def test_two_trainings_on_the_card_with_one_seed_are_equal(cuda):
    from hairsplitter_tpu_torch.models import polisher as P

    runs = [P.train_polisher(seed=0, steps=20, batch=8, L=512, device=cuda).model.state_dict() for _ in range(2)]
    assert all(v.is_cuda for v in runs[0].values())
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    assert not torch.backends.cudnn.deterministic and not torch.backends.cudnn.allow_tf32


def test_bench_headline_block_on_the_card(cuda, monkeypatch):
    """`bench_torch.fused_production_rate` at 2,048 jobs, the size of its
    single call: a positive rate, and the fused call it times on
    `bench_batch` gives the plain composition's buffer."""
    import bench_torch

    monkeypatch.setitem(bench_torch.SIZES, "cuda", dict(bench_torch.SIZES["cuda"], fused_jobs=2048))
    res = bench_torch.fused_production_rate(SPEC, "myers", cuda)
    assert res["cells_per_s"] > 0 and res["fused_single_cells_per_s"] > 0
    assert res["fused_jobs"] == 2048 and res["fused_kernel"] == "myers"
    batch = bench_torch.bench_batch(SPEC, 2048, cuda)
    assert torch.equal(align_traceback_rows(*batch, SPEC, "myers"), myers_fused_plain(*batch, SPEC))


WINDOW_BATCHES = {
    "ragged": ((1, 31, 64, 257, 2000, 64, 1), 8192),
    "deep": ((70_000, 3, 1), 8),  # counts above 65,535
}


@pytest.mark.parametrize("batch", sorted(WINDOW_BATCHES))
def test_window_stats_kernel_equals_plain_and_numpy_twins(cuda, batch):
    from hairsplitter_tpu_torch.ops import variants as V

    rows, P = WINDOW_BATCHES[batch]
    tris, codes = window_blocks(np.random.default_rng(len(rows)), rows, P)
    staging, offsets = V.pack_window_blocks(tris, codes)
    n, nb = int(offsets[-1]), len(rows)
    on_dev = staging.to(cuda)
    flat, code = on_dev[:n], on_dev[n:]
    before = _launches("window_stats")
    got = [x.cpu() for x in V.unpack_window_stats(
        V.window_stats_packed(flat, torch.from_numpy(offsets).to(cuda), code), nb, P)]
    assert _launches("window_stats") == before + 1
    for b, (tri, c) in enumerate(zip(tris, codes)):
        plain = [x.cpu() for x in V.window_stats_plain(flat[offsets[b] : offsets[b + 1]][None], code[b : b + 1])]
        for g, r in zip(got, plain):
            assert torch.equal(g[b], r[0]), f"block {b} ({rows[b]} rows)"
        tc, tn, cov = V.column_stats_host(tri)
        mm, cc = V.window_error_stats_host(tri, c)
        for g, r in zip(got[:3], (tc, tn, cov)):
            np.testing.assert_array_equal(g[b].numpy(), r)
        assert (int(got[3][b]), int(got[4][b])) == (mm, cc)
    assert [x.tolist() for x in got] == [x.tolist() for x in V.window_stats_blocks(tris, codes, cuda)]
    # the dense entry routes through the kernel too: blocks of one row count
    same = [b for b in range(nb) if rows[b] == rows[2]]
    tri_d = torch.from_numpy(np.stack([tris[b] for b in same])).to(cuda)
    code_d = torch.from_numpy(np.stack([codes[b] for b in same])).to(cuda)
    before = _launches("window_stats")
    dense = V.window_stats_batch(tri_d, code_d)
    assert _launches("window_stats") == before + 1
    for g, r in zip(dense, V.window_stats_plain(tri_d, code_d)):
        assert torch.equal(g, r)


def _two_contig_job(device):
    """Two 40 kb contigs of two strains each at 1%, 30x of 8 kb reads a
    contig at 10% error, mapped on the card: the per-contig pending preps
    of stage 3, and what writing the COL file needs."""
    from hairsplitter_tpu_torch.pipeline import call_variants as cv

    rng = np.random.default_rng(30)
    haps = {name: make_haplotypes(40_000, 2, 0.01, rng) for name in ("a", "b")}
    reads = simulate_reads(haps["a"] + haps["b"], coverage=15, read_len=8000, rng=rng,
                           sub_rate=0.06, ins_rate=0.02, del_rate=0.02).seqs
    alns = map_reads({name: h[0] for name, h in haps.items()}, reads, MapConfig(), device=device)
    per_contig = {name: sorted((a for a in alns if a.contig == name), key=lambda a: (a.read_idx, a.t_start))
                  for name in haps}
    seqs = dict(enumerate(reads))
    cfg = cv.VariantCallConfig()
    pending = lambda: [cv.prepare_contig_host(name, haps[name][0], per_contig[name], seqs, cfg)  # noqa: E731
                       for name in haps]
    return pending, per_contig, cfg


def test_finish_preps_on_card_equals_cpu(cuda, tmp_path):
    """Every block of both contigs in one device pass, on the card with one
    launch and on the CPU with none; every field of every ContigPrep and the
    stage's COL file equal to the CPU route's."""
    from hairsplitter_tpu_torch.io.col_gro import write_col
    from hairsplitter_tpu_torch.pipeline import call_variants as cv
    from hairsplitter_tpu_torch.utils import tracing

    pending, per_contig, cfg = _two_contig_job(cuda)

    def run(device):
        first, before = next(tracing._ids), _build.kernel_launch_counts()
        with tracing.span("stats") as sp:
            preps = cv.finish_preps(pending(), cfg, device=device)
        after = _build.kernel_launch_counts()
        under = [(s.name, s.counts) for s in tracing.spans() if s.id > first and s.parent == sp.id]
        return preps, {k: v - before[k] for k, v in after.items() if v != before[k]}, under

    ref, ref_launches, ref_under = run("cpu")
    got, launches, under = run(cuda)
    n_blocks = sum(len(p.win_stats) for p in ref.values())
    assert launches == {"window_stats": 1} and ref_launches == {}
    assert under == ref_under == [("device_pass", {"blocks": n_blocks}), ("host_pass", {})]
    assert n_blocks >= 4
    for name in ref:
        g, r = got[name], ref[name]
        assert (g.length, g.n_reads, g.mismatches, g.cells) == (r.length, r.n_reads, r.mismatches, r.cells)
        np.testing.assert_array_equal(g.hp_mask, r.hp_mask)
        for (gb, *gs), (rb, *rs) in zip(g.win_stats, r.win_stats, strict=True):
            assert gb.start == rb.start
            for x, y in zip(gs, rs):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    err = {d: min(sum(p.mismatches for p in preps.values()) / sum(p.cells for p in preps.values()), cfg.error_cap)
           for d, preps in (("cpu", ref), ("cuda", got))}
    assert err["cpu"] == err["cuda"]
    names = {i: f"read{i}" for a in per_contig.values() for i in (x.read_idx for x in a)}
    for d, preps in (("cpu", ref), ("cuda", got)):
        variants = {name: cv.call_variants_from_prep(p, err[d], cfg, device=d if d == "cpu" else cuda)
                    for name, p in preps.items()}
        write_col(str(tmp_path / f"{d}.col"), variants, per_contig, names)
    assert (tmp_path / "cuda.col").read_bytes() == (tmp_path / "cpu.col").read_bytes()
    assert (tmp_path / "cpu.col").stat().st_size > 0

"""On-card checks of the PyTorch port: the CUDA kernels (K1 Myers and K2 int32
banded DP, each in its check mode and its fused main-path mode) against their
plain PyTorch versions, and the fused call and
`map_reads` on the GPU against the same functions on the CPU, for both DP
kernels; and the paths off the main one on the GPU against the CPU: the
polisher CNN (logits atol/rtol 1e-4, bases above a top-two margin of 1e-3),
`correct_assembly` and `spectral_phase` (equal). Every test is marked `cuda` and skips without a GPU (the kernels
have no CPU mode).

This file imports nothing of JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import MODE_PATTERNS, edge_jobs, mode_pattern, random_jobs
from hairsplitter_tpu_torch.utils.sim import make_haplotypes, simulate_reads
from hairsplitter_tpu_torch.core.mapping import MapConfig, map_reads
from hairsplitter_tpu_torch.ops import align_dp_cuda as ad
from hairsplitter_tpu_torch.ops import align_myers_cuda as am
from hairsplitter_tpu_torch.ops.align import BandSpec
from hairsplitter_tpu_torch.ops.align_device import align_traceback_rows, banded_fused_plain, myers_fused_plain

pytestmark = pytest.mark.cuda

SPEC = BandSpec(chunk=256, band=128)


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
    before = am.myers_rows.launches
    got = am.myers_rows(qd, td, SPEC, emit_tb=True)
    ref = am.myers_rows_torch(qd, td, SPEC, emit_tb=True)
    assert am.myers_rows.launches == before + 1
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
    before, rows_before = am.myers_fused_cuda.launches, am.myers_rows.launches
    got = align_traceback_rows(*arrays, SPEC, "myers")
    torch.cuda.synchronize()
    assert am.myers_fused_cuda.launches == before + 1
    assert am.myers_rows.launches == rows_before  # the check-mode kernel is not on this path
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
    before = ad.banded_align_batch_dp.launches
    got = ad.banded_align_batch_dp(*arrays, SPEC, emit_enc=emit_enc)
    torch.cuda.synchronize()
    assert ad.banded_align_batch_dp.launches == before + 1
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
    before, check_before = ad.banded_fused_cuda.launches, ad.banded_align_batch_dp.launches
    got = align_traceback_rows(*arrays, SPEC, "pallas")
    torch.cuda.synchronize()
    assert ad.banded_fused_cuda.launches == before + 1
    assert ad.banded_align_batch_dp.launches == check_before
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
    before = ad.banded_fused_cuda.launches
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
    assert ad.banded_fused_cuda.launches == before


FUSED_WRAPPER = {"myers": am.myers_fused_cuda, "pallas": ad.banded_fused_cuda}


def test_empty_batch_launches_nothing_and_counts_nothing(cuda):
    """A launch counter moves only where a kernel is launched: no job, no
    launch, an empty result of the right shape and no count."""
    q, ql, t, tl = (torch.from_numpy(x[:0]).to(cuda) for x in _jobs(5, 16))
    modes = torch.zeros(0, dtype=torch.int32, device=cuda)
    wrappers = (am.myers_rows, am.myers_fused_cuda, ad.banded_align_batch_dp, ad.banded_fused_cuda)
    before = [w.launches for w in wrappers]
    assert [x.shape for x in am.myers_rows(q, t, SPEC, emit_tb=True)] == [(0, SPEC.chunk, 4)] * 4
    assert am.myers_fused_cuda(q, ql, t, tl, modes, SPEC).shape == (0, 16 + SPEC.chunk)
    assert ad.banded_align_batch_dp(q, ql, t, tl, SPEC, emit_enc=True)["enc"].shape == (0, SPEC.chunk, 128)
    assert ad.banded_fused_cuda(q, ql, t, tl, modes, SPEC).shape == (0, 16 + SPEC.chunk)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("kernel", ["myers", "pallas"])
def test_fused_call_on_card_equals_cpu(cuda, kernel):
    arrays = _jobs(7, 2048)
    modes = (np.arange(2048) % 2).astype(np.int32)
    host = [torch.from_numpy(x) for x in (*arrays, modes)]
    cpu = align_traceback_rows(*host, SPEC, kernel)
    before = FUSED_WRAPPER[kernel].launches
    gpu = align_traceback_rows(*(x.to(cuda) for x in host), SPEC, kernel)
    assert FUSED_WRAPPER[kernel].launches == before + 1  # the call went through the fused kernel
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.parametrize("cfg", [MapConfig(), MapConfig(use_myers=False)], ids=["myers", "pallas"])
def test_map_reads_on_card_equals_cpu(cuda, cfg):
    rng = np.random.default_rng(3)
    haps = make_haplotypes(12_000, 2, 0.01, rng)
    reads = simulate_reads(haps, coverage=8, read_len=3000, rng=rng,
                           sub_rate=0.06, ins_rate=0.02, del_rate=0.02).seqs
    key = lambda a: (a.read_idx, a.strand, a.q_start, a.q_end, a.t_start, a.t_end,  # noqa: E731
                     a.cigar_ops.tolist(), a.cigar_lens.tolist(), a.nm)
    wrapper = am.myers_fused_cuda if cfg.use_myers else ad.banded_fused_cuda
    cpu = [key(a) for a in map_reads({"c": haps[0]}, reads, cfg, device="cpu")]
    before, check_before = wrapper.launches, ad.banded_align_batch_dp.launches
    gpu = [key(a) for a in map_reads({"c": haps[0]}, reads, cfg, device=cuda)]
    assert wrapper.launches > before  # mapping on the card went through the fused kernel
    assert ad.banded_align_batch_dp.launches == check_before
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
    before = am.myers_fused_cuda.launches
    got = run(cuda)
    assert am.myers_fused_cuda.launches - before >= 3  # before, after one pass, after
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

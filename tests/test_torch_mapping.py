"""Parity of the port's fused mapping call and `map_reads`
(`hairsplitter_tpu_torch/core/mapping.py`) with the JAX package.

The JAX side runs on its CPU backend: the fused call in Pallas interpret
mode, `map_reads` through its native job runner, which the JAX package
documents (and tests) as bit-identical to its device path. Tolerance:
exact equality of the fused buffers and of every Alignment (coordinates,
CIGAR, NM)."""

import numpy as np
import pytest
import torch

from hairsplitter_tpu.core.mapping import MapConfig as JaxMapConfig
from hairsplitter_tpu.core.mapping import map_reads as jax_map_reads
from hairsplitter_tpu.ops.align import BandSpec as JaxBandSpec
from hairsplitter_tpu.ops.align_device import align_traceback_rows as jax_align_traceback_rows
from hairsplitter_tpu.ops.poa import _pin_anchors
from hairsplitter_tpu.utils.sim import random_genome, simulate_reads
from hairsplitter_tpu_torch.core.mapping import MapConfig, map_reads
from hairsplitter_tpu_torch.ops.align import BandSpec
from hairsplitter_tpu_torch.ops.align_device import align_traceback_rows
from tests.test_align_myers import _random_batch
from tests.torch_parity_data import alignment_key, edge_batch, strain_mix

CHUNK = 64
SPEC = BandSpec(chunk=CHUNK, band=128)
JSPEC = JaxBandSpec(chunk=CHUNK, band=128)


@pytest.mark.parametrize("kind,seed", [("random", 2), ("edge", 4)])
def test_fused_buffer_equals_jax(kind, seed):
    """A test_multi_bucket batch (chunk 64, N 32, alternating modes) and the
    edge batch: the [N, 16 + B] buffers agree byte for byte."""
    n = 32
    if kind == "edge":
        q, ql, t, tl = edge_batch(CHUNK, SPEC.t_width, n=n, seed=seed)
    else:
        q, ql, t, tl = _random_batch(np.random.default_rng(seed), n, JSPEC)
    modes = (np.arange(n) % 2).astype(np.int32)
    ref = np.asarray(jax_align_traceback_rows(q, ql, t, tl, modes, JSPEC, "myers", interpret=True))
    got = align_traceback_rows(
        *(torch.from_numpy(x) for x in (q, ql, t, tl, modes)), SPEC
    ).numpy()
    assert got.dtype == np.uint8 and got.shape == (n, 16 + CHUNK)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def clr_reads():
    """The CLR-noise dataset of tests/test_hpc_seeding.py (30 kb, 8x, ~19%
    hp-biased error)."""
    rng = np.random.default_rng(0)
    genome = random_genome(30_000, rng)
    sim = simulate_reads(
        [genome], coverage=8, read_len=6000, rng=rng,
        sub_rate=0.06, ins_rate=0.07, del_rate=0.06, homopolymer_bias=1.5,
    )
    return genome, sim.seqs


def _both(contigs, reads, kw, **extra):
    ref = jax_map_reads(contigs, reads, JaxMapConfig(**kw), **extra)
    got = map_reads(contigs, reads, MapConfig(**kw), device="cpu", **extra)
    return [alignment_key(a) for a in ref], [alignment_key(a) for a in got]


@pytest.mark.parametrize(
    "kw",
    [
        dict(k=19, w=10, rescue=False),
        dict(k=19, w=10, hpc=True, rescue=False),
        dict(k=19, w=10),  # with the short-minimizer rescue pass
    ],
    ids=["raw", "hpc", "rescue"],
)
def test_map_reads_equals_jax(clr_reads, kw):
    genome, reads = clr_reads
    ref, got = _both({"c": genome}, reads, kw)
    assert len(ref) > 0
    assert got == ref


def test_rescue_pass_changes_the_result(clr_reads):
    """The 'rescue' case above really goes through the rescue pass."""
    genome, reads = clr_reads
    plain = map_reads({"c": genome}, reads, MapConfig(k=19, w=10, rescue=False), device="cpu")
    rescued = map_reads({"c": genome}, reads, MapConfig(k=19, w=10), device="cpu")
    assert len({a.read_idx for a in rescued}) > len({a.read_idx for a in plain})


@pytest.fixture(scope="module")
def two_drafts():
    haps, sim = strain_mix(6000, 2, 16, 2000, 0.08, seed=5)
    return {"d0": haps[0], "d1": haps[1]}, sim.seqs


def test_map_reads_restrict_equals_jax(two_drafts):
    drafts, reads = two_drafts
    restrict = [f"d{i % 2}" for i in range(len(reads))]
    ref, got = _both(drafts, reads, {}, restrict=restrict)
    assert len(ref) > 0 and {k[1] for k in ref} == {"d0", "d1"}
    assert got == ref


def test_map_reads_pinned_equals_jax(two_drafts):
    """Pinned chains from a first pass (the polish remap path), with every
    fifth read left unpinned so the seeded fallback runs too."""
    drafts, reads = two_drafts
    first = jax_map_reads(drafts, reads, JaxMapConfig())
    by_read = {a.read_idx: a for a in first}
    pinned = []
    for i, r in enumerate(reads):
        a = by_read.get(i)
        pair = None if a is None or i % 5 == 0 else _pin_anchors(a, len(r), 0, len(drafts[a.contig]), len(drafts[a.contig]))
        pinned.append([(a.contig, a.strand, pair[0], pair[1])] if pair is not None else [])
    assert sum(1 for p in pinned if p) > len(reads) // 2
    ref, got = _both(drafts, reads, {}, pinned=pinned)
    assert got == ref

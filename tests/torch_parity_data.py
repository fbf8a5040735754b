"""Seeded datasets shared by the parity tests of the PyTorch port
(`tests/test_torch_*.py`): the same numpy inputs go through the JAX package
and through `hairsplitter_tpu_torch`."""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a test module's torch CPU work on one thread. The plain versions
    of the kernels are Python loops of small tensor ops: they gain nothing
    from intra-op threads, and lose an order of magnitude when the thread
    pools of several test workers spin for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edge_batch(B: int, T: int, n: int = 32, seed: int = 0):
    """Edge cases of the banded DP in one batch: empty queries, full-length
    queries, targets shorter than qlen - 64, and all-sentinel rows."""
    rng = np.random.default_rng(seed)
    q = np.full((n, B), 7, dtype=np.int8)
    t = np.full((n, T), 6, dtype=np.int8)
    qlens = np.zeros(n, dtype=np.int32)
    tlens = np.zeros(n, dtype=np.int32)
    for i in range(n):
        kind = i % 4
        if kind == 3:  # all-sentinel row
            continue
        ql = 0 if kind == 0 else B
        base = rng.integers(0, 4, ql).astype(np.int8)
        if kind == 0:
            tl = int(rng.integers(0, T + 1))
            ts = rng.integers(0, 4, tl).astype(np.int8)
        elif kind == 1 and i % 8 == 1:  # full-length query, noisy copy target
            ts = base.copy()
            sub = rng.random(B) < 0.1
            ts[sub] = rng.integers(0, 4, int(sub.sum()))
            tl = B
        else:  # full-length query, target shorter than qlen - 64
            tl = int(rng.integers(0, max(1, B - 64)))
            ts = base[:tl].copy()
        q[i, :ql] = base
        t[i, :tl] = ts[:tl]
        qlens[i], tlens[i] = ql, tl
    return q, qlens, t, tlens


def strain_mix(length: int, strains: int, coverage: float, read_len: int, err: float, seed: int):
    """Collapsed assembly (first haplotype) + reads of `strains` haplotypes
    at 1% divergence (the repo's pipeline-bench recipe,
    `scripts/bench_pipeline.py:build_dataset`)."""
    from hairsplitter_tpu.utils import sim

    rng = np.random.default_rng(seed)
    haps = sim.make_haplotypes(length, strains, 0.01, rng)
    reads = sim.simulate_reads(
        haps, coverage=coverage / strains, read_len=read_len, rng=rng,
        sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
    )
    return haps, reads


def alignment_key(a) -> tuple:
    return (
        a.read_idx, a.contig, a.strand, a.q_start, a.q_end, a.t_start, a.t_end,
        np.asarray(a.cigar_ops).tolist(), np.asarray(a.cigar_lens).tolist(), a.nm,
    )


def mapped_strain_mix(length: int, strains: int, coverage: float, read_len: int, err: float, seed: int):
    """`strain_mix` plus its reads mapped to the collapsed assembly by the
    JAX package's mapper, in the pipeline's per-contig row order. Returns
    (haplotypes, read sequences by index, alignments)."""
    from hairsplitter_tpu.core.mapping import map_reads

    haps, reads = strain_mix(length, strains, coverage, read_len, err, seed)
    alns = map_reads({"c": haps[0]}, reads.seqs)
    alns.sort(key=lambda a: (a.read_idx, a.t_start, a.q_start))
    return haps, dict(enumerate(reads.seqs)), alns


def call_stage3(module, contig_seq: str, alns, seqs, **device):
    """Stage 3 of contig "c" through `module` (the JAX package's or the
    port's `pipeline.call_variants`), as `run_pipeline` drives it."""
    cfg = module.VariantCallConfig()
    pending = module.prepare_contig_host("c", contig_seq, alns, seqs, cfg)
    prep = module.finish_preps([pending], cfg, **device)["c"]
    error_rate = min(prep.mismatches / max(1, prep.cells), cfg.error_cap)
    return module.call_variants_from_prep(prep, error_rate, cfg, **device)


def spy_calls(monkeypatch, module, name) -> list:
    """Wrap `module.name` for the test; the returned list grows by one per call."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls

"""Parity of the port's stage 3 (`hairsplitter_tpu_torch/pipeline/call_variants.py`,
`ops/variants.py`) with the JAX package's accelerator branches.

`call_variants._accel_available` is forced on for the JAX side, so both
run the device chi² path (>= 512 suspect columns) and the device column
stats (row bucket >= 256) on this dataset. Tolerance: exact equality of the
COL file and of ContigVariants, except the float32 chi² values themselves,
which are held to rtol 1e-6, with the gated booleans required to agree
except where a value lies within 1e-5 relative of its threshold — XLA and
torch may fuse the f32 operations differently."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hairsplitter_tpu.pipeline.call_variants as jax_cv
from hairsplitter_tpu.constants import TRIMER_ABSENT
from hairsplitter_tpu.io.col_gro import write_col as jax_write_col
from hairsplitter_tpu.ops import variants as jax_variants
import hairsplitter_tpu_torch.pipeline.call_variants as port_cv
from hairsplitter_tpu_torch.io.col_gro import write_col
from hairsplitter_tpu_torch.ops import variants as port_variants
from tests.torch_parity_data import call_stage3, mapped_strain_mix, spy_calls


@pytest.fixture(scope="module")
def mix():
    # 375 reads over 30 kb: >= 512 suspect columns, 8 kb pileup windows
    # with more than 128 rows (device column stats) and with fewer
    return mapped_strain_mix(30_000, 3, 45, 4000, 0.05, seed=3)


def test_col_and_contig_variants_equal(mix, monkeypatch, tmp_path):
    haps, seqs, alns = mix
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    corr_calls = spy_calls(monkeypatch, port_cv, "pairwise_column_correlation_packed")
    stats_calls = spy_calls(monkeypatch, port_cv, "window_stats_blocks")
    ref = call_stage3(jax_cv, haps[0], alns, seqs)
    got = call_stage3(port_cv, haps[0], alns, seqs, device="cpu")
    assert corr_calls and stats_calls, "the device branches did not run"
    assert len(ref.columns) >= 512
    for f in ("contig", "length", "depth", "error_rate", "n_reads"):
        assert getattr(got, f) == getattr(ref, f), f
    assert len(got.columns) == len(ref.columns)
    for g, r in zip(got.columns, ref.columns):
        assert (g.pos, g.top1, g.top2) == (r.pos, r.top1, r.top2)
        np.testing.assert_array_equal(g.rows, r.rows)
        np.testing.assert_array_equal(g.alleles, r.alleles)
    names = {i: f"read{i}" for i in seqs}
    jax_write_col(str(tmp_path / "jax.col"), {"c": ref}, {"c": alns}, names)
    write_col(str(tmp_path / "port.col"), {"c": got}, {"c": alns}, names)
    assert (tmp_path / "port.col").read_bytes() == (tmp_path / "jax.col").read_bytes()


def test_window_stats_batch_equals_jax():
    rng = np.random.default_rng(1)
    nb, R, P = 3, 40, 1024
    tri = rng.integers(0, 125, (nb, R, P)).astype(np.int8)
    tri[rng.random((nb, R, P)) < 0.4] = TRIMER_ABSENT
    tri[:, :, :50] = tri[:, :1, :50]  # count ties
    codes = rng.integers(0, 5, (nb, P)).astype(np.int8)
    got = [x.numpy() for x in port_variants.window_stats_batch(torch.from_numpy(tri), torch.from_numpy(codes))]
    for b in range(nb):
        tc, tn, cov = (np.asarray(x) for x in jax_variants.column_stats(jnp.asarray(tri[b])))
        mm, cc = (int(x) for x in jax_variants.window_error_stats(jnp.asarray(tri[b]), jnp.asarray(codes[b])))
        np.testing.assert_array_equal(got[0][b], tc)
        np.testing.assert_array_equal(got[1][b], tn)
        np.testing.assert_array_equal(got[2][b], cov)
        assert (int(got[3][b]), int(got[4][b])) == (mm, cc)


def _indicators(rng, S, n):
    """Column allele indicators with shared read partitions (so chi² spans
    far below and far above the thresholds)."""
    part = rng.random((4, n)) < 0.5
    which = rng.integers(0, 4, S)
    present = rng.random((S, n)) < 0.7
    noise = rng.random((S, n)) < rng.uniform(0.02, 0.45, (S, 1))
    alt = part[which] ^ noise
    A = (present & alt).astype(np.uint8)
    R = (present & ~alt).astype(np.uint8)
    return A, R, part


def test_pairwise_chi2_within_tolerance():
    rng = np.random.default_rng(2)
    S, n = 96, 203
    A, R, _ = _indicators(rng, S, n)
    pos = np.sort(rng.integers(0, 120_000, S)).astype(np.int64)
    keep, span, margin = 15.0, 50_000, 0.1
    corr_ref, flip_ref = (
        np.unpackbits(np.asarray(x), axis=1, bitorder="little")[:S, :S].astype(bool)
        for x in jax_variants.pairwise_column_correlation(
            jnp.asarray(A, jnp.float32), jnp.asarray(R, jnp.float32), jnp.asarray(pos, jnp.int32),
            np.float32(keep), np.int32(span), np.float32(margin), np.float32(0.0),
        )
    )
    pk = lambda x: torch.from_numpy(np.packbits(x, axis=1, bitorder="little"))  # noqa: E731
    corr, flip = port_variants.pairwise_column_correlation_packed(
        pk(A), pk(R), torch.from_numpy(pos), keep, span, margin, 0.0
    )
    # the chi² values of both twins on the phase-aligned tables
    Af, Rf = A.astype(np.float32), R.astype(np.float32)
    n11, n10, n01, n00 = Af @ Af.T, Af @ Rf.T, Rf @ Af.T, Rf @ Rf.T
    fl = (n11 + n00) < (n10 + n01)
    tabs = [np.where(fl, n01, n00), np.where(fl, n00, n01), np.where(fl, n11, n10), np.where(fl, n10, n11)]
    chi_ref = np.asarray(jax_variants._chi2_dev(*(jnp.asarray(x) for x in tabs)))
    chi = port_variants.chi2_tables(*(torch.from_numpy(x) for x in tabs)).numpy()
    np.testing.assert_allclose(chi, chi_ref, rtol=1e-6)
    assert (chi_ref > keep).sum() > 100 and (chi_ref <= keep).sum() > 100
    np.testing.assert_array_equal(flip.numpy(), flip_ref)
    near = np.abs(chi_ref - keep) <= 1e-5 * keep
    np.testing.assert_array_equal(corr.numpy()[~near], corr_ref[~near])


def test_partition_scans_equal_jax():
    rng = np.random.default_rng(3)
    S, n, K = 80, 128, 3
    A, R, part = _indicators(rng, S, n)
    seen = rng.random((K, n)) < 0.8
    P1 = (part[:K] & seen).astype(np.float32)
    P0 = (~part[:K] & seen).astype(np.float32)
    col_size = (A.sum(1) + R.sum(1)).astype(np.float32)
    pk = lambda x: torch.from_numpy(np.packbits(x, axis=1, bitorder="little"))  # noqa: E731
    unpack = lambda b: np.unpackbits(np.asarray(b), bitorder="little")[:S].astype(bool)  # noqa: E731
    keep_ref = unpack(jax_variants.partition_column_keep(
        P1, P0, A.astype(np.float32), R.astype(np.float32), col_size, np.float32(15.0)))
    keep = port_variants.partition_column_keep_packed(
        torch.from_numpy(P1), torch.from_numpy(P0), pk(A), pk(R), torch.from_numpy(col_size), 15.0)
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    resc_ref = unpack(jax_variants.partition_rescue_keep(
        P1, P0, A.astype(np.float32), R.astype(np.float32), np.float32(20.0)))
    resc = port_variants.partition_rescue_keep_packed(
        torch.from_numpy(P1), torch.from_numpy(P0), pk(A), pk(R), 20.0)
    np.testing.assert_array_equal(resc.numpy(), resc_ref)
    assert keep_ref.any() and resc_ref.any() and not keep_ref.all()

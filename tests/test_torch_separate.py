"""Parity of the port's stage 4 (`hairsplitter_tpu_torch/pipeline/separate_reads.py`,
`ops/phase.py`, `ops/cluster.py`) with the JAX package's accelerator
branch (`SeparateConfig(use_device_cw=True)`).

Tolerance: exact equality of adjacency, labels and the GRO file."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hairsplitter_tpu.pipeline.call_variants as jax_cv
import hairsplitter_tpu.pipeline.separate_reads as jax_sep
from hairsplitter_tpu.io.col_gro import write_gro as jax_write_gro
from hairsplitter_tpu.ops.cluster import chinese_whispers_multi as jax_cw_multi
from hairsplitter_tpu.ops.phase import read_graph_device as jax_read_graph_device
import hairsplitter_tpu_torch.pipeline.call_variants as port_cv
import hairsplitter_tpu_torch.pipeline.separate_reads as port_sep
from hairsplitter_tpu_torch.io.col_gro import write_gro
from hairsplitter_tpu_torch.ops.cluster import chinese_whispers_multi
from hairsplitter_tpu_torch.ops.phase import read_graph_device
from tests.torch_parity_data import call_stage3, mapped_strain_mix, spy_calls


@pytest.mark.parametrize(
    "dataset,amplicon,device_step",
    [
        # 375 reads: device sims (>= 256 rows), row-compacted windows
        ((30_000, 3, 45, 4000, 0.05, 3), False, "phase_windows_sub"),
        # whole-contig window: the dense contig-level path
        ((8_000, 2, 16, 4000, 0.05, 4), True, "phase_windows"),
    ],
    ids=["compact", "amplicon"],
)
def test_gro_equals_jax(dataset, amplicon, device_step, monkeypatch, tmp_path):
    haps, seqs, alns = mapped_strain_mix(*dataset)
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    cv_ref = call_stage3(jax_cv, haps[0], alns, seqs)
    cv = call_stage3(port_cv, haps[0], alns, seqs, device="cpu")
    assert len(cv.columns) == len(cv_ref.columns) > 0
    steps = spy_calls(monkeypatch, port_sep, device_step)
    sims = spy_calls(monkeypatch, port_sep, "sims_diffs_packed")
    spans = [(a.t_start, a.t_end) for a in alns]
    ref = jax_sep.separate_reads_for_contig(
        cv_ref, spans, jax_sep.SeparateConfig(use_device_cw=True, amplicon=amplicon)
    )
    got = port_sep.separate_reads_for_contig(
        cv, spans, port_sep.SeparateConfig(amplicon=amplicon), device="cpu"
    )
    assert steps, f"{device_step} did not run"
    assert bool(sims) == (len(alns) >= 256)
    assert len(got.windows) == len(ref.windows)
    for g, r in zip(got.windows, ref.windows):
        assert (g.start, g.end) == (r.start, r.end)
        np.testing.assert_array_equal(g.labels, r.labels)
    assert any(len(set(w.labels[w.labels >= 0].tolist())) > 1 for w in ref.windows)
    names = {i: f"read{i}" for i in seqs}
    jax_write_gro(str(tmp_path / "jax.gro"), {"c": ref}, {"c": alns}, names)
    write_gro(str(tmp_path / "port.gro"), {"c": got}, {"c": alns}, names)
    assert (tmp_path / "port.gro").read_bytes() == (tmp_path / "jax.gro").read_bytes()


def _random_graph_inputs(rng, n):
    sim = rng.integers(3, 60, (n, n)).astype(np.int32)
    diff = rng.integers(0, 5, (n, n)).astype(np.int32)
    # exact-1.0 distances (diff <= 1), small overlaps and empty pairs
    # exercise the knee fallback and the min-overlap rule
    diff[rng.random((n, n)) < 0.3] = 1
    sim[rng.random((n, n)) < 0.1] = 2
    sim[rng.random((n, n)) < 0.2] = 0
    sim = np.maximum(sim, sim.T)
    diff = np.maximum(diff, diff.T)
    np.fill_diagonal(sim, 0)
    np.fill_diagonal(diff, 0)
    mask = rng.random(n) < 0.85
    return sim, diff, mask


@pytest.mark.parametrize("n,seed", [(6, 0), (32, 1), (64, 2)])
def test_read_graph_closed_form_equals_scan(n, seed):
    """The port's closed form of the rank-order acceptance equals the JAX
    twin's `lax.scan` on every window of a batch."""
    rng = np.random.default_rng(seed)
    wins = [_random_graph_inputs(rng, n) for _ in range(4)]
    err = np.float32(0.04 + 0.02 * seed)
    got = read_graph_device(
        torch.from_numpy(np.stack([w[0] for w in wins])),
        torch.from_numpy(np.stack([w[1] for w in wins])),
        torch.from_numpy(np.stack([w[2] for w in wins])),
        float(err),
    ).numpy()
    for g, (sim, diff, mask) in zip(got, wins):
        ref = np.asarray(jax_read_graph_device(sim, diff, mask, err))
        np.testing.assert_array_equal(g, ref)
        assert ref.sum() > 0


@pytest.mark.parametrize("n,K,seed", [(16, 3, 0), (48, 5, 1)])
def test_chinese_whispers_multi_equals_jax(n, K, seed):
    """Seeded CW runs with per-run stop states, against the JAX twin's
    `lax.map` of while-loops (each seed stops on its own)."""
    rng = np.random.default_rng(seed)
    G = 3
    adj = np.zeros((G, n, n), np.int8)
    masks = rng.random((G, n)) < 0.9
    inits = np.full((G, K, n), -2, np.int64)
    for g in range(G):
        blocks = rng.integers(0, 3, n)
        p = np.where(blocks[:, None] == blocks[None, :], 0.6, 0.08)
        a = np.triu(rng.random((n, n)) < p, 1)
        adj[g] = a | a.T
        for k in range(K - g % 2):  # ragged seed counts: padded -2 seeds
            labels = np.arange(n)
            share = rng.random(n) < 0.3
            labels[share] = int(np.nonzero(share)[0][0]) if share.any() else 0
            inits[g, k] = labels
    got = chinese_whispers_multi(
        torch.from_numpy(adj), torch.from_numpy(inits), torch.from_numpy(masks)
    ).numpy()
    for g in range(G):
        ref = np.asarray(jax_cw_multi(
            jnp.asarray(adj[g], jnp.float32), jnp.asarray(inits[g], jnp.int32), jnp.asarray(masks[g])
        ))
        np.testing.assert_array_equal(got[g], ref)

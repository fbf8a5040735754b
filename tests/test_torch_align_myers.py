"""Parity of the port's Myers DP (`hairsplitter_tpu_torch/ops/align_myers_cuda.py`)
with the JAX package's Pallas kernel (interpret mode).

Tolerance: exact equality of every word, byte and label."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hairsplitter_tpu.ops.align import BandSpec as JaxBandSpec
from hairsplitter_tpu.ops.align_myers_pallas import _words_from_device_jnp, myers_rows_pallas
from hairsplitter_tpu_torch.ops import _build
from hairsplitter_tpu_torch.ops import align_myers_cuda as am
from hairsplitter_tpu_torch.ops.align import BandSpec
from tests.test_align_myers import _random_batch
from tests.torch_parity_data import edge_batch

CHUNK = 64
SPEC = BandSpec(chunk=CHUNK, band=128)
JSPEC = JaxBandSpec(chunk=CHUNK, band=128)


def _pallas_words(q, t):
    outs = myers_rows_pallas(jnp.asarray(q), jnp.asarray(t), JSPEC, interpret=True, emit_tb=True)
    return [np.asarray(_words_from_device_jnp(x)) for x in outs]


def _torch_words(q, t):
    outs = am.myers_rows_torch(torch.from_numpy(q), torch.from_numpy(t), SPEC, emit_tb=True)
    return [x.contiguous().numpy().view(np.uint32) for x in outs]


def _batch(kind: str, n: int, seed: int):
    if kind == "edge":
        return edge_batch(CHUNK, SPEC.t_width, n=n, seed=seed)
    return _random_batch(np.random.default_rng(seed), n, JSPEC)


@pytest.mark.parametrize("kind,n,seed", [("random", 32, 0), ("random", 64, 1), ("edge", 32, 2)])
def test_myers_rows_torch_equals_pallas(kind, n, seed):
    q, _, t, _ = _batch(kind, n, seed)
    ref = _pallas_words(q, t)
    got = _torch_words(q, t)
    for name, r, g in zip(("P", "M", "nonleft", "isup"), ref, got):
        assert r.shape == g.shape == (n, CHUNK, 4), name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_cpu_wrapper_runs_plain_version_without_launch():
    q, _, t, _ = _random_batch(np.random.default_rng(5), 8, JSPEC)
    before = _build.kernel_launch_counts()
    got = am.myers_rows(torch.from_numpy(q), torch.from_numpy(t), SPEC, emit_tb=True)
    ref = am.myers_rows_torch(torch.from_numpy(q), torch.from_numpy(t), SPEC, emit_tb=True)
    assert _build.kernel_launch_counts() == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_bit_helpers_match_numpy():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    x[:3] = [0, 1, 0xFFFFFFFF]
    xt = torch.from_numpy(x.astype(np.int64))
    pc = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(am.popcount32(xt).numpy(), pc)
    hb = np.array([int(v).bit_length() - 1 for v in x])
    np.testing.assert_array_equal(am.highest_bit32(xt).numpy(), hb)

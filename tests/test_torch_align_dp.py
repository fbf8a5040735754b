"""Parity of the port's int32 banded-DP path (`hairsplitter_tpu_torch/ops/
align_dp_cuda.py`, the `"pallas"` and `"jnp"` branches of the fused call and
`MapConfig(use_myers=False)`) with the JAX package.

The JAX side runs on its CPU backend: the Pallas kernel in interpret mode,
`map_reads` through its native job runner and the pipeline with its
accelerator branches forced. Tolerance: exact equality everywhere (every
plane cell, row, column minimum, fused byte, Alignment and artifact)."""

import numpy as np
import pytest
import torch

import hairsplitter_tpu.pipeline.call_variants as jax_cv
from hairsplitter_tpu.core.mapping import MapConfig as JaxMapConfig
from hairsplitter_tpu.core.mapping import map_reads as jax_map_reads
from hairsplitter_tpu.ops.align import BandSpec as JaxBandSpec
from hairsplitter_tpu.ops.align_device import align_traceback_rows as jax_align_traceback_rows
from hairsplitter_tpu.ops.align_device import encode_runs as jax_encode_runs
from hairsplitter_tpu.ops.align_device import traceback_scan as jax_traceback_scan
from hairsplitter_tpu.ops.align_pallas import banded_align_batch_pallas
from hairsplitter_tpu.pipeline.orchestrate import PipelineConfig as JaxPipelineConfig
from hairsplitter_tpu.pipeline.orchestrate import run_pipeline as jax_run_pipeline
from hairsplitter_tpu.pipeline.separate_reads import SeparateConfig as JaxSeparateConfig
from hairsplitter_tpu_torch.compat import config_from_jax
from hairsplitter_tpu_torch.core import mapping as port_mapping
from hairsplitter_tpu_torch.core.mapping import MapConfig, map_reads
from hairsplitter_tpu_torch.ops import align_dp_cuda as ad
from hairsplitter_tpu_torch.ops.align import BandSpec
from hairsplitter_tpu_torch.ops.align_device import (
    align_traceback_rows,
    encode_runs,
    readout_device,
    traceback_scan,
)
from hairsplitter_tpu_torch.pipeline.orchestrate import run_pipeline
from tests.test_align_myers import _random_batch
from tests.test_align_pallas import _mk_batch
from tests.test_torch_mapping import clr_reads  # noqa: F401  (module fixture)
from tests.test_torch_pipeline import ARTIFACTS, _two_strain_dataset
from tests.torch_parity_data import alignment_key, edge_batch, spy_calls

N = 32
BATCHES = {  # name -> (chunk, maker(spec) -> (q, qlens, t, tlens))
    "mk0": (64, lambda s: _mk_batch(np.random.default_rng(0), N, s)),
    "mk1": (64, lambda s: _mk_batch(np.random.default_rng(1), N, s)),
    "edge": (64, lambda s: edge_batch(s.chunk, s.t_width, n=N, seed=3)),
    "random256": (256, lambda s: _random_batch(np.random.default_rng(6), N, s)),
}


def _batch(name):
    chunk, make = BATCHES[name]
    jspec = JaxBandSpec(chunk=chunk, band=128)
    return BandSpec(chunk=chunk, band=128), jspec, make(jspec)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


@pytest.mark.parametrize("emit_enc", [False, True], ids=["bp", "enc"])
@pytest.mark.parametrize("name", list(BATCHES))
def test_plain_k2_equals_pallas(name, emit_enc):
    spec, jspec, (q, ql, t, tl) = _batch(name)
    ref = banded_align_batch_pallas(q, ql, t, tl, jspec, interpret=True, emit_enc=emit_enc)
    got = ad.banded_align_batch_torch(*_t(q, ql, t, tl), spec, emit_enc=emit_enc)
    plane = "enc" if emit_enc else "bp"
    assert got.keys() == ref.keys() == {plane, "row_at_q", "colmin_val", "colmin_i"}
    assert got[plane].dtype == (torch.int16 if emit_enc else torch.uint8)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("name", ["mk0", "edge"])
def test_encode_runs_and_traceback_scan_equal_jax(name):
    spec, jspec, (q, ql, t, tl) = _batch(name)
    res = ad.banded_align_batch_torch(*_t(q, ql, t, tl), spec)
    bp = res["bp"].numpy()
    enc = encode_runs(res["bp"])
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jax_encode_runs(bp)))
    modes = torch.from_numpy((np.arange(N) % 2).astype(np.int32))
    _, si, sb, _ = readout_device(res, *_t(ql, tl), modes, spec)
    got = traceback_scan(enc, si, sb).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_traceback_scan(np.asarray(enc), si.numpy(), sb.numpy())))


def test_cpu_wrapper_runs_plain_version_without_launch():
    spec, _, arrays = _batch("mk1")
    before = ad.banded_align_batch_dp.launches
    got = ad.banded_align_batch_dp(*_t(*arrays), spec, emit_enc=True)
    ref = ad.banded_align_batch_torch(*_t(*arrays), spec, emit_enc=True)
    assert ad.banded_align_batch_dp.launches == before
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
    with pytest.raises(ValueError, match="band 128"):
        ad.banded_align_batch_dp(*_t(*arrays), BandSpec(chunk=64, band=64))


def _fused(arrays, spec, kernel):
    modes = (np.arange(len(arrays[0])) % 2).astype(np.int32)
    return align_traceback_rows(*_t(*arrays, modes), spec, kernel).numpy()


def _jax_fused(arrays, jspec, kernel, interpret=False):
    modes = (np.arange(len(arrays[0])) % 2).astype(np.int32)
    return np.asarray(jax_align_traceback_rows(*arrays, modes, jspec, kernel, interpret=interpret))


@pytest.mark.parametrize("name", ["random256", "edge"])
def test_fused_pallas_buffer_equals_jax_and_myers(name):
    spec, jspec, arrays = _batch(name)
    got = _fused(arrays, spec, "pallas")
    assert got.dtype == np.uint8 and got.shape == (N, 16 + spec.chunk)
    np.testing.assert_array_equal(got, _jax_fused(arrays, jspec, "pallas", interpret=True))
    np.testing.assert_array_equal(got, _fused(arrays, spec, "myers"))


@pytest.mark.parametrize(
    "chunk,band,n,seed", [(48, 32, 96, 0), (64, 64, 96, 1), (256, 128, 32, 2)]
)
def test_fused_jnp_buffer_equals_jax(chunk, band, n, seed):
    """The cases of tests/test_traceback_rows.py:test_rows_traceback_jnp_kernel."""
    jspec = JaxBandSpec(chunk=chunk, band=band)
    arrays = _random_batch(np.random.default_rng(seed), n, jspec)
    got = _fused(arrays, BandSpec(chunk=chunk, band=band), "jnp")
    np.testing.assert_array_equal(got, _jax_fused(arrays, jspec, "jnp"))


@pytest.mark.parametrize(
    "kw,kernel",
    [
        (dict(k=19, w=10, use_myers=False), "pallas"),
        (dict(spec=(256, 64), use_pallas=False), "jnp"),
    ],
    ids=["use_myers_false", "band64_plain"],
)
def test_map_reads_equals_jax(clr_reads, monkeypatch, kw, kernel):  # noqa: F811
    genome, reads = clr_reads
    jkw, pkw = dict(kw), dict(kw)
    if "spec" in kw:
        jkw["spec"] = JaxBandSpec(*kw["spec"])
        pkw["spec"] = BandSpec(*kw["spec"])
    kernels = []
    orig = port_mapping.align_traceback_rows
    monkeypatch.setattr(
        port_mapping, "align_traceback_rows",
        lambda *a: kernels.append(a[-1]) or orig(*a),
    )
    ref = [alignment_key(a) for a in jax_map_reads({"c": genome}, reads, JaxMapConfig(**jkw))]
    got = [alignment_key(a) for a in map_reads({"c": genome}, reads, MapConfig(**pkw), device="cpu")]
    assert len(ref) > 0 and got == ref
    assert kernels and set(kernels) == {kernel}


def test_use_pallas_at_band_64_raises(clr_reads):  # noqa: F811
    genome, reads = clr_reads
    cfg = MapConfig(spec=BandSpec(chunk=256, band=64))
    assert port_mapping.dp_kernel(MapConfig(spec=BandSpec(chunk=256, band=64), use_pallas=False)) == "jnp"
    with pytest.raises(ValueError, match=r"use_pallas=False") as err:
        map_reads({"c": genome}, reads[:4], cfg, device="cpu")
    assert "band 128" in str(err.value)


def test_config_from_jax_carries_kernel_switches():
    jcfg = JaxPipelineConfig(map=JaxMapConfig(use_myers=False, use_pallas=False))
    cfg = config_from_jax(jcfg)
    assert (cfg.map.use_myers, cfg.map.use_pallas) == (False, False)
    assert port_mapping.dp_kernel(cfg.map) == "jnp"
    assert port_mapping.dp_kernel(config_from_jax(JaxPipelineConfig()).map) == "myers"


def test_pipeline_use_myers_false_artifacts_equal_jax(tmp_path, monkeypatch):
    """`test_torch_pipeline.py`'s 20 kb two-strain case with stage 2 on the
    int32 banded DP (stages 5 and 6 map with the default MapConfig in both
    packages, so they stay on the Myers DP)."""
    asm, reads = _two_strain_dataset(str(tmp_path))
    monkeypatch.setattr(jax_cv, "_accel_available", lambda: True)
    k2 = spy_calls(monkeypatch, ad, "banded_align_batch_torch")
    cfg = JaxPipelineConfig(
        map=JaxMapConfig(use_myers=False), separate=JaxSeparateConfig(use_device_cw=True)
    )
    jax_run_pipeline(asm, reads, str(tmp_path / "jax"), cfg)
    run_pipeline(asm, reads, str(tmp_path / "port"), config_from_jax(cfg))
    assert k2, "stage 2 did not run the int32 banded DP"
    for name in ARTIFACTS:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert len(got) > 0, name

"""The port's sharded steps (`hairsplitter_tpu_torch/parallel/mesh.py`) and
the stage-3/4 device step they split (`ops/phase.py:phase_contigs_batch`),
against the JAX package on the same seeded numpy inputs and against their
own unsharded calls. Mirrors tests/test_sharding.py, over lists of `"cpu"`
entries in the place of the virtual CPU mesh.

Tolerance: zero. Every value is an integer or a label, except the error
rate, which is compared as float32 bits. JAX labels are int32 and the
port's int64: values are compared."""

import jax
import numpy as np
import pytest
import torch

import hairsplitter_tpu.parallel.mesh as jax_mesh
from hairsplitter_tpu.ops.align import BandSpec as JaxBandSpec
from hairsplitter_tpu.ops.phase import phase_contigs_batch as jax_phase_contigs_batch
from hairsplitter_tpu.ops.phase import sims_diffs_core as jax_sims_diffs_core
from hairsplitter_tpu_torch.ops.align import BandSpec
from hairsplitter_tpu_torch.ops.align_device import align_traceback_rows
from hairsplitter_tpu_torch.ops.phase import phase_contigs_batch, sims_diffs_core
from hairsplitter_tpu_torch.ops.variants import column_stats_host
from hairsplitter_tpu_torch.parallel.mesh import (
    column_stats_shard_step,
    make_map_example,
    make_mesh,
    make_phase_example,
    map_shard_step,
    phase_shard_step,
)
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the production-like shape of the JAX package's multi-device dry run
# (C = 2 x ctg contig windows of it): small enough for the CPU as it is
PRODUCTION = dict(Rr=512, Pp=2048, S=256, K=8)


def _f32_bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.uint32))


def _unsharded(example):
    err, adj, labels = phase_contigs_batch(*(torch.from_numpy(x) for x in example))
    return err, adj.numpy(), labels.numpy()


def _assert_phase_equal(got, ref):
    assert _f32_bits(got[0]) == _f32_bits(ref[0])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (8, (2, 4)), (6, (2, 3)), (7, (1, 7))])
def test_make_mesh_shapes(n, shape):
    mesh = make_mesh(["cpu"] * n)
    assert mesh.shape == shape and mesh.size == n
    assert mesh.axis_names == ("ctg", "pos")
    assert len(mesh.devices) == shape[0] and all(len(row) == shape[1] for row in mesh.devices)
    assert mesh.flat() == [torch.device("cpu")] * n
    # the JAX package's factorisation of the same count
    if n <= len(jax.devices()):
        assert jax_mesh.make_mesh(n).devices.shape == shape


def test_make_mesh_of_nothing_is_refused():
    with pytest.raises(ValueError):
        make_mesh([])


@pytest.mark.parametrize("kw", [dict(), dict(C=2, Rr=32, Pp=512, S=32, K=8), dict(C=3, Rr=16, Pp=64, S=8, K=2, seed=5)])
def test_make_phase_example_equals_the_jax_package(kw):
    for a, b in zip(make_phase_example(**kw), jax_mesh.make_phase_example(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec_kw,n,seed", [(dict(chunk=64, band=32), 64, 0), (dict(), 16, 3)])
def test_make_map_example_equals_the_jax_package(spec_kw, n, seed):
    got = make_map_example(n, BandSpec(**spec_kw), seed=seed)
    ref = jax_mesh.make_map_example(n, JaxBandSpec(**spec_kw), seed=seed)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(24, 16), (3, 40, 64)])
def test_sims_diffs_core_equals_jax(shape):
    rng = np.random.default_rng(1)
    covered = rng.random(shape) < 0.8
    alt = rng.random(shape) < 0.4
    A, R = (covered & alt).astype(np.float32), (covered & ~alt).astype(np.float32)
    sim, diff = sims_diffs_core(torch.from_numpy(A), torch.from_numpy(R))
    assert sim.dtype == diff.dtype == torch.int32
    ref = jax_sims_diffs_core if A.ndim == 2 else jax.vmap(jax_sims_diffs_core)
    sim_j, diff_j = ref(A, R)
    np.testing.assert_array_equal(sim.numpy(), np.asarray(sim_j))
    np.testing.assert_array_equal(diff.numpy(), np.asarray(diff_j))
    # additive over a split of the SNP axis: what the sharded step leans on
    h = shape[-1] // 2
    parts = [sims_diffs_core(torch.from_numpy(A[..., s].copy()), torch.from_numpy(R[..., s].copy()))
             for s in (slice(0, h), slice(h, None))]
    assert torch.equal(parts[0][0] + parts[1][0], sim) and torch.equal(parts[0][1] + parts[1][1], diff)


def test_phase_contigs_batch_equals_jax_and_separates():
    example = make_phase_example(C=2, Rr=32, Pp=512, S=32, K=8)
    err, adj, labels = _unsharded(example)
    assert isinstance(err, np.float32) and 0.0 < float(err) < 1.0
    assert adj.shape == (2, 32, 32) and adj.dtype == np.int8 and labels.shape == (2, 8, 32)
    _assert_phase_equal((err, adj, labels), jax.jit(jax_phase_contigs_batch)(*example))
    # the example is a clean 2-haplotype split: every seeded CW run must
    # recover it exactly (reads alternate haplotypes by index parity)
    truth = np.arange(32) % 2
    for c in range(2):
        for k in range(labels.shape[1]):
            lab = labels[c, k]
            assert len(set(lab.tolist())) >= 2
            for g in set(lab.tolist()):
                assert len(set(truth[lab == g].tolist())) == 1, "mixed cluster"


def test_phase_contigs_batch_production_shape_equals_jax():
    example = make_phase_example(C=2, **PRODUCTION)
    _assert_phase_equal(_unsharded(example), jax.jit(jax_phase_contigs_batch)(*example))


def test_phase_contigs_batch_n_iters_equals_jax():
    example = make_phase_example(C=2, Rr=48, Pp=256, S=24, K=4, seed=2)
    got = phase_contigs_batch(*(torch.from_numpy(x) for x in example), n_iters=3)
    ref = jax.jit(jax_phase_contigs_batch, static_argnames=("n_iters",))(*example, n_iters=3)
    _assert_phase_equal((got[0], got[1].numpy(), got[2].numpy()), ref)


def test_error_rate_is_a_float32_division():
    """Sums whose double quotient, rounded to float32 afterwards, is not the
    float32 quotient of the rounded sums."""
    from hairsplitter_tpu_torch.ops.phase import error_rate_f32

    n_differ = 0
    rng = np.random.default_rng(0)
    for _ in range(2000):
        mism, cov = int(rng.integers(1, 1 << 27)), int(rng.integers(1 << 24, 1 << 30))
        got = error_rate_f32(mism, cov)
        assert got.dtype == np.float32
        assert _f32_bits(got) == _f32_bits(np.float32(mism) / np.float32(cov))
        n_differ += _f32_bits(got) != _f32_bits(np.float32(mism / cov))
    assert n_differ > 0
    assert error_rate_f32(0, 0) == 0.0


@pytest.mark.parametrize("n_devices", [8, 2, 1])
def test_phase_shard_step_matches_unsharded(n_devices):
    mesh = make_mesh(["cpu"] * n_devices)
    ctg, pos = mesh.shape
    example = make_phase_example(C=2 * ctg, Rr=32, Pp=128 * pos, S=8 * pos, K=4)
    fn, args = phase_shard_step(mesh, example)
    assert len(args) == 6 and len(args[0]) == ctg and len(args[0][0]) == pos
    assert args[0][0][0].shape == (2, 32, 128) and args[2][0][0].shape == (2, 32, 8)
    assert len(args[4][0]) == 1  # mask and seeds live on the row's first device
    got = fn(*args)
    # same computation, unsharded — must be bit-identical (integer reductions)
    _assert_phase_equal(got, _unsharded(example))
    _assert_phase_equal(got, jax.jit(jax_phase_contigs_batch)(*example))


@pytest.mark.parametrize("n_devices", [8, 2])
def test_phase_shard_production_shapes_bit_identical(n_devices):
    """Sharded == unsharded at production-like shapes (512 reads, 256 SNP
    columns, 2048-position pileup blocks), not just toy sizes."""
    mesh = make_mesh(["cpu"] * n_devices)
    example = make_phase_example(C=2 * mesh.shape[0], **PRODUCTION)
    fn, args = phase_shard_step(mesh, example)
    _assert_phase_equal(fn(*args), _unsharded(example))


def test_phase_shard_step_refuses_an_uneven_split():
    mesh = make_mesh(["cpu"] * 8)
    with pytest.raises(ValueError):
        phase_shard_step(mesh, make_phase_example(C=3, Rr=16, Pp=64, S=8, K=2))
    with pytest.raises(ValueError):
        phase_shard_step(mesh, make_phase_example(C=2, Rr=16, Pp=66, S=8, K=2))


@pytest.mark.parametrize("n_devices", [8, 2, 1])
def test_column_stats_shard_matches_host(n_devices):
    """Stage-3's window column stats under the mesh: bit-identical to the
    host numpy twin at production shapes."""
    mesh = make_mesh(["cpu"] * n_devices)
    ctg, pos = mesh.shape
    pileup = make_phase_example(C=2 * ctg, Rr=512, Pp=max(256 * pos, 2048), S=64, K=2)[0]
    fn, args = column_stats_shard_step(mesh, pileup)
    tc, tn, cov = (x.numpy() for x in fn(*args))
    assert tc.shape == tn.shape == (2 * ctg, pileup.shape[2], 3) and cov.shape == (2 * ctg, pileup.shape[2])
    for c in range(pileup.shape[0]):
        htc, htn, hcov = column_stats_host(pileup[c])
        np.testing.assert_array_equal(tc[c], htc)
        np.testing.assert_array_equal(tn[c], htn)
        np.testing.assert_array_equal(cov[c], hcov)


@pytest.mark.parametrize("n_devices", [8, 2, 1])
def test_map_shard_step_bit_identical(n_devices):
    """The fused mapping call (DP + readout + traceback) split over every
    device equals the one-device call bit for bit, and the JAX package's
    sharded call on the same example."""
    mesh = make_mesh(["cpu"] * n_devices)
    n_per = 64 // n_devices
    fn, args = map_shard_step(mesh, n_per_device=n_per)
    assert all(len(a) == n_devices and a[0].shape[0] == n_per for a in args)
    out = fn(*args)
    assert out.dtype == torch.uint8 and out.shape == (64, 16 + 64)
    spec = BandSpec(chunk=64, band=32)
    whole = [torch.from_numpy(a) for a in make_map_example(64, spec)]
    assert torch.equal(out, align_traceback_rows(*whole, spec, "jnp"))
    jfn, jargs = jax_mesh.map_shard_step(jax_mesh.make_mesh(8), n_per_device=8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jfn(*jargs)))


@pytest.mark.parametrize("kernel", ["myers", "pallas"])
def test_map_shard_step_main_path_spec_equals_one_call(kernel):
    """With the default `BandSpec()` and K1's or K2's kernel name (on the
    CPU: the plain versions of the fused kernels), as the card runs it."""
    spec = BandSpec()
    fn, args = map_shard_step(make_mesh(["cpu"] * 2), n_per_device=4, spec=spec, kernel=kernel)
    whole = [torch.from_numpy(a) for a in make_map_example(8, spec)]
    assert torch.equal(fn(*args), align_traceback_rows(*whole, spec, kernel))

"""Parity of the port's NN polisher (`hairsplitter_tpu_torch/models/
polisher.py`, `-p medaka`) with the JAX package's flax model.

Inputs are made from a seed with numpy and go through both packages (the JAX
side on its CPU backend, the port with `device="cpu"`). This is the one
module of the port that is float arithmetic through two different
convolution implementations, so it is the one with a tolerance:
  * logits: atol 1e-4, rtol 1e-4;
  * predicted bases: equal wherever the two best logits differ by more than
    1e-3 (the number of positions under that margin is printed);
  * one Adam step from the same parameters on the same batch: loss and every
    parameter within 1e-5.
The host functions (`pileup_features`, `_simulate_training_batch`), the
weight conversion and the weights file are compared exactly. The port's
training draws its own initial weights, so it is held to the assertions of
`tests/test_nn_polisher.py`, not to the JAX package's trained weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hairsplitter_tpu.models import polisher as JP
from hairsplitter_tpu_torch.models import polisher as TP
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = RTOL = 1e-4
MARGIN = 1e-3
STEP_TOL = 1e-5


def _pileup(seed: int, L: int):
    """Seeded (counts [L, 5], ins_rate [L], backbone [L]) like a noisy group pileup."""
    rng = np.random.default_rng(seed)
    feats, _ = TP._simulate_training_batch(rng, L=L, cov_lo=4, cov_hi=20, err=0.12, div=0.02)
    cov = int(rng.integers(4, 20))
    counts = np.round(feats[:, :5] * cov).astype(np.int32)
    return counts, feats[:, 6].astype(np.float64), feats[:, 7:].argmax(axis=1).astype(np.int8)


def _top_two_margin(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=1)
    return top[:, -1] - top[:, -2]


@pytest.fixture(scope="module")
def shipped():
    ref = JP.load_weights()
    got = TP.load_weights(device="cpu")
    assert ref is not None and got is not None
    return ref, got


@pytest.mark.parametrize("L", [256, 300, 2048])
def test_logits_and_bases_equal_jax(shipped, L):
    """Shipped weights through `params_from_jax`: logits within the tolerance;
    `polish_counts` (which pads 300 to 512) equal above the margin."""
    ref, got = shipped
    counts, ins_rate, backbone = _pileup(L, L)
    feats = TP.pileup_features(counts, ins_rate, backbone)
    ref_logits, got_logits = ref.logits(feats), got.logits(feats)
    assert got_logits.shape == ref_logits.shape == (L, 5) and got_logits.dtype == np.float32
    np.testing.assert_allclose(got_logits, ref_logits, atol=ATOL, rtol=RTOL)
    ref_bases = ref.polish_counts(counts, ins_rate, backbone)
    got_bases = got.polish_counts(counts, ins_rate, backbone)
    assert got_bases.dtype == ref_bases.dtype == np.int8 and got_bases.shape == (L,)
    # the margin of the padded call, which is what polish_counts takes its argmax of
    Lb = TP.pow2_bucket(L, minimum=256)
    padded = TP.pileup_features(
        TP.pad_axis(counts, 0, Lb, 0), TP.pad_axis(ins_rate, 0, Lb, 0.0), TP.pad_axis(backbone, 0, Lb, 0))
    clear = _top_two_margin(ref.logits(padded))[:L] > MARGIN
    print(f"L={L}: {int((~clear).sum())} of {L} positions under the top-two margin {MARGIN}; "
          f"max |logit difference| {float(np.abs(got_logits - ref_logits).max()):.2e}")
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got_bases[clear], ref_bases[clear])


def test_polish_counts_keeps_the_padding():
    """The last positions of a length that is no power of two see the padded
    positions' features (backbone code 0 -> one-hot 'A'): the logits of the
    padded call differ there from those of the unpadded call, in both
    packages alike, so the padding is part of the function."""
    got = TP.load_weights(device="cpu")
    counts, ins_rate, backbone = _pileup(7, 300)
    unpadded = got.logits(TP.pileup_features(counts, ins_rate, backbone))
    padded = got.logits(TP.pileup_features(
        TP.pad_axis(counts, 0, 512, 0), TP.pad_axis(ins_rate, 0, 512, 0.0), TP.pad_axis(backbone, 0, 512, 0)))[:300]
    reach = 4 + 4 + 2  # the three convolutions' half widths
    np.testing.assert_allclose(padded[: 300 - reach], unpadded[: 300 - reach], atol=1e-5)
    assert np.abs(padded[300 - reach:] - unpadded[300 - reach:]).max() > 1e-3


def test_parameter_conversion_round_trips_exactly(tmp_path):
    """`params_to_jax(params_from_jax(x)) == x`, and a file written by the
    port's `save_weights` loads in the JAX package with the same leaves."""
    data = np.load(JP.WEIGHTS_PATH)
    flat = {k: data[k] for k in data.files}
    state = TP.params_from_jax(flat)
    assert state["Conv_0.weight"].shape == (48, 12, 9) and state["Dense_0.weight"].shape == (5, 48)
    back = TP.params_to_jax(state)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype and back[k].shape == flat[k].shape
        np.testing.assert_array_equal(back[k], flat[k])
    path = str(tmp_path / "w.npz")
    TP.save_weights(TP.load_weights(device="cpu"), path)
    loaded = JP.load_weights(path)
    assert loaded is not None
    leaves, _ = jax.tree_util.tree_flatten_with_path(loaded.params)
    assert len(leaves) == len(flat)
    for k, v in leaves:
        np.testing.assert_array_equal(np.asarray(v), flat[jax.tree_util.keystr(k)])
    # and the other way: the JAX package's file loads in the port
    assert TP.load_weights(JP.WEIGHTS_PATH, device="cpu") is not None
    assert TP.load_weights(str(tmp_path / "absent.npz"), device="cpu") is None


def test_shipped_weights_file_is_the_jax_packages():
    with open(JP.WEIGHTS_PATH, "rb") as f1, open(TP.WEIGHTS_PATH, "rb") as f2:
        assert f1.read() == f2.read()
    assert os.path.dirname(TP.WEIGHTS_PATH).endswith(os.path.join("hairsplitter_tpu_torch", "models"))
    assert TP.default_polisher("cpu") is TP.default_polisher(torch.device("cpu"))


def test_one_adam_step_equals_jax(shipped):
    """The backward pass and the optimizer: one step from the shipped
    parameters on one seeded batch, with a weight mask that has zeros."""
    ref, _ = shipped
    rng = np.random.default_rng(11)
    xs, ys = zip(*(TP._simulate_training_batch(rng, L=256) for _ in range(4)))
    x, y = np.stack(xs), np.stack(ys)
    w = (rng.random(y.shape) < 0.8).astype(np.float32)

    tx = optax.adam(1e-3)
    opt_state = tx.init(ref.params)

    def loss_fn(p):
        ce = optax.softmax_cross_entropy_with_integer_labels(ref.model.apply(p, jnp.asarray(x)), jnp.asarray(y))
        return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

    ref_loss, grads = jax.value_and_grad(loss_fn)(ref.params)
    updates, _ = tx.update(grads, opt_state)
    stepped = optax.apply_updates(ref.params, updates)
    ref_flat = {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(stepped)[0]}

    model = TP.PolisherCNN()
    data = np.load(TP.WEIGHTS_PATH)
    model.load_state_dict(TP.params_from_jax({k: data[k] for k in data.files}))
    before = TP.params_to_jax(model.state_dict())
    opt = TP.make_optimizer(model, 1e-3)
    got_loss = TP.train_step(model, opt, *(torch.from_numpy(a) for a in (x, y, w)))
    got_flat = TP.params_to_jax(model.state_dict())

    assert abs(float(got_loss) - float(ref_loss)) < STEP_TOL
    for k, v in ref_flat.items():
        np.testing.assert_allclose(got_flat[k], v, atol=STEP_TOL, rtol=0, err_msg=k)
        assert np.abs(got_flat[k] - before[k]).max() > 1e-4, k  # the step moved it


def test_host_functions_equal_jax_exactly():
    """`pileup_features` and `_simulate_training_batch` are numpy on both sides."""
    for kw in (dict(L=256), dict(L=512, cov_lo=3, cov_hi=6, err=0.2, div=0.05)):
        ref = JP._simulate_training_batch(np.random.default_rng(3), **kw)
        got = TP._simulate_training_batch(np.random.default_rng(3), **kw)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    counts, ins_rate, backbone = _pileup(5, 300)
    ref = JP.pileup_features(counts, ins_rate, backbone)
    got = TP.pileup_features(counts, ins_rate, backbone)
    assert ref.dtype == got.dtype == np.float32 and got.shape == (300, TP.N_FEATURES)
    np.testing.assert_array_equal(got, ref)


def test_realistic_training_pair_equals_jax_exactly():
    """The production-path training pair (mapper, pileup, both simulators)."""
    for hp_bias in (False, True):
        ref = JP._realistic_training_pair(np.random.default_rng(2), L=1024, hp_bias=hp_bias)
        got = TP._realistic_training_pair(np.random.default_rng(2), L=1024, hp_bias=hp_bias, device="cpu")
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert ref[2].mean() > 0.9  # the reads cover the backbone


def test_initial_weights_are_lecun_normal():
    model = TP.PolisherCNN()
    TP.init_params(model, torch.Generator().manual_seed(0))
    for layer, fan_in in (("Conv_0", 12 * 9), ("Conv_1", 48 * 9), ("Conv_2", 48 * 5), ("Dense_0", 48)):
        mod = getattr(model, layer)
        w = mod.weight.detach().numpy()
        assert not mod.bias.detach().numpy().any()
        std = np.sqrt(1.0 / fan_in)
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6  # truncated at two sigma
        if w.size > 2000:
            assert abs(w.std() / std - 1) < 0.05 and abs(w.mean()) < 0.1 * std
    again = TP.PolisherCNN()
    TP.init_params(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))


def test_trained_polisher_beats_majority():
    """tests/test_nn_polisher.py:test_nn_polisher_beats_majority on the port."""
    nn = TP.train_polisher(seed=0, steps=200, batch=8, L=256, device="cpu")
    np_rng = np.random.default_rng(42)
    n_maj = n_nn = n_tot = 0
    for _ in range(15):
        feats, labels = TP._simulate_training_batch(np_rng, L=256, cov_lo=3, cov_hi=6, err=0.2, div=0.01)
        n_maj += int((feats[:, :5].argmax(axis=1) == labels).sum())
        n_nn += int((nn.logits(feats).argmax(axis=1) == labels).sum())
        n_tot += labels.size
    print(f"low coverage: NN {n_nn / n_tot:.4f}, majority {n_maj / n_tot:.4f}")
    assert n_nn / n_tot > n_maj / n_tot, (n_nn / n_tot, n_maj / n_tot)
    assert n_nn / n_tot > 0.95, n_nn / n_tot


@pytest.mark.parametrize("seed", [2, 3])
def test_trained_polisher_corrects_backbone_divergence(seed):
    """tests/test_nn_polisher.py:test_nn_polisher_corrects_backbone_divergence
    on the port: at diverged positions the net follows the reads, not the
    backbone, more than 0.8 of the time. That test reads one batch with 15
    diverged positions, where one position is 0.07: after these 120 steps the
    JAX package's own seeds 0, 1 and 2 give 0.73, 0.93 and 0.73 there, and
    0.77, 0.91 and 0.83 over ten batches. The port's initial draw is its own,
    so it is read over ten batches (150 diverged positions)."""
    nn = TP.train_polisher(seed=seed, steps=120, batch=8, L=256, device="cpu")
    rng = np.random.default_rng(7)
    hit = total = 0
    for _ in range(10):
        feats, labels = TP._simulate_training_batch(rng, L=256, err=0.1, div=0.05)
        pred = nn.logits(feats).argmax(axis=1)
        diverged = feats[:, 7:].argmax(axis=1) != labels
        assert diverged.sum() > 3
        hit += int((pred[diverged] == labels[diverged]).sum())
        total += int(diverged.sum())
    assert hit / total > 0.8, (hit, total)


def test_realistic_training_runs_and_counts_calls():
    """`train_polisher(realistic=True)` at a tiny size, and the call counter."""
    nn = TP.train_polisher(seed=0, steps=3, batch=2, L=256, realistic=True, n_pairs=2, device="cpu")
    assert nn.calls == 0
    out = nn.logits(np.zeros((256, TP.N_FEATURES), np.float32))
    assert out.shape == (256, 5) and np.isfinite(out).all()
    assert nn.calls == 1 and nn.seconds > 0

"""Training of the port's NN polisher (`hairsplitter_tpu_torch/models/
polisher.py:train_polisher`) against the JAX package's optax training, and
the port's training script `scripts/torch_train_polisher.py`.

Tolerances: five Adam steps from the JAX package's own initial parameters
(carried across with `params_from_jax`) on the same five seeded batches:
every loss and every parameter within 1e-5 of optax's (float arithmetic
through two convolution implementations, as in tests/test_torch_polisher.py);
two trainings of the port with one seed: equal bit for bit; the weights file
the script writes: read by the JAX package's `load_weights`, logits within
1e-4 of the port's."""

import json
import os
import subprocess
import sys

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_train_polisher.py")
STEP_TOL = 1e-5
LOGIT_TOL = 1e-4
N_STEPS = 5


def _flat(params) -> dict[str, np.ndarray]:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _batches(seed: int, n: int, batch: int = 4, L: int = 256):
    """`n` seeded synthetic batches (x, y, w), the weight masks with zeros."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xs, ys = zip(*(TP._simulate_training_batch(rng, L=L) for _ in range(batch)))
        out.append((np.stack(xs), np.stack(ys), (rng.random((batch, L)) < 0.8).astype(np.float32)))
    return out


def test_adam_steps_equal_jax():
    """`train_step` + `make_optimizer` against the JAX package's step
    (`value_and_grad` of the masked cross-entropy, `optax.adam`) over five
    steps from the flax initial parameters of seed 0."""
    batches = _batches(11, N_STEPS)
    model_j = JP.PolisherCNN()
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, JP.N_FEATURES)))
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, x, y, w):
        def loss_fn(p):
            ce = optax.softmax_cross_entropy_with_integer_labels(model_j.apply(p, x), y)
            return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    model = TP.PolisherCNN()
    model.load_state_dict(TP.params_from_jax(_flat(params)))
    opt = TP.make_optimizer(model, 1e-3)
    start = _flat(params)
    for k, (x, y, w) in enumerate(batches):
        params, opt_state, ref_loss = step(params, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
        with TP.deterministic_convolutions():
            got_loss = TP.train_step(model, opt, *(torch.from_numpy(a) for a in (x, y, w)))
        assert abs(float(got_loss) - float(ref_loss)) < STEP_TOL, (k, float(got_loss), float(ref_loss))
        got = TP.params_to_jax(model.state_dict())
        for name, v in _flat(params).items():
            np.testing.assert_allclose(got[name], v, atol=STEP_TOL, rtol=0, err_msg=f"step {k}: {name}")
    for name, v in start.items():  # the five steps moved every leaf
        assert np.abs(got[name] - v).max() > 1e-3, name


@pytest.mark.parametrize("realistic", [False, True], ids=["synthetic", "realistic"])
def test_two_runs_with_one_seed_are_equal(realistic):
    kw = dict(steps=3, batch=2, L=256, realistic=True, n_pairs=2) if realistic else dict(steps=10, batch=4, L=256)
    runs = [TP.train_polisher(seed=5, device="cpu", **kw).model.state_dict() for _ in range(2)]
    init = TP.PolisherCNN()
    TP.init_params(init, torch.Generator().manual_seed(5))
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
        assert not torch.equal(runs[0][k], init.state_dict()[k]), k  # the steps moved it


def test_training_scope_sets_and_restores_only_its_flags():
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, cudnn.enabled)
    assert not cudnn.allow_tf32  # the package switched TF32 off
    with TP.deterministic_convolutions():
        assert cudnn.deterministic and not cudnn.benchmark and not cudnn.allow_tf32
    assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, cudnn.enabled) == before
    timings = {}
    TP.train_polisher(seed=0, steps=2, batch=2, L=256, device="cpu", timings=timings)
    assert timings["steps"] == 2 and timings["train_seconds"] > 0 and timings["corpus_seconds"] >= 0
    assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, cudnn.enabled) == before


def _run_script(*argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, SCRIPT, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def test_script_writes_weights_the_jax_package_reads(tmp_path):
    out = str(tmp_path / "w.npz")
    proc = _run_script("--device", "cpu", "--steps", "3", "--pairs", "2", "--out", out)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["steps"] == 3 and res["pairs"] == 2 and res["out"] == out and res["device"] == "cpu"
    assert 0 < res["held_out_majority"] <= 1 and 0 < res["held_out_accuracy"] <= 1
    assert res["corpus_k1_launches"] == 0  # no CUDA kernel on the CPU
    assert "held-out column accuracy: nn" in proc.stdout
    ref = JP.load_weights(out)
    got = TP.load_weights(out, device="cpu")
    assert ref is not None and got is not None
    feats, _ = TP._simulate_training_batch(np.random.default_rng(9), L=512)
    np.testing.assert_allclose(got.logits(feats), ref.logits(feats), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    shipped = TP.load_weights(device="cpu")
    assert np.abs(got.logits(feats) - shipped.logits(feats)).max() > 1e-3  # its own weights, not the shipped ones


@pytest.mark.parametrize("which", ["port", "jax"])
def test_script_refuses_the_shipped_weights(tmp_path, which):
    path = TP.WEIGHTS_PATH if which == "port" else JP.WEIGHTS_PATH
    with open(path, "rb") as f:
        before = f.read()
    mtime = os.stat(path).st_mtime_ns
    proc = _run_script("--device", "cpu", "--steps", "1", "--pairs", "1", "--out", path)
    assert proc.returncode == 2 and "shipped weights file" in proc.stderr, proc.stderr[-2000:]
    with open(path, "rb") as f:
        assert f.read() == before
    assert os.stat(path).st_mtime_ns == mtime
    # a path that only leads to the shipped file is refused too
    link = tmp_path / "w.npz"
    link.symlink_to(path)
    proc = _run_script("--device", "cpu", "--steps", "1", "--pairs", "1", "--out", str(link))
    assert proc.returncode == 2
    with open(path, "rb") as f:
        assert f.read() == before


def test_script_needs_its_out_and_a_card_unless_told_cpu(tmp_path):
    proc = _run_script("--device", "cpu")
    assert proc.returncode == 2 and "--out" in proc.stderr
    if not torch.cuda.is_available():
        proc = _run_script("--out", str(tmp_path / "w.npz"))
        assert proc.returncode == 2 and "no CUDA device" in proc.stderr
        assert not (tmp_path / "w.npz").exists()

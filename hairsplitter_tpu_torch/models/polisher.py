"""Neural consensus polisher (the medaka-equivalent) in PyTorch.

Counterpart of `hairsplitter_tpu/models/polisher.py`: the same small 1-D CNN
over pileup count features, the same features, training data and inference
padding. The flax modules become `torch.nn.Conv1d` / `nn.Linear`, optax's
Adam becomes `torch.optim.Adam`; `params_from_jax` / `params_to_jax` carry
the weights between the two layouts, and the weights file keeps the flax
layout, so either package loads the other's file. The shipped pretrained
weights are this package's own copy (`models/polisher_weights.npz`).

Features per contig position (from the same pileup tensors as stage 3):
    counts of A/C/G/T/- among covering reads (normalized), coverage,
    insertion-event rate, one-hot of the backbone base.
Labels: the true base at that position (A/C/G/T or deletion).

This is float arithmetic: logits agree with the JAX package's to about 1e-5
on a CPU (the tests hold them to 1e-4), not bit for bit, so a predicted base
can differ where the two best logits lie closer than that. On a GPU the
convolutions run in full float32 (the package switches TF32 off).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..constants import decode_seq, encode_seq
from ..core.mapping import map_reads
from ..pipeline.pileup import alignment_cells_full, orient_read
from ..utils import sim2
from ..utils.shapes import pad_axis, pow2_bucket
from ..utils.sim import simulate_reads

N_CLASSES = 5  # A C G T -
N_FEATURES = 12  # 5 counts + coverage + ins rate + 5 backbone one-hot

# flax module names of the JAX package's PolisherCNN, in call order, with the
# kernel size of each convolution (None: the dense layer)
LAYERS = (("Conv_0", 9), ("Conv_1", 9), ("Conv_2", 5), ("Dense_0", None))


class PolisherCNN(nn.Module):
    """1-D CNN over positions: [B, L, F] -> [B, L, 5] base logits. The
    submodules carry the flax names, so a state dict reads like the JAX
    package's parameter tree."""

    def __init__(self, width: int = 48):
        super().__init__()
        self.Conv_0 = nn.Conv1d(N_FEATURES, width, 9, padding="same")
        self.Conv_1 = nn.Conv1d(width, width, 9, padding="same")
        self.Conv_2 = nn.Conv1d(width, width, 5, padding="same")
        self.Dense_0 = nn.Linear(width, N_CLASSES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)  # Conv1d wants [B, C, L]
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = torch.relu(self.Conv_2(x))
        return self.Dense_0(x.transpose(1, 2))


def _flax_key(layer: str, leaf: str) -> str:
    return f"['params']['{layer}']['{leaf}']"


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """State dict of `PolisherCNN` from the JAX package's flat parameters
    (the weights file's own keys, `['params']['Conv_0']['kernel']` ...).
    flax conv kernels are [k, in, out] and become [out, in, k]; the dense
    kernel [in, out] becomes [out, in]. Both convolutions are
    cross-correlations, so no tap is flipped."""
    state = {}
    for layer, ksize in LAYERS:
        kernel = np.asarray(flat[_flax_key(layer, "kernel")])
        axes = (2, 1, 0) if ksize is not None else (1, 0)
        state[f"{layer}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(axes)))
        state[f"{layer}.bias"] = torch.from_numpy(np.array(flat[_flax_key(layer, "bias")]))
    return state


def params_to_jax(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of `params_from_jax`."""
    flat = {}
    for layer, ksize in LAYERS:
        weight = state[f"{layer}.weight"].detach().cpu().numpy()
        axes = (2, 1, 0) if ksize is not None else (1, 0)
        flat[_flax_key(layer, "bias")] = state[f"{layer}.bias"].detach().cpu().numpy().copy()
        flat[_flax_key(layer, "kernel")] = np.ascontiguousarray(weight.transpose(axes))
    return flat


def init_params(model: PolisherCNN, generator: torch.Generator) -> None:
    """Initial weights as flax draws them: lecun-normal kernels (a normal
    truncated at two standard deviations, variance 1 / fan_in) and zero
    biases. The draw is this generator's own, not the JAX key's."""
    lo, hi = (0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (-2.0, 2.0))
    # standard deviation of the unit normal truncated at +-2
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for layer, _ in LAYERS:
            mod = getattr(model, layer)
            fan_in = mod.weight[0].numel()
            u = torch.rand(mod.weight.shape, generator=generator, dtype=torch.float64)
            draw = math.sqrt(2.0) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
            mod.weight.copy_(draw * (math.sqrt(1.0 / fan_in) / trunc_std))
            mod.bias.zero_()


def pileup_features(counts: np.ndarray, ins_rate: np.ndarray, backbone: np.ndarray) -> np.ndarray:
    """Per-position feature vectors. counts: [L, 5] base counts,
    ins_rate: [L], backbone: [L] base codes."""
    cov = counts.sum(axis=1, keepdims=True)
    norm = counts / np.maximum(cov, 1)
    onehot = np.eye(5, dtype=np.float32)[np.clip(backbone, 0, 4)]
    feats = np.concatenate(
        [
            norm.astype(np.float32),
            (cov / 50.0).astype(np.float32),
            ins_rate[:, None].astype(np.float32),
            onehot,
        ],
        axis=1,
    )
    return feats


def _simulate_training_batch(rng, L=512, cov_lo=3, cov_hi=25, err=0.1, div=0.01):
    """(features [L, F], labels [L]) from one synthetic backbone/truth pair."""
    truth = rng.integers(0, 4, L).astype(np.int8)
    backbone = truth.copy()
    # backbone diverges from the truth by substitutions
    nmut = max(1, int(L * div))
    mut = rng.choice(L, nmut, replace=False)
    backbone[mut] = (backbone[mut] + rng.integers(1, 4, nmut)) % 4
    # truth also contains deletions relative to the backbone: mark label '-'
    ndel = max(1, int(L * div * 0.3))
    dels = rng.choice(L, ndel, replace=False)
    labels = truth.astype(np.int64)
    labels[dels] = 4
    cov = int(rng.integers(cov_lo, cov_hi))
    counts = np.zeros((L, 5), dtype=np.float32)
    ins_rate = np.zeros(L, dtype=np.float32)
    for _ in range(cov):
        read = labels.copy()  # reads carry the truth (incl. deletions)
        e = rng.random(L) < err
        sub = e & (rng.random(L) < 0.5)
        read[sub] = (read[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        gap = e & ~sub
        read[gap] = 4
        present = rng.random(L) < 0.97
        for b in range(5):
            counts[:, b] += (read == b) & present
        ins_rate += (rng.random(L) < err * 0.2) & present
    ins_rate /= max(1, cov)
    feats = pileup_features(counts, ins_rate, backbone)
    return feats, labels


@dataclass
class NNPolisher:
    """A `PolisherCNN` on its device. `calls` and `seconds` count the
    `logits` calls and their wall time (upload, forward pass, download);
    `slowest` is the longest single call (on a GPU the first, which starts
    cuDNN)."""

    model: PolisherCNN
    device: torch.device
    calls: int = 0
    seconds: float = 0.0
    slowest: float = 0.0

    def logits(self, feats: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(feats, dtype=np.float32)).to(self.device)
            out = self.model(x[None])[0].cpu().numpy()
        took = time.perf_counter() - t0
        self.calls += 1
        self.seconds += took
        self.slowest = max(self.slowest, took)
        return out

    def polish_counts(self, counts: np.ndarray, ins_rate: np.ndarray, backbone: np.ndarray) -> np.ndarray:
        """Predicted base codes per position (4 = deletion)."""
        L = counts.shape[0]
        # The length is padded to a power of two BEFORE the features are made,
        # as in the JAX package (there a compile bucket). It is kept because
        # it is part of the function: a padded position has backbone code 0,
        # so its one-hot says 'A', and the convolutions reach 4 + 4 + 2 = 10
        # positions, so the last 10 real positions see those features.
        Lb = pow2_bucket(L, minimum=256)
        feats = pileup_features(
            pad_axis(counts, 0, Lb, 0),
            pad_axis(ins_rate, 0, Lb, 0.0),
            pad_axis(backbone, 0, Lb, 0),
        )
        return self.logits(feats).argmax(axis=1).astype(np.int8)[:L]


def _realistic_training_pair(rng, L=2048, err=0.14, div=0.01, cov_lo=4, cov_hi=22,
                             hp_bias=False, *, device):
    """(features [L, F], labels [L], weights [L]) through the production
    alignment + pileup path: a truth genome, a diverged backbone with known
    per-position labels (substitutions -> truth base, backbone-only
    insertions -> '-'), and indel-rich simulated reads mapped with the real
    mapper on `device`, so the net trains on the feature distribution it
    polishes at inference (incl. the mapper's indel fragmenting), not on
    idealized substitution-only pileups."""
    truth = rng.integers(0, 4, L).astype(np.int8)
    # backbone: walk the truth, substituting / inserting / skipping
    bb: list[int] = []
    labels: list[int] = []
    i = 0
    while i < L:
        r = rng.random()
        if r < div * 0.5:  # substitution: reads should restore the truth
            bb.append(int((truth[i] + rng.integers(1, 4)) % 4))
            labels.append(int(truth[i]))
            i += 1
        elif r < div * 0.75:  # backbone-only base: reads vote deletion
            bb.append(int(rng.integers(0, 4)))
            labels.append(4)
        elif r < div:  # truth base the backbone lost (insertion recovery's
            i += 1  # job, not the per-column caller's)
        else:
            bb.append(int(truth[i]))
            labels.append(int(truth[i]))
            i += 1
    backbone = np.asarray(bb, np.int8)
    labels_arr = np.asarray(labels, np.int64)
    Lb = len(backbone)

    cov = int(rng.integers(cov_lo, cov_hi))
    if hp_bias:
        # hp-run-length-biased reads (utils/sim2): teaches the net the
        # systematic undercall majority consensus cannot fix (run detection
        # needs the conv context)
        cfg2 = sim2.Sim2Config(
            mean_len=min(L, 1500), min_len=300, base_error=err * 0.8,
            hp_undercall=0.10, junk_rate=0.0,
        )
        s2 = sim2.generate(
            [decode_seq(truth)], coverage=cov, cfg=cfg2,
            seed=int(rng.integers(1 << 30)),
        )
        read_seqs = s2.seqs
    else:
        sim = simulate_reads(
            [decode_seq(truth)], coverage=cov, read_len=min(L, 1500),
            rng=rng, sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
        )
        read_seqs = sim.seqs
    alns = map_reads({"b": decode_seq(backbone)}, read_seqs, device=device)
    counts = np.zeros((Lb, 5), np.int32)
    cover = np.zeros(Lb, np.int32)
    ins_events = np.zeros(Lb, np.int32)
    for a in alns:
        oriented = orient_read(encode_seq(read_seqs[a.read_idx]), a.strand)
        tpos, tri, it, _ic = alignment_cells_full(a, oriented)
        cents = (np.asarray(tri, np.int16) // 25).astype(np.int8)
        counts[tpos, cents] += 1
        cover[tpos] += 1
        if it.size:
            np.add.at(ins_events, np.unique(it), 1)
    ins_rate = ins_events / np.maximum(cover, 1)
    feats = pileup_features(counts, ins_rate, backbone)
    weights = (cover > 0).astype(np.float32)  # uncovered columns keep the
    return feats, labels_arr, weights  # backbone in production: no signal


def masked_cross_entropy(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean over the weighted positions of the softmax cross-entropy."""
    ce = nn.functional.cross_entropy(logits.reshape(-1, N_CLASSES), y.reshape(-1), reduction="none")
    return (ce * w.reshape(-1)).sum() / torch.clamp(w.sum(), min=1.0)


def train_step(model: PolisherCNN, opt: torch.optim.Optimizer, x, y, w) -> torch.Tensor:
    """One optimizer step on the masked cross-entropy; returns the loss
    before the step."""
    opt.zero_grad(set_to_none=True)
    loss = masked_cross_entropy(model(x), y, w)
    loss.backward()
    opt.step()
    return loss.detach()


def make_optimizer(model: PolisherCNN, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, no decay)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_polisher(
    seed: int = 0,
    steps: int = 300,
    batch: int = 8,
    L: int = 512,
    lr: float = 1e-3,
    realistic: bool = False,
    n_pairs: int = 48,
    *,
    device,
) -> NNPolisher:
    """Train the polisher on `device`. realistic=True draws (feature, label)
    pairs from the production alignment+pileup path on indel-rich simulated
    reads (the shipped default weights are trained this way);
    realistic=False keeps the fast synthetic generator for unit tests. The
    data comes from numpy's `default_rng(seed)` exactly as in the JAX
    package; the initial weights from a `torch.Generator` seeded the same."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    model = PolisherCNN()
    init_params(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt = make_optimizer(model, lr)

    def step(x, y, w):
        return train_step(model, opt, *(torch.from_numpy(a).to(device) for a in (x, y, w)))

    if realistic:
        # generate the corpus once (mapping-heavy), then shuffle mini-batches
        pool_x, pool_y, pool_w = [], [], []
        for i in range(n_pairs):
            # 50/50 i.i.d.-error and hp-biased (sim2) pairs so the net
            # handles both regimes
            # hp pairs carry EXTRA backbone substitutions: hp-heavy
            # training otherwise teaches blanket backbone trust, and the
            # net stops correcting true SNP columns on diverged drafts
            f, l, w = _realistic_training_pair(
                rng, L=max(L, 1024), hp_bias=i % 2 == 1,
                div=0.025 if i % 2 == 1 else 0.01, device=device,
            )
            for lo in range(0, len(l) - L + 1, L):
                pool_x.append(f[lo : lo + L])
                pool_y.append(l[lo : lo + L])
                pool_w.append(w[lo : lo + L])
        pool_x = np.stack(pool_x)
        pool_y = np.stack(pool_y)
        pool_w = np.stack(pool_w)
        for it in range(steps):
            sel = rng.integers(0, len(pool_x), batch)
            step(pool_x[sel], pool_y[sel], pool_w[sel])
    else:
        ones = np.ones((batch, L), np.float32)
        for it in range(steps):
            xs, ys = [], []
            for _ in range(batch):
                f, l = _simulate_training_batch(rng, L=L)
                xs.append(f)
                ys.append(l)
            step(np.stack(xs), np.stack(ys), ones)
    model.eval()
    return NNPolisher(model=model, device=device)


WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "polisher_weights.npz")


def save_weights(p: NNPolisher, path: str = WEIGHTS_PATH) -> None:
    """Persist trained parameters in the flax layout (flat {path: array}
    npz), the layout of the JAX package's file."""
    np.savez(path, **params_to_jax(p.model.state_dict()))


def load_weights(path: str = WEIGHTS_PATH, *, device) -> NNPolisher | None:
    """Load persisted parameters onto `device`; None if the file is
    absent/incompatible."""
    if not os.path.exists(path):
        return None
    model = PolisherCNN()
    data = np.load(path)
    try:
        state = params_from_jax({k: data[k] for k in data.files})
    except KeyError:
        return None
    want = model.state_dict()
    if any(state[k].shape != want[k].shape for k in want):
        return None
    model.load_state_dict(state)
    device = torch.device(device)
    return NNPolisher(model=model.to(device).eval(), device=device)


_DEFAULT: dict[torch.device, NNPolisher] = {}


def default_polisher(device) -> NNPolisher:
    """Process-wide polisher of `device`: loads the shipped pretrained
    weights (trained on realistic indel-rich pileups via `train_polisher(
    realistic=True)`, persisted with `save_weights`: the analogue of
    medaka's downloadable models); falls back to a quick synthetic training
    run only if the weight file is missing."""
    device = torch.device(device)
    if device not in _DEFAULT:
        _DEFAULT[device] = load_weights(device=device) or train_polisher(seed=0, device=device)
    return _DEFAULT[device]

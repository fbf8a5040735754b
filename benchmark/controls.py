"""Controls and faults: the program with one of its guarantees broken
underneath, from the benchmark's side, so that the check can be shown to
fail. Each is a context manager that patches the port while it is open.

Controls, each breaking one guarantee that the configurations state (run
on the card at a cell's own size by `readings.py` and
`tests/test_benchmark_controls.py`):

- `half_reads_unmapped`: stage 2 returns the alignments of every other
  read only ("every read is mapped").
- `groups_split_at_random`: stage 4's clustered reads are put into one of
  two groups at random in every window ("reads are grouped by strain").
- `tf32`: TF32 matmuls (the program turns them off); its float32 matmuls
  multiply 0/1 indicators, so this is expected to change nothing.
- `chi2_bf16`: stage 3's Pearson chi² statistics, the one float path of
  the run (float32: `ops/variants.py:chi2_tables` on the device and its
  numpy twin `pipeline/call_variants.py:_chi2_tables` under 512 suspect
  columns), computed from the same contingency counts in bfloat16: the
  plain formula in the nearest precision below float32, in the program's
  place.

Faults, for the CPU test of the whole run (`tests/test_benchmark_faults.py`):

- `tokens_altered`: the fused mapping call's first traceback token of
  every chunk alignment flips its UP bit where the call produces it;
- `half_reads_unmapped` (as above: half of the batch left out);
- `nothing_separated`: stage 4 returns every read in one group (the step
  returns its input state unchanged).
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def half_reads_unmapped():
    from hairsplitter_tpu_torch.pipeline import orchestrate

    def make(orig):
        def map_reads(*args, **kwargs):
            return [a for a in orig(*args, **kwargs) if a.read_idx % 2 == 0]
        return map_reads
    return _patched(orchestrate, "map_reads", make)


def _relabel(labels_fn):
    from hairsplitter_tpu_torch.pipeline import orchestrate

    def make(orig):
        def separate_reads_for_contig(*args, **kwargs):
            groups = orig(*args, **kwargs)
            for w in groups.windows:
                clustered = w.labels >= 0
                w.labels = w.labels.copy()
                w.labels[clustered] = labels_fn(int(clustered.sum()), w.start)
            return groups
        return separate_reads_for_contig
    return _patched(orchestrate, "separate_reads_for_contig", make)


def groups_split_at_random():
    return _relabel(lambda n, start: np.random.default_rng(start).integers(0, 2, size=n))


def nothing_separated():
    return _relabel(lambda n, start: np.zeros(n, dtype=np.int64))


@contextlib.contextmanager
def tf32():
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _chi2_bf16(n00, n01, n10, n11):
    """Pearson chi² on 2x2 tables of counts, every step in bfloat16."""
    import torch

    b = [t.to(torch.bfloat16) for t in (n00, n01, n10, n11)]
    n = b[0] + b[1] + b[2] + b[3]
    p1 = (b[2] + b[3]) / torch.clamp(n, min=1.0)
    p2 = (b[1] + b[3]) / torch.clamp(n, min=1.0)
    chi = torch.zeros_like(n)
    for obs, e in zip(b, ((1 - p1) * (1 - p2) * n, (1 - p1) * p2 * n, p1 * (1 - p2) * n, p1 * p2 * n)):
        chi = chi + torch.where(e > 0, (obs - e) ** 2 / torch.clamp(e, min=1e-9), 0.0)
    degenerate = (p1 * (1 - p1) == 0) | (p2 * (1 - p2) == 0)
    return torch.where((n == 0) | degenerate, 0.0, chi).float()


@contextlib.contextmanager
def chi2_bf16():
    import torch

    from hairsplitter_tpu_torch.ops import variants
    from hairsplitter_tpu_torch.pipeline import call_variants

    def host(*tables):  # the numpy twin, for fewer than 512 suspect columns
        return _chi2_bf16(*(torch.from_numpy(np.asarray(t, dtype=np.float32)) for t in tables)).numpy()

    with _patched(variants, "chi2_tables", lambda orig: _chi2_bf16), \
            _patched(call_variants, "_chi2_tables", lambda orig: host):
        yield


def tokens_altered():
    from hairsplitter_tpu_torch.core import mapping

    def make(orig):
        def fused_call_host(arrays, spec, kernel, device):
            out = orig(arrays, spec, kernel, device).copy()
            out[:, 16] ^= 0x80
            return out
        return fused_call_host
    return _patched(mapping, "fused_call_host", make)


CONTROLS = {
    "half_reads_unmapped": half_reads_unmapped,
    "groups_split_at_random": groups_split_at_random,
    "tf32": tf32,
    "chi2_bf16": chi2_bf16,
}
FAULTS = {
    "tokens_altered": tokens_altered,
    "half_reads_unmapped": half_reads_unmapped,
    "nothing_separated": nothing_separated,
}


def applied(name: str | None):
    """The control or fault `name` as a context manager (none for None or "none")."""
    if name in (None, "none"):
        return contextlib.nullcontext()
    table = {**CONTROLS, **FAULTS}
    if name not in table:
        raise KeyError(f"no control or fault {name!r} (have: {', '.join(sorted(table))})")
    return table[name]()

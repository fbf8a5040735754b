"""A second, independent read simulator — evidence de-correlation.

Every quality number in this repo is scored on reads from `utils/sim.py`;
the same codebase generating and grading its own data is a validity risk
(round-4 verdict weak #1). This module shares NO code or error model with
`utils/sim.py`:

  * read lengths are log-normal (ONT library profile), not fixed;
  * each read draws its own quality level (reads vary read-to-read), and
    quality covaries with length (long reads skew noisier, as pore exit
    speed drifts);
  * errors arrive in BURSTS: a 2-state Markov chain (clean / noisy)
    switches along the read, so errors cluster instead of landing i.i.d.;
  * homopolymer runs are re-sampled as run LENGTHS: the output run length
    is drawn around the true length with variance growing with run length
    and a systematic undercall for long runs (the dominant ONT mode) —
    not per-base indel flips;
  * a fraction of reads are junk (random sequence) as real libraries have.

The sequence machinery (base drawing, reverse complement) is written here
from scratch on Python's `random`, not numpy, so not even the RNG stream
shape is shared.

Copy of `hairsplitter_tpu/utils/sim2.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

_ALPHABET = "ACGT"
_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _revcomp(s: str) -> str:
    return "".join(_COMPLEMENT.get(c, "N") for c in reversed(s))


@dataclass
class Sim2Config:
    mean_len: float = 8000.0
    len_sigma: float = 0.35  # log-normal shape
    min_len: int = 500
    base_error: float = 0.075  # median-read error; bursts + hp noise land
    # the realized pileup divergence near 0.10 (matched to the sim.py
    # scenarios' 10% so cross-simulator comparisons are apples-to-apples)
    quality_spread: float = 0.35  # per-read error multiplier spread (log-normal)
    length_quality_coupling: float = 0.25  # longer reads skew noisier
    burst_rate: float = 0.004  # per-base probability of entering a noisy burst
    burst_len: float = 60.0  # mean burst length (geometric)
    burst_multiplier: float = 4.0  # error rate inside a burst
    sub_frac: float = 0.45  # of non-hp errors: substitutions vs indels
    ins_frac: float = 0.5  # of indel errors: insertions vs deletions
    # systematic shortening per extra hp base; 0.06 keeps the PER-READ bias
    # real (runs of 8+ are majority-miscalled) without making majority
    # consensus provably wrong on every 5-run — beyond that the measurement
    # tests the simulator's parameter, not the pipeline
    hp_undercall: float = 0.06
    junk_rate: float = 0.005  # fraction of reads that are random sequence


@dataclass
class Sim2Reads:
    names: list[str] = field(default_factory=list)
    seqs: list[str] = field(default_factory=list)
    hap_of_read: list[int] = field(default_factory=list)


def _hp_runs(s: str):
    """Yield (base, run length) over the sequence."""
    i = 0
    n = len(s)
    while i < n:
        j = i + 1
        while j < n and s[j] == s[i]:
            j += 1
        yield s[i], j - i
        i = j


def _corrupt(fragment: str, err: float, cfg: Sim2Config, rng: random.Random) -> str:
    """Apply the burst + hp-resampling error process to one fragment."""
    out: list[str] = []
    in_burst = False
    p_exit = 1.0 / max(cfg.burst_len, 1.0)
    for base, run in _hp_runs(fragment):
        # hp run-length resampling: variance grows with run length, long
        # runs systematically undercalled
        if run >= 2:
            mu = run - cfg.hp_undercall * (run - 1) * (err / cfg.base_error)
            sd = 0.18 * math.sqrt(run) * (err / cfg.base_error)
            new_run = int(round(rng.gauss(mu, sd)))
            new_run = max(0, new_run)
        else:
            new_run = run
        for _ in range(new_run):
            # burst state machine advances per emitted base
            if in_burst:
                if rng.random() < p_exit:
                    in_burst = False
            elif rng.random() < cfg.burst_rate:
                in_burst = True
            local = err * (cfg.burst_multiplier if in_burst else 1.0)
            local = min(local, 0.5)
            r = rng.random()
            if r < local * cfg.sub_frac:
                # substitution to a different base
                out.append(rng.choice(_ALPHABET.replace(base, "")))
            elif r < local * (cfg.sub_frac + (1 - cfg.sub_frac) * cfg.ins_frac):
                out.append(base)
                out.append(rng.choice(_ALPHABET))
            elif r < local:
                pass  # deletion
            else:
                out.append(base)
    return "".join(out)


def generate(
    haplotypes: list[str],
    coverage: float,
    cfg: Sim2Config = Sim2Config(),
    seed: int = 0,
    abundances: list[float] | None = None,
) -> Sim2Reads:
    """Sample reads from the haplotypes under the independent error model."""
    rng = random.Random(seed)
    out = Sim2Reads()
    rid = 0
    for h, hap in enumerate(haplotypes):
        ab = abundances[h] if abundances else 1.0
        target_bp = coverage * ab * len(hap)
        emitted = 0
        while emitted < target_bp:
            if rng.random() < cfg.junk_rate:
                L = max(cfg.min_len, int(rng.lognormvariate(math.log(cfg.mean_len) - 0.5, cfg.len_sigma)))
                seq = "".join(rng.choice(_ALPHABET) for _ in range(min(L, 2000)))
                out.names.append(f"junk_{rid}")
                out.seqs.append(seq)
                out.hap_of_read.append(-1)
                rid += 1
                emitted += len(seq)
                continue
            L = max(
                cfg.min_len,
                int(rng.lognormvariate(math.log(cfg.mean_len) - cfg.len_sigma**2 / 2, cfg.len_sigma)),
            )
            # uniform-to-the-ends sampling: start may hang off either edge
            start = rng.randint(-(L - cfg.min_len), len(hap) - cfg.min_len)
            frag = hap[max(0, start) : max(0, start) + L + min(0, start)]
            if len(frag) < cfg.min_len:
                continue
            # per-read quality, coupled to length
            len_bias = cfg.length_quality_coupling * math.log(max(L, 1) / cfg.mean_len)
            err = cfg.base_error * math.exp(rng.gauss(len_bias, cfg.quality_spread))
            err = min(max(err, 0.005), 0.35)
            seq = _corrupt(frag, err, cfg, rng)
            if rng.random() < 0.5:
                seq = _revcomp(seq)
            out.names.append(f"sim2_{rid}_h{h}")
            out.seqs.append(seq)
            out.hap_of_read.append(h)
            rid += 1
            emitted += len(frag)
    return out


def write_fasta(path: str, reads: Sim2Reads) -> None:
    with open(path, "w") as f:
        for n, s in zip(reads.names, reads.seqs):
            f.write(f">{n}\n{s}\n")

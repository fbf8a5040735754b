"""Long-read / haplotype simulator for tests and benchmarks.

The reference ships no runnable test reads (`test/simple_mock/mock_reads.fasta`
is absent from the repo; README.md:68-70) — its GraphUnzip evaluation harness
sketches the approach we productize here: generate random haplotypes that
differ by SNPs, sample error-prone reads from them, and check phasing against
the known truth (`src/GraphUnzip/tests.py:384-438,477-527`).

Copy of `hairsplitter_tpu/utils/sim.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import decode_seq, encode_seq, revcomp

_BASES = "ACGT"


def random_genome(length: int, rng: np.random.Generator) -> str:
    return "".join(rng.choice(list(_BASES), size=length))


def mutate(seq: str, snp_rate: float, rng: np.random.Generator) -> tuple[str, list[int]]:
    """Introduce substitutions at ~snp_rate; returns (mutated, positions)."""
    codes = encode_seq(seq).copy()
    n = max(1, int(len(seq) * snp_rate))
    pos = np.sort(rng.choice(len(seq), size=n, replace=False))
    for p in pos:
        codes[p] = (codes[p] + rng.integers(1, 4)) % 4
    return decode_seq(codes), pos.tolist()


def make_haplotypes(
    length: int,
    n_haplotypes: int,
    divergence: float,
    rng: np.random.Generator,
) -> list[str]:
    """A shared backbone plus n haplotypes each mutated at ~divergence."""
    backbone = random_genome(length, rng)
    return [mutate(backbone, divergence, rng)[0] for _ in range(n_haplotypes)]


@dataclass
class SimReads:
    names: list[str]
    seqs: list[str]
    hap_of_read: list[int]  # truth labels
    starts: list[int]
    strands: list[int]


def simulate_reads(
    haplotypes: list[str],
    coverage: float,
    read_len: int,
    rng: np.random.Generator,
    sub_rate: float = 0.0,
    ins_rate: float = 0.0,
    del_rate: float = 0.0,
    len_sd: float = 0.0,
    circular: bool = False,
    abundances: list[float] | None = None,
    homopolymer_bias: float = 0.0,
    chimera_rate: float = 0.0,
    uniform_edges: bool = False,
) -> SimReads:
    """Sample reads from the haplotypes with a simple error model.

    abundances: per-haplotype relative abundance multipliers on `coverage`
    (the metagenome/strain-mix case `--rarest-strain-abundance` targets,
    reference README.md:14). homopolymer_bias: indel rates scale by
    (1 + bias*(run-1)) inside homopolymer runs — the dominant ONT error
    mode the uniform model misses. chimera_rate: fraction of reads that are
    junctions of two unrelated fragments (library chimeras). uniform_edges:
    sample starts beyond the sequence bounds and truncate, so coverage is
    uniform to the very ends (default sampling ramps from 0 over the first/
    last read length — real libraries fragment past the assayed region)."""
    names, seqs, haps, starts, strands = [], [], [], [], []
    ridx = 0
    for h, hap in enumerate(haplotypes):
        cov_h = coverage * (abundances[h] if abundances else 1.0)
        n_reads = int(np.ceil(cov_h * len(hap) / read_len))
        if uniform_edges:
            n_reads = int(np.ceil(n_reads * (len(hap) + read_len - 400) / len(hap)))
        for _ in range(n_reads):
            L = max(50, int(rng.normal(read_len, len_sd))) if len_sd else read_len
            if circular:
                s = int(rng.integers(0, len(hap)))
                frag = (hap + hap)[s : s + L]
            elif uniform_edges:
                s = int(rng.integers(-(L - 200), max(1, len(hap) - 200)))
                frag = hap[max(0, s) : max(0, s) + L + min(0, s)]
                s = max(0, s)
            else:
                s = int(rng.integers(0, max(1, len(hap) - L + 1)))
                frag = hap[s : s + L]
            if chimera_rate and rng.random() < chimera_rate:
                # splice in an unrelated fragment (same or other haplotype)
                h2 = int(rng.integers(0, len(haplotypes)))
                hap2 = haplotypes[h2]
                L2 = max(50, L // 2)
                s2 = int(rng.integers(0, max(1, len(hap2) - L2 + 1)))
                frag = frag[: max(50, L - L2)] + hap2[s2 : s2 + L2]
            frag = _apply_errors(
                frag, sub_rate, ins_rate, del_rate, rng, homopolymer_bias
            )
            strand = int(rng.integers(0, 2))
            if strand == 0:
                frag = revcomp(frag)
            names.append(f"read_{ridx}_h{h}")
            seqs.append(frag)
            haps.append(h)
            starts.append(s)
            strands.append(strand)
            ridx += 1
    return SimReads(names, seqs, haps, starts, strands)


def _apply_errors(seq: str, sub: float, ins: float, dele: float, rng, hp_bias: float = 0.0) -> str:
    if sub == 0 and ins == 0 and dele == 0:
        return seq
    out = []
    run = 0
    prev = ""
    for ch in seq:
        run = run + 1 if ch == prev else 1
        prev = ch
        boost = 1.0 + hp_bias * min(run - 1, 8) if hp_bias else 1.0
        d, i = min(0.45, dele * boost), min(0.45, ins * boost)
        r = rng.random()
        if r < d:
            continue
        if r < d + i:
            out.append(ch)
            # homopolymer over-call: repeat the run base rather than random
            out.append(ch if (hp_bias and rng.random() < 0.75) else _BASES[rng.integers(0, 4)])
            continue
        if r < d + i + sub:
            out.append(_BASES[(_BASES.index(ch) + rng.integers(1, 4)) % 4] if ch in _BASES else ch)
        else:
            out.append(ch)
    return "".join(out)


def write_sim_fasta(path: str, sim: SimReads) -> None:
    with open(path, "w") as f:
        for name, seq in zip(sim.names, sim.seqs):
            f.write(f">{name}\n{seq}\n")

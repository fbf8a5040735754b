"""The benchmark's one traffic generator: strain mixes and the reads sampled
from them, made from a seed in a few vectorised numpy passes.

The error model is that of `hairsplitter_tpu_torch/utils/sim.py`
(`make_haplotypes`, `mutate`, `simulate_reads`, `_apply_errors`), frozen
here so that a change to the program cannot change the traffic:

- strains are random backbones mutated by substitutions at `divergence`;
- reads are sampled per strain at `coverage * abundance` (or a fixed number
  of full-length reads), optionally with `uniform_edges` (starts drawn past
  both ends, fragments truncated, so coverage stays flat to the ends);
- a `chimera_rate` share of reads joins an unrelated half-length fragment;
- per base: deletion, insertion or substitution, with the indel rates
  scaled by `1 + homopolymer_bias * min(run - 1, 8)` inside homopolymer
  runs, an insertion repeating the run's base with probability 0.75 when
  the bias is on;
- every read is reverse-complemented with probability 1/2.

The original draws one random number per base in a Python loop (15.5-17.7 s
for 9 Mbp); this draws them in bulk, so the same seed gives another (but
equally distributed) data set than the original, in well under a second.

Everything the judge needs is kept: each strain, the assembly, the
positions where strains differ from the assembly, and each read's contig,
strain, start, end, strand and whether it is chimeric.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.int8)


@dataclass
class Contig:
    name: str
    assembly: np.ndarray  # int8 codes 0..3
    strains: list[np.ndarray]
    variant_positions: np.ndarray  # sorted 0-based positions where a strain differs from the assembly


@dataclass
class Reads:
    seqs: list[np.ndarray]  # int8 codes as sequenced (reverse-complemented when strand == 0)
    contig: np.ndarray  # index into Job.contigs
    strain: np.ndarray
    start: np.ndarray  # 0-based start of the (first) fragment on the strain
    end: np.ndarray  # its exclusive end
    strand: np.ndarray  # 1 forward, 0 reverse-complemented
    chimeric: np.ndarray  # bool

    @property
    def bases(self) -> int:
        return int(sum(s.size for s in self.seqs))


@dataclass
class Job:
    contigs: list[Contig]
    reads: Reads
    paths: dict = field(default_factory=dict)  # "assembly", "reads" once written

    @property
    def read_names(self) -> list[str]:
        return [f"r{i}" for i in range(len(self.reads.seqs))]


def mutate(seq: np.ndarray, rate: float, rng: np.random.Generator) -> np.ndarray:
    """Substitutions at `rate` of the positions (at least one), each to one
    of the three other bases."""
    out = seq.copy()
    n = max(1, int(seq.size * rate))
    pos = np.sort(rng.choice(seq.size, size=n, replace=False))
    out[pos] = (out[pos] + rng.integers(1, 4, size=n)) % 4
    return out


def run_position(codes: np.ndarray, breaks: np.ndarray) -> np.ndarray:
    """1-based position of every base inside its homopolymer run; a run
    never continues across a `breaks` position (the start of a fragment)."""
    n = codes.size
    new_run = np.ones(n, dtype=bool)
    new_run[1:] = codes[1:] != codes[:-1]
    new_run[breaks] = True
    starts = np.flatnonzero(new_run)
    run_id = np.cumsum(new_run) - 1
    return np.arange(n) - starts[run_id] + 1


def apply_errors(codes: np.ndarray, breaks: np.ndarray, sub: float, ins: float, dele: float,
                 hp_bias: float, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Sequencing errors on the concatenated fragments `codes` (fragment i
    starts at breaks[i]). Returns the erroneous concatenation and the start
    of each fragment in it."""
    n = codes.size
    if sub == 0 and ins == 0 and dele == 0:
        return codes.copy(), breaks.copy()
    if hp_bias:
        boost = 1.0 + hp_bias * np.minimum(run_position(codes, breaks) - 1, 8)
    else:
        boost = np.ones(n)
    d = np.minimum(0.45, dele * boost)
    i = np.minimum(0.45, ins * boost)
    r = rng.random(n)
    deleted = r < d
    inserted = ~deleted & (r < d + i)
    substituted = ~deleted & ~inserted & (r < d + i + sub)
    base = codes.copy()
    base[substituted] = (base[substituted] + rng.integers(1, 4, size=int(substituted.sum()))) % 4
    width = np.where(deleted, 0, np.where(inserted, 2, 1))
    ends = np.cumsum(width)
    out = np.empty(int(ends[-1]) if n else 0, dtype=np.int8)
    keep = ~deleted
    out[ends[keep] - width[keep]] = base[keep]
    ins_at = np.flatnonzero(inserted)
    extra = rng.integers(0, 4, size=ins_at.size).astype(np.int8)
    if hp_bias:
        extra = np.where(rng.random(ins_at.size) < 0.75, codes[ins_at], extra)
    out[ends[ins_at] - 1] = extra
    new_breaks = np.concatenate([[0], ends])[breaks]
    return out, new_breaks


def make_contig(name: str, p: dict, n_strains: int, rng: np.random.Generator) -> Contig:
    """A backbone and its strains. `first_is_backbone`: strain 0 is the
    backbone itself (a species and its strains); otherwise every strain is
    a mutated copy. `assembly`: "strain0" or "backbone" (the collapsed
    contig the mix was assembled into)."""
    length = int(p["contig_len"])
    backbone = rng.integers(0, 4, size=length).astype(np.int8)
    strains = []
    for s in range(n_strains):
        if s == 0 and p.get("first_is_backbone", True):
            strains.append(backbone.copy())
        else:
            strains.append(mutate(backbone, float(p["divergence"]), rng))
    assembly = strains[0] if p.get("assembly", "strain0") == "strain0" else backbone
    differs = np.zeros(length, dtype=bool)
    for st in strains:
        differs |= st != assembly
    return Contig(name, assembly.copy(), strains, np.flatnonzero(differs))


def sample_reads(contigs: list[Contig], p: dict, rng: np.random.Generator) -> Reads:
    """Fragments from every strain of every contig, then errors in bulk."""
    read_len = p.get("read_len", 8000)
    chimera_rate = float(p.get("chimera_rate", 0.0))
    frags, meta = [], []
    for ci, contig in enumerate(contigs):
        strains = contig.strains
        ab = p.get("abundances") or [1.0 / len(strains)] * len(strains)
        if len(ab) != len(strains):
            raise ValueError(f"{len(ab)} abundances for {len(strains)} strains")
        for h, hap in enumerate(strains):
            L_hap = hap.size
            if read_len == "full":  # amplicon reads: every read spans the whole strain
                n = int(round(float(p["reads_per_contig"]) * ab[h]))
                starts = np.zeros(n, dtype=np.int64)
                L = L_hap
            else:
                L = int(read_len)
                n = int(np.ceil(float(p["coverage"]) * ab[h] * L_hap / L))
                if p.get("uniform_edges", False):
                    n = int(np.ceil(n * (L_hap + L - 400) / L_hap))
                    starts = rng.integers(-(L - 200), max(1, L_hap - 200), size=n)
                else:
                    starts = rng.integers(0, max(1, L_hap - L + 1), size=n)
            chim = rng.random(n) < chimera_rate if chimera_rate else np.zeros(n, dtype=bool)
            partners = rng.integers(0, len(strains), size=n)
            L2 = max(50, L // 2)
            s2 = rng.integers(0, max(1, L_hap - L2 + 1), size=n)
            for k in range(n):
                s = int(starts[k])
                lo, hi = max(0, s), max(0, s) + L + min(0, s)
                frag = hap[lo:hi]
                end = hi if hi <= L_hap else L_hap
                if chim[k]:
                    other = strains[int(partners[k])]
                    head = frag[: max(50, L - L2)]
                    end = lo + head.size
                    frag = np.concatenate([head, other[int(s2[k]) : int(s2[k]) + L2]])
                frags.append(frag)
                meta.append((ci, h, lo, min(end, L_hap), bool(chim[k])))
    lengths = np.array([f.size for f in frags], dtype=np.int64)
    breaks = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    noisy, nb = apply_errors(
        np.concatenate(frags), breaks, float(p.get("sub_rate", 0.0)), float(p.get("ins_rate", 0.0)),
        float(p.get("del_rate", 0.0)), float(p.get("homopolymer_bias", 0.0)), rng,
    )
    bounds = np.concatenate([nb, [noisy.size]])
    strand = rng.integers(0, 2, size=len(frags))
    seqs = []
    for k in range(len(frags)):
        s = noisy[bounds[k] : bounds[k + 1]]
        seqs.append(COMPLEMENT[s[::-1]] if strand[k] == 0 else s.copy())
    m = np.array(meta, dtype=object).reshape(-1, 5) if meta else np.zeros((0, 5), dtype=object)
    return Reads(
        seqs=seqs,
        contig=m[:, 0].astype(np.int64),
        strain=m[:, 1].astype(np.int64),
        start=m[:, 2].astype(np.int64),
        end=m[:, 3].astype(np.int64),
        strand=strand.astype(np.int64),
        chimeric=m[:, 4].astype(bool),
    )


def make_job(p: dict, seed: int) -> Job:
    """One job of the mix `p` (a configuration's `data` merged with a
    traffic mix) from `seed`: `strains_per_contig` lists the strains of
    each collapsed contig, named sp0, sp1, ..."""
    rng = np.random.default_rng(seed)
    contigs = [
        make_contig(f"sp{ci}", p, int(ns), rng) for ci, ns in enumerate(p["strains_per_contig"])
    ]
    return Job(contigs, sample_reads(contigs, p, rng))


def to_text(codes: np.ndarray) -> bytes:
    return BASES[codes].tobytes()


def write_job(job: Job, root: str) -> None:
    """Write the job's assembly (FASTA, one collapsed contig per entry) and
    reads (FASTA) under `root`; fills `job.paths`."""
    os.makedirs(root, exist_ok=True)
    asm = os.path.join(root, "assembly.fasta")
    reads = os.path.join(root, "reads.fasta")
    with open(asm, "wb") as f:
        for c in job.contigs:
            f.write(b">" + c.name.encode() + b"\n" + to_text(c.assembly) + b"\n")
    with open(reads, "wb") as f:
        f.write(b"".join(
            b">" + name.encode() + b"\n" + to_text(seq) + b"\n"
            for name, seq in zip(job.read_names, job.reads.seqs)
        ))
    job.paths = {"assembly": asm, "reads": reads}

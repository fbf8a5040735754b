"""The comparison that decides `correct`: a job's artifacts, as the timed
path wrote them, against the truth the generator kept and the plain
references beside this file.

Numbers, each worst over the distinct outputs a run judged:

- `aln_excess` (stage 2, SAM): for a sample of reads drawn from the seed
  (not chimeric, truth span of 1 kb or more), the program's cost of the
  read's alignment, as all its records on the read's true contig and
  strand that overlap its true span state it (the substitutions, insertions
  and deletions of their CIGARs, plus every read base that no record
  aligns, which a semi-global alignment would have to insert; the whole
  read when no record is there), against the least semi-global cost of the
  whole read around its true origin (`align.semiglobal_costs`). Reported
  as sum(program - reference) / sum(reference).
- `variant_miss` (stage 3, VCF): the share of the positions where a truth
  strain differs from the assembly that no variant record names;
  `variant_false_per_mbp`: records at no such position, per Mbp of assembly.
- `group_pair_error` (stage 4, GRO): over every window, the share of pairs of
  clustered reads that the program groups together while they come from
  different strains, or apart while they come from the same strain.
- `recovery_gap`, `switches` (the final assembly): 1 - the lowest strain
  recovery of `score.score_assembly` against the truth strains (contigs
  assigned to the collapsed contig they were made from by name: `sp3_0_1`
  comes from `sp3`), and its switch errors. `min_recovery` is also kept.

Nothing here imports the program: the artifacts are parsed from their text.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from .align import semiglobal_costs
from .score import score_assembly

ARTIFACTS = {
    "sam": "tmp/reads_on_asm.sam",
    "vcf": "variants.vcf",
    "gro": "tmp/reads_haplo.gro",
    "fasta": "hairsplitter_final_assembly.fasta",
}
# every number is a gap from the truth: it fails above its limit
NUMBERS = ("aln_excess", "variant_miss", "variant_false_per_mbp", "group_pair_error", "recovery_gap", "switches")
SAMPLE_PER_JOB = 32
MIN_SAMPLED_SPAN = 1000
WINDOW_MARGIN = 300
BAND = 256
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class Truth:
    """What the judge needs of one generated job."""
    contig_names: list[str]
    assemblies: list[np.ndarray]
    strains: list[list[np.ndarray]]
    variant_positions: list[np.ndarray]
    read_names: list[str]
    read_contig: np.ndarray
    read_strain: np.ndarray
    sample: np.ndarray  # read indices judged in stage 2
    sample_start: np.ndarray  # their truth spans on the strain (= assembly coordinates)
    sample_end: np.ndarray
    sample_strand: np.ndarray
    sample_forward: list[np.ndarray] = field(default_factory=list)  # their bases in the assembly's orientation
    sample_ref_cost: np.ndarray | None = None


def truth_of(job, rng: np.random.Generator) -> Truth:
    """The truth of a generated job (`traffic.generate.Job`), with its stage
    2 sample drawn from `rng`."""
    r = job.reads
    span = r.end - r.start
    eligible = np.flatnonzero(~r.chimeric & (span >= MIN_SAMPLED_SPAN))
    k = min(SAMPLE_PER_JOB, eligible.size)
    sample = np.sort(rng.choice(eligible, size=k, replace=False)) if k else eligible
    fwd = [r.seqs[i] if r.strand[i] == 1 else (3 - r.seqs[i][::-1]).astype(np.int8) for i in sample]
    return Truth(
        contig_names=[c.name for c in job.contigs],
        assemblies=[c.assembly for c in job.contigs],
        strains=[c.strains for c in job.contigs],
        variant_positions=[c.variant_positions for c in job.contigs],
        read_names=job.read_names,
        read_contig=r.contig,
        read_strain=r.strain,
        sample=sample,
        sample_start=r.start[sample],
        sample_end=r.end[sample],
        sample_strand=r.strand[sample],
        sample_forward=fwd,
    )


def reference_costs(truths: list[Truth], device) -> None:
    """Fill each truth's `sample_ref_cost`: one batched DP over every
    sampled read of every job, each against its assembly window."""
    queries, targets, offsets = [], [], []
    for t in truths:
        for n, i in enumerate(t.sample):
            asm = t.assemblies[int(t.read_contig[i])]
            lo = max(0, int(t.sample_start[n]) - WINDOW_MARGIN)
            hi = min(asm.size, int(t.sample_end[n]) + WINDOW_MARGIN)
            queries.append(t.sample_forward[n])
            targets.append(asm[lo:hi])
            offsets.append(int(t.sample_start[n]) - lo)
    costs = semiglobal_costs(queries, targets, offsets, band=BAND, device=device)
    at = 0
    for t in truths:
        t.sample_ref_cost = costs[at : at + t.sample.size]
        at += t.sample.size


def parse_sam(text: str) -> dict[str, list[tuple]]:
    """read name -> [(strand, contig, t_start, t_end, edits, q_start, q_end)],
    q_start and q_end on the read as the record orients it."""
    out: dict[str, list[tuple]] = {}
    for line in text.splitlines():
        if not line or line[0] == "@":
            continue
        f = line.split("\t", 11)
        flag = int(f[1])
        if flag & 4 or f[5] == "*":
            continue
        t0 = int(f[3]) - 1
        edits = t_len = q_len = lead = 0
        for n, op in _CIGAR.findall(f[5]):
            n = int(n)
            if op in "SH" and q_len == 0:
                lead += n
            if op in "XID":
                edits += n
            if op == "M":  # no match/mismatch split: count every base as a possible mismatch
                edits += n
            if op in "=XMD":
                t_len += n
            if op in "=XMI":
                q_len += n
        out.setdefault(f[0], []).append((0 if flag & 16 else 1, f[2], t0, t0 + t_len, edits, lead, lead + q_len))
    return out


def parse_vcf(text: str) -> dict[str, set[int]]:
    out: dict[str, set[int]] = {}
    for line in text.splitlines():
        if line and line[0] != "#":
            f = line.split("\t", 2)
            out.setdefault(f[0], set()).add(int(f[1]))
    return out


def parse_gro(text: str) -> list[tuple[str, list[str], list[tuple[np.ndarray, np.ndarray]]]]:
    """[(contig, read names by row, [(rows, labels) per window])]."""
    out = []
    for line in text.splitlines():
        f = line.split("\t")
        if f[0] == "CONTIG":
            out.append((f[1], [], []))
        elif f[0] == "READ":
            out[-1][1].append(f[1])
        elif f[0] == "GROUP":
            rows = np.array([int(x) for x in f[3].split(",") if x], dtype=np.int64)
            labels = np.array([int(x) for x in f[4].split(",") if x], dtype=np.int64)
            out[-1][2].append((rows, labels))
    return out


def parse_fasta(text: str) -> dict[str, str]:
    out, name, parts = {}, None, []
    for line in text.splitlines():
        if line.startswith(">"):
            if name is not None:
                out[name] = "".join(parts)
            name, parts = line[1:].split()[0], []
        elif line:
            parts.append(line.strip())
    if name is not None:
        out[name] = "".join(parts)
    return out


def _pairs(n: np.ndarray) -> int:
    return int((n * (n - 1) // 2).sum())


def judge(truth: Truth, files: dict[str, str]) -> dict[str, float]:
    """Every number of one job's artifacts (`files`: the texts of ARTIFACTS)."""
    start, end, strand = truth.sample_start, truth.sample_end, truth.sample_strand
    name_to_idx = {n: i for i, n in enumerate(truth.read_names)}

    # stage 2
    records = parse_sam(files["sam"])
    prog = np.empty(truth.sample.size, dtype=np.int64)
    for n, i in enumerate(truth.sample):
        qlen = truth.sample_forward[n].size
        want = truth.contig_names[int(truth.read_contig[i])]
        covered = np.zeros(qlen, dtype=bool)
        edits = 0
        for s, contig, t0, t1, e, q0, q1 in records.get(truth.read_names[i], []):
            if s == int(strand[n]) and contig == want and min(t1, int(end[n])) > max(t0, int(start[n])):
                edits += e
                covered[q0:q1] = True
        prog[n] = edits + int(qlen - covered.sum())
    ref = truth.sample_ref_cost
    aln_excess = float((prog - ref).sum() / max(1, ref.sum())) if ref is not None and ref.size else 0.0

    # stage 3
    called = parse_vcf(files["vcf"])
    truth_n = missed = false = 0
    asm_bp = 0
    for name, asm, pos in zip(truth.contig_names, truth.assemblies, truth.variant_positions):
        got = called.get(name, set())
        want = set(pos.tolist())
        truth_n += len(want)
        missed += len(want - got)
        false += len(got - want)
        asm_bp += asm.size
    variant_miss = missed / truth_n if truth_n else 0.0
    variant_false = false / (asm_bp / 1e6)

    # stage 4
    bad = total = 0
    for contig, names, windows in parse_gro(files["gro"]):
        row_truth = np.array(
            [
                int(truth.read_contig[name_to_idx[n]]) * 1000 + int(truth.read_strain[name_to_idx[n]])
                if n in name_to_idx else -1
                for n in names
            ],
            dtype=np.int64,
        )
        for rows, labels in windows:
            keep = labels >= 0
            if keep.sum() < 2:
                continue
            g, s = labels[keep], row_truth[rows[keep]]
            _, joint = np.unique(np.stack([g, s]), axis=1, return_counts=True)
            same_g = _pairs(np.unique(g, return_counts=True)[1])
            same_s = _pairs(np.unique(s, return_counts=True)[1])
            both = _pairs(joint)
            bad += same_g + same_s - 2 * both
            total += _pairs(np.array([g.size]))
    group_pair_error = bad / total if total else 0.0

    # the final assembly
    contigs = parse_fasta(files["fasta"])
    recovery, switches = [], 0
    for name, strains in zip(truth.contig_names, truth.strains):
        mine = {n: s for n, s in contigs.items() if n.split("_")[0] == name}
        sc = score_assembly(mine if mine else contigs, strains)
        recovery.extend(sc.recovery)
        switches += sc.switches
    return {
        "aln_excess": aln_excess,
        "variant_miss": variant_miss,
        "variant_false_per_mbp": variant_false,
        "group_pair_error": group_pair_error,
        "recovery_gap": 1.0 - float(min(recovery)),
        "switches": float(switches),
        "min_recovery": float(min(recovery)),
    }


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    """Each number at its worst (largest) over several judged outputs."""
    return {key: max(r[key] for r in readings) for key in NUMBERS if readings}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[tuple[str, float, float]]]:
    """Whether every limited number is at or under its limit, and the
    (name, value, limit) of each. A limit without its number fails."""
    for key in limits:
        if key not in NUMBERS:
            raise KeyError(f"no number {key!r} to hold to a limit")
    rows = [(key, numbers.get(key, float("nan")), float(limits[key])) for key in NUMBERS if key in limits]
    ok = bool(rows) and all(value <= lim for _, value, lim in rows)
    return ok, rows

"""Phasing evaluation against known truth haplotypes.

Productizes the reference's research evaluation ideas
(`src/GraphUnzip/tests.py:477-527` check_result — each output contig should
be a sub-walk of one true haplotype — and `check_phasing.py:22-200` — count
switch errors between haplotypes): k-mer containment against each truth
haplotype, per-window haplotype assignment, and switch-error counting.
Used by the test suite and available to users for benchmarking.

Copy of `hairsplitter_tpu/utils/evaluate.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..constants import revcomp


def _kmers(s: str, k: int, step: int = 1):
    return {s[i : i + k] for i in range(0, len(s) - k + 1, step)}


@dataclass
class ContigEval:
    name: str
    length: int
    best_haplotype: int
    identity: float  # kmer containment in the best haplotype
    switch_errors: int
    window_calls: list[int] = field(default_factory=list)


@dataclass
class PhasingEval:
    contigs: list[ContigEval]
    haplotype_recovery: list[float]  # per truth haplotype: fraction recovered

    @property
    def total_switch_errors(self) -> int:
        return sum(c.switch_errors for c in self.contigs)

    @property
    def mean_identity(self) -> float:
        total = sum(c.length for c in self.contigs)
        if not total:
            return 0.0
        return sum(c.identity * c.length for c in self.contigs) / total


def evaluate_phasing(
    contigs: dict[str, str],
    haplotypes: list[str],
    k: int = 31,
    window: int = 2000,
    min_contig: int = 1000,
) -> PhasingEval:
    """Score output contigs against truth haplotypes.

    Per contig: sliding windows are assigned to their best-matching haplotype
    (both strands); a switch error is a change of assignment between adjacent
    confidently-assigned windows. Haplotype recovery is the fraction of each
    truth haplotype's k-mers found anywhere in the output (either strand)."""
    hap_kmers = [_kmers(h, k) for h in haplotypes]
    out = PhasingEval(contigs=[], haplotype_recovery=[])

    all_out_kmers: set = set()
    for seq in contigs.values():
        all_out_kmers |= _kmers(seq, k)
        all_out_kmers |= _kmers(revcomp(seq), k)

    for name, seq in contigs.items():
        if len(seq) < min_contig:
            continue
        calls: list[int] = []
        for lo in range(0, max(1, len(seq) - window + 1), window):
            w = seq[lo : lo + window]
            scores = []
            for hk in hap_kmers:
                qk = _kmers(w, k, step=7)
                fwd = len(qk & hk) / max(1, len(qk))
                qr = _kmers(revcomp(w), k, step=7)
                rev = len(qr & hk) / max(1, len(qr))
                scores.append(max(fwd, rev))
            best = max(range(len(scores)), key=lambda i: scores[i])
            second = max(
                (s for i, s in enumerate(scores) if i != best), default=0.0
            )
            # windows where haplotypes are locally identical are unassignable
            confident_call = scores[best] > 0.5 and scores[best] - second > 0.1
            calls.append(best if confident_call else -1)
        confident = [c for c in calls if c >= 0]
        switches = sum(1 for a, b in zip(confident[:-1], confident[1:]) if a != b)
        qk = _kmers(seq, k, step=7)
        ids = []
        for hk in hap_kmers:
            qr = _kmers(revcomp(seq), k, step=7)
            ids.append(
                max(
                    len(qk & hk) / max(1, len(qk)),
                    len(qr & hk) / max(1, len(qr)),
                )
            )
        besth = max(range(len(ids)), key=lambda i: ids[i])
        out.contigs.append(
            ContigEval(
                name=name,
                length=len(seq),
                best_haplotype=besth,
                identity=ids[besth],
                switch_errors=switches,
                window_calls=calls,
            )
        )

    for hk in hap_kmers:
        if hk:
            out.haplotype_recovery.append(len(hk & all_out_kmers) / len(hk))
        else:
            out.haplotype_recovery.append(0.0)
    return out

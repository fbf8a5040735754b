"""The plain references and the judge's parsers, on small inputs."""

import numpy as np
import pytest

from benchmark.reference import judge as J
from benchmark.reference.align import semiglobal_costs
from benchmark.reference.score import kmer_codes, score_assembly


def naive_semiglobal(q: np.ndarray, t: np.ndarray) -> int:
    """Full-matrix semi-global edit distance (free target end gaps)."""
    n, m = q.size, t.size
    D = np.zeros((n + 1, m + 1), dtype=np.int64)
    D[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            D[i, j] = min(D[i - 1, j - 1] + (q[i - 1] != t[j - 1]), D[i - 1, j] + 1, D[i, j - 1] + 1)
    return int(D[n].min())


def test_banded_dp_equals_the_full_matrix():
    rng = np.random.default_rng(0)
    qs, ts, offs, want = [], [], [], []
    for _ in range(6):
        t = rng.integers(0, 4, size=int(rng.integers(60, 90))).astype(np.int8)
        lo = int(rng.integers(0, 15))
        q = t[lo : lo + 40].copy()
        edits = rng.choice(q.size, size=5, replace=False)
        q[edits] = (q[edits] + 1) % 4
        q = np.delete(q, [3, 17])
        q = np.insert(q, 9, 2).astype(np.int8)
        qs.append(q), ts.append(t), offs.append(lo)
        want.append(naive_semiglobal(q, t))
    assert semiglobal_costs(qs, ts, offs, band=40).tolist() == want


def test_score_equals_the_original():
    from hairsplitter_tpu_torch.utils.evaluate import evaluate_phasing

    rng = np.random.default_rng(1)
    alpha = np.array(list("ACGT"))
    haps = ["".join(rng.choice(alpha, 6000)) for _ in range(2)]
    h1 = list(haps[0])
    for p in rng.choice(6000, 60, replace=False):
        h1[p] = "ACGT"[("ACGT".index(h1[p]) + 1) % 4]
    haps.append("".join(h1))
    out = {"a_0": haps[0][:3500] + haps[2][3500:], "b_0": haps[1][200:5000], "c_0": haps[2][:900]}
    comp = str.maketrans("ACGT", "TGCA")
    out["d_0"] = haps[1][::-1].translate(comp)[:2500]
    ev = evaluate_phasing(out, haps)
    sc = score_assembly(out, haps)
    assert sc.recovery == ev.haplotype_recovery
    assert sc.switches == ev.total_switch_errors
    assert sc.switches >= 1  # the chimeric contig switches
    out["e_0"] = "ACGTN" * 300  # k-mers holding a letter outside ACGT match nothing
    ev = evaluate_phasing(out, haps)
    sc = score_assembly(out, haps)
    assert sc.recovery == ev.haplotype_recovery and sc.switches == ev.total_switch_errors


def test_kmer_codes():
    codes = np.array([0, 1, 2, 3, 0], dtype=np.uint8)
    assert kmer_codes(codes, 3).tolist() == [0b000110, 0b011011, 0b101100]
    assert kmer_codes(codes, 6).size == 0
    assert kmer_codes(codes, 2, step=2).tolist() == [0b0001, 0b1011]
    gap = np.array([0, 1, 255, 2, 3, 0], dtype=np.uint8)  # a letter outside ACGT
    assert kmer_codes(gap, 2).tolist() == [0b0001, 0b1011, 0b1100]


SAM = "\n".join([
    "@HD\tVN:1.6",
    "r0\t0\tsp0\t101\t60\t5S10=1X2I3D4=\t*\t0\t0\t*\t*\tNM:i:6",
    "r0\t16\tsp1\t1\t60\t20=\t*\t0\t0\t*\t*\tNM:i:0",
    "r1\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*",
])


def test_parse_sam():
    rec = J.parse_sam(SAM)
    assert rec["r0"][0] == (1, "sp0", 100, 100 + 10 + 1 + 3 + 4, 6, 5, 5 + 10 + 1 + 2 + 4)
    assert rec["r0"][1] == (0, "sp1", 0, 20, 0, 0, 20)
    assert "r1" not in rec


def test_parse_vcf_gro_fasta():
    vcf = "##fileformat=VCFv4.2\n#CHROM\tPOS\n" + "sp0\t12\t.\tA\tC\nsp0\t40\t.\tA\tC\nsp1\t3\t.\tA\tC\n"
    assert J.parse_vcf(vcf) == {"sp0": {12, 40}, "sp1": {3}}
    gro = "CONTIG\tsp0\t100\t3\nREAD\tr0\t0\t9\t0\t9\t1\nREAD\tr1\t0\t9\t0\t9\t1\nGROUP\t0\t99\t0,1,\t0,-1,\n"
    (name, names, windows), = J.parse_gro(gro)
    assert name == "sp0" and names == ["r0", "r1"]
    assert windows[0][0].tolist() == [0, 1] and windows[0][1].tolist() == [0, -1]
    assert J.parse_fasta(">a x\nAC\nGT\n>b\nT\n") == {"a": "ACGT", "b": "T"}


def _truth(names, strains):
    return J.Truth(
        contig_names=["sp0"], assemblies=[np.zeros(100, np.int8)], strains=[[np.zeros(100, np.int8)]],
        variant_positions=[np.array([10, 20, 30, 40])], read_names=names,
        read_contig=np.zeros(len(names), np.int64), read_strain=np.array(strains),
        sample=np.zeros(0, np.int64), sample_start=np.zeros(0), sample_end=np.zeros(0),
        sample_strand=np.zeros(0), sample_ref_cost=np.zeros(0, np.int64),
    )


@pytest.mark.parametrize("labels,error", [
    ("0,0,1,1,", 0.0),  # grouped by strain
    ("0,0,0,0,", 4 / 6),  # everything together: the four cross-strain pairs
    ("0,1,2,3,", 2 / 6),  # everything apart: the two same-strain pairs
    ("0,0,-1,-1,", 0.0),  # unclustered reads are left out
])
def test_group_pair_error(labels, error):
    names = ["r0", "r1", "r2", "r3"]
    gro = "CONTIG\tsp0\t100\t4\n" + "".join(f"READ\t{n}\t0\t9\t0\t9\t1\n" for n in names)
    gro += f"GROUP\t0\t99\t0,1,2,3,\t{labels}\n"
    files = {"sam": "", "vcf": "sp0\t10\t.\nsp0\t20\t.\nsp0\t77\t.\n", "gro": gro, "fasta": ">sp0_0\n" + "A" * 100}
    got = J.judge(_truth(names, [0, 0, 1, 1]), files)
    assert got["group_pair_error"] == pytest.approx(error)
    assert got["variant_miss"] == 0.5 and got["variant_false_per_mbp"] == pytest.approx(1e4)
    assert got["recovery_gap"] == 0.0 and got["switches"] == 0


def test_worst_and_verdict():
    a = dict.fromkeys(J.NUMBERS, 0.1)
    b = dict(a, aln_excess=0.3)
    w = J.worst([a, b])
    assert w["aln_excess"] == 0.3 and w["switches"] == 0.1
    ok, rows = J.verdict(w, {"aln_excess": 0.5, "switches": 0.2})
    assert ok and [r[0] for r in rows] == ["aln_excess", "switches"]
    ok, _ = J.verdict(w, {"aln_excess": 0.2})
    assert not ok
    with pytest.raises(KeyError):
        J.verdict(w, {"no_such_number": 1.0})


def test_a_read_split_over_records_counts_once():
    """A read aligned as two records (a primary and the rest, each clipping
    the other's part) costs their edits plus the read bases neither aligns."""
    q = np.zeros(40, np.int8)
    t = _truth(["r0"], [0])
    t.sample = np.array([0])
    t.sample_start, t.sample_end, t.sample_strand = np.array([10]), np.array([50]), np.array([1])
    t.sample_forward, t.sample_ref_cost = [q], np.array([4])
    split = "r0\t0\tsp0\t11\t60\t25=1X14S\t*\t0\t0\t*\t*\nr0\t0\tsp0\t30\t60\t20S1X19=\t*\t0\t0\t*\t*\n"
    files = {"sam": split, "vcf": "", "gro": "", "fasta": ">sp0_0\n" + "A" * 100}
    assert J.judge(t, files)["aln_excess"] == pytest.approx((2 - 4) / 4)
    clipped = "r0\t0\tsp0\t11\t60\t1X29=10S\t*\t0\t0\t*\t*\n"
    assert J.judge(t, dict(files, sam=clipped))["aln_excess"] == pytest.approx((1 + 10 - 4) / 4)
    elsewhere = "r0\t0\tsp0\t80\t60\t40=\t*\t0\t0\t*\t*\n"  # off its true span: the whole read is unaligned
    assert J.judge(t, dict(files, sam=elsewhere))["aln_excess"] == pytest.approx((40 - 4) / 4)

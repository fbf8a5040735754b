"""Parity of the port's standalone untangler CLI (`hairsplitter_tpu_torch/
graphunzip.py`) with the JAX package's `hairsplitter_tpu/graphunzip.py`.

Each subcommand of both `main`s runs on the same files, made from a seed with
numpy (the inputs of `tests/test_graphunzip_cli.py` and `tests/test_dbg.py`);
the port maps with `--device cpu`. Tolerance: none. Output GFA, FASTA and
supercontigs files are compared byte for byte, `.npz` matrices array by array,
and what each command prints line by line."""

import os

import numpy as np
import pytest

from hairsplitter_tpu.graphunzip import main as jax_main
from hairsplitter_tpu.utils.sim import random_genome, simulate_reads
from hairsplitter_tpu_torch.graphunzip import main as port_main
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _gaf_line(read, path, qlen=1000):
    return f"{read}\t{qlen}\t0\t{qlen}\t+\t{path}\t3000\t0\t3000\t950\t1000\t60\tid:f:0.95\n"


def _write_gfa(path, seqs, links, depths=None):
    with open(path, "w") as f:
        for n, s in seqs.items():
            f.write(f"S\t{n}\t{s}\tDP:f:{(depths or {}).get(n, 20)}\n")
        for a, b in links:
            f.write(f"L\t{a}\t+\t{b}\t+\t0M\n")


DIAMOND = [("A1", "X"), ("A2", "X"), ("X", "C1"), ("X", "C2")]


def _run_both(tmp_path, capsys, argv_of, outputs):
    """Run `argv_of(out_dir, device_flags)` through both mains; returns the
    two dicts {output name: bytes or npz arrays} after comparing what was
    printed (paths aside)."""
    results, printed = [], []
    for pkg, main, device in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        out = tmp_path / pkg
        out.mkdir()
        assert main(argv_of(out, device)) == 0
        printed.append(capsys.readouterr().out.replace(str(out), "OUT"))
        files = {}
        for name in outputs:
            p = out / name
            assert p.exists() and p.stat().st_size > 0, (pkg, name)
            if name.endswith(".npz"):
                data = np.load(p, allow_pickle=True)
                files[name] = {k: (data[k].dtype, data[k].shape, data[k].tolist()) for k in data.files}
            else:
                files[name] = p.read_bytes()
        results.append(files)
    assert printed[0] == printed[1]
    return results


def test_unzip_equals_jax(tmp_path, capsys):
    """`unzip -e -f` on the collapsed diamond of tests/test_graphunzip_cli.py."""
    rng = np.random.default_rng(0)
    seqs = {n: random_genome(800, rng) for n in ("A1", "A2", "C1", "C2")}
    seqs["X"] = random_genome(1200, rng)
    gfa, gaf = tmp_path / "in.gfa", tmp_path / "aln.gaf"
    _write_gfa(gfa, seqs, DIAMOND)
    with open(gaf, "w") as f:
        for k in range(3):
            f.write(_gaf_line(f"r1_{k}", ">A1>X>C1"))
            f.write(_gaf_line(f"r2_{k}", ">A2>X>C2"))
    ref, got = _run_both(
        tmp_path, capsys,
        lambda out, dev: ["unzip", "-g", str(gfa), "-l", str(gaf), "-o", str(out / "out.gfa"), "-e",
                          "-f", str(out / "out.fa"), "--supercontigs", str(out / "super.txt")],
        ["out.gfa", "out.fa", "super.txt"],
    )
    assert got == ref
    assert got["out.gfa"].count(b"\nS\t") + got["out.gfa"].startswith(b"S\t") == 2
    assert len(got["super.txt"].splitlines()) == 2


def test_unzip_with_reads_repolishes_and_equals_jax(tmp_path, capsys, monkeypatch):
    """`unzip -r`: the duplicated copies of X are re-polished from the reads
    of their own paths (the shared contig differs by 1% between the two
    haplotypes, and the graph holds the first)."""
    import hairsplitter_tpu_torch.graphunzip as port_gz
    from hairsplitter_tpu.utils.sim import mutate

    rng = np.random.default_rng(1)
    seqs = {n: random_genome(1500, rng) for n in ("A1", "A2", "C1", "C2")}
    seqs["X"] = random_genome(3000, rng)
    x2, _ = mutate(seqs["X"], 0.01, rng)
    haps = [seqs["A1"] + seqs["X"] + seqs["C1"], seqs["A2"] + x2 + seqs["C2"]]
    sim = simulate_reads(haps, coverage=12, read_len=5500, rng=rng, sub_rate=0.02, ins_rate=0.01, del_rate=0.01)
    gfa, gaf, reads = tmp_path / "in.gfa", tmp_path / "aln.gaf", tmp_path / "reads.fa"
    _write_gfa(gfa, seqs, DIAMOND)
    with open(gaf, "w") as f, open(reads, "w") as fr:
        for i, (s, h) in enumerate(zip(sim.seqs, sim.hap_of_read)):
            fr.write(f">read_{i}\n{s}\n")
            f.write(_gaf_line(f"read_{i}", ">A1>X>C1" if h == 0 else ">A2>X>C2", qlen=len(s)))
    repolished = []
    orig = port_gz.repolish_copies
    monkeypatch.setattr(port_gz, "repolish_copies",
                        lambda *a, **k: repolished.append(orig(*a, **k)) or repolished[-1])
    ref, got = _run_both(
        tmp_path, capsys,
        lambda out, dev: ["unzip", "-g", str(gfa), "-l", str(gaf), "-r", str(reads), "-o", str(out / "out.gfa"),
                          "--dont_merge", "--supercontigs", str(out / "super.txt"), *dev],
        ["out.gfa", "super.txt"],
    )
    assert repolished and repolished[0] >= 1, "no duplicated copy was re-polished"
    assert got == ref


def test_unzip_duplicate_by_topology_equals_jax(tmp_path, capsys):
    """`unzip -D -x`: the multiway duplication of tests/test_graphunzip_cli.py
    (no informative read path), exported most-covered first."""
    rng = np.random.default_rng(2)
    depths = {"A": 12, "B": 8, "C": 12, "D": 8, "X": 20}
    seqs = {n: random_genome(1500, rng) for n in depths}
    gfa, gaf = tmp_path / "in.gfa", tmp_path / "aln.gaf"
    _write_gfa(gfa, seqs, [("A", "X"), ("B", "X"), ("X", "C"), ("X", "D")], depths)
    gaf.write_text(_gaf_line("r0", ">A"))
    ref, got = _run_both(
        tmp_path, capsys,
        lambda out, dev: ["unzip", "-g", str(gfa), "-l", str(gaf), "-o", str(out / "out.gfa"), "-D", "-x",
                          "--supercontigs", str(out / "super.txt")],
        ["out.gfa", "super.txt"],
    )
    assert got == ref
    assert b"X-dup" in got["super.txt"]


@pytest.mark.parametrize("blunt", [False, True], ids=["plain", "blunt"])
def test_dbg_equals_jax(tmp_path, capsys, blunt):
    """`dbg` on the collapsed three-contig repeat of tests/test_dbg.py."""
    rng = np.random.default_rng(0)
    names = ["A", "B", "R1", "R2", "R3", "C", "D"]
    seqs = {n: random_genome(2000, rng) for n in names}
    links = [("A", "R1"), ("B", "R1"), ("R1", "R2"), ("R2", "R3"), ("R3", "C"), ("R3", "D")]
    gfa, gaf = tmp_path / "in.gfa", tmp_path / "aln.gaf"
    _write_gfa(gfa, seqs, links, {n: 20 if n.startswith("R") else 10 for n in names})
    with open(gaf, "w") as f:
        rid = 0
        for _ in range(3):
            for p in (">A>R1>R2", ">B>R1>R2", ">R1>R2>R3", ">R2>R3>C", ">R2>R3>D"):
                f.write(_gaf_line(f"r{rid}", p, qlen=6000))
                rid += 1
    ref, got = _run_both(
        tmp_path, capsys,
        lambda out, dev: ["dbg", "-g", str(gfa), "-l", str(gaf), "-o", str(out / "out.gfa"),
                          "-f", str(out / "out.fa"), "-k", "9", "--chunk", "1000"] + (["--blunt"] if blunt else []),
        ["out.gfa", "out.fa"],
    )
    assert got == ref
    # a flank was extended into the repeat: some contig is longer than any input
    assert max(len(line) for line in got["out.fa"].splitlines()) > 2000


def _mate_pairs(tmp_path, seqs, rng):
    r1, r2 = tmp_path / "r1.fa", tmp_path / "r2.fa"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        k = 0
        for a, c in (("A1", "C1"), ("A2", "C2")):
            for _ in range(8):
                s1, s2 = int(rng.integers(0, 1000)), int(rng.integers(0, 1000))
                f1.write(f">p{k}\n{seqs[a][s1:s1 + 400]}\n")
                f2.write(f">p{k}\n{seqs[c][s2:s2 + 400]}\n")
                k += 1
    return r1, r2


def test_hic_im_and_untangle_im_equal_jax(tmp_path, capsys):
    """`hic-im` on mate pairs drawn from the true haplotypes, then
    `untangle-im` on the matrix it wrote."""
    rng = np.random.default_rng(0)
    seqs = {n: random_genome(1500, rng) for n in ("A1", "A2", "C1", "C2", "X")}
    gfa = tmp_path / "in.gfa"
    _write_gfa(gfa, seqs, DIAMOND)
    r1, r2 = _mate_pairs(tmp_path, seqs, rng)

    def both_steps(out, dev):
        return ["hic-im", "-g", str(gfa), "-1", str(r1), "-2", str(r2), "-o", str(out / "im.npz"), *dev]

    ref, got = _run_both(tmp_path, capsys, both_steps, ["im.npz"])
    assert got == ref
    names, m = got["im.npz"]["names"][2], np.asarray(got["im.npz"]["m"][2])
    assert m[names.index("A1"), names.index("C1")] >= 6 and m[names.index("A1"), names.index("C2")] == 0
    outs = []
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / pkg / "out.gfa"
        assert main(["untangle-im", "-g", str(gfa), "-m", str(tmp_path / pkg / "im.npz"), "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    printed = capsys.readouterr().out
    assert outs[0] == outs[1] and outs[1].count(b"S\t") == 2
    assert printed.count("solved 1/1 knots") == 2


def test_linked_reads_im_equals_jax(tmp_path, capsys):
    """`linked-reads-im` on barcoded reads. Both packages' FASTA reader keeps
    a header's first word only, so the `BX:Z:` tag after the blank never
    reaches the command and no pair is counted: the port reproduces that,
    matrix and printed line alike (a read whose name is the tag itself is
    seen, but names are unique, so it pairs with nothing)."""
    rng = np.random.default_rng(3)
    seqs = {n: random_genome(1500, rng) for n in ("A1", "A2", "C1", "C2", "X")}
    gfa, reads = tmp_path / "in.gfa", tmp_path / "linked.fa"
    _write_gfa(gfa, seqs, DIAMOND)
    with open(reads, "w") as f:
        k = 0
        for bc, members in (("AAAC", ("A1", "X", "C1")), ("GGTT", ("A2", "X", "C2")), ("TTTT", ("A1",))):
            for n in members:
                for _ in range(3):
                    s = int(rng.integers(0, 1000))
                    f.write(f">l{k} BX:Z:{bc}\n{seqs[n][s:s + 400]}\n")
                    k += 1
        f.write(f">nobarcode\n{seqs['X'][100:500]}\n")
        f.write(f">junk BX:Z:CCCC\n{random_genome(400, rng)}\n")
        f.write(f">BX:Z:ACGT\n{seqs['C2'][200:600]}\n")
    ref, got = _run_both(
        tmp_path, capsys,
        lambda out, dev: ["linked-reads-im", "-g", str(gfa), "-r", str(reads), "-o", str(out / "im.npz"), *dev],
        ["im.npz"],
    )
    assert got == ref
    assert got["im.npz"]["names"][2] == list(seqs) and got["im.npz"]["m"][1] == (5, 5)


def test_mapping_subcommands_need_the_device_they_are_given(tmp_path):
    """No quiet CPU run: `--device cuda` (the default) without a GPU raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    rng = np.random.default_rng(0)
    seqs = {n: random_genome(600, rng) for n in ("A1", "A2", "C1", "C2", "X")}
    gfa = tmp_path / "in.gfa"
    _write_gfa(gfa, seqs, DIAMOND)
    r1, r2 = _mate_pairs(tmp_path, {n: s * 3 for n, s in seqs.items()}, rng)
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["hic-im", "-g", str(gfa), "-1", str(r1), "-2", str(r2), "-o", str(tmp_path / "im.npz")])
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["linked-reads-im", "-g", str(gfa), "-r", str(r1), "-o", str(tmp_path / "im.npz")])
    assert not os.path.exists(tmp_path / "im.npz")

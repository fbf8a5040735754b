"""Parity of the port's assembly correction (`hairsplitter_tpu_torch/pipeline/
tailor.py`, `--correct-assembly`) with the JAX package's.

The datasets are those of `tests/test_tailor.py`, made from a seed with
numpy; each goes through both `correct_assembly` (the JAX side on its CPU
backend through its native job runner, the port with `device="cpu"`).
Tolerance: none. Segments (names, order, sequences), links (in order),
depths and every field of the report are compared exactly."""

import dataclasses
import os

import numpy as np
import pytest

import hairsplitter_tpu.pipeline.tailor as jax_tailor
import hairsplitter_tpu_torch.pipeline.tailor as port_tailor
from hairsplitter_tpu.core.datatypes import Alignment as JaxAlignment
from hairsplitter_tpu.core.mapping import MapConfig as JaxMapConfig
from hairsplitter_tpu.io import gfa as jax_gfa
from hairsplitter_tpu.utils.sim import random_genome, simulate_reads
from hairsplitter_tpu_torch.core.datatypes import Alignment
from hairsplitter_tpu_torch.core.mapping import MapConfig
from hairsplitter_tpu_torch.io import gfa as port_gfa
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ------------------------------------------------------------- the datasets
# each returns ([(name, sequence, depth)], read sequences)


def data_missing_link(rng):
    A, B = random_genome(4000, rng), random_genome(4000, rng)
    sim = simulate_reads([A + B], coverage=12, read_len=2000, rng=rng)
    return [("A", A, 12), ("B", B, 12)], sim.seqs


def data_chimeric_cut(rng):
    left, right = random_genome(4000, rng), random_genome(4000, rng)
    mol1 = left + random_genome(4000, rng)
    mol2 = random_genome(4000, rng) + right
    sim = simulate_reads([mol1, mol2], coverage=15, read_len=2000, rng=rng)
    return [("chim", left + right, 15)], sim.seqs


def data_no_errors(rng):
    genome = random_genome(6000, rng)
    sim = simulate_reads([genome], coverage=10, read_len=2000, rng=rng)
    return [("g", genome, 10)], sim.seqs


def data_gap_filling(rng):
    A, B, insert = random_genome(4000, rng), random_genome(4000, rng), random_genome(300, rng)
    sim = simulate_reads([A + insert + B], coverage=12, read_len=2500, rng=rng)
    return [("A", A, 12), ("B", B, 12)], sim.seqs


def data_reassemble_unaligned(rng):
    known, novel = random_genome(5000, rng), random_genome(5000, rng)
    sim = simulate_reads([known, novel], coverage=10, read_len=1500, rng=rng)
    return [("known", known, 10)], sim.seqs


def data_misjoin_and_gap(rng):
    A, decoy, B = random_genome(4000, rng), random_genome(3000, rng), random_genome(4000, rng)
    insert = random_genome(300, rng)
    sim = simulate_reads([A + insert + B], coverage=15, read_len=2500, rng=rng)
    return [("chim", A + decoy, 15), ("B", B, 15)], sim.seqs


def data_noisy_gap_filling(rng):
    """Gap filling from 10%-error reads, so that the junction's inserts go
    through the POA polish and its remap."""
    A, B, insert = random_genome(4000, rng), random_genome(4000, rng), random_genome(400, rng)
    sim = simulate_reads([A + insert + B], coverage=14, read_len=2500, rng=rng,
                         sub_rate=0.06, ins_rate=0.02, del_rate=0.02)
    return [("A", A, 14), ("B", B, 14)], sim.seqs


def _assembly(gfa_mod, segments):
    asm = gfa_mod.AssemblyGraph()
    for name, seq, depth in segments:
        asm.add_segment(name, seq, depth=depth)
    return asm


def _graph_state(g):
    return (
        list(g.segments.items()),
        [(l.name1, l.orient1, l.name2, l.orient2, l.cigar) for l in g.links],
        dict(g.depths),
    )


def _both(segments, seqs, map_kw=None, cfg_kw=None, **kw):
    """(graph state, report fields) of the JAX package's run and of the port's."""
    reads = dict(enumerate(seqs))
    map_kw, cfg_kw = map_kw or {}, cfg_kw or {}
    ref = jax_tailor.correct_assembly(
        _assembly(jax_gfa, segments), reads, JaxMapConfig(**map_kw), jax_tailor.TailorConfig(**cfg_kw), **kw)
    got = port_tailor.correct_assembly(
        _assembly(port_gfa, segments), reads, MapConfig(**map_kw), port_tailor.TailorConfig(**cfg_kw),
        device="cpu", **kw)
    return [(_graph_state(g), dataclasses.asdict(rep)) for g, rep in (ref, got)]


DATASETS = {
    "missing_link": (data_missing_link, lambda rep: rep["new_links"]),
    "chimeric_cut": (data_chimeric_cut, lambda rep: rep["cuts"]),
    "no_errors": (data_no_errors, lambda rep: not rep["cuts"] and not rep["new_links"]),
    "gap_filling": (data_gap_filling, lambda rep: rep["new_links"]),
    "reassemble_unaligned": (data_reassemble_unaligned, lambda rep: rep["reassembled_contigs"] >= 1),
    "misjoin_and_gap": (
        data_misjoin_and_gap,
        lambda rep: rep["cuts"] and rep["dropped_low_coverage"] >= 1 and rep["iterations"] >= 1,
    ),
    "noisy_gap_filling": (data_noisy_gap_filling, lambda rep: rep["new_links"]),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_correct_assembly_equals_jax(name):
    make, went_through = DATASETS[name]
    segments, seqs = make(np.random.default_rng(0))
    (ref_graph, ref_rep), (got_graph, got_rep) = _both(segments, seqs)
    assert went_through(ref_rep), ref_rep  # the dataset exercises what its name says
    assert got_rep == ref_rep
    assert got_graph == ref_graph
    if name.endswith("gap_filling"):
        assert any(n.startswith("junction_") for n, _ in got_graph[0])


def test_correct_assembly_with_the_int32_dp_equals_jax():
    """`MapConfig(use_myers=False)`: tailor's mappings go through K2's plain
    version in the port and through the int32 DP in the JAX package."""
    segments, seqs = data_misjoin_and_gap(np.random.default_rng(3))
    (ref_graph, ref_rep), (got_graph, got_rep) = _both(segments, seqs, map_kw=dict(use_myers=False))
    assert ref_rep["cuts"] and ref_rep["new_links"]
    assert got_rep == ref_rep and got_graph == ref_graph


def test_loop_past_five_iterations_equals_jax(monkeypatch):
    """The 8-pass repair cascade of tests/test_tailor.py in both packages."""
    def cascade(module):
        calls = {"n": 0}
        real_apply = module._apply_corrections

        def fake_apply(graph, *args, **kw):
            calls["n"] += 1
            if calls["n"] <= 8:
                return graph, True
            return real_apply(graph, *args, **kw)

        monkeypatch.setattr(module, "_apply_corrections", fake_apply)
        return calls

    jax_calls, port_calls = cascade(jax_tailor), cascade(port_tailor)
    rng = np.random.default_rng(0)
    g = random_genome(3000, rng)
    sim = simulate_reads([g], coverage=8, read_len=1500, rng=rng)
    (ref_graph, ref_rep), (got_graph, got_rep) = _both([("c", g, 8)], sim.seqs)
    assert jax_calls["n"] >= 9 and port_calls["n"] == jax_calls["n"]
    assert ref_rep["iterations"] >= 8
    assert got_rep == ref_rep and got_graph == ref_graph


def test_checkpoint_and_resume_give_the_uninterrupted_result(tmp_path):
    """A run that stops before its first correction pass leaves
    `tailor_iter_0.gfa` and `tailor_state.json`; resumed, it ends in the
    graph of the uninterrupted run, and so does a resume from the last
    checkpoint; the checkpoints equal the JAX package's byte for byte."""
    segments, seqs = data_misjoin_and_gap(np.random.default_rng(0))
    reads = dict(enumerate(seqs))
    d_jax, d_full, d_cut = (str(tmp_path / n) for n in ("jax", "full", "cut"))
    for d in (d_jax, d_full, d_cut):
        os.makedirs(d)
    jax_tailor.correct_assembly(_assembly(jax_gfa, segments), reads, artifact_dir=d_jax)
    full, rep_full = port_tailor.correct_assembly(
        _assembly(port_gfa, segments), reads, artifact_dir=d_full, device="cpu")
    assert rep_full.iterations >= 1 and rep_full.cuts
    names = sorted(os.listdir(d_jax))
    assert {"tailor_iter_0.gfa", "tailor_iter_1.gfa", "tailor_state.json"} <= set(names)
    assert sorted(os.listdir(d_full)) == names
    for n in names:
        with open(os.path.join(d_jax, n), "rb") as f1, open(os.path.join(d_full, n), "rb") as f2:
            assert f1.read() == f2.read(), n

    # interrupted before the first pass: max_iterations=0 never enters the loop
    port_tailor.correct_assembly(
        _assembly(port_gfa, segments), reads, cfg=port_tailor.TailorConfig(max_iterations=0),
        artifact_dir=d_cut, device="cpu")
    assert sorted(os.listdir(d_cut)) == ["tailor_iter_0.gfa", "tailor_state.json"]
    for d in (d_cut, d_full):  # from the first checkpoint, and from the last
        resumed, rep_res = port_tailor.correct_assembly(
            _assembly(port_gfa, segments), reads, artifact_dir=d, resume=True, device="cpu")
        assert _graph_state(resumed) == _graph_state(full)
        assert rep_res.iterations == rep_full.iterations
        assert rep_res.end_to_end_before == rep_full.end_to_end_before
        assert rep_res.end_to_end_after == rep_full.end_to_end_after


def _shave_case(gfa_mod, tailor_mod):
    g = gfa_mod.AssemblyGraph()
    for name, seq in (("main1", "A" * 500), ("main2", "C" * 500), ("dead", "G" * 30),
                      ("b1", "A" * 10), ("b2", "C" * 10)):
        g.add_segment(name, seq)
    for a, b in (("main1", "dead"), ("main1", "b1"), ("main1", "b2"), ("b1", "main2"), ("b2", "main2")):
        g.add_link(gfa_mod.Link(a, "+", b, "+", "0M"))
    removed = tailor_mod.shave_and_pop(g, 60, 20)
    return removed, _graph_state(g)


def _cleanup_case(gfa_mod, tailor_mod, alignment_cls):
    g = gfa_mod.AssemblyGraph()
    g.add_segment("cov", "A" * 1000, depth=5)
    g.add_segment("nocov", "C" * 1000, depth=5)
    z = np.zeros(0, np.uint8)
    alns = {i: [alignment_cls(i, "cov", 1, 0, 1000, 0, 1000, z, z)] for i in range(3)}
    dropped = tailor_mod.last_cleanup(g, alns, min_coverage=1.0)
    return dropped, _graph_state(g)


@pytest.mark.parametrize("unit", ["shave_and_pop", "last_cleanup"])
def test_unit_cases_equal_jax(unit):
    if unit == "shave_and_pop":
        ref, got = _shave_case(jax_gfa, jax_tailor), _shave_case(port_gfa, port_tailor)
        assert got[0] == 2 and "dead" not in dict(got[1][0])
    else:
        ref = _cleanup_case(jax_gfa, jax_tailor, JaxAlignment)
        got = _cleanup_case(port_gfa, port_tailor, Alignment)
        assert got[0] == 1 and got[1][2] == {"cov": 3.0}
    assert got == ref


def test_helpers_equal_jax():
    """`_pool_positions`, `_attach_piece`, `_link_keys` and `_trim_noisy_ends`
    on seeded inputs."""
    rng = np.random.default_rng(5)
    votes = sorted(int(v) for v in rng.integers(0, 3000, 60))
    pieces = [("c&0", 0, 900), ("c&1", 900, 2100), ("c&2", 2100, 3000)]
    ops = np.array([0, 1, 0, 2, 0, 3, 1, 1, 1, 0], np.uint8)  # = X = I = D X X X =
    lens = np.array([3, 2, 40, 1, 30, 2, 3, 1, 2, 5], np.int32)
    out = []
    for tailor_mod, gfa_mod, aln_cls in ((jax_tailor, jax_gfa, JaxAlignment), (port_tailor, port_gfa, Alignment)):
        g = gfa_mod.AssemblyGraph()
        for n in "abc":
            g.add_segment(n, "ACGT")
        g.add_link(gfa_mod.Link("a", "+", "b", "-", "0M"))
        g.add_link(gfa_mod.Link("c", "-", "a", "+", "0M"))
        trimmed = [
            tailor_mod._trim_noisy_ends(aln_cls(0, "c", strand, 10, 10 + 87, 100, 100 + 88, ops, lens))
            for strand in (1, -1)
        ]
        out.append((
            tailor_mod._pool_positions(votes, 100, 3),
            [tailor_mod._attach_piece(pieces, side, pos, entering)
             for side in "+-" for pos in (0, 950, 2990) for entering in (True, False)],
            sorted(tailor_mod._link_keys(g)),
            [(a.q_start, a.q_end, a.t_start, a.t_end, a.cigar_ops.tolist(), a.cigar_lens.tolist()) for a in trimmed],
        ))
    assert out[0] == out[1]
    assert out[0][3][0][:2] != (10, 97)  # the noisy ends were trimmed

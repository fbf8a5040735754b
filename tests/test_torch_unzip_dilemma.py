"""Parity of the port's dilemma untangler (`pipeline/unzip.py`) with the JAX
package's on the five repeat-cassette graphs of tests/test_unzip_dilemma.py.

Each case makes the call its JAX test makes (`unzip`, or `duplicate_contigs`
alone) on one graph and one set of read paths built twice, once with each
package's `AssemblyGraph`; the port re-polishes duplicated copies on the CPU.
Tolerance: none. The segments (names, order, sequences), depths, links (in
order), the copy -> original map that `duplicate_contigs` returns, the
rewritten read paths and, for `unzip`, the supercontigs must be equal."""

import copy

import numpy as np
import pytest

import hairsplitter_tpu.pipeline.unzip as jax_unzip
import hairsplitter_tpu_torch.pipeline.unzip as port_unzip
from hairsplitter_tpu.io.gfa import AssemblyGraph as JaxGraph, Link as JaxLink
from hairsplitter_tpu.utils.sim import mutate, random_genome
from hairsplitter_tpu_torch.io.gfa import AssemblyGraph as PortGraph, Link as PortLink
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASSETTE = [("A1", "+", "R1", "+"), ("A2", "+", "R1", "+"), ("R1", "+", "R2", "+"),
            ("R2", "+", "B1", "+"), ("R2", "+", "B2", "+")]
DIAMOND = [("A1", "+", "X", "+"), ("A2", "+", "X", "+"), ("X", "+", "B1", "+"), ("X", "+", "B2", "+")]


def _flanks():
    return {n: "ACGT" * 50 for n in ("A1", "A2", "B1", "B2")}


def _two_contig_repeat_cassette():
    segs = {**_flanks(), "R1": "TTGC" * 60, "R2": "GGAT" * 60}
    paths = {}
    for k in range(3):
        paths[2 * k] = [("A1", 1), ("R1", 1), ("R2", 1), ("B1", 1)]
        paths[2 * k + 1] = [("A2", 1), ("R1", 1), ("R2", 1), ("B2", 1)]
    return segs, CASSETTE, 20.0, paths, "unzip", {}


def _reverse_reads():
    segs = {**_flanks(), "R1": "TTGC" * 60}
    links = [(a.replace("X", "R1"), o1, b.replace("X", "R1"), o2) for a, o1, b, o2 in DIAMOND]
    paths = {}
    for k in range(2):
        paths[4 * k] = [("A1", 1), ("R1", 1), ("B1", 1)]
        paths[4 * k + 1] = [("B1", 0), ("R1", 0), ("A1", 0)]
        paths[4 * k + 2] = [("A2", 1), ("R1", 1), ("B2", 1)]
        paths[4 * k + 3] = [("B2", 0), ("R1", 0), ("A2", 0)]
    return segs, links, 20.0, paths, "unzip", {}


def _unmatched_paths_canceled():
    segs = {**_flanks(), "X": "TTGC" * 60}
    paths = {}
    for k in range(4):
        paths[2 * k] = [("A1", 1), ("X", 1), ("B1", 1)]
        paths[2 * k + 1] = [("A2", 1), ("X", 1), ("B2", 1)]
    paths[8] = [("A1", 1), ("X", 1), ("B2", 1)]  # support 1 < 2
    return segs, DIAMOND, 20.0, paths, "duplicate_contigs", {}


def _links_unconfirmed():
    segs = {**_flanks(), "X": "TTGC" * 60}
    paths = {k: [("A1" if k % 2 == 0 else "A2", 1), ("X", 1), ("B1", 1)] for k in range(4)}
    return segs, DIAMOND, 20.0, paths, "duplicate_contigs", {}


def _repolish_copies():
    # tests/test_unzip_dilemma.py:test_repolish_copies_restores_path_content,
    # drawn from seed 0 (its `rng` fixture is default_rng(0))
    rng = np.random.default_rng(0)
    A1, A2 = random_genome(1200, rng), random_genome(1200, rng)
    C1, C2 = random_genome(1200, rng), random_genome(1200, rng)
    X = random_genome(2000, rng)
    X2, _ = mutate(X, 0.01, rng)
    segs = {"A1": A1, "A2": A2, "X": X, "C1": C1, "C2": C2}
    links = [("A1", "+", "X", "+"), ("A2", "+", "X", "+"), ("X", "+", "C1", "+"), ("X", "+", "C2", "+")]
    paths, seqs = {}, {}
    for k in range(6):
        paths[k] = [("A1", 1), ("X", 1), ("C1", 1)]
        seqs[k] = A1[600:] + X + C1[:600]
    for k in range(6, 12):
        paths[k] = [("A2", 1), ("X", 1), ("C2", 1)]
        seqs[k] = A2[600:] + X2 + C2[:600]
    return segs, links, 12.0, paths, "unzip", dict(merge=False, read_seqs=seqs)


CASES = {
    "two_contig_repeat_cassette": _two_contig_repeat_cassette,
    "reverse_reads": _reverse_reads,
    "unmatched_paths_canceled": _unmatched_paths_canceled,
    "links_unconfirmed": _links_unconfirmed,
    "repolish_copies": _repolish_copies,
}


def _run(module, graph_cls, link_cls, case, monkeypatch, **device):
    """The case's call through one package: (graph, read paths afterwards,
    copy -> original map, supercontigs or None)."""
    segs, links, depth, paths, call, kwargs = CASES[case]()
    g = graph_cls()
    for name, seq in segs.items():
        g.add_segment(name, seq, depth)
    for link in links:
        g.add_link(link_cls(*link))
    paths = copy.deepcopy(paths)
    copies = []
    duplicate = module.duplicate_contigs

    def recorded(*a, **k):
        copies.append(duplicate(*a, **k))
        return copies[-1]

    monkeypatch.setattr(module, "duplicate_contigs", recorded)
    supercontigs = None
    if call == "unzip":
        res = module.unzip(g, paths, **kwargs, **device)
        g, supercontigs = res.graph, res.supercontigs
    else:
        module.duplicate_contigs(g, paths, **kwargs)
    assert len(copies) == 1
    return g, paths, copies[0], supercontigs


@pytest.mark.parametrize("case", list(CASES))
def test_dilemma_untangler_equals_jax(case, monkeypatch):
    jg, jpaths, jcopies, jsuper = _run(jax_unzip, JaxGraph, JaxLink, case, monkeypatch)
    pg, ppaths, pcopies, psuper = _run(port_unzip, PortGraph, PortLink, case, monkeypatch, device="cpu")
    assert list(pg.segments.items()) == list(jg.segments.items())
    assert pg.depths == jg.depths
    assert [(l.name1, l.orient1, l.name2, l.orient2, l.cigar) for l in pg.links] == \
        [(l.name1, l.orient1, l.name2, l.orient2, l.cigar) for l in jg.links]
    assert pcopies == jcopies
    assert ppaths == jpaths
    assert psuper == jsuper
    # the case does what its JAX test checks: a duplication, or none where
    # the links are unconfirmed
    assert (pcopies == {}) == (case == "links_unconfirmed")

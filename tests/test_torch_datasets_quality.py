"""End-to-end parity of the port's pipeline with the JAX package on the two
quality scenarios of `scripts/eval_quality.py`, reduced in scale and built
by `scripts/torch_eval_quality.py`: every artifact byte-identical (the
harness of tests/test_torch_datasets.py).

  * metagenome: 2 species x 20 kb (2 and 3 strains), 30x of 8 kb reads, 10%
    error, seed 0 (the full scenario: 10 species x 100 kb);
  * skewed: 3 strains x 20 kb at abundances 1.0 / 0.5 / 0.17 of 30x (the
    rare strain at 5x), seed 0 (the full scenario: 100 kb).
Only the contig length and the number of species are cut; coverage, read
length, error and abundances are the scenarios' own."""

import pytest

from scripts.torch_eval_quality import build_metagenome, build_skewed
from tests.test_torch_datasets import assert_runs_equal
from tests.torch_parity_data import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCENARIOS = {
    "metagenome": lambda root: build_metagenome(root, 0, n_species=2, length=20_000),
    "skewed": lambda root: build_skewed(root, 0, length=20_000, rare_cov=5.0),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scenario_artifacts_equal_jax(scenario, tmp_path, monkeypatch):
    asm_path, reads_path, _, n_reads, _ = SCENARIOS[scenario](str(tmp_path))
    assert n_reads > 50
    assert_runs_equal(tmp_path, monkeypatch, asm_path, reads_path)

"""The benchmark of `hairsplitter_tpu_torch` (`python3 -m benchmark.run`);
see `BENCHMARK.json` at the root of the repository and `run.py`."""

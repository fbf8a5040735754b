"""The share of each job's time, on the harness's clock around
`run_pipeline`, that no top-level program span explains: 1 - (load_inputs,
write_artifacts and the stages in `stage_stats.json`) / (end - start),
summed over the window's jobs that hold `load_inputs`. The harness's own
reads of a job's files count as unspanned."""

TOP_LEVEL = ("load_inputs", "write_artifacts", "correct_assembly", "mapping", "call_variants",
             "separate_reads", "create_new_contigs", "untangle")


def read(ctx):
    jobs = [j for j in ctx.jobs if "load_inputs" in j["stages"]]
    wall = sum(j["end"] - j["start"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 1.0 - sum(j["stages"].get(k, 0.0) for j in jobs for k in TOP_LEVEL) / wall

"""How unevenly a job spread over several processes loads them: over the
window's jobs that hold "shard.p<i>" entries in `stage_stats.json` (each
process's own seconds in stages 2-4, its collectives left out), the sum
of each job's largest over the sum of each job's mean. 1.0 is an even
load. None where no job holds them (one process, or a program without
the entries)."""


def read(ctx):
    largest = mean = 0.0
    for j in ctx.jobs:
        shards = [s for k, s in j["stages"].items() if k.startswith("shard.p")]
        if shards:
            largest += max(shards)
            mean += sum(shards) / len(shards)
    if mean <= 0:
        return None
    return largest / mean

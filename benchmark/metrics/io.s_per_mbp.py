"""Seconds of input parsing and artifact writing per Mbp of reads: the
program's `load_inputs` span (parse, sanitise, bluntify, `cut_assembly`,
quality filter, `ReadStore`) and its `write_artifacts` spans (every artifact
write outside a stage), from `stage_stats.json`, over the window's jobs that
hold them."""


def read(ctx):
    jobs = [j for j in ctx.jobs if "load_inputs" in j["stages"]]
    mbp = sum(j["read_bp"] for j in jobs) / 1e6
    if not jobs or mbp <= 0:
        return None
    return sum(j["stages"].get(p, 0.0) for j in jobs for p in ("load_inputs", "write_artifacts")) / mbp

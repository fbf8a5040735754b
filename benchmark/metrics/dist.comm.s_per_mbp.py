"""Process 0's seconds in the collectives of a job spread over several
processes, per Mbp of reads: every "comm" entry of `stage_stats.json` (a
stage's "<stage>.comm" and the top-level "comm"), each a collective's
pickling, transfer and wait for the slowest process, over the window's
jobs that hold one. None where no job does (one process, or a program
without the spans)."""


def _comm(stages: dict) -> float | None:
    found = [s for k, s in stages.items() if k == "comm" or k.endswith(".comm")]
    return sum(found) if found else None


def read(ctx):
    jobs = [(j, _comm(j["stages"])) for j in ctx.jobs]
    jobs = [(j, s) for j, s in jobs if s is not None]
    mbp = sum(j["read_bp"] for j, _ in jobs) / 1e6
    if not jobs or mbp <= 0:
        return None
    return sum(s for _, s in jobs) / mbp

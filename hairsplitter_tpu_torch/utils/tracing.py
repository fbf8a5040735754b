"""The port's span recorder: named, nested host-clock intervals with counts.

    with tracing.span("chain", reads=len(codes)) as sp:
        ...
        sp.add(jobs=n)

A span's parent is the innermost span open on its own thread, or the
`parent` it is given: a worker thread takes the span that submitted its
work that way, since `ThreadPoolExecutor` carries no context into its
workers. `job()` opens a span that starts a job: every span under it
carries its id as the job id (`pipeline/orchestrate.py:run_pipeline` opens
one per call). Times are `time.perf_counter()`, the clock onto which a
`torch.profiler` trace can be placed through an anchor.

A closed span goes into one process-wide ring (`spans()`, with the count
that fell out of it in `dropped()`), and its seconds, calls and counts are
summed by name into its parent's `children`: `StageStats` in
`pipeline/orchestrate.py` writes a stage's children to `stage_stats.json`
from there. The recorder is always on. It opens no profiler or NVTX range
and never waits for the device: a span times what the host spends in it,
device work it only enqueued included.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

RING_SIZE = 1 << 14


class Totals:
    """Seconds, calls and summed counts of one name's closed child spans."""

    __slots__ = ("seconds", "calls", "counts")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self.counts: dict[str, float] = {}


class Recorder:
    """The ring of closed spans, and how many spans have closed."""

    def __init__(self, maxlen: int = RING_SIZE):
        self.ring: collections.deque[Span] = collections.deque(maxlen=maxlen)
        self.closed = 0
        self.lock = threading.Lock()

    def dropped(self) -> int:
        return self.closed - len(self.ring)


RECORDER = Recorder()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One open or closed span; a context manager, entered once."""

    __slots__ = ("id", "parent", "job", "name", "thread", "start", "end", "counts", "children", "_up")

    def __init__(self, name: str, parent: Span | None, counts: dict, new_job: bool = False):
        self.id = next(_ids)
        self.name = name
        self._up = parent
        self.parent = parent.id if parent is not None else None
        self.job = self.id if new_job or parent is None else parent.job
        self.thread = threading.get_ident()
        self.counts = counts
        self.children: dict[str, Totals] = {}
        self.start = self.end = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def add(self, **counts) -> None:
        """Add to the span's counts (from any thread)."""
        with RECORDER.lock:
            for k, v in counts.items():
                self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self) -> Span:
        self.thread = threading.get_ident()
        _stack().append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        _stack().pop()
        up, self._up = self._up, None
        rec = RECORDER
        with rec.lock:
            if up is not None:
                tot = up.children.get(self.name)
                if tot is None:
                    tot = up.children[self.name] = Totals()
                tot.seconds += self.end - self.start
                tot.calls += 1
                for k, v in self.counts.items():
                    tot.counts[k] = tot.counts.get(k, 0) + v
            rec.closed += 1
            rec.ring.append(self)
        return False


def current() -> Span | None:
    """The innermost span open on this thread."""
    stack = _stack()
    return stack[-1] if stack else None


def span(name: str, parent: Span | None = None, **counts) -> Span:
    """A span under `parent`, or under this thread's innermost open span."""
    return Span(name, parent if parent is not None else current(), counts)


def job(name: str = "job") -> Span:
    """A span that starts a job: it and every span under it carry its id."""
    return Span(name, current(), {}, new_job=True)


def spans() -> list[Span]:
    """The closed spans still in the ring, oldest first."""
    return list(RECORDER.ring)


def dropped() -> int:
    """How many closed spans have fallen out of the ring."""
    return RECORDER.dropped()


"""The program's own spans, as the metric readers see them.

graphminer_tpu_torch keeps them in utils/profiling.py's PROFILER: a record
a closed span (its name, start and end on time.perf_counter(), the clock of
the harness's calls, and its self time), and, while torch.profiler records,
a host event a span (record_function) in the trace, on one clock with the
device's events. A program that keeps no such records (one older than its
spans) gives None here, and the readers leave their metric out.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from . import stats

PROFILING = "graphminer_tpu_torch.utils.profiling"
#: the program's span of one engine count, and its read-back child
COUNT = "count"
READBACK = "count.readback"


def _records():
    """The program's span records, or None where it keeps none."""
    prof = getattr(sys.modules.get(PROFILING), "PROFILER", None)
    read = getattr(prof, "span_records", None)
    return read() if callable(read) else None


def setup_self_s(run, name: str) -> Optional[float]:
    """The self time (s) of the program's spans `name` that lie in the
    run's set-up; None without such a span. The set-up is the setup_s
    before the end of the last span that closed before the first timed
    call: a traced run starts torch.profiler between its set-up and that
    call, which can take longer than parts of the set-up, so the call's
    start less setup_s would cut them off."""
    recs = _records()
    if recs is None or not run.calls:
        return None
    hi = run.calls[0].start
    before = [r for r in recs if r.end <= hi]
    if not before:
        return None
    lo = max(r.end for r in before) - run.setup_s
    own = [r.self_s for r in before if r.name == name and r.start >= lo]
    return sum(own) if own else None


def host_spans(run, name: str) -> List[Tuple[float, float]]:
    """The trace's host events `name` inside its window, (start, end) us."""
    tr = run.trace
    if tr is None:
        return []
    return [(s, e) for s, e, n in tr.host
            if n == name and s >= tr.lo and e <= tr.hi]


def _overlap(a, b, lo: float, hi: float) -> float:
    """Length of (union of a) ∩ (union of b) inside [lo, hi)."""
    return stats.busy(a, lo, hi) + stats.busy(b, lo, hi) - \
        stats.busy(list(a) + list(b), lo, hi)


def count_host_ms(run) -> Optional[float]:
    """The program's host path a count (ms): the time in `count` spans
    less the time of their `count.readback` children, over the counts."""
    counts = host_spans(run, COUNT)
    if not counts:
        return None
    tr = run.trace
    inside = _overlap(host_spans(run, READBACK), counts, tr.lo, tr.hi)
    return (stats.busy(counts, tr.lo, tr.hi) - inside) / len(counts) / 1e3


def idle_in_count_pct(run) -> Optional[float]:
    """Of device 0's idle time in the window, the % inside the program's
    `count` spans (the rest is the caller's, between counts)."""
    counts = host_spans(run, COUNT)
    tr = run.trace
    if not counts or 0 not in tr.device:
        return None
    idle = stats.gaps(tr.intervals(0), tr.lo, tr.hi)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    return 100.0 * _overlap(idle, counts, tr.lo, tr.hi) / total

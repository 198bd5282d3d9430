"""count_p95_ms: the 95th percentile (nearest rank) of the host-clock wall
times of every count completed in the window (ms)."""
from bench_port import stats


def read(run):
    return stats.percentile([(c.end - c.start) * 1e3 for c in run.ok_calls],
                            95)

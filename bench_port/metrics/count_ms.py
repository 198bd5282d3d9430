"""count_ms: the window's length over the counts it completed (ms)."""
from bench_port import stats


def read(run):
    return stats.window_mean_ms(run.window_s, len(run.ok_calls))

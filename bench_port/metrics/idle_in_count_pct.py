"""idle_in_count_pct: of device 0's idle time in the traced window, the %
that lies inside the program's count spans; the rest is the caller's time
between counts (bench_port/spans.py)."""
from bench_port import spans


def read(run):
    return spans.idle_in_count_pct(run)

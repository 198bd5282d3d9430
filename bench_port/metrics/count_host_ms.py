"""count_host_ms: the program's host path a count in the traced window
(ms): its count spans less their count.readback children, over the counts
(host events of the trace; bench_port/spans.py)."""
from bench_port import spans


def read(run):
    return spans.count_host_ms(run)

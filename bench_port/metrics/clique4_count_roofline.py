"""clique4_count_roofline: count_roofline of the 4-clique cells (a count's
least time on one H100 over its device time, %), a metric of its own
because it moves clique4_count_ms."""
from bench_port.metrics.count_roofline import read  # noqa: F401

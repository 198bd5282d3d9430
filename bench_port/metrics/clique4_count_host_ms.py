"""clique4_count_host_ms: count_host_ms of the 4-clique cells (the
program's host path a count, ms), a metric of its own because it moves
clique4_count_ms."""
from bench_port.metrics.count_host_ms import read  # noqa: F401

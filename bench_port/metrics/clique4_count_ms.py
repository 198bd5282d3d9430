"""clique4_count_ms: count_ms of the 4-clique cells: the window's length over
the counts it completed (ms). A metric of its own, so that its cells are
held to a bound set from their own spread and not from the triangle cells'."""
from bench_port.metrics.count_ms import read  # noqa: F401

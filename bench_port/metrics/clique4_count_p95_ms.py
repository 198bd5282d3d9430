"""clique4_count_p95_ms: count_p95_ms of the 4-clique cells: the 95th
percentile (nearest rank) of the wall times of every count completed in the
window (ms). A metric of its own, so that its cells are held to a bound set
from their own spread and not from the triangle cells'."""
from bench_port.metrics.count_p95_ms import read  # noqa: F401

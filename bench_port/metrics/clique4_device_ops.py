"""clique4_device_ops: device_ops of the 4-clique cells (device events a
count in the traced window), a metric of its own because it moves
clique4_count_ms."""
from bench_port.metrics.device_ops import read  # noqa: F401

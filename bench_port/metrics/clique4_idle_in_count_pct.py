"""clique4_idle_in_count_pct: idle_in_count_pct of the 4-clique cells (the %
of device 0's idle time inside the program's count spans), a metric of its
own because it moves clique4_count_ms."""
from bench_port.metrics.idle_in_count_pct import read  # noqa: F401

"""The benchmark of graphminer_tpu_torch (see bench_port/run.py)."""

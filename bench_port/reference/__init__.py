"""The benchmark's yardstick: the Graph500 generator and the plain exact
counters that decide `correct`. Plain NumPy and PyTorch only: nothing here
imports graphminer_tpu_torch, the JAX package or JAX."""

"""graphminer_tpu_torch — the PyTorch and CUDA port of graphminer_tpu.

A second package beside the JAX one (which stays the reference). It runs the
exact triangle-count fast path — the stream, ring and hub-core engines —
and the probe scripts of scripts/ on an NVIDIA H100 through hand-written
CUDA kernels for sm_90a (csrc/), and on the CPU through their plain PyTorch
versions. It imports torch and never
jax. Counts accumulate in int64; there is no global x64 switch and no
compile cache. ROADMAP.md lists what is still to be ported.
"""
from .core.graph import HostGraph  # noqa: F401
from .io.loader import load_graph, save_graph  # noqa: F401

__version__ = "0.1.0"

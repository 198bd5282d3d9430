"""graphminer_tpu_torch — the PyTorch and CUDA port of graphminer_tpu.

A second package beside the JAX one (which stays the reference), with its
capability set: triangle counting (the generic set-operation path, the
stream, ring, hub-core, hybrid and dense-core engines), k-cliques, subgraph
listing (generic and the fast diamond, 4-cycle and house engines), k-motifs,
SC, FSM, GQL queries and keyword search, the probe scripts of scripts/, and
scale-out (sharded counting over a mesh of cards, induced halo partitions,
and a count over several processes with torch.distributed), all behind the
same CLI verbs. It runs on an NVIDIA H100 through hand-written CUDA kernels
for sm_90a (csrc/), and on the CPU through their plain PyTorch versions. It
imports torch and never jax. Counts accumulate in int64; there is no global
x64 switch and no compile cache.
"""
from .core.graph import HostGraph  # noqa: F401
from .core.device_graph import DeviceGraph  # noqa: F401
from .io.loader import load_graph, save_graph  # noqa: F401

__version__ = "0.1.0"

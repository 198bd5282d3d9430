"""Typed runtime configuration.

Replaces the reference's three config tiers (SURVEY §5): compile-time macros
(defines.h USE_DAG/USE_CMAP/...), Makefile feature flags (common.mk:54-118),
and positional CLI args — one dataclass; algorithm switches are runtime
strategy choices here because JAX recompiles per (shape, flag) anyway.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # execution strategy (replaces USE_DAG / EDGE_PAR / VERTEX_PAR / CTA)
    engine: str = "compact"           # "compact" | "map"
    backend: str = "auto"             # setops backend: "auto" | "bc" | "bs"
    bucketed: bool = True             # degree-class task partitioning
    dense_core: int = 16384           # MXU core size (0 = disable hybrid)

    # shapes
    chunk: int = 16384                # edge tasks per device chunk
    sub: Optional[int] = None         # frontier sub-chunk (default = chunk)
    width: Optional[int] = None       # override adjacency tile width

    # memory
    table_budget: int = 6 << 30       # padded adjacency table ceiling (bytes)

    # distribution
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("host", "chip")

    # io
    mmap: bool = False                # out-of-core host loading
    use_native: bool = True           # C++ preprocessing library

    @staticmethod
    def from_env(prefix: str = "GRAPHMINER_") -> "Config":
        cfg = Config()
        for f in dataclasses.fields(Config):
            v = os.environ.get(prefix + f.name.upper())
            if v is None:
                continue
            if f.name in ("chunk", "sub", "width", "dense_core", "table_budget"):
                setattr(cfg, f.name, int(v))
            elif f.name in ("bucketed", "mmap", "use_native"):
                setattr(cfg, f.name, v.lower() in ("1", "true", "yes"))
            else:
                setattr(cfg, f.name, v)
        return cfg


DEFAULT = Config()

"""Preprocessing artifact persistence.

The counterpart of graphminer_tpu/io/cache.py. The reference's .bin graph
format doubles as its preprocessing checkpoint (src/common/graph.cc:4-124;
README.md:83-103). Here relabeled/oriented CSR graphs are cached as .npz
keyed by content parameters, so a second run skips the host preprocessing.
Left out: enable_compile_cache — PyTorch runs eagerly and has no XLA
executables to cache.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

DEFAULT_DIR = os.environ.get("GRAPHMINER_CACHE",
                             os.path.join(os.path.dirname(__file__),
                                          "..", "..", "graph_cache"))


def _path(key: str, cache_dir: Optional[str] = None) -> str:
    d = os.path.abspath(cache_dir or DEFAULT_DIR)
    os.makedirs(d, exist_ok=True)
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
    return os.path.join(d, safe + ".npz")


def save_graph(key: str, g, cache_dir: Optional[str] = None) -> str:
    """Persist a HostGraph (CSR + labels + flags) under `key`."""
    p = _path(key, cache_dir)
    arrs = dict(rowptr=g.rowptr, colidx=g.colidx,
                is_dag=np.array([g.is_dag]))
    if g.vlabels is not None:
        arrs["vlabels"] = g.vlabels
    if g.elabels is not None:
        arrs["elabels"] = g.elabels
    tmp = p + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, p)
    return p


def load_graph(key: str, cache_dir: Optional[str] = None):
    """Load a cached HostGraph, or None on miss."""
    from ..core.graph import HostGraph
    p = _path(key, cache_dir)
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        return HostGraph(rowptr=z["rowptr"], colidx=z["colidx"],
                         vlabels=z["vlabels"] if "vlabels" in z else None,
                         elabels=z["elabels"] if "elabels" in z else None,
                         is_dag=bool(z["is_dag"][0]), name=key)


def cached_graph(key: str, build, cache_dir: Optional[str] = None):
    """load_graph(key) or build-and-save. `build` is a zero-arg callable."""
    g = load_graph(key, cache_dir)
    if g is not None:
        return g
    g = build()
    save_graph(key, g, cache_dir)
    return g

"""Triangles by graphminer_tpu_torch.ops.hybrid.HybridEngine: set-up relabels
and orients the graph (span "prep") and builds the engine's ring core
table and sub-core stream (span "build"); a count is one launch of kernel B
and one of kernel A and the int64 sum read back."""
from __future__ import annotations

from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.ops.hybrid import HybridEngine


def prepare(rowptr, colidx, config, devices, span):
    g = HostGraph(rowptr=rowptr, colidx=colidx)
    with span("prep"):
        rg = g.relabel_by_degree(descending=False).orientation()
    with span("build", devices):
        eng = HybridEngine(rg, device=devices[0],
                           **config.get("entry_args", {}))
    return eng

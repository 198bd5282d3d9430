"""Binary graph format IO.

Reads/writes the GraphMiner on-disk format so reference inputs and golden
tables work unchanged (reference: src/common/graph.cc:4-124, README.md:83-103):

  <prefix>.meta.txt    : n_vertices \n n_edges \n vid_size eid_size vlabel_size
                         elabel_size \n max_degree \n feat_len \n
                         num_vertex_classes \n num_edge_classes
  <prefix>.vertex.bin  : int64 rowptr[V+1]
  <prefix>.edge.bin    : int32 colidx[E]
  <prefix>.vlabel.bin  : uint8 vlabel[V]           (optional)
  <prefix>.elabel.bin  : uint16/int32 elabel[E]    (optional)

Uses np.memmap for out-of-core loading of the big arrays (the analogue of the
reference's map_file path, include/custom_alloc.h:33-56).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..types import VID_DTYPE, EID_DTYPE, VLABEL_DTYPE


@dataclass
class GraphMeta:
    n_vertices: int
    n_edges: int
    vid_size: int = 4
    eid_size: int = 8
    vlabel_size: int = 1
    elabel_size: int = 2
    max_degree: int = 0
    feat_len: int = 0
    num_vertex_classes: int = 0
    num_edge_classes: int = 0


def read_meta(prefix: str) -> GraphMeta:
    with open(prefix + ".meta.txt") as f:
        tokens = f.read().split()
    it = iter(tokens)
    vals = [int(next(it)) for _ in range(10)]
    return GraphMeta(
        n_vertices=vals[0], n_edges=vals[1], vid_size=vals[2], eid_size=vals[3],
        vlabel_size=vals[4], elabel_size=vals[5], max_degree=vals[6],
        feat_len=vals[7], num_vertex_classes=vals[8], num_edge_classes=vals[9],
    )


def load_graph(prefix: str, use_vlabel: bool = False, use_elabel: bool = False,
               mmap: bool = False):
    """Load a graph in the reference binary format; returns a HostGraph."""
    from ..core.graph import HostGraph

    meta = read_meta(prefix)
    mode = "r" if mmap else None
    if mmap:
        rowptr = np.memmap(prefix + ".vertex.bin", dtype=EID_DTYPE, mode=mode)
        colidx = np.memmap(prefix + ".edge.bin", dtype=VID_DTYPE, mode=mode)
    else:
        rowptr = np.fromfile(prefix + ".vertex.bin", dtype=EID_DTYPE)
        colidx = np.fromfile(prefix + ".edge.bin", dtype=VID_DTYPE)
    assert rowptr.shape[0] == meta.n_vertices + 1, (
        f"rowptr size {rowptr.shape[0]} != V+1 {meta.n_vertices + 1}")
    assert colidx.shape[0] == meta.n_edges, (
        f"colidx size {colidx.shape[0]} != E {meta.n_edges}")

    vlabels = None
    if use_vlabel and os.path.exists(prefix + ".vlabel.bin"):
        vlabels = np.fromfile(prefix + ".vlabel.bin", dtype=VLABEL_DTYPE)
        assert vlabels.shape[0] == meta.n_vertices

    elabels = None
    if use_elabel and os.path.exists(prefix + ".elabel.bin"):
        # elabel on-disk width comes from meta (reference uses 2 or 4 bytes).
        edt = {1: np.uint8, 2: np.uint16, 4: np.int32}[meta.elabel_size]
        elabels = np.fromfile(prefix + ".elabel.bin", dtype=edt)
        assert elabels.shape[0] == meta.n_edges

    name = os.path.basename(os.path.dirname(os.path.abspath(prefix)))
    return HostGraph(rowptr=np.asarray(rowptr), colidx=np.asarray(colidx),
                     vlabels=vlabels, elabels=elabels, meta=meta, name=name)


def save_graph(g, prefix: str) -> None:
    """Write a HostGraph in the reference binary format."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    g.rowptr.astype(EID_DTYPE).tofile(prefix + ".vertex.bin")
    g.colidx.astype(VID_DTYPE).tofile(prefix + ".edge.bin")
    nvc, nec, vls, els = 0, 0, 1, 2
    if g.vlabels is not None:
        g.vlabels.astype(VLABEL_DTYPE).tofile(prefix + ".vlabel.bin")
        nvc = int(np.unique(g.vlabels).size)
    if g.elabels is not None:
        g.elabels.tofile(prefix + ".elabel.bin")
        els = g.elabels.dtype.itemsize
        nec = int(np.unique(g.elabels).size)
    with open(prefix + ".meta.txt", "w") as f:
        f.write(f"{g.n_vertices}\n{g.n_edges}\n4 8 {vls} {els}\n"
                f"{g.max_degree}\n0\n{nvc}\n{nec}\n")

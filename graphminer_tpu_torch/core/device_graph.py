"""Device-resident CSR graph (the GraphGPU analogue, reference
include/graph_gpu.h:6-324).

The counterpart of graphminer_tpu/core/device_graph.py, as a plain class of
device tensors. Two layouts, chosen by memory budget:

* padded 2D adjacency table [V, Wpad] (SENTINEL-padded, sorted rows) — the
  default. Adjacency access is then a row gather (index_select).
  Memory = V·Wpad·4 bytes.
* flat CSR (rowptr/colidx) fallback for graphs whose padded table exceeds the
  budget — an element gather per slot.

The table is built on the device from the flat CSR (E ints cross the bus,
not V·Wpad). Rows are sorted ascending with SENTINEL tails, the invariant
every set operation relies on. Index tensors are int32 throughout;
index_select takes them as they are.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..types import LANE, SENTINEL, round_up

# Default ceiling for the padded table (bytes). Above this, keep flat CSR.
DEFAULT_TABLE_BUDGET = 6 << 30


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array (task ids, candidate lists) as an int32 tensor on
    `device`."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(
        device)


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[idx] for an int32 index tensor of any shape."""
    return flat.index_select(0, idx.reshape(-1)).view(idx.shape)


def _build_table(rowptr: torch.Tensor, colidx: torch.Tensor,
                 deg: torch.Tensor, *, wpad: int, epad: int,
                 fill: int = int(SENTINEL)) -> torch.Tensor:
    """[V, wpad] rows of colidx; slots past deg read the padding slot epad-1
    and are then overwritten by fill."""
    offs = torch.arange(wpad, dtype=torch.int32, device=deg.device)[None, :]
    idx = rowptr[:-1, None] + offs
    valid = offs < deg[:, None]
    rows = _take(colidx, torch.where(valid, idx, epad - 1))
    return torch.where(valid, rows, fill)


def _pad_width(max_degree: int) -> int:
    if max_degree <= 8:
        return 8
    if max_degree <= 64:
        return round_up(max_degree, 8)
    return round_up(max_degree, LANE)


class DeviceGraph:
    """The graph's CSR, degrees, optional padded table and labels as device
    tensors (int32)."""

    def __init__(self, rowptr, colidx, deg, adj_table, vlabels, elabels=None,
                 elab_table=None, n_vertices: int = 0, n_edges: int = 0,
                 max_degree: int = 0):
        self.rowptr = rowptr          # int32 [V+1]
        self.colidx = colidx          # int32 [Epad] (SENTINEL padded)
        self.deg = deg                # int32 [V]
        self.adj_table = adj_table    # int32 [V, Wpad] or None
        self.vlabels = vlabels        # int32 [V] or None
        self.elabels = elabels        # int32 [Epad] flat, -1 padded
        self.elab_table = elab_table  # int32 [V, Wpad] aligned with adj
        self.n_vertices = n_vertices
        self.n_edges = n_edges
        self.max_degree = max_degree

    @staticmethod
    def from_host(g, device: DeviceLike = "cuda",
                  table_budget: int = DEFAULT_TABLE_BUDGET,
                  use_table: Optional[bool] = None) -> "DeviceGraph":
        if g.n_edges >= 2**31:
            raise ValueError("device graph must have E < 2^31; partition "
                             "first")
        dev = resolve_device(device)
        rowptr = g.rowptr.astype(np.int32)
        epad = max(round_up(g.n_edges, LANE), LANE)
        colidx = np.full(epad, SENTINEL, dtype=np.int32)
        colidx[: g.n_edges] = g.colidx
        deg = np.diff(g.rowptr).astype(np.int32)

        maxdeg = g.max_degree
        wpad = _pad_width(max(1, maxdeg))
        if use_table is None:
            use_table = g.n_vertices * wpad * 4 <= table_budget

        vlab = None
        if g.vlabels is not None:
            vlab = g.vlabels.astype(np.int32)
        elab = None
        if g.elabels is not None:
            elab = np.full(epad, -1, dtype=np.int32)
            elab[: g.n_edges] = g.elabels

        put = lambda x: (torch.from_numpy(x).to(dev) if x is not None
                         else None)
        rowptr_d, colidx_d, deg_d = put(rowptr), put(colidx), put(deg)
        elab_d = put(elab)
        table = etable = None
        if use_table:
            table = _build_table(rowptr_d, colidx_d, deg_d, wpad=wpad,
                                 epad=epad)
            if elab_d is not None:
                etable = _build_table(rowptr_d, elab_d, deg_d, wpad=wpad,
                                      epad=epad, fill=-1)
        return DeviceGraph(rowptr=rowptr_d, colidx=colidx_d, deg=deg_d,
                           adj_table=table, vlabels=put(vlab),
                           elabels=elab_d, elab_table=etable,
                           n_vertices=g.n_vertices, n_edges=g.n_edges,
                           max_degree=maxdeg)

    def _safe(self, vs: torch.Tensor):
        """(ids clamped into [0, V), mask of the ids inside [0, V))."""
        return (vs.clamp(0, max(self.n_vertices - 1, 0)),
                (vs >= 0) & (vs < self.n_vertices))

    def labels_of(self, vs: torch.Tensor) -> torch.Tensor:
        """Vertex labels (any shape of ids) with -1 for invalid/padded ids."""
        assert self.vlabels is not None
        vs_safe, valid = self._safe(vs)
        return torch.where(valid, _take(self.vlabels, vs_safe), -1)

    def _rows(self, table, flat, fill: int, vs: torch.Tensor,
              width: int) -> torch.Tensor:
        vs_safe, valid_v = self._safe(vs)
        if table is not None:
            wpad = table.shape[1]
            rows = torch.where(valid_v[:, None],
                               table.index_select(0, vs_safe), fill)
            if width <= wpad:
                return rows[:, :width]
            return torch.cat([rows, rows.new_full(
                (rows.shape[0], width - wpad), fill)], dim=1)
        # flat CSR fallback: element gather
        start = _take(self.rowptr, vs_safe)
        d = torch.where(valid_v, _take(self.deg, vs_safe), 0)
        offs = torch.arange(width, dtype=torch.int32, device=vs.device)
        idx = start[:, None] + offs[None, :]
        valid = offs[None, :] < d[:, None]
        rows = _take(flat, torch.where(valid, idx, flat.shape[0] - 1))
        return torch.where(valid, rows, fill)

    def gather_rows(self, vs: torch.Tensor, width: int) -> torch.Tensor:
        """Padded adjacency tiles: [B, width] int32, SENTINEL beyond deg(v).

        vs entries that are out of range (e.g. SENTINEL task padding) yield
        all-SENTINEL rows. Rows are sorted ascending (SENTINEL at the end).
        Vertices with deg > width are truncated — callers pick `width` from
        the degree bucket they are processing.
        """
        return self._rows(self.adj_table, self.colidx, int(SENTINEL), vs,
                          width)

    def gather_elabel_rows(self, vs: torch.Tensor, width: int) -> torch.Tensor:
        """Edge labels aligned with gather_rows: [B, width] int32 where
        entry j is the label of edge (v, gather_rows(v)[j]); -1 beyond
        deg(v) or for invalid v."""
        assert self.elabels is not None
        return self._rows(self.elab_table, self.elabels, -1, vs, width)

    def degree_of(self, vs: torch.Tensor) -> torch.Tensor:
        vs_safe, valid = self._safe(vs)
        return torch.where(valid, _take(self.deg, vs_safe), 0)

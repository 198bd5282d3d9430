"""Hub-bitmap layout shared by the stream and ring engines.

The counterpart of graphminer_tpu/ops/hubcore.py's HubLayout and
build_hub_layout (hubcore.py:69-121). Vertices are relabeled ascending by
degree and the graph oriented toward higher (degree, id) (graph.cc:233-279
semantics), so every out-edge points to a HIGHER id and the core [V-C, V)
is closed under out-neighbors. Each vertex row of the device table is

    [ CB: words int32 — bitmap of N+(v) ∩ core over the core universe
    | T : wt_pad int32 slots — N+(v) \\ core, sorted, SENTINEL padded ]

and for an edge (u, v): |N+(u) ∩ N+(v)| = popcount(CB[u] & CB[v]) +
|T[u] ∩ T[v]|. The table is built on the host in numpy exactly as the
reference builds it (uint32 words, bit 31 set for core-local ids ≡ 31 mod
32, viewed as int32) and then moved to the device as an int32 tensor.

Not here yet: TriangleEngine, bucket_tail_tasks and pack_groups (see
ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..types import SENTINEL, cdiv, round_up

DEFAULT_CORE = 4096


@dataclasses.dataclass(frozen=True)
class HubLayout:
    """Device-resident hub-bitmap table for a degree-ascending oriented DAG."""
    table: torch.Tensor     # int32 [V, words + wt_pad]
    words: int              # core bitmap words (= padded C/32)
    core_start: int         # cs; core = ids [cs, V)
    core_size: int          # C = V - cs
    wt_pad: int             # padded T width (0 if no vertex has a tail)
    t_width: np.ndarray     # host int32 [V] — true T width per vertex
    n_vertices: int

    @property
    def row_width(self) -> int:
        return self.words + self.wt_pad


def build_hub_layout(g, core: int = DEFAULT_CORE,
                     device: DeviceLike = "cuda") -> HubLayout:
    """g must be relabel_by_degree(descending=False).orientation() output."""
    assert g.is_dag, "hub layout requires the oriented DAG"
    dev = resolve_device(device)
    v = g.n_vertices
    c = min(core, v)
    cs = v - c
    words = round_up(max(1, cdiv(c, 32)), 8)

    deg = np.diff(g.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    col = g.colidx.astype(np.int64)

    is_core_nb = col >= cs
    # T width per vertex = # out-neighbors below cs. Rows are sorted
    # ascending and core ids are the largest, so T is the row PREFIX.
    t_width = np.bincount(src[~is_core_nb], minlength=v).astype(np.int32)
    wt_max = int(t_width.max(initial=0))
    wt_pad = round_up(max(8, wt_max), 8) if wt_max else 0

    table = np.zeros((v, words + wt_pad), dtype=np.uint32)
    cu = src[is_core_nb]
    cc = col[is_core_nb] - cs
    np.bitwise_or.at(table, (cu, cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    if wt_pad:
        tpart = np.full((v, wt_pad), SENTINEL, dtype=np.int32)
        tu = src[~is_core_nb]
        tv = col[~is_core_nb].astype(np.int32)
        row_starts = np.concatenate(
            [[0], np.cumsum(t_width, dtype=np.int64)[:-1]])
        slot = np.arange(tu.shape[0], dtype=np.int64) - row_starts[tu]
        tpart[tu, slot] = tv
        table[:, words:] = tpart.view(np.uint32)

    table_d = torch.from_numpy(table.view(np.int32)).to(dev)
    return HubLayout(table=table_d, words=words, core_start=cs, core_size=c,
                     wt_pad=wt_pad, t_width=t_width, n_vertices=v)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words read as uint32, as int64.

    Torch has no popcount op, sign-extends int32 on widening and shifts
    int32 arithmetically, so the word is widened to int64 and masked to
    its low 32 bits before the SWAR reduction (bit 31 counts as one bit)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF

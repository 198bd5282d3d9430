"""Plan-interpreting frontier engine.

The counterpart of graphminer_tpu/engine/frontier.py. It executes a
core.plan.Plan over chunks of edge tasks — the reference's two execution
strategies in one engine:

* the generated DFS nested loops (src/*/cpu_kernels/*.h,
  clique4_warp_edge.cuh) become a recursion over plan levels, one batched
  chunk of embeddings per step instead of one embedding per warp;
* the Pangolin BFS extend (extend_alloc → scan → extend_insert,
  src/pangolin/clique/base.cu:16-226) becomes the level-expansion primitive:
  the live slots of candidate tiles [B, W] are listed by torch.nonzero into
  a dense frontier at its exact size, which is consumed in sub-chunks of
  `sub` rows — so deep levels do O(#live embeddings) work, not
  O(B · W^depth).

A dead embedding is marked by SENTINEL in its newest vertex slot and
contributes exactly 0 everywhere. Rows of vertices matched at level >= 2
are gathered at the full width wf, never truncated. Counts are int64 from
the first sum onward and stay on the device until the caller reads the
total. The engine runs torch ops only (set algebra: ops/setops.py); the one
host sync a level needs is nonzero's, for the frontier's size.

Two engines are kept:
  engine="compact"  (default) — nonzero compaction + sub-chunked descent
  engine="map"      — a loop over candidate slot columns with no
                      compaction (dead slots stay and add 0); simple, the
                      differential reference in tests. It takes
                      MAP_ROWS // B slot columns a step (lax.map with a
                      batch size), so a step holds at most about MAP_ROWS
                      embeddings.

Left out: jit and lax.map/while_loop with their fixed shapes, the
cumsum+scatter into a fixed [B·W] buffer (nonzero gives the live slots
directly) and the shard_map carry trick.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device_graph import DeviceGraph, to_device
from ..core.plan import Level, Plan
from ..device import DeviceLike, resolve_device
from ..ops import setops
from ..types import SENTINEL as _SENTINEL
from ..utils.exec import pad_to_chunks, sum_chunked

SENTINEL = int(_SENTINEL)
#: most embeddings one step of the map engine holds (B rows x slot columns)
MAP_ROWS = 1 << 16


def _build_candidates(dg: DeviceGraph, lp: Level, verts: List[torch.Tensor],
                      sets: Dict[int, torch.Tensor], width: int,
                      backend: str, cand: Optional[torch.Tensor] = None,
                      idx: int = 0, wf: Optional[int] = None,
                      cand_sets: Optional[Dict[int, torch.Tensor]] = None):
    """Candidate tile C [B, w] for the next vertex + optional upper bound.
    Rows of dead embeddings (newest vertex == SENTINEL) come out all-SENTINEL.

    width: tile width for rows of the edge-task endpoints v0/v1 (and sets
    derived from them) — the task's degree class under bucketed execution.
    wf: full width for rows of deeper vertices (candidates can be hubs of any
    degree, so their rows must never be truncated); defaults to width.
    cand: optional [k, V] int8 per-query-vertex candidate bitmap (the query
    workload's GQL/NLF filter, filter.cc parity) — candidates with
    cand[idx][v] == 0 are masked out."""
    wf = wf or width

    def row_w(j: int) -> int:
        return width if j < 2 else wf

    kind, j = lp.source
    if kind == 'adj':
        c = dg.gather_rows(verts[j], row_w(j))
    elif kind == 'cand':
        # candidate-set-indexed execution (query_plan.h:10 GQL ordering):
        # iterate the small GLOBAL filtered candidate list of this level and
        # probe adjacency, instead of gathering full rows and masking
        c = cand_sets[j][None, :].expand(verts[0].shape[0], -1)
    else:
        c = sets[j]
    for j in lp.intersect:
        c = setops.intersect(c, dg.gather_rows(verts[j], row_w(j)),
                             backend=backend)
    for j in lp.difference:
        c = setops.difference(c, dg.gather_rows(verts[j], row_w(j)),
                              backend=backend)
    if lp.exclude:
        anc = torch.stack([verts[j] for j in lp.exclude], dim=1)
        c = setops.exclude(c, anc)
    if lp.vlabel is not None:
        c = torch.where(dg.labels_of(c) == lp.vlabel, c, SENTINEL)
    if cand is not None:
        v = cand.shape[1]
        ok = cand[idx].index_select(0, c.clamp(0, v - 1).reshape(-1)
                                    ).view(c.shape) != 0
        c = torch.where(ok & (c != SENTINEL), c, SENTINEL)
    if lp.lbound:  # symmetry order v > max(v_j) (vertex_gen.py:83-100)
        lower = functools.reduce(torch.maximum, [verts[j] for j in lp.lbound])
        c = torch.where(c > lower[:, None], c, SENTINEL)
    upper = None
    if lp.bound:
        upper = functools.reduce(torch.minimum, [verts[j] for j in lp.bound])
    dead = verts[-1][:, None] == SENTINEL
    c = torch.where(dead, SENTINEL, c)
    return c, upper


def _is_pair_collapse(plan: Plan, idx: int) -> bool:
    """True when level idx stores a set S and the final level just
    re-enumerates S with bound v_{idx} (ordered pairs inside S) — then
    Σ_{v∈S} |{u ∈ S : u < v}| = n(n-1)/2 with n = |S|. (The diamond
    shortcut — reference counts these pairs explicitly, diamond.h:7-11.)"""
    if idx != plan.k - 2:              # level idx must be second-to-last
        return False
    lvl = idx - 2
    nxt = plan.levels[lvl + 1]
    cur = plan.levels[lvl]
    return (cur.store and nxt.source == ('set', idx)
            and nxt.bound == (idx,) and not nxt.intersect
            and not nxt.difference and not nxt.exclude)


def _final_count(c: torch.Tensor, upper,
                 last_vert: torch.Tensor) -> torch.Tensor:
    cnt = setops.count_valid(c, upper).to(torch.int64)
    return torch.where(last_vert == SENTINEL, 0, cnt)


def _pairs(c: torch.Tensor) -> torch.Tensor:
    n = setops.count_valid(c).to(torch.int64)
    return n * (n - 1) // 2


# --------------------------------------------------------------------------
# engine = "map": slot columns, no compaction (reference engine)
# --------------------------------------------------------------------------

def _descend_map(dg, plan, idx, verts, sets, width, backend,
                 cand=None, wf=None, cand_sets=None) -> torch.Tensor:
    """int64 [B] counts of the embeddings that extend each row."""
    lp = plan.levels[idx - 2]
    c, upper = _build_candidates(dg, lp, verts, sets, width, backend,
                                 cand, idx, wf, cand_sets)

    if idx == plan.k - 1:
        return _final_count(c, upper, verts[-1])

    if upper is not None:
        c = setops.bounded(c, upper)

    if _is_pair_collapse(plan, idx):
        return _pairs(c)

    # pack each row's live slots to the left (SENTINEL sorts last) and cut
    # the tile to its widest row: slot order means nothing to the set ops
    c = c.sort(dim=1).values
    c = c[:, :int(setops.count_valid(c).max())]
    if lp.store:
        sets = dict(sets)
        sets[idx] = c

    b, w = c.shape
    out = torch.zeros(b, dtype=torch.int64, device=c.device)
    step = max(1, MAP_ROWS // max(b, 1))
    for j0 in range(0, w, step):
        # slot columns j0..j1 as one batch, slot-major: row s*b + i is
        # (embedding i, its candidate in slot j0 + s)
        g = min(step, w - j0)
        col = c[:, j0:j0 + g].t().reshape(-1)
        rep = lambda t: t.repeat((g,) + (1,) * (t.dim() - 1))
        cnt = _descend_map(dg, plan, idx + 1, [rep(v) for v in verts] + [col],
                           {k: rep(s) for k, s in sets.items()}, width,
                           backend, cand, wf, cand_sets)
        out += torch.where(col == SENTINEL, 0, cnt).view(g, b).sum(dim=0)
    return out


# --------------------------------------------------------------------------
# engine = "compact": nonzero frontier compaction + sub-chunked descent
# --------------------------------------------------------------------------

def _descend_compact(dg, plan, idx, emb, sets, width, sub, backend,
                     cand=None, wf=None, cand_sets=None) -> torch.Tensor:
    """emb: [B, idx] embeddings (row = (v0..v_{idx-1})); returns an int64
    0-d tensor."""
    verts = [emb[:, j] for j in range(idx)]
    lp = plan.levels[idx - 2]
    c, upper = _build_candidates(dg, lp, verts, sets, width, backend,
                                 cand, idx, wf, cand_sets)

    if idx == plan.k - 1:
        return _final_count(c, upper, verts[-1]).sum()

    if upper is not None:
        c = setops.bounded(c, upper)

    if _is_pair_collapse(plan, idx):
        return _pairs(c).sum()

    if lp.store:
        sets = dict(sets)
        sets[idx] = c

    # the extend step: live slots in row-major order (the host sync)
    parents, slots = torch.nonzero(c != SENTINEL, as_tuple=True)
    vflat = c[parents, slots]
    total = torch.zeros((), dtype=torch.int64, device=c.device)
    for s in range(0, vflat.shape[0], sub):
        ps = parents[s:s + sub]
        new_emb = torch.cat([emb[ps], vflat[s:s + sub, None]], dim=1)
        new_sets = {l: t[ps] for l, t in sets.items()}
        total += _descend_compact(dg, plan, idx + 1, new_emb, new_sets,
                                  width, sub, backend, cand, wf, cand_sets)
    return total


# --------------------------------------------------------------------------
# entry points and their chunk loops
# --------------------------------------------------------------------------

def _count_device_map(dg: DeviceGraph, src, dst, cand=None, cand_sets=None,
                      *, plan: Plan, width: int, chunk: int, backend: str,
                      wf: Optional[int] = None) -> torch.Tensor:
    def fn(s, d):
        return _descend_map(dg, plan, 2, [s, d], {}, width, backend, cand,
                            wf, cand_sets)
    return sum_chunked(fn, (src, dst), chunk)


def _count_device_compact(dg: DeviceGraph, src, dst, cand=None,
                          cand_sets=None, *, plans, width: int, chunk: int,
                          sub: int, backend: str,
                          wf: Optional[int] = None) -> torch.Tensor:
    """Evaluate one plan, or several over the same edge-task chunks (the
    analogue of the reference's fused multi-counter motif DFS,
    src/motif/gpu_kernels/ automine_5motif, 21 counters in one kernel:
    the graph, task list and chunking are shared). Returns int64
    [len(plans)] on the device."""
    srcs, dsts = pad_to_chunks((src, dst), chunk)
    total = torch.zeros(len(plans), dtype=torch.int64, device=src.device)
    for s, d in zip(srcs, dsts):
        emb = torch.stack([s, d], dim=1)
        total += torch.stack([
            _descend_compact(dg, p, 2, emb, {}, width, sub, backend, cand,
                             wf, cand_sets) for p in plans])
    return total


def _width_groups(g, src, dst, wf: int):
    """Tasks sorted by the width class of max(deg(src), deg(dst)):
    (src, dst, [(begin, end, width)] of the non-empty classes)."""
    from ..utils.bucketing import width_class
    deg = np.diff(g.rowptr)
    cls, widths = width_class(np.maximum(deg[src], deg[dst]), wf)
    order = np.argsort(cls, kind="stable")
    src, dst, cls = src[order], dst[order], cls[order]
    bounds = np.searchsorted(cls, np.arange(len(widths) + 1))
    return src, dst, [(int(bounds[ci]), int(bounds[ci + 1]), widths[ci])
                      for ci in range(len(widths))
                      if bounds[ci] < bounds[ci + 1]]


def count_patterns_fused(g, plans, chunk: int = 2048,
                         sub: Optional[int] = None, backend: str = "auto",
                         bucketed: Optional[bool] = None,
                         device: DeviceLike = "cuda") -> list:
    """Count many patterns in shared passes: plans are grouped by their
    edge-task shape (symmetry breaking / DAG use); each group shares host
    prep, the device graph, the task list and one multi-plan pass per width
    class. Returns counts aligned with `plans`."""
    from ..utils.bucketing import pick_chunk
    from ..utils.profiling import PROFILER
    dev = resolve_device(device)
    out = [None] * len(plans)
    groups = {}
    for i, p in enumerate(plans):
        groups.setdefault((p.use_dag, p.edge_sym_break), []).append(i)
    for (use_dag, sym), idxs in groups.items():
        gg = g.orientation() if use_dag and not g.is_dag else g
        dg = DeviceGraph.from_host(gg, device=dev)
        src, dst = gg.edge_list(sym_break=sym)
        wf = max(8, gg.max_degree)
        group_plans = tuple(plans[i] for i in idxs)
        PROFILER.count("edge_tasks", int(src.shape[0]) * len(group_plans))
        buck = bucketed if bucketed is not None else wf > 64

        def run(s, d, w, ck):
            return _count_device_compact(dg, to_device(s, dev),
                                         to_device(d, dev),
                                         plans=group_plans, width=w,
                                         chunk=ck, sub=sub or ck,
                                         backend=backend, wf=wf)

        with PROFILER.span("device_count", dev, hot=True):
            if not buck:
                totals = run(src, dst, wf, chunk)
            else:
                src, dst, spans = _width_groups(gg, src, dst, wf)
                totals = torch.zeros(len(group_plans), dtype=torch.int64,
                                     device=dev)
                for b, e, w in spans:
                    totals += run(src[b:e], dst[b:e], w,
                                  pick_chunk(e - b, max_chunk=chunk))
            totals = totals.tolist()
        for j, i in enumerate(idxs):
            out[i] = int(totals[j]) // plans[i].multiplicity
    return out


def count_pattern(g, plan: Plan, chunk: int = 2048, sub: Optional[int] = None,
                  backend: str = "auto", width: Optional[int] = None,
                  engine: str = "compact", cand=None,
                  bucketed: Optional[bool] = None,
                  cand_sets: Optional[Dict[int, np.ndarray]] = None,
                  tasks=None, device: DeviceLike = "cuda") -> int:
    """End-to-end: host preprocessing per the plan, then chunked device count.

    bucketed=True groups edge tasks by the degree class of their endpoints
    and runs one fixed-width variant per class — candidate tiles then track
    the task's real degrees instead of max_degree (the reference's
    warp/CTA strategy dispatch, common.mk:73-74,100-104 and
    rectangle_nested_balanced.cuh work distribution). Rows of deeper-level
    vertices are still gathered at full width (wf) for exactness. Defaults
    to on when the graph's max degree is > 64 and no width is given.

    cand: optional numpy bool/int8 [k, V] candidate matrix (query workload's
    GQL/NLF/k-core filter) — restricts both the edge-task list (v0/v1) and
    every level's candidate tiles.
    cand_sets: optional {level: sorted int32 candidate ids} for plans whose
    levels take the source ('cand', level).
    tasks: optional explicit (src, dst) edge-task arrays (already in g's id
    space, consistent with the plan's symmetry breaking) — used by engines
    that split the task list across strategies."""
    from ..utils.bucketing import pick_chunk
    from ..utils.profiling import PROFILER
    if engine not in ("compact", "map"):
        raise ValueError(f"unknown frontier engine {engine!r}; use "
                         "compact|map")
    dev = resolve_device(device)
    if plan.use_dag and not g.is_dag:
        assert tasks is None, "explicit tasks must come with the final graph"
        with PROFILER.span("orient"):
            g = g.orientation()
    with PROFILER.span("prep"):
        dg = DeviceGraph.from_host(g, device=dev)
        if tasks is not None:
            src, dst = np.asarray(tasks[0]), np.asarray(tasks[1])
        else:
            src, dst = g.edge_list(sym_break=plan.edge_sym_break)
    if cand is not None:
        cand_h = np.asarray(cand).astype(np.int8)
        keep = (cand_h[0][src] != 0) & (cand_h[1][dst] != 0)
        src, dst = src[keep], dst[keep]
        cand = torch.from_numpy(cand_h).to(dev)
    if plan.v0_label is not None or plan.v1_label is not None:
        vl = g.vlabels.astype(src.dtype)
        keep = (vl[src] == plan.v0_label) if plan.v0_label is not None else \
            (src == src)
        if plan.v1_label is not None:
            keep &= vl[dst] == plan.v1_label
        src, dst = src[keep], dst[keep]
    wf = max(8, g.max_degree)
    if plan.k == 2:  # single-edge pattern: the task list itself is the answer
        return int(src.shape[0]) // plan.multiplicity
    # per-op accounting (reference common.h:72-74 time_ops / intersect.cc
    # call counters): every edge task runs the plan's level-2 set ops once;
    # deeper levels are data-dependent and tracked as "edge_tasks" here.
    n_ops_l2 = 1 + len(plan.levels[0].intersect) + len(plan.levels[0].difference)
    PROFILER.count("edge_tasks", int(src.shape[0]))
    PROFILER.count("set_ops_level2", int(src.shape[0]) * n_ops_l2)

    if cand_sets is not None:
        cand_sets = {k: to_device(v, dev) for k, v in cand_sets.items()}

    def run(s, d, w, ck):
        s, d = to_device(s, dev), to_device(d, dev)
        if engine == "map":
            return _count_device_map(dg, s, d, cand, cand_sets, plan=plan,
                                     width=w, chunk=ck, backend=backend,
                                     wf=wf)
        return _count_device_compact(dg, s, d, cand, cand_sets,
                                     plans=(plan,), width=w, chunk=ck,
                                     sub=sub or ck, backend=backend,
                                     wf=wf)[0]

    if bucketed is None:
        bucketed = width is None and wf > 64 and src.shape[0] > 0
    with PROFILER.span("device_count", dev, hot=True):
        if not bucketed or width is not None:
            total = run(src, dst, width or wf, chunk)
        else:
            src, dst, spans = _width_groups(g, src, dst, wf)
            total = torch.zeros((), dtype=torch.int64, device=dev)
            for b, e, w in spans:
                total += run(src[b:e], dst[b:e], w,
                             pick_chunk(e - b, max_chunk=chunk))
        total = int(total)
    return total // plan.multiplicity

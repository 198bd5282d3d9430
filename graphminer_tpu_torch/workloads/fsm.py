"""Frequent subgraph mining (FSM) on vertex-labeled graphs.

The counterpart of graphminer_tpu/workloads/fsm.py. Parity: src/fsm/ in the
reference — gSpan-style pattern growth with MNI (minimal image) domain
support (omp_base.cc:19-147, domain_support.h:6-74, canonical.h is_min),
with the reference's own GPU structure (host-driven level loop, device
embedding math — gpu_base.cu:321-513):

* the pattern-space search runs on the host as BFS growth with canonical
  dedup (core/pattern_graph.py replaces DFS-code minimality — exact for the
  small patterns FSM explores);
* embedding lists are device-resident SENTINEL-padded int32 tensors
  [nv, cap] with a host-side live count (DevEmb). The transposed layout
  keeps each pattern vertex's images contiguous for the support's sort.
  Extension runs as a Python loop over column blocks of the live columns:
  gather → mask → compact → scatter-append into the child buffer, all on
  the device, the running offset carried as a device tensor; the host
  reads the child's count once an extension and its support once, and the
  host never holds embeddings;
* MNI support = min over pattern vertices of #distinct image vertices, a
  per-row sort + distinct over the live columns on the device.

Children are written block by block, parent by parent within a block and
slot by slot within a parent, as in the JAX package, so every child's live
columns equal its. JAX sizes a child buffer _cap_for(n_parent) and, when
the count passes it (on power-law graphs nearly always), runs the
extension again at _cap_for(n). The port counts first: the anchors'
neighbours with the new vertex's label (Σ nlf[anchor, label], read with
the width class in one host sync) bound the children, and the buffer is
sized _cap_for(bound), so the extension runs once. The retry stays
behind that bound, and the profiler counter fsm_overflow_retries reads
0. A child buffer's columns [cap, cap + block)
are scratch for the block's dead slots, so the compaction writes each
element to its own column (a stable partition: live slots first) and no
two writes meet. The profiler also counts fsm_host_syncs,
fsm_extensions and fsm_filters and times, on
the host clock, the phases fsm_extend and fsm_filter (each with the
support it computes) and fsm_support (every support, also inside those):
every step ends in a host read, so the host clock covers its device work.

Counted result = number of frequent patterns with 1..k edges (the
reference's `total`). Nothing here launches a kernel of ours: the device
work is a gather, a label mask, a broadcast compare, a cumsum, a scatter
and a per-row sort, all torch ops. Left out: jax.jit's static shapes
(blocks past the live count are skipped rather than masked) and the TPU
(8, 128) tiling that chose the transposed layout there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device_graph import DeviceGraph
from ..core.pattern_graph import PatternGraph
from ..device import DeviceLike, resolve_device
from ..ops import setops
from ..types import SENTINEL as _SENTINEL
from ..utils.profiling import PROFILER

SENTINEL = int(_SENTINEL)
BLOCK = 8192          # frontier rows per extension step
MIN_CAP = 1024        # smallest embedding buffer (power-of-4 ladder)


@dataclasses.dataclass
class DevEmb:
    """Device-resident embedding list: SENTINEL-padded [nv, cap] + count
    (transposed — see module docstring)."""
    buf: torch.Tensor
    n: int
    sup: Optional[int] = None       # fused MNI support (None -> compute)

    @property
    def cap(self) -> int:
        return self.buf.shape[1]

    @property
    def nv(self) -> int:
        return self.buf.shape[0]


def _cap_for(n: int) -> int:
    c = MIN_CAP
    while c < n:
        c *= 4
    return c


def device_emb(embs: np.ndarray, cap: Optional[int] = None,
               device: DeviceLike = "cuda") -> DevEmb:
    """embs: host [n, nv] rows (natural order) → device [nv, cap]."""
    n = embs.shape[0]
    cap = cap or _cap_for(n)
    out = np.full((embs.shape[1], cap), SENTINEL, dtype=np.int32)
    out[:, :n] = embs.T
    return DevEmb(buf=torch.from_numpy(out).to(resolve_device(device)), n=n)


def _sync(x: torch.Tensor):
    """x.tolist() (an int for a 0-d tensor), counted as one host sync."""
    PROFILER.count("fsm_host_syncs")
    return x.tolist()


# --------------------------------------------------------------------------
# device steps
# --------------------------------------------------------------------------

def _blk_for(width: int, cap_p: int) -> int:
    """Power-of-2 column block size capping the per-step candidate volume
    (blk·width ≤ 2^21) so wide-degree graphs never materialize huge
    intermediates; powers of two always divide the power-of-4 caps."""
    b = min(BLOCK, cap_p, max(8, (1 << 21) // max(width, 1)))
    return 1 << (b.bit_length() - 1)


def _blocks(n: int, cap: int, blk_sz: int):
    """Column ranges [s, e) of the blocks that hold live columns. The dead
    columns of the last are SENTINEL throughout, so their anchors gather
    all-SENTINEL rows and they need no mask of their own."""
    for s in range(0, min(n, cap), blk_sz):
        yield s, min(s + blk_sz, cap)


def _append(out: torch.Tensor, off: torch.Tensor, child: torch.Tensor,
            mask: torch.Tensor, limit: int) -> torch.Tensor:
    """Write child's columns where mask into out at off, off + 1, ... (in
    column order) and the others, as SENTINEL, after them: a stable
    partition of the block into out[:, base : base + child.shape[1]] with
    base = min(off, limit), every column its own target. Returns the number
    of live columns, a device tensor."""
    pos = torch.cumsum(mask, 0) - 1
    m = pos[-1] + 1
    j = torch.arange(mask.numel(), device=mask.device)
    tgt = off.clamp(max=limit) + torch.where(mask, pos, m + j - pos - 1)
    out.index_copy_(1, tgt, torch.where(mask[None, :], child, SENTINEL))
    return m


def _forward_extend_dev(dg: DeviceGraph, vlab, buf_p, n_p: int, at: int,
                        label: int, elabel: int, *, width: int, nv: int,
                        cap_p: int, cap_c: int, use_elab: bool = False):
    """All-block forward extension: attach a `label` neighbor at position
    `at` of every live embedding, via an edge labeled `elabel` when
    use_elab (gSpan forward DFS-code step incl. elabel —
    src/fsm/dfscode.h, omp_base.cc:151-240). Returns (child buffer
    [nv+1, cap_c], child count, support): the count may exceed cap_c,
    signalling overflow (the buffer then holds the first cap_c children
    and the support is None; the caller retries with a bigger cap)."""
    blk_sz = _blk_for(width, cap_p)
    dev = buf_p.device
    scratch = blk_sz * width
    out = torch.full((nv + 1, cap_c + scratch), SENTINEL, dtype=torch.int32,
                     device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    n_lab = vlab.shape[0]
    parents = torch.arange(blk_sz, device=dev).repeat_interleave(width)
    for s, e in _blocks(n_p, cap_p, blk_sz):
        blk = buf_p[:, s:e]
        rows = dg.gather_rows(blk[at], width)                 # [bs, W]
        ok = rows != SENTINEL
        lab = vlab.index_select(0, rows.clamp(0, n_lab - 1).reshape(-1))
        ok &= lab.view(rows.shape) == label
        if use_elab:
            ok &= dg.gather_elabel_rows(blk[at], width) == elabel
        # vertex-distinct embeddings (subgraph isomorphism)
        ok &= ~(rows[None, :, :] == blk[:, :, None]).any(dim=0)
        flat = rows.reshape(-1)
        child = torch.cat([blk[:, parents[:flat.numel()]], flat[None, :]],
                          dim=0)
        off = off + _append(out, off, child, ok.reshape(-1), cap_c)
    n_c = _sync(off)
    buf_c = out[:, :cap_c]
    if n_c > cap_c:
        return buf_c, n_c, None
    with PROFILER.phase("fsm_support"):
        sup = _sync(_mni_support_device(buf_c, n_c))
    return buf_c, n_c, sup


def _backward_filter_dev(dg: DeviceGraph, buf, n: int, p: int, q: int,
                         elabel: int, *, width: int, nv: int, cap: int,
                         use_elab: bool = False):
    """Keep embeddings where graph edge (emb[p], emb[q]) exists (with
    label `elabel` when use_elab); compacts into a fresh same-capacity
    buffer. Returns (buffer, count, support). Blocked over columns like
    the forward pass so the [blk, width] adjacency gather stays bounded on
    wide-degree graphs; a block's kept and dropped columns land in
    [0, cap), so it needs no scratch columns."""
    blk_sz = _blk_for(width, cap)
    dev = buf.device
    out = torch.full((nv, cap), SENTINEL, dtype=torch.int32, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    for s, e in _blocks(n, cap, blk_sz):
        blk = buf[:, s:e]
        vp, vq = blk[p], blk[q]
        rows = dg.gather_rows(vp, width)
        if use_elab:
            el = dg.gather_elabel_rows(vp, width)
            ok = ((rows == vq[:, None]) & (el == elabel)).any(dim=1)
        else:
            ok = setops.connected(vq, rows)
        off = off + _append(out, off, blk, ok, cap)
    n_c = _sync(off)
    with PROFILER.phase("fsm_support"):
        sup = _sync(_mni_support_device(out, n_c))
    return out, n_c, sup


def _mni_support_device(buf: torch.Tensor,
                        n: Optional[int] = None) -> torch.Tensor:
    """Min over pattern vertices of #distinct image vertices (ignoring
    SENTINEL padding) — the MNI domain support (domain_support.h:6-74)
    without materialized per-pattern Bitsets: sort+distinct per row of the
    [nv, cap] buffer on the device, over its first n columns when n is
    given (dead columns are SENTINEL throughout). n == 0 gives 0 without a
    sort. Returns a 0-d int64 tensor."""
    if n is not None:
        if n == 0:
            return torch.zeros((), dtype=torch.int64, device=buf.device)
        buf = buf[:, :n]
    s = torch.sort(buf, dim=1).values
    valid = s != SENTINEL
    first = valid.clone()
    first[:, 1:] &= s[:, 1:] != s[:, :-1]
    return first.sum(dim=1).min()


# --------------------------------------------------------------------------
# host-side search (pattern bookkeeping only — no embedding bytes)
# --------------------------------------------------------------------------

#: anchor-degree width classes for wide graphs (see _call_width): the
#: extension gather costs cap x width slots, and on power-law graphs the
#: global max degree is 10-100x the typical anchor's degree — classing
#: recovers that factor. Engages only when max_degree > WIDTH_CLASS_MIN.
WIDTH_CLASS_MIN = 1024
FSM_WIDTH_CLASSES = (128, 1024)


def _anchor_maxdeg(degs, buf, at, n: int) -> torch.Tensor:
    """Max degree over the n live anchors of column-resident embeddings
    (the first n columns; the dead ones are SENTINEL throughout)."""
    return degs.index_select(0, buf[at, :n]).max()


class _FSM:
    def __init__(self, g, minsup: int, max_width: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        assert g.vlabels is not None, "FSM needs vertex labels"
        self.g = g
        self.minsup = minsup
        self.device = resolve_device(device)
        self.dg = DeviceGraph.from_host(g, device=self.device)
        self.vlab = self.dg.vlabels
        self.width = max_width or max(8, g.max_degree)
        self.degs = self.dg.deg
        self.nlf = torch.from_numpy(g.build_nlf()).to(self.device)
        freq = np.bincount(g.vlabels.astype(np.int64))
        self.freq_labels = set(int(l) for l in np.nonzero(freq >= minsup)[0])
        # edge labels (gSpan DFS codes carry elabels — src/fsm/dfscode.h);
        # unlabeled-edge graphs run with the single pseudo-label 0
        self.use_elab = g.elabels is not None
        # (la, el, lb) la <= lb triples of FREQUENT single-edge patterns,
        # filled by run(); anti-monotone MNI support makes restricting
        # every extension edge to these triples exact (omp_base.cc's
        # frequent-edge pruning)
        self.freq_triples: set = set()
        #: canonical key -> MNI support of every pattern run() evaluated
        self.supports: Dict[tuple, int] = {}

    def _call_width(self, de: DevEmb, at: int, label: Optional[int] = None):
        """(width class covering this call's anchors — the full width on
        graphs no wider than WIDTH_CLASS_MIN —, and with a label the bound
        Σ nlf[anchor, label] on a forward extension's children: every
        neighbour so labelled), read in one host sync."""
        wide = self.width > WIDTH_CLASS_MIN
        if not wide and label is None:
            return self.width, 0
        dmax = _anchor_maxdeg(self.degs, de.buf, at, de.n)
        bound = (self.nlf[:, label].index_select(0, de.buf[at, :de.n]).sum()
                 if label is not None else torch.zeros_like(dmax))
        dmax, bound = _sync(torch.stack([dmax.long(), bound.long()]))
        if wide:
            for c in FSM_WIDTH_CLASSES:
                if dmax <= c:
                    return c, bound
        return self.width, bound

    def _ext_candidates(self, la: int):
        """(elabel, other_vlabel) pairs allowed at a vertex labeled la."""
        out = set()
        for a, el, b in self.freq_triples:
            if a == la:
                out.add((el, b))
            if b == la:
                out.add((el, a))
        return sorted(out)

    def _backward_elabels(self, la: int, lb: int):
        a, b = min(la, lb), max(la, lb)
        return sorted(el for (x, el, y) in self.freq_triples
                      if (x, y) == (a, b))

    def support(self, de: DevEmb) -> int:
        if de.n == 0:
            return 0
        if de.sup is not None:
            return de.sup
        with PROFILER.phase("fsm_support"):
            return _sync(_mni_support_device(de.buf, de.n))

    def initial_patterns(self) -> Dict[tuple, tuple]:
        """Frequent single-edge patterns (vlabel pairs la <= lb, split by
        edge label when the graph carries elabels) + device embeddings;
        mirrors omp_base.cc:35-100 incl. the frequent-vertex filter."""
        g = self.g
        deg = np.diff(g.rowptr)
        src = np.repeat(np.arange(g.n_vertices, dtype=np.int32), deg)
        dst = g.colidx.astype(np.int32)
        vl = g.vlabels.astype(np.int32)
        la, lb = vl[src], vl[dst]
        el = (g.elabels.astype(np.int32) if self.use_elab
              else np.zeros(src.shape[0], dtype=np.int32))
        keep = la <= lb  # both directions kept when la == lb
        out = {}
        trips = {(int(x), int(e), int(y))
                 for x, e, y in zip(la[keep], el[keep], lb[keep])}
        for a, e, b in trips:
            m = keep & (la == a) & (lb == b) & (el == e)
            embs = np.stack([src[m], dst[m]], axis=1).astype(np.int32)
            pat = PatternGraph((a, b), ((0, 1),),
                               (e,) if self.use_elab else ())
            out[pat.canonical_key()] = (pat, device_emb(embs,
                                                        device=self.device))
        return out

    def forward_extend(self, de: DevEmb, at: int, label: int,
                       elabel: int = 0) -> DevEmb:
        PROFILER.count("fsm_extensions")
        with PROFILER.phase("fsm_extend"):
            w, bound = self._call_width(de, at, label)
        cap_c = _cap_for(max(bound, 1))
        while True:
            with PROFILER.phase("fsm_extend"):
                buf, n, sup = _forward_extend_dev(
                    self.dg, self.vlab, de.buf, de.n, at, label, elabel,
                    width=w, nv=de.nv, cap_p=de.cap, cap_c=cap_c,
                    use_elab=self.use_elab)
            if n <= cap_c:
                return DevEmb(buf=buf, n=n, sup=sup)
            PROFILER.count("fsm_overflow_retries", 1)
            cap_c = _cap_for(n)       # overflow: retry with room

    def backward_filter(self, de: DevEmb, p: int, q: int,
                        elabel: int = 0) -> DevEmb:
        PROFILER.count("fsm_filters")
        with PROFILER.phase("fsm_filter"):
            w, _ = self._call_width(de, p)
            buf, n, sup = _backward_filter_dev(
                self.dg, de.buf, de.n, p, q, elabel, width=w, nv=de.nv,
                cap=de.cap, use_elab=self.use_elab)
        return DevEmb(buf=buf, n=n, sup=sup)

    def _evaluate(self, key, de: DevEmb) -> int:
        sup = self.support(de)
        self.supports[key] = sup
        return sup

    def run(self, k_edges: int) -> int:
        PROFILER.count("fsm_overflow_retries", 0)
        frontier = {}
        n_frequent = 0
        for key, (pat, de) in self.initial_patterns().items():
            if (pat.vlabels[0] in self.freq_labels
                    and pat.vlabels[1] in self.freq_labels
                    and self._evaluate(key, de) >= self.minsup):
                frontier[key] = (pat, de)
                la, lb = pat.vlabels
                el = pat.elabels[0] if pat.elabels else 0
                self.freq_triples.add((min(la, lb), el, max(la, lb)))
        n_frequent += len(frontier)
        seen = set(frontier.keys())

        for level in range(2, k_edges + 1):
            nxt = {}
            for key, (pat, de) in frontier.items():
                nv = pat.n_vertices
                # forward: attach a new labeled vertex at any pattern
                # vertex, by any frequent (elabel, vlabel) edge there
                for at in range(nv):
                    for el, label in self._ext_candidates(pat.vlabels[at]):
                        child = pat.add_forward(
                            at, label, el if self.use_elab else None)
                        ck = child.canonical_key()
                        if ck in seen or ck in nxt:
                            continue
                        ne = self.forward_extend(de, at, label, el)
                        if ne.n and self._evaluate(ck, ne) >= self.minsup:
                            nxt[ck] = (child, ne)
                # backward: close a cycle between non-adjacent vertices
                for p in range(nv):
                    for q in range(p + 1, nv):
                        if pat.has_edge(p, q):
                            continue
                        els = self._backward_elabels(pat.vlabels[p],
                                                     pat.vlabels[q])
                        for el in els:
                            child = pat.add_backward(
                                p, q, el if self.use_elab else None)
                            ck = child.canonical_key()
                            if ck in seen or ck in nxt:
                                continue
                            ne = self.backward_filter(de, p, q, el)
                            if ne.n and self._evaluate(ck, ne) >= \
                                    self.minsup:
                                nxt[ck] = (child, ne)
            seen |= set(nxt.keys())
            n_frequent += len(nxt)
            frontier = nxt
            if not frontier:
                break
        return n_frequent


def fsm_count(g, k_edges: int, minsup: int,
              device: DeviceLike = "cuda") -> int:
    """Number of frequent patterns with 1..k_edges edges (MNI support)."""
    return _FSM(g, minsup, device=device).run(k_edges)

"""Profiling utilities: named phase timers and op counters.

The counterpart of graphminer_tpu/utils/profiling.py. Parity: include/timer.h
(Timer + TIME_OP), the per-phase timer arrays (fsm/omp_base.cc timers[0..5])
and the per-set-op counters (common.h:72-74). A phase that runs on a CUDA
device is timed with torch.cuda.Event pairs on the current stream, so it
measures device time and not the host's enqueue; a CPU phase uses the host
clock. time_ms times a repeated call the same way (on the card the event
pair also spans the host's dispatch of the call), device_ms gives the
device time alone and the device operations a call runs (torch.profiler),
bound_ms gives the least time an H100 SXM could take for a given work, and
gram_bounds, quad_bytes and quad_count_bytes put kernel G's and kernel Q's
work in its terms, and tri_bitmap_bytes, tri_probe_bytes, tri_lists_bytes,
colsum_bytes and colsum_pairs_bytes kernels S's, P's, I's and W's (write
and pairs modes).
Left out: xla_trace (torch.profiler is the tool on the card).
"""
from __future__ import annotations

import contextlib
import json
import statistics
import time
from collections import Counter, defaultdict
from typing import Dict, Optional

import numpy as np
import torch


class Timer:
    """Accumulating wall-clock timer (timer.h:6-44)."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        self.total += time.perf_counter() - self._t0
        self._t0 = None
        return self.total

    @property
    def seconds(self) -> float:
        return self.total


class Profiler:
    """Named phase timers + op counters; one per run."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counters: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, device: Optional[torch.device] = None):
        """Time the block. With a CUDA `device`, the time is the device
        time between two events recorded on the current stream (the exit
        synchronizes on the end event); otherwise the host clock."""
        if device is not None and torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self.seconds[name] += start.elapsed_time(end) / 1e3
            return
        t = Timer().start()
        try:
            yield
        finally:
            self.seconds[name] += t.stop()

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def report(self) -> Dict:
        return {
            "phases_s": {k: round(v, 6) for k, v in self.seconds.items()},
            "counters": dict(self.counters),
        }

    def dump(self) -> str:
        return json.dumps(self.report(), sort_keys=True)


# process-wide default profiler (opt-in; hot paths don't touch it unless
# callers pass it down)
PROFILER = Profiler()


#: published H100 SXM peaks at its 700 W limit (NVIDIA data sheet): HBM3
#: bytes/s, and dense int8 tensor-core operations/s
H100_HBM_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1.979e15


def bound_ms(n_bytes: float, n_int8_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the int8 operations over the tensor cores' peak."""
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = n_int8_ops / H100_INT8_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def gram_bounds(base, mask, n_tiles: int, tile: int, *, r=None, tab=None,
                cols=None) -> Dict:
    """Kernel G's least times for one call (ops/cuda_gram.py::bit_gram's
    arguments and its plan's n_tiles tiles of side tile): "bytes", the
    task ids, each distinct packed row a valid id names (all n rows in
    plain mode) and the mask rows read once, and the int64 partials;
    "ops_mask", 2 * nnz(B) * n int8 operations, the Gram entries that the
    mask's set bits select (what the function needs); "ops_tiles",
    2 * tile^2 * n_tiles * n over the tiles G walks (its design's work);
    "ops_full", 2 * dim^2 * n over the full Gram (the slab form's work);
    "mask", "tiles" and "full", bound_ms of the bytes with each."""
    hw = base.shape[1]
    dim = 32 * hw
    n = (cols.shape[0] if cols is not None else
         r.shape[0] if r is not None else base.shape[0])
    rows = min(mask.shape[0], dim)
    nbytes = 8 * dim + rows * hw * 4
    if r is None:
        nbytes += n * hw * 4
    for ids, tbl in ((r, base), (cols, tab)):
        if ids is not None:
            ids = ids.long()
            ok = (ids >= 0) & (ids < tbl.shape[0])
            nbytes += ids.numel() * 4 + \
                int(torch.unique(ids[ok]).numel()) * hw * 4
    m = mask[:rows].cpu().contiguous().numpy().view(np.uint8)
    ops_mask = 2 * int(np.unpackbits(m).sum()) * n
    ops_tiles = 2 * tile * tile * n_tiles * n
    ops_full = 2 * dim * dim * n
    return {"bytes": nbytes, "ops_mask": ops_mask, "ops_tiles": ops_tiles,
            "ops_full": ops_full, "mask": bound_ms(nbytes, ops_mask),
            "tiles": bound_ms(nbytes, ops_tiles),
            "full": bound_ms(nbytes, ops_full)}


def _distinct_row_bytes(y2, core, erow, c1) -> int:
    """Each distinct y2 and core row a valid task names, read once (the
    row's words up to n_bits, here all of them)."""
    r, c = erow.long(), c1.long()
    ok = (r >= 0) & (r < y2.shape[0]) & (c >= 0) & (c < core.shape[0])
    rows = int(torch.unique(r[ok]).numel()) + \
        int(torch.unique(c[ok]).numel())
    return rows * y2.shape[1] * 4


def quad_bytes(y2, core, erow, c1, n_quads: int) -> int:
    """The bytes kernel Q's emit (ops/cuda_cliquebig.py::quad_emit) must
    move for one call: each task's ids and offset (4 + 4 + 8 B), each
    distinct y2 and core row a valid task names read once, and 12 B
    written a quad."""
    return 16 * erow.numel() + _distinct_row_bytes(y2, core, erow, c1) + \
        12 * n_quads


def quad_count_bytes(y2, core, erow, c1) -> int:
    """The bytes kernel Q's count (ops/cuda_cliquebig.py::quad_count) must
    move for one call: each task's ids (4 + 4 B) and its count (4 B), and
    each distinct y2 and core row a valid task names read once."""
    return 12 * erow.numel() + _distinct_row_bytes(y2, core, erow, c1)


def _distinct_list_bytes(ft, ids) -> int:
    """Each distinct vertex of `ids` that has a list (ops/cuda_tri.FtLists)
    read once: rowptr[x], rowptr[x + 1] and ftw[x] (20 B) and its list's
    ids (4 B each)."""
    x = torch.unique(ids.long())
    _, ln = ft.lengths(x)
    ok = (x >= 0) & (x < ft.n_vertices)
    return 20 * int(ok.sum()) + 4 * int(ln.sum())


def tri_bitmap_bytes(tab, src, dst) -> int:
    """The bytes kernel S (ops/cuda_tri.py::tri_bitmap) must move for one
    call: each task's two ids and its result (12 B) and each distinct row
    a valid id names read once."""
    v = tab.shape[0]
    ids = torch.cat([src, dst]).long()
    ids = torch.unique(ids[(ids >= 0) & (ids < v)])
    return 12 * src.numel() + ids.numel() * tab.shape[1] * 4


def tri_probe_bytes(ft, tab, u, vloc) -> int:
    """The bytes kernel P (ops/cuda_tri.py::tri_probe) must move for one
    call: each task's ids and result (12 B), each distinct u's list once,
    and each distinct (x, word) that a list slot probes, 4 B once."""
    task, x = ft.slots(u)
    ok = (x >= 0) & (x < tab.shape[0])
    key = x[ok] * tab.shape[1] + (vloc.long()[task[ok]] >> 5)
    return 12 * u.numel() + _distinct_list_bytes(ft, u) + \
        4 * int(torch.unique(key).numel())


def tri_lists_bytes(ft, u, w) -> int:
    """The bytes kernel I (ops/cuda_tri.py::tri_lists) must move for one
    call: each task's ids and result (12 B) and each distinct end's list
    once."""
    return 12 * u.numel() + _distinct_list_bytes(ft, torch.cat([u, w]))


def colsum_bytes(ft, tab, u) -> int:
    """The bytes kernel W (ops/cuda_colsum.py::bit_colsum) must move for one
    call: each task's id (4 B), each distinct u's list once, each distinct
    row a list names once, and the output written once (4 B an entry)."""
    _, x = ft.slots(u)
    x = torch.unique(x[(x >= 0) & (x < tab.shape[0])])
    words = tab.shape[1]
    return 4 * u.numel() + _distinct_list_bytes(ft, u) + \
        x.numel() * words * 4 + u.numel() * 32 * words * 4


def colsum_pairs_bytes(plan, tab) -> int:
    """The bytes kernel W's pairs mode (ops/cuda_colsum.py::colsum_pairs)
    must move for one call over a PairsPlan: each task row's id and row
    bounds (4 + 16 B), 4 B a list slot, each distinct table row a slot
    names read once, and the int64 scalar; its split rows' counts are
    design, not output."""
    _, x = plan.slots()
    x = x[(x >= 0) & (x < tab.shape[0])]
    named = torch.zeros(tab.shape[0], dtype=torch.bool, device=x.device)
    named[x] = True
    rows = int(torch.unique(plan.items[:, 0]).numel())
    return 20 * rows + 4 * int(plan.items[:, 2].long().sum()) + \
        int(named.sum()) * tab.shape[1] * 4 + 8


def time_ms(fn, device, reps: int = 11):
    """Median time of fn() in ms over `reps` calls after two warm-up calls,
    and fn's first result. On a CUDA device each call is timed by a pair of
    CUDA events (device time, synchronized after each call); on the CPU by
    the host clock."""
    val = fn()
    fn()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), val


def device_ms(fn, calls: int = 200):
    """(ms, ops) of fn() on the card: the device time of one call in ms —
    the device events torch.profiler records over `calls` calls after ten
    warm-up calls, summed, over the calls they cover — and {event name:
    events per call} of those events (kernels, memsets, copies). The
    profiler can miss an event at the edge of its window; when even the
    most frequent event came fewer than `calls` times, the sum is taken
    over that many calls. Raises when the profiler recorded no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device event")
    us = sum(e.time_range.elapsed_us() for e in dev)
    counts = Counter(e.name for e in dev)
    covered = min(calls, max(counts.values()))
    return us / covered / 1e3, {k: n / calls for k, n in counts.items()}

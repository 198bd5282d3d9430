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
gram_bounds and quad_bytes put kernel G's and kernel Q's work in its
terms.
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


def quad_bytes(y2, core, erow, c1, n_quads: int) -> int:
    """The bytes kernel Q (ops/cuda_cliquebig.py::quad_emit) must move for
    one call: each task's ids and offset (4 + 4 + 8 B), each distinct y2
    and core row a valid task names read once (the row's words up to
    n_bits, here all of them), and 12 B written a quad."""
    r, c = erow.long(), c1.long()
    ok = (r >= 0) & (r < y2.shape[0]) & (c >= 0) & (c < core.shape[0])
    rows = int(torch.unique(r[ok]).numel()) + \
        int(torch.unique(c[ok]).numel())
    return 16 * r.numel() + rows * y2.shape[1] * 4 + 12 * n_quads


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

"""torch.profiler around the measured window, reduced to plain intervals.

The window runs inside profile(activities=[CPU, CUDA]), held open
PAD_S before and after it (events at the profiler's edges are the ones it
drops), and inside record_function(WINDOW); each call inside
record_function(CALL). What is kept: the window's bounds, every device
event (kernels, copies, memsets) with its device, and the host's events,
all in microseconds on the profiler's one clock. The profiler also copies
each record_function range onto the device's timeline as a user
annotation; those are left out of the device events.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from . import stats

PAD_S = 0.2
WINDOW = "bench.window"
CALL = "bench.call"
#: traced windows tried before a run gives up on a trace with no device
#: event (CUPTI now and then hands the profiler none)
READS = 3


@dataclasses.dataclass
class Trace:
    """A traced window: bounds (us), device events by device index as
    (start, end, name), and the host's events as (start, end, name)."""
    lo: float
    hi: float
    device: Dict[int, List[Tuple[float, float, str]]]
    host: List[Tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def intervals(self, index: int):
        return [(s, e) for s, e, _ in self.device.get(index, [])]

    def in_window(self):
        """Every device event that overlaps the window."""
        return [(i, s, e, n) for i, evs in self.device.items()
                for s, e, n in evs if e > self.lo and s < self.hi]

    def busy_s(self, index: int) -> float:
        return stats.busy(self.intervals(index), self.lo, self.hi) / 1e6

    def mean_idle_pct(self, n_devices: int) -> float:
        """The idle share of the window in %, averaged over devices
        0 .. n_devices - 1."""
        return 100.0 * sum(stats.idle_share(self.intervals(i), self.lo,
                                            self.hi)
                           for i in range(n_devices)) / n_devices


def _reduce(prof) -> Trace:
    from torch.autograd import DeviceType
    lo = hi = None
    dev = defaultdict(list)
    host = []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the device-side copies of record_function ranges are no
            # device operations
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in (WINDOW, CALL)):
                dev[int(e.device_index)].append((s, t, e.name))
        else:
            host.append((s, t, e.name))
            if e.name == WINDOW:
                lo, hi = s, t
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(lo=lo, hi=hi, device=dict(dev), host=host)


def traced(window, devices) -> Tuple[object, Trace]:
    """(window's result, Trace) of window() run under torch.profiler. A
    reading with no device event inside the window is taken again, READS
    in all; then it raises."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(READS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            with record_function(WINDOW):
                out = window()
                for d in devices:
                    torch.cuda.synchronize(d)
            time.sleep(PAD_S)
        tr = _reduce(prof)
        if tr.in_window():
            return out, tr
    raise RuntimeError(f"torch.profiler recorded no device event in the "
                       f"window in {READS} readings")


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, summed by
    name, and the longest stretches in which device 0 ran nothing, each
    named by what the host was in at its start: the harness's span and
    the innermost host event (`span > event`)."""
    by_name = defaultdict(float)
    for _, s, e, n in tr.in_window():
        by_name[n] += (min(e, tr.hi) - max(s, tr.lo)) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    first = min(tr.device) if tr.device else 0
    longest = sorted(stats.gaps(tr.intervals(first), tr.lo, tr.hi),
                     key=lambda g: g[0] - g[1])[:top]
    idle = []
    for s, e in longest:
        around = [(hs, he, n) for hs, he, n in tr.host if hs <= s < he]
        spans = [h for h in around if h[2] in (WINDOW, CALL)]
        span = min(spans, key=lambda h: h[1] - h[0])[2] if spans else "host"
        inner = [h for h in around if h[2] not in (WINDOW, CALL)]
        name = span
        if inner:
            name += " > " + min(inner, key=lambda h: h[1] - h[0])[2]
        idle.append([name[:160], (e - s) / 1e6])
    return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": idle}

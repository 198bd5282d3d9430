"""The benchmark's arithmetic: window statistics, device busy time from
trace intervals, and the least time of a count (its roofline).

Every function here is plain Python over numbers the harness recorded; the
metric readers under bench_port/metrics/ call them.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

#: published HBM3 bandwidth of one NVIDIA H100 SXM at its 700 W limit
H100_HBM_BYTES_PER_S = 3.35e12
#: published dense int8 tensor-core rate of one NVIDIA H100 SXM (ops/s)
H100_INT8_OPS_PER_S = 1.979e15


def window_mean_ms(window_s: float, n_calls: int):
    """The window's length over the calls it completed, in ms (None
    without a call)."""
    if n_calls <= 0:
        return None
    return window_s / n_calls * 1e3


def percentile(values: Sequence[float], q: float):
    """The q-th percentile (0 < q <= 100) by the nearest rank: the
    smallest value with at least q % of the values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def merge(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The parts of the intervals inside [lo, hi)."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi)."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def idle_share(intervals, lo: float, hi: float):
    """1 - busy / window, the share of [lo, hi) with no interval open."""
    if hi <= lo:
        return None
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers, in time order."""
    out, at = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def csr_bytes(n_vertices: int, n_dag_edges: int) -> int:
    """The bytes a count needs at the least: the oriented graph's CSR read
    once (int32 row pointers and column ids) and one int64 written."""
    return 4 * (n_vertices + 1) + 4 * n_dag_edges + 8


def least_seconds(n_bytes: float, n_int8_ops: float = 0.0) -> float:
    """The least time of a piece of work on one H100: the larger of its
    bytes over the HBM bandwidth and its int8 operations over the peak."""
    return max(n_bytes / H100_HBM_BYTES_PER_S,
               n_int8_ops / H100_INT8_OPS_PER_S)

"""Degree-bucketed task partitioning (host numpy).

A copy of graphminer_tpu/utils/bucketing.py, kept here because the port
imports nothing of the JAX package.

The reference picks execution strategy per workload shape (warp-per-edge vs
CTA-per-edge vs hindex — common.mk:73-74,100-104; Scheduler::least_first
workload binning, scheduler.cc:133-214). Here: partition edge tasks by the
degree classes of their endpoints and run one fixed-width step per class
pair, so the O(Wa·Wb) compare cost of the set operations tracks the true
work instead of the global max degree.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Powers of 4 (the JAX package's classes, so both bucket alike): few
# distinct tile widths at ≤4× padding waste per side.
WIDTH_CLASSES = (16, 64, 256, 1024, 4096, 16384)


def width_class(deg: np.ndarray, max_degree: int) -> Tuple[np.ndarray, list]:
    """Map degrees to the smallest width class covering them.
    Returns (class index per element, list of class widths used)."""
    widths = [w for w in WIDTH_CLASSES if w < max_degree]
    widths.append(min([w for w in WIDTH_CLASSES if w >= max_degree],
                      default=max_degree))
    bounds = np.array(widths)
    cls = np.searchsorted(bounds, deg, side="left")
    return cls.astype(np.int32), widths


def bucket_edge_tasks(deg_u: np.ndarray, deg_v: np.ndarray, max_degree: int):
    """Group edge tasks by (width(deg_u), width(deg_v)).

    Returns (order, groups) where `order` re-sorts the task arrays and
    `groups` is a list of (start, stop, wa, wb) spans of the sorted order."""
    cls_u, widths = width_class(deg_u, max_degree)
    cls_v, _ = width_class(deg_v, max_degree)
    key = cls_u.astype(np.int64) * len(widths) + cls_v
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    # group boundaries
    change = np.nonzero(np.diff(sorted_key))[0] + 1
    starts = np.concatenate([[0], change])
    stops = np.concatenate([change, [key.shape[0]]])
    groups = []
    for s, e in zip(starts, stops):
        k = int(sorted_key[s])
        wa = widths[k // len(widths)]
        wb = widths[k % len(widths)]
        groups.append((int(s), int(e), wa, wb))
    return order, groups


def pick_chunk(n: int, max_chunk: int = 16384, min_chunk: int = 1024) -> int:
    """Fixed small set of chunk sizes → few compiled variants."""
    c = min_chunk
    while c < max_chunk and c < n:
        c *= 16
    return min(c, max_chunk)

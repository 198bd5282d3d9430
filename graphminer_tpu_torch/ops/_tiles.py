"""Tile tables for the grouped kernels A and C (host side, numpy).

One launch of a grouped kernel covers every bucket of an engine. Its
persistent grid walks a table that lives in device memory beside the
buckets: one int64 record per bucket (base pointers, widths, the
multiply-high division constants the kernel divides by) and one record per
tile. A tile is a run of work units of ONE bucket (16-byte chunks of the
src stream for A, tasks for C): tiles are equal-sized, only the last tile
of a bucket is short, and no tile crosses a bucket, so a wide bucket and a
narrow one interleave in one grid without either setting its shape.

A tile record is (bucket id, first unit, units, first row): the first unit
and first row are 64-bit offsets into the bucket, so a bucket may hold more
than 2^32 units. Inside a tile the kernel divides only tile-relative
indices (the first unit's offset within its row plus a unit index below
the tile size), which stay below 2^31, where gm::FastDiv
(csrc/common.cuh) is exact.

The table is built once per layout (StreamEngine._attach,
RingEngine._attach); a count reads it and plans nothing.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

#: fields of a tile record: bucket id, first unit, units, first row
TREC = 4
#: dividends that gm::FastDiv divides exactly
FASTDIV_LIMIT = 1 << 31


def fastdiv(d: int) -> Tuple[int, int, int]:
    """(d, m, s) of gm::FastDiv::make(d): n // d == (mulhi(n, m) + n) >> s
    for every 0 <= n < 2^31 (the same arithmetic as csrc/common.cuh)."""
    if not 0 < d < FASTDIV_LIMIT:
        raise ValueError(f"FastDiv divisor {d} outside [1, 2^31)")
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    return d, m & 0xFFFFFFFF, s


def plan_tiles(units: Sequence[int], per_row: Sequence[int],
               tile: int) -> np.ndarray:
    """int64 [n_tiles, TREC] tile records over buckets of `units` work units,
    `per_row` units to a row: equal tiles of `tile` units in bucket order,
    the last of each bucket short, none across a bucket; empty buckets have
    no tile. Raises where a tile-relative index could reach 2^31."""
    units = np.asarray(units, np.int64).reshape(-1)
    per_row = np.asarray(per_row, np.int64).reshape(-1)
    if units.shape != per_row.shape or (units < 0).any() or \
            (per_row < 1).any():
        raise ValueError("plan_tiles: one units and one per_row >= 1 per "
                         "bucket")
    if per_row.size and int(per_row.max()) + tile > FASTDIV_LIMIT:
        raise ValueError(f"plan_tiles: rows of {int(per_row.max())} units "
                         f"and tiles of {tile} reach 2^31")
    n_t = -(-units // tile)
    bucket = np.repeat(np.arange(units.size, dtype=np.int64), n_t)
    starts = np.concatenate([[0], np.cumsum(n_t)[:-1]]).astype(np.int64)
    first = (np.arange(bucket.size, dtype=np.int64) - starts[bucket]) * tile
    count = np.minimum(tile, units[bucket] - first)
    out = np.empty((bucket.size, TREC), np.int64)
    out[:, 0] = bucket
    out[:, 1] = first
    out[:, 2] = count
    out[:, 3] = first // per_row[bucket]
    return out

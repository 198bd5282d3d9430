"""Fixed-width ID types and global constants for the TPU GPM framework.

Parity target: include/common.h:29-61 and include/defines.h in the reference
(vidType=int32, eidType=int64, vlabel_t=u8, elabel_t=u16, AccType=u64).

On the TPU device side we use int32 everywhere (int64 is emulated and slow on
TPU); 64-bit accumulation happens on the host or in partitioned int32 blocks
that are promoted after reduction.
"""
from __future__ import annotations

import numpy as np

# Host-side dtypes (match the on-disk binary format of the reference).
VID_DTYPE = np.int32      # vertex id            (vidType)
EID_DTYPE = np.int64      # edge id / row ptr    (eidType)
VLABEL_DTYPE = np.uint8   # vertex label         (vlabel_t)
ELABEL_DTYPE = np.uint16  # edge label           (elabel_t) -- on-disk size 2
ACC_DTYPE = np.uint64     # global accumulator   (AccType)

# Device-side dtypes.
DEV_VID = np.int32
DEV_EID = np.int32        # device row offsets; graphs with E >= 2^31 must be partitioned
DEV_ACC = np.int64        # XLA on CPU supports int64; on TPU x64 is disabled by
                          # default so device partial counts use int32 blocks.

# Sentinel for padded adjacency slots: larger than any valid vertex id, so a
# padded slot never matches a real vertex and never passes an upper-bound test.
SENTINEL = np.int32(np.iinfo(np.int32).max)

# TPU lane width; padded widths are rounded up to a multiple of this when it
# pays off (small widths stay exact to avoid wasted compare lanes).
LANE = 128
SUBLANE = 8

# Number of possible connected patterns with k vertices (reference
# include/pattern.hh:4-15) -- used by k-motif counting.
NUM_POSSIBLE_PATTERNS = {1: 1, 2: 1, 3: 2, 4: 6, 5: 21, 6: 112, 7: 853, 8: 11117, 9: 261080}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m

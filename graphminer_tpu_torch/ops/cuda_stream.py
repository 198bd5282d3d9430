"""Kernel A — the stream engine's bucket count (csrc/stream_count.cu).

Replaces graphminer_tpu/ops/stream.py::_bucket_counts_fused, which XLA
fused into one broadcast-reduce; torch has no popcount op, so the port
counts with a hand-written kernel. For one bucket

    dst_rows int32 [n, ws + wt]           bitmap words | sorted dst tail
    src_rows int32 [n, width, ws + wta]   bitmap words | src tail

it returns, as an int64 0-d tensor on the bucket's device,

    Σ_r Σ_s popcount(dst[r, :ws] & src[r, s, :ws])
          + |{non-SENTINEL x ∈ src[r, s, ws:]} ∩ dst[r, ws:]|   (wtv > 0)

wt <= wtv: the tail class wtv may be wider than the layout's physical tail
width, and a dst row then keeps every physical tail slot (wtv == 0 means
wt == 0). Tails are sorted ascending and SENTINEL padded, with no repeated
id, as build_stream makes them. The wrapper takes the plain version below only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..types import SENTINEL
from . import _build
from ._tensors import PLAIN_ELEMS, n_blocks, on_cuda, popcount32

#: 16-byte chunks per launch (the kernel's flat index stays below 2^31)
MAX_CHUNKS = 1 << 30


def stream_bucket_count(dst_rows: torch.Tensor, src_rows: torch.Tensor, *,
                        ws: int, wtv: int) -> torch.Tensor:
    """Count of one stream bucket (int64 0-d tensor); see module docstring."""
    n, width, row_w = src_rows.shape
    wta = row_w - ws
    if dst_rows.dim() != 2 or dst_rows.shape[0] != n or wta < 0 or \
            not ws <= dst_rows.shape[1] <= ws + wtv:
        raise ValueError(f"bucket shapes disagree: dst {tuple(dst_rows.shape)}"
                         f" src {tuple(src_rows.shape)} ws={ws} wtv={wtv}")
    if not on_cuda("stream_bucket_count", dst_rows, src_rows):
        return stream_bucket_count_plain(dst_rows, src_rows, ws=ws, wtv=wtv)
    wtv = dst_rows.shape[1] - ws          # the tail columns actually stored
    if ws % 4 or wtv % 4 or wta % 4 or ws == 0:
        raise ValueError(f"kernel reads 4-word chunks: ws={ws} wtv={wtv} "
                         f"wta={wta} must be multiples of 4 (ws > 0)")
    if dst_rows.data_ptr() % 16 or src_rows.data_ptr() % 16:
        raise ValueError("kernel reads 16-byte chunks: rows must be aligned")
    lib = _build.kernels()
    stream = torch.cuda.current_stream(dst_rows.device).cuda_stream
    per_row = width * row_w // 4
    step = max(1, MAX_CHUNKS // per_row)
    parts = []
    for r0 in range(0, n, step):
        rows = min(step, n - r0)
        nb = n_blocks(rows * per_row)
        out = torch.empty(nb, dtype=torch.int64, device=dst_rows.device)
        _build.check_launch(lib.gm_stream_bucket_count(
            dst_rows[r0].data_ptr(), src_rows[r0].data_ptr(), rows, width,
            ws, wtv, wta, out.data_ptr(), nb, stream), "stream_bucket_count")
        stream_bucket_count.launches += 1
        parts.append(out)
    if not parts:
        return torch.zeros((), dtype=torch.int64, device=dst_rows.device)
    return torch.cat(parts).sum()


stream_bucket_count.launches = 0


def stream_bucket_count_plain(dst_rows: torch.Tensor, src_rows: torch.Tensor,
                              *, ws: int, wtv: int) -> torch.Tensor:
    """Plain PyTorch version of stream_bucket_count (any device): the
    broadcast AND+popcount and the SENTINEL-masked broadcast tail compare of
    _bucket_counts_fused, in row chunks."""
    n, width, row_w = src_rows.shape
    wta = row_w - ws
    per_row = width * max(ws, wta * max(wtv, 1), 1)
    step = max(1, PLAIN_ELEMS // per_row)
    total = torch.zeros((), dtype=torch.int64, device=dst_rows.device)
    for r0 in range(0, n, step):
        d = dst_rows[r0:r0 + step]
        s = src_rows[r0:r0 + step]
        total += popcount32(d[:, None, :ws] & s[:, :, :ws]).sum()
        if wtv and wta:
            ta = s[:, :, ws:]                     # [r, width, wta]
            tb = d[:, ws:]                        # [r, wtv]
            m = (ta[:, :, :, None] == tb[:, None, None, :]) & \
                (ta != SENTINEL)[:, :, :, None]
            total += m.sum()
    return total

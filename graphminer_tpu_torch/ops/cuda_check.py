"""Kernel R — o = 2 * x on int32 (csrc/times_two.cu).

The port of the Pallas kernel scripts/repro_mosaic_hang.py::kernel, the
smallest kernel there is: the first launch after a build
(graphminer_tpu_torch/scripts/launch_check.py, chip_smoke.py) shows that
the library was built for this card and launches on it. The product wraps
modulo 2^32, as int32 arithmetic does in torch. The wrapper takes the plain
version below only for CPU tensors; for CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import n_blocks, on_cuda


def times_two(x: torch.Tensor) -> torch.Tensor:
    """2 * x, int32, same shape."""
    if not on_cuda("times_two", x):
        return times_two_plain(x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    _build.check_launch(_build.entry("gm_times_two")(
        x.data_ptr(), out.data_ptr(), n, n_blocks(n),
        _build.stream(x.device)), "times_two")
    times_two.launches += 1
    return out


times_two.launches = 0


def times_two_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of times_two (any device)."""
    return x * 2

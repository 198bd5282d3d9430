"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

#: blocks per launch: enough to fill the H100's 132 SMs several times over;
#: the kernels grid-stride over the rest
GRID_CAP = 132 * 16
BLOCK = 256
#: elements per step of a plain version: its int64 temporaries stay under
#: about 256 MB
PLAIN_ELEMS = 1 << 23


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is an int32 CUDA tensor on one device, False
    when every one lies on the CPU; raises on anything else (mixed devices,
    another dtype, a non-contiguous tensor for the kernel). One pass over
    the tensors: it runs before every launch."""
    dev = tensors[0].device
    cuda = dev.type == "cuda"
    if not cuda and dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on several devices: {dev} "
                             f"and {t.device}")
        if cuda and not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors")
    return cuda


_WORKSPACES = {}


def workspace(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """A zeroed int64 tensor of at least n elements on the CUDA `device`,
    kept for the kernels launched on `stream` (its raw handle). A kernel
    that takes it leaves it zeroed (its last block resets the finish counter
    and the sums it used), so it is zeroed once, when it is made or grown,
    and a call costs no memset. Launches on one stream run in order, so two
    never hold it at once."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n:
        ws = torch.zeros(max(n, 1024), dtype=torch.int64, device=device)
        _WORKSPACES[key] = ws
    return ws


def n_blocks(work_items: int) -> int:
    return max(1, min(GRID_CAP, -(-work_items // BLOCK)))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words read as uint32, as int64.

    Torch has no popcount op, sign-extends int32 on widening and shifts
    int32 arithmetically, so the word is widened to int64 and masked to
    its low 32 bits before the SWAR reduction (bit 31 counts as one bit)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF

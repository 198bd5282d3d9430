"""Device resolution: the one place that turns a device request into a
torch.device.

A CUDA request is honoured or refused: when CUDA is asked for and no card
is visible this raises, and nothing falls back to the CPU on its own. The
CPU is used only when the caller names it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available "
                "(pass device='cpu' to run the plain PyTorch path)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

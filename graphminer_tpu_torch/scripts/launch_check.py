"""Smallest build-and-launch check of the port's kernel library.

The port of scripts/repro_mosaic_hang.py, which pinned a TPU runtime that
never returned from compiling a trivial Pallas kernel. Here the same
kernel, o = 2 * x on one [8, 128] int32 block, is kernel R
(ops/cuda_check.py): this builds the library if needed, launches R once,
waits for it and checks the result against 2 * x.

    python -m graphminer_tpu_torch.scripts.launch_check [--device cuda|cpu]

Prints "OK: <o[0, 0]> in <s>s" and exits 0, or raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..ops.cuda_check import times_two


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    x = torch.ones((8, 128), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    out = times_two(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    if not torch.equal(out, x * 2):
        raise RuntimeError("times_two: kernel result != 2 * x")
    print(f"OK: {int(out[0, 0])} in {secs:.1f}s", flush=True)
    return secs


if __name__ == "__main__":
    main()

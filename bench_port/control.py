"""The control of the benchmark's correctness check, run on the card.

    python3 bench_port/control.py --workload <cell> --seconds <s>
                                  --seeds <n> [<n> ...]

For each seed it runs the cell through the harness's own run_cell, at the
cell's own configuration and mix, with the program's entry replaced by
bench_port/entries/control_float32.py: the plain reference with its count
accumulated in float32. The run's own comparison with the int64 reference
then judges the control's counts, so each run must come out with
"correct" false; its count_gap_max is the control's reading. One JSON
line a seed; the benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench_port.run import run_cell  # noqa: E402

#: the configuration key that puts the control in the program's place
OVERRIDE = {"entry": "control_float32"}


def control_run(root: str, workload: str, seed: int, seconds: float,
                device_type: str = "cuda", config_override=None) -> dict:
    """A run of `workload` with the control as its entry: run_cell's
    result."""
    return run_cell(root, workload, seed, seconds, False, device_type,
                    {**(config_override or {}), **OVERRIDE})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = control_run(ROOT, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"],
                          "count": r["graph"]["count"],
                          "checks": r["checks"],
                          "seconds": time.perf_counter() - t0,
                          "kind": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

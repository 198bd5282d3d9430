"""The control of the correctness check, put in the program's place: the
plain reference (bench_port/reference/counts.py) with its count
accumulated in float32, a 24-bit mantissa, below the int64 that a
configuration states. Set-up hands it the generated CSR on the cell's
first device; every count() counts that graph anew. A run of a cell with
"entry": "control_float32" must come out not correct wherever the count
passes 2^24 (bench_port/control.py runs it; the benchmark's own runs
never do)."""
from __future__ import annotations

import torch

from bench_port.reference import counts


class Control:
    def __init__(self, pattern: str, rowptr: torch.Tensor,
                 colidx: torch.Tensor):
        self.pattern, self.rowptr, self.colidx = pattern, rowptr, colidx

    def count(self) -> int:
        return counts.count(self.pattern, self.rowptr, self.colidx,
                            "float32")


def prepare(rowptr, colidx, config, devices, span):
    with span("build", devices[:1]):
        ctl = Control(config["pattern"],
                      torch.from_numpy(rowptr).to(devices[0]),
                      torch.from_numpy(colidx).to(devices[0]))
    return ctl

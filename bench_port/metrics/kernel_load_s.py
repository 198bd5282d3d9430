"""kernel_load_s: the self time (s) of the program's kernels.load span in
set-up: the kernel library loaded at first use, built by nvcc first where
the checkout has none (bench_port/spans.py)."""
from bench_port import spans


def read(run):
    return spans.setup_self_s(run, "kernels.load")

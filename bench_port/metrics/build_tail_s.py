"""build_tail_s: the self time (s) of the program's build.tail spans in
set-up: the clique engine's sub-core tail, counted by the frontier engine at
build (bench_port/spans.py)."""
from bench_port import spans


def read(run):
    return spans.setup_self_s(run, "build.tail")

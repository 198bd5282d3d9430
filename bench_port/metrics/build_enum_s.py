"""build_enum_s: the self time (s) of the program's build.enumerate spans in
set-up: the clique engine's host task enumerator (bench_port/spans.py)."""
from bench_port import spans


def read(run):
    return spans.setup_self_s(run, "build.enumerate")

"""build_pack_s: the self time (s) of the program's build.pack spans in
set-up: the layouts' host numpy packing and the host side of the kernels'
plans (bench_port/spans.py)."""
from bench_port import spans


def read(run):
    return spans.setup_self_s(run, "build.pack")

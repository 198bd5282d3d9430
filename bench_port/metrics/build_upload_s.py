"""build_upload_s: the self time (s) of the program's build.upload spans in
set-up: the layouts' host-to-device copies, as long as they hold the host
(bench_port/spans.py)."""
from bench_port import spans


def read(run):
    return spans.setup_self_s(run, "build.upload")

"""prep_s: the host clock around the entry's relabel and orientation in
set-up (the "prep" span; s)."""


def read(run):
    return run.spans.get("prep")

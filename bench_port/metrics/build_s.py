"""build_s: the host clock around the engine's constructor, ending in a
synchronize (the "build" span; s)."""


def read(run):
    return run.spans.get("build")

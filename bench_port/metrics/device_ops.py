"""device_ops: device events (kernels, copies, memsets) that torch.profiler
recorded in the traced window, over the counts completed in it."""


def read(run):
    if run.trace is None or not run.ok_calls:
        return None
    n = len(run.trace.in_window())
    return n / len(run.ok_calls) if n else None

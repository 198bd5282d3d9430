"""idle_share.repeat: 1 - (union of the device events) / the traced window,
in %, averaged over the cell's cards."""


def read(run):
    if run.trace is None or not run.trace.in_window():
        return None
    return run.trace.mean_idle_pct(run.n_devices)

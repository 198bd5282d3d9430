"""clique4_idle_share: idle_share.repeat of the 4-clique cells: 1 - (union
of the device events) / the traced window, in %, averaged over the cell's
cards. A metric of its own, moving clique4_count_ms."""


def read(run):
    if run.trace is None or not run.trace.in_window():
        return None
    return run.trace.mean_idle_pct(run.n_devices)

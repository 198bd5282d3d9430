"""count_roofline: a count's least time on one H100 over its device time
(%). The least time reads the same work whatever implements it: the
oriented graph's CSR read once (int32 row pointers and column ids) and one
int64 written, over the HBM bandwidth. The device time is the sum of the
device events in the traced window over the counts completed in it."""
from bench_port import stats


def read(run):
    if run.trace is None or not run.ok_calls:
        return None
    events = run.trace.in_window()
    if not events:
        return None
    device_s = sum(min(e, run.trace.hi) - max(s, run.trace.lo)
                   for _, s, e, _ in events) / 1e6 / len(run.ok_calls)
    least = stats.least_seconds(stats.csr_bytes(run.n_vertices,
                                                run.n_dag_edges))
    return 100.0 * least / device_s

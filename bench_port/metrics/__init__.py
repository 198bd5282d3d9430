"""One reader a metric, in a file named after it (`<name>.py`, dots kept):

    read(run) -> float or None

`run` is bench_port.run.Run: the window's calls and length, set-up spans,
the graph's sizes and, in a --trace 1 run, the window's Trace. A reader that
finds nothing to read returns None, and the harness leaves the metric out
of the result."""

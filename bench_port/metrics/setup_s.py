"""setup_s: from the process's start to the first timed call (s): CUDA's
start, the graph made on the card, the host preparation, the layout build,
the kernel library loaded and the warm-up calls."""


def read(run):
    return run.setup_s

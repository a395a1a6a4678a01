"""KKT solves completed in the window over the window's seconds."""

from benchmark.stats import rate


def read(run):
    return rate(run.calls * run.batch, run.window_s)

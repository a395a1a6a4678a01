"""The 95th percentile over every call of the window of the time from the
call's start to its outputs being ready, in ms."""

from benchmark.stats import percentile


def read(run):
    return 1e3 * percentile(run.call_s, 95)

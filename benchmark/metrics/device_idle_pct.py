"""The share of the profiled stretch, from the first call's start to the
last call's end, in which no device operation runs, in %."""

from benchmark.stats import busy_seconds


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    busy = busy_seconds([(a, b) for _, a, b in tl.ops], tl.start, tl.end)
    return 100.0 * (1.0 - busy / tl.seconds)

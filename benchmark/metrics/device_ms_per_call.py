"""Device time of every operation launched in the profiled stretch (the
profiler's trace), over the calls in it, in ms."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    return 1e3 * sum(b - a for _, a, b in tl.ops_in_window()) / tl.calls

"""Mean over the window's calls of the host time from entry to return of
the program's solve call (before the device synchronise), in us."""


def read(run):
    if not run.host_call_s:
        return None
    return 1e6 * sum(run.host_call_s) / len(run.host_call_s)

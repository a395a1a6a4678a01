"""The host's own time around the program's solve: over the profiled
stretch's calls, the time in the benchmark's ``bench.solve_batched`` spans
that neither the program's ``gato.solve`` spans nor a device operation
covers (the CSR packing, the staging's host side, the lists returned), in
us; nothing where the trace holds no ``gato.solve`` span."""

from benchmark.span_times import uncovered_seconds

OUTER, SOLVE = "bench.solve_batched", "gato.solve"


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    solves = [(a, b) for n, a, b in tl.program_spans if n == SOLVE]
    if not solves:
        return None
    outers = [(a, b) for n, a, b in tl.spans if n == OUTER]
    ops = [(a, b) for _, a, b in tl.ops]
    return 1e6 * uncovered_seconds(outers, solves + ops) / tl.calls

"""Time in the program's ``gato.launch`` spans over the profiled stretch's
calls, in us (``span_times.split``)."""

from benchmark.span_times import split


def read(run):
    tl = run.timeline
    return None if tl is None else split(tl.program_spans, tl.calls)["launch_us"]

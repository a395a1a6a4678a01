"""The program's ``gato.launch`` spans (calls into the kernel library)
over the profiled stretch's calls (``span_times.split``)."""

from benchmark.span_times import split


def read(run):
    tl = run.timeline
    return None if tl is None else split(tl.program_spans, tl.calls)["launches_per_call"]

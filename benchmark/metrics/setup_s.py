"""Seconds from the process's start to the first timed call: imports, the
kernel library's build or load, the inputs made, the warm-up."""


def read(run):
    return run.setup_s

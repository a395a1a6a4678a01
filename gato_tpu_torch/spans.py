"""Named spans of the solve path on ``torch.profiler``'s clock.

``with span("gato.stage"): ...`` records a span of that name in the
profiler's trace, beside the CUDA kernels and on the same clock, while a
``torch.profiler`` session runs (for example :func:`debug.trace`); the
profiler keeps the spans and writes them into its Chrome trace.  With no
session running, ``span`` reads one flag and returns a shared no-op
context: it enters no RecordFunction.

The spans of a solve, nested as they run:

* ``gato.solve_batched`` (``gato.solve`` in ``solve``): the entry's body;
* ``gato.route``: backend validation and selection (``_resolve_backend``);
* ``gato.stage``: the inputs moved, checked and lam0 made (``_stage``);
* ``gato.solve_core``: the kernel wrapper, its checks, plan and outputs,
  or on the ``'torch'`` backend the whole plain solve (``_solve_core``);
* ``gato.launch``: one call into the kernel library (``_build.launch``),
  inside ``gato.solve_core`` on a kernel backend.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records span ``name`` inside a ``torch.profiler``
    session, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return _record(name)
    return _OFF


def _record(name: str):
    # The fast RecordFunction where this torch has it (it exports as a
    # ``cpu_op`` event), else record_function (``user_annotation``).
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    return torch.profiler.record_function(name)

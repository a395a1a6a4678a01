"""Named spans of the solve path on ``torch.profiler``'s clock.

``with span("gato.stage"): ...`` records a span of that name in the
profiler's trace, beside the CUDA kernels and on the same clock, while a
``torch.profiler`` session runs (for example :func:`debug.trace`); the
profiler keeps the spans and writes them into its Chrome trace.  With no
session running, ``span`` reads one flag and returns a shared no-op
context: it enters no RecordFunction.

The spans of a solve, nested as they run:

* ``gato.solve_batched`` (``gato.solve`` in ``solve``): the entry's body;
* ``gato.route``: backend validation and selection; in ``solve_batched``
  the lookup of the call signature's launch plan (``solver.launch_plan``);
* ``gato.plan``: inside ``gato.route``, only on the first call of a
  signature (a miss): the plan built, the route (``_resolve_backend``) and
  the kernel's launch plan with it;
* ``gato.stage``: the inputs moved, checked and lam0 made (``_stage``); on
  a plan hit whose tensors are already staged, only the check that they
  are (their dtype, device, contiguity and shape);
* ``gato.solve_core``: the kernel wrapper, its checks, plan and outputs,
  or on the ``'torch'`` backend the whole plain solve (``_solve_core``);
  on such a hit to kernel B or row 4, the outputs' allocation and the
  launch only;
* ``gato.launch``: one call into the kernel library (``_build.launch``),
  inside ``gato.solve_core`` on a kernel backend.

``solver.PLAN_BUILDS`` and ``solver.PLAN_HITS`` count the plans built and
the lookups that found one: with the ``gato.plan`` spans they show how
often the plan engages.
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

"""A profiled stretch of calls, read back as a device timeline.

``profile`` runs calls under ``torch.profiler`` (CPU and CUDA activities),
each call inside the benchmark's own spans (``record_function``), exports
the Chrome trace to a temporary file and reads from it the device's
operations (kernels, copies and fills), the benchmark's spans and the
program's own (``gato.`` names), on one clock.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
# The program's spans: exported as ``cpu_op`` by the fast RecordFunction,
# as ``user_annotation`` by ``record_function``.
PROGRAM_PREFIX = "gato."
PROGRAM_CATS = ("user_annotation", "cpu_op")
CALL_SPAN = "bench.call"
# The host between the benchmark's spans: its loop's own bookkeeping.
LOOP = "bench.loop"
TRIES = 3


class Timeline(NamedTuple):
    ops: list      # (name, start_s, end_s) of each device operation
    spans: list    # (name, start_s, end_s) of each benchmark span
    start: float   # the first call's start (s)
    end: float     # the last call's end (s)
    calls: int     # calls profiled
    program_spans: list = []  # (name, start_s, end_s) of each program span

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def ops_in_window(self) -> list:
        return [(n, a, b) for n, a, b in self.ops if b > self.start and a < self.end]


def from_chrome(events: list) -> Timeline | None:
    """The timeline of a Chrome trace's events; None where it holds no
    call span or no device operation."""
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0.0)) * 1e-6
        if e.get("cat") in DEVICE_CATS:
            ops.append((e["name"], a, b))
        elif e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.append((e["name"], a, b))
    calls = [sp for sp in spans if sp[0] == CALL_SPAN]
    if not calls or not ops:
        return None
    return Timeline(sorted(ops, key=lambda o: o[1]), sorted(spans, key=lambda sp: sp[1]),
                    min(sp[1] for sp in calls), max(sp[2] for sp in calls), len(calls),
                    program_spans(events))


def program_spans(events: list) -> list:
    """(name, start_s, end_s) of each program span (``gato.`` name, a
    ``user_annotation`` or ``cpu_op`` event) of a Chrome trace, by start."""
    found = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in PROGRAM_CATS
                and e["name"].startswith(PROGRAM_PREFIX)):
            a = float(e["ts"]) * 1e-6
            found.append((e["name"], a, a + float(e.get("dur", 0.0)) * 1e-6))
    return sorted(found, key=lambda sp: (sp[1], -sp[2]))


def host_span_at(spans: list, t: float) -> str:
    """The innermost benchmark span that holds time ``t``, or LOOP."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return LOOP if best is None else best[0]


def profile(run_calls, n_calls: int) -> Timeline | None:
    """Run ``run_calls(n_calls, span)`` under the profiler, where ``span``
    is ``torch.profiler.record_function`` and each call ends in a device
    synchronise; returns the timeline, taking the
    session again (TRIES in all) where it recorded no device operation,
    which a session on the card has done now and then."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    for _ in range(TRIES):
        with torch_profile(activities=activities) as prof:
            run_calls(n_calls, record_function)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        timeline = from_chrome(events)
        if timeline is not None:
            return timeline
    return None

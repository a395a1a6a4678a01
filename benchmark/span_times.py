"""The program's spans (``trace.Timeline.program_spans``) read as times a
call: the split of the dispatch by ``gato.route``, ``gato.stage``,
``gato.solve_core`` and ``gato.launch``, and the host's own time around a
span, with the device's operations taken out."""

from __future__ import annotations

from . import stats


def total(spans: list, name: str):
    """(summed seconds, count) of the spans named ``name``; None where
    there is none."""
    durations = [b - a for n, a, b in spans if n == name]
    return (sum(durations), len(durations)) if durations else None


def self_seconds(spans: list, outer: str, inner: str):
    """Summed duration of the ``outer`` spans less what the ``inner`` spans
    inside them cover."""
    outers = [(a, b) for n, a, b in spans if n == outer]
    if not outers:
        return None
    inners = [(a, b) for n, a, b in spans if n == inner]
    return sum((b - a) - sum(min(y, b) - max(x, a) for x, y in inners if x < b and y > a)
               for a, b in outers)


def split(spans: list, calls: int) -> dict:
    """Per call of ``calls``, in us: ``route_us``, ``stage_us``,
    ``launch_us`` (the spans' summed durations), ``wrapper_us`` (the
    ``gato.solve_core`` spans less their ``gato.launch`` children),
    ``launches_per_call``; and ``solve_batched_us``, the mean
    ``gato.solve_batched`` span, ``covered_pct``, the share of it the four
    times cover, and ``remainder_us``, what they leave.  A value whose span
    the trace lacks is None."""
    out = {}
    for key, name in (("route_us", "gato.route"), ("stage_us", "gato.stage"),
                      ("launch_us", "gato.launch")):
        found = total(spans, name)
        out[key] = None if found is None else 1e6 * found[0] / calls
    wrapper = self_seconds(spans, "gato.solve_core", "gato.launch")
    out["wrapper_us"] = None if wrapper is None else 1e6 * wrapper / calls
    launches = total(spans, "gato.launch")
    out["launches_per_call"] = None if launches is None else launches[1] / calls
    entry = total(spans, "gato.solve_batched")
    out["solve_batched_us"] = None if entry is None else 1e6 * entry[0] / entry[1]
    parts = [out[k] for k in ("route_us", "stage_us", "wrapper_us")]
    if entry is not None and None not in parts:
        covered = sum(parts) + (out["launch_us"] or 0.0)
        out["covered_pct"] = 100.0 * covered / out["solve_batched_us"]
        out["remainder_us"] = out["solve_batched_us"] - covered
    return out


def uncovered_seconds(outers: list, covers: list) -> float:
    """Summed time of the ``outers`` ((start, end) pairs) that none of the
    ``covers`` covers."""
    total_s = 0.0
    for a, b in outers:
        inside = [(x, y) for x, y in covers if x < b and y > a]
        total_s += sum(hi - lo for lo, hi in stats.idle_gaps(inside, a, b))
    return total_s

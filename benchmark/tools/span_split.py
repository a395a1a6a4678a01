"""The split of one cell's ``solve_batched`` by the program's own spans
(``gato.route``, ``gato.stage``, ``gato.solve_core``, ``gato.launch``), in
a profiled stretch run as ``harness.measure`` runs its own, beside
``host_call_us`` of an unprofiled window and the cost of the span sites.

    python benchmark/tools/span_split.py --workload <name> --seed <n> \\
        [--seconds 10] [--device cuda:0] [--sites 200000] [--out split.jsonl]

Prints one JSON line: ``host_call_us`` (mean host time of a window call);
``split``, us a profiled call (:func:`split`); with device operations in
the trace, ``device_idle_pct``, ``bench_solve_batched_us`` (the mean
``bench.solve_batched`` span) and the ``breakdown`` of ``harness``, its
idle gaps cut at the program's spans as well as the benchmark's;
``sites_off_us`` and ``sites_on_us``, the five span sites of one solve
opened and closed with no profiler and inside a CPU profiler session, less
the same function without them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from benchmark import generator, harness, stats, trace  # noqa: E402

PREFIX = "gato."
CATS = ("user_annotation", "cpu_op")
CALL_SPAN = "bench.call"


def program_spans(events: list) -> list:
    """(name, start_s, end_s) of each program span (``gato.`` name, a
    ``user_annotation`` or ``cpu_op`` event) of a Chrome trace, by start."""
    found = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in CATS and e["name"].startswith(PREFIX):
            a = float(e["ts"]) * 1e-6
            found.append((e["name"], a, a + float(e.get("dur", 0.0)) * 1e-6))
    return sorted(found, key=lambda sp: (sp[1], -sp[2]))


def _total(spans: list, name: str):
    durations = [b - a for n, a, b in spans if n == name]
    return (sum(durations), len(durations)) if durations else None


def _self_seconds(spans: list, outer: str, inner: str):
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
        total = _total(spans, name)
        out[key] = None if total is None else 1e6 * total[0] / calls
    wrapper = _self_seconds(spans, "gato.solve_core", "gato.launch")
    out["wrapper_us"] = None if wrapper is None else 1e6 * wrapper / calls
    launches = _total(spans, "gato.launch")
    out["launches_per_call"] = None if launches is None else launches[1] / calls
    entry = _total(spans, "gato.solve_batched")
    out["solve_batched_us"] = None if entry is None else 1e6 * entry[0] / entry[1]
    parts = [out[k] for k in ("route_us", "stage_us", "wrapper_us")]
    if entry is not None and None not in parts:
        covered = sum(parts) + (out["launch_us"] or 0.0)
        out["covered_pct"] = 100.0 * covered / out["solve_batched_us"]
        out["remainder_us"] = out["solve_batched_us"] - covered
    return out


def breakdown(tl: trace.Timeline, spans: list) -> dict:
    """``harness``'s breakdown of ``tl`` with its idle gaps cut at the
    program's ``spans`` as well as at the benchmark's: each piece is named
    by the innermost span of either that holds it."""
    both = sorted(tl.spans + spans, key=lambda sp: sp[1])
    return harness._breakdown(tl._replace(spans=both))


def site_cost(n: int, profiled: bool) -> float:
    """us a call that the five span sites of one solve add to a function
    that does nothing else (best of five runs of ``n`` calls)."""
    from gato_tpu_torch.spans import span

    def bare():
        pass

    def sites():
        with span("gato.solve_batched"):
            with span("gato.route"):
                pass
            with span("gato.stage"):
                pass
            with span("gato.solve_core"):
                with span("gato.launch"):
                    pass

    def best(fn):
        return min(timeit.repeat(fn, number=n, repeat=5)) / n

    if not profiled:
        return 1e6 * (best(sites) - best(bare))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        return 1e6 * (best(sites) - best(bare))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--sites", type=int, default=200000,
                    help="calls a run of the site microbenchmark; 0 skips it")
    ap.add_argument("--traffic", action="append", default=[],
                    help="key=value (JSON) in place of the traffic file's")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    for item in args.traffic:
        key, value = item.split("=", 1)
        cell.traffic[key] = json.loads(value)
    tr, cfg = cell.traffic, cell.config
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prepare, solve = harness.program(cell, dev)
    B, K, s, c = int(tr["batch"]), cfg["knot_points"], cfg["state_size"], cfg["control_size"]
    P = generator.pool_size(float(tr["pool_mb"]), B, K, s, c)
    pool = [prepare(f) for f in generator.make_pool(P, B, K, s, c, args.seed, dev)]
    harness._loop(pool, solve, sync, float(tr["warmup_s"]), harness.Sampler(1, args.seed))
    _, call_s, host_s = harness._loop(pool, solve, sync, args.seconds,
                                      harness.Sampler(1, args.seed))

    n_calls = int(tr["profile_calls"])
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    # As trace.profile does: a session on the card that recorded no device
    # operation is taken again.
    for _ in range(trace.TRIES):
        with profile(activities=activities) as prof:
            for j in range(n_calls):
                with record_function(CALL_SPAN):
                    with record_function("bench.solve_batched"):
                        res = solve(pool[(len(call_s) + j) % P])
                    with record_function("bench.sync"):
                        sync()
                del res
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        tl = trace.from_chrome(events)
        if tl is not None or not on_card:
            break

    spans = program_spans(events)
    line = {"workload": args.workload, "seed": args.seed, "device": str(dev),
            "card": harness.power_limit() if on_card else "cpu",
            "host_call_us": 1e6 * sum(host_s) / len(host_s), "window_calls": len(call_s),
            "profiled_calls": n_calls, "split": split(spans, n_calls)}
    if tl is not None:
        busy = stats.busy_seconds([(a, b) for _, a, b in tl.ops], tl.start, tl.end)
        line["device_idle_pct"] = 100.0 * (1.0 - busy / tl.seconds)
        entry = [b - a for n, a, b in tl.spans if n == "bench.solve_batched"]
        line["bench_solve_batched_us"] = 1e6 * sum(entry) / len(entry)
        line["breakdown"] = breakdown(tl, spans)
    if args.sites:
        line["sites_off_us"] = site_cost(args.sites, False)
        line["sites_on_us"] = site_cost(max(1, args.sites // 20), True)
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The split of one cell's ``solve_batched`` by the program's own spans
(``gato.route``, ``gato.stage``, ``gato.solve_core``, ``gato.launch``), in
a profiled stretch run as ``harness.measure`` runs its own, beside
``host_call_us`` of an unprofiled window and the cost of the span sites.

    python benchmark/tools/span_split.py --workload <name> --seed <n> \\
        [--seconds 10] [--device cuda:0] [--sites 200000] [--out split.jsonl]

Prints one JSON line: ``host_call_us`` (mean host time of a window call);
``split``, us a profiled call (:func:`split`); with device operations in
the trace, ``device_idle_pct``, ``bench_solve_batched_us`` (the mean
``bench.solve_batched`` span) and the ``breakdown`` of ``harness``;
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
from benchmark.span_times import split  # noqa: E402
from benchmark.trace import program_spans  # noqa: E402

CALL_SPAN = "bench.call"


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
    prepare, solve = harness.entry_of(cell).program(cell, dev)
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
        line["breakdown"] = harness._breakdown(tl)
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

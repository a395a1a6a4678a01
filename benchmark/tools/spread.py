"""Sets of runs of one cell, each run a process of its own as the check
makes it, and each metric's spread in each set.

    python benchmark/tools/spread.py --workload <name> --seeds 1,2,3,4,5,6 \\
        [--sets 2] [--seconds 10] [--trace 0] [--out runs.jsonl]

Every set runs the same seeds in the same order.  A spread is the distance
between the first and the third quartile over the median
(``statistics.quantiles``, n = 4).  Prints one JSON line a run and one a
set, and last the widest spread of each metric.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from benchmark.stats import spread  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        print(json.dumps(obj), flush=True)
        if out:
            out.write(json.dumps(obj) + "\n")
            out.flush()

    widest = {}
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "benchmark/run.py", "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds),
                 "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
            emit({"workload": args.workload, "set": k, "seed": seed,
                  "rc": proc.returncode, "wall_s": wall, "result": result,
                  "stderr_tail": proc.stderr[-1500:] if result is None else ""})
            if result is not None:
                runs.append(result)
        names = sorted({m for r in runs for m in r["metrics"]})
        per = {}
        for m in names:
            values = [r["metrics"][m]["value"] for r in runs if m in r["metrics"]]
            if len(values) >= 2:
                per[m] = {"median": statistics.median(values),
                          "spread": spread(values), "values": values}
                widest[m] = max(widest.get(m, 0.0), per[m]["spread"])
        emit({"workload": args.workload, "set": k, "correct": [r["correct"] for r in runs],
              "metrics": per})
    emit({"workload": args.workload, "widest_spread": widest})
    return 0


if __name__ == "__main__":
    sys.exit(main())

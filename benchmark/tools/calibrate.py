"""Readings for the limits of ``correct``: the numbers compared, for the
program (the cell's entry, ``harness.entry_of``) on many seeds, and on a
few for the control (the reference at TF32 in the program's place) and, in
PCG cells, for an early stop (the program with its exit tolerance loosened
``--early-stop`` times), each a short window at the cell's own load, all in
one process.

    python benchmark/tools/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--fault-seeds 10,11,12] [--seconds 2] \\
        [--out readings.jsonl]

Prints one JSON line a run, then of each number the lower reading (the
largest the program gives) and the smallest that the control and the
early stop give.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--early-stop", type=float, default=20.0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--traffic", action="append", default=[],
                    help="key=value (JSON) in place of the traffic file's, to try a mix")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import torch
    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    for item in args.traffic:
        key, value = item.split("=", 1)
        cell.traffic[key] = json.loads(value)

    program, to_result = harness.entry_of(cell)

    def early_stop(cell, device):
        solver = dict(cell.config["solver"])
        solver["exit_tol"] *= args.early_stop
        return program(
            dataclasses.replace(cell, config=dict(cell.config, solver=solver)), device)

    faults = args.fault_seeds if cell.traffic["method"] == "pcg" else ""
    lines = []
    for who, seeds, solver, read in (
            ("program", args.seeds, program, to_result),
            ("control", args.control_seeds, harness.control, None),
            ("early_stop", faults, early_stop, to_result)):
        for seed in (int(x) for x in seeds.split(",") if x):
            r = harness.measure(cell, seed, args.seconds, False, solver=solver,
                                to_result=read, device="cuda:0")
            line = {"workload": args.workload, "who": who, "seed": seed,
                    "correct": r["correct"], "attempted": r["attempted"],
                    "numbers": {k: v["value"] for k, v in r["checks"].items()},
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                    "traffic": cell.traffic}
            print(json.dumps(line), flush=True)
            lines.append(line)
            torch.cuda.empty_cache()
    summary = {}
    for name in cell.limits:
        read = {who: [ln["numbers"][name] for ln in lines if ln["who"] == who]
                for who in ("program", "control", "early_stop")}
        summary[name] = {"lower": max(read["program"], default=None),
                         "control": min(read["control"], default=None),
                         "early_stop": min(read["early_stop"], default=None),
                         "limit": cell.limits[name]}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [{"workload": args.workload, "summary": summary}]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

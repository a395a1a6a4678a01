"""Run one cell of the benchmark on this machine's card and print its result.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers are the last lines of standard error.  Exit codes: 2 where
the card the cell asks for is missing, 3 where a module of JAX or of the
JAX package was loaded, 1 on any other failure; no result is printed then.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # Build and kernel caches at fixed paths inside the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{found} found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                             device="cuda:0", t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"run.py: modules of JAX or of the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    print("set-up, seconds from the start to the end of each step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_split_s"].items()), file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel B's time by stage, and its and the farm kernel's times by batch,
for the gato_tpu_torch of any checkout, on one CUDA card.

    python3 gato_tpu_torch/tools/stage_split.py [--root ROOT] [--runs N]
                                                [--sizes S,C,K]

Imports gato_tpu_torch from the checkout at ROOT (default: this one),
building its kernels there, so that one call can set a parent's kernels
beside this tree's.  ``--sizes`` gives the state size, control size and
knots of every problem (default 14,7,50: IIWA; 36,12,57 is the quadruped's
<36, 12> body).  Prints JSON lines, each with the card's name and power
limit and the sizes:

* ``times``: kernel B (``fused_solve_cuda``) on testing.random_batch
  problems, B = 1, 4, 16, 64, 256, rho 1e-3, exit_tol 1e-6, the symmetric
  stair, and, where the farm kernel takes the sizes (``fused_sequence.
  fits``; not above 32), the farm kernel (``fused_sequence_cuda``) on farms
  of B = 1 and 256 streams of T = 16 steps (testing.random_farm, per-step
  rho 1e-3 / 2e-3): CUDA events,
  the median of ``runs`` launches after three, with the cluster size each
  launch took where the checkout has one (``LAST_CLUSTER``); and
  ``call_us_b1``, the host time of one kernel-B call at B = 1 (lambda_0
  given) among 200 back-to-back calls.
* ``truncated``: the split by truncated bodies, for any checkout: the whole
  solve; ``max_iters = 0`` (condensation, preconditioner, the PCG set-up and
  the recovery); the same with scalar Jacobi (whose preconditioner is one
  division a row).  The PCG loop is the first less the second, the stair's
  preconditioner (theta^{-1} and its off-diagonal blocks) the second less
  the third, and the third is the condensation with the set-up and the
  recovery.
* ``stamps`` (a checkout whose library exports ``gato_fused_stage_stamps``):
  in a child process, the kernels built again with ``-DGATO_STAGE_STAMPS``
  (a separate library; the shipped build is untouched), whose CTA 0 reads
  ``%globaltimer`` at the start and after each stage: the Gauss-Jordan of
  Q and of R, the products of S (together the condensation), theta's
  inverse and the stair's blocks (the preconditioner), the PCG set-up and
  loop, the recovery; the medians of each stage over ``runs`` launches, in
  us.  Those stamps add a CTA barrier at each point.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

BATCHES = (1, 4, 16, 64, 256)
FARM_STREAMS = (1, 256)
T_STEPS = 16
KW = dict(rho=1e-3, exit_tol=1e-6, max_iters=100)


def _import(root: str):
    sys.path.insert(0, str(Path(root).resolve()))
    import gato_tpu_torch as gt

    if not gt.__file__.startswith(str(Path(root).resolve())):
        raise SystemExit(f"imported {gt.__file__}, not the checkout at {root}")
    return gt


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int) -> float:
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def call_us(fn, calls: int = 200) -> float:
    """Host time of one call of ``calls`` back-to-back calls, the last
    synchronised: what the wrapper and the launch cost the host (the device
    finishes each launch sooner only where the call is the slower)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def measure(root: str, runs: int, sizes: tuple) -> list:
    """The ``times`` and ``truncated`` lines of the checkout at ``root``."""
    gt = _import(root)
    import torch

    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import fused_sequence as ks
    from gato_tpu_torch.kernels import fused_solve as kb

    dev = torch.device("cuda", 0)
    spec = gt.ProblemSpec(*sizes)
    full = gt.blocks_to_torch(tt.random_batch(spec, max(BATCHES), seed0=0), dev)
    name = card()
    out = {"what": "times", "root": root, "card": name, "sizes": list(sizes),
           "kernel_b": {}, "farm": {}}
    trunc = {"what": "truncated", "root": root, "card": name, "sizes": list(sizes)}
    one = gt.KKTBlocks(*(a[:1] for a in full))
    lam0 = torch.zeros_like(one.q)
    out["call_us_b1"] = call_us(lambda: kb.fused_solve_cuda(*one, lam0, **KW))
    for n in BATCHES:
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        ms = median_ms(lambda: kb.fused_solve_cuda(*blocks, **KW), runs)
        res = kb.fused_solve_cuda(*blocks, **KW)[0]
        out["kernel_b"][n] = {"ms": ms, "cluster": getattr(kb, "LAST_CLUSTER", None),
                              "iters_mean": float(res.iters.double().mean())}
        if n in (1, 256):
            row = {"whole": ms}
            for label, extra in (("no_loop", dict(max_iters=0)),
                                 ("no_loop_jacobi", dict(max_iters=0,
                                                         preconditioner="jacobi"))):
                row[label] = median_ms(
                    lambda: kb.fused_solve_cuda(*blocks, **dict(KW, **extra)), runs)
            row["pcg_loop"] = row["whole"] - row["no_loop"]
            row["stair_precond"] = row["no_loop"] - row["no_loop_jacobi"]
            row["condense_setup_recover"] = row["no_loop_jacobi"]
            trunc[n] = row
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if not ks.fits(spec.knot_points, spec.state_size, spec.control_size, limit):
        return [out, trunc]
    farm = gt.blocks_to_torch(tt.random_farm(spec, T_STEPS, max(FARM_STREAMS),
                                             seed0=500), dev)
    rhos = torch.tensor([1e-3 * (1 + t % 2) for t in range(T_STEPS)],
                        dtype=torch.float32, device=dev)
    for n in FARM_STREAMS:
        blocks = gt.KKTBlocks(*(a[:, :n] for a in farm))
        lam0 = torch.zeros_like(blocks.q[0])
        kw = dict(exit_tol=KW["exit_tol"], max_iters=KW["max_iters"])
        ms = median_ms(lambda: ks.fused_sequence_cuda(*blocks, lam0, rhos, **kw),
                       max(runs // 4, 5))
        out["farm"][n] = {"ms": ms, "cluster": getattr(ks, "LAST_CLUSTER", None)}
    return [out, trunc]


def stamps(root: str, runs: int, sizes: tuple) -> dict:
    """The ``stamps`` line (run in a child process: the stamped build must
    be chosen before the first CUDA call)."""
    gt = _import(root)
    import numpy as np
    import torch

    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import _build
    from gato_tpu_torch.kernels import fused_solve as kb

    _build.DEFINES = ("-DGATO_STAGE_STAMPS",)
    dev = torch.device("cuda", 0)
    read = _build.function("gato_fused_stage_stamps")
    full = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(*sizes), 256, seed0=0),
                              dev)
    stages = ("gj_q", "gj_r", "products", "gj_theta", "stair", "pcg_setup",
              "pcg_loop", "recover")
    buf = (ctypes.c_ulonglong * (len(stages) + 1))()
    line = {"what": "stamps", "root": root, "card": card(), "sizes": list(sizes)}
    for n in (1, 256):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        rows = []
        for i in range(runs + 3):
            kb.fused_solve_cuda(*blocks, **KW)
            torch.cuda.synchronize()
            if read(ctypes.cast(buf, ctypes.c_void_p)) != len(buf):
                raise RuntimeError("the stamped build returned no stamps")
            if i >= 3:
                rows.append(np.diff(np.array(list(buf), dtype=np.float64)) / 1e3)
        med = dict(zip(stages, map(float, np.median(np.array(rows), axis=0))))
        med.update(condense=med["gj_q"] + med["gj_r"] + med["products"],
                   precond=med["gj_theta"] + med["stair"],
                   pcg=med["pcg_setup"] + med["pcg_loop"],
                   total=float(np.median(np.array(rows).sum(axis=1))),
                   cluster=kb.LAST_CLUSTER, launches=runs)
        line[n] = med
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--sizes", default="14,7,50",
                    help="state size, control size, knots (default: IIWA's)")
    ap.add_argument("--stamps-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sizes = tuple(int(v) for v in args.sizes.split(","))
    if len(sizes) != 3:
        ap.error("--sizes takes S,C,K")
    if args.stamps_child:
        print(json.dumps(stamps(args.root, args.runs, sizes)))
        return
    for line in measure(args.root, args.runs, sizes):
        print(json.dumps(line), flush=True)
    from gato_tpu_torch.kernels import _build

    if hasattr(_build.library(), "gato_fused_stage_stamps"):
        child = subprocess.run([sys.executable, __file__, "--root", args.root,
                                "--runs", str(args.runs), "--sizes", args.sizes,
                                "--stamps-child"],
                               capture_output=True, text=True, timeout=1200)
        if child.returncode != 0:
            raise RuntimeError(f"stamps child failed:\n{child.stderr}")
        print(child.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()

"""The iteration floor of the PCG loops, on one CUDA card.

    python3 -m gato_tpu_torch.tools.probe_iter_floor [--scope block|grid|both]
        [--R TRIPS] [--T CHAIN]

The counterpart of ``tools/probe_iter_floor.py``.  Two measurements at each
of two scopes:

  null  row 16 (``kernels/probes.py``'s ``null_chain_cuda``): n_mv
        block-tridiagonal matvec contractions, n_dot reduce -> broadcast
        -> axpy steps and three freeze selects a trip, the op chain of a
        PCG iteration without the algorithm.  One launch of R trips against
        one of 2R (CUDA events, medians) gives ns a trip; sweeping (n_mv,
        n_dot) over (2,2), (1,2), (4,2), (2,1), (2,4) fits
        trip = c0 + c_mv n_mv + c_dot n_dot.  The data: probes.
        chain_operator (a knot's step 0.99 Q, Q orthogonal), where the
        dot steps hold |y| at a fixed point (2.4 to 5 at IIWA), so every
        trip takes the reciprocal 1 / (1 + sc) on a nonzero sc as the PCG
        loop's alpha = eta / nu does; each launch's y is checked finite
        and nonzero.  (The TPU probe's M of all ones and y0 of 0.5 contract
        y to exactly 0 within a few hundred trips at the port's matvec.)
  real  the solver's own iteration at exit_tol = 0 (every problem runs
        exactly max_iters), two max_iters through ``timing.time_solve``,
        at poly degree 1 and 2: 16 against 48 at block scope; 96 against
        192 at grid scope, where a chained step's host work (the long-K
        route's launches and allocations, ~1 ms on an H100's host) exceeds
        the device time of 16 to 48 iterations, so shorter chains would
        time the host.  Beside it, the same difference of one kernel
        launch alone (CUDA events): kernel B, or rows 8/10 on operators
        condensed once, the device's own cost of an iteration.

The TPU has one core; this card has a grid, so the chain runs at two
scopes:

  block  one CTA a problem, y in shared memory, the barriers of kernels A
         and B; real: kernel B (``'fused'``) at IIWA (14, 7, 50), B = 1.
  grid   one cooperative grid, y in global memory, a grid barrier after
         every phase (the long-K PCG's older schedule; rows 8/10 now meet
         twice an iteration and form their halo knots locally, so their
         iteration can fall below this chain's prediction); real: the
         ``'pcg_kernel'`` route at IIWA K = 1024, B = 1 (rows 7, 8/10, 13).

The summary sets the measured poly-1 iteration beside the chain's
prediction at the real body's op counts, c0 + 2 c_mv + 2 c_dot (the CUDA
loops are not unrolled, so a trip is an iteration).  Prints one JSON line
per probe.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from gato_tpu_torch import testing, timing
from gato_tpu_torch.formats import blocks_to_torch
from gato_tpu_torch.kernels import fused_solve, longk, probes
from gato_tpu_torch.problem import ProblemSpec, SolverOptions
from gato_tpu_torch.tools.probe_dispatch import cuda_device

GRID = ((2, 2), (1, 2), (4, 2), (2, 1), (2, 4))
SHAPES = {"block": 50, "grid": 1024}   # IIWA knots at each scope
REAL_BACKEND = {"block": "fused", "grid": "pcg_kernel"}
MAX_ITERS = {"block": (16, 48), "grid": (96, 192)}


def launch_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one fn() over ``reps`` runs, after one."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def chain_inputs(K: int, device):
    """One IIWA problem of K knots for the floor: M (1, K, 3, 14, 14) and
    y0 (1, K, 14) from probes.chain_operator."""
    return probes.chain_operator(1, K, testing.IIWA.state_size, seed=16, device=device)


def check_live(what: str, y: torch.Tensor) -> None:
    """Raises unless y is finite and its sum of squares (a dot step's sc) is
    nonzero: a chain that reached y == 0 would time another path."""
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: the chain's y is not finite after its trips")
    if not float((y * y).sum()) > 0:
        raise RuntimeError(f"{what}: the chain's y is zero after its trips")


def null_trip_ns(n_mv: int, n_dot: int, *, scope: str, R: int, reps: int,
                 M, y0, log=None) -> float:
    """ns a trip of row 16: one launch of 2R trips against one of R."""
    ts = {}
    for RR in (R, 2 * R):
        run = functools.partial(probes.null_chain_cuda, M, y0, n_mv=n_mv, n_dot=n_dot,
                                trips=RR, scope=scope)
        ts[RR] = launch_ms(run, reps)
        check_live(f"null {scope} (n_mv={n_mv}, n_dot={n_dot}) R={RR}", run())
        if log:
            log(f"  null {scope} (n_mv={n_mv}, n_dot={n_dot}) R={RR}: {ts[RR]:.4f} ms")
    return (ts[2 * R] - ts[R]) / R * 1e6


def fit_trip(rows: dict) -> tuple:
    """Least squares of trip = c0 + c_mv n_mv + c_dot n_dot over
    {(n_mv, n_dot): ns}; returns (c0, c_mv, c_dot)."""
    keys = list(rows)
    A = np.array([[1.0, m, d] for (m, d) in keys])
    b = np.array([rows[k] for k in keys])
    c0, c_mv, c_dot = np.linalg.lstsq(A, b, rcond=None)[0]
    return float(c0), float(c_mv), float(c_dot)


def probe_null(scope: str = "block", *, R: int = 20_000, reps: int = 7,
               device="cuda", log=None) -> dict:
    """Sweep (n_mv, n_dot) at ``scope``; fit the trip's cost."""
    dev = cuda_device(device)
    M, y0 = chain_inputs(SHAPES[scope], dev)
    rows = {key: null_trip_ns(*key, scope=scope, R=R, reps=reps, M=M, y0=y0, log=log)
            for key in GRID}
    c0, c_mv, c_dot = fit_trip(rows)
    return {
        "probe": "null_chain", "scope": scope, "K": SHAPES[scope], "R": R,
        "rows_ns": {f"mv{m}_dot{d}": rows[(m, d)] for (m, d) in GRID},
        "c0_ns_per_trip": c0, "c_mv_ns": c_mv, "c_dot_ns": c_dot,
        # the real poly-1 body: 2 matvecs + 2 dots (+ bookkeeping, in c0);
        # poly 2: 4 matvecs + 2 dots
        "predicted_poly1_iter_ns": c0 + 2 * c_mv + 2 * c_dot,
        "predicted_poly2_iter_ns": c0 + 4 * c_mv + 2 * c_dot,
    }


def probe_real(scope: str = "block", *, T: int = 64, reps: int = 7,
               device="cuda", log=None) -> dict:
    """The solver's own ns an iteration at exit_tol = 0, two max_iters
    (MAX_ITERS) through time_solve, at poly degree 1 and 2."""
    dev = cuda_device(device)
    spec = ProblemSpec(14, 7, SHAPES[scope])
    blocks = blocks_to_torch(testing.random_blocks(spec, seed=7), dev)
    out = {"probe": "real_kernel", "scope": scope, "K": spec.knot_points,
           "backend": REAL_BACKEND[scope]}
    kw = dict(T=T, reps=reps, device=dev, min_diff_ms=1.0, log=log)
    # A first chain at the route's shapes, discarded: it warms the card and
    # the allocator for the measured ones.
    lo, hi = MAX_ITERS[scope]
    timing.time_solve(spec, blocks, SolverOptions(rho=1e-3, exit_tol=0.0, max_iters=lo),
                      REAL_BACKEND[scope], n_independent=1, label="floor/warm-up", **kw)
    for poly in (1, 2):
        ts = {}
        for mi in (lo, hi):
            o = SolverOptions(rho=1e-3, exit_tol=0.0, max_iters=mi,
                              precond_poly_degree=poly)
            ts[mi], info = timing.time_solve(
                spec, blocks, o, REAL_BACKEND[scope],
                label=f"floor/{scope}/poly{poly}/maxit{mi}", **kw)
            out[f"poly{poly}_maxit{mi}_estimates_us"] = [1e3 * e for e in info["reps_ms"]]
            out[f"poly{poly}_maxit{mi}_us"] = ts[mi] * 1e3
        out[f"poly{poly}_per_iter_ns"] = (ts[hi] - ts[lo]) / (hi - lo) * 1e6
    out["poly2_over_poly1"] = out["poly2_per_iter_ns"] / out["poly1_per_iter_ns"]
    kkt = [a.unsqueeze(0) for a in blocks]
    ops = longk.condense_longk_cuda(*kkt, rho=1e-3) if scope == "grid" else None
    for poly in (1, 2):
        ms = {}
        for mi in (lo, hi):
            it = dict(exit_tol=0.0, max_iters=mi, poly_degree=poly)
            if ops is None:
                call = lambda: fused_solve.fused_solve_cuda(*kkt, rho=1e-3, **it)  # noqa: E731
            else:
                call = lambda: longk.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, **it)  # noqa: E731
            ms[mi] = launch_ms(call, reps)
        out[f"poly{poly}_kernel_per_iter_ns"] = (ms[hi] - ms[lo]) / (hi - lo) * 1e6
    return out


def summary(null: dict, real: dict) -> dict:
    return {
        "probe": "summary", "scope": null["scope"],
        "predicted_poly1_iter_ns": null["predicted_poly1_iter_ns"],
        "measured_poly1_iter_ns": real["poly1_per_iter_ns"],
        "measured_over_predicted": (real["poly1_per_iter_ns"]
                                    / null["predicted_poly1_iter_ns"]),
        "poly2_over_poly1_measured": real["poly2_over_poly1"],
        "kernel_poly1_iter_ns": real["poly1_kernel_per_iter_ns"],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scope", choices=("block", "grid", "both"), default="both")
    ap.add_argument("--R", type=int, default=20_000)
    ap.add_argument("--T", type=int, default=64)
    args = ap.parse_args(argv)

    def log(m):
        print(m, file=sys.stderr, flush=True)

    for scope in probes.SCOPES if args.scope == "both" else (args.scope,):
        null = probe_null(scope, R=args.R, log=log)
        print(json.dumps(null), flush=True)
        real = probe_real(scope, T=args.T, log=log)
        print(json.dumps(real), flush=True)
        print(json.dumps(summary(null, real)), flush=True)


if __name__ == "__main__":
    main()

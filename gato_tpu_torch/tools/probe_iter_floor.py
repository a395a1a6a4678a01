"""The iteration floor of the PCG loops, on one CUDA card.

    python3 -m gato_tpu_torch.tools.probe_iter_floor [--scope block|grid|both]
        [--R TRIPS] [--T CHAIN] [--halo H] [--problems B] [--null-only]

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

The TPU has one core; this card has a grid, and the chain runs on the
schedule of the kernel each scope bounds, meeting only where the chain's
dependences require it (csrc/probes.cu's note):

  block  kernel B's cluster: C CTAs a problem (fused_solve.cluster_size,
         16 at IIWA K = 50, B = 1), each with its knots' 0.01 M and y in
         shared memory, halo rows pushed into the neighbours' shared
         memory, a cluster_sum a reduction; a one-knot halo, so a cluster
         barrier between matvecs (three a trip at (2, 2)); real: kernel B
         (``'fused'``) at IIWA (14, 7, 50), B = 1.
  grid   rows 8/10's cooperative rounds (longk.pcg_rounds: 128 CTAs at
         K = 1024, B = 1, 0.01 M in shared memory), boundary rows
         published and pulled after grid_common.cuh's meetings, a halo of
         min(n_mv, a CTA's knots) knots, so the matvecs of a trip meet no
         other CTA (two meetings a trip at (2, 2)); real: the
         ``'pcg_kernel'`` route at IIWA K = 1024, B = 1 (rows 7, 8/10, 13).

``--halo`` forces the halo depth at both scopes (the plan's otherwise);
``--problems`` runs the null sweep on B problems in one launch (at the
grid scope a round of several problems meets on flagged partials, where
one problem meets on grid barriers); ``--null-only`` skips the real
iteration and the summary.
The summary sets the measured poly-1 iteration beside the chain's
prediction at the real body's op counts, c0 + 2 c_mv + 2 c_dot (the CUDA
loops are not unrolled, so a trip is an iteration), with the scope's C or
per, its halo and its meetings a trip; ``kernel_over_predicted`` >= 1 says
the probe is a floor of the kernel's own iteration.  Prints one JSON line
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
from gato_tpu_torch.kernels import _build, fused_solve, longk, probes
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


def chain_inputs(K: int, device, B: int = 1):
    """B IIWA problems of K knots for the floor: M (B, K, 3, 14, 14) and
    y0 (B, K, 14) from probes.chain_operator."""
    return probes.chain_operator(B, K, testing.IIWA.state_size, seed=16, device=device)


def check_live(what: str, y: torch.Tensor) -> None:
    """Raises unless y is finite and its sum of squares (a dot step's sc) is
    nonzero: a chain that reached y == 0 would time another path."""
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{what}: the chain's y is not finite after its trips")
    if not float((y * y).sum()) > 0:
        raise RuntimeError(f"{what}: the chain's y is zero after its trips")


def null_trip_ns(n_mv: int, n_dot: int, *, scope: str, R: int, reps: int,
                 M, y0, halo=None, log=None) -> float:
    """ns a trip of row 16: one launch of 2R trips against one of R."""
    ts = {}
    for RR in (R, 2 * R):
        run = functools.partial(probes.null_chain_cuda, M, y0, n_mv=n_mv, n_dot=n_dot,
                                trips=RR, scope=scope, _halo=halo)
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


def schedule(scope: str, K: int, device, halo=None, B: int = 1) -> dict:
    """The chain's schedule at ``scope`` for B IIWA problems of K knots at
    (n_mv, n_dot) = (2, 2): C or per (the first round's), the halo,
    meetings and __syncthreads a trip."""
    n_sms, optin = fused_solve.device_limits(device.index)
    if scope == "block":
        plan = probes.chain_cluster_plan(B, K, 14, 2, n_sms, optin, halo=halo)
        out = {"C": plan.C, "halo": plan.H}
    else:
        rd = probes.chain_grid_rounds(B, K, 14, 2, n_sms, optin - _build.RESERVED_SHARED_BYTES,
                                      halo=halo)[0]
        out = {"per": rd.per, "halo": rd.H, "resident": rd.resident, "meet": rd.meet}
    out["meetings_a_trip_2_2"] = probes.trip_meetings(2, 2, out["halo"])
    out["syncthreads_a_trip_2_2"] = probes.cta_barriers(2, out["halo"])
    return out


def probe_null(scope: str = "block", *, R: int = 20_000, reps: int = 7,
               device="cuda", halo=None, problems: int = 1, log=None) -> dict:
    """Sweep (n_mv, n_dot) at ``scope`` on ``problems`` problems in one
    launch; fit the trip's cost."""
    dev = cuda_device(device)
    M, y0 = chain_inputs(SHAPES[scope], dev, problems)
    rows = {key: null_trip_ns(*key, scope=scope, R=R, reps=reps, M=M, y0=y0, halo=halo,
                              log=log)
            for key in GRID}
    c0, c_mv, c_dot = fit_trip(rows)
    return {
        "probe": "null_chain", "scope": scope, "K": SHAPES[scope], "B": problems, "R": R,
        **schedule(scope, SHAPES[scope], dev, halo, problems),
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
    keys = ("C", "per", "halo", "meetings_a_trip_2_2", "syncthreads_a_trip_2_2")
    return {
        "probe": "summary", "scope": null["scope"],
        **{k: null[k] for k in keys if k in null},
        "c0_ns_per_trip": null["c0_ns_per_trip"], "c_mv_ns": null["c_mv_ns"],
        "c_dot_ns": null["c_dot_ns"],
        "predicted_poly1_iter_ns": null["predicted_poly1_iter_ns"],
        "measured_poly1_iter_ns": real["poly1_per_iter_ns"],
        "measured_over_predicted": (real["poly1_per_iter_ns"]
                                    / null["predicted_poly1_iter_ns"]),
        "poly2_over_poly1_measured": real["poly2_over_poly1"],
        "kernel_poly1_iter_ns": real["poly1_kernel_per_iter_ns"],
        "kernel_over_predicted": (real["poly1_kernel_per_iter_ns"]
                                  / null["predicted_poly1_iter_ns"]),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scope", choices=("block", "grid", "both"), default="both")
    ap.add_argument("--R", type=int, default=20_000)
    ap.add_argument("--T", type=int, default=64)
    ap.add_argument("--halo", type=int, default=None)
    ap.add_argument("--problems", type=int, default=1,
                    help="problems of the null sweep (the grid scope meets on "
                         "flagged partials from 2)")
    ap.add_argument("--null-only", action="store_true")
    args = ap.parse_args(argv)

    def log(m):
        print(m, file=sys.stderr, flush=True)

    for scope in probes.SCOPES if args.scope == "both" else (args.scope,):
        null = probe_null(scope, R=args.R, halo=args.halo, problems=args.problems, log=log)
        print(json.dumps(null), flush=True)
        if args.null_only:
            continue
        real = probe_real(scope, T=args.T, log=log)
        print(json.dumps(real), flush=True)
        print(json.dumps(summary(null, real)), flush=True)


if __name__ == "__main__":
    main()

"""Drive gato_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. require CUDA; print the card's name and power limit; turn TF32 off so the
   plain PyTorch versions run in full float32;
2. build the CUDA kernels from gato_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at IIWA
   (state 14, control 7, K=50; data from testing.random_blocks), B=1 and
   B=256: the PCG kernel (A) against pcg.pcg at the cluster size its rule
   picks and at every one forced, and at its plan's edges (K = 2 and 688,
   s = 2, 20 and 32, every C that fits, poly degree 1 and 2), the fused
   solve (B) against
   condense -> pcg -> recover_dz for all three preconditioners and
   precond_poly_degree 1 and 2, at the cluster size its rule picks and at
   every one forced (C = 1, 2, 4, 8, 16), and one exactly singular input
   at every C; kernel B's compiled <36, 12> body at a quadruped's whole-body
   widths ((s, c, K) = (36, 12, 57), benchmark/configs/anymal36_k57.json;
   data from the benchmark's generator recipe), B=1 and B=4, at the rule's
   cluster size and every one that fits, its launches counted from 0, and
   solve_batched's auto route there, one launch of that body a call;
3b. the sequence kernel (row 3) against its plain version at IIWA on a
   farm of B=1 and B=256 streams of T=16 steps (each stream's matrices
   fixed, q, r, c drifting by ~1 % a step, per-step rho), bit for bit
   against T chained launches of kernel B at the same cluster size, at the
   rule's C and every C forced, and with one exactly singular step in the
   middle of one stream at every C;
4. the main path through the user entry points: linsys_solve on the
   pendulum (the original's gate) and at IIWA (against the dense float64
   oracle), solve_batched at B=256, with each kernel's launch count;
4b. the MPC and packed paths: solve_sequence_batched (B=256, T=16) and
   solve_sequence (B=1, against stream 0), two pack_sequence -> solve_packed_sequence
   windows carried by lam_tail_packed, and pack -> solve_packed ->
   update_vectors -> solve_packed with the lam_packed carry, with their
   launch counts;
3c. the exact-solve kernels against their plain versions at IIWA,
   rho=1e-3: the cyclic-reduction kernel (row 4) at B=1, 15 and 256 and at
   its plan's edges (K = 2, 3, 51 and 740 at B = 1 and 15, s = 2, 20 and
   32), at the rule's cluster size and every one forced, the
   block-Thomas pair (rows 5 and 6) at B=16 and B=256 (the forward
   kernel's factor stacks against the plain forward's, the reverse kernel
   on the plain stacks against the plain reverse, its epilogue's dz
   against the knot-parallel plain epilogue on the walk's lambda), rows 5
   and 6 at row 5's plan edges (K = 2, 51 and 1024 at IIWA, s = 20 and 32), and one exactly
   singular problem in each tier with each tier's contract (row 4: finite,
   eta = 1e30, at every cluster size; rows 5-6: non-finite, the other
   problems untouched);
4c. the exact main path (method='direct') through solve (row 4),
   solve_batched at B=8 (row 4) and B=256 (rows 5+6), against the float64
   dense KKT solve on the card and the 'torch' backend;
   solve_sequence_batched at B=256, T=16 (rows 5+6 on 4096 problems)
   against 16 per-step solve_batched calls; pack -> solve_packed ->
   update_vectors -> solve_packed for tier 'cr' and 'thomas'; each path's
   launch counts from 0;
5. times with CUDA events, medians of 25 runs after warm-up (fewer for the
   slow plain versions and library calls), beside each kernel's bound and
   the time of one PyTorch library call computing the same function;
   kernel B at B=1, 4, 16, 64, 256 at the rule's cluster size (with its
   device time from a CUDA graph) and at every C forced; kernel A the same
   at K=50, B=1 and 256 and K=688, B=1, and by stage (the stamps child
   below); kernel B's <36, 12> body at B=1 and 4 (device time from a CUDA
   graph; its own row in the kernels table, ``"instance": "36x12"``); the
   farm kernel (5b) at every C, with the C each launch used;
5c. the same for the exact-solve kernels at B=1 and B=256, their device
   times (a CUDA graph), row 4 at every C at K=50, B=1, 15, 256 and K=740,
   B=1, and by stage, the
   per-solve time of row 4 and of the Thomas pair at B=1, 4, 16, 64, 256
   (their crossover on this card), the pair and row 6 at K=1024, B=16
   beside the long-K exact routes, row 5 by stage beside kernel B's
   cluster condensation, and row 6 by stage, its walk a knot and its
   epilogue (tools/direct_stamps.py's stamped build, built in a child
   beside phase 2's build, measured there while this process waits; the
   epilogue's line in the kernels table takes its time from there);
3d. the long-horizon PCG kernels (rows 7, 8/10, 9 and 13) against their
   plain versions at IIWA widths: K=1024 at B=1 and B=16 with every
   preconditioner (scalar Jacobi over 10 iterations) and poly degree 2,
   K=2048 and K=8192 at B=1; the edges of rows 8/10's split (K=689 and
   1025, one knot a CTA, two CTAs an SM, poly degree 2 and 3, a batch past
   the SMs in rounds), rows 8/10 bit for bit on both meetings (flagged
   partials, grid barriers); a warm start, and one exactly singular
   problem among healthy ones through both routes;
4d. the long-horizon main path: solve at K=1024 and K=8192, solve_batched
   at B=16, K=2048, solve_sequence_batched (B=4, T=8, K=1024) and
   solve_sequence (its stream 0), pack /
   solve_packed and pack_sequence / solve_packed_sequence at K=1024,
   linsys_solve at K=1024 against the float64 dense KKT solve on the card,
   the route the auto tier does not take through
   longk.solve_longk_batched(force_tier=...), with each route's launch
   counts;
5d. the long-horizon kernels' times at K=1024, 2048, 4096, 8192 and B=1,
   16 beside their bounds, their plain versions and (K=1024) the dense
   Schur solve, rows 8/10's plan (CTAs a problem, operators in shared
   memory, grid barriers an iteration) and one iteration's cost, and the
   two routes' times (the tier crossover);
3e. the long-horizon exact kernels (rows 11 and 12 and the unpeel kernel)
   against their plain versions at IIWA widths, K=2, 50, 71, 72 (where
   row 11's tail stops taking the whole problem), 741, 1025, 1536 and 8192
   at B=1 and 15, and at s = 20 and 32 and B = 16, both exact tiers
   against the plain cyclic reduction, a singular mix and a zero pivot in
   the condensed system; rows 7 and 13 at K=50;
4e. the exact long-K main path (method='direct' past row 4's shared
   memory below B=16): solve at K=1024 and 8192, solve_batched at B=8,
   K=2048 (the auto rule's 'hybrid'; 'xl' elsewhere), 'pcg_kernel' at
   K=50 against row 4, an exact farm of B=2 x T=4 at K=1024, pack /
   solve_packed and a 'longk' PCG pack solved exactly; against the float64
   dense KKT solve where K <= 1024, with each path's launch counts;
5e. the exact kernels' and both exact routes' times at K=1024-8192, B=1
   and 15, beside their bounds, their plain versions, the dense Schur
   solve (K=1024) and the Thomas pair (B=15), rows 11 and 12's and the
   unpeel's device times and their split by stage (the stamps child); the
   long-K PCG kernel, its plain version and its route at row 14's shape,
   K=16384.

3f. row 15 (the knot shard's halo matvec) against its plain version at
   IIWA s = 14, Kl = 256, 2048 and 65, s = 4, 3 and 32: a first shard (no
   left halo), an interior one and a last one (no right halo);
4f. the knot-sharded path on Mesh(["cuda:0"] * n), n = 1, 2, 4 (shards on
   the one card): solve_sharded at IIWA K = 1024 with every
   preconditioner, the kernel tier (rows 7, 15, 13 on every shard) against
   the torch tier, the single-device solve and the float64 dense KKT solve;
   K = 8192 on four shards against the torch tier and solve;
   method='direct' at K = 1024 and 8192 on four shards; one-knot shards
   and the refusals; row 15's launches against the count the iterations
   imply; solve_batched_dp (B = 256, both methods) and
   solve_sequence_batched_dp (B = 256 x T = 16) on four groups against the
   single-device surfaces; then solve_packed_dp on Mesh(["cuda:0"] * n,
   "dp"), n = 1, 2, 4: IIWA K = 50, B = 256 with 'pcg' (kernel B at
   g = 256 / n) and 'direct' (the Thomas pair at g = 64-256), B = 8
   'direct' (row 4 at g = 2-8), and a 'longk' pack at K = 1024, B = 4 for
   both methods; each group a view of the pack, bit for bit against
   solve_packed on each group alone, against the whole-batch solve_packed
   (TOL and the tie rule), the warm carry (the same data in at most one
   iteration, then update_vectors), each route's launches from 0 against
   the groups' alone, and two refusals;
5f. one row-15 call without halos is one node, the kernel, in a CUDA
   graph captured around it, and allocates y alone; in a child process
   (chip_smoke.py --profiled, run after phase 2, before this process
   opens a profiler session) the device's busy shares below; row 15's time at Kl = 256
   and 2048 beside its bound, its plain version and torch.bmm; solve_sharded per call on both tiers at K = 1024 and 8192,
   n = 1, 2, 4, beside the single-device solve, with the device's busy
   share of one kernel-tier call; one sharded PCG
   iteration's cost on four shards; the dp entry points beside their
   single-device surfaces; solve_packed_dp per call at n = 1, 2, 4 beside
   solve_packed on the same pack, for each pack of 4f.

3g. rows 16, 17 and 18 (the probes, kernels/probes.py) against their plain
   versions: row 18 (null_copy) bit for bit at IIWA K = 50, B = 1 and 256,
   at (3, 7, 3) (K s not a multiple of 4) and on q one float off a 16-byte
   boundary;
   row 16 (null_chain) on kernel B's cluster (the rule's C, and C = 1
   and 2 forced) and on rows 8/10's rounds (one problem on grid barriers,
   three on flagged partials), K = 50 over the five (n_mv, n_dot) of the
   fit, K = 37 and K = 1024, 100 trips; row 17
   (fma_chain) at K = 50, s = 14, B = 1 and 132, and K = 4, B = 1 (its
   two layouts), 100 trips of depth 2;
   rows 16 and 17 on probes.chain_operator / fma_operator (each knot's own
   step a scaled orthogonal block), checked within every (problem, knot);
4g. the measurement path: timing.time_solve at IIWA B = 1 for 'fused',
   'pcg_kernel' and method='direct', and at B = 256, with the host reads
   and synchronisations one solve makes (from a trace); debug.solve_debug
   against solve; debug.trace around one linsys_solve (kernel B's symbol
   in its table, the call's split from the trace, and its steps on host
   clocks without the profiler); the probe tools
   (probe_dispatch, probe_iter_floor at both scopes, probe_throughput A and
   D) with reduced trip counts, with the probes' launch counts from 0, and
   probe_iter_floor's summary at each scope (C or per, the halo, the fit,
   kernel / predicted);
5g. the probes' times beside their bounds and plain versions (row 18 beside
   q * 1.0000001), the dispatch floor, the iteration floor's fit against
   the measured iteration at both scopes, probe A's split at B = 256,
   probe D's rate (K = 50 and 4, with row 17's SASS counts and the stamped
   child's split of one launch; row 17's bound also over one SM's share of
   the rate) and the split of one IIWA linsys_solve.
4h. the gradient path: kkt_solve and kkt_solve_batched (gradients by the
   implicit function theorem, diff.py) at IIWA widths, forward and adjoint
   solve through the exact dispatch's kernels, each route's launch counts
   from 0: kkt_solve at B = 1 (row 4 twice), kkt_solve_batched at B = 16
   and 256 (the Thomas pair twice), kkt_solve at K = 1024 (the long-K exact
   tier 'xl': rows 7, 11, 13 twice) and kkt_solve_batched at K = 1024, B =
   12 ('hybrid': row 12's peels too); the primal and all eight gradients
   within 2e-3 of scale of the same call in float64 on the card (the
   'torch' route);
4i. each examples/torch/*.py with --device cuda in a child process, on
   the library phase 2 built (the library is not built again); its last
   lines printed, a non-zero exit fails the run;
5h. forward plus backward with CUDA events at B = 1, 16 and 256 and K =
   1024, beside the forward alone and the 'torch' route in float32; host
   packing (the native C++ packer against NumPy, K = 50 and 1024, median
   of 21 runs on host clocks) and linsys_solve's steps with each packer.
   Phase 4g fails unless the native packer served its linsys_solve calls.

The line before the last is the card's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "needs one CUDA card")

import gato_tpu_torch as gt  # noqa: E402
from gato_tpu_torch import assemble, blocktri, testing  # noqa: E402
from gato_tpu_torch import debug as gdebug  # noqa: E402
from gato_tpu_torch import diff as gdiff  # noqa: E402
from gato_tpu_torch import formats as gformats  # noqa: E402
from gato_tpu_torch import native as gnative  # noqa: E402
from gato_tpu_torch import timing as gtiming  # noqa: E402
from gato_tpu_torch.kernels import _build  # noqa: E402
from gato_tpu_torch.kernels import direct_fused as kd  # noqa: E402
from gato_tpu_torch.kernels import fused_sequence as ks  # noqa: E402
from gato_tpu_torch.kernels import fused_solve as kb  # noqa: E402
from gato_tpu_torch.kernels import halo_matvec as hm  # noqa: E402
from gato_tpu_torch.kernels import longk as kl  # noqa: E402
from gato_tpu_torch.kernels import pcg_kernel as ka  # noqa: E402
from gato_tpu_torch.kernels import probes as kp  # noqa: E402
from gato_tpu_torch.kernels import thomas_batch as kt  # noqa: E402
from gato_tpu_torch.parallel import sharded as gsharded  # noqa: E402
from gato_tpu_torch.tools import probe_dispatch, probe_iter_floor  # noqa: E402
from gato_tpu_torch.tools import probe_throughput  # noqa: E402

DEV = torch.device("cuda", 0)
IIWA = testing.IIWA
IIWA_SIZES = (IIWA.state_size, IIWA.control_size, IIWA.knot_points)
RHO = 1e-3
EXIT_TOL = 1e-6
MAX_ITERS = 100
BATCH = 256
# lambda, dz_x, dz_u agree when |kernel - plain| <= TOL*|plain| + TOL*scale,
# scale = max |plain| (tests/test_fused_solve.py's rtol = atol = 1e-4).
TOL = 1e-4
# An exit index may differ by one where the earlier-exiting run's eta lies
# within this relative distance of exit_tol: eta's float32 round-off at IIWA
# is about 1e-5 relative (float32 against float64 at the same iteration), so
# 1e-3 is far outside round-off for any other case.
ETA_TIE = 1e-3
TIMING_RUNS = 25
SLOW_RUNS = 5       # plain versions of the farm and library calls
T_STEPS = 16        # farm steps
# An H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
# float32 outside the tensor cores, and device memory.
F32_FLOPS = 67e12
SMS = 132           # the SMs that rate is summed over (an H100 SXM's)
HBM_BYTES = 3.35e12

MAX_ERR = {ka.NAME: 0.0, kb.NAME: 0.0, ks.NAME: 0.0, kd.NAME: 0.0,
           kt.FWD_NAME: 0.0, kt.REV_NAME: 0.0, kt.EPILOGUE_NAME: 0.0,
           kl.CONDENSE_NAME: 0.0,
           kl.PCG_NAME: 0.0, kl.FUSED_NAME: 0.0, kl.RECOVER_NAME: 0.0,
           kl.CR_NAME: 0.0, kl.PEEL_NAME: 0.0, kl.UNPEEL_NAME: 0.0, hm.NAME: 0.0,
           kp.COPY_NAME: 0.0, kp.CHAIN_BLOCK_NAME: 0.0, kp.CHAIN_GRID_NAME: 0.0,
           kp.FMA_NAME: 0.0}
# An exact solve's eta is a squared residual at round-off level: kernel and
# plain version agree when |eta_k - eta_p| <= ETA_REL (1 + ||gamma||^2), a
# relative residual of 1e-5, float32 round-off for these systems.
ETA_REL = 1e-10
CROSSOVER_B = (1, 4, 16, 64, 256)
# A quadruped's whole body (s, c, K) = (36, 12, 57), kernel B's compiled
# <36, 12> body (benchmark/configs/anymal36_k57.json), at these batch widths.
ANYMAL = (36, 12, 57)
ANYMAL_B = (1, 4)
ANYMAL_SEED = 2**31 + 24
WIDE_ROW = f"{kb.NAME} 36x12"
MAX_ERR[WIDE_ROW] = 0.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_close(what: str, kernel: torch.Tensor, plain: torch.Tensor) -> float:
    k = kernel.detach().double().cpu().numpy()
    p = plain.detach().double().cpu().numpy()
    if not np.all(np.isfinite(k)):
        raise AssertionError(f"{what}: kernel output is not finite")
    scale = max(float(np.max(np.abs(p))), 1e-30)
    err = np.abs(k - p)
    bound = TOL * np.abs(p) + TOL * scale
    if np.any(err > bound):
        raise AssertionError(f"{what}: max |kernel - plain| = {err.max():.3e} "
                             f"exceeds rtol = atol = {TOL} of scale {scale:.3e}")
    return float(err.max())


def check_iters(what: str, k_res, p_res, exit_tol: float) -> int:
    """Equal iteration counts and converged flags, except a +-1 exit where
    the earlier exit's eta is within round-off of exit_tol.  Returns the
    number of such ties."""
    ki = k_res.iters.cpu().numpy().reshape(-1)
    pi = p_res.iters.cpu().numpy().reshape(-1)
    ke = k_res.eta.double().cpu().numpy().reshape(-1)
    pe = p_res.eta.double().cpu().numpy().reshape(-1)
    if not np.array_equal(k_res.converged.cpu().numpy(),
                          p_res.converged.cpu().numpy()):
        raise AssertionError(f"{what}: converged flags differ")
    ties = 0
    for i in np.nonzero(ki != pi)[0]:
        early_eta = ke[i] if ki[i] < pi[i] else pe[i]
        if abs(int(ki[i]) - int(pi[i])) == 1 and \
                abs(early_eta - exit_tol) <= ETA_TIE * exit_tol:
            print(f"  {what}: problem {i} exits at {ki[i]} (kernel) vs "
                  f"{pi[i]} (plain); eta {early_eta:.6e} is within "
                  f"{ETA_TIE:g} of exit_tol {exit_tol:g} (round-off tie)")
            ties += 1
            continue
        raise AssertionError(f"{what}: problem {i} iterations kernel {ki[i]} "
                             f"vs plain {pi[i]}")
    return ties


def check_farm(what: str, got, ref, redo_got, redo_ref, *, stepwise=False,
               max_iters=MAX_ITERS) -> tuple:
    """A farm's results (lam, dz_x, dz_u, iters, converged, eta with (T, B)
    axes) against a reference farm.  Iteration counts as check_iters.  A
    round-off tie at (t, b) changes that step's iterate by one PCG update
    and so the warm start of the stream's later steps: a stream is compared
    whole up to its first tie, and from there step by step, the reference
    started from the kernel's own lambda of the step before
    (redo_got / redo_ref(t, streams, lam0, max_iters) solve step t of those
    streams; lam0 None is the farm's lam0).  Where the exits of such a step
    still differ by one, the later one is run again capped at the earlier
    one's count, so that both did the same work.  ``stepwise`` compares
    every stream step by step from step 0 (for runs capped short of
    convergence, whose round-off compounds along the chain).  Returns
    (ties, max |difference|)."""
    T, n = got.iters.shape
    fields = ("lam", "dz_x", "dz_u")
    first = {b: 0 for b in range(n)} if stepwise else {}
    if not stepwise:
        for t, b in np.argwhere(got.iters.cpu().numpy() != ref.iters.cpu().numpy()):
            first[int(b)] = min(first.get(int(b), T), int(t))
    steps = torch.arange(T)[:, None]
    first_t = torch.tensor([first.get(b, T) for b in range(n)])[None, :]
    chained = (steps < first_t).to(got.iters.device)
    ties = 0
    if not stepwise:
        # Each stream up to and with its first differing step: equal counts,
        # or a round-off tie at that step.
        upto = (steps <= first_t).to(got.iters.device)
        ties = check_iters(what, gt.SolveResult(*(x[upto] for x in got)),
                           gt.SolveResult(*(x[upto] for x in ref)), EXIT_TOL)
    err = 0.0
    if bool(chained.any()):
        for name in fields:
            err = max(err, check_close(f"{what} {name}", getattr(got, name)[chained],
                                       getattr(ref, name)[chained]))
    for t in range(T):
        bs = sorted(b for b, t0 in first.items() if t0 <= t)
        if not bs:
            continue
        lam0 = got.lam[t - 1, bs] if t > 0 else None
        g = gt.SolveResult(*(x[t, bs] for x in got))
        r = redo_ref(t, bs, lam0, max_iters)
        step_ties = check_iters(f"{what} step {t}", g, r, EXIT_TOL)
        ties += step_ties if stepwise else 0   # else counted on the chain
        gi, ri = g.iters.cpu().numpy(), r.iters.cpu().numpy()
        same = torch.as_tensor(gi == ri, device=g.iters.device)
        for name in fields if bool(same.any()) else ():
            err = max(err, check_close(f"{what} step {t} {name}",
                                       getattr(g, name)[same], getattr(r, name)[same]))
        for i in np.nonzero(gi != ri)[0]:
            b, start = bs[i], None if lam0 is None else lam0[i:i + 1]
            cap = int(min(gi[i], ri[i])) + 1
            g1 = (redo_got(t, [b], start, cap) if gi[i] > ri[i]
                  else gt.SolveResult(*(x[i:i + 1] for x in g)))
            r1 = (redo_ref(t, [b], start, cap) if ri[i] > gi[i]
                  else gt.SolveResult(*(x[i:i + 1] for x in r)))
            for name in fields:
                err = max(err, check_close(f"{what} stream {b} step {t} {name}",
                                           getattr(g1, name), getattr(r1, name)))
    if first and not stepwise:
        print(f"  {what}: streams {sorted(first)} compared step by step from "
              "their first tie, at equal work")
    return ties, err


def staged_batch(n: int, seed0: int = 0):
    blocks = gt.blocks_to_torch(testing.random_batch(IIWA, n, seed0=seed0), DEV)
    return blocks, torch.zeros_like(blocks.q)


def phase_parity():
    print("== phase 3: kernels against their plain versions at IIWA "
          f"(14, 7, 50), rho={RHO}, exit_tol={EXIT_TOL}, max_iters={MAX_ITERS}")
    full, lam0_full = staged_batch(BATCH)
    for n in (1, BATCH):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        lam0 = lam0_full[:n]
        sys_ = assemble.condense(*blocks, RHO)
        for poly in (1, 2):
            kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS, poly_degree=poly)
            kr = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, lam0, **kw)
            pr = ka.pcg_batched_plain(sys_.S, sys_.Pinv, sys_.gamma, lam0, **kw)
            torch.cuda.synchronize()
            what = f"{ka.NAME} B={n} poly={poly}"
            ties = check_iters(what, kr, pr, EXIT_TOL)
            err = check_close(what + " lam", kr.lam, pr.lam)
            MAX_ERR[ka.NAME] = max(MAX_ERR[ka.NAME], err)
            it = kr.iters.cpu().numpy()
            print(f"  {what}: iters {it.min()}..{it.max()} equal "
                  f"({ties} ties), max|dlam| {err:.3e}")
        # warm start from the solution: at most one iteration
        kr = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, pr.lam,
                                 exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
        if int(kr.iters.max()) > 1:
            raise AssertionError(f"{ka.NAME} B={n}: warm start took "
                                 f"{int(kr.iters.max())} iterations")
        # Kernel A at its rule's cluster size (above) and at every one forced.
        for poly in (1, 2):
            kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS, poly_degree=poly)
            pr = ka.pcg_batched_plain(sys_.S, sys_.Pinv, sys_.gamma, lam0, **kw)
            for C in kb.CLUSTER_SIZES:
                kr = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, lam0, cluster=C, **kw)
                torch.cuda.synchronize()
                what = f"{ka.NAME} B={n} C={C} poly={poly}"
                check_iters(what, kr, pr, EXIT_TOL)
                MAX_ERR[ka.NAME] = max(MAX_ERR[ka.NAME], check_close(what + " lam", kr.lam, pr.lam))
            print(f"  {ka.NAME} B={n} poly={poly}: every C of {kb.CLUSTER_SIZES} forced "
                  "agrees with the plain version")
        for prec in ("symmetric_stair", "block_jacobi", "jacobi"):
            for poly in (1, 2):
                # Scalar Jacobi is compared over a capped run.  At IIWA its
                # PCG needs ~60 iterations and float32 round-off grows along
                # them: over these 256 problems the plain version's dz_x in
                # float32 and float64 differ by 3.2e-6 after 10 iterations
                # but by 4.3e-4 after 20 (eta by 2e-1 relative after 40),
                # so two float32 orderings part by more than 1e-4.
                # Composed to degree 2 it may be indefinite (the exception
                # gato_tpu's tests/test_precond_poly.py documents) and parts
                # after 3 iterations (lambda 2.5e-6 relative after 3, 3e-4
                # after 4).  All measured on the CPU.
                cap = {("jacobi", 1): 10, ("jacobi", 2): 3}.get((prec, poly),
                                                                MAX_ITERS)
                kw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=cap,
                          poly_degree=poly, preconditioner=prec)
                pres, pdx, pdu = kb.fused_solve_plain(*blocks, lam0, **kw)
                # The rule's cluster size, then every one forced.
                for C in (None, *kb.CLUSTER_SIZES):
                    kres, kdx, kdu = kb.fused_solve_cuda(*blocks, lam0, cluster=C, **kw)
                    torch.cuda.synchronize()
                    what = (f"{kb.NAME} B={n} C={kb.LAST_CLUSTER}"
                            f"{' (rule)' if C is None else ''} {prec} poly={poly} "
                            f"max_iters={cap}")
                    ties = check_iters(what, kres, pres, EXIT_TOL)
                    err = max(check_close(what + " lam", kres.lam, pres.lam),
                              check_close(what + " dz_x", kdx, pdx),
                              check_close(what + " dz_u", kdu, pdu))
                    MAX_ERR[kb.NAME] = max(MAX_ERR[kb.NAME], err)
                    it = kres.iters.cpu().numpy()
                    print(f"  {what}: iters {it.min()}..{it.max()} equal "
                          f"({ties} ties), max|d| {err:.3e}")

    # Kernel A at its plan's edges: K = 2, the horizon before the long-K
    # tier (688), the pendulum's and wide widths; every C that fits.
    _, limit = kb.device_limits(0)
    for sizes, n in (((14, 7, 2), 4), ((14, 7, 688), 2), ((2, 1, 50), 4),
                     ((20, 9, 37), 4), ((32, 32, 6), 4)):
        spec = gt.ProblemSpec(*sizes)
        K, s = sizes[2], sizes[0]
        blocks = gt.blocks_to_torch(testing.random_batch(spec, n, seed0=70), DEV)
        sys_ = assemble.condense(*blocks, RHO)
        sizes_run = [C for C in kb.CLUSTER_SIZES if ka.cluster_fits(K, s, C, limit)]
        for poly in (1, 2):
            kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS, poly_degree=poly)
            pr = ka.pcg_batched_plain(sys_.S, sys_.Pinv, sys_.gamma, **kw)
            for C in (None, *sizes_run):
                kr = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, cluster=C, **kw)
                torch.cuda.synchronize()
                what = f"{ka.NAME} {sizes} B={n} C={ka.LAST_CLUSTER} poly={poly}"
                check_iters(what, kr, pr, EXIT_TOL)
                MAX_ERR[ka.NAME] = max(MAX_ERR[ka.NAME], check_close(what + " lam", kr.lam, pr.lam))
        print(f"  {ka.NAME} {sizes} B={n}: the rule's C and C = {sizes_run} forced, poly 1 "
              "and 2, agree with the plain version")

    # One exactly singular problem (zero row/column in Q[2], rho=0) among
    # healthy ones: only it is frozen, unconverged, at max_iters, eta 1e30.
    bad = testing.singular_blocks(IIWA, seed=3, knot=2)
    mix = testing.stack_blocks([testing.random_blocks(IIWA, seed=40), bad,
                                testing.random_blocks(IIWA, seed=41)])
    blocks = gt.blocks_to_torch(mix, DEV)
    lam0 = torch.zeros_like(blocks.q)
    kw = dict(rho=0.0, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    pres, pdx, pdu = kb.fused_solve_plain(*blocks, lam0, **kw)
    for C in kb.CLUSTER_SIZES:
        kres, kdx, kdu = kb.fused_solve_cuda(*blocks, lam0, cluster=C, **kw)
        torch.cuda.synchronize()
        conv = kres.converged.cpu().tolist()
        if conv != [True, False, True] or int(kres.iters[1]) != MAX_ITERS \
                or float(kres.eta[1]) != float(np.float32(1e30)) \
                or not torch.equal(kres.lam[1], lam0[1]):
            raise AssertionError(f"singular input, C={C}: converged {conv}, iters "
                                 f"{kres.iters.tolist()}, eta {kres.eta.tolist()}")
        check_iters(f"{kb.NAME} C={C} singular mix", kres, pres, EXIT_TOL)
        for name, k, p in (("lam", kres.lam, pres.lam), ("dz_x", kdx, pdx),
                           ("dz_u", kdu, pdu)):
            check_close(f"{kb.NAME} C={C} singular mix {name}", k, p)
    print(f"  {kb.NAME} singular input at C = {kb.CLUSTER_SIZES}: converged {conv}, "
          f"iters {kres.iters.tolist()}, eta[1] = {float(kres.eta[1]):g}, lambda_0 "
          "kept (plain version agrees)")
    return wide_parity()


def anymal_batch(n: int):
    """n problems at the quadruped's widths from the benchmark's generator
    recipe (benchmark/generator.py), on the card, and a zero lam0."""
    from benchmark import generator
    s, c, K = ANYMAL
    blocks = gt.KKTBlocks(*generator.make_problems(n, K, s, c, ANYMAL_SEED, DEV))
    return blocks, torch.zeros_like(blocks.q)


def wide_parity() -> int:
    """Kernel B's <36, 12> body against its plain version at ANYMAL, B = 1
    and 4: the rule's C and every C that fits, the launches counted from 0;
    then solve_batched's auto route there.  Returns that route's launches
    of kernel B a call."""
    s, c, K = ANYMAL
    _, limit = kb.device_limits(0)
    sizes = [C for C in kb.CLUSTER_SIZES if kb.cluster_fits(K, s, c, C, limit)]
    kw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    for n in ANYMAL_B:
        blocks, lam0 = anymal_batch(n)
        launch = kb.plan(n, K, s, c, DEV, poly_degree=1, preconditioner="symmetric_stair",
                         **kw)
        if launch.instance != "36x12":
            raise AssertionError(f"{kb.NAME} {ANYMAL} B={n}: plan selects "
                                 f"{launch.instance!r}, not '36x12'")
        pres, pdx, pdu = kb.fused_solve_plain(*blocks, lam0, **kw)
        kb.LAUNCHES = 0
        for C in (None, *sizes):
            kres, kdx, kdu = kb.fused_solve_cuda(*blocks, lam0, cluster=C, **kw)
            torch.cuda.synchronize()
            what = (f"{kb.NAME} <36, 12> {ANYMAL} B={n} C={kb.LAST_CLUSTER}"
                    f"{' (rule)' if C is None else ''}")
            ties = check_iters(what, kres, pres, EXIT_TOL)
            err = max(check_close(what + " lam", kres.lam, pres.lam),
                      check_close(what + " dz_x", kdx, pdx),
                      check_close(what + " dz_u", kdu, pdu))
            MAX_ERR[WIDE_ROW] = max(MAX_ERR[WIDE_ROW], err)
            it = kres.iters.cpu().numpy()
            print(f"  {what}: iters {it.min()}..{it.max()} equal ({ties} ties), "
                  f"max|d| {err:.3e}")
        if kb.LAUNCHES != 1 + len(sizes):
            raise AssertionError(f"{kb.NAME} {ANYMAL} B={n}: {kb.LAUNCHES} launches "
                                 f"for {1 + len(sizes)} calls")
    # The main path: solve_batched's auto route launches the <36, 12> body.
    spec = gt.ProblemSpec(*ANYMAL)
    opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    kb.LAUNCHES = 0
    res = gt.solve_batched(spec, blocks, opts)
    torch.cuda.synchronize()
    ref = gt.solve_batched(spec, blocks, opts, pcg_backend="torch")
    check_iters(f"solve_batched {ANYMAL} fused vs torch", res, ref, EXIT_TOL)
    for name in ("lam", "dz_x", "dz_u"):
        check_close(f"solve_batched {ANYMAL} {name}", getattr(res, name),
                    getattr(ref, name))
    if kb.LAUNCHES != 1:
        raise AssertionError(f"solve_batched {ANYMAL}: {kb.LAUNCHES} launches of "
                             f"{kb.NAME}, not 1")
    print(f"  {kb.NAME} <36, 12>: the rule's C and C = {sizes} agree with the plain "
          f"version at B = {ANYMAL_B}; solve_batched's auto route: 1 launch, agrees "
          "with the torch backend")
    return kb.LAUNCHES


def farm(n: int, T: int, seed0: int) -> gt.KKTBlocks:
    """n streams of T steps on the card (testing.random_farm)."""
    return gt.blocks_to_torch(testing.random_farm(IIWA, T, n, seed0=seed0), DEV)


def farm_rhos(T: int) -> torch.Tensor:
    """A per-step rho: RHO, 2 RHO, RHO, ... so every step reads its own."""
    return torch.tensor([RHO * (1 + t % 2) for t in range(T)],
                        dtype=torch.float32, device=DEV)


def farm_result(res, dz_x, dz_u) -> gt.SolveResult:
    return gt.SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged,
                          res.eta)


def farm_steps(blocks, lam0, rhos, kw, cluster=None):
    """check_farm's one-step solvers for the sequence kernel: kernel B at
    ``cluster`` (each step of the sequence kernel is kernel B at the same
    cluster size, bit for bit) and its plain version, on step t of the
    streams bs."""
    def step(fn, **extra):
        def solve(t, bs, lam_prev, max_iters):
            one = gt.KKTBlocks(*(a[t, bs] for a in blocks))
            start = lam0[bs] if lam_prev is None else lam_prev
            return farm_result(*fn(*one, start, rho=float(rhos[t]),
                                   **dict(kw, max_iters=max_iters), **extra))
        return solve
    return step(kb.fused_solve_cuda, cluster=cluster), step(kb.fused_solve_plain)


def phase_sequence_parity():
    print(f"== phase 3b: the sequence kernel ({ks.NAME}) against its plain "
          f"version and against {T_STEPS} chained {kb.NAME} launches, IIWA "
          f"farms of T={T_STEPS} steps")
    full = farm(BATCH, T_STEPS, seed0=500)
    rhos = farm_rhos(T_STEPS)
    for n in (1, BATCH):
        blocks = gt.KKTBlocks(*(a[:, :n] for a in full))
        lam0 = torch.zeros_like(blocks.q[0])
        cases = [("symmetric_stair", 1), ("symmetric_stair", 2),
                 ("block_jacobi", 1), ("jacobi", 1)]
        for prec, poly in cases:
            # scalar Jacobi over a capped run, as in phase 3
            cap = MAX_ITERS if prec != "jacobi" else 10
            kw = dict(exit_tol=EXIT_TOL, max_iters=cap, poly_degree=poly,
                      preconditioner=prec)
            pres = farm_result(*ks.fused_sequence_plain(*blocks, lam0, rhos, **kw))
            # The rule's cluster size, then every one forced.
            for C in (None, *kb.CLUSTER_SIZES):
                kres = farm_result(*ks.fused_sequence_cuda(*blocks, lam0, rhos,
                                                           cluster=C, **kw))
                torch.cuda.synchronize()
                what = (f"{ks.NAME} B={n} T={T_STEPS} C={ks.LAST_CLUSTER}"
                        f"{' (rule)' if C is None else ''} {prec} poly={poly} "
                        f"max_iters={cap}")
                ties, err = check_farm(what, kres, pres,
                                       *farm_steps(blocks, lam0, rhos, kw,
                                                   ks.LAST_CLUSTER),
                                       stepwise=prec == "jacobi", max_iters=cap)
                MAX_ERR[ks.NAME] = max(MAX_ERR[ks.NAME], err)
                it = kres.iters.float()
                how = "step by step" if prec == "jacobi" else "whole farm"
                print(f"  {what}: iters {int(it.min())}..{int(it.max())} equal "
                      f"({ties} ties; {how}), mean step 0 {float(it[0].mean()):.2f}, "
                      f"steps 1.. {float(it[1:].mean()):.2f}; max|d| {err:.3e}")

        # Step t of the farm is kernel B on step t's inputs with step t-1's
        # lambda and rhos[t] at the same cluster size, bit for bit.
        kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
        for C in (None, *kb.CLUSTER_SIZES):
            kres, kdx, kdu = ks.fused_sequence_cuda(*blocks, lam0, rhos, cluster=C, **kw)
            used = ks.LAST_CLUSTER
            lam = lam0
            for t in range(T_STEPS):
                bres, bdx, bdu = kb.fused_solve_cuda(*(a[t] for a in blocks), lam,
                                                     rho=float(rhos[t]), cluster=C, **kw)
                if kb.LAST_CLUSTER != used:
                    raise AssertionError(f"{ks.NAME} B={n} took C={used}, {kb.NAME} "
                                         f"C={kb.LAST_CLUSTER}")
                for name, x, y in (("lam", kres.lam[t], bres.lam),
                                   ("dz_x", kdx[t], bdx), ("dz_u", kdu[t], bdu),
                                   ("iters", kres.iters[t], bres.iters),
                                   ("converged", kres.converged[t], bres.converged),
                                   ("eta", kres.eta[t], bres.eta)):
                    if not torch.equal(x, y):
                        raise AssertionError(f"{ks.NAME} B={n} C={used} step {t} {name} "
                                             f"is not bit-identical to chained {kb.NAME}")
                lam = bres.lam
            print(f"  {ks.NAME} B={n} C={used}{' (rule)' if C is None else ''}: all "
                  f"{T_STEPS} steps bit-identical to {T_STEPS} chained {kb.NAME} "
                  "launches")

    # One exactly singular step (zero row/column in Q[2], rho=0 at that step)
    # in the middle of stream 1: only that (t, b) is frozen, it hands its
    # lambda_0 on unchanged, and the stream's later steps converge.
    t_bad, n = T_STEPS // 2, 3
    blocks = gt.KKTBlocks(*(a[:, :n].clone() for a in full))
    bad = gt.blocks_to_torch(testing.singular_blocks(IIWA, seed=3, knot=2), DEV)
    blocks.Q[t_bad, 1] = bad.Q
    rhos_bad = rhos.clone()
    rhos_bad[t_bad] = 0.0
    lam0 = torch.zeros_like(blocks.q[0])
    kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    pres = farm_result(*ks.fused_sequence_plain(*blocks, lam0, rhos_bad, **kw))
    for C in kb.CLUSTER_SIZES:
        kres = farm_result(*ks.fused_sequence_cuda(*blocks, lam0, rhos_bad, cluster=C,
                                                   **kw))
        torch.cuda.synchronize()
        conv = kres.converged.cpu().numpy()
        expect = np.ones_like(conv)
        expect[t_bad, 1] = False
        if not np.array_equal(conv, expect) or int(kres.iters[t_bad, 1]) != MAX_ITERS \
                or float(kres.eta[t_bad, 1]) != float(np.float32(1e30)) \
                or not torch.equal(kres.lam[t_bad, 1], kres.lam[t_bad - 1, 1]):
            raise AssertionError(f"singular step, C={C}: converged {conv.tolist()}, iters "
                                 f"{kres.iters[:, 1].tolist()}, eta "
                                 f"{kres.eta[:, 1].tolist()}")
        check_farm(f"{ks.NAME} C={C} singular step", kres, pres,
                   *farm_steps(blocks, lam0, rhos_bad, kw, C))
    print(f"  {ks.NAME} singular step (t={t_bad}, stream 1 of {n}) at C = "
          f"{kb.CLUSTER_SIZES}: only it "
          f"frozen (iters {int(kres.iters[t_bad, 1])}, eta "
          f"{float(kres.eta[t_bad, 1]):g}, lambda passed on unchanged); stream "
          f"1 iters {kres.iters[:, 1].tolist()}; plain version agrees")


def dense_from_csr(indptr, indices, data, shape):
    M = np.zeros(shape)
    for row in range(len(indptr) - 1):
        for j in range(indptr[row], indptr[row + 1]):
            M[row, indices[j]] += data[j]
    return M


def run_linsys(p, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = gt.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                              p.C_val, p.g, p.c, *args, **kw)
    text = buf.getvalue()
    print("  | " + text.strip().replace("\n", "\n  | "))
    if "first run PCG terminated in" not in text or "avg time:" not in text:
        raise AssertionError("linsys_solve did not print its two lines")
    avg = float(re.search(r"avg time:\s*([0-9.eE+-]+)", text).group(1))
    return out, avg


def phase_main_path():
    print("== phase 4: main path through linsys_solve and solve_batched")
    ka.LAUNCHES = 0
    kb.LAUNCHES = 0
    launches = {}

    # The original's pendulum gate (rtol=1, atol=0.01 against the
    # unregularized dense solve).
    p = testing.pendulum_problem()
    before = kb.LAUNCHES
    (l, dz), _ = run_linsys(p, [0.0] * 10, 10, 1e-6, 10, False, 0.001)
    if kb.LAUNCHES <= before:
        raise AssertionError("pendulum linsys_solve did not launch the fused kernel")
    nz, nl = len(p.g), len(p.c)
    G = dense_from_csr(p.G_row, p.G_col, p.G_val, (nz, nz))
    C = dense_from_csr(p.C_row, p.C_col, p.C_val, (nl, nz))
    KKT = np.block([[G, C.T], [C, np.zeros((nl, nl))]])
    x = np.linalg.solve(KKT, np.concatenate([p.g, p.c]))
    if not np.allclose(np.concatenate([dz, l]), x, rtol=1, atol=0.01):
        raise AssertionError("pendulum gate failed")
    print("  pendulum (2, 1, 5): reference gate rtol=1, atol=0.01 passed")

    # IIWA through the CSR entry point, against the dense float64 oracle.
    blocks = testing.random_blocks(IIWA, seed=11)
    csr = testing.blocks_to_csr(IIWA, blocks)
    lam_ref, dz_ref = testing.dense_oracle(IIWA, blocks, rho=RHO)
    avg = {}
    for backend, kmod in ((None, kb), ("pcg_kernel", ka)):
        before = kmod.LAUNCHES
        (l, dz), avg[backend or "fused"] = run_linsys(
            csr, [0.0] * IIWA.nl, 10, 1e-8, MAX_ITERS, False, RHO,
            pcg_backend=backend)
        if kmod.LAUNCHES <= before:
            raise AssertionError(f"IIWA linsys_solve ({backend}) did not launch {kmod.NAME}")
        np.testing.assert_allclose(l, lam_ref, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(dz, dz_ref, rtol=1e-3, atol=1e-3)
        print(f"  IIWA linsys_solve (backend {backend or 'auto = fused'}"
              f"{f', C={kb.LAST_CLUSTER}' if kmod is kb else ''}, "
              "testiters=10, exit_tol=1e-8): lam, dz within 1e-3 of the dense "
              f"oracle; max|dlam| {np.max(np.abs(np.array(l) - lam_ref)):.3e}")

    # The throughput configuration: solve_batched at B=256.
    batch = testing.random_batch(IIWA, BATCH, seed0=1000)
    opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    before = kb.LAUNCHES
    res = gt.solve_batched(IIWA, batch, opts)
    torch.cuda.synchronize()
    if kb.LAUNCHES <= before:
        raise AssertionError("solve_batched did not launch the fused kernel")
    for t, shape in ((res.lam, (BATCH, 50, 14)), (res.dz_x, (BATCH, 50, 14)),
                     (res.dz_u, (BATCH, 49, 7))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"solve_batched output {tuple(t.shape)} not finite {shape}")
    if not bool(res.converged.all()):
        raise AssertionError("solve_batched: a problem did not converge")
    ref = gt.solve_batched(IIWA, batch, opts, pcg_backend="torch")
    ties = check_iters("solve_batched fused vs torch", res, ref, EXIT_TOL)
    for name, a, b in (("lam", res.lam, ref.lam), ("dz_x", res.dz_x, ref.dz_x),
                       ("dz_u", res.dz_u, ref.dz_u)):
        check_close(f"solve_batched {name}", a, b)
    worst = 0.0
    for i in range(4):
        one = testing.KKTBlocks(*(np.asarray(a[i]) for a in batch))
        lr, _ = testing.dense_oracle(IIWA, one, rho=RHO)
        worst = max(worst, float(np.max(np.abs(res.lam[i].cpu().numpy().reshape(-1) - lr))))
    if worst > 5e-3:
        raise AssertionError(f"solve_batched: lam off the dense oracle by {worst:.3e}")
    print(f"  solve_batched B={BATCH} (kernel B at C={kb.LAST_CLUSTER}): finite, all "
          "converged, iters "
          f"{int(res.iters.min())}..{int(res.iters.max())} equal to the "
          f"'torch' backend ({ties} ties); 4 problems within {worst:.2e} of "
          "the dense oracle")
    launches[ka.NAME] = ka.LAUNCHES
    launches[kb.NAME] = kb.LAUNCHES
    print(f"  launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    return launches, avg


def phase_mpc_path():
    print(f"== phase 4b: MPC farms and the packed surface through "
          f"solve_sequence_batched, solve_sequence, pack_sequence / "
          f"solve_packed_sequence and pack / solve_packed")
    full = farm(BATCH, T_STEPS, seed0=2000)
    rhos = farm_rhos(T_STEPS).cpu().numpy()
    opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    single = gt.KKTBlocks(*(a[:, 0] for a in full))
    half = T_STEPS // 2
    win1 = gt.KKTBlocks(*(a[:half] for a in full))
    win2 = gt.KKTBlocks(*(a[half:] for a in full))
    step0 = gt.KKTBlocks(*(a[0] for a in full))
    step1 = gt.KKTBlocks(*(a[1] for a in full))

    # The paths, with every count at 0 just before and read just after.
    ka.LAUNCHES = kb.LAUNCHES = ks.LAUNCHES = 0
    seq = gt.solve_sequence_batched(IIWA, full, opts, rhos=rhos)
    one = gt.solve_sequence(IIWA, single, opts, rhos=rhos)
    w1 = gt.solve_packed_sequence(gt.pack_sequence(IIWA, win1), opts)
    w2 = gt.solve_packed_sequence(gt.pack_sequence(IIWA, win2), opts,
                                  lam0=w1.lam_tail_packed)
    packed = gt.pack(IIWA, step0)
    first = gt.solve_packed(packed, opts)
    packed = gt.update_vectors(packed, step1.q, step1.r, step1.c)
    second = gt.solve_packed(packed, opts, lam0=first.lam_packed)
    torch.cuda.synchronize()
    launches = {ka.NAME: ka.LAUNCHES, kb.NAME: kb.LAUNCHES, ks.NAME: ks.LAUNCHES}
    print(f"  launches on the MPC and packed paths: {launches}; the farm's last "
          f"launch at C={ks.LAST_CLUSTER}, kernel B's at C={kb.LAST_CLUSTER}")
    if launches[ks.NAME] != 4 or launches[kb.NAME] != 2:
        raise AssertionError(f"expected 4 {ks.NAME} and 2 {kb.NAME} launches")

    # solve_sequence_batched against the 'torch' backend and the oracle.
    for name, t, shape in (("lam", seq.lam, (T_STEPS, BATCH, 50, 14)),
                           ("dz_x", seq.dz_x, (T_STEPS, BATCH, 50, 14)),
                           ("dz_u", seq.dz_u, (T_STEPS, BATCH, 49, 7))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"solve_sequence_batched {name} "
                                 f"{tuple(t.shape)} not finite {shape}")
    if not bool(seq.converged.all()):
        raise AssertionError("solve_sequence_batched: a step did not converge")
    ref = gt.solve_sequence_batched(IIWA, full, opts, rhos=rhos,
                                    pcg_backend="torch")
    lam0 = torch.zeros_like(full.q[0])
    redo_got, _ = farm_steps(full, lam0, rhos, dict(exit_tol=EXIT_TOL))

    def redo_ref(t, bs, lam_prev, max_iters):
        one = gt.KKTBlocks(*(a[t, bs] for a in full))
        step_opts = gt.SolverOptions(rho=float(rhos[t]), exit_tol=EXIT_TOL,
                                     max_iters=max_iters, warm_start=True)
        return gt.solve_batched(IIWA, one, step_opts, pcg_backend="torch",
                                lam0=lam0[bs] if lam_prev is None else lam_prev)

    ties, _ = check_farm("solve_sequence_batched fused vs torch", seq, ref,
                         redo_got, redo_ref)
    it = seq.iters.double()
    cold, warm = float(it[0].mean()), float(it[1:].mean())
    if not warm < cold:
        raise AssertionError(f"warm start: steps 1.. average {warm:.2f} "
                             f"iterations, step 0 {cold:.2f}")
    worst = 0.0
    for b in range(2):
        blk = testing.KKTBlocks(*(a[-1, b].cpu().numpy() for a in full))
        lr, _ = testing.dense_oracle(IIWA, blk, rho=float(rhos[-1]))
        worst = max(worst, float(np.max(np.abs(
            seq.lam[-1, b].cpu().numpy().reshape(-1) - lr))))
    if worst > 5e-3:
        raise AssertionError(f"solve_sequence_batched: lam off the dense "
                             f"oracle by {worst:.3e}")
    print(f"  solve_sequence_batched B={BATCH} T={T_STEPS} (auto = fused): "
          f"finite, all converged, iters equal to 'torch' ({ties} ties); mean "
          f"iterations step 0 {cold:.2f}, steps 1..{T_STEPS - 1} {warm:.2f}; "
          f"last step of 2 streams within {worst:.2e} of the dense oracle")

    # solve_sequence is stream 0 of the farm, each at the cluster size the
    # rule takes for its stream count (so their sums run in other orders):
    # equal iterations but for round-off ties, within TOL of scale.
    shape = (IIWA.knot_points, IIWA.state_size, IIWA.control_size)
    c_one = kb.cluster_size(1, *shape, *kb.device_limits(0))
    c_all = kb.cluster_size(BATCH, *shape, *kb.device_limits(0))
    stream0 = gt.KKTBlocks(*(a[:, :1] for a in full))
    kw0 = dict(exit_tol=EXIT_TOL)
    ties, err = check_farm(
        "solve_sequence vs stream 0 of the farm",
        gt.SolveResult(*(x[:, None] for x in one)), gt.SolveResult(*(x[:, :1] for x in seq)),
        farm_steps(stream0, lam0[:1], rhos, kw0, c_one)[0],
        farm_steps(stream0, lam0[:1], rhos, kw0, c_all)[0])
    print(f"  solve_sequence B=1 T={T_STEPS} (C={c_one}) against stream 0 of the farm "
          f"(C={c_all}): iters equal ({ties} ties), max|d| {err:.3e}; iters "
          f"{one.iters.tolist()}")

    # Two packed windows carried by lam_tail_packed equal one farm run at
    # rho = options.rho.
    whole = gt.solve_sequence_batched(IIWA, full, opts)
    for name, a, b in (("lam", torch.cat([w1.lam_p, w2.lam_p]), whole.lam),
                       ("dz_x", torch.cat([w1.dzx_p, w2.dzx_p]), whole.dz_x),
                       ("iters", torch.cat([w1.iters, w2.iters]), whole.iters)):
        if not torch.equal(a, b):
            raise AssertionError(f"packed windows: {name} differs from one run")
    print(f"  pack_sequence -> solve_packed_sequence, two windows of {half} "
          "carried by lam_tail_packed: bit-identical to one farm run")

    # pack -> solve_packed -> update_vectors -> solve_packed with the carry.
    warm_opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL,
                                 max_iters=MAX_ITERS, warm_start=True)
    ref1 = gt.solve_batched(IIWA, step0, opts, pcg_backend="torch")
    ref2 = gt.solve_batched(IIWA, step1, warm_opts, lam0=ref1.lam,
                            pcg_backend="torch")
    for what, got, ref in (("first", first.unpack(), ref1),
                           ("second", second.unpack(), ref2)):
        check_iters(f"solve_packed {what}", got, ref, EXIT_TOL)
        for name in ("lam", "dz_x", "dz_u"):
            check_close(f"solve_packed {what} {name}", getattr(got, name),
                        getattr(ref, name))
    print(f"  pack -> solve_packed -> update_vectors -> solve_packed "
          f"(lam_packed carry) B={BATCH}: agrees with solve_batched 'torch'; "
          f"mean iters {float(first.iters.double().mean()):.2f} then "
          f"{float(second.iters.double().mean()):.2f}")
    return launches


def check_direct(what: str, k_res, p_res, gamma) -> float:
    """An exact solve's outcome against its plain version: converged equal,
    iters 0, eta within ETA_REL (1 + ||gamma||^2).  Returns max |d eta|."""
    kc, pc = k_res.converged.cpu().tolist(), p_res.converged.cpu().tolist()
    if kc != pc:
        raise AssertionError(f"{what}: converged {kc} vs plain {pc}")
    if int(k_res.iters.abs().max()) != 0:
        raise AssertionError(f"{what}: iters not 0")
    g2 = (gamma.double() ** 2).sum(dim=(-2, -1))
    d = (k_res.eta.double() - p_res.eta.double()).abs()
    if not bool((d <= ETA_REL * (1 + g2)).all()):
        raise AssertionError(f"{what}: eta {k_res.eta.tolist()} vs plain "
                             f"{p_res.eta.tolist()}")
    return float(d.max())


def singular_mix(n_good: int, seed0: int) -> gt.KKTBlocks:
    """One exactly singular problem (zero row/column in Q[2]; use rho=0) at
    index 1 among n_good healthy ones, on the card."""
    good = [testing.random_blocks(IIWA, seed=seed0 + i) for i in range(n_good)]
    bad = testing.singular_blocks(IIWA, seed=3, knot=2)
    return gt.blocks_to_torch(testing.stack_blocks(good[:1] + [bad] + good[1:]), DEV)


def phase_direct_parity():
    print(f"== phase 3c: the exact-solve kernels against their plain versions "
          f"at IIWA (14, 7, 50), rho={RHO}")
    full, _ = staged_batch(BATCH)
    _, limit = kb.device_limits(0)
    # Row 4 at its rule's cluster size and every one forced, at IIWA K = 50
    # and its plan's edges: K = 2, 3, an odd K, the last horizon it serves
    # (740: records in the global slice), the pendulum's and wide widths.
    iiwa = ((14, 7, 50), (1, 15, BATCH))
    edges = [(sizes, (1, 15)) for sizes in ((14, 7, 2), (14, 7, 3), (14, 7, 51),
                                            (14, 7, 740))]
    edges += [(sizes, (15,)) for sizes in ((2, 1, 5), (20, 9, 37), (32, 32, 6))]
    for sizes, ns in (iiwa, *edges):
        spec = gt.ProblemSpec(*sizes)
        s, c, K = sizes
        sizes_run = [C for C in kb.CLUSTER_SIZES if kd.cluster_fits(K, s, c, C, limit)]
        for n in ns:
            blocks = (gt.KKTBlocks(*(a[:n] for a in full)) if sizes == IIWA_SIZES else
                      gt.blocks_to_torch(testing.random_batch(spec, n, seed0=80), DEV))
            pres, pdx, pdu = kd.direct_fused_plain(*blocks, rho=RHO)
            gamma = assemble.condense(*blocks, RHO, None).gamma
            err = deta = 0.0
            for C in (None, *sizes_run):
                kres, kdx, kdu = kd.direct_fused_cuda(*blocks, rho=RHO, cluster=C)
                torch.cuda.synchronize()
                what = f"{kd.NAME} {sizes} B={n} C={kd.LAST_CLUSTER}"
                deta = max(deta, check_direct(what, kres, pres, gamma))
                if not bool(kres.converged.all()):
                    raise AssertionError(f"{what}: a problem did not converge")
                err = max(err, check_close(what + " lam", kres.lam, pres.lam),
                          check_close(what + " dz_x", kdx, pdx),
                          check_close(what + " dz_u", kdu, pdu))
            MAX_ERR[kd.NAME] = max(MAX_ERR[kd.NAME], err)
            print(f"  {kd.NAME} {sizes} B={n}: the rule's C and C = {sizes_run} forced: all "
                  f"converged, max|d| {err:.3e}, max|d eta| {deta:.3e} (eta up to "
                  f"{float(kres.eta.max()):.3e})")
    fields = kt.ThomasFactors._fields
    for n in (16, BATCH):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        kf = kt.thomas_fwd_cuda(*blocks, rho=RHO)
        pf = kt.thomas_fwd_plain(*blocks, rho=RHO)
        torch.cuda.synchronize()
        ferr = max(check_close(f"{kt.FWD_NAME} B={n} {name}", x, y)
                   for name, x, y in zip(fields, kf, pf))
        MAX_ERR[kt.FWD_NAME] = max(MAX_ERR[kt.FWD_NAME], ferr)
        rest = (blocks.q, blocks.A, blocks.B, blocks.r)
        # The reverse kernel on the plain stacks, against the plain reverse.
        kres, kdx, kdu = kt.thomas_rev_cuda(pf, *rest)
        pres, pdx, pdu = kt.thomas_rev_plain(pf, *rest)
        torch.cuda.synchronize()
        what = f"{kt.REV_NAME} B={n}"
        deta = check_direct(what, kres, pres, pf.gamma)
        rerr = max(check_close(what + " lam", kres.lam, pres.lam),
                   check_close(what + " dz_x", kdx, pdx),
                   check_close(what + " dz_u", kdu, pdu))
        MAX_ERR[kt.REV_NAME] = max(MAX_ERR[kt.REV_NAME], rerr)
        eerr = check_epilogue(what, pf, rest, kres, kdx, kdu)
        # The pair end to end against the plain composite.
        sres, sdx, sdu = kt.solve_direct_thomas_cuda(*blocks, rho=RHO)
        torch.cuda.synchronize()
        check_direct(f"thomas pair B={n}", sres, pres, pf.gamma)
        if not bool(sres.converged.all()):
            raise AssertionError(f"thomas pair B={n}: a problem did not converge")
        perr = max(check_close(f"thomas pair B={n} lam", sres.lam, pres.lam),
                   check_close(f"thomas pair B={n} dz_x", sdx, pdx),
                   check_close(f"thomas pair B={n} dz_u", sdu, pdu))
        print(f"  {kt.FWD_NAME} B={n}: the 7 factor stacks within tolerance, "
              f"max|d| {ferr:.3e}; {kt.REV_NAME} on the plain stacks max|d| "
              f"{rerr:.3e}, max|d eta| {deta:.3e} (its epilogue on its own lambda "
              f"max|d| {eerr:.3e}); the pair end to end: all converged, max|d| "
              f"{perr:.3e}")

    # Rows 5 and 6 at row 5's plan edges: K = 2, an odd K, the horizon the
    # exact routes reach (K = 1024), and the wide walk (s = 20, 32).
    for sizes, n in (((14, 7, 2), 16), ((14, 7, 51), 15), ((14, 7, 1024), 16),
                     ((20, 9, 37), 16), ((32, 32, 6), 16)):
        spec = gt.ProblemSpec(*sizes)
        blocks = gt.blocks_to_torch(testing.random_batch(spec, n, seed0=50), DEV)
        kf = kt.thomas_fwd_cuda(*blocks, rho=RHO)
        pf = kt.thomas_fwd_plain(*blocks, rho=RHO)
        torch.cuda.synchronize()
        what = f"{kt.FWD_NAME} {sizes} B={n}"
        ferr = max(check_close(f"{what} {name}", x, y) for name, x, y in zip(fields, kf, pf))
        MAX_ERR[kt.FWD_NAME] = max(MAX_ERR[kt.FWD_NAME], ferr)
        rest = (blocks.q, blocks.A, blocks.B, blocks.r)
        kres, kdx, kdu = kt.thomas_rev_cuda(kf, *rest)
        pres, pdx, pdu = kt.thomas_rev_plain(pf, *rest)
        torch.cuda.synchronize()
        deta = check_direct(f"thomas pair {sizes} B={n}", kres, pres, pf.gamma)
        if not bool(kres.converged.all()):
            raise AssertionError(f"thomas pair {sizes} B={n}: a problem did not converge")
        perr = max(check_close(f"thomas pair {sizes} B={n} {name}", k, p)
                   for name, k, p in (("lam", kres.lam, pres.lam), ("dz_x", kdx, pdx),
                                      ("dz_u", kdu, pdu)))
        MAX_ERR[kt.REV_NAME] = max(MAX_ERR[kt.REV_NAME], perr)
        check_epilogue(f"{kt.REV_NAME} {sizes} B={n}", kf, rest, kres, kdx, kdu)
        print(f"  {what}: the 7 factor stacks max|d| {ferr:.3e}; the pair on them "
              f"against the plain pair: all converged, max|d| {perr:.3e}, max|d eta| "
              f"{deta:.3e}")

    # Row 4's singular contract at every C: finite outputs, eta >= 1e30,
    # only it False.
    mix = singular_mix(2, seed0=40)
    pres, pdx, pdu = kd.direct_fused_plain(*mix, rho=0.0)
    for C in (None, *kb.CLUSTER_SIZES):
        kres, kdx, kdu = kd.direct_fused_cuda(*mix, rho=0.0, cluster=C)
        torch.cuda.synchronize()
        for res, who in ((kres, f"kernel C={kd.LAST_CLUSTER}"), (pres, "plain")):
            if res.converged.cpu().tolist() != [True, False, True] \
                    or not float(res.eta[1]) >= 1e30:
                raise AssertionError(f"{kd.NAME} singular ({who}): converged "
                                     f"{res.converged.tolist()}, eta {res.eta.tolist()}")
        for t in (kres.lam, kdx, kdu):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{kd.NAME} singular C={C}: an output is not finite")
        healthy = [0, 2]
        for name, k, p in (("lam", kres.lam, pres.lam), ("dz_x", kdx, pdx),
                           ("dz_u", kdu, pdu)):
            check_close(f"{kd.NAME} singular mix C={C} {name}", k[healthy], p[healthy])
    print(f"  {kd.NAME} singular input at the rule's C and C = {kb.CLUSTER_SIZES}: "
          f"converged {kres.converged.tolist()}, eta[1] = {float(kres.eta[1]):g}, every "
          "output finite; plain agrees")

    # Rows 5-6: that problem non-finite, the others as if it were absent.
    mix = singular_mix(16, seed0=60)
    kres, kdx, kdu = kt.solve_direct_thomas_cuda(*mix, rho=0.0)
    pres, pdx, pdu = kt.solve_direct_thomas_plain(*mix, rho=0.0)
    keep = [0] + list(range(2, 17))
    alone, adx, adu = kt.solve_direct_thomas_cuda(*(a[keep] for a in mix), rho=0.0)
    torch.cuda.synchronize()
    expect = [True, False] + [True] * 15
    for res, dx, du, who in ((kres, kdx, kdu, "kernel"), (pres, pdx, pdu, "plain")):
        if res.converged.cpu().tolist() != expect:
            raise AssertionError(f"thomas singular ({who}): converged "
                                 f"{res.converged.tolist()}")
        for name, t in (("lam", res.lam), ("dz_x", dx), ("dz_u", du),
                        ("eta", res.eta)):
            if bool(torch.isfinite(t[1]).any()):
                raise AssertionError(f"thomas singular ({who}): {name} of the "
                                     "singular problem has a finite entry")
    for name, k, a in (("lam", kres.lam, alone.lam), ("dz_x", kdx, adx),
                       ("dz_u", kdu, adu), ("eta", kres.eta, alone.eta)):
        if not torch.equal(k[keep], a):
            raise AssertionError(f"thomas singular: {name} of the healthy "
                                 "problems changed")
    for name, k, p in (("lam", kres.lam, pres.lam), ("dz_x", kdx, pdx),
                       ("dz_u", kdu, pdu)):
        check_close(f"thomas singular mix {name}", k[keep], p[keep])
    print("  thomas pair singular input (1 of 17): its lambda, dz and eta "
          "non-finite, converged False; the 16 others bit-identical to a run "
          "without it; plain agrees")


def check_epilogue(what: str, f, rest, res, dz_x, dz_u) -> float:
    """Row 6's epilogue against its knot-parallel plain version on the
    walk's own lambda: dz within TOL, eta within ETA_REL, converged equal.
    Returns max |d dz| (MAX_ERR's epilogue entry)."""
    pres, pdx, pdu = kt.thomas_epilogue_plain(f, *rest, res.lam)
    check_direct(f"{what} epilogue", res, pres, f.gamma)
    err = max(check_close(f"{what} epilogue dz_x", dz_x, pdx),
              check_close(f"{what} epilogue dz_u", dz_u, pdu))
    MAX_ERR[kt.EPILOGUE_NAME] = max(MAX_ERR[kt.EPILOGUE_NAME], err)
    return err


def split_dz(dz: torch.Tensor, K: int, s: int, c: int):
    """(B, nz) interleaved [x_0, u_0, ..., x_{K-1}] -> (dz_x, dz_u)."""
    Bn = dz.shape[0]
    head = dz[:, :(K - 1) * (s + c)].reshape(Bn, K - 1, s + c)
    dz_x = torch.cat([head[:, :, :s], dz[:, None, (K - 1) * (s + c):]], dim=1)
    return dz_x, head[:, :, s:]


def dense_solve64(blocks: gt.KKTBlocks, rho: float):
    """The float64 dense KKT solve on the card (the oracle only): (lam,
    dz_x, dz_u) in the solver's shapes."""
    K, s, c = IIWA.knot_points, IIWA.state_size, IIWA.control_size
    b64 = gt.KKTBlocks(*(a.double() for a in blocks))
    M, rhs = dense_kkt(b64, rho)
    x = torch.linalg.solve(M, rhs.unsqueeze(-1))[..., 0]
    nz = IIWA.nz
    dz_x, dz_u = split_dz(x[:, :nz], K, s, c)
    return x[:, nz:].reshape(-1, K, s), dz_x, dz_u


def check_oracle(what: str, res, blocks, rho: float) -> float:
    """lam, dz within 2e-3 of scale of the float64 dense solve (test_direct's
    tolerance against the dense oracle).  Returns the worst relative error."""
    worst = 0.0
    for lo in range(0, blocks.Q.shape[0], 64):
        part = gt.KKTBlocks(*(a[lo:lo + 64] for a in blocks))
        ref = dense_solve64(part, rho)
        for name, got, r in zip(("lam", "dz_x", "dz_u"),
                                (res.lam[lo:lo + 64], res.dz_x[lo:lo + 64],
                                 res.dz_u[lo:lo + 64]), ref):
            scale = max(1.0, float(r.abs().max()))
            err = float((got.double() - r).abs().max()) / scale
            if err > 2e-3:
                raise AssertionError(f"{what} {name}: {err:.3e} of scale off the "
                                     "float64 dense KKT solve")
            worst = max(worst, err)
    return worst


def direct_counts() -> dict:
    return {kd.NAME: kd.LAUNCHES, kt.FWD_NAME: kt.FWD_LAUNCHES,
            kt.REV_NAME: kt.REV_LAUNCHES, kt.EPILOGUE_NAME: kt.EPILOGUE_LAUNCHES}


def zero_direct_counts() -> None:
    kd.LAUNCHES = kt.FWD_LAUNCHES = kt.REV_LAUNCHES = kt.EPILOGUE_LAUNCHES = 0


def expect_counts(what: str, got: dict, row4: int, pair: int) -> None:
    want = {kd.NAME: row4, kt.FWD_NAME: pair, kt.REV_NAME: pair, kt.EPILOGUE_NAME: pair}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def phase_direct_path():
    print("== phase 4c: the exact main path (method='direct') through solve, "
          "solve_batched, solve_sequence_batched and pack / solve_packed")
    opts = gt.SolverOptions(rho=RHO, method="direct")
    full = gt.blocks_to_torch(testing.random_batch(IIWA, BATCH, seed0=3000), DEV)
    total = dict.fromkeys(direct_counts(), 0)

    def run(what, fn, row4, pair):
        zero_direct_counts()
        out = fn()
        torch.cuda.synchronize()
        got = direct_counts()
        expect_counts(what, got, row4, pair)
        for key, value in got.items():
            total[key] += value
        return out

    one = gt.KKTBlocks(*(a[0] for a in full))
    res1 = run("solve", lambda: gt.solve(IIWA, one, opts), 1, 0)
    res8 = run("solve_batched B=8", lambda: gt.solve_batched(
        IIWA, gt.KKTBlocks(*(a[:8] for a in full)), opts), 1, 0)
    resb = run(f"solve_batched B={BATCH}",
               lambda: gt.solve_batched(IIWA, full, opts), 0, 1)
    for what, res, n in (("solve", gt.SolveResult(*(t[None] for t in res1)), 1),
                         ("solve_batched B=8", res8, 8),
                         (f"solve_batched B={BATCH}", resb, BATCH)):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        if not bool(res.converged.all()) or int(res.iters.abs().max()) != 0:
            raise AssertionError(f"{what}: not all converged with iters 0")
        worst = check_oracle(what, res, blocks, RHO)
        ref = gt.solve_batched(IIWA, blocks, opts, pcg_backend="torch")
        for name in ("lam", "dz_x", "dz_u"):
            check_close(f"{what} {name} vs 'torch'", getattr(res, name),
                        getattr(ref, name))
        print(f"  {what}: converged, iters 0, within {worst:.2e} of scale of "
              f"the float64 dense KKT solve; agrees with the 'torch' backend")

    # The exact farm: 4096 solves folded into one batch, per-step rho.
    farm_blocks = farm(BATCH, T_STEPS, seed0=3100)
    rhos = farm_rhos(T_STEPS).cpu().numpy()
    seq = run(f"solve_sequence_batched B={BATCH} T={T_STEPS}",
              lambda: gt.solve_sequence_batched(IIWA, farm_blocks, opts,
                                                rhos=rhos), 0, 1)
    if not bool(seq.converged.all()):
        raise AssertionError("exact farm: a step did not converge")
    for t in range(T_STEPS):
        step = gt.solve_batched(IIWA, gt.KKTBlocks(*(a[t] for a in farm_blocks)),
                                gt.SolverOptions(rho=float(rhos[t]), method="direct"))
        for name in ("lam", "dz_x", "dz_u", "converged", "eta"):
            if not torch.equal(getattr(seq, name)[t], getattr(step, name)):
                raise AssertionError(f"exact farm step {t} {name} differs from "
                                     "solve_batched on that step")
    one_seq = gt.solve_sequence(IIWA, gt.KKTBlocks(*(a[:, 0] for a in farm_blocks)),
                                opts, rhos=rhos)
    if not torch.equal(one_seq.lam, seq.lam[:, 0]):
        raise AssertionError("solve_sequence (direct) differs from stream 0 of "
                             "the farm")
    print(f"  solve_sequence_batched B={BATCH} T={T_STEPS} (method='direct', "
          f"rho alternating {RHO:g} / {2 * RHO:g}): {T_STEPS * BATCH} solves in "
          "one launch pair, all converged, bit-identical to 16 per-step "
          "solve_batched calls; solve_sequence equals stream 0")

    step0 = gt.KKTBlocks(*(a[0] for a in farm_blocks))
    step1 = gt.KKTBlocks(*(a[1] for a in farm_blocks))
    ref0 = gt.solve_batched(IIWA, step0, opts, pcg_backend="torch")
    ref1 = gt.solve_batched(IIWA, step1, opts, pcg_backend="torch")
    for tier, row4, pair in (("cr", 2, 0), ("thomas", 0, 2)):
        def serve(tier=tier):
            packed = gt.pack(IIWA, step0, method="direct", tier=tier)
            first = gt.solve_packed(packed, opts)
            packed = gt.update_vectors(packed, step1.q, step1.r, step1.c)
            return packed, first, gt.solve_packed(packed, opts)
        packed, first, second = run(f"packed tier={tier}", serve, row4, pair)
        if packed.plan.tier != tier:
            raise AssertionError(f"pack(tier={tier!r}) planned {packed.plan.tier}")
        for what, got, ref in (("first", first.unpack(), ref0),
                               ("second", second.unpack(), ref1)):
            if not bool(got.converged.all()):
                raise AssertionError(f"solve_packed {tier} {what}: not converged")
            for name in ("lam", "dz_x", "dz_u"):
                check_close(f"solve_packed {tier} {what} {name}",
                            getattr(got, name), getattr(ref, name))
        if tier == "thomas" and not torch.equal(first.lam_p, seq.lam[0]):
            raise AssertionError("solve_packed thomas differs from the farm's "
                                 "step 0 (same kernels, same inputs)")
        print(f"  pack(tier={tier!r}) -> solve_packed -> update_vectors -> "
              f"solve_packed B={BATCH}: agrees with the 'torch' backend")
    print(f"  launches on the exact path: {total}")
    for name, count in total.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the exact path")
    return total


def condense_flops(K: int, s: int, c: int) -> float:
    """Qinv, Rinv, phi, B Rinv, theta and gamma of one problem."""
    f = K * 2 * s ** 3 + (K - 1) * 2 * c ** 3
    f += (K - 1) * (2 * s ** 3 + 2 * s * c * c)
    f += (K - 1) * (2 * s ** 3 + 2 * s * s * c)
    f += K * 2 * s * s + (K - 1) * (2 * s * s + 2 * s * c)
    return f


def recover_flops(K: int, s: int, c: int) -> float:
    return (K - 1) * 2 * s * s + K * 2 * s * s + (K - 1) * (2 * s * c + 2 * c * c)


def thomas_fwd_flops(K: int, s: int, c: int) -> float:
    """Row 5 per problem: condensation, then per knot Dhat^-1 and, from
    j = 1, M, M phi^T and M bhat."""
    return condense_flops(K, s, c) + K * 2 * s ** 3 + (K - 1) * (4 * s ** 3 + 2 * s * s)


def thomas_rev_flops(K: int, s: int, c: int) -> float:
    """Row 6 per problem: per knot Cinv (bhat - u), theta x and, from the
    second step on, phi^T x and phi x; the recovery."""
    return K * 2 * 2 * s * s + (K - 1) * 2 * 2 * s * s + recover_flops(K, s, c)


def epilogue_flops(K: int, s: int, c: int) -> float:
    """Row 6's epilogue per problem: theta x, phi x and phi^T x of the
    residual (the walk's phi^T x is not reused), the recovery."""
    return (K + 2 * (K - 1)) * 2 * s * s + recover_flops(K, s, c)


def phase_direct_times(card: str):
    print(f"== phase 5c: the exact-solve kernels' times (CUDA events, median "
          f"of {TIMING_RUNS} runs after warm-up; {SLOW_RUNS} for library calls) "
          f"on {card}")
    full, _ = staged_batch(BATCH)
    K, s, c = IIWA.knot_points, IIWA.state_size, IIWA.control_size
    times = {}
    for n in (1, BATCH):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        rest = (blocks.q, blocks.A, blocks.B, blocks.r)
        kres, kdx, kdu = kd.direct_fused_cuda(*blocks, rho=RHO)
        f = kt.thomas_fwd_cuda(*blocks, rho=RHO)
        tres, tdx, tdu = kt.thomas_rev_cuda(f, *rest)
        flags = 2 * 4 * n                      # conv (int32) and eta, per problem
        out = nbytes(kres.lam, kdx, kdu) + flags
        # Row 4 and the pair compute one function (condense, exact solve,
        # true residual, recover) from the same inputs: both are bounded by
        # the fewest operations it needs, block Thomas's, which are fewer
        # than row 4's own cyclic reduction does.
        exact = bound(nbytes(*blocks) + out,
                      n * (thomas_fwd_flops(K, s, c) + thomas_rev_flops(K, s, c)))
        bounds = {
            kd.NAME: exact,
            kt.FWD_NAME: bound(nbytes(*blocks, *f), n * thomas_fwd_flops(K, s, c)),
            kt.REV_NAME: bound(nbytes(*f, *rest) + out, n * thomas_rev_flops(K, s, c)),
            "pair": exact,
        }
        M, rhs = dense_kkt(blocks, RHO)
        rhs = rhs.unsqueeze(-1)
        lib = torch.linalg.solve(M, rhs)
        lib_lam = lib[:, IIWA.nz:, 0].reshape(n, K, s)
        print(f"  B={n}: the dense KKT solve (library) against row 4 max|dlam| "
              f"{float((lib_lam - kres.lam).abs().max()):.2e}, against the "
              f"Thomas pair {float((lib_lam - tres.lam).abs().max()):.2e} "
              "(both exact: float32 round-off)")
        rows = (
            (kd.NAME, lambda: kd.direct_fused_cuda(*blocks, rho=RHO),
             lambda: kd.direct_fused_plain(*blocks, rho=RHO), True),
            ("pair", lambda: kt.solve_direct_thomas_cuda(*blocks, rho=RHO),
             lambda: kt.solve_direct_thomas_plain(*blocks, rho=RHO), True),
            (kt.FWD_NAME, lambda: kt.thomas_fwd_cuda(*blocks, rho=RHO),
             lambda: kt.thomas_fwd_plain(*blocks, rho=RHO), False),
            (kt.REV_NAME, lambda: kt.thomas_rev_cuda(f, *rest),
             lambda: kt.thomas_rev_plain(f, *rest), False),
        )
        lib_ms = cuda_median_ms(lambda: torch.linalg.solve(M, rhs),
                                runs=SLOW_RUNS, warmup=1)
        for name, kern, plain, has_lib in rows:
            p1 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
            k1 = cuda_median_ms(kern)
            k2 = cuda_median_ms(kern)
            p2 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
            bound_ms, bound_by = bounds[name]
            # One call's device time, from a CUDA graph of 20 calls.
            dev_ms = graph_ms_per_call(kern, calls=20)
            if name == kt.REV_NAME:
                epilogue_times(times, n, f, rest, tres, tdx, tdu, card)
            times[(name, n)] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                    library_ms=lib_ms if has_lib else None,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    device_ms=dev_ms)
            lib_text = f"library {lib_ms:.4f} ms" if has_lib else "no library call"
            dev_text = "" if dev_ms is None else f", device {dev_ms:.4f} ms"
            print(f"  {name} B={n}: kernel {k1:.4f} / {k2:.4f} ms{dev_text}, plain "
                  f"{p1:.4f} / {p2:.4f} ms, {lib_text}, bound {bound_ms:.5f} ms "
                  f"({bound_by}; {100 * bound_ms / ((k1 + k2) / 2):.2f} % of the "
                  f"kernel's time)  [{card}]")
        del M, rhs, lib
        torch.cuda.empty_cache()

    # Row 4 by cluster size (events; the rule's device time from a CUDA
    # graph) at K = 50, B = 1, 15 and 256, and at K = 740, its last horizon.
    _, limit = kb.device_limits(0)
    for Kr, n in ((50, 1), (50, 15), (50, BATCH), (740, 1)):
        blocks = (gt.KKTBlocks(*(a[:n] for a in full)) if Kr == K else
                  gt.blocks_to_torch(testing.random_batch(gt.ProblemSpec(14, 7, Kr), n,
                                                          seed0=95), DEV))

        def kern(C=None, blocks=blocks):
            return kd.direct_fused_cuda(*blocks, rho=RHO, cluster=C)
        by_c = {C: cuda_median_ms(lambda C=C: kern(C)) for C in kb.CLUSTER_SIZES
                if kd.cluster_fits(Kr, s, c, C, limit)}
        ms = cuda_median_ms(kern)
        dev_ms = graph_ms_per_call(kern, calls=20)
        C = kd.LAST_CLUSTER
        times[("row4_rule", Kr, n)] = dict(ms=ms, device_ms=dev_ms, cluster=C,
                                           by_cluster={str(k): v for k, v in by_c.items()})
        print(f"  {kd.NAME} K={Kr} B={n}: rule C={C} {ms:.4f} ms (device {dev_ms:.4f} ms); "
              "by C " + ", ".join(f"{k}: {v:.4f}" for k, v in by_c.items()) + f"  [{card}]")
    stamps = STAMPS.result()
    print("  row 4 by stage (tools/direct_stamps.py, the stamped build's %globaltimer, "
          f"median of {stamps['runs']} launches, us): " + "; ".join(
              f"{key}: " + ", ".join(f"{lab} {ph:.1f}" for lab, ph in
                                     zip(r["labels"], r["phases"]))
              for key, r in stamps["row4"].items()) + f"  [{card}]")
    print(f"  per-solve time, row 4 against the Thomas pair [{card}]:")
    crossover = None
    for n in CROSSOVER_B:
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        t4 = cuda_median_ms(lambda: kd.direct_fused_cuda(*blocks, rho=RHO))
        tp = cuda_median_ms(lambda: kt.solve_direct_thomas_cuda(*blocks, rho=RHO))
        times[("crossover", n)] = (t4, tp)
        if crossover is None and tp < t4:
            crossover = n
        print(f"    B={n:4d}: row 4 {t4:.4f} ms ({1e3 * t4 / n:.2f} us/solve), "
              f"pair {tp:.4f} ms ({1e3 * tp / n:.2f} us/solve)")
    where = (f"from B={crossover}" if crossover is not None
             else "at no width")
    print(f"  the pair is faster {where} of {CROSSOVER_B} "
          f"(the port routes from B >= {kt.MIN_BATCH}, gato_tpu's constant)")
    # Where auto sends a long horizon at B >= 16 (the pair) beside the
    # long-K exact routes on the same inputs (ROADMAP queue 1 item 9).
    K = 1024
    blocks = longk_batch(K, 16, seed0=9700)
    tp = cuda_median_ms(lambda: kt.solve_direct_thomas_cuda(*blocks, rho=RHO))
    txl = cuda_median_ms(lambda: kl.solve_direct_longk_batched(*blocks, rho=RHO,
                                                                force_tier="xl"))
    thy = cuda_median_ms(lambda: kl.solve_direct_longk_batched(*blocks, rho=RHO,
                                                                force_tier="hybrid"))
    f = kt.thomas_fwd_cuda(*blocks, rho=RHO)
    rest = (blocks.q, blocks.A, blocks.B, blocks.r)
    trev = graph_ms_per_call(lambda: kt.thomas_rev_cuda(f, *rest), calls=20)
    times[("long", K, 16)] = dict(pair=tp, xl=txl, hybrid=thy, rev_device=trev)
    print(f"  K={K} B=16: the Thomas pair {tp:.4f} ms (row 6 device {trev:.4f} ms), 'xl' "
          f"(rows 7 + 11 + 13) {txl:.4f} ms, 'hybrid' {thy:.4f} ms (auto: the pair)  "
          f"[{card}]")
    line = STAMPS.result()
    print("  row 5 by stage (tools/direct_stamps.py, the stamped build's "
          f"%globaltimer, median of {line['runs']} launches, us; the condensation "
          "launch, the walk launch's knots): " + "; ".join(
              f"{key}: condensation {r['stage1']:.1f}, walk {r['walk']:.1f} "
              f"({r['knots_stamped']} knots, {r['knot']:.2f} a knot; the first with the "
              f"launch gap {r['first_knot']:.2f})" for key, r in line["row5"].items())
          + f"  [{card}]")
    print("  row 6 by stage (the stamped build, problem 0's walk and the epilogue "
          "launch, us): " + "; ".join(
              f"{key}: walk {r['walk']:.1f} ({r['knots_stamped']} knots stamped, "
              f"{r['knot']:.3f} a knot), gap {r['gap']:.1f}, epilogue {r['epilogue']:.1f}"
              for key, r in line["row6"].items()) + f"  [{card}]")
    print("  the alternative condensation, kernel B's on one thread-block cluster a "
          "problem (cluster_body.cuh stages 1-3, its stamps in the same build and "
          "inputs, us): " + "; ".join(
              f"{key}: {r['condensation']:.1f} (C = {r['cluster_ctas']}; row 5's tiles "
              f"{line['row5'][key]['stage1']:.1f})" for key, r in line["cluster"].items())
          + f"  [{card}]")
    return times


def epilogue_times(times: dict, n: int, f, rest, res, dz_x, dz_u, card: str) -> None:
    """Row 6's epilogue at IIWA K = 50, B = n: its device time from the
    stamps child (the launch's first CTA's start to its last CTA's end),
    the knot-parallel plain version's time, its bound; into times."""
    K, s, c = IIWA.knot_points, IIWA.state_size, IIWA.control_size
    stamps = STAMPS.result()["row6"][f"K=50 B={n}"]
    plain = lambda: kt.thomas_epilogue_plain(f, *rest, res.lam)  # noqa: E731
    p1 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
    p2 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
    read = (f.Qinv, f.Rinv, f.phi, f.theta, f.gamma, *rest, res.lam)
    bound_ms, bound_by = bound(nbytes(*read, dz_x, dz_u) + 2 * 4 * n,
                               n * epilogue_flops(K, s, c))
    ms = stamps["epilogue"] / 1e3
    times[(kt.EPILOGUE_NAME, n)] = dict(ms=ms, plain_ms=(p1 + p2) / 2, library_ms=None,
                                        bound_ms=bound_ms, bound_by=bound_by,
                                        device_ms=ms)
    print(f"  {kt.EPILOGUE_NAME} B={n}: device {ms:.4f} ms (the stamps child's "
          f"launch), plain {p1:.4f} / {p2:.4f} ms, no library call, bound "
          f"{bound_ms:.5f} ms ({bound_by}; {100 * bound_ms / ms:.2f} % of it)  [{card}]")


class StampsChild:
    """tools/direct_stamps.py's stamps child (rows 5 and 11 by stage, with
    the kernels built again with -DGATO_STAGE_STAMPS): start() has it build
    beside this process's build, wait_built() waits for its build to end
    (so that no timed phase shares the host with nvcc); result() lets it
    measure while this process waits (so the two never share the card),
    and raises if it failed."""

    RUNS = 10

    def __init__(self):
        self.proc = None
        self.line = None

    def start(self) -> None:
        tool = Path(__file__).resolve().parent / "gato_tpu_torch" / "tools" / "direct_stamps.py"
        self.proc = subprocess.Popen([sys.executable, str(tool), "--runs", str(self.RUNS),
                                      "--stamps-child", "--wait"], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)

    def wait_built(self) -> None:
        said = self.proc.stdout.readline().strip()
        if said != "built":
            self.proc.wait(timeout=60)
            raise AssertionError(f"direct_stamps.py --stamps-child did not build (exit "
                                 f"{self.proc.returncode}, said {said!r}):\n"
                                 f"{self.proc.stderr.read()[-4000:]}")

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self) -> dict:
        if self.line is None:
            torch.cuda.synchronize()
            out, err = self.proc.communicate("go\n", timeout=900)
            if self.proc.returncode != 0:
                raise AssertionError(f"direct_stamps.py --stamps-child failed (exit "
                                     f"{self.proc.returncode}):\n{out[-2000:]}{err[-4000:]}")
            self.line = json.loads(out.strip().splitlines()[-1])
            self.line["runs"] = self.RUNS
        return self.line


STAMPS = StampsChild()


def cuda_median_ms(fn, runs=TIMING_RUNS, warmup=3) -> float:
    for _ in range(warmup):
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


def pcg_flops(K: int, s: int, iters: torch.Tensor, conv: torch.Tensor,
              poly: int) -> float:
    """Floating-point operations of the PCG loops that ran: per loop body
    one S matvec and the preconditioner's 2 poly - 1 block-tridiagonal
    matvecs (6 K s^2 each), plus ~10 K s for the dots and updates; the
    set-up costs one body.  A loop that converged at index i ran i + 1
    bodies, one that did not ran max_iters (iters)."""
    bodies = (iters.double() + conv.double()).sum().item() + iters.numel()
    return bodies * (2 * poly * 6 * K * s * s + 10 * K * s)


def condense_recover_flops(K: int, s: int, c: int, prec: str) -> float:
    """Operations of one problem's condensation, preconditioner and
    recovery (an n x n inverse counted as 2 n^3)."""
    f = K * 2 * s ** 3 + (K - 1) * 2 * c ** 3                 # Qinv, Rinv
    f += (K - 1) * (2 * s ** 3 + 2 * s * c * c)               # phi, B Rinv
    f += (K - 1) * (2 * s ** 3 + 2 * s * s * c)               # theta
    if prec != "jacobi":
        f += K * 2 * s ** 3                                   # theta^-1
    if prec == "symmetric_stair":
        f += 4 * (K - 1) * 2 * s ** 3                         # off-diagonals
    f += K * (4 * s * s + 2 * s * c)                          # gamma
    f += K * 4 * s * s + (K - 1) * (2 * s * c + 2 * c * c)    # dz recovery
    return f


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_: float, flops: float):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the float32 rate."""
    t_bytes = nbytes_ / HBM_BYTES * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_btd(S: torch.Tensor) -> torch.Tensor:
    """(B, K, 3, s, s) block-tridiagonal -> dense (B, K s, K s) on the card."""
    Bn, K, _, s, _ = S.shape
    M = torch.zeros(Bn, K * s, K * s, dtype=S.dtype, device=S.device)
    for k in range(K):
        r = slice(k * s, (k + 1) * s)
        M[:, r, r] = S[:, k, 1]
        if k > 0:
            M[:, r, (k - 1) * s:k * s] = S[:, k, 0]
        if k < K - 1:
            M[:, r, (k + 1) * s:(k + 2) * s] = S[:, k, 2]
    return M


def dense_kkt(b: gt.KKTBlocks, rho: float):
    """Batched dense saddle-point system [[G + rho I, C^T], [C, 0]] and rhs
    [g; c] on the card, in the layout of formats.blocks_to_dense_kkt."""
    Bn, K, s, _ = b.Q.shape
    c = b.R.shape[-1]
    sc = s + c
    nz = K * sc - c
    N = nz + K * s
    M = torch.zeros(Bn, N, N, dtype=b.Q.dtype, device=b.Q.device)
    rhs = torch.zeros(Bn, N, dtype=b.Q.dtype, device=b.Q.device)
    eye_s = torch.eye(s, dtype=b.Q.dtype, device=b.Q.device)
    eye_c = torch.eye(c, dtype=b.Q.dtype, device=b.Q.device)
    M[:, nz:nz + s, :s] = eye_s
    M[:, :s, nz:nz + s] = eye_s
    for k in range(K):
        o = k * sc
        M[:, o:o + s, o:o + s] = b.Q[:, k] + rho * eye_s
        rhs[:, o:o + s] = b.q[:, k]
        rhs[:, nz + k * s:nz + (k + 1) * s] = b.c[:, k]
        if k < K - 1:
            M[:, o + s:o + sc, o + s:o + sc] = b.R[:, k] + rho * eye_c
            rhs[:, o + s:o + sc] = b.r[:, k]
            ro = nz + (k + 1) * s
            C = torch.cat([b.A[:, k], b.B[:, k], eye_s.expand(Bn, s, s)], dim=2)
            M[:, ro:ro + s, o:o + sc + s] = C
            M[:, o:o + sc + s, ro:ro + s] = C.transpose(1, 2)
    return M, rhs


def phase_times(card: str):
    print(f"== phase 5: times (CUDA events, median of {TIMING_RUNS} runs "
          f"after warm-up; {SLOW_RUNS} for library calls) on {card}")
    full, lam0_full = staged_batch(BATCH)
    times = {}
    for n in (1, BATCH):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        lam0 = lam0_full[:n]
        sys_ = assemble.condense(*blocks, RHO)
        pkw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
        fkw = dict(rho=RHO, **pkw)
        K, s, c = IIWA.knot_points, IIWA.state_size, IIWA.control_size
        ra = ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, lam0, **pkw)
        rb, dxb, dub = kb.fused_solve_cuda(*blocks, lam0, **fkw)
        bounds = {
            ka.NAME: bound(nbytes(sys_.S, sys_.Pinv, sys_.gamma, lam0, ra.lam,
                                  ra.iters, ra.converged, ra.eta),
                           pcg_flops(K, s, ra.iters, ra.converged, 1)),
            kb.NAME: bound(nbytes(*blocks, lam0, rb.lam, dxb, dub, rb.iters,
                                  rb.converged, rb.eta),
                           pcg_flops(K, s, rb.iters, rb.converged, 1)
                           + n * condense_recover_flops(K, s, c, "symmetric_stair")),
        }
        # One PyTorch call computing the same function: a dense LU solve of
        # the Schur system (kernel A) or of the whole KKT system (kernel B).
        S_dense = dense_btd(sys_.S)
        gamma = sys_.gamma.reshape(n, -1, 1)
        M, rhs = dense_kkt(blocks, RHO)
        rhs = rhs.unsqueeze(-1)
        lib_a = torch.linalg.solve(S_dense, gamma)
        lib_b = torch.linalg.solve(M, rhs)
        nz = IIWA.nz
        print(f"  B={n}: library solves against the kernels: max|dlam| "
              f"{float((lib_a.reshape(n, K, s) - ra.lam).abs().max()):.2e} (A), "
              f"{float((lib_b[:, nz:, 0].reshape(n, K, s) - rb.lam).abs().max()):.2e} (B)")
        rows = (
            (ka.NAME, lambda: ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, lam0, **pkw),
             lambda: ka.pcg_batched_plain(sys_.S, sys_.Pinv, sys_.gamma, lam0, **pkw),
             lambda: torch.linalg.solve(S_dense, gamma)),
            (kb.NAME, lambda: kb.fused_solve_cuda(*blocks, lam0, **fkw),
             lambda: kb.fused_solve_plain(*blocks, lam0, **fkw),
             lambda: torch.linalg.solve(M, rhs)),
        )
        for name, kern, plain, lib in rows:
            # plain, kernel, kernel, plain; each time is the mean of its pair
            p1 = cuda_median_ms(plain)
            k1 = cuda_median_ms(kern)
            k2 = cuda_median_ms(kern)
            p2 = cuda_median_ms(plain)
            lib_ms = cuda_median_ms(lib, runs=SLOW_RUNS, warmup=1)
            bound_ms, bound_by = bounds[name]
            # Kernel A's device time: one call from a CUDA graph of 20
            # (kernel B's comes with its rule's table below).
            dev_ms = graph_ms_per_call(kern, calls=20) if name == ka.NAME else None
            times[(name, n)] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                    library_ms=lib_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, device_ms=dev_ms)
            dev_text = "" if dev_ms is None else f", device {dev_ms:.4f} ms"
            print(f"  {name} B={n}: kernel {k1:.4f} / {k2:.4f} ms{dev_text}, plain "
                  f"{p1:.4f} / {p2:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})  [{card}]")
        del S_dense, M, rhs, lib_a, lib_b
        torch.cuda.empty_cache()
    # Kernel B at B = 1, 4, 16, 64, 256: the rule's cluster size (events,
    # and the device time of one launch from 20 in a CUDA graph), and every
    # cluster size forced (events), the table the rule is set from.
    for n in CROSSOVER_B:
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        lam0 = lam0_full[:n]
        fkw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
        by_c = {}
        for C in kb.CLUSTER_SIZES:
            by_c[C] = cuda_median_ms(lambda: kb.fused_solve_cuda(*blocks, lam0, cluster=C,
                                                                 **fkw))
        rule = lambda: kb.fused_solve_cuda(*blocks, lam0, **fkw)  # noqa: E731
        ms = cuda_median_ms(rule)
        dev_ms = graph_ms_per_call(rule, calls=20)
        C = kb.LAST_CLUSTER
        times[("rule", n)] = dict(ms=ms, device_ms=dev_ms, cluster=C,
                                  by_cluster={str(k): v for k, v in by_c.items()})
        best = min(by_c, key=by_c.get)
        print(f"  {kb.NAME} B={n}: rule C={C} {ms:.4f} ms (device {dev_ms:.4f} ms); by C "
              + ", ".join(f"{k}: {v:.4f}" for k, v in by_c.items())
              + f"; fastest C={best}  [{card}]")
    # Kernel A the same way at B = 1 and 256, and at K = 688, the last
    # horizon before the long-K tier.
    _, limit = kb.device_limits(0)
    for K, n in ((50, 1), (50, BATCH), (688, 1)):
        blocks = (gt.KKTBlocks(*(a[:n] for a in full)) if K == IIWA.knot_points else
                  gt.blocks_to_torch(testing.random_batch(gt.ProblemSpec(14, 7, K), n,
                                                          seed0=90), DEV))
        sys_ = assemble.condense(*blocks, RHO)

        def kern(C=None, sys_=sys_):
            return ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, exit_tol=EXIT_TOL,
                                       max_iters=MAX_ITERS, cluster=C)
        by_c = {C: cuda_median_ms(lambda C=C: kern(C)) for C in kb.CLUSTER_SIZES
                if ka.cluster_fits(K, 14, C, limit)}
        ms = cuda_median_ms(kern)
        dev_ms = graph_ms_per_call(kern, calls=20)
        C = ka.LAST_CLUSTER
        times[("A_rule", K, n)] = dict(ms=ms, device_ms=dev_ms, cluster=C,
                                       by_cluster={str(k): v for k, v in by_c.items()})
        print(f"  {ka.NAME} K={K} B={n}: rule C={C} {ms:.4f} ms (device {dev_ms:.4f} ms); "
              "by C " + ", ".join(f"{k}: {v:.4f}" for k, v in by_c.items()) + f"  [{card}]")
    line = STAMPS.result()
    print("  kernel A by stage (tools/direct_stamps.py, the stamped build's %globaltimer, "
          f"median of {line['runs']} launches, us): " + "; ".join(
              f"{key}: " + ", ".join(f"{lab} {ph:.1f}" for lab, ph in
                                     zip(r["labels"], r["phases"]))
              for key, r in line["rowA"].items()) + f"  [{card}]")
    return times


def wide_times(card: str) -> dict:
    """Kernel B's <36, 12> body at ANYMAL, B = 1 and 4, at the rule's C:
    plain, kernel, kernel, plain (CUDA events), the device time of one
    launch from 20 in a CUDA graph, and the bound of those inputs."""
    s, c, K = ANYMAL
    fkw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    times = {}
    for n in ANYMAL_B:
        blocks, lam0 = anymal_batch(n)
        res, dx, du = kb.fused_solve_cuda(*blocks, lam0, **fkw)
        bound_ms, bound_by = bound(
            nbytes(*blocks, lam0, res.lam, dx, du, res.iters, res.converged, res.eta),
            pcg_flops(K, s, res.iters, res.converged, 1)
            + n * condense_recover_flops(K, s, c, "symmetric_stair"))

        def kern(blocks=blocks, lam0=lam0):
            return kb.fused_solve_cuda(*blocks, lam0, **fkw)

        def plain(blocks=blocks, lam0=lam0):
            return kb.fused_solve_plain(*blocks, lam0, **fkw)
        p1 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
        k1 = cuda_median_ms(kern)
        k2 = cuda_median_ms(kern)
        p2 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
        dev_ms = graph_ms_per_call(kern, calls=20)
        times[n] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=None,
                        bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_ms,
                        cluster=kb.LAST_CLUSTER,
                        iters_mean=float(res.iters.double().mean()))
        print(f"  {kb.NAME} <36, 12> {ANYMAL} B={n}: C={kb.LAST_CLUSTER} kernel {k1:.4f} / "
              f"{k2:.4f} ms, device {dev_ms:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}; {100 * bound_ms / dev_ms:.2f} % of the "
              f"device time), iters {times[n]['iters_mean']:.2f}  [{card}]")
    return times


def phase_sequence_times(card: str):
    print(f"== phase 5b: the sequence kernel, T={T_STEPS}, against its plain "
          f"version and {T_STEPS} chained {kb.NAME} launches [{card}]")
    full = farm(BATCH, T_STEPS, seed0=500)
    rhos = farm_rhos(T_STEPS)
    rho_list = rhos.tolist()
    kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    K, s, c = IIWA.knot_points, IIWA.state_size, IIWA.control_size
    times = {}
    for n in (1, BATCH):
        blocks = gt.KKTBlocks(*(a[:, :n] for a in full))
        lam0 = torch.zeros_like(blocks.q[0])

        def chained():
            lam = lam0
            for t in range(T_STEPS):
                lam = kb.fused_solve_cuda(*(a[t] for a in blocks), lam,
                                          rho=rho_list[t], **kw)[0].lam

        res, dx, du = ks.fused_sequence_cuda(*blocks, lam0, rhos, **kw)
        bound_ms, bound_by = bound(
            nbytes(*blocks, lam0, rhos, res.lam, dx, du, res.iters,
                   res.converged, res.eta),
            pcg_flops(K, s, res.iters, res.converged, 1)
            + T_STEPS * n * condense_recover_flops(K, s, c, "symmetric_stair"))
        kern = lambda: ks.fused_sequence_cuda(*blocks, lam0, rhos, **kw)  # noqa: E731
        plain = lambda: ks.fused_sequence_plain(*blocks, lam0, rhos, **kw)  # noqa: E731
        p1 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
        c1 = cuda_median_ms(chained)
        k1 = cuda_median_ms(kern)
        k2 = cuda_median_ms(kern)
        c2 = cuda_median_ms(chained)
        p2 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
        C = ks.LAST_CLUSTER
        by_c = {str(k): cuda_median_ms(
            lambda: ks.fused_sequence_cuda(*blocks, lam0, rhos, cluster=k, **kw),
            runs=SLOW_RUNS, warmup=1) for k in kb.CLUSTER_SIZES}
        times[n] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                        chained_ms=(c1 + c2) / 2, library_ms=None,
                        bound_ms=bound_ms, bound_by=bound_by, cluster=C,
                        by_cluster=by_c)
        print(f"  {ks.NAME} B={n} T={T_STEPS} C={C}: by C "
              + ", ".join(f"{k}: {v:.3f}" for k, v in by_c.items()) + " ms")
        print(f"  {ks.NAME} B={n} T={T_STEPS} C={C}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"{T_STEPS} chained {kb.NAME} {c1:.4f} / {c2:.4f} ms, plain "
              f"{p1:.4f} / {p2:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"iterations {int(res.iters.sum())} in all  [{card}]")
    return times


# ---------------------------------------------------------------------------
# The long-horizon PCG tier (rows 7, 8/10, 9 and 13: kernels/longk.py)
# ---------------------------------------------------------------------------

LONGK_K = (1024, 2048, 4096, 8192)
LONGK_B = (1, 16)
OPS_FIELDS = ("S", "Pinv", "gamma", "Qinv", "Rinv")


def longk_spec(K: int) -> gt.ProblemSpec:
    return gt.ProblemSpec(IIWA.state_size, IIWA.control_size, K)


def longk_batch(K: int, n: int, seed0: int) -> gt.KKTBlocks:
    """n IIWA-width problems of horizon K on the card (testing.random_batch)."""
    return gt.blocks_to_torch(testing.random_batch(longk_spec(K), n, seed0=seed0), DEV)


def longk_counts() -> dict:
    return {kl.CONDENSE_NAME: kl.CONDENSE_LAUNCHES, kl.PCG_NAME: kl.PCG_LAUNCHES,
            kl.FUSED_NAME: kl.FUSED_LAUNCHES, kl.RECOVER_NAME: kl.RECOVER_LAUNCHES}


def zero_longk_counts() -> None:
    kl.CONDENSE_LAUNCHES = kl.PCG_LAUNCHES = kl.FUSED_LAUNCHES = 0
    kl.RECOVER_LAUNCHES = 0


def _longk_limits() -> tuple:
    """(SMs, shared bytes a block may use) of the card, as the wrappers
    plan with them."""
    return (torch.cuda.get_device_properties(DEV).multi_processor_count,
            _build.max_shared_bytes(DEV.index) - _build.RESERVED_SHARED_BYTES)


def pcg_plan_text(n: int, K: int, poly: int = 1, ctas=None) -> str:
    """Rows 8/10's plan of n problems of horizon K at IIWA width on this
    card: its rounds, the CTAs a problem and knots a CTA, what sits in
    shared memory, how the CTAs meet and the grid barriers an iteration."""
    rounds = kl.pcg_rounds(n, K, IIWA.state_size, *_longk_limits(), ctas)
    rd = rounds[0]
    held = [name for bit, name in ((kl.VEC_IN_SMEM, "vectors"), (kl.S_RESIDENT, "S"),
                                   (kl.P_RESIDENT, "Pinv")) if rd.flags & bit]
    streamed = [name for bit, name in ((kl.S_RESIDENT, "S"), (kl.P_RESIDENT, "Pinv"))
                if not rd.flags & bit]
    meeting = ("grid barriers (cg::grid_group::sync)" if rd.meet == "grid"
               else "barriers over each problem's CTAs (flagged partials)")
    return (f"{len(rounds)} round(s), {rd.nprob} x {rd.per} CTAs, "
            f"{-(-K // rd.per)} knots a CTA, in shared memory: "
            f"{', '.join(held) or 'nothing'}"
            + (f"; streamed ({rd.ring}-knot ring): {', '.join(streamed)}" if streamed else "")
            + f"; {kl.grid_barriers(poly)} {meeting} an iteration")


def check_longk_kernels(what: str, blocks, lam0, *, rho=RHO,
                        prec="symmetric_stair", poly=1, cap=MAX_ITERS,
                        keep=None, ctas=None) -> str:
    """The four long-K kernels against their plain versions on one batch:
    row 7 on the inputs, rows 8/10 and 13 on the plain version's operators
    and multipliers (each kernel alone; rows 8/10 at ``ctas`` CTAs a
    problem, None for the plan's, one launch a round, and, where every
    round holds one problem, bit for bit on flagged partials too), row 9
    end to end.  ``keep`` limits the value comparisons to those problems (a
    singular mix).  Returns a summary line."""
    kw = dict(exit_tol=EXIT_TOL, max_iters=cap, poly_degree=poly)
    sel = slice(None) if keep is None else keep
    kops = kl.condense_longk_cuda(*blocks, rho=rho, preconditioner=prec)
    pops = kl.condense_longk_plain(*blocks, rho=rho, preconditioner=prec)
    torch.cuda.synchronize()
    if not torch.equal(kops.bad.cpu(), pops.bad.cpu()):
        raise AssertionError(f"{what} {kl.CONDENSE_NAME}: zero-pivot flags "
                             f"{kops.bad.tolist()} vs plain {pops.bad.tolist()}")
    e7 = max(check_close(f"{what} {kl.CONDENSE_NAME} {name}", x[sel], y[sel])
             for name, x, y in zip(OPS_FIELDS, kops, pops))
    n, K, s = pops.gamma.shape
    rounds = kl.pcg_rounds(n, K, s, *_longk_limits(), ctas)
    before = kl.PCG_LAUNCHES
    kres = kl.pcg_longk_cuda(pops.S, pops.Pinv, pops.gamma, lam0, pops.bad,
                             _rounds=None if ctas is None else rounds, **kw)
    if kl.PCG_LAUNCHES - before != len(rounds):
        raise AssertionError(f"{what} {kl.PCG_NAME}: {kl.PCG_LAUNCHES - before} launches "
                             f"counted for {len(rounds)} rounds")
    # The same sums in the same order on either meeting: the same bits.
    if all(rd.meet == "grid" for rd in rounds):
        other = kl.pcg_longk_cuda(pops.S, pops.Pinv, pops.gamma, lam0, pops.bad,
                                  _rounds=tuple(rd._replace(meet="flags") for rd in rounds),
                                  **kw)
        if not all(torch.equal(x, y) for x, y in zip(kres, other)):
            raise AssertionError(f"{what} {kl.PCG_NAME}: flagged partials differ from "
                                 "grid barriers")
    pres = kl.pcg_longk_plain(pops.S, pops.Pinv, pops.gamma, lam0, pops.bad, **kw)
    one_an_sm = kl.pcg_rounds(n, K, s, *_longk_limits(), per_sm=1)
    before = kl.FUSED_LAUNCHES
    fres, fqi, fri = kl.fused_longk_cuda(*blocks, lam0, rho=rho,
                                         preconditioner=prec, **kw)
    if kl.FUSED_LAUNCHES - before != len(one_an_sm):
        raise AssertionError(f"{what} {kl.FUSED_NAME}: {kl.FUSED_LAUNCHES - before} "
                             f"launches counted for {len(one_an_sm)} rounds")
    # Rows 7 and 8/10 on row 9's plan (one CTA an SM).
    split = kl.pcg_longk_cuda(kops.S, kops.Pinv, kops.gamma, lam0, kops.bad,
                              _rounds=one_an_sm, **kw)
    kdx, kdu = kl.recover_longk_cuda(pops.Qinv, pops.Rinv, blocks.A, blocks.B,
                                     blocks.q, blocks.r, pres.lam)
    pdx, pdu = kl.recover_longk_plain(pops.Qinv, pops.Rinv, blocks.A, blocks.B,
                                      blocks.q, blocks.r, pres.lam)
    torch.cuda.synchronize()
    ties = check_iters(f"{what} {kl.PCG_NAME}", kres, pres, EXIT_TOL)
    e8 = check_close(f"{what} {kl.PCG_NAME} lam", kres.lam[sel], pres.lam[sel])
    # Row 9 is rows 7 and 8/10 in one launch: its plain version is theirs.
    ties += check_iters(f"{what} {kl.FUSED_NAME}", fres, pres, EXIT_TOL)
    e9 = max(check_close(f"{what} {kl.FUSED_NAME} lam", fres.lam[sel], pres.lam[sel]),
             check_close(f"{what} {kl.FUSED_NAME} Qinv", fqi[sel], pops.Qinv[sel]),
             check_close(f"{what} {kl.FUSED_NAME} Rinv", fri[sel], pops.Rinv[sel]))
    e13 = max(check_close(f"{what} {kl.RECOVER_NAME} dz_x", kdx[sel], pdx[sel]),
              check_close(f"{what} {kl.RECOVER_NAME} dz_u", kdu[sel], pdu[sel]))
    if not (torch.equal(fres.lam, split.lam) and torch.equal(fres.iters, split.iters)
            and torch.equal(fqi, kops.Qinv) and torch.equal(fri, kops.Rinv)):
        raise AssertionError(f"{what}: row 9 differs from rows 7 + 8/10 on its plan "
                             "(the same device code on the same inputs)")
    for name, err in ((kl.CONDENSE_NAME, e7), (kl.PCG_NAME, e8),
                      (kl.FUSED_NAME, e9), (kl.RECOVER_NAME, e13)):
        MAX_ERR[name] = max(MAX_ERR[name], err)
    it = kres.iters.cpu().numpy()
    return (f"{len(rounds)} launch(es) of 8/10, {len(one_an_sm)} of 9; "
            f"iters {it.min()}..{it.max()} equal ({ties} ties); max|d| row 7 "
            f"{e7:.2e}, 8/10 {e8:.2e}, 9 {e9:.2e} (bit-equal to 7 + 8/10 on its plan), "
            f"13 {e13:.2e}")


def phase_longk_parity():
    print(f"== phase 3d: the long-K kernels against their plain versions at "
          f"IIWA widths (14, 7), rho={RHO}, exit_tol={EXIT_TOL}")
    full = longk_batch(1024, 16, seed0=4000)
    lam0 = torch.zeros_like(full.q)
    for n in LONGK_B:
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        for prec, poly in (("symmetric_stair", 1), ("block_jacobi", 1),
                           ("jacobi", 1), ("symmetric_stair", 2)):
            # scalar Jacobi over a capped run, as in phase 3
            cap = 10 if prec == "jacobi" else MAX_ITERS
            line = check_longk_kernels(f"K=1024 B={n} {prec} poly={poly}", blocks,
                                       lam0[:n], prec=prec, poly=poly, cap=cap)
            print(f"  K=1024 B={n} {prec} poly={poly} max_iters={cap}: {line}")
    for K in (2048, 8192):
        blocks = longk_batch(K, 1, seed0=4100 + K)
        line = check_longk_kernels(f"K={K} B=1", blocks, torch.zeros_like(blocks.q))
        print(f"  K={K} B=1 symmetric_stair: {line}")
    # The edges of the PCG kernel's split: K just past kernel B (689) and
    # not a multiple of the CTAs a problem (1025: a short last CTA), one knot
    # a CTA, two CTAs an SM (operators partly streamed), two and three
    # Horner terms, and a batch past the SMs, which runs in rounds.  Every
    # multi-CTA case has a first CTA without a left halo and a last one
    # without a right one.
    n_sms = _longk_limits()[0]
    # check_longk_kernels asserts a launch counted a round; the batch past
    # the SMs takes two rounds of each kernel.
    for per_sm in (1, 2):
        past = kl.pcg_rounds(n_sms + 8, 64, IIWA.state_size, *_longk_limits(),
                             per_sm=per_sm)
        if len(past) != 2:
            raise AssertionError(f"{n_sms + 8} problems at K=64 plan {len(past)} rounds "
                                 f"(per_sm={per_sm}), not 2")
    for K, n, kwargs in ((689, 1, {}), (1025, 1, {}), (1025, 3, dict(poly=3)),
                         (1024, 2, dict(poly=2, prec="block_jacobi")),
                         (132, 1, dict(ctas=132)), (1024, 1, dict(ctas=264)),
                         (8192, 1, dict(ctas=264)), (64, n_sms + 8, {})):
        blocks = longk_batch(K, n, seed0=4300 + K)
        line = check_longk_kernels(f"K={K} B={n} {kwargs}", blocks,
                                   torch.zeros_like(blocks.q), **kwargs)
        plan = pcg_plan_text(n, K, kwargs.get("poly", 1), kwargs.get("ctas"))
        print(f"  K={K} B={n} {kwargs}: {plan}; {line}")

    # Warm starts: from the solution (at most one iteration), and from a
    # random lambda_0 against the plain version.
    sol = kl.fused_longk_plain(*full, lam0, rho=RHO, exit_tol=EXIT_TOL,
                               max_iters=MAX_ITERS)[0].lam
    for route in ("fused_xl", "xl"):
        res, _, _ = kl.solve_longk_batched(*full, sol, rho=RHO, exit_tol=EXIT_TOL,
                                           max_iters=MAX_ITERS, force_tier=route)
        if int(res.iters.max()) > 1:
            raise AssertionError(f"long-K {route}: a warm start from the solution "
                                 f"took {int(res.iters.max())} iterations")
    gen = torch.Generator(device="cpu").manual_seed(7)
    warm = (0.1 * torch.randn(full.q.shape, generator=gen)).to(DEV)
    line = check_longk_kernels("K=1024 B=16 warm", full, warm)
    print(f"  K=1024 B=16 warm start (lambda_0 ~ 0.1 N(0, 1)): {line}; from "
          "the solution: at most 1 iteration on both routes")

    # One exactly singular problem (zero row/column in Q[2], rho=0) among
    # healthy ones: gato_tpu's long-K contract (iters = max_iters, not
    # converged, eta >= 1e30 and finite), nothing non-finite, the healthy
    # problems as their plain versions.
    good = [testing.random_blocks(longk_spec(1024), seed=4200 + i) for i in range(2)]
    bad = testing.singular_blocks(longk_spec(1024), seed=3, knot=2)
    mix = gt.blocks_to_torch(testing.stack_blocks([good[0], bad, good[1]]), DEV)
    # check_longk_kernels holds rows 8/10 on both meetings: B = 3 meets on
    # flagged partials, and on grid barriers the frozen problem keeps the
    # round's counter.
    line = check_longk_kernels("singular mix", mix, torch.zeros_like(mix.q),
                               rho=0.0, keep=[0, 2])
    for route in ("fused_xl", "xl"):
        res, dx, du = kl.solve_longk_batched(*mix, rho=0.0, exit_tol=EXIT_TOL,
                                             max_iters=MAX_ITERS, force_tier=route)
        torch.cuda.synchronize()
        eta1 = float(res.eta[1])
        if res.converged.cpu().tolist() != [True, False, True] \
                or int(res.iters[1]) != MAX_ITERS or not 1e30 <= eta1 < float("inf"):
            raise AssertionError(f"long-K {route} singular mix: converged "
                                 f"{res.converged.tolist()}, iters "
                                 f"{res.iters.tolist()}, eta {res.eta.tolist()}")
        for t in (res.lam, dx, du, res.eta):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"long-K {route} singular mix: an output "
                                     "is not finite")
    print(f"  singular mix (1 of 3, K=1024, rho=0): {line}; both routes: "
          f"converged [True, False, True], iters[1] = {MAX_ITERS}, eta[1] = "
          f"{eta1:g}, every output finite")


def dense_kkt_solve64(blocks: gt.KKTBlocks, rho: float):
    """(lam, dz_x, dz_u) of the float64 dense KKT solve on the card, one
    problem at a time (the oracle only)."""
    Bn, K, s, _ = blocks.Q.shape
    c = blocks.R.shape[-1]
    nz = K * (s + c) - c
    out = []
    for i in range(Bn):
        one = gt.KKTBlocks(*(a[i:i + 1].double() for a in blocks))
        M, rhs = dense_kkt(one, rho)
        x = torch.linalg.solve(M, rhs.unsqueeze(-1))[..., 0]
        del M
        dz_x, dz_u = split_dz(x[:, :nz], K, s, c)
        out.append((x[:, nz:].reshape(1, K, s), dz_x, dz_u))
        torch.cuda.empty_cache()
    return tuple(torch.cat([o[j] for o in out]) for j in range(3))


def phase_longk_path():
    print("== phase 4d: the long-K main path through solve, solve_batched, "
          "solve_sequence_batched, pack / solve_packed, pack_sequence / "
          "solve_packed_sequence and linsys_solve")
    opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    total = dict.fromkeys(longk_counts(), 0)
    auto = kl.AUTO_TIER

    def run(what, fn, expect):
        zero_longk_counts()
        out = fn()
        torch.cuda.synchronize()
        got = longk_counts()
        want = {key: expect.get(key, 0) for key in got}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for key, value in got.items():
            total[key] += value
        return out

    def route(n_solves, tier):
        """Launch counts of n_solves calls of one long-K tier."""
        if tier == "fused_xl":
            return {kl.FUSED_NAME: n_solves, kl.RECOVER_NAME: n_solves}
        return {kl.CONDENSE_NAME: n_solves, kl.PCG_NAME: n_solves,
                kl.RECOVER_NAME: n_solves}

    def against_torch(what, got, spec, blocks, lam0=None):
        ref = gt.solve_batched(spec, blocks,
                               dataclasses.replace(opts, warm_start=lam0 is not None),
                               lam0=lam0, pcg_backend="torch")
        ties = check_iters(what, got, ref, EXIT_TOL)
        err = max(check_close(f"{what} {name}", getattr(got, name), getattr(ref, name))
                  for name in ("lam", "dz_x", "dz_u"))
        if not bool(got.converged.all()):
            raise AssertionError(f"{what}: a problem did not converge")
        return ties, err

    for K, n in ((1024, 1), (8192, 1), (2048, 16)):
        spec = longk_spec(K)
        blocks = longk_batch(K, n, seed0=5000 + K)
        if n == 1:
            one = gt.KKTBlocks(*(a[0] for a in blocks))
            res = run(f"solve K={K}", lambda: gt.solve(spec, one, opts),
                      route(1, auto))
            res = gt.SolveResult(*(t[None] for t in res))
        else:
            res = run(f"solve_batched K={K} B={n}",
                      lambda: gt.solve_batched(spec, blocks, opts), route(1, auto))
        ties, err = against_torch(f"K={K} B={n}", res, spec, blocks)
        print(f"  {'solve' if n == 1 else 'solve_batched'} K={K} B={n} (auto: "
              f"'pcg_kernel', tier {auto}): converged, iters "
              f"{int(res.iters.min())}..{int(res.iters.max())} equal to 'torch' "
              f"({ties} ties), max|d| {err:.2e}")
    # 'pcg_kernel' named explicitly takes the same route.
    spec = longk_spec(1024)
    blocks = longk_batch(1024, 2, seed0=5100)
    res = run("solve_batched pcg_kernel K=1024 B=2", lambda: gt.solve_batched(
        spec, blocks, opts, pcg_backend="pcg_kernel"), route(1, auto))
    against_torch("pcg_kernel K=1024 B=2", res, spec, blocks)
    try:
        gt.solve_batched(spec, blocks, opts, pcg_backend="fused")
    except ValueError as e:
        if "'pcg_kernel'" not in str(e):
            raise
        print(f"  explicit 'fused' at K=1024 raises: {e}")
    else:
        raise AssertionError("explicit 'fused' past kernel B's shared memory ran")

    # The MPC farm: B=4 streams x T=8 steps, each step warm-started.
    T, n = 8, 4
    farm_blocks = gt.blocks_to_torch(testing.random_farm(spec, T, n, seed0=5200), DEV)
    rhos = farm_rhos(T).cpu().numpy()
    seq = run(f"solve_sequence_batched K=1024 B={n} T={T}",
              lambda: gt.solve_sequence_batched(spec, farm_blocks, opts, rhos=rhos),
              route(T, auto))
    ref = gt.solve_sequence_batched(spec, farm_blocks, opts, rhos=rhos,
                                    pcg_backend="torch")
    lam_first = torch.zeros_like(farm_blocks.q[0])

    def redo(backend):
        def solve(t, bs, lam_prev, max_iters):
            one = gt.KKTBlocks(*(a[t, bs] for a in farm_blocks))
            step_opts = gt.SolverOptions(rho=float(rhos[t]), exit_tol=EXIT_TOL,
                                         max_iters=max_iters, warm_start=True)
            return gt.solve_batched(spec, one, step_opts, pcg_backend=backend,
                                    lam0=lam_first[bs] if lam_prev is None else lam_prev)
        return solve

    ties, err = check_farm("long-K farm vs torch", seq, ref, redo("pcg_kernel"),
                           redo("torch"))
    if not bool(seq.converged.all()):
        raise AssertionError("long-K farm: a step did not converge")
    it = seq.iters.double()
    if not float(it[1:].mean()) < float(it[0].mean()):
        raise AssertionError("long-K farm: warm starts did not cut iterations")
    print(f"  solve_sequence_batched K=1024 B={n} T={T} (auto: 'pcg_kernel', "
          f"{T} steps of tier {auto}): all converged, iters equal to 'torch' "
          f"({ties} ties), max|d| {err:.2e}; mean iterations step 0 "
          f"{float(it[0].mean()):.2f}, steps 1.. {float(it[1:].mean()):.2f}")
    single = gt.KKTBlocks(*(a[:, 0] for a in farm_blocks))
    one = run(f"solve_sequence K=1024 T={T}",
              lambda: gt.solve_sequence(spec, single, opts, rhos=rhos),
              route(T, auto))
    ties, _ = check_farm("solve_sequence vs stream 0 of the farm",
                         gt.SolveResult(*(x[:, None] for x in one)),
                         gt.SolveResult(*(x[:, :1] for x in seq)),
                         redo("pcg_kernel"), redo("pcg_kernel"))
    print(f"  solve_sequence K=1024 T={T}: agrees with stream 0 of the farm "
          f"({ties} ties); iters {one.iters.tolist()}")

    # The packed surface.
    step0 = gt.KKTBlocks(*(a[0] for a in farm_blocks))
    step1 = gt.KKTBlocks(*(a[1] for a in farm_blocks))

    def serve():
        packed = gt.pack(spec, step0)
        first = gt.solve_packed(packed, opts)
        packed = gt.update_vectors(packed, step1.q, step1.r, step1.c)
        return packed, first, gt.solve_packed(packed, opts, lam0=first.lam_packed)

    packed, first, second = run("pack / solve_packed K=1024", serve, route(2, auto))
    if packed.plan.tier != "longk":
        raise AssertionError(f"pack at K=1024 planned tier {packed.plan.tier!r}")
    against_torch("solve_packed first", first.unpack(), spec, step0)
    against_torch("solve_packed second", second.unpack(), spec, step1,
                  lam0=first.lam_packed)
    half = T // 2
    win1 = gt.KKTBlocks(*(a[:half] for a in farm_blocks))
    win2 = gt.KKTBlocks(*(a[half:] for a in farm_blocks))

    def windows():
        w1 = gt.solve_packed_sequence(gt.pack_sequence(spec, win1), opts)
        return w1, gt.solve_packed_sequence(gt.pack_sequence(spec, win2), opts,
                                            lam0=w1.lam_tail_packed)

    w1, w2 = run("pack_sequence / solve_packed_sequence K=1024", windows,
                 route(T, auto))
    whole = gt.solve_sequence_batched(spec, farm_blocks, opts)
    for name, a, b in (("lam", torch.cat([w1.lam_p, w2.lam_p]), whole.lam),
                       ("iters", torch.cat([w1.iters, w2.iters]), whole.iters)):
        if not torch.equal(a, b):
            raise AssertionError(f"long-K packed windows: {name} differs from one run")
    print(f"  pack (tier 'longk') -> solve_packed -> update_vectors -> "
          f"solve_packed B={n} K=1024 agrees with 'torch'; two pack_sequence "
          f"windows of {half} carried by lam_tail_packed equal one farm run")

    # linsys_solve at K=1024 against the float64 dense KKT solve.
    one = testing.random_blocks(spec, seed=5300)
    csr = testing.blocks_to_csr(spec, one)
    zero_longk_counts()
    (l, dz), _ = run_linsys(csr, [0.0] * spec.nl, 2, 1e-8, 200, False, RHO)
    torch.cuda.synchronize()
    got = longk_counts()
    for key, value in route(2, auto).items():
        if got[key] != value:
            raise AssertionError(f"linsys_solve K=1024: launches {got}")
        total[key] += value
    lam_ref, dzx_ref, dzu_ref = dense_kkt_solve64(
        gt.blocks_to_torch(testing.stack_blocks([one]), DEV), RHO)
    dz_ref = torch.cat([torch.cat([dzx_ref[0, :-1], dzu_ref[0]], dim=1).reshape(-1),
                        dzx_ref[0, -1]]).cpu().numpy()
    worst = 0.0
    for name, got_v, ref_v in (("lam", np.array(l), lam_ref.reshape(-1).cpu().numpy()),
                               ("dz", np.array(dz), dz_ref)):
        scale = max(1.0, float(np.abs(ref_v).max()))
        err = float(np.abs(got_v - ref_v).max()) / scale
        if err > 2e-3:
            raise AssertionError(f"linsys_solve K=1024 {name}: {err:.3e} of scale "
                                 "off the float64 dense KKT solve")
        worst = max(worst, err)
    print(f"  linsys_solve K=1024 (auto, testiters=2, exit_tol=1e-8): lam, dz "
          f"within {worst:.2e} of scale of the float64 dense KKT solve")

    # The route the auto tier does not take, through solve_longk_batched:
    # the split one under both of its names ('xl' at row 8's shape,
    # 'stream' at row 10's), or the fused one.
    forced = ((("xl", 2048, 1), ("stream", 8192, 1)) if auto == "fused_xl"
              else (("fused_xl", 1024, 16),))
    for tier, K, n in forced:
        blocks = longk_batch(K, n, seed0=5400 + K)
        res, dx, du = run(f"force_tier={tier} K={K} B={n}",
                          lambda: kl.solve_longk_batched(
                              *blocks, rho=RHO, exit_tol=EXIT_TOL,
                              max_iters=MAX_ITERS, force_tier=tier),
                          route(1, tier))
        ties, err = against_torch(f"force_tier={tier} K={K} B={n}",
                                  gt.SolveResult(res.lam, dx, du, res.iters,
                                                 res.converged, res.eta),
                                  longk_spec(K), blocks)
        print(f"  longk.solve_longk_batched(force_tier={tier!r}) K={K} B={n} "
              f"(not the auto tier): converged, iters equal to 'torch' "
              f"({ties} ties), max|d| {err:.2e}")
    print(f"  launches on the long-K path: {total}")
    for name, count in total.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the long-K path")
    return total


def precond_flops(K: int, s: int, prec: str) -> float:
    """theta^-1 of every knot (block Jacobi, stair) and the stair's two
    off-diagonal products a knot (2 n^3 per inverse or product)."""
    f = 0.0 if prec == "jacobi" else K * 2 * s ** 3
    if prec == "symmetric_stair":
        f += 4 * (K - 1) * 2 * s ** 3
    return f


def phase_longk_times(card: str):
    print(f"== phase 5d: the long-K kernels' times (CUDA events, median of "
          f"{TIMING_RUNS} runs after warm-up; {SLOW_RUNS} for plain versions and "
          f"library calls) on {card}")
    s, c = IIWA.state_size, IIWA.control_size
    times, routes = {}, {}
    kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    for K in LONGK_K:
        full = longk_batch(K, max(LONGK_B), seed0=6000 + K)
        Kb = full.Q.shape[1]
        for n in LONGK_B:
            blocks = gt.KKTBlocks(*(a[:n] for a in full))
            lam0 = torch.zeros_like(blocks.q)
            ops = kl.condense_longk_cuda(*blocks, rho=RHO)
            res = kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, lam0, ops.bad, **kw)
            fres, fqi, fri = kl.fused_longk_cuda(*blocks, lam0, rho=RHO, **kw)
            dx, du = kl.recover_longk_cuda(ops.Qinv, ops.Rinv, blocks.A, blocks.B,
                                           blocks.q, blocks.r, res.lam)
            torch.cuda.synchronize()
            flags = n                                      # bad (bool)
            outs = nbytes(res.lam, res.iters, res.converged, res.eta)
            cflops = n * (condense_flops(Kb, s, c) + precond_flops(Kb, s, "symmetric_stair"))
            pflops = pcg_flops(Kb, s, res.iters, res.converged, 1)
            bounds = {
                kl.CONDENSE_NAME: bound(nbytes(*blocks, *ops[:5]) + flags, cflops),
                kl.PCG_NAME: bound(nbytes(ops.S, ops.Pinv, ops.gamma, lam0) + flags
                                   + outs, pflops),
                kl.FUSED_NAME: bound(nbytes(*blocks, lam0, fqi, fri) + outs,
                                     cflops + pflops),
                kl.RECOVER_NAME: bound(nbytes(ops.Qinv, ops.Rinv, blocks.A, blocks.B,
                                              blocks.q, blocks.r, res.lam, dx, du),
                                       n * recover_flops(Kb, s, c)),
            }
            rows = (
                (kl.CONDENSE_NAME, lambda: kl.condense_longk_cuda(*blocks, rho=RHO),
                 lambda: kl.condense_longk_plain(*blocks, rho=RHO)),
                (kl.PCG_NAME, lambda: kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma,
                                                        lam0, ops.bad, **kw),
                 lambda: kl.pcg_longk_plain(ops.S, ops.Pinv, ops.gamma, lam0,
                                            ops.bad, **kw)),
                (kl.FUSED_NAME, lambda: kl.fused_longk_cuda(*blocks, lam0, rho=RHO, **kw),
                 lambda: kl.fused_longk_plain(*blocks, lam0, rho=RHO, **kw)),
                (kl.RECOVER_NAME, lambda: kl.recover_longk_cuda(
                    ops.Qinv, ops.Rinv, blocks.A, blocks.B, blocks.q, blocks.r, res.lam),
                 lambda: kl.recover_longk_plain(ops.Qinv, ops.Rinv, blocks.A,
                                                blocks.B, blocks.q, blocks.r, res.lam)),
            )
            # The plain versions' dense intermediates at K=8192 are kept to B=1.
            plain_ok = K < 8192 or n == 1
            lib_ms = None
            if K == 1024:
                # One PyTorch call for rows 8/10 and 9's function: the dense
                # LU solve of the Schur system (K s = 14,336).
                S_dense = dense_btd(ops.S)
                gam = ops.gamma.reshape(n, -1, 1)
                lib = torch.linalg.solve(S_dense, gam)
                print(f"  K={K} B={n}: the dense Schur solve (library) against "
                      f"rows 8/10 max|dlam| "
                      f"{float((lib.reshape(n, Kb, s) - res.lam).abs().max()):.2e}")
                lib_ms = cuda_median_ms(lambda: torch.linalg.solve(S_dense, gam),
                                        runs=SLOW_RUNS, warmup=1)
                del S_dense, lib
                torch.cuda.empty_cache()
            for name, kern, plain in rows:
                p1 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1) if plain_ok else None
                k1 = cuda_median_ms(kern)
                k2 = cuda_median_ms(kern)
                p2 = cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1) if plain_ok else None
                has_lib = name in (kl.PCG_NAME, kl.FUSED_NAME)
                bound_ms, bound_by = bounds[name]
                # The device's time alone (CUDA events also hold the host's
                # enqueue while the card waits for it).
                dev_ms = graph_ms_per_call(kern, calls=20 if k1 < 1.0 else 4)
                times[(name, K, n)] = dict(
                    ms=(k1 + k2) / 2, plain_ms=None if p1 is None else (p1 + p2) / 2,
                    library_ms=lib_ms if has_lib else None, bound_ms=bound_ms,
                    bound_by=bound_by, device_ms=dev_ms)
                plain_text = (f"plain {p1:.4f} / {p2:.4f} ms" if plain_ok
                              else "plain not timed (B=16 at K=8192)")
                lib_text = (f"library {lib_ms:.4f} ms" if has_lib and lib_ms is not None
                            else "no library call")
                print(f"  {name} K={K} B={n}: kernel {k1:.4f} / {k2:.4f} ms (device "
                      f"{dev_ms:.4f} ms, a CUDA graph), {plain_text}, {lib_text}, bound "
                      f"{bound_ms:.5f} ms ({bound_by}); launches 1  [{card}]")
            # The two routes end to end (one call of solve_longk_batched each).
            fused_ms, split_ms = [], []
            for _ in range(2):
                fused_ms.append(cuda_median_ms(lambda: kl.solve_longk_batched(
                    *blocks, lam0, rho=RHO, force_tier="fused_xl", **kw)))
                split_ms.append(cuda_median_ms(lambda: kl.solve_longk_batched(
                    *blocks, lam0, rho=RHO, force_tier="xl", **kw)))
            routes[(K, n)] = (float(np.mean(fused_ms)), float(np.mean(split_ms)))
            xl_dev = graph_ms_per_call(lambda: kl.solve_longk_batched(
                *blocks, lam0, rho=RHO, force_tier="xl", **kw),
                calls=20 if split_ms[0] < 1.0 else 4)
            it = res.iters
            print(f"  plan K={K} B={n}: rows 8/10 {pcg_plan_text(n, K)}; row 7 tiles of "
                  f"{kl.tile_knots(n, K, s, c, *_longk_limits())} knots")
            print(f"  route K={K} B={n}: 'fused_xl' (rows 9 + 13) "
                  f"{fused_ms[0]:.4f} / {fused_ms[1]:.4f} ms, 'xl' = 'stream' "
                  f"(rows 7 + 8/10 + 13) {split_ms[0]:.4f} / {split_ms[1]:.4f} ms "
                  f"(device {xl_dev:.4f} ms); PCG iterations "
                  f"{int(it.min())}..{int(it.max())}  [{card}]")
            del ops, res, fres, fqi, fri, dx, du
        del full
        torch.cuda.empty_cache()
    # A PCG iteration's cost: 20 iterations against none (exit_tol = 0, so
    # no problem leaves the loop early), B=1.
    for K in LONGK_K:
        blocks = longk_batch(K, 1, seed0=6000 + K)
        ops = kl.condense_longk_cuda(*blocks, rho=RHO)
        lam0 = torch.zeros_like(blocks.q)
        runs = {}
        for iters in (0, 20):
            runs[iters] = cuda_median_ms(lambda: kl.pcg_longk_cuda(
                ops.S, ops.Pinv, ops.gamma, lam0, ops.bad, exit_tol=0.0,
                max_iters=iters))
        per_it = (runs[20] - runs[0]) / 20
        times[("iteration", K)] = per_it
        print(f"  {kl.PCG_NAME} K={K} B=1: max_iters=0 {runs[0]:.4f} ms, 20 "
              f"{runs[20]:.4f} ms: {1e3 * per_it:.2f} us an iteration ("
              f"{pcg_plan_text(1, K)}: two dot products, S p and M r on own "
              f"knots, the halo knots' r and p formed locally)  [{card}]")
        del ops
    # The plan's choices measured against the others (device time, CUDA
    # graphs): how the CTAs meet (flagged partials, the hand-rolled one,
    # against cg::grid_group::sync), the CTAs a problem at K = 1024 (more
    # CTAs, fewer knots each, more arrivals at each barrier), and row 7's
    # tile (more tiles against the recomputed share, 3 of nk + 3 knots).
    def per_iteration_us(ops, lam0, rounds=None):
        g = {iters: graph_ms_per_call(lambda: kl.pcg_longk_cuda(
            ops.S, ops.Pinv, ops.gamma, lam0, ops.bad, exit_tol=0.0, max_iters=iters,
            _rounds=rounds), calls=10) for iters in (0, 20)}
        return 1e3 * (g[20] - g[0]) / 20

    limits = _longk_limits()
    for K, n in ((1024, 1), (8192, 1), (1024, 16)):
        blocks = longk_batch(K, n, seed0=6000 + K)
        ops = kl.condense_longk_cuda(*blocks, rho=RHO)
        lam0 = torch.zeros_like(blocks.q)
        plan = kl.pcg_rounds(n, K, s, *limits)
        if n == 1:
            meets = {b: per_iteration_us(ops, lam0, tuple(rd._replace(meet=b) for rd in plan))
                     for b in kl.BARRIERS}
            print(f"  {kl.PCG_NAME} K={K} B=1, an iteration by meeting (device): flagged "
                  f"partials {meets['flags']:.2f} us, grid barriers {meets['grid']:.2f} us; "
                  f"the plan takes {plan[0].meet}  [{card}]")
        else:
            print(f"  {kl.PCG_NAME} K={K} B={n}, an iteration (device) on flagged partials "
                  f"(grid barriers only for one problem): {per_iteration_us(ops, lam0):.2f} "
                  f"us  [{card}]")
        if (K, n) == (1024, 1):
            sweep = {ctas: per_iteration_us(ops, lam0, kl.pcg_rounds(1, K, s, *limits, ctas))
                     for ctas in (56, 64, 96, 128, 132, 264)}
            print(f"  {kl.PCG_NAME} K={K} B=1, an iteration by CTAs a problem (device; "
                  f"the plan {plan[0].per}, grid barriers): "
                  + ", ".join(f"{c} {us:.2f} us" for c, us in sweep.items())
                  + f"  [{card}]")
        if n == 1:
            tiles = {t: graph_ms_per_call(lambda: kl.condense_longk_cuda(
                *blocks, rho=RHO, _tile=t), calls=10) for t in (2, 3, 4, 6)}
            print(f"  {kl.CONDENSE_NAME} K={K} B=1 by tile knots (device; the plan "
                  f"{kl.tile_knots(1, K, s, c, *limits)}): "
                  + ", ".join(f"{t} {ms:.4f} ms" for t, ms in tiles.items())
                  + f"  [{card}]")
        del ops
    # Two CTAs an SM where the operators stream (the plan's rule at B = 16)
    # against one, and a forced two where it would push the vectors out of
    # shared memory (K = 4096).
    for K in (1024, 4096, 8192):
        blocks = longk_batch(K, 16, seed0=6000 + K)
        ops = kl.condense_longk_cuda(*blocks, rho=RHO)
        lam0 = torch.zeros_like(blocks.q)
        one = kl.pcg_rounds(16, K, s, *limits, per_sm=1)
        plan = kl.pcg_rounds(16, K, s, *limits)[0].per
        t = {name: graph_ms_per_call(lambda: kl.pcg_longk_cuda(
            ops.S, ops.Pinv, ops.gamma, lam0, ops.bad, _rounds=rounds, **kw), calls=4)
             for name, rounds in (("one", one), ("plan", None),
                                  ("two", kl.pcg_rounds(16, K, s, *limits,
                                                        2 * one[0].per)))}
        print(f"  {kl.PCG_NAME} K={K} B=16 by CTAs an SM (device): one ({one[0].per} a "
              f"problem) {t['one']:.4f} ms, two ({2 * one[0].per}) {t['two']:.4f} ms; the "
              f"plan takes {plan}  [{card}]")
        del ops, blocks
    print("  the faster route per shape:")
    for (K, n), (f_ms, x_ms) in routes.items():
        print(f"    K={K:5d} B={n:2d}: {'fused_xl' if f_ms <= x_ms else 'xl'} "
              f"({f_ms:.4f} against {x_ms:.4f} ms); the auto tier takes "
              f"{kl.AUTO_TIER}")
    return times, routes


# --------------------------------------------------------------------------
# The long-K exact tier: rows 11 and 12 and the unpeel kernel, with rows 7
# and 13.

DIRECT_K = (2, 50, 71, 72, 741, 1025, 1536, 8192)
DIRECT_B = (1, 15)


def direct_longk_counts() -> dict:
    return {kl.CONDENSE_NAME: kl.CONDENSE_LAUNCHES, kl.CR_NAME: kl.CR_LAUNCHES,
            kl.PEEL_NAME: kl.PEEL_LAUNCHES, kl.UNPEEL_NAME: kl.UNPEEL_LAUNCHES,
            kl.RECOVER_NAME: kl.RECOVER_LAUNCHES, kl.PCG_NAME: kl.PCG_LAUNCHES,
            kl.FUSED_NAME: kl.FUSED_LAUNCHES}


def zero_direct_longk_counts() -> None:
    zero_longk_counts()
    kl.CR_LAUNCHES = kl.PEEL_LAUNCHES = kl.UNPEEL_LAUNCHES = 0


def check_cr_kernels(what: str, S, gamma, keep=None) -> str:
    """Rows 11 and 12 and the unpeel kernel against their plain versions on
    one condensed system: row 11 and the peel on S, gamma; the unpeel on the
    plain peel's level and the plain solution of its reduced system, which
    must give back the whole system's solution.  Flags are compared for
    every problem, values for ``keep``."""
    sel = slice(None) if keep is None else keep
    x, bad = kl.cr_longk_cuda(S, gamma)
    Sh, bh, level = kl.peel_longk_cuda(S, gamma)
    torch.cuda.synchronize()
    xp, badp = kl.cr_longk_plain(S, gamma)
    Shp, bhp, levelp = kl.peel_longk_plain(S, gamma)
    xh = kl.cr_longk_plain(Shp, bhp)[0]
    xu = kl.unpeel_longk_cuda(xh, levelp)
    torch.cuda.synchronize()
    xup = kl.unpeel_longk_plain(xh, levelp)
    for name, k, p in (("flags", bad, badp), ("peel flags", level.bad, levelp.bad)):
        if not torch.equal(k.cpu(), p.cpu()):
            raise AssertionError(f"{what}: {name} {k.tolist()} vs plain {p.tolist()}")
    e11 = check_close(f"{what} {kl.CR_NAME} lam", x[sel], xp[sel])
    e12 = max(check_close(f"{what} {kl.PEEL_NAME} {name}", k[sel], p[sel])
              for name, k, p in (("S'", Sh, Shp), ("b'", bh, bhp),
                                 ("Doinv", level.Doinv, levelp.Doinv)))
    eu = check_close(f"{what} {kl.UNPEEL_NAME} x", xu[sel], xup[sel])
    check_close(f"{what} a peel, the rest, its unpeel (plain)", xup[sel], xp[sel])
    for name, err in ((kl.CR_NAME, e11), (kl.PEEL_NAME, e12), (kl.UNPEEL_NAME, eu)):
        MAX_ERR[name] = max(MAX_ERR[name], err)
    return (f"max|d| row 11 {e11:.2e}, row 12 {e12:.2e}, unpeel {eu:.2e}; flags "
            f"{int(bad.sum())} / peel {int(level.bad.sum())} equal to plain")


def check_exact_tiers(what: str, blocks, rho=RHO, keep=None) -> str:
    """'xl' and 'hybrid' against 'xla' (the plain cyclic reduction between
    the same row 7 and row 13 launches): converged equal, iters 0, eta
    within ETA_REL (1 + ||gamma||^2), lambda and dz within TOL."""
    sel = slice(None) if keep is None else keep
    ref, rdx, rdu = kl.solve_direct_longk_batched(*blocks, rho=rho, force_tier="xla")
    gamma = kl.condense_longk_cuda(*blocks, rho=rho, preconditioner="jacobi").gamma
    errs = []
    for tier in ("xl", "hybrid"):
        res, dx, du = kl.solve_direct_longk_batched(*blocks, rho=rho, force_tier=tier)
        torch.cuda.synchronize()
        check_direct(f"{what} {tier}", gt.SolveResult(*(t[sel] for t in (
            res.lam, dx, du, res.iters, res.converged, res.eta))),
            gt.SolveResult(*(t[sel] for t in (ref.lam, rdx, rdu, ref.iters,
                                              ref.converged, ref.eta))), gamma[sel])
        if res.converged.tolist() != ref.converged.tolist():
            raise AssertionError(f"{what} {tier}: converged {res.converged.tolist()}")
        errs.append(max(check_close(f"{what} {tier} {name}", k[sel], p[sel])
                        for name, k, p in (("lam", res.lam, ref.lam), ("dz_x", dx, rdx),
                                           ("dz_u", du, rdu))))
    return f"'xl' max|d| {errs[0]:.2e}, 'hybrid' {errs[1]:.2e} against 'xla'"


def phase_direct_longk_parity():
    print(f"== phase 3e: rows 11 and 12 and the unpeel kernel against their plain "
          f"versions at IIWA widths (14, 7), rho={RHO}; rows 7 and 13 at K=50")
    for n in DIRECT_B:
        blocks = longk_batch(50, n, seed0=7000)
        for prec in ("jacobi", "symmetric_stair"):
            # scalar Jacobi over a capped run, as in phase 3
            cap = 10 if prec == "jacobi" else MAX_ITERS
            line = check_longk_kernels(f"K=50 B={n} {prec}", blocks,
                                       torch.zeros_like(blocks.q), prec=prec, cap=cap)
            print(f"  rows 7-13 at K=50 B={n} {prec} max_iters={cap}: {line}")
    for K in DIRECT_K:
        full = longk_batch(K, max(DIRECT_B), seed0=7100 + K)
        for n in DIRECT_B:
            blocks = gt.KKTBlocks(*(a[:n] for a in full))
            ops = kl.condense_longk_cuda(*blocks, rho=RHO, preconditioner="jacobi")
            line = check_cr_kernels(f"K={K} B={n}", ops.S, ops.gamma)
            if K < 8192 or n == 1:
                line += "; " + check_exact_tiers(f"K={K} B={n}", blocks)
            print(f"  K={K} B={n}: {line}")
        del full
        torch.cuda.empty_cache()

    # Row 11 at the wide widths (s = 20, 32: the tail takes 13 rows at s =
    # 32, so these run grid levels too) and at a batch of 16.
    for sizes, n in (((20, 9, 300), 16), ((32, 32, 14), 15), ((32, 32, 200), 16),
                     ((14, 7, 1024), 16)):
        blocks = gt.blocks_to_torch(testing.random_batch(gt.ProblemSpec(*sizes), n,
                                                         seed0=7300), DEV)
        ops = kl.condense_longk_cuda(*blocks, rho=RHO, preconditioner="jacobi")
        print(f"  {sizes} B={n}: {check_cr_kernels(f'{sizes} B={n}', ops.S, ops.gamma)}")

    # Singular input.  A zero row and column in Q[2] (rho = 0): row 7 flags
    # it, both tiers report it converged False with eta >= 1e30 and finite
    # outputs, the others as their plain versions.  A zero pivot in an odd
    # row's block of the condensed system: rows 11 and 12 flag that problem
    # alone, as their plain versions do.
    good = [testing.random_blocks(longk_spec(1024), seed=7200 + i) for i in range(2)]
    bad = testing.singular_blocks(longk_spec(1024), seed=3, knot=2)
    mix = gt.blocks_to_torch(testing.stack_blocks([good[0], bad, good[1]]), DEV)
    line = check_exact_tiers("singular mix", mix, rho=0.0, keep=[0, 2])
    for tier in ("xl", "hybrid"):
        res, dx, du = kl.solve_direct_longk_batched(*mix, rho=0.0, force_tier=tier)
        torch.cuda.synchronize()
        if res.converged.cpu().tolist() != [True, False, True] \
                or not float(res.eta[1]) >= 1e30:
            raise AssertionError(f"long-K direct {tier} singular mix: converged "
                                 f"{res.converged.tolist()}, eta {res.eta.tolist()}")
        for t in (res.lam, dx, du):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"long-K direct {tier} singular mix: an output "
                                     "is not finite")
    ops = kl.condense_longk_cuda(*mix, rho=RHO, preconditioner="jacobi")
    S = ops.S.clone()
    S[1, 5, 1, 0, :] = 0.0
    S[1, 5, 1, :, 0] = 0.0
    cr_line = check_cr_kernels("zero pivot in an odd row", S, ops.gamma, keep=[0, 2])
    _, flags = kl.cr_longk_cuda(S, ops.gamma)
    if flags.cpu().tolist() != [False, True, False]:
        raise AssertionError(f"{kl.CR_NAME}: flags {flags.tolist()} for a zero pivot "
                             "in problem 1")
    print(f"  singular mix (1 of 3, K=1024, rho=0): {line}; converged [True, False, "
          f"True], eta[1] = {float(res.eta[1]):g}, every output finite; a zero "
          f"pivot in problem 1's odd row 5: {cr_line}")


def phase_direct_longk_path():
    print("== phase 4e: the exact long-K main path (method='direct') through solve, "
          "solve_batched, 'pcg_kernel', solve_sequence_batched and pack / "
          "solve_packed")
    opts = gt.SolverOptions(rho=RHO, method="direct")
    total = dict.fromkeys(direct_longk_counts(), 0)

    def run(what, fn, expect):
        zero_direct_longk_counts()
        out = fn()
        torch.cuda.synchronize()
        got = direct_longk_counts()
        want = {key: expect.get(key, 0) for key in got}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for key, value in got.items():
            total[key] += value
        return out

    def route(n_calls, n, K):
        """Launch counts of n_calls calls of the auto exact tier on n
        problems of horizon K."""
        out = {kl.CONDENSE_NAME: n_calls, kl.CR_NAME: n_calls,
               kl.RECOVER_NAME: n_calls}
        if kl.direct_tier(n, K) == "hybrid":
            out[kl.PEEL_NAME] = out[kl.UNPEEL_NAME] = n_calls * kl.hybrid_peels(K)
        return out

    def exact(what, res, blocks, rho=RHO):
        """Converged with iters 0; within 2e-3 of scale of the float64 dense
        KKT solve where K <= 1024, else against the 'xla' tier."""
        if not bool(res.converged.all()) or int(res.iters.abs().max()) != 0:
            raise AssertionError(f"{what}: not all converged with iters 0")
        if blocks.Q.shape[1] <= 1024:
            ref = dense_kkt_solve64(blocks, rho)
            worst = 0.0
            for name, got, r in zip(("lam", "dz_x", "dz_u"), (res.lam, res.dz_x,
                                                              res.dz_u), ref):
                err = float((got.double() - r).abs().max()) / max(1.0, float(r.abs().max()))
                if err > 2e-3:
                    raise AssertionError(f"{what} {name}: {err:.3e} of scale off the "
                                         "float64 dense KKT solve")
                worst = max(worst, err)
            return f"within {worst:.2e} of scale of the float64 dense KKT solve"
        ref, rdx, rdu = kl.solve_direct_longk_batched(*blocks, rho=rho, force_tier="xla")
        err = max(check_close(f"{what} {name}", k, p) for name, k, p in (
            ("lam", res.lam, ref.lam), ("dz_x", res.dz_x, rdx), ("dz_u", res.dz_u, rdu)))
        return f"max|d| {err:.2e} against the 'xla' tier (plain cyclic reduction)"

    for K, n in ((1024, 1), (8192, 1), (2048, 8)):
        spec = longk_spec(K)
        blocks = longk_batch(K, n, seed0=8000 + K)
        if n == 1:
            one = gt.KKTBlocks(*(a[0] for a in blocks))
            res = run(f"solve K={K}", lambda: gt.solve(spec, one, opts),
                      route(1, n, spec.knot_points))
            res = gt.SolveResult(*(t[None] for t in res))
        else:
            res = run(f"solve_batched K={K} B={n}",
                      lambda: gt.solve_batched(spec, blocks, opts),
                      route(1, n, spec.knot_points))
        print(f"  {'solve' if n == 1 else 'solve_batched'} K={K} B={n} (auto: "
              f"'pcg_kernel', tier {kl.direct_tier(n, spec.knot_points)}): converged, "
              "iters 0, "
              f"{exact(f'K={K} B={n}', res, blocks)}")

    # 'pcg_kernel' named explicitly at K = 50, against row 4.
    spec50 = longk_spec(50)
    blocks = longk_batch(50, 2, seed0=8100)
    res = run("solve_batched pcg_kernel K=50", lambda: gt.solve_batched(
        spec50, blocks, opts, pcg_backend="pcg_kernel"), route(1, 2, spec50.knot_points))
    r4, r4x, r4u = kd.direct_fused_cuda(*blocks, rho=RHO)
    err = max(check_close(f"pcg_kernel direct K=50 {name} vs row 4", k, p)
              for name, k, p in (("lam", res.lam, r4.lam), ("dz_x", res.dz_x, r4x),
                                 ("dz_u", res.dz_u, r4u)))
    print(f"  solve_batched pcg_kernel K=50 B=2 (the long-K tier): converged, "
          f"{exact('pcg_kernel K=50', res, blocks)}; max|d| {err:.2e} against row 4")
    try:
        gt.solve_batched(longk_spec(1024), longk_batch(1024, 2, seed0=8150), opts,
                         pcg_backend="fused")
    except ValueError as e:
        if "'pcg_kernel'" not in str(e):
            raise
        print(f"  explicit 'fused' at K=1024 B=2 raises: {e}")
    else:
        raise AssertionError("explicit 'fused' past row 4 below B=16 ran")

    # The exact farm: B=2 streams x T=4 steps, 8 solves in one call.
    spec = longk_spec(1024)
    T, n = 4, 2
    farm_blocks = gt.blocks_to_torch(testing.random_farm(spec, T, n, seed0=8200), DEV)
    rhos = farm_rhos(T).cpu().numpy()
    seq = run(f"solve_sequence_batched K=1024 B={n} T={T}",
              lambda: gt.solve_sequence_batched(spec, farm_blocks, opts, rhos=rhos),
              route(1, T * n, spec.knot_points))
    worst = []
    for t in range(T):
        worst.append(exact(f"exact farm step {t}", gt.SolveResult(*(x[t] for x in seq)),
                           gt.KKTBlocks(*(a[t] for a in farm_blocks)),
                           rho=float(rhos[t])))
    print(f"  solve_sequence_batched K=1024 B={n} T={T} (method='direct', rho "
          f"alternating): {T * n} solves in one call, all converged; step by step "
          f"{'; '.join(worst)}")

    # The packed surface: a 'direct' pack, and a 'longk' PCG pack solved
    # exactly.
    step0 = gt.KKTBlocks(*(a[0] for a in farm_blocks))
    step1 = gt.KKTBlocks(*(a[1] for a in farm_blocks))

    def serve():
        packed = gt.pack(spec, step0, method="direct")
        first = gt.solve_packed(packed, opts)
        packed = gt.update_vectors(packed, step1.q, step1.r, step1.c)
        return packed, first, gt.solve_packed(packed, opts)

    packed, first, second = run("pack / solve_packed K=1024", serve,
                                route(2, n, spec.knot_points))
    if packed.plan.tier != "longk":
        raise AssertionError(f"pack(method='direct') at K=1024 planned {packed.plan.tier}")
    line = exact("solve_packed first", first.unpack(), step0)
    ref = gt.solve_batched(spec, step1, opts)
    for name in ("lam", "dz_x", "dz_u", "eta", "converged"):
        if not torch.equal(getattr(second.unpack(), name), getattr(ref, name)):
            raise AssertionError(f"solve_packed second: {name} differs from solve_batched")
    pcg_pack = run("PCG pack solved directly K=1024", lambda: gt.pack(spec, step0), {})
    res = run("solve_packed(method='direct') on a 'longk' PCG pack",
              lambda: gt.solve_packed(pcg_pack, opts), route(1, n, spec.knot_points))
    if pcg_pack.plan.tier != "longk" or not torch.equal(res.lam_p, first.lam_p):
        raise AssertionError("a 'longk' PCG pack solved directly differs from the "
                             "'direct' pack")
    print(f"  pack(method='direct') (tier 'longk') -> solve_packed -> update_vectors "
          f"-> solve_packed B={n} K=1024: {line}, the second equal to solve_batched; "
          "a 'longk' PCG pack solved with method='direct' equals it")

    print(f"  launches on the exact long-K path: {total}")
    for name in (kl.CONDENSE_NAME, kl.CR_NAME, kl.PEEL_NAME, kl.UNPEEL_NAME,
                 kl.RECOVER_NAME):
        if total[name] < 1:
            raise AssertionError(f"{name} was not launched on the exact long-K path")
    return total


def thomas_solve_flops(K: int, s: int) -> float:
    """Block Thomas on S lambda = gamma, the fewest operations of an exact
    solve of the condensed system: per knot a pivot inverse, from the second
    knot L C^-1, (L C^-1) U and (L C^-1) y; back, C^-1 (y - U x)."""
    return (K * 2 * s ** 3 + (K - 1) * (4 * s ** 3 + 2 * s * s)
            + K * 2 * s * s + (K - 1) * 2 * s * s)


def peel_flops(W: int, s: int) -> float:
    """One compacting level: W//2 inverses, then per even row A, B and the
    four products of L', U', D' and two matrix-vector products."""
    return (W // 2) * 2 * s ** 3 + ((W + 1) // 2) * (12 * s ** 3 + 4 * s * s)


def phase_direct_longk_times(card: str):
    print(f"== phase 5e: the long-K exact kernels' times (CUDA events, median of "
          f"{TIMING_RUNS} runs after warm-up; {SLOW_RUNS} for plain versions, library "
          f"calls and the Thomas pair; plain versions once at K=8192 B=15) on {card}")
    s, c = IIWA.state_size, IIWA.control_size
    times, routes = {}, {}
    for K in LONGK_K:
        full = longk_batch(K, max(DIRECT_B), seed0=9000 + K)
        for n in DIRECT_B:
            blocks = gt.KKTBlocks(*(a[:n] for a in full))
            ops = kl.condense_longk_cuda(*blocks, rho=RHO, preconditioner="jacobi")
            S, g = ops.S, ops.gamma
            x, _ = kl.cr_longk_cuda(S, g)
            Sh, bh, level = kl.peel_longk_cuda(S, g)
            xh = kl.cr_longk_cuda(Sh, bh)[0]
            torch.cuda.synchronize()
            odd = (level.S[:, 1::2, 0], level.S[:, 1::2, 2], level.b[:, 1::2])
            bounds = {
                kl.CR_NAME: bound(nbytes(S, g, x), n * thomas_solve_flops(K, s)),
                kl.PEEL_NAME: bound(nbytes(S, g, Sh, bh, level.Doinv)
                                    + 4 * level.bad.numel(), n * peel_flops(K, s)),
                kl.UNPEEL_NAME: bound(nbytes(xh, level.Doinv, x, *odd),
                                      n * (K // 2) * 6 * s * s),
            }
            once = K == 8192 and n == max(DIRECT_B)
            rows = (
                (kl.CR_NAME, lambda: kl.cr_longk_cuda(S, g),
                 lambda: kl.cr_longk_plain(S, g)),
                (kl.PEEL_NAME, lambda: kl.peel_longk_cuda(S, g),
                 lambda: kl.peel_longk_plain(S, g)),
                (kl.UNPEEL_NAME, lambda: kl.unpeel_longk_cuda(xh, level),
                 lambda: kl.unpeel_longk_plain(xh, level)),
            )
            lib_ms = None
            if K == 1024:
                # One PyTorch call for row 11's function: the dense LU solve
                # of the Schur system (K s = 14,336).
                S_dense = dense_btd(S)
                gam = g.reshape(n, -1, 1)
                lib = torch.linalg.solve(S_dense, gam)
                print(f"  K={K} B={n}: the dense Schur solve (library) against row 11 "
                      f"max|dlam| {float((lib.reshape(n, K, s) - x).abs().max()):.2e}")
                lib_ms = cuda_median_ms(lambda: torch.linalg.solve(S_dense, gam),
                                        runs=SLOW_RUNS, warmup=1)
                del S_dense, lib
                torch.cuda.empty_cache()
            for name, kern, plain in rows:
                p1 = cuda_median_ms(plain, runs=1 if once else SLOW_RUNS,
                                    warmup=0 if once else 1)
                k1 = cuda_median_ms(kern)
                k2 = cuda_median_ms(kern)
                p2 = p1 if once else cuda_median_ms(plain, runs=SLOW_RUNS, warmup=1)
                has_lib = name == kl.CR_NAME
                bound_ms, bound_by = bounds[name]
                times[(name, K, n)] = dict(
                    ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                    library_ms=lib_ms if has_lib else None, bound_ms=bound_ms,
                    bound_by=bound_by)
                # One call's device time, from a CUDA graph of 20 calls.
                dev_ms = graph_ms_per_call(kern, calls=20)
                times[(name, K, n)]["device_ms"] = dev_ms
                plan = (f"tail stride {kl.cr_tail_stride(K, s, _longk_limits()[1])}"
                        if name == kl.CR_NAME else
                        "two launches" if name == kl.PEEL_NAME else "a warp an even row")
                print(f"  {name} K={K} B={n}: device {dev_ms:.4f} ms ({plan}, bound "
                      f"{100 * bound_ms / dev_ms:.2f} % of it)  [{card}]")
                lib_text = (f"library {lib_ms:.4f} ms" if has_lib and lib_ms is not None
                            else "no library call")
                plain_text = (f"plain {p1:.4f} ms (once)" if once
                              else f"plain {p1:.4f} / {p2:.4f} ms")
                print(f"  {name} K={K} B={n}: kernel {k1:.4f} / {k2:.4f} ms, "
                      f"{plain_text}, {lib_text}, bound {bound_ms:.5f} ms ({bound_by})"
                      f"  [{card}]")
            # The two routes end to end (one call of solve_direct_longk_batched
            # each), beside the exact function's bound (condensation, the
            # block-Thomas solve, recovery: row 4's bound) and, at B=15, the
            # Thomas pair called directly on the same inputs.
            xl_ms, hy_ms = [], []
            for _ in range(2):
                xl_ms.append(cuda_median_ms(lambda: kl.solve_direct_longk_batched(
                    *blocks, rho=RHO, force_tier="xl")))
                hy_ms.append(cuda_median_ms(lambda: kl.solve_direct_longk_batched(
                    *blocks, rho=RHO, force_tier="hybrid")))
            res, dx, du = kl.solve_direct_longk_batched(*blocks, rho=RHO)
            out = nbytes(res.lam, dx, du, res.eta) + 4 * n
            fn_bound = bound(nbytes(*blocks) + out,
                             n * (thomas_fwd_flops(K, s, c) + thomas_rev_flops(K, s, c)))
            thomas = None
            if n == max(DIRECT_B):
                thomas = cuda_median_ms(lambda: kt.solve_direct_thomas_cuda(*blocks,
                                                                             rho=RHO),
                                        runs=SLOW_RUNS, warmup=1)
            routes[(K, n)] = dict(xl=float(np.mean(xl_ms)), hybrid=float(np.mean(hy_ms)),
                                  thomas=thomas, bound_ms=fn_bound[0],
                                  bound_by=fn_bound[1])
            thomas_text = ("" if thomas is None
                           else f", the Thomas pair (rows 5 + 6) {thomas:.4f} ms")
            print(f"  route K={K} B={n}: 'xl' (rows 7 + 11 + 13) {xl_ms[0]:.4f} / "
                  f"{xl_ms[1]:.4f} ms, 'hybrid' ({kl.hybrid_peels(K)} peels) "
                  f"{hy_ms[0]:.4f} / {hy_ms[1]:.4f} ms{thomas_text}; bound "
                  f"{fn_bound[0]:.5f} ms ({fn_bound[1]})  [{card}]")
            del ops, S, g, x, Sh, bh, level, xh, res, dx, du
        del full
        torch.cuda.empty_cache()

    # Row 14's shape: IIWA K = 16384, where gato_tpu runs pcg_streamed and
    # the port its long-K PCG route.
    K = 16384
    blocks = longk_batch(K, 1, seed0=9500)
    kw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    ops = kl.condense_longk_cuda(*blocks, rho=RHO)
    lam0 = torch.zeros_like(blocks.q)
    res = kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, lam0, ops.bad, **kw)
    torch.cuda.synchronize()
    pcg_ms = cuda_median_ms(lambda: kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma,
                                                      lam0, ops.bad, **kw))
    pcg_bound = bound(nbytes(ops.S, ops.Pinv, ops.gamma, lam0, res.lam) + 16,
                      pcg_flops(K, s, res.iters, res.converged, 1))
    plain_ms = cuda_median_ms(lambda: kl.pcg_longk_plain(ops.S, ops.Pinv, ops.gamma,
                                                         lam0, ops.bad, **kw),
                              runs=SLOW_RUNS, warmup=1)
    route_ms = cuda_median_ms(lambda: kl.solve_longk_batched(*blocks, rho=RHO, **kw))
    routes["row14"] = dict(ms=pcg_ms, plain_ms=plain_ms, route_ms=route_ms,
                           bound_ms=pcg_bound[0], bound_by=pcg_bound[1],
                           iters=int(res.iters[0]))
    print(f"  row 14's shape K={K} B=1: {kl.PCG_NAME} {pcg_ms:.4f} ms ({int(res.iters[0])} "
          f"iterations), plain {plain_ms:.4f} ms, no library call (the dense Schur "
          f"matrix is 210 GB), bound {pcg_bound[0]:.5f} ms ({pcg_bound[1]}); the "
          f"route (rows 7 + 8/10 + 13) {route_ms:.4f} ms  [{card}]")
    line = STAMPS.result()
    for key, r in line["row11"].items():
        print(f"  row 11 {key} by stage (tools/direct_stamps.py, the stamped build's "
              f"%globaltimer, median of {line['runs']} launches, us; {r['total']:.1f} in "
              "all): " + ", ".join(f"{lab} {v:.2f}" for lab, v in zip(r["labels"],
                                                                    r["phases"]))
              + f"  [{card}]")
    for key, r in line["row12"].items():
        print(f"  row 12 {key} by launch (the stamped build, first CTA's start to last "
              f"CTA's end, us): inverses {r['first']:.1f}, gap {r['gap']:.1f}, reductions "
              f"{r['second']:.1f}; unpeel {r['unpeel']:.1f}  [{card}]")
    print("  the faster exact route per shape:")
    for (K, n), r in ((key, r) for key, r in routes.items() if key != "row14"):
        best = min(("xl", "hybrid"), key=lambda t: r[t])
        thomas_text = "" if r["thomas"] is None else f", Thomas pair {r['thomas']:.4f}"
        print(f"    K={K:5d} B={n:2d}: {best} ('xl' {r['xl']:.4f}, 'hybrid' "
              f"{r['hybrid']:.4f} ms{thomas_text}); the auto tier takes "
              f"{kl.direct_tier(n, K)}")
    return times, routes


# --------------------------------------------------------------------------
# The knot-sharded path (row 15 on every shard, rows 7 and 13 around it)
# and the data-parallel entry points, on meshes that repeat the one card.

SHARD_N = (1, 2, 4)
SHARD_K = (1024, 8192)
PRECS = ("symmetric_stair", "block_jacobi", "jacobi")
# Row 15 against its plain version: one matvec of 3 s terms a row in
# another order, float32 round-off of ~s 6e-8 of scale, so 1e-5 of scale.
HALO_TOL = 1e-5
# The single-device solve may exit up to 2 iterations apart from a sharded
# one (another operator round-off and sum order; tests/test_sharded.py:41).
SHARD_ITERS = 2


def sharded_counts() -> dict:
    return {hm.NAME: hm.LAUNCHES, kl.CONDENSE_NAME: kl.CONDENSE_LAUNCHES,
            kl.RECOVER_NAME: kl.RECOVER_LAUNCHES}


def zero_sharded_counts() -> None:
    hm.LAUNCHES = kl.CONDENSE_LAUNCHES = kl.RECOVER_LAUNCHES = 0


def halo_case(s: int, Kl: int, seed: int):
    """S (Kl, 3, s, s), x (Kl, s) and two halo rows (s,) on the card."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=DEV)
    return t(Kl, 3, s, s), t(Kl, s), t(s), t(s)


def check_scaled(what: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """max |got - ref| <= tol max |ref|; returns max |got - ref|."""
    g, r = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: not finite")
    scale = max(float(r.abs().max()), 1e-30)
    err = float((g - r).abs().max())
    if err > tol * scale:
        raise AssertionError(f"{what}: max |d| = {err:.3e} exceeds {tol:g} of scale "
                             f"{scale:.3e}")
    return err


def phase_halo_parity():
    print(f"== phase 3f: row 15 ({hm.NAME}) against its plain version, within "
          f"{HALO_TOL:g} of scale")
    for s, Kl in ((14, 256), (14, 2048), (4, 256), (14, 65), (3, 37), (32, 2048)):
        S, x, left, right = halo_case(s, Kl, seed=100 * s + Kl)
        worst = 0.0
        for shard, lo, hi in (("first", None, right), ("interior", left, right),
                              ("last", left, None)):
            got = hm.halo_matvec_cuda(S, x, lo, hi)
            torch.cuda.synchronize()
            err = check_scaled(f"{hm.NAME} s={s} Kl={Kl} {shard}", got,
                               hm.halo_matvec_plain(S, x, lo, hi), HALO_TOL)
            worst = max(worst, err)
        MAX_ERR[hm.NAME] = max(MAX_ERR[hm.NAME], worst)
        print(f"  s={s} Kl={Kl}: first (zero left halo), interior, last (zero right "
              f"halo) shards: max|d| {worst:.2e}")


def _cu_check(code: int, what: str) -> None:
    if code:
        raise AssertionError(f"{what} returned CUresult {code}")


def graph_nodes(fn) -> list:
    """What one fn() puts on the device, as a CUDA graph captured around
    it: a (type, kernel name) per node, the types of libcuda's
    CUgraphNodeType (0 a kernel, 1 a copy, 2 a fill) and the name None
    for every node but a kernel.  Read through libcuda, so it does
    not rest on a profiler's trace."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    _cu_check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    for node in nodes[:count.value]:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        _cu_check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        name = None
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56.
            params = (ctypes.c_void_p * 16)()
            _cu_check(cu.cuGraphKernelNodeGetParams_v2(node, params),
                      "cuGraphKernelNodeGetParams_v2")
            text = ctypes.c_char_p()
            if params[0]:
                _cu_check(cu.cuFuncGetName(ctypes.byref(text), ctypes.c_void_p(params[0])),
                          "cuFuncGetName")
            else:
                _cu_check(cu.cuKernelGetName(ctypes.byref(text), ctypes.c_void_p(params[7])),
                          "cuKernelGetName")
            name = text.value.decode()
        out.append((kind.value, name))
    del graph
    return out


def halo_call_check():
    """One row-15 call with both halos absent: a CUDA graph captured
    around it holds one node, the kernel (no fill of a zero halo, no
    copy), and torch.cuda.memory_allocated() grows by y's block alone."""
    S, x, _, _ = halo_case(IIWA.state_size, 256, seed=9)
    hm.halo_matvec_cuda(S, x)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = hm.halo_matvec_cuda(S, x)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    y_block = -(-y.numel() * y.element_size() // 512) * 512
    if grown > y_block:
        raise AssertionError(f"{hm.NAME} without halos allocated {grown} B, y's block "
                             f"is {y_block} B")
    nodes = graph_nodes(lambda: hm.halo_matvec_cuda(S, x))
    if len(nodes) != 1 or nodes[0][0] != 0 or "halo_matvec" not in nodes[0][1]:
        raise AssertionError(f"{hm.NAME} without halos: graph nodes {nodes}, not the "
                             "one kernel")
    return {"kernel": nodes[0][1], "allocated": grown, "y_block": y_block}


def profiled_sharded() -> dict:
    """The knot-sharded measurements that need torch.profiler, run in a
    process of their own (``python3 chip_smoke.py --profiled``) before the
    main process opens any profiler session: in one process, a profiler
    session before the long-K phases left every later session of this run
    without device activity.  The device's busy share of one kernel-tier
    solve_sharded per (K, n) and of 20 pcg_sharded iterations on four
    shards per K (None where the trace holds no device activity)."""
    out = {"solve_sharded": {}, "pcg_sharded": {}}
    kw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    for K in SHARD_K:
        one = gt.KKTBlocks(*(a[0] for a in longk_batch(K, 1, seed0=7000 + K)))
        for n in SHARD_N:
            mesh = gt.Mesh([DEV] * n)
            out["solve_sharded"][f"{K},{n}"] = device_busy_ms(
                lambda: gt.solve_sharded(mesh, *one, **kw))
        ops = kl.condense_longk_cuda(*(a[None] for a in one), rho=RHO)
        mesh = gt.Mesh([DEV] * 4)
        out["pcg_sharded"][str(K)] = device_busy_ms(lambda: gt.pcg_sharded(
            mesh, ops.S[0], ops.Pinv[0], ops.gamma[0], exit_tol=0.0, max_iters=20))
        del ops
        torch.cuda.empty_cache()
    return out


def run_profiled_sharded() -> dict:
    """profiled_sharded() in a child process; raises if it fails."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--profiled"],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"chip_smoke.py --profiled failed (exit {proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def busy_text(busy, wall) -> str:
    if busy is None:
        return "not measured (the trace holds no device activity)"
    return f"device busy {busy:.4f} of {wall:.4f} ms, idle {100 * (1 - busy / wall):.1f} %"


def halo_launches(n: int, res, max_iters: int) -> int:
    """Row 15's launches in one sharded PCG solve at poly degree 1.  Each
    matvec (of S or of Pinv) is one launch a shard.  The set-up makes two
    (r = gamma - S lam0, r~ = Pinv r); each loop body two (upsilon = S p,
    r~ = Pinv r).  A run that exits at loop index iters ran iters + 1
    bodies, one that did not converge max_iters.  So n * 2 (1 + bodies)."""
    bodies = int(res.iters) + 1 if bool(res.converged) else max_iters
    return n * 2 * (1 + bodies)


def as_batch(res, dz_x, dz_u) -> gt.SolveResult:
    """A sharded solve's (PCGResult, dz_x, dz_u) as a SolveResult of B = 1."""
    return gt.SolveResult(res.lam[None], dz_x[None], dz_u[None], res.iters[None],
                          res.converged[None], res.eta[None])


def phase_sharded_path():
    print("== phase 4f: the knot-sharded path on Mesh(['cuda:0'] * n), n = 1, 2, 4: "
          "solve_sharded (PCG: rows 7, 15 and 13 on every shard; method='direct'), "
          "the degenerate placement and the refusals; solve_batched_dp and "
          "solve_sequence_batched_dp")
    total = dict.fromkeys(sharded_counts(), 0)

    def run(what, fn, expect):
        """fn() with the path's counts from 0; expect(out) gives the counts."""
        zero_sharded_counts()
        out = fn()
        torch.cuda.synchronize()
        got = sharded_counts()
        want = {key: expect(out).get(key, 0) for key in got}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for key, value in got.items():
            total[key] += value
        return out

    def kernel_tier(n, max_iters=MAX_ITERS):
        return lambda out: {hm.NAME: halo_launches(n, out[0], max_iters),
                            kl.CONDENSE_NAME: n, kl.RECOVER_NAME: n}

    def oracle_err(what, out, ref):
        worst = 0.0
        for name, got, r in zip(("lam", "dz_x", "dz_u"), (out[0].lam, *out[1:]), ref):
            err = float((got.double() - r[0]).abs().max()) / max(1.0, float(r.abs().max()))
            if err > 2e-3:
                raise AssertionError(f"{what} {name}: {err:.3e} of scale off the "
                                     "reference")
            worst = max(worst, err)
        return worst

    kw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    meshes = {n: gt.Mesh([DEV] * n) for n in SHARD_N}
    for K in SHARD_K:
        spec = longk_spec(K)
        one = gt.KKTBlocks(*(a[0] for a in longk_batch(K, 1, seed0=7000 + K)))
        oracle = (dense_kkt_solve64(gt.KKTBlocks(*(a[None] for a in one)), RHO)
                  if K == 1024 else None)
        for prec in PRECS if K == 1024 else ("symmetric_stair",):
            opts = gt.SolverOptions(preconditioner=prec, **kw)
            single = gt.solve(spec, one, opts)
            for n in SHARD_N if K == 1024 else (4,):
                what = f"solve_sharded K={K} n={n} {prec}"
                out = run(what, lambda: gt.solve_sharded(
                    meshes[n], *one, preconditioner=prec, **kw), kernel_tier(n))
                ref = gt.solve_sharded(meshes[n], *one, preconditioner=prec,
                                       use_kernel=False, **kw)
                got_b, ref_b = as_batch(*out), as_batch(*ref)
                if not bool(out[0].converged):
                    raise AssertionError(f"{what}: did not converge")
                ties = check_iters(f"{what} kernel vs torch tier", got_b, ref_b, EXIT_TOL)
                if prec == "jacobi":
                    # Scalar Jacobi compared over a capped run, as in phase 3:
                    # its float32 round-off grows past 1e-4 along ~70 iterations.
                    cap = 10
                    c_k = run(f"{what} capped", lambda: gt.solve_sharded(
                        meshes[n], *one, preconditioner=prec, **{**kw, "max_iters": cap}),
                        kernel_tier(n, cap))
                    c_t = gt.solve_sharded(meshes[n], *one, preconditioner=prec,
                                           use_kernel=False, **{**kw, "max_iters": cap})
                    pair = (as_batch(*c_k), as_batch(*c_t))
                else:
                    pair = (got_b, ref_b) if not ties else None
                err = 0.0
                for name in ("lam", "dz_x", "dz_u") if pair else ():
                    err = max(err, check_close(f"{what} {name}", getattr(pair[0], name),
                                               getattr(pair[1], name)))
                d_it = int(out[0].iters) - int(single.iters)
                if abs(d_it) > SHARD_ITERS:
                    raise AssertionError(f"{what}: {int(out[0].iters)} iterations, the "
                                         f"single-device solve {int(single.iters)}")
                if oracle is not None:
                    o_err = oracle_err(what, out, oracle)
                    o_text = f"within {o_err:.2e} of scale of the float64 dense KKT solve"
                else:
                    o_err = oracle_err(what, out, tuple(
                        x.double()[None] for x in (single.lam, single.dz_x, single.dz_u)))
                    o_text = f"within {o_err:.2e} of scale of the single-device solve"
                print(f"  {what}: iters {int(out[0].iters)} (torch tier "
                      f"{int(ref[0].iters)}, {ties} ties; single-device solve "
                      f"{int(single.iters)}), kernel vs torch tier max|d| {err:.2e}"
                      f"{' over 10 iterations' if prec == 'jacobi' else ''}; {o_text}")
        # The exact path, in torch ops: no launch of rows 7, 13 or 15.
        what = f"solve_sharded method='direct' K={K} n=4"
        out = run(what, lambda: gt.solve_sharded(meshes[4], *one, rho=RHO,
                                                 method="direct"), lambda out: {})
        if not bool(out[0].converged) or int(out[0].iters) != 0:
            raise AssertionError(f"{what}: not converged with iters 0")
        if oracle is not None:
            err = oracle_err(what, out, oracle)
            ref_text = "the float64 dense KKT solve"
        else:
            single = gt.solve(spec, one, gt.SolverOptions(rho=RHO, method="direct"))
            err = oracle_err(what, out, tuple(
                x.double()[None] for x in (single.lam, single.dz_x, single.dz_u)))
            ref_text = "the single-device solve(method='direct')"
        print(f"  {what}: converged, iters 0, within {err:.2e} of scale of {ref_text}")
        del oracle
        torch.cuda.empty_cache()

    # One-knot shards (K = n = 4): the torch tier and block Thomas.
    spec = longk_spec(4)
    one = gt.KKTBlocks(*(a[0] for a in longk_batch(4, 1, seed0=7100)))
    out = run("solve_sharded K=n=4", lambda: gt.solve_sharded(meshes[4], *one, **kw),
              lambda out: {})
    single = gt.solve(spec, one, gt.SolverOptions(**kw), pcg_backend="torch")
    if int(out[0].iters) != int(single.iters):
        raise AssertionError("solve_sharded K=n=4: iterations differ from 'torch'")
    check_close("solve_sharded K=n=4 lam", out[0].lam, single.lam)
    out = run("solve_sharded direct K=n=4", lambda: gt.solve_sharded(
        meshes[4], *one, rho=RHO, method="direct"), lambda out: {})
    single = gt.solve(spec, one, gt.SolverOptions(rho=RHO, method="direct"))
    check_close("solve_sharded direct K=n=4 lam", out[0].lam, single.lam)
    print("  K = n = 4 (one knot a shard): 'pcg' on the torch tier (no launch), "
          "iterations equal to 'torch'; 'direct' by block Thomas, equal to solve")
    for what, fn in (
            ("K=1023 on 4 shards", lambda: gt.solve_sharded(
                meshes[4], *gt.KKTBlocks(*(a[0] for a in longk_batch(1023, 1, 7200))),
                **kw)),
            ("method='direct' with use_kernel=True", lambda: gt.solve_sharded(
                meshes[4], *one, rho=RHO, method="direct", use_kernel=True))):
        try:
            fn()
        except ValueError as e:
            print(f"  {what} raises: {e}")
        else:
            raise AssertionError(f"{what} ran")

    # The data-parallel entry points: four groups on the card, each the
    # single-device surface on its problems.
    dp = gt.Mesh([DEV] * 4, "dp")
    blocks = gt.blocks_to_torch(testing.random_batch(IIWA, BATCH, seed0=7300), DEV)
    for method, counters in (("pcg", lambda: {kb.NAME: kb.LAUNCHES}),
                             ("direct", lambda: {kt.FWD_NAME: kt.FWD_LAUNCHES,
                                                 kt.REV_NAME: kt.REV_LAUNCHES})):
        before = counters()
        got = gt.solve_batched_dp(dp, *blocks, rho=RHO, exit_tol=EXIT_TOL,
                                  max_iters=MAX_ITERS, method=method)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counters().items()}
        if any(v != 4 for v in launched.values()):
            raise AssertionError(f"solve_batched_dp {method}: launches {launched}")
        ref = gt.solve_batched(IIWA, blocks, gt.SolverOptions(method=method, **kw))
        got_r = gt.SolveResult(got[0].lam, got[1], got[2], got[0].iters,
                               got[0].converged, got[0].eta)
        bitwise = dp_compare(f"solve_batched_dp B={BATCH} {method}", got_r, ref)
        print(f"  solve_batched_dp B={BATCH} on 4 groups, {method}: launches "
              f"{launched}; against solve_batched: iterations equal, "
              f"{'bit for bit' if bitwise else 'not bit for bit (within 1e-4 of scale)'}")
    farm_blocks = gt.blocks_to_torch(testing.random_farm(IIWA, T_STEPS, BATCH,
                                                         seed0=7400), DEV)
    rhos = farm_rhos(T_STEPS)
    before = ks.LAUNCHES
    out = gt.solve_sequence_batched_dp(dp, *farm_blocks, rhos=rhos,
                                       exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    torch.cuda.synchronize()
    if ks.LAUNCHES - before != 4:
        raise AssertionError(f"solve_sequence_batched_dp: {ks.LAUNCHES - before} "
                             "farm-kernel launches, expected 4")
    ref = gt.solve_sequence_batched(IIWA, farm_blocks, gt.SolverOptions(**kw),
                                    rhos=rhos)
    bitwise = dp_compare(f"solve_sequence_batched_dp B={BATCH} T={T_STEPS}",
                         gt.SolveResult(*out), ref)
    print(f"  solve_sequence_batched_dp B={BATCH} x T={T_STEPS} on 4 groups: 4 farm-"
          f"kernel launches; against solve_sequence_batched: iterations equal, "
          f"{'bit for bit' if bitwise else 'not bit for bit (within 1e-4 of scale)'}")
    print(f"  launches on the knot-sharded path: {total}")
    for name, count in total.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the knot-sharded path")
    return total


def dp_compare(what: str, got: gt.SolveResult, ref: gt.SolveResult) -> bool:
    """Equal iterations and converged flags, results within TOL of scale;
    True when every field is equal bit for bit."""
    for name in ("iters", "converged"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"{what}: {name} differ from the single-device surface")
    for name in ("lam", "dz_x", "dz_u"):
        check_close(f"{what} {name}", getattr(got, name), getattr(ref, name))
    return all(torch.equal(a, b) for a, b in zip(got, ref))


# --------------------------------------------------------------------------
# One pack served over a mesh (solve_packed_dp), the groups on the one card.

PACKED_DP_N = (1, 2, 4)
PACKED_FIELDS = ("lam_p", "dzx_p", "dzu_p", "iters", "converged", "eta")


def packed_counts() -> dict:
    """The launch count of every kernel solve_packed can take."""
    return {kb.NAME: kb.LAUNCHES, **direct_counts(), **direct_longk_counts()}


def zero_packed_counts() -> None:
    kb.LAUNCHES = 0
    zero_direct_counts()
    zero_direct_longk_counts()


def packed_dp_cases():
    """(label, spec, blocks on the card, method, the tier the pack records,
    the kernels each group's solve launches once, and one it launches at
    least once: rows 8/10 run in rounds, row 11 in up to three launches)."""
    iiwa = gt.blocks_to_torch(testing.random_batch(IIWA, BATCH, seed0=7500), DEV)
    long4 = longk_batch(1024, 4, seed0=7600)
    pair = (kt.FWD_NAME, kt.REV_NAME, kt.EPILOGUE_NAME)
    rows_7_13 = (kl.CONDENSE_NAME, kl.RECOVER_NAME)
    return (("pcg B=256", IIWA, iiwa, "pcg", None, (kb.NAME,), kb.NAME),
            ("direct B=256", IIWA, iiwa, "direct", "thomas", pair, kt.FWD_NAME),
            ("direct B=8", IIWA, gt.KKTBlocks(*(a[:8] for a in iiwa)), "direct", "cr",
             (kd.NAME,), kd.NAME),
            ("long-K pcg K=1024 B=4", longk_spec(1024), long4, "pcg", "longk",
             rows_7_13, kl.PCG_NAME),
            ("long-K direct K=1024 B=4", longk_spec(1024), long4, "direct", "longk",
             rows_7_13, kl.CR_NAME))


def phase_packed_dp_path():
    print("== phase 4f, continued: solve_packed_dp on Mesh(['cuda:0'] * n, 'dp'), n = "
          "1, 2, 4: "
          "one pack's groups of g = B / n problems, each group's solve_packed on a "
          "view of the pack; against each group alone (bit for bit), the whole "
          "batch (TOL and the tie rule), the warm carry, and the launches")
    kw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    total = dict.fromkeys(packed_counts(), 0)
    for label, spec, blocks, method, tier, route, core in packed_dp_cases():
        opts = gt.SolverOptions(method=method, **kw)
        packed = gt.pack(spec, blocks, method=method)
        if packed.plan.tier != tier:
            raise AssertionError(f"pack {label}: tier {packed.plan.tier}, expected {tier}")
        whole = gt.solve_packed(packed, opts)
        for n in PACKED_DP_N:
            what = f"solve_packed_dp {label} n={n}"
            mesh = gt.Mesh([DEV] * n, "dp")
            g = packed.plan.batch // n
            for i, local in enumerate(gsharded._local_packs(mesh, packed, g)):
                if any(getattr(local, f).data_ptr() != getattr(packed, f)[i * g].data_ptr()
                       for f in ("Qb", "Rb", "Ab", "Bb", "qb", "rb", "cb")):
                    raise AssertionError(f"{what}: group {i} is not a view of the pack")
            # Each group alone: a pack of its problems with the same tier.
            zero_packed_counts()
            alone = []
            for i in range(n):
                part = gt.KKTBlocks(*(a[i * g:(i + 1) * g] for a in blocks))
                gp = gt.pack(spec, part, method=method,
                             tier=tier if tier in ("cr", "thomas") else None)
                if gp.plan.tier != tier:
                    raise AssertionError(f"{what}: group {i} packs as {gp.plan.tier}")
                alone.append(gt.solve_packed(gp, opts))
            torch.cuda.synchronize()
            want = packed_counts()
            zero_packed_counts()
            dp = gt.solve_packed_dp(mesh, packed, opts)
            torch.cuda.synchronize()
            got = packed_counts()
            if got != want or any(got[name] != n for name in route) or got[core] < n:
                raise AssertionError(f"{what}: launches {got}; the groups alone {want}, "
                                     f"{route} {n} times each, {core} at least {n}")
            for key, value in got.items():
                total[key] += value
            for f in PACKED_FIELDS:
                if not torch.equal(getattr(dp, f), torch.cat([getattr(r, f) for r in alone])):
                    raise AssertionError(f"{what}: {f} differs from the groups alone")
            ties = check_iters(f"{what} against the whole batch", dp, whole, EXIT_TOL)
            same = dp.iters == whole.iters
            err = max(check_close(f"{what} {f} against the whole batch",
                                  getattr(dp, f)[same], getattr(whole, f)[same])
                      for f in ("lam_p", "dzx_p", "dzu_p"))
            bitwise = all(torch.equal(getattr(dp, f), getattr(whole, f))
                          for f in PACKED_FIELDS)
            text = (f"launches {({k: v for k, v in got.items() if v})}; bit for bit "
                    f"with each group alone; against the whole batch "
                    f"{'bit for bit' if bitwise else f'max|d| {err:.2e}'}, {ties} ties")
            if method == "pcg":
                again = gt.solve_packed_dp(mesh, packed, opts, lam0=dp.lam_packed)
                if int(again.iters.max()) > 1:
                    raise AssertionError(f"{what}: the carry on the same data took "
                                         f"{int(again.iters.max())} iterations")
                refreshed = gt.update_vectors(packed, blocks.q * 1.01, blocks.r, blocks.c)
                warm = gt.solve_packed_dp(mesh, refreshed, opts, lam0=dp.lam_packed)
                ref = gt.solve_packed(refreshed, opts, lam0=whole.lam_packed)
                check_iters(f"{what} warm after update_vectors", warm, ref, EXIT_TOL)
                if not bool(warm.converged.all()) or \
                        int(warm.iters.sum()) >= int(dp.iters.sum()):
                    raise AssertionError(f"{what}: the warm start after update_vectors "
                                         "did not converge in fewer iterations")
                text += (f"; the carry on the same data {int(again.iters.max())} "
                         f"iterations at most, after update_vectors mean "
                         f"{float(warm.iters.double().mean()):.2f} (cold "
                         f"{float(dp.iters.double().mean()):.2f})")
            print(f"  {what} (g={g}, tier {tier}): {text}")
        del whole, packed
        torch.cuda.empty_cache()
    refusals = 0
    packed = gt.pack(IIWA, gt.blocks_to_torch(testing.random_batch(IIWA, 6, seed0=7700),
                                               DEV))
    for fn in (lambda: gt.solve_packed_dp(gt.Mesh([DEV] * 4, "dp"), packed),
               lambda: gt.solve_packed_dp(gt.Mesh([DEV] * 2, "dp"), packed,
                                          gt.SolverOptions(method="direct"))):
        try:
            fn()
        except ValueError as e:
            print(f"  refused: {e}")
            refusals += 1
    if refusals != 2:
        raise AssertionError("solve_packed_dp served a batch of 6 on 4 groups or "
                             "relabelled a PCG pack")
    print(f"  launches on the solve_packed_dp path: "
          f"{({k: v for k, v in total.items() if v})}")
    return total


def phase_packed_dp_times(card: str) -> dict:
    print(f"== phase 5f, continued: solve_packed_dp per call beside solve_packed on the "
          f"same pack "
          f"(CUDA events, median of {TIMING_RUNS} runs after warm-up) on {card}")
    kw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    times = {}
    for label, spec, blocks, method, *_ in packed_dp_cases():
        opts = gt.SolverOptions(method=method, **kw)
        packed = gt.pack(spec, blocks, method=method)
        meshes = {n: gt.Mesh([DEV] * n, "dp") for n in PACKED_DP_N}
        row = {"solve_packed": [cuda_median_ms(lambda: gt.solve_packed(packed, opts))]}
        for n in PACKED_DP_N:
            row[n] = cuda_median_ms(lambda: gt.solve_packed_dp(meshes[n], packed, opts))
        row["solve_packed"].append(cuda_median_ms(lambda: gt.solve_packed(packed, opts)))
        times[label] = row
        print(f"  {label}: solve_packed {row['solve_packed'][0]:.4f} / "
              f"{row['solve_packed'][1]:.4f} ms; solve_packed_dp " + ", ".join(
                  f"n={n} {row[n]:.4f}" for n in PACKED_DP_N) + f" ms  [{card}]")
    return times


def phase_examples():
    print("== phase 4i: examples/torch/*.py on the card (--device cuda), each in a "
          "child process on the library phase 2 built")
    root = Path(__file__).resolve().parent
    lib = _build.library_path()

    def built():
        return lib.stat().st_mtime_ns, sorted(p.name for p in
                                              _build.BUILD_DIR.glob("libgato_kernels_*"))

    before = built()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    scripts = sorted((root / "examples" / "torch").glob("*.py"))
    if [p.stem for p in scripts] != ["advanced", "iiwa_batch", "pendulum", "serving"]:
        raise AssertionError(f"examples/torch holds {[p.name for p in scripts]}")
    for path in scripts:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(path), "--device", "cuda"], cwd=root,
                             env=env, capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"examples/torch/{path.name} exited {out.returncode}:\n"
                                 f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        lines = out.stdout.strip().splitlines()
        print(f"  examples/torch/{path.name}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s; its last lines:")
        for line in lines[-5:]:
            print(f"    {line}")
    if built() != before:
        raise AssertionError("an example built the kernel library again")
    print(f"  the library {lib.name} was not built again")


def graph_ms_per_call(fn, calls: int = 50) -> float:
    """Device time of one fn() without the host's launch cost: ``calls``
    calls captured in a CUDA graph, the replay timed, over calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_median_ms(graph.replay) / calls


def device_busy_ms(fn):
    """(device ms, wall ms) of one fn(): the summed durations of the CUDA
    activities (kernels, copies, fills) a torch.profiler trace records,
    and CUDA events around the call.  Device ms is None where the trace
    holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return (busy / 1e3 if busy > 0 else None), start.elapsed_time(end)


def phase_sharded_times(card: str, prof: dict):
    print(f"== phase 5f: row 15 and the knot-sharded path's times (CUDA events, median "
          f"of {TIMING_RUNS} runs after warm-up; {SLOW_RUNS} for plain versions, library "
          f"calls and the torch tier) on {card}")
    h = halo_call_check()
    print(f"  one {hm.NAME} call without halos (Kl=256) captured in a CUDA graph: one "
          f"node, the kernel ({h['kernel']}); {h['allocated']} B allocated, y's block "
          f"{h['y_block']} B")
    s = IIWA.state_size
    times = {}
    for Kl in (256, 2048):
        S, x, left, right = halo_case(s, Kl, seed=500 + Kl)
        y = hm.halo_matvec_cuda(S, x, left, right)
        # The library call: S as (Kl, s, 3s) against the halo stack as (Kl,
        # 3s, 1), both laid out before the timing (the port never calls it).
        S_lib = S.permute(0, 2, 1, 3).reshape(Kl, s, 3 * s).contiguous()
        h_lib = blocktri.halo_stack(x, left, right).reshape(Kl, 3 * s, 1).contiguous()
        lib = torch.bmm(S_lib, h_lib)[..., 0]
        check_scaled(f"torch.bmm Kl={Kl}", lib, y, HALO_TOL)
        bound_ms, bound_by = bound(nbytes(S, x, left, right, y), 6 * s * s * Kl)
        kern = lambda: hm.halo_matvec_cuda(S, x, left, right)
        plain = lambda: hm.halo_matvec_plain(S, x, left, right)
        library = lambda: torch.bmm(S_lib, h_lib)
        # Each timed twice (plain, kernel, kernel, plain): a call as the
        # sharded loop makes it, host work included, and its device time
        # alone (50 calls in a CUDA graph).  At these sizes a call's host
        # work is the larger.
        call, dev = {}, {}
        for name, fn in (("plain", plain), ("kernel", kern), ("kernel", kern),
                         ("plain", plain), ("library", library)):
            call.setdefault(name, []).append(cuda_median_ms(fn))
            dev.setdefault(name, []).append(graph_ms_per_call(fn))
        c, d = ({k: float(np.mean(v)) for k, v in m.items()} for m in (call, dev))
        times[(hm.NAME, Kl)] = dict(
            ms=d["kernel"], plain_ms=d["plain"], library_ms=d["library"],
            bound_ms=bound_ms, bound_by=bound_by, call_ms=c["kernel"],
            plain_call_ms=c["plain"], library_call_ms=c["library"])
        print(f"  {hm.NAME} s={s} Kl={Kl}, device time a call (CUDA graph): kernel "
              f"{dev['kernel'][0]:.5f} / {dev['kernel'][1]:.5f} ms, plain "
              f"{dev['plain'][0]:.5f} / {dev['plain'][1]:.5f} ms, library (torch.bmm) "
              f"{d['library']:.5f} ms; bound {bound_ms:.6f} ms ({bound_by}; "
              f"{100 * bound_ms / d['kernel']:.1f} % of the kernel's time); a whole "
              f"call with its host work: kernel {c['kernel']:.4f}, plain "
              f"{c['plain']:.4f}, library {c['library']:.4f} ms  [{card}]")
    kw = dict(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    for K in SHARD_K:
        spec = longk_spec(K)
        one = gt.KKTBlocks(*(a[0] for a in longk_batch(K, 1, seed0=7000 + K)))
        single = gt.solve(spec, one, gt.SolverOptions(**kw))
        single_ms = cuda_median_ms(lambda: gt.solve(spec, one, gt.SolverOptions(**kw)))
        times[("single", K)] = single_ms
        print(f"  solve K={K} (one device, the long-K route): {single_ms:.4f} ms, "
              f"{int(single.iters)} iterations  [{card}]")
        for n in SHARD_N:
            mesh = gt.Mesh([DEV] * n)
            res = gt.solve_sharded(mesh, *one, **kw)[0]
            k_ms = cuda_median_ms(lambda: gt.solve_sharded(mesh, *one, **kw))
            t_ms = cuda_median_ms(lambda: gt.solve_sharded(mesh, *one, use_kernel=False,
                                                           **kw), runs=SLOW_RUNS, warmup=1)
            busy, wall = prof["solve_sharded"][f"{K},{n}"]
            times[("sharded", K, n)] = dict(kernel=k_ms, torch=t_ms, iters=int(res.iters),
                                           busy=busy, wall=wall)
            print(f"  solve_sharded K={K} n={n}: kernel tier {k_ms:.4f} ms, torch tier "
                  f"{t_ms:.4f} ms ({int(res.iters)} iterations; {k_ms / single_ms:.1f}x "
                  f"the single-device solve); one kernel-tier call under torch.profiler: "
                  f"{busy_text(busy, wall)}  [{card}]")
        # One sharded PCG iteration on four shards: 20 iterations against
        # none (exit_tol = 0, so the loop never exits early), row 15 on
        # operators condensed once.
        ops = kl.condense_longk_cuda(*(a[None] for a in one), rho=RHO)
        mesh = gt.Mesh([DEV] * 4)
        runs = {}
        for iters in (0, 20):
            runs[iters] = cuda_median_ms(lambda: gt.pcg_sharded(
                mesh, ops.S[0], ops.Pinv[0], ops.gamma[0], exit_tol=0.0,
                max_iters=iters))
        per_it = (runs[20] - runs[0]) / 20
        times[("iteration", K)] = per_it
        busy, wall = prof["pcg_sharded"][str(K)]
        times[("busy", K)] = (busy, wall)
        print(f"  pcg_sharded K={K} n=4: max_iters=0 {runs[0]:.4f} ms, 20 {runs[20]:.4f} "
              f"ms: {1e3 * per_it:.1f} us an iteration (2 matvecs of 4 launches and 6 "
              f"halo copies each, 2 dots, 3 updates, one host read); 20 iterations "
              f"under torch.profiler: {busy_text(busy, wall)}  [{card}]")
        del ops
        torch.cuda.empty_cache()
    dp = gt.Mesh([DEV] * 4, "dp")
    blocks = gt.blocks_to_torch(testing.random_batch(IIWA, BATCH, seed0=7300), DEV)
    for method in ("pcg", "direct"):
        opts = gt.SolverOptions(method=method, **kw)
        dp_ms = cuda_median_ms(lambda: gt.solve_batched_dp(
            dp, *blocks, rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS, method=method))
        one_ms = cuda_median_ms(lambda: gt.solve_batched(IIWA, blocks, opts))
        times[("dp", method)] = (dp_ms, one_ms)
        print(f"  solve_batched_dp B={BATCH} on 4 groups, {method}: {dp_ms:.4f} ms; "
              f"solve_batched {one_ms:.4f} ms  [{card}]")
    farm_blocks = gt.blocks_to_torch(testing.random_farm(IIWA, T_STEPS, BATCH,
                                                         seed0=7400), DEV)
    rhos = farm_rhos(T_STEPS)
    dp_ms = cuda_median_ms(lambda: gt.solve_sequence_batched_dp(
        dp, *farm_blocks, rhos=rhos, exit_tol=EXIT_TOL, max_iters=MAX_ITERS),
        runs=SLOW_RUNS, warmup=1)
    one_ms = cuda_median_ms(lambda: gt.solve_sequence_batched(
        IIWA, farm_blocks, gt.SolverOptions(**kw), rhos=rhos), runs=SLOW_RUNS, warmup=1)
    times[("dp", "farm")] = (dp_ms, one_ms)
    print(f"  solve_sequence_batched_dp B={BATCH} x T={T_STEPS} on 4 groups: "
          f"{dp_ms:.4f} ms; solve_sequence_batched {one_ms:.4f} ms  [{card}]")
    return times


# --------------------------------------------------------------------------
# The measurement surface (timing, debug) and the three probe kernels (rows
# 16, 17 and 18, kernels/probes.py).

# Rows 16 and 17 against their plain versions, knot by knot: within 1e-4 of
# the largest |y| of each (problem, knot).  Their inputs (probes.
# chain_operator, fma_operator) make each knot's own step a scaled
# orthogonal block, so every knot's y stays within 7x of every other's
# over the 100 trips; the rest is float32 round-off along up to 600
# dependent steps in another order (float32 against float64 drifts up to
# 2.6e-5 of a knot's scale at IIWA).
PROBE_TOL = 1e-4
PROBE_TRIPS = 100


def probe_counts() -> dict:
    return {kp.COPY_NAME: kp.COPY_LAUNCHES, kp.CHAIN_BLOCK_NAME: kp.CHAIN_BLOCK_LAUNCHES,
            kp.CHAIN_GRID_NAME: kp.CHAIN_GRID_LAUNCHES, kp.FMA_NAME: kp.FMA_LAUNCHES}


def zero_probe_counts() -> None:
    kp.COPY_LAUNCHES = kp.CHAIN_BLOCK_LAUNCHES = kp.CHAIN_GRID_LAUNCHES = 0
    kp.FMA_LAUNCHES = 0


def check_knots(what: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """max |got - ref| <= tol max |ref| within every (problem, knot) row of
    (B, K, s); returns max |got - ref|."""
    g, r = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: not finite")
    err = (g - r).abs().amax(-1)
    scale = r.abs().amax(-1).clamp_min(1e-30)
    worst = (err / scale).flatten().argmax()
    b, k = divmod(int(worst), r.shape[1])
    if float(err[b, k]) > tol * float(scale[b, k]):
        raise AssertionError(f"{what}: problem {b}, knot {k}: max |d| = "
                             f"{float(err[b, k]):.3e} exceeds {tol:g} of its scale "
                             f"{float(scale[b, k]):.3e}")
    return float(err.max())


def phase_probe_parity():
    print(f"== phase 3g: rows 16, 17 and 18 against their plain versions (row 18 bit "
          f"for bit; rows 16, 17 over {PROBE_TRIPS} trips within {PROBE_TOL:g} of "
          "each knot's scale)")
    s = IIWA.state_size
    for B in (1, BATCH):
        q = gt.blocks_to_torch(testing.random_batch(IIWA, B, seed0=8000), DEV).q
        got = kp.null_copy_cuda(q)
        torch.cuda.synchronize()
        if not torch.equal(got, kp.null_copy_plain(q)):
            raise AssertionError(f"{kp.COPY_NAME} B={B}: not bit for bit q * 1.0000001")
    # The scalar tail (K s not a multiple of 4) and the scalar path (q one
    # float off a 16-byte boundary).
    for shape, offset in (((3, 7, 3), 0), ((1, 50, 14), 1), ((3, 7, 3), 1)):
        flat = torch.tensor(np.random.default_rng(8001 + offset).normal(
            size=offset + int(np.prod(shape))), dtype=torch.float32, device=DEV)
        q = flat[offset:].view(shape)
        got = kp.null_copy_cuda(q)
        torch.cuda.synchronize()
        if not torch.equal(got, kp.null_copy_plain(q)):
            raise AssertionError(f"{kp.COPY_NAME} {shape} offset {offset}: not bit for "
                                 "bit q * 1.0000001")
    print(f"  {kp.COPY_NAME} at IIWA K=50, B=1 and {BATCH}, (3, 7, 3), and q one float "
          "off a 16-byte boundary: bit for bit")
    # Row 16 on kernel B's cluster (the rule's C, and C = 1 and 2 forced)
    # and on rows 8/10's rounds (one problem on grid barriers, three on
    # flagged partials).
    for scope, B, K, force in (("block", 1, 50, {}), ("block", 1, 50, {"cluster": 1}),
                               ("block", 1, 50, {"cluster": 2}), ("grid", 1, 50, {}),
                               ("grid", 3, 37, {}), ("grid", 1, 1024, {})):
        name = kp.CHAIN_BLOCK_NAME if scope == "block" else kp.CHAIN_GRID_NAME
        cases = probe_iter_floor.GRID if K == 50 and not force else ((2, 2), (4, 1))
        worst = 0.0
        for n_mv, n_dot in cases:
            M, y0 = kp.chain_operator(B, K, s, seed=8100 + K + 10 * n_mv + n_dot, device=DEV)
            kw = dict(n_mv=n_mv, n_dot=n_dot, trips=PROBE_TRIPS)
            got = kp.null_chain_cuda(M, y0, scope=scope, **kw, **force)
            torch.cuda.synchronize()
            worst = max(worst, check_knots(f"{name} B={B} K={K} {force} ({n_mv}, {n_dot})",
                                           got, kp.null_chain_plain(M, y0, **kw), PROBE_TOL))
        MAX_ERR[name] = max(MAX_ERR[name], worst)
        print(f"  {name} at IIWA B={B} K={K} {force or ''}, (n_mv, n_dot) in "
              f"{list(cases)}: max|d| {worst:.2e}")
    # Row 17 at IIWA K = 50 (two lanes a knot) and at K = 4 (kernel B's
    # knots a CTA at C = 16: 16 lanes a knot).
    for K, B in ((50, 1), (50, 132), (4, 1)):
        M, y0 = kp.fma_operator(B, K, seed=8200 + B + K, device=DEV)
        got = kp.fma_chain_cuda(M, y0, depth=2, trips=PROBE_TRIPS)
        torch.cuda.synchronize()
        err = check_knots(f"{kp.FMA_NAME} K={K} B={B}", got,
                          kp.fma_chain_plain(M, y0, depth=2, trips=PROBE_TRIPS), PROBE_TOL)
        MAX_ERR[kp.FMA_NAME] = max(MAX_ERR[kp.FMA_NAME], err)
        print(f"  {kp.FMA_NAME} at K={K}, s=14, B={B}, depth 2 ({kp.fma_plan(B, K).lanes} "
              f"lanes a knot): max|d| {err:.2e} (scale {float(got.abs().max()):.2e})")


# A torch.profiler session on the card has, rarely, recorded no CUDA
# activity at all, though the same call recorded its kernels in every other
# session (ROADMAP queue 3: a process's first session, and once 4g's
# third): debug.trace raises then.  Such a session is taken again,
# PROFILE_TRIES times in all at most, for that error alone, each retry
# printed; any other failure, or the last, stops the run.
PROFILE_TRIES = 3


def profiled(session):
    """session(), taken again where its trace recorded no CUDA activity."""
    for attempt in range(1, PROFILE_TRIES + 1):
        try:
            return session()
        except RuntimeError as err:
            if "recorded no CUDA activity" not in str(err) or attempt == PROFILE_TRIES:
                raise
            print(f"  note: a torch.profiler session recorded no CUDA activity; taking "
                  f"it again ({attempt + 1} of {PROFILE_TRIES})")


def traced_events(fn, label: str):
    """Run fn() once under debug.trace inside a record_function span named
    ``label``; returns the Chrome trace's events and the span's start and
    end (us)."""
    fn()
    torch.cuda.synchronize()

    def session():
        with tempfile.TemporaryDirectory() as tmp:
            with gdebug.trace(tmp):
                with torch.profiler.record_function(label):
                    fn()
            (path,) = Path(tmp).glob("*.json")
            with open(path) as f:
                return json.load(f)["traceEvents"]

    events = profiled(session)
    span = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == label]
    if len(span) != 1:
        raise AssertionError(f"trace: {len(span)} spans named {label!r}, not 1")
    return events, span[0]["ts"], span[0]["ts"] + span[0]["dur"]


def runtime_calls(events, lo: float, hi: float) -> list:
    """The CUDA runtime calls the host made within [lo, hi], in order."""
    return sorted((e for e in events if e.get("cat") == "cuda_runtime"
                   and lo <= e["ts"] <= hi), key=lambda e: e["ts"])


def host_reads(fn) -> tuple:
    """(scalar reads, synchronisations) of one fn(), from its trace:
    ``aten::_local_scalar_dense`` ops (a tensor read on the host) and
    runtime calls that wait for the device (cuda*Synchronize, a pageable
    copy's stream synchronisation)."""
    events, lo, hi = traced_events(fn, "gato_host_reads")
    reads = sum(e.get("cat") == "cpu_op" and e["name"] == "aten::_local_scalar_dense"
                and lo <= e["ts"] <= hi for e in events)
    syncs = sum("Synchronize" in e["name"] for e in runtime_calls(events, lo, hi))
    return reads, syncs


def linsys_split(fn) -> dict:
    """The parts of one linsys_solve (testiters=1, staged, on the card) from
    its trace, in us: host packing (CSR to blocks, before the first runtime
    call), staging (the copies up to linsys_solve's first device
    synchronisation), the solve call (from there to the second, which waits
    for kernel B: routing, staging checks, allocations, the wrapper and the
    launch, and within it the host work up to kernel B's launch call),
    the wait, and the copy back (the two copies to the host and the lists);
    kernel B's and the copies' device time."""
    events, lo, hi = traced_events(fn, "linsys_solve")
    calls = runtime_calls(events, lo, hi)
    syncs = [e for e in calls if e["name"] == "cudaDeviceSynchronize"]
    kernel = [e for e in events if e.get("cat") == "kernel"
              and "fused_solve_kernel" in e["name"] and lo <= e["ts"]]
    if len(syncs) != 2 or len(kernel) != 1:
        raise AssertionError(f"linsys_solve trace: {len(syncs)} device synchronisations "
                             f"and {len(kernel)} kernel-B launches, not 2 and 1")
    # Kernel B's launch call: the runtime call with the kernel's correlation
    # id, else the last launch call before the second synchronisation (not
    # "before the kernel's start": the trace's host and device clocks may
    # be skewed by a few us).
    corr = kernel[0].get("args", {}).get("correlation")
    launches = [e for e in calls if e["name"].startswith("cudaLaunchKernel")
                and syncs[0]["ts"] < e["ts"] < syncs[1]["ts"]]
    launch = [e for e in launches
              if corr is not None and e.get("args", {}).get("correlation") == corr]
    launch = (launch or launches)[-1:]
    if not launch:
        raise AssertionError("linsys_solve trace: no launch call between its two "
                             "device synchronisations")
    launch = launch[0]
    first, s1, s2 = calls[0]["ts"], syncs[0], syncs[1]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and lo <= e["ts"] <= hi]
    return {
        "total_us": hi - lo,
        "host_packing_us": first - lo,
        "staging_us": s1["ts"] + s1["dur"] - first,
        "solve_call_us": s2["ts"] - (s1["ts"] + s1["dur"]),
        "to_launch_us": launch["ts"] - (s1["ts"] + s1["dur"]),
        "launch_call_us": launch["dur"],
        "wait_us": s2["dur"],
        "copy_back_us": hi - (s2["ts"] + s2["dur"]),
        "kernel_b_us": kernel[0]["dur"],
        "h2d_us": sum(e["dur"] for e in copies if "HtoD" in e["name"]),
        "d2h_us": sum(e["dur"] for e in copies if "DtoH" in e["name"]),
    }


def dbg_batch(res) -> gt.SolveResult:
    """A single solve's result as a batch of one, for check_iters."""
    return gt.SolveResult(*(t[None] for t in res))


def untraced_split(csr) -> dict:
    """linsys_solve's steps (testiters=1) on host clocks without a
    profiler, medians of 7 calls in us: packing (infer_spec, pack_kkt),
    staging (the copies and a device synchronisation), the solve call, the
    wait for the card, the copy back (lam_flat, dz_flat)."""
    opts = gt.SolverOptions(exit_tol=EXIT_TOL, max_iters=MAX_ITERS, rho=RHO)
    parts = []
    for _ in range(7):
        t = [time.perf_counter()]
        spec = gt.infer_spec(csr.C_row, csr.g, csr.c)
        blocks = gt.pack_kkt(spec, csr.G_row, csr.G_col, csr.G_val, csr.C_row, csr.C_col,
                             csr.C_val, csr.g, csr.c)
        t.append(time.perf_counter())
        staged = gt.blocks_to_torch(blocks, DEV)
        lam = torch.zeros(spec.knot_points, spec.state_size, device=DEV)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        res = gt.solve(spec, staged, opts, lam0=lam)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        res.lam_flat(), res.dz_flat()
        t.append(time.perf_counter())
        parts.append(np.diff(t) * 1e6)
    med = np.median(np.array(parts), axis=0)
    return dict(zip(("host_packing_us", "staging_us", "solve_call_us", "wait_us",
                     "copy_back_us"), map(float, med)), total_us=float(med.sum()))


def phase_measurement_path():
    print("== phase 4g: the measurement path: timing.time_solve, debug.solve_debug, "
          "debug.trace around linsys_solve, probe_dispatch, probe_iter_floor, "
          "probe_throughput A and D (reduced R), with the probes' launch counts")
    zero_probe_counts()
    out = {}
    one = testing.random_blocks(IIWA, seed=8300)
    staged = gt.blocks_to_torch(one, DEV)
    for label, backend, method, T in (("fused", "fused", "pcg", 16),
                                      ("pcg_kernel", "pcg_kernel", "pcg", 4),
                                      ("direct", None, "direct", 16)):
        opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS,
                                method=method)
        ms, info = gtiming.time_solve(IIWA, one, opts, backend, T=T, reps=3,
                                      min_diff_ms=1.0)
        reads, syncs = host_reads(lambda: gt.solve(IIWA, staged, opts, pcg_backend=backend))
        out[("time_solve", label)] = (ms, info, reads, syncs)
        print(f"  time_solve IIWA B=1 {label}: {ms:.4f} ms a solve (T={info['T']}, "
              f"estimates {info['reps_ms']}); one solve reads {reads} scalars and "
              f"synchronises {syncs} times on the host")
    batch = testing.random_batch(IIWA, BATCH, seed0=8400)
    opts = gt.SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    ms, info = gtiming.time_solve(IIWA, batch, opts, T=8, reps=3, min_diff_ms=1.0)
    out[("time_solve", "b256")] = (ms, info)
    print(f"  time_solve IIWA B={BATCH} (auto = fused): {ms:.4f} ms a batch (T="
          f"{info['T']}, estimates {info['reps_ms']})")
    print(f"  measure_rtt_ms: {gtiming.measure_rtt_ms(5):.4f} ms")

    dbg = gdebug.solve_debug(IIWA, one, opts)
    ref = gt.solve(IIWA, one, opts)
    ties = check_iters("solve_debug vs solve", dbg_batch(dbg.result), dbg_batch(ref),
                       EXIT_TOL)
    err = check_scaled("solve_debug lam", dbg.result.lam, ref.lam, TOL)
    hist = dbg.eta_history
    if hist.shape != (MAX_ITERS + 1,) or not bool(torch.isfinite(hist).all()):
        raise AssertionError(f"solve_debug eta history {tuple(hist.shape)} not finite")
    print(f"  solve_debug IIWA against solve (kernel B): {int(dbg.result.iters)} "
          f"iterations both ({ties} ties), lam within {err:.2e}; true residual "
          f"{float(dbg.final_residual_norm):.3e}")

    csr = testing.blocks_to_csr(IIWA, one)
    args = (csr.G_row, csr.G_col, csr.G_val, csr.C_row, csr.C_col, csr.C_val, csr.g,
            csr.c, [0.0] * IIWA.nl, 1, EXIT_TOL, MAX_ITERS, False, RHO)
    Path("build").mkdir(exist_ok=True)
    tdir = tempfile.mkdtemp(prefix="trace_", dir="build")
    gnative.CALLS = 0
    gt.linsys_solve(*args, verbose=False)
    if gnative.CALLS != 2:
        raise AssertionError(f"linsys_solve made {gnative.CALLS} native packer calls, "
                             "not 2 (G and C): the native packer did not serve it")
    print(f"  linsys_solve packed through the native packer ({gnative.library_path().name}"
          f"): {gnative.CALLS} native calls")

    def session():
        with gdebug.trace(tdir, with_stack=True) as prof:
            gt.linsys_solve(*args, verbose=False)
        return prof
    prof = profiled(session)
    if not any("fused_solve_kernel" in e.key for e in prof.key_averages()):
        raise AssertionError("trace of linsys_solve names no fused_solve_kernel")
    print(f"  trace of one IIWA linsys_solve (with Python stacks) names kernel B's "
          f"symbol; written to {tdir}")
    out["split"] = linsys_split(lambda: gt.linsys_solve(*args, verbose=False))
    out["untraced"] = untraced_split(csr)
    gformats.USE_NATIVE = False
    try:
        out["untraced_numpy"] = untraced_split(csr)
    finally:
        gformats.USE_NATIVE = True
    out["packing"] = packing_times()

    out["dispatch"] = probe_dispatch.probe_dispatch(calls=200, T=64, reps=3)
    for scope, R in (("block", 2000), ("grid", 500)):
        out[("null", scope)] = probe_iter_floor.probe_null(scope, R=R, reps=3)
        out[("real", scope)] = probe_iter_floor.probe_real(scope, T=16, reps=3)
    out["A"] = probe_throughput.probe_A(T=4, reps=3)
    out["D"] = probe_throughput.probe_D(R=5000, reps=3)
    for key in ("dispatch", ("null", "block"), ("real", "block"), ("null", "grid"),
                ("real", "grid"), "A", "D"):
        print(f"  {json.dumps(out[key])}")
    for scope in ("block", "grid"):
        out[("summary", scope)] = probe_iter_floor.summary(out[("null", scope)],
                                                           out[("real", scope)])
        print(f"  {json.dumps(out[('summary', scope)])}")
    out["launches"] = probe_counts()
    print(f"  launches on the measurement path: {out['launches']}")
    for name, count in out["launches"].items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the measurement path")
    return out


def chain_flops(K: int, s: int, n_mv: int, n_dot: int, trips: int) -> float:
    """Row 16's operations on one problem: the scaled operator once; a
    matvec 2 s per block row of its 3 K - 2 blocks a row and 3 a row for
    0.25 acc + 0.5 y; a dot 2 a row for y^2 and its sum, 3 for the axpy."""
    mv = 2 * s * s * (3 * K - 2) + 3 * K * s
    return 3 * K * s * s + trips * (n_mv * mv + n_dot * 5 * K * s)


def fma_flops(K: int, s: int, depth: int, trips: int) -> float:
    """Row 17's operations on one problem: the scaled operator once, then a
    matvec's 2 s + 2 a row (probe_throughput.fma_rates)."""
    return K * s * s + trips * depth * K * s * (2 * s + 2)


def phase_probe_times(card: str, meas: dict):
    print(f"== phase 5g: the probes' times beside their bounds (CUDA events, median of "
          f"{TIMING_RUNS} runs; device times of one launch from 50 in a CUDA graph) and "
          f"the measurement path's numbers, on {card}")
    s = IIWA.state_size
    times = {}
    q = gt.blocks_to_torch(testing.random_batch(IIWA, 1, seed0=8500), DEV).q
    kern = lambda: kp.null_copy_cuda(q)  # noqa: E731
    plain = lambda: kp.null_copy_plain(q)  # noqa: E731
    dev_t = {n: graph_ms_per_call(f) for n, f in (("kernel", kern), ("plain", plain))}
    call_t = {n: cuda_median_ms(f) for n, f in (("kernel", kern), ("plain", plain))}
    bound_ms, bound_by = bound(2 * nbytes(q), q.numel())
    # The plain version is the library call q * 1.0000001 itself.
    times[kp.COPY_NAME] = dict(ms=dev_t["kernel"], plain_ms=dev_t["plain"],
                               library_ms=dev_t["plain"], bound_ms=bound_ms,
                               bound_by=bound_by, call_ms=call_t["kernel"],
                               plain_call_ms=call_t["plain"], batch=1)
    for name, scope, K in ((kp.CHAIN_BLOCK_NAME, "block", 50),
                           (kp.CHAIN_GRID_NAME, "grid", 1024)):
        M, y0 = kp.chain_operator(1, K, s, seed=8600 + K, device=DEV)
        kw = dict(n_mv=2, n_dot=2, trips=PROBE_TRIPS)
        k_ms = cuda_median_ms(lambda: kp.null_chain_cuda(M, y0, scope=scope, **kw))
        p_ms = cuda_median_ms(lambda: kp.null_chain_plain(M, y0, **kw), runs=SLOW_RUNS,
                              warmup=1)
        b_ms, b_by = bound(nbytes(M, y0, y0), chain_flops(K, s, **kw))
        times[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                           bound_by=b_by, K=K, n_mv=2, n_dot=2, trips=PROBE_TRIPS)
    M, y0 = kp.fma_operator(1, 50, seed=8700, device=DEV)
    kw = dict(depth=2, trips=PROBE_TRIPS)
    k_ms = cuda_median_ms(lambda: kp.fma_chain_cuda(M, y0, **kw))
    p_ms = cuda_median_ms(lambda: kp.fma_chain_plain(M, y0, **kw), runs=SLOW_RUNS,
                          warmup=1)
    b_ms, b_by = bound(nbytes(M, y0, y0), fma_flops(50, s, **kw))
    times[kp.FMA_NAME] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                              bound_by=b_by, K=50, depth=2, trips=PROBE_TRIPS,
                              lanes=kp.fma_plan(1, 50).lanes)
    for name, r in times.items():
        print(f"  {name}: kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"{r['library_ms']}, bound {r['bound_ms']:.7f} ms ({r['bound_by']}; "
              f"{100 * r['bound_ms'] / r['ms']:.2f} % of the kernel's time)  [{card}]")
    # Row 17 runs one CTA: its operations over one SM's share of the rate.
    r = times[kp.FMA_NAME]
    sm_ms = fma_flops(50, s, **kw) / (F32_FLOPS / SMS) * 1e3
    print(f"  {kp.FMA_NAME} (K=50, B=1, {r['lanes']} lanes a knot): one SM's share of the "
          f"float32 rate bounds its one CTA at {sm_ms:.6f} ms ({100 * sm_ms / r['ms']:.2f} % "
          f"of the kernel's time, events with the call's host work)  [{card}]")
    d = meas["dispatch"]
    print(f"  dispatch floor at IIWA B=1: row 18 device {d['kernel_device_us']:.2f} us, "
          f"per call {d['kernel_per_call_us']:.2f} us, chained {d['kernel_chain_us']:.2f} "
          f"us; q * 1.0000001 device {d['torch_device_us']:.2f} us, per call "
          f"{d['torch_per_call_us']:.2f} us, chained {d['torch_chain_us']:.2f} us  [{card}]")
    print("  row 18's call, each step alone (us): " + ", ".join(
        f"{k[6:-3]} {v:.2f}" for k, v in d.items() if k.startswith("split_"))
        + f"  [{card}]")
    for scope in ("block", "grid"):
        n, r = meas[("null", scope)], meas[("real", scope)]
        where = f"C = {n['C']}" if scope == "block" else f"per = {n['per']}"
        print(f"  iteration floor, {scope} scope (K={n['K']}, {where}, halo {n['halo']} "
              f"knots, {n['meetings_a_trip_2_2']} meetings and "
              f"{n['syncthreads_a_trip_2_2']} __syncthreads a trip at (2, 2)): c0 "
              f"{n['c0_ns_per_trip']:.0f} ns, c_mv {n['c_mv_ns']:.0f} ns, c_dot "
              f"{n['c_dot_ns']:.0f} ns; predicted poly-1 iteration "
              f"{n['predicted_poly1_iter_ns']:.0f} ns, measured "
              f"{r['poly1_per_iter_ns']:.0f} ns through time_solve ({r['backend']}, "
              f"K={r['K']}; poly 2 {r['poly2_per_iter_ns']:.0f} ns), the kernel alone "
              f"{r['poly1_kernel_per_iter_ns']:.0f} ns (poly 2 "
              f"{r['poly2_kernel_per_iter_ns']:.0f} ns); kernel / predicted "
              f"{meas[('summary', scope)]['kernel_over_predicted']:.3f}  [{card}]")
    a, dd = meas["A"], meas["D"]
    print(f"  probe A, kernel B at B={a['batch']}: fixed {a['fixed_ms']:.4f} ms, "
          f"{1e3 * a['per_iter_ms_batch']:.2f} us an iteration, full default "
          f"{a['full_default_ms']:.4f} ms ({a['full_us_per_solve']:.3f} us a solve)  [{card}]")
    print(f"  probe D, row 17 at K={dd['K']}: {dd['ns_per_matvec']:.1f} ns a matvec, "
          f"{dd['ns_per_col_fma']:.2f} ns a column FMA, {dd['gflops_one_cta']:.1f} GFLOP/s "
          f"one CTA, {dd['gflops_132_ctas']:.0f} GFLOP/s 132 CTAs "
          f"({100 * dd['share_of_f32_peak_132_ctas']:.2f} % of 67 TFLOP/s); at K=4 "
          f"{dd['K4']['ns_per_matvec']:.1f} ns a matvec; SASS {dd['sass']}  [{card}]")
    for key, st in STAMPS.result()["row17"].items():
        print(f"  row 17's stamps at {key}, 100 trips of depth 2 (us): load {st['load']:.3f}, "
              f"first matvec {st['first']:.3f}, {st['steady_ns_per_matvec']:.1f} ns a matvec "
              f"after it, store {st['store']:.3f}, total {st['total']:.3f}  [{card}]")
    print("  one IIWA linsys_solve from its trace (us): " + ", ".join(
        f"{k[:-3]} {v:.1f}" for k, v in meas["split"].items()) + f"  [{card}]")
    print("  its steps on host clocks without the profiler (us, median of 7): " + ", ".join(
        f"{k[:-3]} {v:.1f}" for k, v in meas["untraced"].items()) + f"  [{card}]")
    print("  the same with the NumPy packer (us, median of 7): " + ", ".join(
        f"{k[:-3]} {v:.1f}" for k, v in meas["untraced_numpy"].items()) + f"  [{card}]")
    for (K, form), r in meas["packing"].items():
        print(f"  host packing IIWA K={K} from {form} (pack_kkt, median of {PACK_RUNS} runs on "
              f"host clocks): native {r['native']:.1f} us, NumPy {r['numpy']:.1f} us "
              f"({r['numpy'] / r['native']:.2f}x); blocks bit-equal  [{card}]")
    for label in ("fused", "pcg_kernel", "direct"):
        ms, _, reads, syncs = meas[("time_solve", label)]
        print(f"  time_solve B=1 {label}: {ms:.4f} ms; {reads} host reads, {syncs} "
              f"synchronisations a solve  [{card}]")
    return times


# --------------------------------------------------------------------------
# Host packing (formats.py through native.py) and the gradient path (diff.py)

PACK_RUNS = 21
GRAD_TOL = 2e-3


def packing_times() -> dict:
    """pack_kkt at IIWA K = 50 and 1024 through the native packer and the
    NumPy path, from Python lists (as linsys_solve receives them) and from
    NumPy arrays: median us of PACK_RUNS calls on host clocks, after one
    call each whose blocks must agree bit for bit."""
    out = {}
    for K in (50, 1024):
        spec = gt.ProblemSpec(IIWA.state_size, IIWA.control_size, K)
        csr = testing.blocks_to_csr(spec, testing.random_blocks(spec, seed=8800 + K))
        lists = (csr.G_row, csr.G_col, csr.G_val, csr.C_row, csr.C_col, csr.C_val,
                 csr.g, csr.c)
        arrays = tuple(np.asarray(a, dtype=np.int64 if i in (0, 1, 3, 4) else np.float64)
                       for i, a in enumerate(lists))
        for form, data in (("lists", lists), ("arrays", arrays)):
            r, blocks = {}, {}
            for label, use in (("native", True), ("numpy", False)):
                gformats.USE_NATIVE = use
                try:
                    blocks[label] = gt.pack_kkt(spec, *data)
                    times = []
                    for _ in range(PACK_RUNS):
                        t0 = time.perf_counter()
                        gt.pack_kkt(spec, *data)
                        times.append((time.perf_counter() - t0) * 1e6)
                finally:
                    gformats.USE_NATIVE = True
                r[label] = float(np.median(times))
            for name, a, b in zip(gt.KKTBlocks._fields, blocks["native"], blocks["numpy"]):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise AssertionError(f"packing K={K} {form}: native {name} differs "
                                         "from the NumPy path")
            out[(K, form)] = r
    return out


def grad_counts() -> dict:
    return {kd.NAME: kd.LAUNCHES, kt.FWD_NAME: kt.FWD_LAUNCHES,
            kt.REV_NAME: kt.REV_LAUNCHES, kt.EPILOGUE_NAME: kt.EPILOGUE_LAUNCHES,
            kl.CONDENSE_NAME: kl.CONDENSE_LAUNCHES, kl.CR_NAME: kl.CR_LAUNCHES,
            kl.PEEL_NAME: kl.PEEL_LAUNCHES, kl.UNPEEL_NAME: kl.UNPEEL_LAUNCHES,
            kl.RECOVER_NAME: kl.RECOVER_LAUNCHES}


def zero_grad_counts() -> None:
    zero_direct_counts()
    zero_direct_longk_counts()


def grad_loss(lam, dz_x, dz_u):
    """tests/test_diff.py's loss."""
    return ((lam * torch.cos(lam)).sum() + (dz_x ** 2).sum()
            + torch.sin(dz_u).sum())


def grad_args(blocks, dtype) -> list:
    """The seven blocks and a 0-d rho on the card, leaves requiring grad."""
    args = [torch.tensor(np.asarray(a), dtype=dtype, device=DEV, requires_grad=True)
            for a in blocks]
    return args + [torch.tensor(RHO, dtype=dtype, device=DEV, requires_grad=True)]


def grad_step(args, single: bool):
    """Forward and backward: the outputs and the eight gradients."""
    out = (gdiff.kkt_solve if single else gdiff.kkt_solve_batched)(*args)
    return out, torch.autograd.grad(grad_loss(*out), args)


@contextlib.contextmanager
def torch_route():
    """diff's routing helper held at the 'torch' backend: the plain route."""
    saved = gdiff._backend
    gdiff._backend = lambda Q, R: "torch"
    try:
        yield
    finally:
        gdiff._backend = saved


def phase_gradients(card: str):
    print("== phase 4h: the gradient path: kkt_solve / kkt_solve_batched, forward and "
          "adjoint solves through the exact kernels, against float64 on the card")
    routes = []
    for what, K, n in (("kkt_solve B=1", 50, 0), ("kkt_solve_batched B=16", 50, 16),
                       (f"kkt_solve_batched B={BATCH}", 50, BATCH),
                       ("kkt_solve K=1024 B=1", 1024, 0),
                       ("kkt_solve_batched K=1024 B=12", 1024, 12)):
        spec = gt.ProblemSpec(IIWA.state_size, IIWA.control_size, K)
        blocks = (testing.random_blocks(spec, seed=9000 + K) if n == 0
                  else testing.random_batch(spec, n, seed0=9000 + K))
        width = max(n, 1)
        if K == 50:
            expect = ({kd.NAME: 2} if width < kt.MIN_BATCH else
                      {kt.FWD_NAME: 2, kt.REV_NAME: 2, kt.EPILOGUE_NAME: 2})
        else:
            expect = {kl.CONDENSE_NAME: 2, kl.CR_NAME: 2, kl.RECOVER_NAME: 2}
            if kl.direct_tier(width, K) == "hybrid":
                expect[kl.PEEL_NAME] = expect[kl.UNPEEL_NAME] = 2 * kl.hybrid_peels(K)
        routes.append((what, spec, blocks, n, expect))
    total = dict.fromkeys(grad_counts(), 0)
    results = {}
    for what, spec, blocks, n, expect in routes:
        args = grad_args(blocks, torch.float32)
        zero_grad_counts()
        out, grads = grad_step(args, n == 0)
        torch.cuda.synchronize()
        got = grad_counts()
        want = {key: expect.get(key, 0) for key in got}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for key, value in got.items():
            total[key] += value
        ref_out, ref_grads = grad_step(grad_args(blocks, torch.float64), n == 0)
        worst = 0.0
        for name, x, y in zip(("lam", "dz_x", "dz_u", "Q_bar", "R_bar", "A_bar", "B_bar",
                               "q_bar", "r_bar", "c_bar", "rho_bar"),
                              (*out, *grads), (*ref_out, *ref_grads)):
            x, y = x.detach(), y.detach()
            if x.dtype != torch.float32 or x.device != DEV or x.shape != y.shape:
                raise AssertionError(f"{what} {name}: {x.dtype} {x.device} "
                                     f"{tuple(x.shape)}, expected float32 on {DEV} "
                                     f"{tuple(y.shape)}")
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{what} {name}: not finite")
            scale = max(1.0, float(y.abs().max()))
            diff = (x.double() - y).abs()
            worst = max(worst, float(diff.max()) / scale)
            if bool((diff > GRAD_TOL * (y.abs() + scale)).any()):
                raise AssertionError(f"{what} {name}: float32 and float64 differ by "
                                     f"{float(diff.max()) / scale:.3e} of scale, past "
                                     f"rtol = atol = {GRAD_TOL}")
        results[what] = (args, n == 0)
        print(f"  {what}: launches {dict((k, v) for k, v in got.items() if v)}; primal and "
              f"all eight gradients within rtol = atol = {GRAD_TOL} of scale of float64 "
              f"on the card (largest difference {worst:.2e} of scale)")
    print(f"  launches on the gradient path: {total}")
    for name in (kd.NAME, kt.FWD_NAME, kt.REV_NAME, kt.EPILOGUE_NAME, kl.CONDENSE_NAME,
                 kl.CR_NAME, kl.PEEL_NAME, kl.UNPEEL_NAME, kl.RECOVER_NAME):
        if total[name] < 1:
            raise AssertionError(f"{name} was not launched on the gradient path")

    print(f"== phase 5h: the gradient path's times (CUDA events, median of {TIMING_RUNS} "
          f"runs; 'torch' route {SLOW_RUNS}), on {card}")
    for what, (args, single) in results.items():
        both = cuda_median_ms(lambda: grad_step(args, single))
        fwd = cuda_median_ms(lambda: (gdiff.kkt_solve if single
                                      else gdiff.kkt_solve_batched)(*args))
        with torch_route():
            plain = cuda_median_ms(lambda: grad_step(args, single), runs=SLOW_RUNS,
                                   warmup=1)
        print(f"  {what}: forward + backward {both:.4f} ms (forward alone {fwd:.4f} ms); "
              f"the 'torch' route in float32 {plain:.4f} ms ({plain / both:.1f}x)  [{card}]")
    return total


def main():
    t_start = time.perf_counter()
    card = card_line()
    print(f"== phase 1: card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 2: build")
    # Rows 5 and 11 by stage (5c, 5e): a child that builds the stamped
    # library beside this build.
    STAMPS.start()
    info = _build.build()
    _build.library()
    STAMPS.wait_built()
    print(f"  {info['path'].name}: built={info['built']} in {info['seconds']:.2f} s "
          f"(the stamped library beside it: both done)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())
    # 5f's profiler sessions, in a child process that ends before this one
    # opens a session of its own; 5f prints them.
    prof = run_profiled_sharded()

    wide_launches = phase_parity()
    phase_sequence_parity()
    phase_direct_parity()
    phase_longk_parity()
    phase_direct_longk_parity()
    phase_halo_parity()
    phase_probe_parity()
    launches, avg = phase_main_path()
    seq_launches = phase_mpc_path()
    direct_launches = phase_direct_path()
    longk_launches = phase_longk_path()
    exact_launches = phase_direct_longk_path()
    sharded_launches = phase_sharded_path()
    packed_dp_launches = phase_packed_dp_path()
    meas = phase_measurement_path()
    grad_launches = phase_gradients(card)
    phase_examples()
    times = phase_times(card)
    anymal_times = wide_times(card)
    seq_times = phase_sequence_times(card)
    direct_times = phase_direct_times(card)
    longk_times, longk_routes = phase_longk_times(card)
    exact_times, exact_routes = phase_direct_longk_times(card)
    sharded_times = phase_sharded_times(card, prof)
    packed_dp_times = phase_packed_dp_times(card)
    probe_times = phase_probe_times(card, meas)
    print(f"  linsys_solve IIWA avg time (printed, testiters=10): fused "
          f"{avg['fused']:.4f} ms, pcg_kernel {avg['pcg_kernel']:.4f} ms  [{card}]")

    # Each kernel's launches are those of the path it is on: kernels A and
    # B from linsys_solve / solve_batched (phase 4), the sequence kernel
    # from the MPC and packed path (phase 4b), rows 4-6 from the exact path
    # (phase 4c), rows 7-10 and 13 from the long-K path (phase 4d), rows 11
    # and 12 and the unpeel kernel from the exact long-K path (phase 4e).
    pair = {f"pair_{key}": value for key, value in
            direct_times[("pair", BATCH)].items() if key != "bound_by"}
    pair.update({f"pair_{key}_b1": value for key, value in
                 direct_times[("pair", 1)].items() if key != "bound_by"})
    kernels = []
    for name, source, replaces, count, at_b, at_1, extra in (
            (ka.NAME, ka.SOURCE, ka.REPLACES, launches[ka.NAME],
             times[(ka.NAME, BATCH)], times[(ka.NAME, 1)], {}),
            (kb.NAME, kb.SOURCE, kb.REPLACES, launches[kb.NAME],
             times[(kb.NAME, BATCH)], times[(kb.NAME, 1)], {}),
            (ks.NAME, ks.SOURCE, ks.REPLACES, seq_launches[ks.NAME],
             seq_times[BATCH], seq_times[1], {"steps": T_STEPS}),
            (kd.NAME, kd.SOURCE, kd.REPLACES, direct_launches[kd.NAME],
             direct_times[(kd.NAME, BATCH)], direct_times[(kd.NAME, 1)], {}),
            (kt.FWD_NAME, kt.SOURCE, kt.FWD_REPLACES,
             direct_launches[kt.FWD_NAME], direct_times[(kt.FWD_NAME, BATCH)],
             direct_times[(kt.FWD_NAME, 1)], pair),
            (kt.REV_NAME, kt.SOURCE, kt.REV_REPLACES,
             direct_launches[kt.REV_NAME], direct_times[(kt.REV_NAME, BATCH)],
             direct_times[(kt.REV_NAME, 1)], pair),
            (kt.EPILOGUE_NAME, kt.SOURCE, kt.REV_REPLACES,
             direct_launches[kt.EPILOGUE_NAME], direct_times[(kt.EPILOGUE_NAME, BATCH)],
             direct_times[(kt.EPILOGUE_NAME, 1)], {})):
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": count,
               "max_abs_err": MAX_ERR[name], **at_b, "batch": BATCH, **extra}
        row.update({f"{key}_b1": value for key, value in at_1.items()
                    if key != "bound_by"})
        if name == kb.NAME:
            for n in CROSSOVER_B:
                row.update({f"{key}_rule_b{n}": value
                            for key, value in times[("rule", n)].items()})
        for tag, table in (("A_rule", times), ("row4_rule", direct_times)):
            if name == (ka.NAME if tag == "A_rule" else kd.NAME):
                for key3, value3 in table.items():
                    if key3[0] == tag:
                        row.update({f"{key}_rule_k{key3[1]}_b{key3[2]}": value
                                    for key, value in value3.items()})
        if name in grad_launches:
            row["launches_grad"] = grad_launches[name]
        kernels.append(row)
    # Kernel B's <36, 12> body: B = 4 (and _b1) at a quadruped's widths;
    # its launches a call of solve_batched's auto route there (phase 3).
    row = {"name": kb.NAME, "instance": "36x12", "sizes": list(ANYMAL), "route": "cuda",
           "source": kb.SOURCE, "replaces": kb.REPLACES, "launches": wide_launches,
           "max_abs_err": MAX_ERR[WIDE_ROW], **anymal_times[4], "batch": 4}
    row.update({f"{key}_b1": value for key, value in anymal_times[1].items()
                if key != "bound_by"})
    kernels.append(row)
    # The long-K kernels: K=1024 at B=16 (and _b1), with K=8192 beside.
    for name, replaces in ((kl.CONDENSE_NAME, kl.CONDENSE_REPLACES),
                           (kl.PCG_NAME, kl.PCG_REPLACES),
                           (kl.FUSED_NAME, kl.FUSED_REPLACES),
                           (kl.RECOVER_NAME, kl.RECOVER_REPLACES)):
        row = {"name": name, "route": "cuda", "source": kl.SOURCE,
               "replaces": replaces, "launches": longk_launches[name],
               "max_abs_err": MAX_ERR[name], **longk_times[(name, 1024, 16)],
               "batch": 16, "K": 1024}
        if name in grad_launches:
            row["launches_grad"] = grad_launches[name]
        for K, n in ((1024, 1), (8192, 1), (8192, 16)):
            row.update({f"{key}_k{K}_b{n}": value for key, value in
                        longk_times[(name, K, n)].items() if key != "bound_by"})
        if name == kl.PCG_NAME:
            # Row 14's shape (gato_tpu's pcg_streamed), which this kernel serves.
            row.update({f"{key}_k16384_b1": value for key, value in
                        exact_routes["row14"].items() if key != "bound_by"})
        kernels.append(row)
    # The long-K exact kernels: K=1024 at B=15 (and _b1), with K=8192 beside;
    # their launches from the exact long-K path (phase 4e).
    for name, replaces in ((kl.CR_NAME, kl.CR_REPLACES),
                           (kl.PEEL_NAME, kl.PEEL_REPLACES),
                           (kl.UNPEEL_NAME, kl.UNPEEL_REPLACES)):
        row = {"name": name, "route": "cuda", "source": kl.DIRECT_SOURCE,
               "replaces": replaces, "launches": exact_launches[name],
               "max_abs_err": MAX_ERR[name], **exact_times[(name, 1024, 15)],
               "batch": 15, "K": 1024, "launches_grad": grad_launches[name]}
        for K, n in ((1024, 1), (8192, 1), (8192, 15)):
            row.update({f"{key}_k{K}_b{n}": value for key, value in
                        exact_times[(name, K, n)].items() if key != "bound_by"})
        kernels.append(row)
    # Row 15: Kl = 256 (K = 1024 on four shards), with Kl = 2048 (K = 8192)
    # beside; its launches from the knot-sharded path (phase 4f).
    row = {"name": hm.NAME, "route": "cuda", "source": hm.SOURCE,
           "replaces": hm.REPLACES, "launches": sharded_launches[hm.NAME],
           "max_abs_err": MAX_ERR[hm.NAME], **sharded_times[(hm.NAME, 256)],
           "Kl": 256}
    row.update({f"{key}_kl2048": value for key, value in
                sharded_times[(hm.NAME, 2048)].items() if key != "bound_by"})
    kernels.append(row)
    # Rows 16, 17 and 18: their launches from the measurement path (phase 4g).
    for name, replaces in ((kp.CHAIN_BLOCK_NAME, kp.CHAIN_REPLACES),
                           (kp.CHAIN_GRID_NAME, kp.CHAIN_REPLACES),
                           (kp.FMA_NAME, kp.FMA_REPLACES),
                           (kp.COPY_NAME, kp.COPY_REPLACES)):
        kernels.append({"name": name, "route": "cuda", "source": kp.SOURCE,
                        "replaces": replaces, "launches": meas["launches"][name],
                        "max_abs_err": MAX_ERR[name], **probe_times[name]})
    for K in SHARD_K:
        print(f"  solve_sharded K={K}: " + ", ".join(
            f"n={n} kernel {sharded_times[('sharded', K, n)]['kernel']:.4f} / torch "
            f"{sharded_times[('sharded', K, n)]['torch']:.4f} ms" for n in SHARD_N)
            + f"; single-device solve {sharded_times[('single', K)]:.4f} ms; "
            f"{1e3 * sharded_times[('iteration', K)]:.1f} us a sharded iteration at n=4")
    for label, row in packed_dp_times.items():
        print(f"  solve_packed_dp {label}: " + ", ".join(
            f"n={n} {row[n]:.4f}" for n in PACKED_DP_N)
            + f" ms; solve_packed {min(row['solve_packed']):.4f} ms")
    print(f"  launches on the solve_packed_dp path: "
          f"{({k: v for k, v in packed_dp_launches.items() if v})}")
    for (K, n), (f_ms, x_ms) in longk_routes.items():
        print(f"  long-K route K={K} B={n}: fused_xl {f_ms:.4f} ms, xl {x_ms:.4f} ms")
    for key, r in exact_routes.items():
        if key != "row14":
            print(f"  long-K exact route K={key[0]} B={key[1]}: xl {r['xl']:.4f} ms, "
                  f"hybrid {r['hybrid']:.4f} ms, bound {r['bound_ms']:.5f} ms")
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--profiled"]:
        print(json.dumps(profiled_sharded()))
    else:
        try:
            main()
        finally:
            STAMPS.stop()

"""Drive gato_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. require CUDA; print the card's name and power limit; turn TF32 off so the
   plain PyTorch versions run in full float32;
2. build the CUDA kernels from gato_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at IIWA
   (state 14, control 7, K=50; data from testing.random_blocks), B=1 and
   B=256: the PCG kernel (A) against pcg.pcg, the fused solve (B) against
   condense -> pcg -> recover_dz for all three preconditioners and
   precond_poly_degree 1 and 2, and one exactly singular input;
4. the main path through the user entry points: linsys_solve on the
   pendulum (the original's gate) and at IIWA (against the dense float64
   oracle), solve_batched at B=256, with each kernel's launch count;
5. times with CUDA events, medians of 25 runs after warm-up.

The line before the last is the card's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "needs one CUDA card")

import gato_tpu_torch as gt  # noqa: E402
from gato_tpu_torch import assemble, testing  # noqa: E402
from gato_tpu_torch.kernels import _build  # noqa: E402
from gato_tpu_torch.kernels import fused_solve as kb  # noqa: E402
from gato_tpu_torch.kernels import pcg_kernel as ka  # noqa: E402

DEV = torch.device("cuda", 0)
IIWA = testing.IIWA
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

MAX_ERR = {ka.NAME: 0.0, kb.NAME: 0.0}


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
    ki = k_res.iters.cpu().numpy()
    pi = p_res.iters.cpu().numpy()
    ke = k_res.eta.double().cpu().numpy()
    pe = p_res.eta.double().cpu().numpy()
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
                kres, kdx, kdu = kb.fused_solve_cuda(*blocks, lam0, **kw)
                pres, pdx, pdu = kb.fused_solve_plain(*blocks, lam0, **kw)
                torch.cuda.synchronize()
                what = f"{kb.NAME} B={n} {prec} poly={poly} max_iters={cap}"
                ties = check_iters(what, kres, pres, EXIT_TOL)
                err = max(check_close(what + " lam", kres.lam, pres.lam),
                          check_close(what + " dz_x", kdx, pdx),
                          check_close(what + " dz_u", kdu, pdu))
                MAX_ERR[kb.NAME] = max(MAX_ERR[kb.NAME], err)
                it = kres.iters.cpu().numpy()
                print(f"  {what}: iters {it.min()}..{it.max()} equal "
                      f"({ties} ties), max|d| {err:.3e}")

    # One exactly singular problem (zero row/column in Q[2], rho=0) among
    # healthy ones: only it is frozen, unconverged, at max_iters, eta 1e30.
    bad = testing.singular_blocks(IIWA, seed=3, knot=2)
    mix = testing.stack_blocks([testing.random_blocks(IIWA, seed=40), bad,
                                testing.random_blocks(IIWA, seed=41)])
    blocks = gt.blocks_to_torch(mix, DEV)
    lam0 = torch.zeros_like(blocks.q)
    kw = dict(rho=0.0, exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
    kres, kdx, kdu = kb.fused_solve_cuda(*blocks, lam0, **kw)
    pres, pdx, pdu = kb.fused_solve_plain(*blocks, lam0, **kw)
    torch.cuda.synchronize()
    conv = kres.converged.cpu().tolist()
    if conv != [True, False, True] or int(kres.iters[1]) != MAX_ITERS \
            or float(kres.eta[1]) != float(np.float32(1e30)):
        raise AssertionError(f"singular input: converged {conv}, iters "
                             f"{kres.iters.tolist()}, eta {kres.eta.tolist()}")
    check_iters(f"{kb.NAME} singular mix", kres, pres, EXIT_TOL)
    for name, k, p in (("lam", kres.lam, pres.lam), ("dz_x", kdx, pdx),
                       ("dz_u", kdu, pdu)):
        check_close(f"{kb.NAME} singular mix {name}", k, p)
    print(f"  {kb.NAME} singular input: converged {conv}, iters "
          f"{kres.iters.tolist()}, eta[1] = {float(kres.eta[1]):g} "
          "(plain version agrees)")


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
        print(f"  IIWA linsys_solve (backend {backend or 'auto = fused'}, "
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
    print(f"  solve_batched B={BATCH}: finite, all converged, iters "
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


def phase_times(card: str):
    print(f"== phase 5: times (CUDA events, median of {TIMING_RUNS} runs "
          f"after warm-up) on {card}")
    full, lam0_full = staged_batch(BATCH)
    times = {}
    for n in (1, BATCH):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        lam0 = lam0_full[:n]
        sys_ = assemble.condense(*blocks, RHO)
        pkw = dict(exit_tol=EXIT_TOL, max_iters=MAX_ITERS)
        fkw = dict(rho=RHO, **pkw)
        rows = (
            (ka.NAME, lambda: ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, lam0, **pkw),
             lambda: ka.pcg_batched_plain(sys_.S, sys_.Pinv, sys_.gamma, lam0, **pkw)),
            (kb.NAME, lambda: kb.fused_solve_cuda(*blocks, lam0, **fkw),
             lambda: kb.fused_solve_plain(*blocks, lam0, **fkw)),
        )
        for name, kern, plain in rows:
            # plain, kernel, kernel, plain; each time is the mean of its pair
            p1 = cuda_median_ms(plain)
            k1 = cuda_median_ms(kern)
            k2 = cuda_median_ms(kern)
            p2 = cuda_median_ms(plain)
            times[(name, n)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"  {name} B={n}: kernel {k1:.4f} / {k2:.4f} ms, plain "
                  f"{p1:.4f} / {p2:.4f} ms  [{card}]")
    return times


def main():
    t_start = time.perf_counter()
    card = card_line()
    print(f"== phase 1: card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 2: build")
    info = _build.build()
    _build.library()
    print(f"  {info['path'].name}: built={info['built']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())

    phase_parity()
    launches, avg = phase_main_path()
    times = phase_times(card)
    print(f"  linsys_solve IIWA avg time (printed, testiters=10): fused "
          f"{avg['fused']:.4f} ms, pcg_kernel {avg['pcg_kernel']:.4f} ms  [{card}]")

    kernels = []
    for mod in (ka, kb):
        k256, p256 = times[(mod.NAME, BATCH)]
        k1, p1 = times[(mod.NAME, 1)]
        kernels.append({
            "name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches[mod.NAME],
            "max_abs_err": MAX_ERR[mod.NAME],
            "ms": k256, "plain_ms": p256, "batch": BATCH,
            "ms_b1": k1, "plain_ms_b1": p1,
        })
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Observability: debug solves, residual histories, profiling hooks.

The port of ``gato_tpu.debug``.  The original's observability is printf
gated by compile-time flags plus matrix dumps and cudaEvent spans; here the
equivalents are runtime functions returning data:

  * :func:`solve_debug` — a full solve that also returns the condensed system
    (S, Pinv, gamma, Qinv, Rinv), the per-iteration PCG residual history, and
    the true unpreconditioned residual of the returned solution.
  * :func:`residual_history` — PCG trace on an already-condensed system.
  * :func:`trace` — a ``torch.profiler`` span that writes a Chrome trace
    (view it in chrome://tracing or Perfetto) and yields the profiler, whose
    ``key_averages()`` sums the time by operation and by CUDA kernel.
  * module ``logging`` via the standard library (logger name
    "gato_tpu_torch").
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import NamedTuple

import torch

from . import assemble, recover
from .blocktri import btd_matvec
from .formats import KKTBlocks, blocks_to_torch, check_block_shapes
from .pcg import _dot
from .problem import ProblemSpec, SolverOptions
from .solver import SolveResult, _torch_dtype, resolve_device

logger = logging.getLogger("gato_tpu_torch")


class DebugResult(NamedTuple):
    result: SolveResult
    system: assemble.SchurSystem   # S, Pinv, gamma, Qinv, Rinv
    eta_history: torch.Tensor      # (max_iters+1,) |r.Pinv.r| per iteration
                                   # (padded with the final value after exit)
    final_residual_norm: torch.Tensor  # ||gamma - S lam||_2 (true residual)


def residual_history(S, Pinv, gamma, lam0=None, *, exit_tol=1e-6,
                     max_iters=100, poly_degree=1):
    """PCG with a recorded eta trace.  A fixed-length loop (masked after
    convergence, so it reads nothing back to the host) whose history has
    max_iters + 1 entries.  ``poly_degree`` composes the preconditioner
    exactly as pcg.pcg does, so the trace (and the derived iteration count)
    matches solve() at any degree.  Returns (lam, history, converged)."""

    def apply_P(rv):
        y = btd_matvec(Pinv, rv)
        for _ in range(poly_degree - 1):
            y = y + btd_matvec(Pinv, rv - btd_matvec(S, y))
        return y

    if lam0 is None:
        lam0 = torch.zeros_like(gamma)
    zero = torch.zeros((), dtype=gamma.dtype, device=gamma.device)
    lam = lam0
    r = gamma - btd_matvec(S, lam0)
    p = apply_P(r)
    eta = _dot(r, p)
    converged = torch.zeros(eta.shape, dtype=torch.bool, device=eta.device)
    hist = [eta.abs()]
    for _ in range(int(max_iters)):
        live = ~converged
        upsilon = btd_matvec(S, p)
        nu = _dot(p, upsilon)
        alpha = torch.where(nu != 0, eta / nu, zero)
        lam_n = lam + alpha[..., None, None] * p
        r_n = r - alpha[..., None, None] * upsilon
        r_tilde = apply_P(r_n)
        eta_new = _dot(r_n, r_tilde)
        conv_now = eta_new.abs() < exit_tol
        beta = torch.where(eta != 0, eta_new / eta, zero)
        p_n = r_tilde + beta[..., None, None] * p
        lv = live[..., None, None]
        lam = torch.where(lv, lam_n, lam)
        r = torch.where(lv, r_n, r)
        p = torch.where(lv, p_n, p)
        eta = torch.where(live, eta_new, eta)
        converged = converged | conv_now
        hist.append(eta.abs())
    return lam, torch.stack(hist), converged


def solve_debug(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0=None,
    *,
    device="cuda",
) -> DebugResult:
    """Instrumented solve: everything the original's GATO_PRINTING dumps
    (dense S, Pinv, gamma) plus the residual history, returned as tensors
    instead of printed.  Plain PyTorch ops on ``device`` (default "cuda",
    which raises without a card; pass "cpu" for the CPU)."""
    dev = resolve_device(device)
    dtype = _torch_dtype(options.dtype)
    b = blocks_to_torch(blocks, dev, dtype)
    check_block_shapes(spec, b)
    K, s = spec.knot_points, spec.state_size
    if lam0 is None or not options.warm_start:
        lam0 = torch.zeros((K, s), dtype=dtype, device=dev)
    else:
        lam0 = torch.as_tensor(lam0, dtype=dtype, device=dev).reshape(K, s)

    sys = assemble.condense(*b, options.rho, options.preconditioner)
    lam, hist, conv = residual_history(
        sys.S, sys.Pinv, sys.gamma, lam0,
        exit_tol=options.exit_tol, max_iters=options.max_iters,
        poly_degree=options.precond_poly_degree,
    )
    below = (hist[1:] < options.exit_tol).to(torch.int32)
    first = torch.argmax(below) if below.numel() else torch.zeros((), dtype=torch.int64)
    iters = torch.where(below.any(), first,
                        torch.full_like(first, int(options.max_iters))).to(torch.int32)
    dz_x, dz_u = recover.recover_dz(sys.Qinv, sys.Rinv, b.A, b.B, b.q, b.r, lam)
    true_res = torch.linalg.norm(sys.gamma - btd_matvec(sys.S, lam))
    result = SolveResult(lam=lam, dz_x=dz_x, dz_u=dz_u, iters=iters,
                         converged=conv, eta=hist[-1])
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("solve_debug %s: iters=%s converged=%s true_residual=%s",
                     spec, int(iters), bool(conv), float(true_res))
    return DebugResult(result=result, system=sys, eta_history=hist,
                       final_residual_norm=true_res)


@contextlib.contextmanager
def trace(log_dir: str, *, device="cuda", with_stack: bool = False):
    """A ``torch.profiler`` span (the cudaEvent/GATO_TIMING analog).

    Records CPU activity and, for ``device`` "cuda" (the default, which
    raises without a card), CUDA activity; yields the profiler, and on exit
    writes a Chrome trace into ``log_dir``.  ``with_stack`` also records the
    Python functions that ran, so the trace splits a call by function.
    Raises if the profiler fails, and on a CUDA run if it recorded no CUDA
    activity (rather than writing an empty trace).  Usage::

        with gato_tpu_torch.debug.trace("traces") as prof:
            solve(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev.type == "cuda" and not any(
            e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
        raise RuntimeError("trace: torch.profiler recorded no CUDA activity on a "
                           "CUDA run (is CUPTI available?)")
    path = os.path.join(log_dir, f"gato_tpu_torch_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"trace: torch.profiler wrote an empty trace to {path}")
    logger.info("profiler trace written to %s", path)

"""Row 3: a warm-started MPC farm as one hand-written CUDA kernel.

Replaces the inner ``kernel`` of
``gato_tpu/kernels/fused_solve.py::_call_fused_sequence`` (entry points
``solve_fused_sequence_batched`` and ``solve_fused_sequence``): for each of
B streams, T dependent whole solves, step t warm-started from step t-1's
multipliers (``lam0`` at t = 0) and regularised by ``rhos[t]``.  The CUDA
source is ``gato_tpu_torch/csrc/fused_sequence.cu``; its note gives the
design: one thread block per stream walks t = 0..T-1 through kernel B's
body (``fused_body.cuh``), the carry passing through the global output of
step t-1, one scratch slice per stream reused by its steps, and the
zero-pivot flag cleared at every step.  One launch serves the whole farm.

:func:`fused_sequence_cuda` takes tensors on a CUDA device to the kernel
and raises if the kernel cannot take them; tensors on the CPU go to the
plain version, :func:`fused_sequence_plain`: a loop over t of kernel B's
plain version with the carry.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..pcg import PCGResult
from . import _build
from .fused_solve import (PRECOND_CODES, block_shapes, check_kernel_limits,
                          check_tensors, fused_solve_plain)

NAME = "fused_sequence_cuda"
SOURCE = "gato_tpu_torch/csrc/fused_sequence.cu"
REPLACES = "gato_tpu/kernels/fused_solve.py:732"

LAUNCHES = 0


def fused_sequence_plain(Q, R, A, B, q, r, c, lam0, rhos, *, exit_tol=1e-6,
                         max_iters=100, poly_degree=1,
                         preconditioner="symmetric_stair"):
    """The kernel's plain PyTorch version: kernel B's plain version step by
    step, each step warm-started from the last.  Returns (PCGResult with
    (T, B) axes, dz_x (T, B, K, s), dz_u (T, B, K-1, c))."""
    steps = []
    lam = lam0
    for t, rho in enumerate(rhos.tolist()):
        res, dz_x, dz_u = fused_solve_plain(
            Q[t], R[t], A[t], B[t], q[t], r[t], c[t], lam, rho=rho,
            exit_tol=exit_tol, max_iters=max_iters, poly_degree=poly_degree,
            preconditioner=preconditioner)
        steps.append((res, dz_x, dz_u))
        lam = res.lam
    res = PCGResult(*(torch.stack([st[0][i] for st in steps]) for i in range(4)))
    return (res, torch.stack([st[1] for st in steps]),
            torch.stack([st[2] for st in steps]))


def fused_sequence_cuda(
    Q, R, A, B, q, r, c, lam0, rhos, *,
    exit_tol: float = 1e-6, max_iters: int = 100, poly_degree: int = 1,
    preconditioner: str = "symmetric_stair",
):
    """T warm-started whole solves for each of B streams.

    The seven block arguments follow ``formats.KKTBlocks`` with leading
    (T, B) axes; ``lam0`` is (B, K, s) and ``rhos`` (T,).  Returns
    (PCGResult with (T, B) axes, dz_x (T, B, K, s), dz_u (T, B, K-1, c)).
    A step whose condensation met a zero pivot in a live Q or R block
    reports iters = max_iters, converged False and eta = 1e30, and passes
    its lambda_0 on to the next step unchanged."""
    if preconditioner not in PRECOND_CODES:
        raise ValueError(f"unknown preconditioner {preconditioner!r}; valid: "
                         f"{sorted(PRECOND_CODES)}")
    if Q.ndim != 5 or Q.shape[0] < 1:
        raise ValueError(f"{NAME}: Q must be (T, B, K, s, s) with T >= 1, got "
                         f"{tuple(Q.shape)}")
    if q.device.type == "cpu":
        return fused_sequence_plain(Q, R, A, B, q, r, c, lam0, rhos,
                                    exit_tol=exit_tol, max_iters=max_iters,
                                    poly_degree=poly_degree,
                                    preconditioner=preconditioner)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {q.device} are neither CPU nor CUDA")
    T, Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = dict(block_shapes((T, Bn), K, s, cdim), lam0=(Bn, K, s),
                  rhos=(T,))
    tensors = dict(zip(expect, (Q, R, A, B, q, r, c, lam0, rhos)))
    check_tensors(NAME, expect, tensors, q.device)
    lib = check_kernel_limits(NAME, K, s, cdim, poly_degree, q.device)
    Q, R, A, B, q, r, c, lam0, rhos = (t.contiguous() for t in tensors.values())
    dev = q.device
    # One scratch slice per stream: its T steps run one after another.
    scratch = torch.empty(Bn, lib.gato_fused_scratch_floats(K, s, cdim),
                          dtype=torch.float32, device=dev)
    lam = torch.empty_like(q)
    dz_x = torch.empty_like(q)
    dz_u = torch.empty_like(r)
    iters = torch.empty(T, Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(T, Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(T, Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gato_fused_sequence(
                *map(_build.ptr, (Q, R, A, B, q, r, c, lam0, rhos, scratch,
                                  lam, dz_x, dz_u, iters, conv, eta)),
                T, Bn, K, s, cdim, float(exit_tol), int(max_iters),
                poly_degree, PRECOND_CODES[preconditioner],
                ctypes.c_void_p(stream))
        _build.check_launch(code, NAME)
        global LAUNCHES
        LAUNCHES += 1
    res = PCGResult(lam=lam, iters=iters, converged=conv != 0, eta=eta)
    return res, dz_x, dz_u

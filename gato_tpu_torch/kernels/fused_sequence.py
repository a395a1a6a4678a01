"""Row 3: a warm-started MPC farm as one hand-written CUDA kernel.

Replaces the inner ``kernel`` of
``gato_tpu/kernels/fused_solve.py::_call_fused_sequence`` (entry points
``solve_fused_sequence_batched`` and ``solve_fused_sequence``): for each of
B streams, T dependent whole solves, step t warm-started from step t-1's
multipliers (``lam0`` at t = 0) and regularised by ``rhos[t]``.  The CUDA
source is ``gato_tpu_torch/csrc/fused_sequence.cu``; its note gives the
design: one thread-block cluster a stream walks t = 0..T-1 through kernel
B's body (``cluster_body.cuh``), the carry kept in the CTAs' shared
memory, a stream's records reused by its steps, and the zero-pivot flag
cleared at every step.  The cluster size is kernel B's rule
(``fused_solve.cluster_size``) of the stream count, so a farm equals B-wide
chained kernel-B launches bit for bit.  One launch serves the whole farm.

:func:`fused_sequence_cuda` takes tensors on a CUDA device to the kernel
and raises if the kernel cannot take them; tensors on the CPU go to the
plain version, :func:`fused_sequence_plain`: a loop over t of kernel B's
plain version with the carry.  ``LAUNCHES`` counts the kernel's launches,
``LAST_CLUSTER`` holds the C of the last.  The kernel takes s, c <= 32
(:func:`fits`): kernel B's wide pairs are not compiled into it.
"""

from __future__ import annotations

import torch

from ..pcg import PCGResult
from . import _build
from . import fused_solve
from .fused_solve import (PRECOND_CODES, block_shapes, fused_solve_plain,
                          launch_plan, outputs, record_floats)

NAME = "fused_sequence_cuda"
SOURCE = "gato_tpu_torch/csrc/fused_sequence.cu"
REPLACES = "gato_tpu/kernels/fused_solve.py:732"

LAUNCHES = 0
LAST_CLUSTER = None


def fits(K: int, s: int, cdim: int, smem_limit: int) -> bool:
    """True iff the kernel serves (K, s, c) under ``smem_limit`` bytes of
    shared memory a block: kernel B's horizons (``fused_solve.fits``) at
    s, c <= MAX_BLOCK: none of kernel B's wide pairs."""
    return fused_solve.fits(K, s, cdim, smem_limit, wide=())


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
    preconditioner: str = "symmetric_stair", cluster=None,
):
    """T warm-started whole solves for each of B streams.

    The seven block arguments follow ``formats.KKTBlocks`` with leading
    (T, B) axes; ``lam0`` is (B, K, s) and ``rhos`` (T,).  Returns
    (PCGResult with (T, B) axes, dz_x (T, B, K, s), dz_u (T, B, K-1, c)).
    A step whose condensation met a zero pivot in a live Q or R block
    reports iters = max_iters, converged False and eta = 1e30, and passes
    its lambda_0 on to the next step unchanged.  ``cluster`` forces the
    cluster size as in ``fused_solve.fused_solve_cuda``."""
    if preconditioner not in PRECOND_CODES:
        raise ValueError(f"unknown preconditioner {preconditioner!r}; valid: "
                         f"{sorted(PRECOND_CODES)}")
    if Q.ndim != 5 or Q.shape[0] < 1:
        raise ValueError(f"{NAME}: Q must be (T, B, K, s, s) with T >= 1, got "
                         f"{tuple(Q.shape)}")
    dev = q.device
    if dev.type == "cpu":
        return fused_sequence_plain(Q, R, A, B, q, r, c, lam0, rhos,
                                    exit_tol=exit_tol, max_iters=max_iters,
                                    poly_degree=poly_degree,
                                    preconditioner=preconditioner)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {dev} are neither CPU nor CUDA")
    T, Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = dict(block_shapes((T, Bn), K, s, cdim), lam0=(Bn, K, s),
                  rhos=(T,))
    Q, R, A, B, q, r, c, lam0, rhos = (
        _build.checked(NAME, key, t, torch.Size(expect[key]), dev)
        for key, t in zip(expect, (Q, R, A, B, q, r, c, lam0, rhos)))
    C, in_smem = launch_plan(NAME, Bn, K, s, cdim, poly_degree, dev, cluster,
                             occupancy="gato_sequence_max_clusters",
                             wide=())
    # One record slice a stream, when the records do not fit shared memory:
    # its T steps run one after another.
    scratch = None if in_smem else torch.empty(
        Bn * K * record_floats(s, cdim), dtype=torch.float32, device=dev)
    lam, dz_x, dz_u, eta, iters, conv = outputs((T, Bn), K, s, cdim, dev)
    if Bn > 0:
        _build.launch(NAME, "gato_fused_sequence", dev,
                      *(t.data_ptr() for t in (Q, R, A, B, q, r, c, lam0, rhos)),
                      None if scratch is None else scratch.data_ptr(),
                      lam.data_ptr(), dz_x.data_ptr(), dz_u.data_ptr(),
                      iters.data_ptr(), conv.data_ptr(), eta.data_ptr(),
                      T, Bn, K, s, cdim, float(exit_tol), int(max_iters),
                      poly_degree, PRECOND_CODES[preconditioner], C, int(in_smem))
        global LAUNCHES, LAST_CLUSTER
        LAUNCHES += 1
        LAST_CLUSTER = C
    res = PCGResult(lam=lam, iters=iters, converged=conv, eta=eta)
    return res, dz_x, dz_u

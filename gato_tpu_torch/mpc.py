"""MPC sequences: T dependent solves, each warm-started from the previous
step's multipliers, with a per-step rho.

The counterpart of ``gato_tpu.mpc`` on its PCG tier.
:func:`solve_sequence_batched` runs a farm: B independent streams (a fleet
of controllers), T dependent steps each, every stream carrying its own
warm start (``result.lam[t, b]`` warm-starts step t+1 of stream b).
:func:`solve_sequence` is its B=1 case.  Backends (solver.py's names):

* ``'torch'``: a Python loop over t of condense -> pcg -> recover_dz
  (``gato_tpu``'s ``lax.scan`` over ``'jax'`` steps);
* ``'pcg_kernel'``: the same loop with the PCG kernel (kernel A) in each
  step (``gato_tpu``'s ``'pallas'``), or past kernel A's shared memory the
  long-K tier (kernels/longk.py: its condensation, PCG and recovery
  kernels), each step warm-started from the last in the public layout;
* ``'fused'``: the whole farm in ONE launch of the sequence kernel
  (kernels/fused_sequence.py, row 3), ``gato_tpu``'s TPU default.

Auto-selection picks ``'fused'`` for float32 on CUDA where the sequence
kernel takes the shape (s, c <= 32), ``'pcg_kernel'`` past it where that
backend has a kernel (so the long-K tier; kernel A at a control size above
32), and ``'torch'`` otherwise (``solver._resolve_backend``); an explicit
``'fused'`` past it raises.  ``lam0`` is used whatever
``options.warm_start`` says: chaining is the point of these entry points.

``method='direct'`` is the exact farm (``gato_tpu.mpc``'s
``_solve_sequence_batched_direct_core``): an exact solve has no warm-start
carry, so the T steps are independent and the (T, B) grid folds into ONE
batch of T*B solves, with each step's rho folded into its Q and R diagonals
first (:func:`_fold_rhos`) and the batch solved at rho = 0 by
``solve_batched``'s direct route: on CUDA the block-Thomas pair from
T*B >= 16 (4096 problems at B=256, T=16), else the cyclic-reduction
kernel, or past its shared memory (``'pcg_kernel'``, auto there) the
long-K exact tier (kernels/longk.py).  ``lam0`` is ignored there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .formats import KKTBlocks, blocks_to_torch, check_block_shapes
from .kernels import fused_sequence
from .problem import ProblemSpec, SolverOptions
from .solver import (SolveResult, _resolve_backend, _solve_core,
                     _torch_dtype, resolve_device, spec_shape)


def _fold_rhos(Q, R, rhos):
    """Q_t + rho_t I and R_t + rho_t I for every step t (leading T axis):
    rho enters the system only as G + rho I, so folding it in lets one
    batched call serve steps with different regularisers."""
    rr = rhos.reshape((rhos.shape[0],) + (1,) * (Q.ndim - 1))
    Qr = Q + rr * torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    Rr = R + rr * torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    return Qr, Rr


def _solves(blocks: KKTBlocks) -> int:
    """Solves of a farm: the product of Q's leading axes, the batch width
    the exact farm folds them into."""
    return int(np.prod(blocks.Q.shape[:-3]))


def _direct_farm(b: KKTBlocks, rhos: np.ndarray, options: SolverOptions,
                 backend: str) -> SolveResult:
    """The exact farm: T*B independent solves as one batched direct solve
    at rho = 0, on rho-folded blocks."""
    T, Bn = b.Q.shape[:2]
    Qr, Rr = _fold_rhos(b.Q, b.R, torch.as_tensor(rhos, device=b.Q.device))
    flat = KKTBlocks(*(a.reshape((T * Bn,) + a.shape[2:])
                       for a in b._replace(Q=Qr, R=Rr)))
    lam0 = torch.zeros_like(flat.q)
    res = _solve_core(flat, lam0, dataclasses.replace(options, rho=0.0), backend)
    return SolveResult(*(x.reshape((T, Bn) + x.shape[1:]) for x in res))


def _sequence_core(b: KKTBlocks, lam0: torch.Tensor, rhos: np.ndarray,
                   options: SolverOptions, backend: str) -> SolveResult:
    """The farm on staged (T, B, ...) tensors; returns (T, B, ...) results."""
    if options.method == "direct":
        return _direct_farm(b, rhos, options, backend)
    if backend == "fused":
        res, dz_x, dz_u = fused_sequence.fused_sequence_cuda(
            *b, lam0, torch.as_tensor(rhos, device=lam0.device),
            exit_tol=options.exit_tol, max_iters=options.max_iters,
            poly_degree=options.precond_poly_degree,
            preconditioner=options.preconditioner.value)
        return SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged,
                           res.eta)
    steps = []
    lam = lam0
    for t, rho in enumerate(rhos.tolist()):
        out = _solve_core(KKTBlocks(*(a[t] for a in b)), lam,
                          dataclasses.replace(options, rho=rho), backend)
        steps.append(out)
        lam = out.lam
    return SolveResult(*(torch.stack(field) for field in zip(*steps)))


def _stage_sequence(spec, blocks, options, lam0, rhos, device, lead_ndim,
                    caller):
    """Blocks as (T, B, ...) tensors on ``device``, lam0 (B, K, s), and rhos
    as a (T,) host array in the options' dtype."""
    dev = resolve_device(device)
    dtype = _torch_dtype(options.dtype)
    b = blocks_to_torch(blocks, dev, dtype)
    if b.Q.ndim != lead_ndim + 3:
        axes, shape = (("a leading T axis", "(T, K, s, s)") if lead_ndim == 1
                       else ("leading (T, B) axes", "(T, B, K, s, s)"))
        raise ValueError(f"{caller} expects {axes} on every array (Q {shape}); "
                         f"got Q shape {tuple(b.Q.shape)}")
    if lead_ndim == 1:
        b = KKTBlocks(*(a.unsqueeze(1) for a in b))
    T, Bn = b.Q.shape[:2]
    check_block_shapes(spec, b, lead=(T, Bn))
    shape = (Bn, spec.knot_points, spec.state_size)
    if lam0 is None:
        lam0 = torch.zeros(shape, dtype=dtype, device=dev)
    else:
        lam0 = torch.as_tensor(lam0, dtype=dtype, device=dev).reshape(shape)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    if rhos is None:
        rhos = np.full(T, options.rho, dtype=np_dtype)
    else:
        if torch.is_tensor(rhos):
            rhos = rhos.detach().cpu()
        rhos = np.asarray(rhos, dtype=np_dtype).reshape(-1)
        if rhos.shape != (T,):
            raise ValueError(f"{caller}: rhos must hold one value per step "
                             f"(T={T}), got {rhos.size}")
    return b, lam0.contiguous(), rhos


def solve_sequence_batched(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0=None,
    rhos=None,
    pcg_backend: Optional[str] = None,
    *,
    device="cuda",
) -> SolveResult:
    """Solve B dependent KKT sequences in lockstep: an MPC farm.

    Args:
      spec: problem shape (checked against ``blocks``).
      blocks: KKTBlocks with leading (T, B) axes on every array.
      options: runtime solver options; ``options.rho`` is the default of
        every step.
      lam0: (B, K, s) multipliers warm-starting step 0 (zeros by default;
        ignored by ``method='direct'``).
      rhos: optional per-step regularisers (T,).
      pcg_backend: 'torch' | 'pcg_kernel' | 'fused' | None (auto).
      device: where to solve; default "cuda".

    Returns a SolveResult with leading (T, B) axes."""
    backend = _resolve_backend(pcg_backend, options, device, spec_shape(spec),
                               batch=_solves(blocks), farm=True)
    b, lam0, rhos = _stage_sequence(spec, blocks, options, lam0, rhos, device,
                                    2, "solve_sequence_batched")
    return _sequence_core(b, lam0, rhos, options, backend)


def solve_sequence(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0=None,
    rhos=None,
    pcg_backend: Optional[str] = None,
    *,
    device="cuda",
) -> SolveResult:
    """Solve T dependent KKT systems with cross-step warm starting.

    ``blocks`` carries a leading T (time or SQP-iteration) axis on every
    array; ``lam0`` is (K, s); ``rhos`` (T,) defaults to ``options.rho``.
    Returns a SolveResult with a leading T axis; ``result.lam[t]``
    warm-starts solve t+1.  The B=1 case of :func:`solve_sequence_batched`.
    """
    backend = _resolve_backend(pcg_backend, options, device, spec_shape(spec),
                               batch=_solves(blocks), farm=True)
    b, lam0, rhos = _stage_sequence(spec, blocks, options, lam0, rhos, device,
                                    1, "solve_sequence")
    res = _sequence_core(b, lam0, rhos, options, backend)
    return SolveResult(*(t[:, 0] for t in res))

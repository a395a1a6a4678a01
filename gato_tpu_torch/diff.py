"""Differentiable exact KKT solves by the implicit function theorem.

The counterpart of ``gato_tpu.diff``: gradients of the solution (lambda,
dz_x, dz_u) with respect to every datum (Q, R, A, B, q, r, c, rho), at the
cost of one more solve of the same system, never by differentiating
through the solver.

The VJP.  The solution x = [dz; lam] satisfies M x = b with the symmetric
saddle matrix M = [[G + rho I, C^T], [C, 0]] and b = [g; c].  For a
cotangent x_bar = (dz_x_bar, dz_u_bar, lam_bar) the backward solves

    M y = x_bar        (the same system, q = dz_x_bar, r = dz_u_bar,
                        c = lam_bar)

and assembles

    Q_bar[k] = -sym(y_zx[k] dz_x[k]^T)       R_bar[k] = -sym(y_zu[k] dz_u[k]^T)
    A_bar[k] = -(lam[k+1] y_zx[k]^T + y_lam[k+1] dz_x[k]^T)
    B_bar[k] = -(lam[k+1] y_zu[k]^T + y_lam[k+1] dz_u[k]^T)
    q_bar = y_zx,  r_bar = y_zu,  c_bar = y_lam
    rho_bar = -(y_zx . dz_x + y_zu . dz_u), summed over every axis, the
              batch included (one rho serves the batch), in rho's dtype

with sym(M) = (M + M^T) / 2.  Q and R are Hessian blocks: the solve is the
saddle solve only on the symmetric manifold, so their gradients are the
symmetric ones (the same inner product against any symmetric perturbation;
``torch.autograd.gradcheck`` needs a symmetric parametrisation of them).
Only first derivatives are supported (the backward is
``once_differentiable``).

The routing.  Both the forward and the adjoint solve run the solver's own
exact dispatch, :func:`_backend` (``solver._resolve_backend`` with
``method='direct'`` at this batch width), then ``solver._solve_core``: on
CUDA in float32 the cyclic-reduction kernel (row 4) below B = 16, the
block-Thomas pair (rows 5 and 6) from B = 16, and past row 4's shared
memory below B = 16 the long-K exact tier (rows 7, 11 or 'hybrid''s 12,
13); float64, and tensors on the CPU, run the 'torch' backend (condense,
block Thomas, recover).  :func:`kkt_solve` is the batch of one.  Tensors
run on the device they are on.

Singular input is outside the gradient's domain: the kernel routes report
such a problem through its eta (and the long-K exact tier adds 1e30 to its
lambda), the 'torch' route propagates inf/NaN, and its gradient means
nothing in either case.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import solver
from .formats import KKTBlocks, blocks_to_torch, check_block_shapes
from .problem import SolverOptions


def _backend(Q: torch.Tensor, R: torch.Tensor) -> str:
    """The solver's exact-solve backend for a batch Q (B, K, s, s), R (B,
    K-1, c, c) on Q's device in Q's dtype: one predicate with
    solve_batched(method='direct')."""
    Bn, K, s, _ = Q.shape
    options = SolverOptions(method="direct", dtype=Q.dtype)
    return solver._resolve_backend(None, options, Q.device, (K, s, R.shape[-1]),
                                   batch=Bn)


def _solve(Q, R, A, B, q, r, c, rho: float):
    """Exact batched saddle solve; returns (lam, dz_x, dz_u)."""
    options = SolverOptions(method="direct", rho=rho, dtype=Q.dtype)
    res = solver._solve_core(KKTBlocks(Q, R, A, B, q, r, c), None, options,
                             _backend(Q, R))
    return res.lam, res.dz_x, res.dz_u


def _outer(a, b):
    return torch.einsum("...a,...b->...ab", a, b)


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _cotangents(lam, dz_x, dz_u, y_lam, y_zx, y_zu):
    """(Q_bar, R_bar, A_bar, B_bar, q_bar, r_bar, c_bar, rho_bar) of the
    VJP in the module docstring (gato_tpu.diff._bwd_core)."""
    lam_next = lam[..., 1:, :]
    y_lam_next = y_lam[..., 1:, :]
    Q_bar = -_sym(_outer(y_zx, dz_x))
    R_bar = -_sym(_outer(y_zu, dz_u))
    A_bar = -(_outer(lam_next, y_zx[..., :-1, :])
              + _outer(y_lam_next, dz_x[..., :-1, :]))
    B_bar = -(_outer(lam_next, y_zu) + _outer(y_lam_next, dz_u))
    rho_bar = -((y_zx * dz_x).sum() + (y_zu * dz_u).sum())
    return Q_bar, R_bar, A_bar, B_bar, y_zx, y_zu, y_lam, rho_bar


class _KKTSolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Q, R, A, B, q, r, c, rho):
        rho_f = float(rho)
        lam, dz_x, dz_u = _solve(Q, R, A, B, q, r, c, rho_f)
        ctx.rho = rho_f
        ctx.rho_to = (dict(dtype=rho.dtype, device=rho.device)
                      if torch.is_tensor(rho) else None)
        ctx.save_for_backward(Q, R, A, B, lam, dz_x, dz_u)
        return lam, dz_x, dz_u

    @staticmethod
    @once_differentiable
    def backward(ctx, lam_bar, dz_x_bar, dz_u_bar):
        Q, R, A, B, lam, dz_x, dz_u = ctx.saved_tensors
        y_lam, y_zx, y_zu = _solve(Q, R, A, B, dz_x_bar, dz_u_bar, lam_bar, ctx.rho)
        grads = list(_cotangents(lam, dz_x, dz_u, y_lam, y_zx, y_zu))
        if ctx.rho_to is not None:
            grads[7] = grads[7].to(**ctx.rho_to)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def kkt_solve_batched(Q, R, A, B, q, r, c, rho):
    """Differentiable exact KKT solve over a leading batch axis:
    (B, K, s, s), ... -> (lam (B, K, s), dz_x (B, K, s), dz_u (B, K-1, c)).

    The forward and the adjoint solve run the solver's exact dispatch on
    the tensors' device (module docstring: row 4 below B = 16, the
    block-Thomas pair from B = 16, the long-K exact tier past row 4's
    shared memory, the 'torch' backend for float64 or on the CPU).
    ``rho`` is a Python float (no gradient) or a 0-d tensor shared by the
    batch; its gradient sums over the batch."""
    return _KKTSolveBatched.apply(Q, R, A, B, q, r, c, rho)


def kkt_solve(Q, R, A, B, q, r, c, rho):
    """Differentiable exact KKT solve of one problem: (Q, R, A, B, q, r,
    c, rho) in the layout of formats.KKTBlocks -> (lam (K, s), dz_x (K, s),
    dz_u (K-1, c)); :func:`kkt_solve_batched` at B = 1."""
    out = kkt_solve_batched(*(x.unsqueeze(0) for x in (Q, R, A, B, q, r, c)), rho)
    return tuple(x[0] for x in out)


def solve_and_grad_example(spec, blocks, rho, loss_fn, *, device="cuda"):
    """The loss loss_fn(lam, dz_x, dz_u) of one problem and its gradients
    with respect to the seven blocks: ``blocks`` (NumPy arrays, float32)
    are staged on ``device`` (default the card).  Returns (loss, (Q_bar,
    R_bar, A_bar, B_bar, q_bar, r_bar, c_bar))."""
    dev = solver.resolve_device(device)
    b = blocks_to_torch(blocks, dev)
    check_block_shapes(spec, b)
    b = [t.requires_grad_() for t in b]
    loss = loss_fn(*kkt_solve(*b, rho))
    return loss, torch.autograd.grad(loss, b)

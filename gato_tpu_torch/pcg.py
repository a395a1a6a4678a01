"""Preconditioned conjugate gradient on the block-tridiagonal Schur system,
batched over leading axes with a per-problem masked freeze.

Algorithm (``gato_tpu.pcg.pcg``, the original's cooperative PCG kernel):

    r_0 = gamma - S lambda_0
    r~ = M r;  p = r~;  eta = r . r~
    repeat up to max_iters:
        upsilon = S p
        nu    = p . upsilon
        alpha = eta / nu                  (0 when nu == 0)
        lambda += alpha p;  r -= alpha upsilon
        r~ = M r;  eta_new = r . r~
        exit if |eta_new| < exit_tol      (preconditioned residual dot)
        beta = eta_new / eta              (0 when eta == 0)
        p = r~ + beta p;  eta = eta_new

with M r = Pinv r for ``poly_degree`` 1 and the Horner form
y = Pinv r; y += Pinv (r - S y) for each further degree.

The iteration count is the 0-based loop index at which the exit test fired,
or ``max_iters`` if it never did.  In a batch, a problem that has converged
stops updating while the rest iterate, so every problem gets exactly the
iterates it would get alone.  ``frozen`` problems (a zero pivot clamped
during condensation, see assemble.condense(flag=True)) never update, never
converge, report ``max_iters`` and eta = 1e30.

This is the plain version of the CUDA PCG kernel (kernels/pcg_kernel.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .blocktri import btd_matvec

FROZEN_ETA = 1e30


class PCGResult(NamedTuple):
    lam: torch.Tensor        # (..., K, s)  solution
    iters: torch.Tensor      # (...)        int32
    converged: torch.Tensor  # (...)        bool
    eta: torch.Tensor        # (...)        final |r . M r|


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=(-2, -1))


def pcg(
    S: torch.Tensor,
    Pinv: torch.Tensor,
    gamma: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    *,
    exit_tol: float = 1e-6,
    max_iters: int = 100,
    poly_degree: int = 1,
    frozen: Optional[torch.Tensor] = None,
) -> PCGResult:
    """Solve S lam = gamma for every problem of the leading batch axes."""

    def apply_P(rv):
        y = btd_matvec(Pinv, rv)
        for _ in range(poly_degree - 1):
            y = y + btd_matvec(Pinv, rv - btd_matvec(S, y))
        return y

    dt, dev = gamma.dtype, gamma.device
    batch = gamma.shape[:-2]
    max_iters = int(max_iters)
    tol = torch.tensor(exit_tol, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    if lam0 is None:
        lam = torch.zeros_like(gamma)
        r = gamma
    else:
        lam = lam0.to(dt)
        r = gamma - btd_matvec(S, lam)
    r_tilde = apply_P(r)
    p = r_tilde
    eta = _dot(r, r_tilde)

    n_iters = torch.full(batch, max_iters, dtype=torch.int32, device=dev)
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    blocked = (torch.zeros(batch, dtype=torch.bool, device=dev)
               if frozen is None else frozen.to(torch.bool))

    it = 0
    while it < max_iters:
        live = ~(converged | blocked)
        if not bool(live.any()):
            break
        upsilon = btd_matvec(S, p)
        nu = _dot(p, upsilon)
        alpha = torch.where(nu != 0, eta / nu, zero)
        lam_n = lam + alpha[..., None, None] * p
        r_n = r - alpha[..., None, None] * upsilon
        r_tilde = apply_P(r_n)
        eta_new = _dot(r_n, r_tilde)
        conv_now = eta_new.abs() < tol
        beta = torch.where(eta != 0, eta_new / eta, zero)
        p_n = r_tilde + beta[..., None, None] * p

        lv = live[..., None, None]
        lam = torch.where(lv, lam_n, lam)
        r = torch.where(lv, r_n, r)
        p = torch.where(lv, p_n, p)
        eta = torch.where(live, eta_new, eta)
        hit = live & conv_now
        n_iters = torch.where(hit, torch.full_like(n_iters, it), n_iters)
        converged = converged | hit
        it += 1

    eta = eta.abs()
    if frozen is not None:
        eta = torch.where(blocked, torch.full_like(eta, FROZEN_ETA), eta)
    return PCGResult(lam=lam, iters=n_iters, converged=converged, eta=eta)

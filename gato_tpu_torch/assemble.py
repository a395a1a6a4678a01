"""Schur-complement condensation of the trajectory-QP KKT system.

Given the block KKT data (Q, R, A, B, q, r, c) and the regularizer rho, form
the block-tridiagonal Schur system in the multipliers lambda:

    S lambda = gamma,      S = C (G + rho I)^{-1} C^T,
                           gamma = C (G + rho I)^{-1} g - c

Per knot, with Qr = Q + rho I and Rr = R + rho I:

    theta_0 = Qr_0^{-1}
    phi_k   = A_{k-1} Qr_{k-1}^{-1}                                (k = 1..K-1)
    theta_k = phi_k A_{k-1}^T + B_{k-1} Rr_{k-1}^{-1} B_{k-1}^T + Qr_k^{-1}
    S       = btd(left=phi_k, main=theta_k, right=phi_{k+1}^T)
    gamma_0 = Qr_0^{-1} q_0 - c_0
    gamma_k = phi_k q_{k-1} + B_{k-1} Rr_{k-1}^{-1} r_{k-1} + Qr_k^{-1} q_k - c_k

The sign convention is positive (S is positive definite) and gamma_0 includes
the -c_0 term, as in ``gato_tpu.assemble``.  Preconditioners:

  * block Jacobi:     Pinv main diagonal = theta_k^{-1}
  * symmetric stair:  additionally Pinv_(k,k-1) = -theta_k^{-1} phi_k theta_{k-1}^{-1}
                      and          Pinv_(k,k+1) = -theta_k^{-1} phi_{k+1}^T theta_{k+1}^{-1}
  * scalar Jacobi:    Pinv main diagonal = diag(1/diag(theta_k))

Qr^{-1} and Rr^{-1} are returned for the dz recovery.  Every tensor may carry
leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .blocktri import block_inv, block_inv_flag
from .problem import Preconditioner


class SchurSystem(NamedTuple):
    """Condensed system + preconditioner + cached inverses for dz recovery."""

    S: torch.Tensor      # (..., K, 3, s, s)  block-tridiagonal Schur complement
    Pinv: torch.Tensor   # (..., K, 3, s, s)  preconditioner (approximate S^{-1})
    gamma: torch.Tensor  # (..., K, s)        condensed rhs
    Qinv: torch.Tensor   # (..., K, s, s)     (Q_k + rho I)^{-1}
    Rinv: torch.Tensor   # (..., K-1, c, c)   (R_k + rho I)^{-1}
    bad: Optional[torch.Tensor] = None  # (...) zero-pivot flags (flag=True)


def _bmm(a, b):
    return torch.einsum("...kab,...kbc->...kac", a, b)


def _bmm_t(a, b):
    """Batched a @ b^T."""
    return torch.einsum("...kab,...kcb->...kac", a, b)


def _bmv(a, x):
    return torch.einsum("...kab,...kb->...ka", a, x)


def condense(
    Q: torch.Tensor,
    R: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    q: torch.Tensor,
    r: torch.Tensor,
    c: torch.Tensor,
    rho: float,
    preconditioner: Preconditioner = Preconditioner.SYMMETRIC_STAIR,
    *,
    flag: bool = False,
) -> SchurSystem:
    """Assemble (S, Pinv, gamma) from block KKT data.

    ``flag=True`` is the plain version of the CUDA fused solve's condensation:
    zero pivots are clamped to 1 in every inversion (and a zero theta
    diagonal in scalar Jacobi), and ``bad`` flags each problem in which a
    zero pivot was clamped in a live Q or R block.  With ``flag=False`` a
    singular block propagates inf/NaN, as in ``gato_tpu``."""
    s = Q.shape[-1]
    cdim = R.shape[-1]
    eye_s = torch.eye(s, dtype=Q.dtype, device=Q.device)
    eye_c = torch.eye(cdim, dtype=Q.dtype, device=Q.device)

    if flag:
        Qinv, bad_q = block_inv_flag(Q + rho * eye_s)      # (..., K, s, s)
        Rinv, bad_r = block_inv_flag(R + rho * eye_c)      # (..., K-1, c, c)
        bad = bad_q.any(-1) | bad_r.any(-1)
    else:
        Qinv = block_inv(Q + rho * eye_s)
        Rinv = block_inv(R + rho * eye_c)
        bad = None

    phi = _bmm(A, Qinv[..., :-1, :, :])        # phi_{k+1} = A_k Qr_k^{-1}
    BRinv = _bmm(B, Rinv)                      # (..., K-1, s, c)

    theta_rest = _bmm_t(phi, A) + _bmm_t(BRinv, B) + Qinv[..., 1:, :, :]
    theta = torch.cat([Qinv[..., :1, :, :], theta_rest], dim=-3)  # (..., K, s, s)

    zero_block = torch.zeros_like(Qinv[..., :1, :, :])
    left = torch.cat([zero_block, phi], dim=-3)
    right = torch.cat([phi.transpose(-1, -2), zero_block], dim=-3)
    S = torch.stack([left, theta, right], dim=-3)  # (..., K, 3, s, s)

    gamma_rest = (_bmv(phi, q[..., :-1, :]) + _bmv(BRinv, r)
                  + _bmv(Qinv[..., 1:, :, :], q[..., 1:, :]) - c[..., 1:, :])
    gamma0 = _bmv(Qinv[..., :1, :, :], q[..., :1, :]) - c[..., :1, :]
    gamma = torch.cat([gamma0, gamma_rest], dim=-2)  # (..., K, s)

    Pinv = _preconditioner(theta, phi, Preconditioner(preconditioner), flag)
    return SchurSystem(S=S, Pinv=Pinv, gamma=gamma, Qinv=Qinv, Rinv=Rinv,
                       bad=bad)


def _preconditioner(theta, phi, kind: Preconditioner, clamp: bool):
    zeros = torch.zeros_like(theta)
    if kind == Preconditioner.JACOBI:
        diag = torch.diagonal(theta, dim1=-2, dim2=-1)          # (..., K, s)
        if clamp:
            diag = torch.where(diag != 0, diag, torch.ones_like(diag))
        main = torch.diag_embed(1.0 / diag)
        return torch.stack([zeros, main, zeros], dim=-3)

    theta_inv = block_inv_flag(theta)[0] if clamp else block_inv(theta)

    if kind == Preconditioner.BLOCK_JACOBI:
        return torch.stack([zeros, theta_inv, zeros], dim=-3)

    # Symmetric stair (bandwidth-3 approximate inverse).
    ti_next = theta_inv[..., 1:, :, :]
    ti_prev = theta_inv[..., :-1, :, :]
    left_off = -_bmm(_bmm(ti_next, phi), ti_prev)            # (..., K-1, s, s)
    right_off = -_bmm(_bmm_t(ti_prev, phi), ti_next)         # (..., K-1, s, s)
    zero_block = zeros[..., :1, :, :]
    p_left = torch.cat([zero_block, left_off], dim=-3)
    p_right = torch.cat([right_off, zero_block], dim=-3)
    return torch.stack([p_left, theta_inv, p_right], dim=-3)

"""Primal step recovery: dz from the converged multipliers.

dz = (G + rho I)^{-1} (g - C^T lambda) splits per knot into

    dz_x_k     = Qr_k^{-1} (q_k - lambda_k - A_k^T lambda_{k+1})     k = 0..K-2
    dz_x_{K-1} = Qr_{K-1}^{-1} (q_{K-1} - lambda_{K-1})
    dz_u_k     = Rr_k^{-1} (r_k - B_k^T lambda_{k+1})                k = 0..K-2

using the block inverses kept by the condensation.  The last state row has no
A_{K-1}^T lambda_K term (there is no interval K-1), as in ``gato_tpu.recover``
and the dense oracle.
"""

from __future__ import annotations

from typing import Tuple

import torch


def recover_dz(
    Qinv: torch.Tensor,   # (..., K, s, s)
    Rinv: torch.Tensor,   # (..., K-1, c, c)
    A: torch.Tensor,      # (..., K-1, s, s)
    B: torch.Tensor,      # (..., K-1, s, c)
    q: torch.Tensor,      # (..., K, s)
    r: torch.Tensor,      # (..., K-1, c)
    lam: torch.Tensor,    # (..., K, s)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dz_x: (..., K, s), dz_u: (..., K-1, c))."""
    lam_next = lam[..., 1:, :]
    at_l = torch.einsum("...kba,...kb->...ka", A, lam_next)  # (..., K-1, s)
    bt_l = torch.einsum("...kba,...kb->...ka", B, lam_next)  # (..., K-1, c)
    at_l = torch.cat([at_l, torch.zeros_like(at_l[..., :1, :])], dim=-2)
    dz_x = torch.einsum("...kab,...kb->...ka", Qinv, q - lam - at_l)
    dz_u = torch.einsum("...kab,...kb->...ka", Rinv, r - bt_l)
    return dz_x, dz_u

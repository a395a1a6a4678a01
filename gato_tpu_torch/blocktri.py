"""Block-tridiagonal linear algebra on tensors with leading batch axes.

Storage: a block-tridiagonal matrix over K knot rows with (s x s) blocks is a
``(..., K, 3, s, s)`` tensor; per row the slots are ``[..., 0]`` the left
off-diagonal block (row k, col k-1; zero at row 0), ``[..., 1]`` the main
diagonal block and ``[..., 2]`` the right off-diagonal block (row k, col k+1;
zero at row K-1).  Edges are exact: the halo is zero-padded.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def halo_stack(x: torch.Tensor, left: Optional[torch.Tensor] = None,
               right: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., K, s) segments -> (..., K, 3, s) halo [x_{k-1}, x_k, x_{k+1}].
    The out-of-range neighbours x_{-1} and x_K are ``left`` and ``right``
    (..., s), zero where not given: a shard of a longer trajectory takes
    its neighbours' boundary rows there."""
    zero = torch.zeros_like(x[..., :1, :])
    xl = zero if left is None else left.unsqueeze(-2)
    xr = zero if right is None else right.unsqueeze(-2)
    xm = torch.cat([xl, x[..., :-1, :]], dim=-2)
    xp = torch.cat([x[..., 1:, :], xr], dim=-2)
    return torch.stack([xm, x, xp], dim=-2)


def btd_matvec(S: torch.Tensor, x: torch.Tensor,
               left: Optional[torch.Tensor] = None,
               right: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1} for a (..., K, 3, s, s)
    operator and (..., K, s) vectors, x_{-1} and x_K from :func:`halo_stack`."""
    return torch.einsum("...kjab,...kjb->...ka", S, halo_stack(x, left, right))


def btd_transpose(S: torch.Tensor) -> torch.Tensor:
    """Transpose of a (..., K, 3, s, s) block-tridiagonal operator: row k's
    left block is (U_{k-1})^T, its diagonal D_k^T, its right block
    (L_{k+1})^T, with the edge slots zero."""
    L, D, U = (S[..., j, :, :].transpose(-1, -2) for j in range(3))
    zero = torch.zeros_like(L[..., :1, :, :])
    left = torch.cat([zero, U[..., :-1, :, :]], dim=-3)
    right = torch.cat([L[..., 1:, :, :], zero], dim=-3)
    return torch.stack([left, D, right], dim=-3)


def btd_to_dense(S) -> np.ndarray:
    """(..., K, 3, s, s) -> dense (..., K*s, K*s) NumPy array.  Test oracle."""
    S = S.detach().cpu().numpy() if torch.is_tensor(S) else np.asarray(S)
    *lead, K, _, s, _ = S.shape
    out = np.zeros(tuple(lead) + (K * s, K * s), dtype=S.dtype)
    for k in range(K):
        out[..., k * s : (k + 1) * s, k * s : (k + 1) * s] = S[..., k, 1, :, :]
        if k > 0:
            out[..., k * s : (k + 1) * s, (k - 1) * s : k * s] = S[..., k, 0, :, :]
        if k < K - 1:
            out[..., k * s : (k + 1) * s, (k + 1) * s : (k + 2) * s] = S[..., k, 2, :, :]
    return out


def _gauss_jordan(M: torch.Tensor, clamp: bool):
    """Unrolled Gauss-Jordan on [M | I] with no pivoting and an explicit
    pivot-row division; returns (inverse, number of zero pivots per matrix).
    With ``clamp`` a zero pivot divides by 1 instead of 0."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    A = torch.cat([M, eye], dim=-1)  # augmented [M | I], (..., n, 2n)
    rows = torch.arange(n, device=M.device).reshape(n, 1)
    zero_pivots = torch.zeros(M.shape[:-2], dtype=torch.int32, device=M.device)
    for i in range(n):
        piv = A[..., i : i + 1, i : i + 1]
        zero_pivots = zero_pivots + (piv[..., 0, 0] == 0).to(torch.int32)
        if clamp:
            piv = torch.where(piv != 0, piv, torch.ones_like(piv))
        row = A[..., i : i + 1, :] / piv
        f = torch.where(rows == i, torch.zeros_like(A[..., :, i : i + 1]),
                        A[..., :, i : i + 1])
        A = A - f * row
        A = torch.where(rows == i, row, A)
    return A[..., :, n:], zero_pivots


def block_inv(M: torch.Tensor) -> torch.Tensor:
    """Batched small-matrix inverse, (..., n, n) -> (..., n, n).

    Unrolled Gauss-Jordan with no pivoting and an explicit pivot-row
    normalisation, as ``gato_tpu.blocktri.block_inv``: every inverted block
    (Q+rho*I, R+rho*I, theta) is symmetric positive definite, so its leading
    principal minors are nonsingular.  A zero pivot divides by zero, so a
    singular block poisons the result with inf/NaN, as in the JAX package.
    Blocks above 32 x 32 go to ``torch.linalg.inv``.
    """
    if M.shape[-1] > 32:
        return torch.linalg.inv(M)
    return _gauss_jordan(M, clamp=False)[0]


def block_inv_flag(M: torch.Tensor):
    """:func:`block_inv` with zero pivots clamped to 1, plus a flag per
    matrix: True where a zero pivot was clamped in a block whose diagonal is
    not all zero (an all-zero block is structural padding).  The plain
    version of the CUDA fused solve's Gauss-Jordan, which mirrors
    ``gato_tpu.kernels.fused_solve._gj_inv_flag``."""
    inv, zero_pivots = _gauss_jordan(M, clamp=True)
    diag_abs = torch.diagonal(M, dim1=-2, dim2=-1).abs().sum(-1)
    return inv, (zero_pivots > 0) & (diag_abs > 0)

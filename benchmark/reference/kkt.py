"""Plain PyTorch reference for the batched trajectory-QP KKT solve.

The system, for one problem of K knots, s states and c controls:

    [ H  C^T ] [dz ]   [g]        H = blockdiag(Q_0 + rho I, R_0 + rho I, ...,
    [ C   0  ] [lam] = [c]                      Q_{K-1} + rho I)
                                  C: row-block 0 is [I 0 ...]; row-block k >= 1
                                     is A_{k-1} on x_{k-1}, B_{k-1} on u_{k-1}
                                     and I on x_k
                                  g = [q_0, r_0, q_1, ..., q_{K-1}]

is solved by eliminating dz: S lam = C H^-1 g - c with S = C H^-1 C^T, a
symmetric positive definite block-tridiagonal matrix; then a block Cholesky
factorisation of S, and dz = H^-1 (g - C^T lam).  Everything is worked out
here from the seven input blocks: this module imports nothing of the
program under test.

``solve`` computes in float64 by default, the reference against which
``correct`` is decided.  ``solve(..., tf32=True)`` is the control: the same
arithmetic in float32 with every matrix product taken at TF32 precision
(both factors rounded to 10 mantissa bits, the products summed in float32),
as an NVIDIA tensor core takes a float32 product with TF32 on.  The rounding
is done here explicitly, so the control computes the same on any device.

``pcg`` is a plain preconditioned conjugate gradient on the same S with the
symmetric-stair preconditioner, in float64: its iteration counts are the
work that these inputs need at a given exit tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Solution(NamedTuple):
    lam: torch.Tensor    # (n, K, s)
    dz_x: torch.Tensor   # (n, K, s)
    dz_u: torch.Tensor   # (n, K-1, c)


class PCGCounts(NamedTuple):
    iters: torch.Tensor      # (n,) int64: index of the body whose exit test fired
    converged: torch.Tensor  # (n,) bool


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties away from zero, as the conversion before a tensor-core
    product does."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def _products(tf32: bool):
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(tf32_round(a), tf32_round(b))


class _Condensed(NamedTuple):
    Qi: torch.Tensor      # (n, K, s, s)   (Q_k + rho I)^-1
    Ri: torch.Tensor      # (n, K-1, c, c) (R_k + rho I)^-1
    diag: torch.Tensor    # (n, K, s, s)   S_kk
    lower: torch.Tensor   # (n, K-1, s, s) S_{k+1,k}
    rhs: torch.Tensor     # (n, K, s)      C H^-1 g - c


def _spd_inverse(M: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_inverse(torch.linalg.cholesky(M))


def _condense(Q, R, A, B, q, r, c, rho, mm) -> _Condensed:
    s, cd = Q.shape[-1], R.shape[-1]
    Qi = _spd_inverse(Q + rho * torch.eye(s, dtype=Q.dtype, device=Q.device))
    Ri = _spd_inverse(R + rho * torch.eye(cd, dtype=Q.dtype, device=Q.device))
    AQi = mm(A, Qi[:, :-1])                        # A_{k-1} Qi_{k-1}
    BRi = mm(B, Ri)                                # B_{k-1} Ri_{k-1}
    diag = Qi.clone()
    diag[:, 1:] += mm(AQi, A.mT) + mm(BRi, B.mT)
    rhs = mm(Qi, q.unsqueeze(-1)).squeeze(-1) - c
    rhs[:, 1:] += (mm(AQi, q[:, :-1].unsqueeze(-1))
                   + mm(BRi, r.unsqueeze(-1))).squeeze(-1)
    return _Condensed(Qi, Ri, diag, AQi, rhs)


def _block_cholesky_solve(diag, lower, rhs, mm) -> torch.Tensor:
    """S lam = rhs for S = btd(lower, diag, lower^T), by S = L L^T with
    L's diagonal blocks G_k (Cholesky factors) and subdiagonal blocks
    W_k = S_{k,k-1} G_{k-1}^-T."""
    K = diag.shape[1]
    G, W, y = [], [], []
    for k in range(K):
        D = diag[:, k]
        b = rhs[:, k].unsqueeze(-1)
        if k:
            Wk = torch.linalg.solve_triangular(G[-1], lower[:, k - 1].mT,
                                               upper=False).mT
            D = D - mm(Wk, Wk.mT)
            b = b - mm(Wk, y[-1])
            W.append(Wk)
        G.append(torch.linalg.cholesky(D))
        y.append(torch.linalg.solve_triangular(G[-1], b, upper=False))
    lam = [None] * K
    x = torch.linalg.solve_triangular(G[-1].mT, y[-1], upper=True)
    lam[-1] = x
    for k in range(K - 2, -1, -1):
        x = torch.linalg.solve_triangular(G[k].mT, y[k] - mm(W[k].mT, x),
                                          upper=True)
        lam[k] = x
    return torch.stack(lam, dim=1).squeeze(-1)


def _recover(cond: _Condensed, A, B, q, r, lam, mm):
    nxt = lam[:, 1:].unsqueeze(-1)
    gx = q.clone()
    gx -= lam
    gx[:, :-1] -= mm(A.mT, nxt).squeeze(-1)
    gu = r - mm(B.mT, nxt).squeeze(-1)
    dz_x = mm(cond.Qi, gx.unsqueeze(-1)).squeeze(-1)
    dz_u = mm(cond.Ri, gu.unsqueeze(-1)).squeeze(-1)
    return dz_x, dz_u


def solve(blocks, rho: float, *, dtype=torch.float64, tf32: bool = False) -> Solution:
    """The exact solve of every problem in ``blocks`` (seven tensors with a
    leading problem axis, in the order Q, R, A, B, q, r, c), in ``dtype``;
    ``tf32=True`` is the control (float32, products at TF32)."""
    if tf32:
        dtype = torch.float32
    Q, R, A, B, q, r, c = (t.to(dtype) for t in blocks)
    mm = _products(tf32)
    cond = _condense(Q, R, A, B, q, r, c, rho, mm)
    lam = _block_cholesky_solve(cond.diag, cond.lower, cond.rhs, mm)
    dz_x, dz_u = _recover(cond, A, B, q, r, lam, mm)
    return Solution(lam, dz_x, dz_u)


def _stair(cond: _Condensed):
    """Symmetric-stair preconditioner blocks: diag theta_k^-1, and
    below it -theta_{k+1}^-1 S_{k+1,k} theta_k^-1."""
    Ti = _spd_inverse(cond.diag)
    low = -(Ti[:, 1:] @ cond.lower @ Ti[:, :-1])
    return Ti, low


def _btd_apply(diag, lower, x):
    """y = M x for the symmetric block-tridiagonal M = btd(lower, diag, lower^T)."""
    y = (diag @ x.unsqueeze(-1)).squeeze(-1)
    y[:, 1:] += (lower @ x[:, :-1].unsqueeze(-1)).squeeze(-1)
    y[:, :-1] += (lower.mT @ x[:, 1:].unsqueeze(-1)).squeeze(-1)
    return y


def pcg(blocks, rho: float, exit_tol: float, max_iters: int) -> PCGCounts:
    """Plain float64 PCG from lam = 0 with the symmetric-stair
    preconditioner; a problem stops at the first body whose
    |r . M r| falls under ``exit_tol``, or after ``max_iters`` bodies."""
    Q, R, A, B, q, r, c = (t.to(torch.float64) for t in blocks)
    cond = _condense(Q, R, A, B, q, r, c, rho, torch.matmul)
    Pd, Pl = _stair(cond)
    n = q.shape[0]
    res = cond.rhs.clone()
    z = _btd_apply(Pd, Pl, res)
    p = z.clone()
    eta = (res * z).sum((-2, -1))
    iters = torch.full((n,), max_iters, dtype=torch.int64, device=q.device)
    done = torch.zeros(n, dtype=torch.bool, device=q.device)
    for it in range(max_iters):
        Sp = _btd_apply(cond.diag, cond.lower, p)
        nu = (p * Sp).sum((-2, -1))
        alpha = torch.where(nu != 0, eta / nu, torch.zeros_like(nu))
        res = res - alpha[:, None, None] * Sp
        z = _btd_apply(Pd, Pl, res)
        eta_new = (res * z).sum((-2, -1))
        hit = ~done & (eta_new.abs() < exit_tol)
        iters[hit] = it
        done |= hit
        if bool(done.all()):
            break
        beta = torch.where(eta != 0, eta_new / eta, torch.zeros_like(eta))
        p = z + beta[:, None, None] * p
        eta = eta_new
    return PCGCounts(iters, done)

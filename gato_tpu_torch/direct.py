"""Exact block-tridiagonal solves: block Thomas and block cyclic reduction.

The counterpart of ``gato_tpu.direct``.  On S = btd(L, D, U), S x = b:

* :func:`btd_solve`, block Thomas (block LU without inter-block pivoting):

      forward, k = 0..K-1 (L_0 = 0, U_{-1} = 0):
          w_k = L_k C_{k-1}^{-1};  C_k = D_k - w_k U_{k-1};  y_k = b_k - w_k y_{k-1}
      backward, k = K-1..0 (U_{K-1} = 0):
          x_k = C_k^{-1} (y_k - U_k x_{k+1})

* :func:`btd_solve_cr`, block cyclic reduction: each level eliminates the
  odd rows of the surviving system at once (ceil(log2 K) levels), then
  back-substitutes level by level.

Both are stable without pivoting on the symmetric positive definite Schur
systems of assemble.condense (the reduced systems are Schur complements of
SPD systems, SPD themselves), the justification of blocktri.block_inv.  The
knot loops are Python loops over batched tensor ops: every step is batched
over the leading axes.  Products are einsums in the tensors' own type; on
CUDA, float32 products run in full float32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default).

``method='direct'`` derives ``converged`` from the true residual
(:func:`residual_converged`): a singular system reports False.
"""

from __future__ import annotations

from typing import Optional

import torch

from .blocktri import block_inv, block_inv_flag, btd_matvec

# Residual acceptance for method='direct' (gato_tpu.direct.DIRECT_CONV_RTOL):
# sqrt(eta) <= RTOL * sqrt(1 + ||gamma||^2).
DIRECT_CONV_RTOL = 1e-3


def residual_converged(eta, gamma_sq):
    """``converged`` of an exact solve: eta (the squared residual norm) is
    accepted when small against 1 + ||gamma||^2.  NaN compares False."""
    return eta <= DIRECT_CONV_RTOL ** 2 * (1.0 + gamma_sq)


def residual_norms(S: torch.Tensor, gamma: torch.Tensor, lam: torch.Tensor):
    """(eta, gamma_sq): ||gamma - S lam||^2 and ||gamma||^2 per problem."""
    resid = gamma - btd_matvec(S, lam)
    return ((resid * resid).sum(dim=(-2, -1)),
            (gamma * gamma).sum(dim=(-2, -1)))


def _mm(a, b):
    return torch.einsum("...ab,...bc->...ac", a, b)


def _mv(a, x):
    return torch.einsum("...ab,...b->...a", a, x)


def btd_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b by block Thomas.  S (..., K, 3, s, s), b (..., K, s)."""
    K = b.shape[-2]
    L, D, U = S[..., 0, :, :], S[..., 1, :, :], S[..., 2, :, :]
    c_inv, y = [], []
    for k in range(K):
        if k == 0:
            ck, yk = D[..., 0, :, :], b[..., 0, :]
        else:
            w = _mm(L[..., k, :, :], c_inv[-1])
            ck = D[..., k, :, :] - _mm(w, U[..., k - 1, :, :])
            yk = b[..., k, :] - _mv(w, y[-1])
        c_inv.append(block_inv(ck))
        y.append(yk)
    x = [None] * K
    x[K - 1] = _mv(c_inv[K - 1], y[K - 1])
    for k in range(K - 2, -1, -1):
        x[k] = _mv(c_inv[k], y[k] - _mv(U[..., k, :, :], x[k + 1]))
    return torch.stack(x, dim=-2)


def thomas_multi(L, D, U, Bm):
    """Block Thomas with a matrix right-hand side, scan axis first.

    L, D, U (m, ..., s, s), the block tridiagonal along the leading axis
    (L[0] and U[m-1] zero); Bm (m, ..., s, nrhs).  Returns X (m, ..., s,
    nrhs) with T X = Bm: one factorisation serves every column."""
    m = D.shape[0]
    c_inv, Y = [], []
    for k in range(m):
        if k == 0:
            ck, yk = D[0], Bm[0]
        else:
            w = _mm(L[k], c_inv[-1])
            ck = D[k] - _mm(w, U[k - 1])
            yk = Bm[k] - _mm(w, Y[-1])
        c_inv.append(block_inv(ck))
        Y.append(yk)
    X = [None] * m
    X[m - 1] = _mm(c_inv[m - 1], Y[m - 1])
    for k in range(m - 2, -1, -1):
        X[k] = _mm(c_inv[k], Y[k] - _mm(U[k], X[k + 1]))
    return torch.stack(X)


def _shift_right(x, n, dim):
    """x along ``dim`` moved one place right (a zero block in front), cut to
    length ``n``: element t is x[t-1]."""
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([zero, x], dim=dim).narrow(dim, 0, n)


def _pad_to(x, n, dim):
    """x along ``dim`` zero-padded at the end to length ``n``."""
    if x.shape[dim] == n:
        return x
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([x, zero], dim=dim)


def cr_level(L, D, U, b, *, flag: bool = False):
    """One compacting level of block cyclic reduction on the m rows of
    btd(L, D, U) x = b (L, D, U (..., m, s, s), b (..., m, s), m >= 2).

    With odd rows (D_o, L_o, U_o, b_o) and even rows (D_e, L_e, U_e, b_e):

        A = L_e D_{o,left}^{-1},   B = U_e D_{o,right}^{-1}
        L' = -A L_{o,left}         U' = -B U_{o,right}
        D' = D_e - A U_{o,left} - B L_{o,right}
        b' = b_e - A b_{o,left} - B b_{o,right}

    the left odd neighbour of even row t being odd row t-1 and the right
    one odd row t (zero past either end: an odd m leaves the last even row
    without a right neighbour).  Returns ((L', D', U', b') of the ceil(m/2)
    even rows, (D_o^{-1}, L_o, U_o, b_o) for :func:`cr_back_level`, and
    with ``flag`` the (..., m // 2) rows whose inversion clamped a zero
    pivot in a block with a nonzero diagonal, else None)."""
    Do, Lo, Uo, bo = (D[..., 1::2, :, :], L[..., 1::2, :, :],
                      U[..., 1::2, :, :], b[..., 1::2, :])
    De, Le, Ue, be = (D[..., 0::2, :, :], L[..., 0::2, :, :],
                      U[..., 0::2, :, :], b[..., 0::2, :])
    me = De.shape[-3]
    Doinv, bad = block_inv_flag(Do) if flag else (block_inv(Do), None)
    DoinvL, LoL, UoL = (_shift_right(x, me, -3) for x in (Doinv, Lo, Uo))
    boL = _shift_right(bo, me, -2)
    DoinvR, LoR, UoR = (_pad_to(x, me, -3) for x in (Doinv, Lo, Uo))
    boR = _pad_to(bo, me, -2)
    A = _mm(Le, DoinvL)
    Bm = _mm(Ue, DoinvR)
    reduced = (-_mm(A, LoL), De - _mm(A, UoL) - _mm(Bm, LoR), -_mm(Bm, UoR),
               be - _mv(A, boL) - _mv(Bm, boR))
    return reduced, (Doinv, Lo, Uo, bo), bad


def cr_back_level(x, Doinv, Lo, Uo, bo, m: int):
    """Back-substitution of one :func:`cr_level`: the level's m rows of x
    from its even rows' x (..., ceil(m/2), s) and the saves, with
    x_odd = D_o^{-1} (b_o - L_o x_left - U_o x_right)."""
    mo, me = bo.shape[-2], x.shape[-2]
    x_right = _pad_to(x, me + 1, -2)[..., 1:mo + 1, :]
    x_odd = _mv(Doinv, bo - _mv(Lo, x[..., :mo, :]) - _mv(Uo, x_right))
    x_odd = _pad_to(x_odd, me, -2)
    return torch.stack([x, x_odd], dim=-2).reshape(
        x.shape[:-2] + (2 * me, x.shape[-1]))[..., :m, :]


def btd_solve_cr(S: torch.Tensor, b: torch.Tensor, *, flag: bool = False):
    """Solve S x = b by block cyclic reduction: :func:`cr_level` until one
    row is left, the root, then :func:`cr_back_level` level by level.

    ``flag=True`` is the plain version of the CUDA cyclic-reduction kernels
    (kernels/direct_fused.py, kernels/longk.py): every inversion clamps a
    zero pivot to 1, and the return is (x, bad) with ``bad`` (...) True
    where a used inversion clamped one in a block whose diagonal is not all
    zero.  With ``flag=False`` a singular pivot propagates inf/NaN, as in
    gato_tpu."""
    L, D, U = S[..., 0, :, :], S[..., 1, :, :], S[..., 2, :, :]
    bb = b
    bad = torch.zeros(b.shape[:-2], dtype=torch.bool, device=b.device)
    levels = []
    while D.shape[-3] > 1:
        m = D.shape[-3]
        (L, D, U, bb), saves, f = cr_level(L, D, U, bb, flag=flag)
        if flag:
            bad = bad | f.any(-1)
        levels.append((saves, m))
    if flag:
        root, f = block_inv_flag(D)
        bad = bad | f.any(-1)
    else:
        root = block_inv(D)
    x = _mv(root, bb)  # (..., 1, s)
    for saves, m in reversed(levels):
        x = cr_back_level(x, *saves, m)
    return (x, bad) if flag else x


def btd_solve_auto(S: torch.Tensor, b: torch.Tensor,
                   use_cr: Optional[bool] = None) -> torch.Tensor:
    """Block Thomas, or cyclic reduction with ``use_cr=True``.  Auto
    (None) takes block Thomas, as gato_tpu does off the TPU; the CUDA
    routes run their own kernels (kernels/direct_fused.py,
    kernels/thomas_batch.py) and never reach this function."""
    return btd_solve_cr(S, b) if use_cr else btd_solve(S, b)

"""Rows 5 and 6: the batched exact solve as block-Thomas elimination, a
forward and a reverse hand-written CUDA kernel.

Replace ``gato_tpu/kernels/thomas_batch.py::_fwd_kernel`` (row 5) and
``::_rev_kernel`` (row 6), entry point ``solve_direct_thomas_batched``.
The CUDA source is ``gato_tpu_torch/csrc/thomas_batch.cu``; its note gives
the design.  The forward kernel condenses every knot at once through the
device functions shared with kernel B (``condense.cuh``), then walks the
knots j = 0..K-1 in a loop of its own:

    M_j = phi_j Cinv_{j-1};  Dhat_j = theta_j - M_j phi_j^T
    bhat_j = gamma_j - M_j bhat_{j-1};  Cinv_j = Dhat_j^{-1}

and writes the factor stacks (:class:`ThomasFactors`).  The reverse kernel
walks j = K-1..0, x_j = Cinv_j (bhat_j - phi_{j+1}^T x_{j+1}), fused with
the dz recovery and the squared true residual, and reports iters = 0, eta
and converged = direct.residual_converged(eta, ||gamma||^2).

A zero pivot clamped in Q_j, R_{j-1} or Dhat_j (in a block whose diagonal
is not all zero) adds +inf to bhat_j: that problem's lambda, dz and eta
turn non-finite and it reports converged False; no other problem changes.
(Row 4, kernels/direct_fused.py, reports eta = 1e30 instead.)

:func:`thomas_fwd_cuda` and :func:`thomas_rev_cuda` take tensors on a CUDA
device to their kernels and raise if a kernel cannot take them; CPU tensors
go to the plain versions :func:`thomas_fwd_plain` and
:func:`thomas_rev_plain`, PyTorch loops over j on the same stacks.
:func:`solve_direct_thomas_cuda` launches both (its plain composite is
:func:`solve_direct_thomas_plain`).  ``FWD_LAUNCHES`` and ``REV_LAUNCHES``
count the two kernels' launches.  :func:`should_dispatch` is the batch
width from which ``method='direct'`` takes this pair instead of row 4.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..assemble import condense_knots
from ..blocktri import block_inv_flag
from ..direct import residual_converged
from ..pcg import PCGResult
from . import _build
from .direct_fused import check_limits
from .fused_solve import block_shapes, check_tensors

FWD_NAME = "thomas_fwd_cuda"
REV_NAME = "thomas_rev_cuda"
SOURCE = "gato_tpu_torch/csrc/thomas_batch.cu"
FWD_REPLACES = "gato_tpu/kernels/thomas_batch.py:306"
REV_REPLACES = "gato_tpu/kernels/thomas_batch.py:429"

FWD_LAUNCHES = 0
REV_LAUNCHES = 0

# gato_tpu's crossover (thomas_batch._MIN_BATCH, measured there on a TPU):
# kept so that the port routes as gato_tpu does.  The H100's own crossover
# is chip_smoke.py's phase 5c (PERF.md): there row 4 was faster per solve at
# every B up to 256, so this threshold is to be replaced by the card's
# (ROADMAP queue 1 item 9).
MIN_BATCH = 16
# Cap on the factor stacks and scratch of one launch pair (gato_tpu's
# _HBM_FACTOR_BUDGET_BYTES): past it the batch goes to row 4.
FACTOR_BUDGET_BYTES = 2 * 1024 ** 3


class ThomasFactors(NamedTuple):
    """What the forward pass writes, per problem: Cinv (K, s, s) the
    inverse pivots Dhat_j^{-1}, bhat (K, s), Qinv (K, s, s), Rinv
    (K-1, c, c), phi (K, s, s) with phi_0 = 0, theta (K, s, s) and gamma
    (K, s), each with the batch axis in front."""

    Cinv: torch.Tensor
    bhat: torch.Tensor
    Qinv: torch.Tensor
    Rinv: torch.Tensor
    phi: torch.Tensor
    theta: torch.Tensor
    gamma: torch.Tensor


def factor_bytes(B: int, K: int, s: int, c: int) -> int:
    """Bytes of the factor stacks and the forward scratch of B problems."""
    per = 4 * K * s * s + (K - 1) * c * c + 2 * K * s + (K - 1) * s * c + 2 * K
    return 4 * B * per


def fits(B: int, K: int, s: int, c: int) -> bool:
    """True if the kernel pair takes (K, s, c) and its stacks fit the
    budget."""
    return (K >= 2 and max(s, c) <= _build.MAX_BLOCK
            and factor_bytes(B, K, s, c) <= FACTOR_BUDGET_BYTES)


def should_dispatch(B: int, K: int, s: int, c: int) -> bool:
    """Whether ``method='direct'`` on the kernel route takes this pair
    (else row 4): B >= MIN_BATCH and the stacks fit (gato_tpu's rule)."""
    return B >= MIN_BATCH and fits(B, K, s, c)


def thomas_fwd_plain(Q, R, A, B, q, r, c, *, rho=0.0) -> ThomasFactors:
    """The forward kernel's plain PyTorch version: every knot's inverses and
    condensed blocks at once (assemble.condense_knots), then a loop over j."""
    K = Q.shape[-3]
    k = condense_knots(Q, R, A, B, q, r, c, rho, flag=True)
    Qinv, Rinv, theta, gamma = k.Qinv, k.Rinv, k.theta, k.gamma
    phi = torch.cat([torch.zeros_like(Qinv[..., :1, :, :]), k.phi], dim=-3)
    bad_knot = k.bad_q.clone()
    bad_knot[..., 1:] |= k.bad_r
    inf = torch.tensor(float("inf"), dtype=Q.dtype, device=Q.device)
    c_inv, bhat = [], []
    for j in range(K):
        if j == 0:
            dh, bc = theta[..., 0, :, :], gamma[..., 0, :]
        else:
            ph = phi[..., j, :, :]
            M = ph @ c_inv[-1]
            dh = theta[..., j, :, :] - M @ ph.transpose(-1, -2)
            bc = gamma[..., j, :] - (M @ bhat[-1].unsqueeze(-1)).squeeze(-1)
        cj, bad_d = block_inv_flag(dh)
        poison = bad_knot[..., j] | bad_d
        bc = bc + torch.where(poison, inf, torch.zeros_like(inf)).unsqueeze(-1)
        c_inv.append(cj)
        bhat.append(bc)
    return ThomasFactors(torch.stack(c_inv, dim=-3), torch.stack(bhat, dim=-2),
                         Qinv, Rinv, phi, theta, gamma)


def thomas_rev_plain(f: ThomasFactors, q, A, B, r):
    """The reverse kernel's plain PyTorch version: a loop over j = K-1..0.
    Returns (PCGResult, dz_x, dz_u)."""
    K = q.shape[-2]

    def mv(M, x):
        return (M @ x.unsqueeze(-1)).squeeze(-1)

    def mtv(M, x):
        return (M.transpose(-1, -2) @ x.unsqueeze(-1)).squeeze(-1)

    lam, dz_x, dz_u = [None] * K, [None] * K, [None] * (K - 1)
    eta = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
    gnorm = torch.zeros_like(eta)
    x_next = part_next = None
    atl = torch.zeros_like(q[..., 0, :])
    for j in range(K - 1, -1, -1):
        u = (torch.zeros_like(atl) if j == K - 1
             else mtv(f.phi[..., j + 1, :, :], x_next))
        x = mv(f.Cinv[..., j, :, :], f.bhat[..., j, :] - u)
        if j < K - 1:
            res = part_next - mv(f.phi[..., j + 1, :, :], x)
            eta = eta + (res * res).sum(-1)
        part = (f.gamma[..., j, :] - mv(f.theta[..., j, :, :], x)) - u
        if j == 0:
            eta = eta + (part * part).sum(-1)
        gnorm = gnorm + (f.gamma[..., j, :] ** 2).sum(-1)
        dz_x[j] = mv(f.Qinv[..., j, :, :], (q[..., j, :] - x) - atl)
        if j > 0:
            dz_u[j - 1] = mv(f.Rinv[..., j - 1, :, :],
                             r[..., j - 1, :] - mtv(B[..., j - 1, :, :], x))
            atl = mtv(A[..., j - 1, :, :], x)
        lam[j] = x
        x_next, part_next = x, part
    res = PCGResult(lam=torch.stack(lam, dim=-2),
                    iters=torch.zeros(eta.shape, dtype=torch.int32, device=eta.device),
                    converged=residual_converged(eta, gnorm), eta=eta)
    return res, torch.stack(dz_x, dim=-2), torch.stack(dz_u, dim=-2)


def solve_direct_thomas_plain(Q, R, A, B, q, r, c, *, rho=0.0):
    """The plain composite of the pair: forward, then reverse."""
    return thomas_rev_plain(thomas_fwd_plain(Q, R, A, B, q, r, c, rho=rho),
                            q, A, B, r)


def _check_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {q.device} are neither CPU nor CUDA")


def thomas_fwd_cuda(Q, R, A, B, q, r, c, *, rho: float = 0.0) -> ThomasFactors:
    """Row 5: condensation and the forward elimination; returns the
    factor stacks.  Arguments follow ``formats.KKTBlocks`` with one leading
    batch axis."""
    if q.device.type == "cpu":
        return thomas_fwd_plain(Q, R, A, B, q, r, c, rho=rho)
    _check_cuda(FWD_NAME, q)
    if Q.ndim != 4:
        raise ValueError(f"{FWD_NAME}: Q must be (B, K, s, s), got {tuple(Q.shape)}")
    Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = block_shapes((Bn,), K, s, cdim)
    tensors = dict(zip(expect, (Q, R, A, B, q, r, c)))
    check_tensors(FWD_NAME, expect, tensors, q.device)
    dev = q.device
    lib = _build.library()
    scratch_floats = lib.gato_thomas_scratch_floats(K, s, cdim)
    check_limits(FWD_NAME, K, s, cdim, scratch_floats,
                 lib.gato_thomas_smem_bytes(K, s, cdim), Bn, dev)
    if factor_bytes(Bn, K, s, cdim) > FACTOR_BUDGET_BYTES:
        raise ValueError(f"{FWD_NAME}: the factor stacks of {Bn} problems at "
                         f"(K, s, c) = ({K}, {s}, {cdim}) exceed "
                         f"{FACTOR_BUDGET_BYTES} B; split the batch or use row 4")
    Q, R, A, B, q, r, c = (t.contiguous() for t in tensors.values())
    scratch = torch.empty(Bn, scratch_floats, dtype=torch.float32, device=dev)
    f = ThomasFactors(Cinv=torch.empty_like(Q), bhat=torch.empty_like(q),
                      Qinv=torch.empty_like(Q), Rinv=torch.empty_like(R),
                      phi=torch.empty_like(Q), theta=torch.empty_like(Q),
                      gamma=torch.empty_like(q))
    if Bn > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gato_thomas_fwd(
                *map(_build.ptr, (Q, R, A, B, q, r, c, scratch, *f)),
                Bn, K, s, cdim, float(rho), ctypes.c_void_p(stream))
        _build.check_launch(code, FWD_NAME)
        global FWD_LAUNCHES
        FWD_LAUNCHES += 1
    return f


def thomas_rev_cuda(f: ThomasFactors, q, A, B, r):
    """Row 6: back-substitution, dz recovery and the true residual on the
    forward pass's stacks.  Returns (PCGResult, dz_x, dz_u)."""
    if q.device.type == "cpu":
        return thomas_rev_plain(f, q, A, B, r)
    _check_cuda(REV_NAME, q)
    if q.ndim != 3:
        raise ValueError(f"{REV_NAME}: q must be (B, K, s), got {tuple(q.shape)}")
    Bn, K, s = q.shape
    cdim = r.shape[-1]
    shapes = block_shapes((Bn,), K, s, cdim)
    expect = dict(Cinv=shapes["Q"], bhat=shapes["q"], Qinv=shapes["Q"],
                  Rinv=shapes["R"], phi=shapes["Q"], theta=shapes["Q"],
                  gamma=shapes["q"], q=shapes["q"], A=shapes["A"],
                  B=shapes["B"], r=shapes["r"])
    tensors = dict(zip(expect, (*f, q, A, B, r)))
    check_tensors(REV_NAME, expect, tensors, q.device)
    if K < 2 or max(s, cdim) > _build.MAX_BLOCK:
        raise ValueError(f"{REV_NAME}: needs K >= 2 and s, c <= {_build.MAX_BLOCK}; "
                         f"got K={K}, s={s}, c={cdim}")
    dev = q.device
    lib = _build.library()
    args = [t.contiguous() for t in tensors.values()]
    lam = torch.empty_like(q)
    dz_x = torch.empty_like(q)
    dz_u = torch.empty_like(r)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gato_thomas_rev(
                *map(_build.ptr, (*args, lam, dz_x, dz_u, conv, eta)),
                Bn, K, s, cdim, ctypes.c_void_p(stream))
        _build.check_launch(code, REV_NAME)
        global REV_LAUNCHES
        REV_LAUNCHES += 1
    res = PCGResult(lam=lam, iters=torch.zeros(Bn, dtype=torch.int32, device=dev),
                    converged=conv != 0, eta=eta)
    return res, dz_x, dz_u


def solve_direct_thomas_cuda(Q, R, A, B, q, r, c, *, rho: float = 0.0):
    """Whole batched exact solve by block Thomas: row 5, then row 6.
    Returns (PCGResult with a batch axis, dz_x (B, K, s), dz_u (B, K-1, c))."""
    return thomas_rev_cuda(thomas_fwd_cuda(Q, R, A, B, q, r, c, rho=rho),
                           q, A, B, r)

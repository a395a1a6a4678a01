"""Rows 5 and 6: the batched exact solve as block-Thomas elimination, a
forward and a reverse hand-written CUDA kernel.

Replace ``gato_tpu/kernels/thomas_batch.py::_fwd_kernel`` (row 5) and
``::_rev_kernel`` (row 6), entry point ``solve_direct_thomas_batched``.
The CUDA source is ``gato_tpu_torch/csrc/thomas_batch.cu``; its note gives
the design.  The forward pass condenses every knot in row 7's tiles
(``csrc/condense_tile.cuh``) across the card, then walks the knots j =
0..K-1 of each problem on one warp, in registers:

    M_j = phi_j Cinv_{j-1};  Dhat_j = theta_j - M_j phi_j^T
    bhat_j = gamma_j - M_j bhat_{j-1};  Cinv_j = Dhat_j^{-1}

and writes the factor stacks (:class:`ThomasFactors`); its plan is
:func:`fwd_plan` (the tile's knots from ``longk.tile_knots``, the walks a
CTA from :func:`walks_per_cta`).  The reverse pass walks j = K-1..0, x_j =
Cinv_j (bhat_j - phi_{j+1}^T x_{j+1}), on one warp a problem with the next
knots' blocks in flight into a ring, then an epilogue, a warp a knot across the card (:func:`epi_tiles`
CTAs a problem), recovers dz from lambda and the squared true residual
(:func:`thomas_epilogue_plain` is its plain version; :func:`rev_plan` the
two launches' plan), and reports iters = 0, eta and converged =
direct.residual_converged(eta, ||gamma||^2).

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
count the two wrappers' calls that launch, ``EPILOGUE_LAUNCHES`` the
reverse epilogue's launches (one a ``thomas_rev_cuda`` call).
:func:`should_dispatch` is the batch width from which ``method='direct'``
takes this pair instead of row 4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..assemble import condense_knots
from ..blocktri import block_inv_flag
from ..direct import residual_converged
from ..pcg import PCGResult
from ..recover import recover_dz
from . import _build
from .fused_solve import block_shapes
from .longk import _check_widths, _limits, _round4, tile_knots

FWD_NAME = "thomas_fwd_cuda"
REV_NAME = "thomas_rev_cuda"
EPILOGUE_NAME = "thomas_rev_epilogue"
SOURCE = "gato_tpu_torch/csrc/thomas_batch.cu"
FWD_REPLACES = "gato_tpu/kernels/thomas_batch.py:306"
REV_REPLACES = "gato_tpu/kernels/thomas_batch.py:429"

FWD_LAUNCHES = 0
REV_LAUNCHES = 0
EPILOGUE_LAUNCHES = 0

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


# Knots a walk keeps in its ring of shared memory (thomas_batch.cu's
# kWalkRing) and walks a forward CTA carries at most (kMaxWalks).
WALK_RING = 4
MAX_WALKS = 8


def walk_width(s: int) -> int:
    """The walk's padded block width: 14 (IIWA's, compiled in), else 16 or
    32 (phi padded with zeros, theta with the identity)."""
    return 14 if s == 14 else (16 if s <= 16 else 32)


def walk_slot_floats(s: int) -> int:
    """Floats of one ring slot: phi_j, theta_j (padded), gamma_j and knot
    j's flag."""
    w = walk_width(s)
    return 2 * _round4(w * w) + _round4(w) + 4


def walk_smem_bytes(s: int, walks: int) -> int:
    """Dynamic shared memory of a walk CTA of ``walks`` warps."""
    return 4 * walks * WALK_RING * walk_slot_floats(s)


def walks_per_cta(B: int, s: int, n_sms: int, limit: int, smem=walk_smem_bytes) -> int:
    """Walks (a warp each) of a forward CTA (a reverse one with ``smem`` =
    :func:`rev_smem_bytes`): ceil(B / n_sms), so that the SMs share the
    walks before a CTA takes two, at most ``MAX_WALKS`` and what ``limit``
    bytes of shared memory hold."""
    walks = min(max(-(-B // n_sms), 1), MAX_WALKS)
    while walks > 1 and smem(s, walks) > limit:
        walks -= 1
    return walks


def fwd_plan(B: int, K: int, s: int, c: int, n_sms: int, limit: int) -> tuple:
    """(tile knots, walks a CTA) of row 5's two launches."""
    return tile_knots(B, K, s, c, n_sms, limit), walks_per_cta(B, s, n_sms, limit)


# Row 6's plan (mirrors of thomas_batch.cu's; the card tests compare them
# with the library's gato_thomas_rev_smem_bytes / gato_thomas_epi_smem_bytes):
# knots the reverse walk keeps in its ring (kRevRing) and knots, a warp
# each, of an epilogue CTA (kEpiKnots).
REV_RING = 8
EPI_KNOTS = 4


def rev_ld(s: int) -> int:
    """The reverse ring's row stride: 14 at IIWA's width, else the padded
    width plus one (odd: a column read by the lanes meets no bank
    conflict)."""
    w = walk_width(s)
    return 14 if w == 14 else w + 1


def rev_slot_floats(s: int) -> int:
    """Floats of one reverse ring slot: Cinv_j, phi_{j+1} (padded rows of
    :func:`rev_ld`) and bhat_j."""
    w = walk_width(s)
    return 2 * _round4(w * rev_ld(s)) + _round4(w)


def rev_smem_bytes(s: int, walks: int) -> int:
    """Dynamic shared memory of a reverse walk CTA of ``walks`` warps."""
    return 4 * walks * REV_RING * rev_slot_floats(s)


def epi_tiles(K: int) -> int:
    """Epilogue CTAs a problem: ceil(K / EPI_KNOTS), a warp a knot."""
    return -(-K // EPI_KNOTS)


def epi_smem_bytes(s: int, c: int) -> int:
    """Dynamic shared memory of an epilogue CTA: each warp's theta_j,
    Qinv_j, phi_j, phi_{j+1}, A_j (s x s), B_j (s x c), Rinv_j (c x c), six
    s-vectors and two c-vectors, each rounded to 4 floats."""
    warp = (5 * _round4(s * s) + _round4(s * c) + _round4(c * c) + 6 * _round4(s)
            + 2 * _round4(c))
    return 4 * EPI_KNOTS * warp


def rev_plan(B: int, K: int, s: int, n_sms: int, limit: int) -> tuple:
    """(walks a CTA, epilogue CTAs a problem) of row 6's two launches: the
    walks as :func:`walks_per_cta` on the reverse ring."""
    return walks_per_cta(B, s, n_sms, limit, rev_smem_bytes), epi_tiles(K)


def factor_bytes(B: int, K: int, s: int, c: int) -> int:
    """Bytes of the factor stacks and a forward scratch of B problems (the
    scratch counted as the first forward kernel's, (K-1) s c + 2 K floats,
    so that the routing stays where it was)."""
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


def thomas_epilogue_plain(f: ThomasFactors, q, A, B, r, lam):
    """Row 6's epilogue in knot-parallel PyTorch ops: dz from lambda
    (``recover.recover_dz``) and the squared true residual, row j
    ((gamma_j - theta_j x_j) - phi_{j+1}^T x_{j+1}) - phi_j x_{j-1}.
    Returns (PCGResult, dz_x, dz_u) as :func:`thomas_rev_plain`."""
    def mv(M, x):
        return (M @ x.unsqueeze(-1)).squeeze(-1)

    zero = torch.zeros_like(lam[..., :1, :])
    x_next = torch.cat([lam[..., 1:, :], zero], dim=-2)
    x_prev = torch.cat([zero, lam[..., :-1, :]], dim=-2)
    phi_next = torch.cat([f.phi[..., 1:, :, :], torch.zeros_like(f.phi[..., :1, :, :])],
                         dim=-3)
    res = ((f.gamma - mv(f.theta, lam)) - mv(phi_next.transpose(-1, -2), x_next)) \
        - mv(f.phi, x_prev)
    eta = (res * res).sum((-2, -1))
    dz_x, dz_u = recover_dz(f.Qinv, f.Rinv, A, B, q, r, lam)
    out = PCGResult(lam=lam, iters=torch.zeros(eta.shape, dtype=torch.int32, device=eta.device),
                    converged=residual_converged(eta, (f.gamma ** 2).sum((-2, -1))), eta=eta)
    return out, dz_x, dz_u


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
    dev = q.device
    tensors = [_build.checked(FWD_NAME, key, x, shape, dev) for (key, shape), x in
               zip(block_shapes((Bn,), K, s, cdim).items(), (Q, R, A, B, q, r, c))]
    _check_widths(FWD_NAME, K, s, cdim)
    if factor_bytes(Bn, K, s, cdim) > FACTOR_BUDGET_BYTES:
        raise ValueError(f"{FWD_NAME}: the factor stacks of {Bn} problems at "
                         f"(K, s, c) = ({K}, {s}, {cdim}) exceed "
                         f"{FACTOR_BUDGET_BYTES} B; split the batch or use row 4")
    Q, R, q = tensors[0], tensors[1], tensors[4]
    f = ThomasFactors(Cinv=torch.empty_like(Q), bhat=torch.empty_like(q),
                      Qinv=torch.empty_like(Q), Rinv=torch.empty_like(R),
                      phi=torch.empty_like(Q), theta=torch.empty_like(Q),
                      gamma=torch.empty_like(q))
    if Bn > 0:
        nk, walks = fwd_plan(Bn, K, s, cdim, *_limits(dev))
        knot_bad = torch.empty(Bn, K, dtype=torch.int32, device=dev)
        _build.launch(FWD_NAME, "gato_thomas_fwd", dev,
                      *(t.data_ptr() for t in (*tensors, *f, knot_bad)),
                      Bn, K, s, cdim, float(rho), nk, walks)
        global FWD_LAUNCHES
        FWD_LAUNCHES += 1
    return f


def thomas_rev_cuda(f: ThomasFactors, q, A, B, r):
    """Row 6: back-substitution (the walk), then dz recovery and the true
    residual (the epilogue) on the forward pass's stacks, two launches.
    Returns (PCGResult, dz_x, dz_u)."""
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
    dev = q.device
    args = [_build.checked(REV_NAME, key, x, shape, dev)
            for (key, shape), x in zip(expect.items(), (*f, q, A, B, r))]
    _check_widths(REV_NAME, K, s, cdim)
    lam = torch.empty_like(args[7])
    dz_x = torch.empty_like(lam)
    dz_u = torch.empty_like(args[10])
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        walks, tiles = rev_plan(Bn, K, s, *_limits(dev))
        scratch = torch.empty(Bn * (2 * tiles + 1), dtype=torch.float32, device=dev)
        _build.launch(REV_NAME, "gato_thomas_rev", dev,
                      *(t.data_ptr() for t in (*args, lam, dz_x, dz_u, conv, eta, scratch)),
                      Bn, K, s, cdim, walks)
        global REV_LAUNCHES, EPILOGUE_LAUNCHES
        REV_LAUNCHES += 1
        EPILOGUE_LAUNCHES += 1
    res = PCGResult(lam=lam, iters=torch.zeros(Bn, dtype=torch.int32, device=dev),
                    converged=conv != 0, eta=eta)
    return res, dz_x, dz_u


def solve_direct_thomas_cuda(Q, R, A, B, q, r, c, *, rho: float = 0.0):
    """Whole batched exact solve by block Thomas: row 5, then row 6.
    Returns (PCGResult with a batch axis, dz_x (B, K, s), dz_u (B, K-1, c))."""
    return thomas_rev_cuda(thomas_fwd_cuda(Q, R, A, B, q, r, c, rho=rho),
                           q, A, B, r)

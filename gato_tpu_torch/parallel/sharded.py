"""Knot-sharded solves over a device mesh, and data-parallel batches and
farms: the counterpart of ``gato_tpu.parallel.sharded``.

**Knot sharding** (:func:`solve_sharded`, :func:`pcg_sharded`,
:func:`btd_solve_sharded`) splits one long trajectory of K knots into n
contiguous shards of Kl = K / n knots, one on each device of the mesh
(mesh.py: single-controller, a device may repeat).

* Condensation: each shard condenses its knots with two ghost knots on
  the left and one on the right, then drops the ghost rows.  theta_k reads
  knot k-1 and interval k-1, the stair's P_left_k reads theta_{k-1}^{-1}
  (so knot k-2), and slot 2 of row k reads knot k+1: with the ghosts every
  kept row is the row of the whole problem's condensation, and no seam
  needs a patch.  ``gato_tpu`` instead runs its condense kernel on the
  shard alone and patches the seam rows from one ppermuted carry
  (``sharded.py:671-752``), a patch shaped by the TPU's lane layout.  The
  ghosts cost three knots of condensation a shard.
* PCG: the recurrence of ``pcg.pcg`` on per-shard lists.  A matvec (of S
  and of Pinv) sends each shard's first and last rows to its neighbours
  (:func:`mesh.shift_left` / :func:`mesh.shift_right`; no halo, meaning
  zeros, at the trajectory's ends) and runs row 15 (kernels/halo_matvec.py) on every
  shard; a dot adds the shards' partial sums in shard order
  (:func:`mesh.psum`).  The loop runs on the host and reads eta every
  iteration, as ``pcg.pcg`` does.
* Recovery: each shard's last dz_x and dz_u rows read the right
  neighbour's first lambda row (zeros on the last shard).

Two tiers of the same math (``use_kernel``): the kernel tier condenses a
shard with row 7 (``longk.condense_longk_cuda``), multiplies with row 15
and recovers with row 13 (``longk.recover_longk_cuda``); the torch tier
runs ``assemble.condense``, ``blocktri.btd_matvec`` with halos and
``recover.recover_dz``.  ``use_kernel=None`` takes the kernel tier when
every mesh device is CUDA and the data is float32, else the torch tier;
an explicit True on a CUDA mesh in float64 raises (the kernels are
float32-only), and on a CPU mesh runs the kernels' plain versions, as
every kernel wrapper does for CPU tensors.  Row 7's zero-pivot flag is
not used on this path: ``gato_tpu``'s sharded condensation drops it too,
so a singular block propagates inf/NaN as on its einsum tier.

``method='direct'`` is ``gato_tpu``'s exact substructuring (SPIKE): each
shard eliminates its interior rows with one multi-right-hand-side block
Thomas sweep, the n-row interface system is gathered and solved by cyclic
reduction, and each shard recovers its interior.  It runs in torch ops, as
``gato_tpu`` runs it in XLA (no Pallas kernel there, so no CUDA kernel
here).

**Data parallelism** (:func:`solve_batched_dp`,
:func:`solve_sequence_batched_dp`) splits a batch of problems, or a farm's
streams, into n contiguous groups, one on each device, and runs the port's
own single-device surface on each group (``solver.solve_batched``,
``mpc.solve_sequence_batched``) with its routing unchanged.  There is no
communication until the results are gathered.

:func:`solve_packed_dp` serves one ``packed.PackedKKT`` the same way: the
pack's problems split into n contiguous groups, group i solved by
``packed.solve_packed`` on device i on the group's slices of the staged
tensors, the pack's tier kept.  ``gato_tpu`` shards its packing's lane
groups; the port's pack has no lanes (packed.py), so its group is a block
of problems, as in :func:`solve_batched_dp`.

Every entry point returns its results on the mesh's first device, in the
original order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import assemble, direct, recover
from ..blocktri import btd_matvec
from ..formats import KKTBlocks
from ..kernels import halo_matvec, longk
from ..mpc import solve_sequence_batched
from ..packed import (PackedKKT, PackedSolveResult, _check_options, _warm_start,
                      solve_packed)
from ..pcg import PCGResult
from ..problem import Preconditioner, ProblemSpec, SolverOptions
from ..solver import solve_batched
from .mesh import (Mesh, all_gather, gather, psum, replicate, shift_left,
                   shift_right)

# Ghost knots a shard condenses on either side of its own (module note).
GHOSTS_LEFT = 2
GHOSTS_RIGHT = 1


def _shards(mesh: Mesh, axis_name: str, K: int, what: str = "knot_points"):
    """(n, Kl): the axis size and the knots a shard; raises unless n
    divides K."""
    n = mesh.size(axis_name)
    if K % n:
        raise ValueError(f"{what}={K} not divisible by mesh axis {axis_name}={n}")
    return n, K // n


def _resolve_use_kernel(mesh: Mesh, dtype: torch.dtype,
                        use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        return mesh.all_cuda and dtype == torch.float32
    if use_kernel and dtype != torch.float32 and any(
            d.type == "cuda" for d in mesh.devices):
        raise ValueError(f"use_kernel=True runs float32-only CUDA kernels; the "
                         f"data is {dtype}: pass use_kernel=None or False")
    return bool(use_kernel)


def _tensor(x, dtype=None) -> torch.Tensor:
    if not torch.is_tensor(x):
        a = np.asarray(x)
        x = torch.as_tensor(a if a.flags.writeable else a.copy())
    return x if dtype is None else x.to(dtype)


def _split(x: torch.Tensor, devices, Kl: int) -> list:
    """Shard i of x along its leading axis (rows i Kl .. (i+1) Kl - 1) on
    device i."""
    return [x[i * Kl:(i + 1) * Kl].to(d).contiguous()
            for i, d in enumerate(devices)]


# --------------------------------------------------------------------------
# Knot-sharded PCG.


def _matvec(mv, devices, M: list, x: list) -> list:
    """M x on every shard: the neighbours' boundary rows in as halos, none
    (zeros, with no tensor filled) at the trajectory's ends."""
    left = shift_right([xi[-1] for xi in x], devices, edge_zeros=False)
    right = shift_left([xi[0] for xi in x], devices, edge_zeros=False)
    return [mv(Mi, xi, li, ri) for Mi, xi, li, ri in zip(M, x, left, right)]


def _dot(devices, a: list, b: list) -> torch.Tensor:
    return psum([(ai * bi).sum() for ai, bi in zip(a, b)], devices)


def _axpy(devices, alpha: torch.Tensor, x: list, y: list) -> list:
    """y + alpha x on every shard."""
    return [yi + ai * xi for ai, xi, yi in zip(replicate(alpha, devices), x, y)]


def _pcg_shards(devices, S: list, Pinv: list, gamma: list, lam0: list, *,
                exit_tol, max_iters: int, poly_degree: int, mv) -> PCGResult:
    """``pcg.pcg``'s recurrence for one problem on per-shard lists: the
    same iteration convention, alpha and beta guards and Horner form of
    ``poly_degree``, with ``mv`` (a halo matvec) on each shard.  Returns
    lam as a list of shards and iters, converged, eta on the first
    device."""
    def matvec(M, x):
        return _matvec(mv, devices, M, x)

    def apply_P(r):
        y = matvec(Pinv, r)
        for _ in range(poly_degree - 1):
            Sy = matvec(S, y)
            y = [yi + zi for yi, zi in
                 zip(y, matvec(Pinv, [ri - si for ri, si in zip(r, Sy)]))]
        return y

    dt, dev = gamma[0].dtype, devices[0]
    tol = torch.tensor(exit_tol, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    lam = lam0
    r = [g - x for g, x in zip(gamma, matvec(S, lam))]
    r_tilde = apply_P(r)
    p = r_tilde
    eta = _dot(devices, r, r_tilde)
    iters, converged = int(max_iters), False
    for it in range(int(max_iters)):
        upsilon = matvec(S, p)
        nu = _dot(devices, p, upsilon)
        alpha = torch.where(nu != 0, eta / nu, zero)
        lam = _axpy(devices, alpha, p, lam)
        r = _axpy(devices, -alpha, upsilon, r)
        r_tilde = apply_P(r)
        eta_new = _dot(devices, r, r_tilde)
        beta = torch.where(eta != 0, eta_new / eta, zero)
        p = _axpy(devices, beta, p, r_tilde)
        eta = eta_new
        if bool(eta_new.abs() < tol):
            iters, converged = it, True
            break
    return PCGResult(lam=lam,
                     iters=torch.tensor(iters, dtype=torch.int32, device=dev),
                     converged=torch.tensor(converged, device=dev),
                     eta=eta.abs())


def _check_poly(poly_degree) -> None:
    if not isinstance(poly_degree, int) or poly_degree < 1:
        raise ValueError(f"poly_degree must be an int >= 1, got {poly_degree!r}")


def _halo_mv(use_kernel: bool):
    return halo_matvec.halo_matvec_cuda if use_kernel else btd_matvec


def pcg_sharded(
    mesh: Mesh,
    S,
    Pinv,
    gamma,
    lam0=None,
    *,
    exit_tol=1e-6,
    max_iters=100,
    poly_degree: int = 1,
    axis_name: str = "knot",
    use_kernel: Optional[bool] = None,
) -> PCGResult:
    """PCG on S lam = gamma (S, Pinv (K, 3, s, s), gamma (K, s)) with the
    knot axis sharded over ``mesh[axis_name]``; K must divide by the axis
    size.  ``use_kernel`` picks row 15 or its plain version for every
    matvec (module note).  Returns a PCGResult with lam (K, s) and scalar
    iters, converged and eta, all on the mesh's first device."""
    gamma = _tensor(gamma)
    dt = gamma.dtype
    S, Pinv = _tensor(S, dt), _tensor(Pinv, dt)
    lam0 = torch.zeros_like(gamma) if lam0 is None else _tensor(lam0, dt)
    n, Kl = _shards(mesh, axis_name, gamma.shape[0])
    _check_poly(poly_degree)
    use_kernel = _resolve_use_kernel(mesh, dt, use_kernel)
    devs = mesh.devices
    res = _pcg_shards(devs, _split(S, devs, Kl), _split(Pinv, devs, Kl),
                      _split(gamma, devs, Kl), _split(lam0, devs, Kl),
                      exit_tol=exit_tol, max_iters=max_iters,
                      poly_degree=poly_degree, mv=_halo_mv(use_kernel))
    return res._replace(lam=gather(res.lam, devs[0]))


# --------------------------------------------------------------------------
# Knot-sharded exact solve: substructuring (SPIKE).


def _spike(devices, S: list, b: list) -> list:
    """S x = b exactly on shards of Kl >= 2 rows (``gato_tpu``'s
    ``_btd_solve_direct_local``).  Rows 0..Kl-2 of a shard are its
    interior, row Kl-1 its interface unknown t_p.  One multi-right-hand-side
    block Thomas sweep a shard gives x_int = y - V t_{p-1} - W t_p; each
    interface equation, with the right neighbour's first (y, V, W) row,
    gives one row of the n-row interface system, gathered on the first
    device and solved by cyclic reduction."""
    n = len(devices)
    s = b[0].shape[-1]
    parts = []
    for Si, bi in zip(S, b):
        m = bi.shape[0] - 1
        L, D, U = Si[:, 0], Si[:, 1], Si[:, 2]
        zero = torch.zeros_like(L[:1])
        Lint = torch.cat([zero, L[1:m]])
        Uint = torch.cat([U[:m - 1], zero])
        Bm = torch.zeros((m, s, 1 + 2 * s), dtype=bi.dtype, device=bi.device)
        Bm[:, :, 0] = bi[:m]
        Bm[0, :, 1:1 + s] = L[0]
        Bm[m - 1, :, 1 + s:] += U[m - 1]
        X = direct.thomas_multi(Lint, D[:m], Uint, Bm)
        parts.append((X[:, :, 0], X[:, :, 1:1 + s], X[:, :, 1 + s:]))
    first = [torch.cat([y[0][:, None], V[0], W[0]], dim=1) for y, V, W in parts]
    nbr = shift_left(first, devices)
    rows, rhs = [], []
    for Si, bi, (y, V, W), nb in zip(S, b, parts, nbr):
        y_n, V_n, W_n = nb[:, 0], nb[:, 1:1 + s], nb[:, 1 + s:]
        L_l, D_l, U_l = Si[-1, 0], Si[-1, 1], Si[-1, 2]
        rows.append(torch.stack([-L_l @ V[-1], D_l - L_l @ W[-1] - U_l @ V_n,
                                 -U_l @ W_n]))
        rhs.append(bi[-1] - L_l @ y[-1] - U_l @ y_n)
    t = direct.btd_solve_cr(all_gather(rows, devices[0]),
                            all_gather(rhs, devices[0]))
    t_here = replicate(t, devices)
    x = []
    for p, ((y, V, W), tp) in enumerate(zip(parts, t_here)):
        t_prev = tp[p - 1] if p > 0 else torch.zeros_like(tp[0])
        x_int = (y - torch.einsum("mab,b->ma", V, t_prev)
                 - torch.einsum("mab,b->ma", W, tp[p]))
        x.append(torch.cat([x_int, tp[p][None]]))
    return x


def btd_solve_sharded(mesh: Mesh, S, b, *, axis_name: str = "knot") -> torch.Tensor:
    """Exact block-tridiagonal solve S x = b (S (K, 3, s, s), b (K, s)) with
    the row axis sharded over the mesh: K must divide by the axis size with
    at least 2 rows a shard (a 1-row shard has no interior; that placement
    is the interface system itself, a single-device solve).  Returns x
    (K, s) on the mesh's first device."""
    b = _tensor(b)
    S = _tensor(S, b.dtype)
    K = b.shape[0]
    n, Kl = _shards(mesh, axis_name, K)
    if Kl < 2:
        raise ValueError(f"btd_solve_sharded needs >= 2 rows per shard (K={K}, "
                         f"mesh {axis_name}={n}); use direct.btd_solve on one "
                         "device")
    devs = mesh.devices
    return gather(_spike(devs, _split(S, devs, Kl), _split(b, devs, Kl)), devs[0])


# --------------------------------------------------------------------------
# The whole knot-sharded solve.


class _Shard(NamedTuple):
    """One shard's condensed system and what its recovery reads: S, Pinv
    (None for method='direct') (Kl, 3, s, s), gamma (Kl, s); Qinv
    (Kl, s, s), Rinv (Kl, c, c) (a zero block past the trajectory's last
    interval); the shard's A, B, q, r."""

    S: torch.Tensor
    Pinv: Optional[torch.Tensor]
    gamma: torch.Tensor
    Qinv: torch.Tensor
    Rinv: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor


def _condense_shards(devices, blocks: KKTBlocks, Kl: int, rho: float,
                     preconditioner: Optional[Preconditioner],
                     use_kernel: bool) -> list:
    """Each shard condensed on its device with its ghost knots (module
    note), by row 7 or by ``assemble.condense``.  ``blocks`` has R, A, B
    and r padded by one zero interval (K rows each)."""
    Q, R, A, B, q, r, c = blocks
    K = q.shape[0]
    shards = []
    for i, dev in enumerate(devices):
        a, b = i * Kl, (i + 1) * Kl
        lo, hi = max(a - GHOSTS_LEFT, 0), min(b + GHOSTS_RIGHT, K)
        sub = [x.to(dev) for x in (Q[lo:hi], R[lo:hi - 1], A[lo:hi - 1],
                                   B[lo:hi - 1], q[lo:hi], r[lo:hi - 1],
                                   c[lo:hi])]
        if use_kernel:
            ops = longk.condense_longk_cuda(*(x.unsqueeze(0) for x in sub),
                                            rho=rho,
                                            preconditioner=preconditioner.value)
            St, Pt, gt_, Qi, Ri = (x[0] for x in ops[:5])
        else:
            sys = assemble.condense(*sub, rho, preconditioner)
            St, Pt, gt_, Qi, Ri = sys.S, sys.Pinv, sys.gamma, sys.Qinv, sys.Rinv
        keep = slice(a - lo, a - lo + Kl)
        Ri = Ri[keep]
        if Ri.shape[0] < Kl:   # the last shard: zero past the last interval
            Ri = torch.cat([Ri, torch.zeros_like(Ri[:1])])
        shards.append(_Shard(
            St[keep], None if Pt is None else Pt[keep], gt_[keep], Qi[keep], Ri,
            *(x[a:b].to(dev) for x in (A, B, q, r))))
    return shards


def _recover_shards(devices, shards: list, lam: list, use_kernel: bool):
    """dz_x (Kl, s) and dz_u (Kl, c) of every shard.  A shard's recovery
    runs on Kl + 1 knots, the last one a ghost with lambda the right
    neighbour's first row (zeros after the last shard) and a zero Qinv and
    q, whose dz_x row is dropped."""
    nxt = shift_left([x[0] for x in lam], devices)
    out = []
    for sh, lm, ln in zip(shards, lam, nxt):
        Qinv = torch.cat([sh.Qinv, torch.zeros_like(sh.Qinv[:1])])
        q = torch.cat([sh.q, torch.zeros_like(sh.q[:1])])
        lam_ext = torch.cat([lm, ln[None]])
        args = (Qinv, sh.Rinv, sh.A, sh.B, q, sh.r, lam_ext)
        if use_kernel:
            dz_x, dz_u = longk.recover_longk_cuda(*(x.unsqueeze(0) for x in args))
            dz_x, dz_u = dz_x[0], dz_u[0]
        else:
            dz_x, dz_u = recover.recover_dz(*args)
        out.append((dz_x[:-1], dz_u))
    return out


def _solve_direct(devices, shards: list, Kl: int) -> PCGResult:
    """method='direct' on condensed shards: SPIKE, or with 1-row shards
    block Thomas on the whole system gathered on the first device;
    ``converged`` from the true residual (direct.residual_converged)."""
    dev0 = devices[0]
    S = [sh.S for sh in shards]
    gamma = [sh.gamma for sh in shards]
    if Kl < 2:
        x = direct.btd_solve_auto(gather(S, dev0), gather(gamma, dev0))
        lam = [x[i * Kl:(i + 1) * Kl].to(d) for i, d in enumerate(devices)]
    else:
        lam = _spike(devices, S, gamma)
    resid = [g - y for g, y in zip(gamma, _matvec(btd_matvec, devices, S, lam))]
    eta = _dot(devices, resid, resid)
    gamma_sq = _dot(devices, gamma, gamma)
    return PCGResult(lam=lam, iters=torch.zeros((), dtype=torch.int32, device=dev0),
                     converged=direct.residual_converged(eta, gamma_sq), eta=eta)


def solve_sharded(
    mesh: Mesh,
    Q, R, A, B, q, r, c,
    lam0=None,
    *,
    rho=0.0,
    exit_tol=1e-6,
    max_iters=100,
    preconditioner=Preconditioner.SYMMETRIC_STAIR,
    poly_degree: int = 1,
    axis_name: str = "knot",
    use_kernel: Optional[bool] = None,
    method: str = "pcg",
):
    """One KKT solve with the knot axis sharded over ``mesh[axis_name]``.

    Arguments follow ``formats.KKTBlocks`` for one problem (NumPy arrays or
    tensors, on any device; the dtype is Q's); K must divide by the axis
    size.  The interval arrays (R, A, B, r: K-1 rows) are padded by one
    zero row so that every shard holds Kl of them; the pad never
    contributes.  ``use_kernel`` picks the tier (module note); with 1-knot
    shards (K equal to the axis size) ``method='pcg'`` takes the torch
    tier, as ``gato_tpu`` does.

    ``method='direct'`` condenses without a preconditioner and solves
    exactly by substructuring (:func:`btd_solve_sharded`), or with 1-knot
    shards by block Thomas on the whole system; ``converged`` comes from
    the true residual, iters is 0.  It runs in torch ops only, so
    ``use_kernel=True`` raises there.

    Returns (PCGResult with lam (K, s) and scalar iters, converged, eta;
    dz_x (K, s); dz_u (K-1, c)), all on the mesh's first device."""
    dt = _tensor(Q).dtype
    blocks = KKTBlocks(*(_tensor(x, dt) for x in (Q, R, A, B, q, r, c)))
    K = blocks.q.shape[0]
    n, Kl = _shards(mesh, axis_name, K)
    if method not in ("pcg", "direct"):
        raise ValueError(f"solve_sharded supports method in ('pcg', 'direct'); "
                         f"got {method!r}")
    if method == "direct" and use_kernel:
        raise ValueError("method='direct' has no kernel-tier executor to select; "
                         "drop use_kernel (the exact tier is substructuring in "
                         "torch ops)")
    _check_poly(poly_degree)

    def pad1(x):
        return torch.cat([x, torch.zeros_like(x[:1])])

    blocks = blocks._replace(R=pad1(blocks.R), A=pad1(blocks.A),
                             B=pad1(blocks.B), r=pad1(blocks.r))
    devs = mesh.devices
    if method == "direct":
        shards = _condense_shards(devs, blocks, Kl, rho, None, False)
        res = _solve_direct(devs, shards, Kl)
        tier = False
    else:
        tier = _resolve_use_kernel(mesh, dt, use_kernel) and Kl >= 2
        shards = _condense_shards(devs, blocks, Kl, rho,
                                  Preconditioner(preconditioner), tier)
        lam0 = torch.zeros_like(blocks.q) if lam0 is None else _tensor(lam0, dt)
        res = _pcg_shards(devs, [sh.S for sh in shards],
                          [sh.Pinv for sh in shards],
                          [sh.gamma for sh in shards], _split(lam0, devs, Kl),
                          exit_tol=exit_tol, max_iters=max_iters,
                          poly_degree=poly_degree, mv=_halo_mv(tier))
    dz = _recover_shards(devs, shards, res.lam, tier)
    dz_x = gather([x for x, _ in dz], devs[0])
    dz_u = gather([u for _, u in dz], devs[0])[:K - 1]
    return res._replace(lam=gather(res.lam, devs[0])), dz_x, dz_u


# --------------------------------------------------------------------------
# Data parallelism: problems and streams split over the mesh.


def _options(dtype: torch.dtype, **kw) -> SolverOptions:
    return SolverOptions(dtype=str(dtype).removeprefix("torch."), **kw)


def solve_batched_dp(
    mesh: Mesh,
    Q, R, A, B, q, r, c,
    lam0=None,
    *,
    rho=0.0,
    exit_tol=1e-6,
    max_iters=100,
    poly_degree: int = 1,
    preconditioner="symmetric_stair",
    axis_name: str = "dp",
    method: str = "pcg",
):
    """Data-parallel batched solves: the B problems (a leading batch axis on
    every array, B divisible by the axis size) split into n contiguous
    groups, group i solved by ``solver.solve_batched`` on device i with
    that surface's routing at the group's batch width (kernel B, row 4 or
    the Thomas pair, the long-K tiers).  ``lam0`` (B, K, s), where given,
    warm-starts the PCG solves.  No communication until the results are
    gathered.

    Returns (PCGResult, dz_x, dz_u) with the batch axis, gathered on the
    mesh's first device in the original order."""
    if method not in ("pcg", "direct"):
        raise ValueError(f"solve_batched_dp supports method in ('pcg', 'direct'); "
                         f"got {method!r}")
    dt = _tensor(Q).dtype
    blocks = KKTBlocks(*(_tensor(x, dt) for x in (Q, R, A, B, q, r, c)))
    Bn, K, s = blocks.q.shape
    n, g = _shards(mesh, axis_name, Bn, what="batch")
    spec = ProblemSpec(s, blocks.r.shape[-1], K)
    opts = _options(dt, exit_tol=exit_tol, max_iters=max_iters,
                    warm_start=lam0 is not None, rho=rho,
                    preconditioner=preconditioner, method=method,
                    precond_poly_degree=poly_degree)
    lam0 = None if lam0 is None else _tensor(lam0, dt)
    outs = []
    for i, dev in enumerate(mesh.devices):
        part = slice(i * g, (i + 1) * g)
        outs.append(solve_batched(spec, KKTBlocks(*(x[part] for x in blocks)),
                                  opts, lam0=None if lam0 is None else lam0[part],
                                  device=dev))
    lam, dz_x, dz_u, iters, conv, eta = (gather(list(f), mesh.devices[0])
                                         for f in zip(*outs))
    return PCGResult(lam=lam, iters=iters, converged=conv, eta=eta), dz_x, dz_u


def solve_sequence_batched_dp(
    mesh: Mesh,
    Q, R, A, B, q, r, c,
    lam0=None,
    rhos=None,
    *,
    rho=0.0,
    exit_tol=1e-6,
    max_iters=100,
    poly_degree: int = 1,
    preconditioner="symmetric_stair",
    axis_name: str = "dp",
    method: str = "pcg",
):
    """An MPC farm split over the mesh: arrays carry leading (T, B) axes,
    and the B streams (divisible by the axis size) split into n contiguous
    groups, group i run by ``mpc.solve_sequence_batched`` on device i
    (the farm kernel, the long-K tier, or with ``method='direct'`` the
    exact farm, at the group's width).  ``lam0`` (B, K, s) warm-starts step
    0 (zeros by default), ``rhos`` (T,) defaults to ``rho``.

    Returns (lam, dz_x, dz_u, iters, converged, eta) with (T, B) leading
    axes, gathered on the mesh's first device in the original order."""
    if method not in ("pcg", "direct"):
        raise ValueError(f"solve_sequence_batched_dp supports method in ('pcg', "
                         f"'direct'); got {method!r}")
    dt = _tensor(Q).dtype
    blocks = KKTBlocks(*(_tensor(x, dt) for x in (Q, R, A, B, q, r, c)))
    T, Bn, K, s = blocks.q.shape
    n, g = _shards(mesh, axis_name, Bn, what="stream count")
    spec = ProblemSpec(s, blocks.r.shape[-1], K)
    opts = _options(dt, exit_tol=exit_tol, max_iters=max_iters, rho=rho,
                    preconditioner=preconditioner, method=method,
                    precond_poly_degree=poly_degree)
    lam0 = None if lam0 is None else _tensor(lam0, dt)
    outs = []
    for i, dev in enumerate(mesh.devices):
        part = slice(i * g, (i + 1) * g)
        outs.append(solve_sequence_batched(
            spec, KKTBlocks(*(x[:, part] for x in blocks)), opts,
            lam0=None if lam0 is None else lam0[part], rhos=rhos, device=dev))
    return tuple(gather(list(f), mesh.devices[0], dim=1) for f in zip(*outs))


def _local_packs(mesh: Mesh, packed: PackedKKT, g: int) -> list:
    """Group i of the pack (problems i g .. (i+1) g - 1) on device i, with
    the pack's plan at batch width g.  Where device i is the pack's own, the
    group's tensors are views of the pack's (``.to`` returns them as they
    are); elsewhere they are copies."""
    local = packed.plan._replace(batch=g)
    tensors = (packed.Qb, packed.Rb, packed.Ab, packed.Bb, packed.qb, packed.rb,
               packed.cb)
    return [PackedKKT(*(t[i * g:(i + 1) * g].to(dev) for t in tensors), plan=local)
            for i, dev in enumerate(mesh.devices)]


def solve_packed_dp(mesh: Mesh, packed: PackedKKT, options=None, lam0=None,
                    *, axis_name: str = "dp") -> PackedSolveResult:
    """Serve one :class:`PackedKKT` over the mesh: ``gato_tpu``'s
    ``solve_packed_dp`` with the port's groups.

    The pack's B problems split into n contiguous groups of g = B / n
    (``axis_name``'s size n must divide B), and device i runs
    ``packed.solve_packed`` on problems i g .. (i+1) g - 1 with the pack's
    plan at batch width g: the tier the pack recorded ('thomas' stays the
    Thomas pair at any g, 'longk' the long-K tier), each kernel at the
    group's own launch plan (kernel B's and row 4's cluster size is chosen
    from g), so a problem's bits are those of ``solve_packed`` on its group
    alone, and agree with the whole-batch solve within float32 round-off.

    Placement: where the mesh repeats the pack's device (``Mesh(["cuda:0"]
    * n)``) a group's tensors are views of the pack and nothing is copied
    in; on a mesh of other devices each call copies every group to its
    device, as ``gato_tpu``'s ``shard_map`` places a pack that is not
    already on the mesh.  The loop over devices reads nothing back to the
    host, so groups on distinct cards run at once.  The results are gathered
    on the mesh's first device in the original order, the one new
    allocation on a repeated device.

    ``lam0``: None (cold start), the packed carry (B, K, s) (a previous
    result's ``lam_packed``) or the public shape, split by rows the same
    way; a supplied ``lam0`` is used whatever ``options.warm_start`` says,
    and an exact solve reads none.

    Returns a ``PackedSolveResult`` with the pack's (global) plan,
    so ``unpack()`` and ``lam_packed`` work as on ``solve_packed``'s.

    Raises ValueError, as ``gato_tpu``'s does, for ``options.method`` other
    than the pack's (this function does not relabel; ``solve_packed``
    serves either method from one pack), a dtype other than float32, a
    batch not divisible by the mesh axis (so an unbatched pack needs a mesh
    of one device), or an ``axis_name`` the mesh does not have; and
    RuntimeError for a CUDA pack or mesh where CUDA is absent."""
    options = SolverOptions() if options is None else options
    plan = packed.plan
    n = mesh.size(axis_name)
    if options.method != plan.method:
        raise ValueError(
            f"this PackedKKT was packed for method={plan.method!r}; "
            f"solve_packed_dp does not relabel: repack with "
            f"pack(..., method={options.method!r}) or call solve_packed")
    _check_options(options, "solve_packed_dp")
    if plan.batch % n:
        raise ValueError(f"packed batch={plan.batch} not divisible by mesh axis "
                         f"{axis_name}={n}")
    g = plan.batch // n
    if lam0 is not None:
        carry = (plan.batch, plan.K, plan.s)
        public = carry if plan.batched else (plan.K, plan.s)
        lam0 = _warm_start(lam0, carry, public, packed.qb.device)
    outs = [solve_packed(local, options,
                         lam0=None if lam0 is None else lam0[i * g:(i + 1) * g].to(dev))
            for i, (local, dev) in enumerate(zip(_local_packs(mesh, packed, g),
                                                 mesh.devices))]
    fields = ("lam_p", "dzx_p", "dzu_p", "iters", "converged", "eta")
    return PackedSolveResult(
        *(gather([getattr(o, f) for o in outs], mesh.devices[0]) for f in fields),
        plan=plan)

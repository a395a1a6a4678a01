"""Rows 7-13: the long-horizon tiers as hand-written CUDA kernels, for
horizons past the shared memory of kernels A and B (PCG) and of row 4
(the exact solve).

Replace ``gato_tpu/kernels/longk.py``: ``_condense_kernel`` (row 7), the
inner kernel of ``_pcg_xl_call`` (row 8) and ``_pcg_stream_kernel`` (row
10), ``_fused_xl_kernel`` (row 9), the inner kernel of ``_direct_xl_call``
(row 11), ``_peel_kernel`` (row 12) and ``_recover_kernel`` (row 13),
entry points ``solve_longk_batched`` / ``solve_longk`` and
``solve_direct_longk_batched`` / ``solve_direct_longk``.  The CUDA sources
are ``gato_tpu_torch/csrc/longk.cu`` (rows 7-10 and 13: condensation tiles
that recompute their neighbour knots instead of carrying them, a
cooperative PCG launch with grid barriers and per-CTA partial sums added
in one fixed order, knot-parallel recovery) and ``csrc/longk_direct.cu``
(rows 11 and 12: block cyclic reduction with one warp a block row, the
whole reduction in one cooperative launch, a compacting level in two
launches, and the back-substitution of a compacted level); their notes
give the designs.  Rows 8 and 10 compute one function, PCG on condensed
operators, which the TPU split by whether the operators fit VMEM; on the
card that is the L2 cache's business, so one kernel, :func:`pcg_longk_cuda`,
replaces both.  The TPU layout (knots on 128 lanes, ``plan_longk``
chunking, VMEM budgets, the lane shift of the stair's slot 2, the peel's
lane padding and chunk schedule) has no counterpart: the port works in the
public (B, K, ...) layout.

Each wrapper takes tensors on a CUDA device to its kernel and raises if the
kernel cannot take them; CPU tensors go to its plain version:

* :func:`condense_longk_cuda` (row 7): ``assemble.condense(flag=True)``;
* :func:`pcg_longk_cuda` (rows 8 and 10): ``pcg.pcg(frozen=...)``;
* :func:`fused_longk_cuda` (row 9): the two together;
* :func:`cr_longk_cuda` (row 11): ``direct.btd_solve_cr(flag=True)``;
* :func:`peel_longk_cuda` (row 12): one ``direct.cr_level``;
* :func:`unpeel_longk_cuda`: its back-substitution, ``direct.cr_back_level``;
* :func:`recover_longk_cuda` (row 13): ``recover.recover_dz``.

``*_LAUNCHES`` count each kernel's launches.  :func:`solve_longk_batched`
runs a PCG tier: ``'fused_xl'`` is row 9 then row 13; ``'xl'`` and
``'stream'`` are both row 7, rows 8/10, row 13 (on this card they are the
same route).  :func:`solve_direct_longk_batched` runs an exact tier:
``'xl'`` is rows 7, 11 and 13; ``'hybrid'`` peels with row 12 before row
11 and back-substitutes after it.  :func:`should_dispatch` and
:func:`should_dispatch_direct` say where the solver routes ``method='pcg'``
and ``method='direct'`` here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..assemble import condense
from ..direct import (btd_solve_cr, cr_back_level, cr_level, residual_converged,
                      residual_norms)
from ..pcg import PCGResult, pcg
from ..problem import Preconditioner
from ..recover import recover_dz
from . import _build, direct_fused, pcg_kernel
from .fused_solve import PRECOND_CODES, block_shapes, check_tensors

SOURCE = "gato_tpu_torch/csrc/longk.cu"
DIRECT_SOURCE = "gato_tpu_torch/csrc/longk_direct.cu"
CONDENSE_NAME = "condense_longk_cuda"
PCG_NAME = "pcg_longk_cuda"
FUSED_NAME = "fused_longk_cuda"
RECOVER_NAME = "recover_longk_cuda"
CR_NAME = "cr_longk_cuda"
PEEL_NAME = "peel_longk_cuda"
UNPEEL_NAME = "unpeel_longk_cuda"
CONDENSE_REPLACES = "gato_tpu/kernels/longk.py:352"
PCG_REPLACES = "gato_tpu/kernels/longk.py:430, gato_tpu/kernels/longk.py:661"
FUSED_REPLACES = "gato_tpu/kernels/longk.py:547"
RECOVER_REPLACES = "gato_tpu/kernels/longk.py:1464"
CR_REPLACES = "gato_tpu/kernels/longk.py:860"
PEEL_REPLACES = "gato_tpu/kernels/longk.py:1171"
# Not a TPU kernel: gato_tpu back-substitutes a peeled level in XLA.
UNPEEL_REPLACES = "gato_tpu/kernels/longk.py:1062 (_cr_unpeel, XLA)"

CONDENSE_LAUNCHES = 0
PCG_LAUNCHES = 0
FUSED_LAUNCHES = 0
RECOVER_LAUNCHES = 0
CR_LAUNCHES = 0
PEEL_LAUNCHES = 0
UNPEEL_LAUNCHES = 0

TIERS = ("fused_xl", "xl", "stream")
# The tier of a call that forces none: rows 7 + 8/10 + 13, the faster
# route on an H100 at every shape chip_smoke.py phase 5d times (K =
# 1024-8192, B = 1 and 16; PERF.md): row 9 condenses on the PCG loop's
# resident CTAs only, which makes it 13-35 % slower there.
AUTO_TIER = "xl"
# The per-block shared memory an H100 lets a kernel opt in to: the limit
# the routing assumes for tensors on the CPU, whose plain versions then
# take the route the card would.
H100_SHARED_BYTES = 232448
# The kernel selector's codes: the cooperative kernels of longk.cu, and
# row 11 (longk_direct.cu).
_PCG_KERNEL, _FUSED_KERNEL, _CR_KERNEL = 0, 1, 2

DIRECT_TIERS = ("xl", "hybrid", "xla")
# The exact tier of a call that forces none is 'hybrid' from this many
# block rows in the batch (B * K), else 'xl'.  On an H100 (700 W;
# chip_smoke.py phase 5e, whole route, IIWA widths) 'xl' was the faster at
# B = 1 for K = 1024-8192 (0.91 / 0.71 / 1.06 / 1.22 ms against 1.04 /
# 0.95 / 1.46 / 1.55: a peel adds three launches), 'hybrid' at B = 15 for
# the same K (1.53 / 2.60 / 4.43 / 8.32 ms against 1.60 / 2.72 / 4.96 /
# 9.48: the peel kernels run the widest levels on more warps than the
# cooperative grid holds).  B * K = 8192 took 'xl', 15360 'hybrid'; the
# shapes between were not measured.
HYBRID_MIN_ROWS = 12288
# 'hybrid' peels (row 12) until the reduced system has at most this many
# rows, and at least once, before row 11 solves it.
HYBRID_CR_ROWS = 1024


class LongkOperators(NamedTuple):
    """Row 7's outputs, with a leading batch axis: S and Pinv (B, K, 3, s,
    s), gamma (B, K, s), Qinv (B, K, s, s), Rinv (B, K-1, c, c) and the
    zero-pivot flag of each problem (B,)."""

    S: torch.Tensor
    Pinv: torch.Tensor
    gamma: torch.Tensor
    Qinv: torch.Tensor
    Rinv: torch.Tensor
    bad: torch.Tensor


def should_dispatch(K: int, s: int, c: int, smem_limit: int) -> bool:
    """True iff ``method='pcg'`` on the kernel routes belongs to this tier:
    kernel A's vectors exceed a block's shared memory (``smem_limit``, the
    device's opt-in bytes), and a condensation tile takes the widths."""
    return (pcg_kernel.smem_bytes(K, s) > smem_limit - _build.RESERVED_SHARED_BYTES
            and max(s, c) <= _build.MAX_BLOCK)


def should_dispatch_direct(K: int, s: int, c: int, smem_limit: int) -> bool:
    """True iff ``method='direct'`` on the kernel routes belongs to the
    exact tier here: row 4's shared memory does not take the horizon (IIWA
    K >= 741 on an H100) and the kernels take the widths."""
    return (K >= 2 and max(s, c) <= _build.MAX_BLOCK
            and not direct_fused.fits(K, s, c, smem_limit))


def direct_tier(Bn: int, K: int) -> str:
    """The exact tier of a call that forces none, for Bn problems of horizon
    K: 'hybrid' from ``HYBRID_MIN_ROWS`` block rows, else 'xl'."""
    return "hybrid" if Bn * K >= HYBRID_MIN_ROWS else "xl"


def hybrid_peels(K: int) -> int:
    """Row 12 levels of the 'hybrid' tier at horizon K: until at most
    ``HYBRID_CR_ROWS`` rows are left, at least one."""
    peels, rows = 1, (K + 1) // 2
    while rows > HYBRID_CR_ROWS:
        peels, rows = peels + 1, (rows + 1) // 2
    return peels


# --------------------------------------------------------------------------
# Plain versions.


def condense_longk_plain(Q, R, A, B, q, r, c, *, rho=0.0,
                         preconditioner="symmetric_stair") -> LongkOperators:
    """Row 7's plain version: ``assemble.condense(flag=True)``."""
    sys = condense(Q, R, A, B, q, r, c, rho, Preconditioner(preconditioner),
                   flag=True)
    return LongkOperators(sys.S, sys.Pinv, sys.gamma, sys.Qinv, sys.Rinv,
                          sys.bad)


def pcg_longk_plain(S, Pinv, gamma, lam0, frozen=None, *, exit_tol=1e-6,
                    max_iters=100, poly_degree=1) -> PCGResult:
    """Rows 8/10's plain version: ``pcg.pcg`` with frozen problems."""
    return pcg(S, Pinv, gamma, lam0, exit_tol=exit_tol, max_iters=max_iters,
               poly_degree=poly_degree, frozen=frozen)


def fused_longk_plain(Q, R, A, B, q, r, c, lam0, *, rho=0.0, exit_tol=1e-6,
                      max_iters=100, poly_degree=1,
                      preconditioner="symmetric_stair"):
    """Row 9's plain version: rows 7 and 8/10's.  Returns (PCGResult, Qinv,
    Rinv)."""
    ops = condense_longk_plain(Q, R, A, B, q, r, c, rho=rho,
                               preconditioner=preconditioner)
    res = pcg_longk_plain(ops.S, ops.Pinv, ops.gamma, lam0, ops.bad,
                          exit_tol=exit_tol, max_iters=max_iters,
                          poly_degree=poly_degree)
    return res, ops.Qinv, ops.Rinv


def recover_longk_plain(Qinv, Rinv, A, B, q, r, lam):
    """Row 13's plain version: ``recover.recover_dz``."""
    return recover_dz(Qinv, Rinv, A, B, q, r, lam)


class PeelLevel(NamedTuple):
    """What the back-substitution of one compacted level reads: the level's
    input S (B, W, 3, s, s) and b (B, W, s), whose odd rows' L, U and b it
    uses, the odd rows' D^{-1} Doinv (B, W // 2, s, s), and ``bad``
    (B, W // 2), True where that inversion clamped a zero pivot in a block
    whose diagonal is not all zero."""

    S: torch.Tensor
    b: torch.Tensor
    Doinv: torch.Tensor
    bad: torch.Tensor


def cr_longk_plain(S, gamma):
    """Row 11's plain version: ``direct.btd_solve_cr(flag=True)``, returning
    (lam, bad) with lam unpoisoned."""
    return btd_solve_cr(S, gamma, flag=True)


def peel_longk_plain(S, b):
    """Row 12's plain version: one ``direct.cr_level`` on S (B, W, 3, s, s)
    and b (B, W, s).  Returns (S' (B, ceil(W/2), 3, s, s), b', PeelLevel)."""
    (L, D, U, bh), (Doinv, _, _, _), bad = cr_level(
        S[..., 0, :, :], S[..., 1, :, :], S[..., 2, :, :], b, flag=True)
    return torch.stack([L, D, U], dim=-3), bh, PeelLevel(S, b, Doinv, bad)


def unpeel_longk_plain(x_half, level: PeelLevel):
    """The back-substitution of one peeled level (gato_tpu's XLA
    ``_cr_unpeel``): ``direct.cr_back_level``, x (B, W, s) from the reduced
    system's x_half (B, ceil(W/2), s)."""
    S, b = level.S, level.b
    return cr_back_level(x_half, level.Doinv, S[..., 1::2, 0, :, :],
                         S[..., 1::2, 2, :, :], b[..., 1::2, :], b.shape[-2])


# --------------------------------------------------------------------------
# The wrappers.


def _check_args(name: str, q: torch.Tensor, preconditioner=None,
                poly_degree=None) -> None:
    if preconditioner is not None and preconditioner not in PRECOND_CODES:
        raise ValueError(f"unknown preconditioner {preconditioner!r}; valid: "
                         f"{sorted(PRECOND_CODES)}")
    if poly_degree is not None and (not isinstance(poly_degree, int)
                                    or poly_degree < 1):
        raise ValueError(f"{name}: poly_degree must be an int >= 1")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {q.device} are neither CPU nor CUDA")


def _check_widths(name: str, K: int, s: int, c: int) -> None:
    if K < 2 or max(s, c) > _build.MAX_BLOCK:
        raise ValueError(f"{name}: needs K >= 2 and s, c <= {_build.MAX_BLOCK}; "
                         f"got K={K}, s={s}, c={c}")


def _kkt(name: str, Q, R, A, B, q, r, c, extra: Optional[dict] = None):
    """Checked, contiguous block tensors (and ``extra`` ones) on one CUDA
    device; returns (Bn, K, s, c, tensors)."""
    if Q.ndim != 4:
        raise ValueError(f"{name}: Q must be (B, K, s, s), got {tuple(Q.shape)}")
    Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = block_shapes((Bn,), K, s, cdim)
    tensors = dict(zip(expect, (Q, R, A, B, q, r, c)))
    for key, (t, shape) in (extra or {}).items():
        expect[key] = shape
        tensors[key] = t
    check_tensors(name, expect, tensors, q.device)
    _check_widths(name, K, s, cdim)
    return Bn, K, s, cdim, {k: t.contiguous() for k, t in tensors.items()}


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


@functools.cache
def _resident_ctas(device_index: int, kind: int, s: int, c: int) -> int:
    """The occupancy query of gato_longk_grid (gato_longk_cr_grid for row
    11), once per device and shape (the caller has made ``device_index``
    current)."""
    lib = _build.library()
    if kind == _CR_KERNEL:
        return lib.gato_longk_cr_grid(s)
    return lib.gato_longk_grid(kind, s, c)


def _grid(lib, name: str, kind: int, s: int, c: int) -> int:
    """Resident CTAs of a cooperative kernel on the current device; raises
    with the numbers when none fits."""
    grid = _resident_ctas(torch.cuda.current_device(), kind, s, c)
    if grid < 1:
        smem = 0
        if kind == _FUSED_KERNEL:
            smem = lib.gato_longk_tile_smem_bytes(s, c)
        elif kind == _CR_KERNEL:
            smem = lib.gato_longk_cr_smem_bytes(s)
        why = (f"CUDA error {-grid} ({lib.gato_error_string(-grid).decode()})"
               if grid < 0 else "0 resident blocks")
        raise RuntimeError(
            f"{name}: the cooperative grid does not fit the device: the "
            f"occupancy query for blocks of 256 threads and {smem} B of "
            f"dynamic shared memory at (s, c) = ({s}, {c}) gave {why}")
    return grid


def _loop_buffers(Bn: int, K: int, s: int, grid: int, dev):
    """The PCG loop's global vectors, partial sums and round counters."""
    vec = torch.empty(Bn, 5, K * s, dtype=torch.float32, device=dev)
    parts = torch.empty(2 * grid, dtype=torch.float32, device=dev)
    done = torch.zeros(max(Bn, 1), dtype=torch.int32, device=dev)
    return vec, parts, done


def condense_longk_cuda(Q, R, A, B, q, r, c, *, rho: float = 0.0,
                        preconditioner: str = "symmetric_stair") -> LongkOperators:
    """Row 7: the batched condensation with the zero-pivot flag.  Arguments
    follow ``formats.KKTBlocks`` with one leading batch axis."""
    _check_args(CONDENSE_NAME, q, preconditioner)
    if q.device.type == "cpu":
        return condense_longk_plain(Q, R, A, B, q, r, c, rho=rho,
                                    preconditioner=preconditioner)
    Bn, K, s, cdim, t = _kkt(CONDENSE_NAME, Q, R, A, B, q, r, c)
    dev = q.device
    lib = _build.library()
    S = torch.empty(Bn, K, 3, s, s, dtype=torch.float32, device=dev)
    ops = LongkOperators(S=S, Pinv=torch.empty_like(S), gamma=torch.empty_like(q),
                         Qinv=torch.empty_like(Q), Rinv=torch.empty_like(R),
                         bad=torch.zeros(Bn, dtype=torch.int32, device=dev))
    if Bn > 0:
        with torch.cuda.device(dev):
            code = lib.gato_longk_condense(
                *map(_build.ptr, (*t.values(), *ops)), Bn, K, s, cdim,
                float(rho), PRECOND_CODES[preconditioner], _stream(dev))
        _build.check_launch(code, CONDENSE_NAME)
        global CONDENSE_LAUNCHES
        CONDENSE_LAUNCHES += 1
    return ops._replace(bad=ops.bad != 0)


def pcg_longk_cuda(S, Pinv, gamma, lam0=None, frozen=None, *,
                   exit_tol: float = 1e-6, max_iters: int = 100,
                   poly_degree: int = 1) -> PCGResult:
    """Rows 8 and 10: PCG on condensed operators S, Pinv (B, K, 3, s, s) and
    gamma (B, K, s), one cooperative launch a round of resident CTAs.
    ``frozen`` (B,) marks problems that run no iteration and report
    max_iters, not converged and eta = 1e30 (row 7's ``bad``)."""
    if lam0 is None:
        lam0 = torch.zeros_like(gamma)
    _check_args(PCG_NAME, gamma, poly_degree=poly_degree)
    if gamma.device.type == "cpu":
        return pcg_longk_plain(S, Pinv, gamma, lam0, frozen, exit_tol=exit_tol,
                               max_iters=max_iters, poly_degree=poly_degree)
    if gamma.ndim != 3:
        raise ValueError(f"{PCG_NAME}: gamma must be (B, K, s), got "
                         f"{tuple(gamma.shape)}")
    Bn, K, s = gamma.shape
    dev = gamma.device
    if frozen is None:
        frozen = torch.zeros(Bn, dtype=torch.int32, device=dev)
    frozen = frozen.to(device=dev, dtype=torch.int32)
    expect = {"S": (Bn, K, 3, s, s), "Pinv": (Bn, K, 3, s, s),
              "gamma": (Bn, K, s), "lam0": (Bn, K, s)}
    tensors = dict(zip(expect, (S, Pinv, gamma, lam0)))
    check_tensors(PCG_NAME, expect, tensors, dev)
    if tuple(frozen.shape) != (Bn,):
        raise ValueError(f"{PCG_NAME}: frozen shape {tuple(frozen.shape)}, "
                         f"expected {(Bn,)}")
    _check_widths(PCG_NAME, K, s, 1)
    S, Pinv, gamma, lam0 = (x.contiguous() for x in tensors.values())
    lam = torch.empty_like(gamma)
    iters = torch.empty(Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        lib = _build.library()
        with torch.cuda.device(dev):
            grid = _grid(lib, PCG_NAME, _PCG_KERNEL, s, 1)
            vec, parts, done = _loop_buffers(Bn, K, s, grid, dev)
            code = lib.gato_longk_pcg(
                *map(_build.ptr, (S, Pinv, gamma, lam0, frozen.contiguous(),
                                  lam, iters, conv, eta, vec, parts, done)),
                Bn, K, s, float(exit_tol), int(max_iters), poly_degree, grid,
                _stream(dev))
        _build.check_launch(code, f"{PCG_NAME} (cooperative, up to {grid} "
                                  "resident CTAs)")
        global PCG_LAUNCHES
        PCG_LAUNCHES += 1
    return PCGResult(lam=lam, iters=iters, converged=conv != 0, eta=eta)


def fused_longk_cuda(Q, R, A, B, q, r, c, lam0=None, *, rho: float = 0.0,
                     exit_tol: float = 1e-6, max_iters: int = 100,
                     poly_degree: int = 1,
                     preconditioner: str = "symmetric_stair"):
    """Row 9: condensation and PCG in one cooperative launch a round.
    Returns (PCGResult, Qinv, Rinv) for the recovery; a problem whose
    condensation met a zero pivot is frozen as in :func:`pcg_longk_cuda`."""
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    _check_args(FUSED_NAME, q, preconditioner, poly_degree)
    if q.device.type == "cpu":
        return fused_longk_plain(Q, R, A, B, q, r, c, lam0, rho=rho,
                                 exit_tol=exit_tol, max_iters=max_iters,
                                 poly_degree=poly_degree,
                                 preconditioner=preconditioner)
    Bn, K, s, cdim, t = _kkt(FUSED_NAME, Q, R, A, B, q, r, c,
                             {"lam0": (lam0, tuple(q.shape))})
    dev = q.device
    lam = torch.empty_like(q)
    iters = torch.empty(Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    Qinv = torch.empty_like(Q)
    Rinv = torch.empty_like(R)
    if Bn > 0:
        lib = _build.library()
        with torch.cuda.device(dev):
            grid = _grid(lib, FUSED_NAME, _FUSED_KERNEL, s, cdim)
            S = torch.empty(Bn, K, 3, s, s, dtype=torch.float32, device=dev)
            P = torch.empty_like(S)
            gamma = torch.empty_like(q)
            bad = torch.zeros(Bn, dtype=torch.int32, device=dev)
            vec, parts, done = _loop_buffers(Bn, K, s, grid, dev)
            code = lib.gato_longk_fused(
                *map(_build.ptr, (*t.values(), lam, iters, conv, eta, Qinv,
                                  Rinv, S, P, gamma, bad, vec, parts, done)),
                Bn, K, s, cdim, float(rho), float(exit_tol), int(max_iters),
                poly_degree, PRECOND_CODES[preconditioner], grid, _stream(dev))
        _build.check_launch(code, f"{FUSED_NAME} (cooperative, up to {grid} "
                                  "resident CTAs)")
        global FUSED_LAUNCHES
        FUSED_LAUNCHES += 1
    return PCGResult(lam=lam, iters=iters, converged=conv != 0, eta=eta), Qinv, Rinv


def recover_longk_cuda(Qinv, Rinv, A, B, q, r, lam):
    """Row 13: dz_x (B, K, s) and dz_u (B, K-1, c) from the multipliers and
    the condensation's inverses."""
    _check_args(RECOVER_NAME, q)
    if q.device.type == "cpu":
        return recover_longk_plain(Qinv, Rinv, A, B, q, r, lam)
    if q.ndim != 3:
        raise ValueError(f"{RECOVER_NAME}: q must be (B, K, s), got {tuple(q.shape)}")
    Bn, K, s = q.shape
    cdim = r.shape[-1]
    shapes = block_shapes((Bn,), K, s, cdim)
    expect = dict(Qinv=shapes["Q"], Rinv=shapes["R"], A=shapes["A"],
                  B=shapes["B"], q=shapes["q"], r=shapes["r"], lam=shapes["q"])
    tensors = dict(zip(expect, (Qinv, Rinv, A, B, q, r, lam)))
    check_tensors(RECOVER_NAME, expect, tensors, q.device)
    _check_widths(RECOVER_NAME, K, s, cdim)
    dev = q.device
    dz_x = torch.empty_like(q)
    dz_u = torch.empty_like(r)
    if Bn > 0:
        lib = _build.library()
        with torch.cuda.device(dev):
            code = lib.gato_longk_recover(
                *map(_build.ptr, (*(x.contiguous() for x in tensors.values()),
                                  dz_x, dz_u)),
                Bn, K, s, cdim, _stream(dev))
        _build.check_launch(code, RECOVER_NAME)
        global RECOVER_LAUNCHES
        RECOVER_LAUNCHES += 1
    return dz_x, dz_u


def _system(name: str, S, b, min_rows: int):
    """Checked, contiguous (S (B, W, 3, s, s), b (B, W, s)) on one CUDA
    device; returns (B, W, s, S, b)."""
    if S.ndim != 5 or b.ndim != 3:
        raise ValueError(f"{name}: S must be (B, W, 3, s, s) and b (B, W, s), got "
                         f"{tuple(S.shape)} and {tuple(b.shape)}")
    Bn, W, s = b.shape
    check_tensors(name, {"S": (Bn, W, 3, s, s), "b": (Bn, W, s)}, {"S": S, "b": b},
                  b.device)
    if W < min_rows or s > _build.MAX_BLOCK:
        raise ValueError(f"{name}: needs at least {min_rows} rows and s <= "
                         f"{_build.MAX_BLOCK}; got W={W}, s={s}")
    return Bn, W, s, S.contiguous(), b.contiguous()


def cr_longk_cuda(S, gamma):
    """Row 11: S lam = gamma (S (B, K, 3, s, s), gamma (B, K, s)) by block
    cyclic reduction in one cooperative launch, on a working copy of S.
    Returns (lam, bad (B,)): ``bad`` where a used inversion clamped a zero
    pivot in a block whose diagonal is not all zero; lam is not poisoned."""
    _check_args(CR_NAME, gamma)
    if gamma.device.type == "cpu":
        return cr_longk_plain(S, gamma)
    Bn, K, s, S, gamma = _system(CR_NAME, S, gamma, 1)
    dev = gamma.device
    lam = torch.empty_like(gamma)
    bad = torch.zeros(Bn, dtype=torch.int32, device=dev)
    if Bn > 0:
        lib = _build.library()
        with torch.cuda.device(dev):
            grid = _grid(lib, CR_NAME, _CR_KERNEL, s, 1)
            W = torch.empty_like(S)
            bv = torch.empty_like(gamma)
            code = lib.gato_longk_cr(*map(_build.ptr, (S, gamma, W, bv, lam, bad)),
                                     Bn, K, s, grid, _stream(dev))
        _build.check_launch(code, f"{CR_NAME} (cooperative, up to {grid} "
                                  "resident CTAs)")
        global CR_LAUNCHES
        CR_LAUNCHES += 1
    return lam, bad != 0


def peel_longk_cuda(S, b):
    """Row 12: one compacting cyclic-reduction level of the W >= 2 rows of
    S (B, W, 3, s, s) and b (B, W, s), both of its phases.  Returns (S'
    (B, ceil(W/2), 3, s, s), b' (B, ceil(W/2), s), PeelLevel)."""
    _check_args(PEEL_NAME, b)
    if b.device.type == "cpu":
        return peel_longk_plain(S, b)
    Bn, W, s, S, b = _system(PEEL_NAME, S, b, 2)
    dev = b.device
    we, wo = (W + 1) // 2, W // 2
    Sh = torch.empty(Bn, we, 3, s, s, dtype=torch.float32, device=dev)
    bh = torch.empty(Bn, we, s, dtype=torch.float32, device=dev)
    Doinv = torch.empty(Bn, wo, s, s, dtype=torch.float32, device=dev)
    flags = torch.zeros(Bn, wo, dtype=torch.int32, device=dev)
    if Bn > 0:
        lib = _build.library()
        with torch.cuda.device(dev):
            code = lib.gato_longk_peel(*map(_build.ptr, (S, b, Sh, bh, Doinv, flags)),
                                       Bn, W, s, _stream(dev))
        _build.check_launch(code, PEEL_NAME)
        global PEEL_LAUNCHES
        PEEL_LAUNCHES += 1
    return Sh, bh, PeelLevel(S, b, Doinv, flags != 0)


def unpeel_longk_cuda(x_half, level: PeelLevel):
    """The back-substitution of one peeled level: x (B, W, s) from the
    reduced system's solution x_half (B, ceil(W/2), s), knot-parallel."""
    _check_args(UNPEEL_NAME, x_half)
    if x_half.device.type == "cpu":
        return unpeel_longk_plain(x_half, level)
    Bn, W, s, S, b = _system(UNPEEL_NAME, level.S, level.b, 2)
    expect = {"x_half": (Bn, (W + 1) // 2, s), "Doinv": (Bn, W // 2, s, s)}
    check_tensors(UNPEEL_NAME, expect, {"x_half": x_half, "Doinv": level.Doinv},
                  b.device)
    x_half, Doinv = x_half.contiguous(), level.Doinv.contiguous()
    dev = b.device
    x = torch.empty_like(b)
    if Bn > 0:
        lib = _build.library()
        with torch.cuda.device(dev):
            code = lib.gato_longk_unpeel(*map(_build.ptr, (S, b, Doinv, x_half, x)),
                                         Bn, W, s, _stream(dev))
        _build.check_launch(code, UNPEEL_NAME)
        global UNPEEL_LAUNCHES
        UNPEEL_LAUNCHES += 1
    return x


# --------------------------------------------------------------------------
# The tier.


def solve_longk_batched(
    Q, R, A, B, q, r, c, lam0=None, *,
    rho: float = 0.0, exit_tol: float = 1e-6, max_iters: int = 100,
    poly_degree: int = 1, preconditioner: str = "symmetric_stair",
    force_tier: Optional[str] = None,
):
    """Whole batched solve (condense + PCG + recover) for long horizons.

    Arguments follow ``formats.KKTBlocks`` with a leading batch axis;
    returns (PCGResult with a batch axis, dz_x (B, K, s), dz_u (B, K-1, c)),
    the contract of ``gato_tpu.kernels.longk.solve_longk_batched``.  A
    problem whose condensation clamped a zero pivot in a live Q or R block
    reports iters = max_iters, converged False and eta = 1e30; the others
    are solved as if it were absent.

    ``force_tier`` ('fused_xl' | 'xl' | 'stream'), a test knob as in
    ``gato_tpu``: 'fused_xl' runs row 9 then row 13; 'xl' and 'stream' both
    run row 7, rows 8/10 and row 13, one route on this card (the TPU split
    them by VMEM).  None takes ``AUTO_TIER``."""
    if force_tier not in (None, *TIERS):
        raise ValueError(f"unknown force_tier {force_tier!r}; valid: {TIERS} "
                         "or None")
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    kw = dict(exit_tol=exit_tol, max_iters=max_iters, poly_degree=poly_degree)
    tier = force_tier or AUTO_TIER
    if tier == "fused_xl":
        res, Qinv, Rinv = fused_longk_cuda(Q, R, A, B, q, r, c, lam0, rho=rho,
                                           preconditioner=preconditioner, **kw)
    else:
        ops = condense_longk_cuda(Q, R, A, B, q, r, c, rho=rho,
                                  preconditioner=preconditioner)
        res = pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, lam0, ops.bad, **kw)
        Qinv, Rinv = ops.Qinv, ops.Rinv
    dz_x, dz_u = recover_longk_cuda(Qinv, Rinv, A, B, q, r, res.lam)
    return res, dz_x, dz_u


def solve_longk(Q, R, A, B, q, r, c, lam0=None, **kw):
    """Single-problem wrapper (the B=1 case of solve_longk_batched)."""
    res, dz_x, dz_u = solve_longk_batched(
        *(x.unsqueeze(0) for x in (Q, R, A, B, q, r, c)),
        None if lam0 is None else lam0.unsqueeze(0), **kw)
    return PCGResult(*(x[0] for x in res)), dz_x[0], dz_u[0]


def _hybrid(S, gamma):
    """'hybrid': :func:`hybrid_peels` row 12 levels, row 11 on what is
    left, then each level's back-substitution.  Returns (lam, bad) as
    :func:`cr_longk_cuda`, ``bad`` also where a peel clamped."""
    levels = []
    bad = torch.zeros(gamma.shape[0], dtype=torch.bool, device=gamma.device)
    for _ in range(hybrid_peels(S.shape[1])):
        S, gamma, level = peel_longk_cuda(S, gamma)
        bad = bad | level.bad.any(-1)
        levels.append(level)
    lam, bad_cr = cr_longk_cuda(S, gamma)
    for level in reversed(levels):
        lam = unpeel_longk_cuda(lam, level)
    return lam, bad | bad_cr


def solve_direct_longk_batched(
    Q, R, A, B, q, r, c, *, rho: float = 0.0, force_tier: Optional[str] = None,
):
    """Whole batched exact solve for long horizons: row 7's condensation
    (with the scalar Jacobi branch, whose preconditioner is unused), block
    cyclic reduction of S lambda = gamma, the true residual, row 13's
    recovery.

    Arguments follow ``formats.KKTBlocks`` with a leading batch axis;
    returns (PCGResult with a batch axis: iters = 0, eta the squared true
    residual, converged = direct.residual_converged(eta, ||gamma||^2);
    dz_x (B, K, s), dz_u (B, K-1, c)), the contract of
    ``gato_tpu.kernels.longk.solve_direct_longk_batched``.  A problem whose
    condensation clamped a zero pivot in a live Q or R block gets eta +=
    1e30; one whose reduction did (an odd row of a level or the root) gets
    1e30 added to its lambda and its eta.  Either way it reports converged
    False and its outputs stay finite; the other problems are solved as if
    it were absent.

    ``force_tier`` ('xl' | 'hybrid' | 'xla'), gato_tpu's test knob: 'xl'
    runs row 11 on the whole operator; 'hybrid' peels
    :func:`hybrid_peels` levels with row 12 before it and
    back-substitutes them after; 'xla' is the plain PyTorch cyclic
    reduction (``cr_longk_plain``) on the condensed operator, on any
    device.  None takes :func:`direct_tier`."""
    if force_tier not in (None, *DIRECT_TIERS):
        raise ValueError(
            f"force_tier={force_tier!r}; valid direct tiers are 'xl' (row 11 "
            "alone), 'hybrid' (row 12 peels, then row 11) and 'xla' (the plain "
            "PyTorch cyclic reduction)")
    Bn, K = q.shape[:2]
    tier = force_tier or direct_tier(Bn, K)
    ops = condense_longk_cuda(Q, R, A, B, q, r, c, rho=rho, preconditioner="jacobi")
    if tier == "xl":
        x, bad = cr_longk_cuda(ops.S, ops.gamma)
    elif tier == "hybrid":
        x, bad = _hybrid(ops.S, ops.gamma)
    else:
        x, bad = cr_longk_plain(ops.S, ops.gamma)
    eta, gamma_sq = residual_norms(ops.S, ops.gamma, x)
    poison = torch.where(bad, direct_fused.POISON_ETA, 0.0).to(x.dtype)
    eta = eta + torch.where(bad | ops.bad, direct_fused.POISON_ETA, 0.0).to(eta.dtype)
    lam = x + poison[:, None, None]
    dz_x, dz_u = recover_longk_cuda(ops.Qinv, ops.Rinv, A, B, q, r, lam)
    res = PCGResult(lam=lam, iters=torch.zeros(Bn, dtype=torch.int32, device=q.device),
                    converged=residual_converged(eta, gamma_sq), eta=eta)
    return res, dz_x, dz_u


def solve_direct_longk(Q, R, A, B, q, r, c, **kw):
    """Single-problem wrapper (the B=1 case of solve_direct_longk_batched)."""
    res, dz_x, dz_u = solve_direct_longk_batched(
        *(x.unsqueeze(0) for x in (Q, R, A, B, q, r, c)), **kw)
    return PCGResult(*(x[0] for x in res)), dz_x[0], dz_u[0]

"""Rows 7, 8, 9, 10 and 13: the long-horizon PCG tier as four hand-written
CUDA kernels, for horizons past the shared memory of kernels A and B.

Replace the PCG half of ``gato_tpu/kernels/longk.py``: ``_condense_kernel``
(row 7), the inner kernel of ``_pcg_xl_call`` (row 8) and
``_pcg_stream_kernel`` (row 10), ``_fused_xl_kernel`` (row 9) and
``_recover_kernel`` (row 13), entry points ``solve_longk_batched`` and
``solve_longk``.  The CUDA source is ``gato_tpu_torch/csrc/longk.cu``; its
note gives the design: condensation tiles that recompute their neighbour
knots instead of carrying them, a cooperative PCG launch with grid
barriers and per-CTA partial sums added in one fixed order, and
knot-parallel recovery.  Rows 8 and 10 compute one function, PCG on
condensed operators, which the TPU split by whether the operators fit
VMEM; on the card that is the L2 cache's business, so one kernel,
:func:`pcg_longk_cuda`, replaces both.  The TPU layout (knots on 128
lanes, ``plan_longk`` chunking, VMEM budgets, the lane shift of the
stair's slot 2) has no counterpart: the port works in the public
(B, K, ...) layout.

Each wrapper takes tensors on a CUDA device to its kernel and raises if the
kernel cannot take them; CPU tensors go to its plain version:

* :func:`condense_longk_cuda` (row 7): ``assemble.condense(flag=True)``;
* :func:`pcg_longk_cuda` (rows 8 and 10): ``pcg.pcg(frozen=...)``;
* :func:`fused_longk_cuda` (row 9): the two together;
* :func:`recover_longk_cuda` (row 13): ``recover.recover_dz``.

``*_LAUNCHES`` count each kernel's launches.  :func:`solve_longk_batched`
runs a tier: ``'fused_xl'`` is row 9 then row 13; ``'xl'`` and
``'stream'`` are both row 7, rows 8/10, row 13 (on this card they are the
same route).  :func:`should_dispatch` says where the solver routes
``method='pcg'`` here: past kernel A's shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..assemble import condense
from ..pcg import PCGResult, pcg
from ..problem import Preconditioner
from ..recover import recover_dz
from . import _build, pcg_kernel
from .fused_solve import PRECOND_CODES, block_shapes, check_tensors

SOURCE = "gato_tpu_torch/csrc/longk.cu"
CONDENSE_NAME = "condense_longk_cuda"
PCG_NAME = "pcg_longk_cuda"
FUSED_NAME = "fused_longk_cuda"
RECOVER_NAME = "recover_longk_cuda"
CONDENSE_REPLACES = "gato_tpu/kernels/longk.py:352"
PCG_REPLACES = "gato_tpu/kernels/longk.py:430, gato_tpu/kernels/longk.py:661"
FUSED_REPLACES = "gato_tpu/kernels/longk.py:547"
RECOVER_REPLACES = "gato_tpu/kernels/longk.py:1464"

CONDENSE_LAUNCHES = 0
PCG_LAUNCHES = 0
FUSED_LAUNCHES = 0
RECOVER_LAUNCHES = 0

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
# The kernel selector's codes (the cooperative kernels of longk.cu).
_PCG_KERNEL, _FUSED_KERNEL = 0, 1


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
    """The occupancy query of gato_longk_grid, once per device and shape
    (the caller has made ``device_index`` current)."""
    return _build.library().gato_longk_grid(kind, s, c)


def _grid(lib, name: str, kind: int, s: int, c: int) -> int:
    """Resident CTAs of a cooperative kernel on the current device; raises
    with the numbers when none fits."""
    grid = _resident_ctas(torch.cuda.current_device(), kind, s, c)
    if grid < 1:
        smem = lib.gato_longk_tile_smem_bytes(s, c) if kind == _FUSED_KERNEL else 0
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

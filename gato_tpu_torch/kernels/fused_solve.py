"""Kernel B: the whole batched KKT solve as one hand-written CUDA kernel.

Replaces ``gato_tpu/kernels/fused_solve.py::_fused_kernel`` (entry points
``_call_fused`` and ``solve_fused_batched``): rho-condensation with the
zero-pivot flag, any of the three preconditioners, the PCG loop shared with
kernel A, and dz recovery.  The CUDA source is
``gato_tpu_torch/csrc/fused_solve.cu``, with the per-problem body in
``fused_body.cuh`` (shared with the sequence kernel, fused_sequence.py);
their notes give the design: one thread block per problem, the
Gauss-Jordan work area and then the PCG vectors in shared memory, S and
Pinv written to a global scratch tensor that this wrapper allocates,
because together (235,200 B at IIWA) they exceed the 232,448 B of shared
memory a block may use.

:func:`fused_solve_cuda` takes tensors on a CUDA device to the kernel and
raises if the kernel cannot take them; tensors on the CPU go to the plain
version, :func:`fused_solve_plain`: ``condense(flag=True)`` -> ``pcg`` with
flagged problems frozen -> ``recover_dz``.  ``LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..assemble import condense
from ..pcg import PCGResult, pcg
from ..problem import Preconditioner
from ..recover import recover_dz
from . import _build

NAME = "fused_solve_cuda"
SOURCE = "gato_tpu_torch/csrc/fused_solve.cu"
REPLACES = "gato_tpu/kernels/fused_solve.py:568"
# The kernel's preconditioner codes (enum Precond in fused_solve.cu).
PRECOND_CODES = {"jacobi": 0, "block_jacobi": 1, "symmetric_stair": 2}

LAUNCHES = 0


def fused_solve_plain(Q, R, A, B, q, r, c, lam0, *, rho=0.0, exit_tol=1e-6,
                      max_iters=100, poly_degree=1,
                      preconditioner="symmetric_stair"):
    """The kernel's plain PyTorch version.  Returns (PCGResult, dz_x, dz_u)."""
    sys = condense(Q, R, A, B, q, r, c, rho, Preconditioner(preconditioner),
                   flag=True)
    res = pcg(sys.S, sys.Pinv, sys.gamma, lam0, exit_tol=exit_tol,
              max_iters=max_iters, poly_degree=poly_degree, frozen=sys.bad)
    dz_x, dz_u = recover_dz(sys.Qinv, sys.Rinv, A, B, q, r, res.lam)
    return res, dz_x, dz_u


def block_shapes(lead: tuple, K: int, s: int, cdim: int) -> dict:
    """Expected shapes of the seven KKT block tensors after ``lead`` axes."""
    return {"Q": (*lead, K, s, s), "R": (*lead, K - 1, cdim, cdim),
            "A": (*lead, K - 1, s, s), "B": (*lead, K - 1, s, cdim),
            "q": (*lead, K, s), "r": (*lead, K - 1, cdim), "c": (*lead, K, s)}


def check_tensors(name: str, expect: dict, tensors: dict, device) -> None:
    """Raise unless every tensor has its expected shape, is float32 and lies
    on ``device``."""
    for key, t in tensors.items():
        if tuple(t.shape) != expect[key]:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, expected {expect[key]}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} is {t.dtype}; the kernel takes float32")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on {device}")


def smem_bytes(K: int, s: int, cdim: int) -> int:
    """Shared memory of one kernel-B (or farm-kernel) block, as
    ``gato_fused_smem_bytes`` computes it: the Gauss-Jordan work area and,
    reusing it, six PCG vectors (fused_body.cuh's fused_arena_floats)."""
    def gj(n):
        return 2 * n * n + 3 * n + 2
    floats = max(6 * max(K * s, (K - 1) * cdim), gj(s), gj(cdim),
                 min(K * gj(s), 16384))
    return 4 * floats


def fits(K: int, s: int, cdim: int, smem_limit: int) -> bool:
    """True iff kernel B and the farm kernel take (K, s, c) on a device whose
    blocks may opt in to ``smem_limit`` bytes of shared memory."""
    return (K >= 2 and max(s, cdim) <= _build.MAX_BLOCK
            and smem_bytes(K, s, cdim) <= smem_limit - _build.RESERVED_SHARED_BYTES)


def past_limit_message(name: str, K: int, s: int, cdim: int, smem: int,
                       limit: int) -> str:
    return (f"{name}: (K, s, c) = ({K}, {s}, {cdim}) needs {smem} B of shared "
            f"memory per block, above the device's {limit} B; this horizon is "
            "served by the long-K tier (kernels/longk.py): pass pcg_backend "
            "None (auto) or 'pcg_kernel'")


def check_kernel_limits(name: str, K: int, s: int, cdim: int, poly_degree,
                        device) -> ctypes.CDLL:
    """Raise unless the fused body can take (K, s, c) and ``poly_degree`` on
    ``device``; returns the kernel library (built on first use)."""
    if K < 2 or s > _build.MAX_BLOCK or cdim > _build.MAX_BLOCK:
        raise ValueError(f"{name}: needs K >= 2 and s, c <= {_build.MAX_BLOCK}; got "
                         f"K={K}, s={s}, c={cdim}")
    if not isinstance(poly_degree, int) or poly_degree < 1:
        raise ValueError(f"{name}: poly_degree must be an int >= 1")
    lib = _build.library()
    smem = lib.gato_fused_smem_bytes(K, s, cdim)
    limit = _build.max_shared_bytes(device) - 1024
    if smem > limit:
        raise ValueError(past_limit_message(name, K, s, cdim, smem, limit))
    return lib


def fused_solve_cuda(
    Q, R, A, B, q, r, c, lam0=None, *,
    rho: float = 0.0, exit_tol: float = 1e-6, max_iters: int = 100,
    poly_degree: int = 1, preconditioner: str = "symmetric_stair",
):
    """Whole batched solve (condense + PCG + recover).

    Arguments follow ``formats.KKTBlocks`` with one leading batch axis.
    Returns (PCGResult with a batch axis, dz_x (B, K, s), dz_u (B, K-1, c)).
    A problem whose condensation met a zero pivot in a live Q or R block
    reports iters = max_iters, converged False and eta = 1e30."""
    if preconditioner not in PRECOND_CODES:
        raise ValueError(f"unknown preconditioner {preconditioner!r}; valid: "
                         f"{sorted(PRECOND_CODES)}")
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    if q.device.type == "cpu":
        return fused_solve_plain(Q, R, A, B, q, r, c, lam0, rho=rho,
                                 exit_tol=exit_tol, max_iters=max_iters,
                                 poly_degree=poly_degree,
                                 preconditioner=preconditioner)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {q.device} are neither CPU nor CUDA")
    if Q.ndim != 4:
        raise ValueError(f"{NAME}: Q must be (B, K, s, s), got {tuple(Q.shape)}")
    Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = dict(block_shapes((Bn,), K, s, cdim), lam0=(Bn, K, s))
    tensors = dict(zip(expect, (Q, R, A, B, q, r, c, lam0)))
    check_tensors(NAME, expect, tensors, q.device)
    lib = check_kernel_limits(NAME, K, s, cdim, poly_degree, q.device)
    Q, R, A, B, q, r, c, lam0 = (t.contiguous() for t in tensors.values())
    dev = q.device
    scratch = torch.empty(Bn, lib.gato_fused_scratch_floats(K, s, cdim),
                          dtype=torch.float32, device=dev)
    lam = torch.empty_like(q)
    dz_x = torch.empty_like(q)
    dz_u = torch.empty_like(r)
    iters = torch.empty(Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gato_fused_solve(
                *map(_build.ptr, (Q, R, A, B, q, r, c, lam0, scratch, lam,
                                  dz_x, dz_u, iters, conv, eta)),
                Bn, K, s, cdim, float(rho), float(exit_tol), int(max_iters),
                poly_degree, PRECOND_CODES[preconditioner],
                ctypes.c_void_p(stream))
        _build.check_launch(code, NAME)
        global LAUNCHES
        LAUNCHES += 1
    res = PCGResult(lam=lam, iters=iters, converged=conv != 0, eta=eta)
    return res, dz_x, dz_u

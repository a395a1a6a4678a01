"""Row 4: the whole batched exact solve as one hand-written CUDA kernel.

Replaces ``gato_tpu/kernels/direct_fused.py::_direct_kernel`` (entry points
``_call_direct`` and ``solve_direct_fused_batched``): rho-condensation with
the zero-pivot flag, block cyclic reduction of S lambda = gamma, dz
recovery, the squared true residual eta = ||gamma - S lambda||^2 against the
original S, iters = 0 and converged = direct.residual_converged(eta,
||gamma||^2).  The CUDA source is ``gato_tpu_torch/csrc/direct_fused.cu``;
its note gives the design: one thread block per problem, the condensation
through the device functions it shares with kernel B (``condense.cuh``), S
and the copy the reduction overwrites in a per-problem global scratch
tensor that this wrapper allocates, all odd rows of a level inverted at
once.

A problem in which a used inversion clamped a zero pivot (singular input)
gets eta = 1e30 (finite), so it reports converged False; its lambda and dz
stay finite.  (Rows 5 and 6, kernels/thomas_batch.py, report such a
problem non-finite instead: each kernel keeps its TPU kernel's contract.)

:func:`direct_fused_cuda` takes tensors on a CUDA device to the kernel and
raises if the kernel cannot take them; tensors on the CPU go to the plain
version, :func:`direct_fused_plain`: ``condense(flag=True)`` ->
``direct.btd_solve_cr(flag=True)`` -> ``recover_dz``, with the residual and
the 1e30 poison.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..assemble import condense
from ..direct import btd_solve_cr, residual_converged, residual_norms
from ..pcg import PCGResult
from ..recover import recover_dz
from . import _build
from .fused_solve import block_shapes, check_tensors

NAME = "direct_fused_cuda"
SOURCE = "gato_tpu_torch/csrc/direct_fused.cu"
REPLACES = "gato_tpu/kernels/direct_fused.py:350"
# eta of a problem whose used inversions clamped a zero pivot.
POISON_ETA = 1e30

LAUNCHES = 0


def smem_bytes(K: int, s: int, cdim: int) -> int:
    """Shared memory of one row-4 block, as ``gato_direct_smem_bytes``
    computes it: the Gauss-Jordan work area (condense.cuh's
    gj_arena_floats) and four vectors."""
    def gj(n):
        return 2 * n * n + 3 * n + 2
    arena = max(gj(s), gj(cdim), min(K * gj(s), 16384))
    return 4 * (arena + 4 * max(K * s, (K - 1) * cdim))


def fits(K: int, s: int, cdim: int, smem_limit: int) -> bool:
    """True iff row 4 takes (K, s, c) on a device whose blocks may opt in to
    ``smem_limit`` bytes of shared memory (IIWA: K <= 740 on an H100)."""
    return (K >= 2 and max(s, cdim) <= _build.MAX_BLOCK
            and smem_bytes(K, s, cdim) <= smem_limit - _build.RESERVED_SHARED_BYTES)


def past_limit_message(name: str, K: int, s: int, cdim: int, smem: int,
                       limit: int) -> str:
    return (f"{name}: (K, s, c) = ({K}, {s}, {cdim}) needs {smem} B of shared "
            f"memory per block, above the device's {limit} B; this horizon is "
            "served by the long-K direct tier (kernels/longk.py): pass "
            "pcg_backend None (auto) or 'pcg_kernel'")


def direct_fused_plain(Q, R, A, B, q, r, c, *, rho=0.0):
    """The kernel's plain PyTorch version.  Returns (PCGResult, dz_x, dz_u)."""
    sys = condense(Q, R, A, B, q, r, c, rho, None, flag=True)
    lam, bad_cr = btd_solve_cr(sys.S, sys.gamma, flag=True)
    eta, gnorm = residual_norms(sys.S, sys.gamma, lam)
    eta = eta + torch.where(sys.bad | bad_cr, POISON_ETA, 0.0).to(eta.dtype)
    dz_x, dz_u = recover_dz(sys.Qinv, sys.Rinv, A, B, q, r, lam)
    res = PCGResult(lam=lam,
                    iters=torch.zeros(eta.shape, dtype=torch.int32, device=eta.device),
                    converged=residual_converged(eta, gnorm), eta=eta)
    return res, dz_x, dz_u


def check_limits(name: str, K: int, s: int, cdim: int, scratch_floats, smem,
                 Bn: int, device) -> None:
    """Raise ValueError unless a kernel's block shapes, per-block shared
    memory and scratch fit ``device``."""
    if K < 2 or s > _build.MAX_BLOCK or cdim > _build.MAX_BLOCK:
        raise ValueError(f"{name}: needs K >= 2 and s, c <= {_build.MAX_BLOCK}; got "
                         f"K={K}, s={s}, c={cdim}")
    limit = _build.max_shared_bytes(device) - _build.RESERVED_SHARED_BYTES
    if smem > limit:
        raise ValueError(past_limit_message(name, K, s, cdim, smem, limit))
    total = torch.cuda.get_device_properties(device).total_memory
    if Bn * scratch_floats * 4 > total:
        raise ValueError(f"{name}: {Bn} problems need {Bn * scratch_floats * 4} B "
                         f"of scratch, above the device's {total} B; split the batch")


def direct_fused_cuda(Q, R, A, B, q, r, c, *, rho: float = 0.0):
    """Whole batched exact solve (condense + cyclic reduction + recover).

    Arguments follow ``formats.KKTBlocks`` with one leading batch axis.
    Returns (PCGResult with a batch axis: iters = 0, eta the squared true
    residual, converged derived from it; dz_x (B, K, s), dz_u (B, K-1, c))."""
    if q.device.type == "cpu":
        return direct_fused_plain(Q, R, A, B, q, r, c, rho=rho)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {q.device} are neither CPU nor CUDA")
    if Q.ndim != 4:
        raise ValueError(f"{NAME}: Q must be (B, K, s, s), got {tuple(Q.shape)}")
    Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = block_shapes((Bn,), K, s, cdim)
    tensors = dict(zip(expect, (Q, R, A, B, q, r, c)))
    check_tensors(NAME, expect, tensors, q.device)
    dev = q.device
    lib = _build.library()
    scratch_floats = lib.gato_direct_scratch_floats(K, s, cdim)
    check_limits(NAME, K, s, cdim, scratch_floats,
                 lib.gato_direct_smem_bytes(K, s, cdim), Bn, dev)
    Q, R, A, B, q, r, c = (t.contiguous() for t in tensors.values())
    scratch = torch.empty(Bn, scratch_floats, dtype=torch.float32, device=dev)
    lam = torch.empty_like(q)
    dz_x = torch.empty_like(q)
    dz_u = torch.empty_like(r)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.gato_direct_fused(
                *map(_build.ptr, (Q, R, A, B, q, r, c, scratch, lam, dz_x,
                                  dz_u, conv, eta)),
                Bn, K, s, cdim, float(rho), ctypes.c_void_p(stream))
        _build.check_launch(code, NAME)
        global LAUNCHES
        LAUNCHES += 1
    res = PCGResult(lam=lam, iters=torch.zeros(Bn, dtype=torch.int32, device=dev),
                    converged=conv != 0, eta=eta)
    return res, dz_x, dz_u

"""Kernel A: the batched PCG loop as one hand-written CUDA kernel.

Replaces ``gato_tpu/kernels/pcg_pallas.py::_pcg_kernel`` (entry points
``pcg_fused_batched`` and ``pcg_fused``).  The CUDA source is
``gato_tpu_torch/csrc/pcg.cu``, with the loop in ``pcg_common.cuh``; its note
gives the design: one thread block per problem, vectors in shared memory,
S and Pinv read from global memory because the two together (235,200 B at
IIWA) exceed the 232,448 B of shared memory a block may use.

:func:`pcg_batched_cuda` takes tensors on a CUDA device to the kernel and
raises if the kernel cannot take them; tensors on the CPU go to the plain
version, :func:`pcg_batched_plain` (``gato_tpu_torch.pcg.pcg``).
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..pcg import PCGResult, pcg
from . import _build

NAME = "pcg_batched_cuda"
SOURCE = "gato_tpu_torch/csrc/pcg.cu"
REPLACES = "gato_tpu/kernels/pcg_pallas.py:481"

LAUNCHES = 0


def pcg_batched_plain(S, Pinv, gamma, lam0=None, *, exit_tol=1e-6,
                      max_iters=100, poly_degree=1) -> PCGResult:
    """The kernel's plain PyTorch version: ``gato_tpu_torch.pcg.pcg``."""
    return pcg(S, Pinv, gamma, lam0, exit_tol=exit_tol, max_iters=max_iters,
               poly_degree=poly_degree)


def pcg_batched_cuda(
    S: torch.Tensor,       # (B, K, 3, s, s)
    Pinv: torch.Tensor,    # (B, K, 3, s, s)
    gamma: torch.Tensor,   # (B, K, s)
    lam0: Optional[torch.Tensor] = None,
    *,
    exit_tol: float = 1e-6,
    max_iters: int = 100,
    poly_degree: int = 1,
) -> PCGResult:
    """Solve B block-tridiagonal systems S lam = gamma by PCG; the same
    contract as ``gato_tpu_torch.pcg.pcg`` with one leading batch axis."""
    if lam0 is None:
        lam0 = torch.zeros_like(gamma)
    if gamma.device.type == "cpu":
        return pcg_batched_plain(S, Pinv, gamma, lam0, exit_tol=exit_tol,
                                 max_iters=max_iters, poly_degree=poly_degree)
    if gamma.device.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {gamma.device} are neither CPU "
                         "nor CUDA")
    if gamma.ndim != 3:
        raise ValueError(f"{NAME}: gamma must be (B, K, s), got {tuple(gamma.shape)}")
    Bn, K, s = gamma.shape
    for name, t, shape in (("S", S, (Bn, K, 3, s, s)),
                           ("Pinv", Pinv, (Bn, K, 3, s, s)),
                           ("lam0", lam0, (Bn, K, s))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} shape {tuple(t.shape)}, expected {shape}")
    for name, t in (("S", S), ("Pinv", Pinv), ("gamma", gamma), ("lam0", lam0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{NAME}: {name} is {t.dtype}; the kernel takes float32")
        if t.device != gamma.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, gamma on {gamma.device}")
    if s > _build.MAX_BLOCK:
        raise ValueError(f"{NAME}: state size {s} > {_build.MAX_BLOCK}")
    if not isinstance(poly_degree, int) or poly_degree < 1:
        raise ValueError(f"{NAME}: poly_degree must be an int >= 1")
    lib = _build.library()
    smem = lib.gato_pcg_smem_bytes(K, s)
    limit = _build.max_shared_bytes(gamma.device) - 1024
    if smem > limit:
        raise ValueError(f"{NAME}: K*s = {K * s} needs {smem} B of shared "
                         f"memory per block, above the device's {limit} B")
    S, Pinv, gamma, lam0 = (t.contiguous() for t in (S, Pinv, gamma, lam0))
    dev = gamma.device
    lam = torch.empty_like(gamma)
    iters = torch.empty(Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn == 0:
        return PCGResult(lam=lam, iters=iters, converged=conv.bool(), eta=eta)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gato_pcg_batched(
            *map(_build.ptr, (S, Pinv, gamma, lam0, lam, iters, conv, eta)),
            Bn, K, s, float(exit_tol), int(max_iters), poly_degree,
            ctypes.c_void_p(stream))
    _build.check_launch(code, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return PCGResult(lam=lam, iters=iters, converged=conv != 0, eta=eta)

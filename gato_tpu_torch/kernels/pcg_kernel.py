"""Kernel A: the batched PCG loop as one hand-written CUDA kernel.

Replaces ``gato_tpu/kernels/pcg_pallas.py::_pcg_kernel`` (entry points
``pcg_fused_batched`` and ``pcg_fused``).  The CUDA source is
``gato_tpu_torch/csrc/pcg.cu``, with the loop in ``cluster_body.cuh`` (kernel
B's PCG stage); its note gives the design: one thread-block cluster of C
CTAs a problem, CTA r holding a contiguous range of knots, their S and
Pinv copied into its shared memory where they fit (else read from the
global tensors), halos and dot products through distributed shared memory.

The plan of a launch is pure Python here, mirrored by the library's
``gato_pcg_cluster_*`` functions: :func:`cta_threads`,
:func:`cta_smem_bytes`, :func:`ops_in_smem`, :func:`cluster_fits` and
:func:`cluster_size`, kernel B's rule (``fused_solve.rule``) with kernel A's
record.  :func:`smem_bytes` and :func:`fits` keep the horizons kernel A
serves (the routing to the long-K tier reads them).

:func:`pcg_batched_cuda` takes tensors on a CUDA device to the kernel and
raises if the kernel cannot take them (``cluster=`` forces C, for tests and
measurements); tensors on the CPU go to the plain version,
:func:`pcg_batched_plain` (``gato_tpu_torch.pcg.pcg``).  ``LAUNCHES`` counts
the kernel's launches, ``LAST_CLUSTER`` holds the C of the last.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..pcg import PCGResult, pcg
from . import _build
from . import fused_solve as kb

NAME = "pcg_batched_cuda"
SOURCE = "gato_tpu_torch/csrc/pcg.cu"
REPLACES = "gato_tpu/kernels/pcg_pallas.py:481"

LAUNCHES = 0
LAST_CLUSTER = None


def smem_bytes(K: int, s: int) -> int:
    """The shared memory one block of the one-CTA-a-problem kernel A needed
    (six K s vectors).  It no longer sizes a launch (:func:`cta_smem_bytes`
    does); it fixes the horizons kernel A serves (:func:`fits`), so that
    the routing to the long-K tier (IIWA K >= 689 on an H100,
    ``longk.should_dispatch``) stays where it was."""
    return 6 * K * s * 4


def fits(K: int, s: int, smem_limit: int) -> bool:
    """True iff kernel A serves (K, s) on a device whose blocks may opt in
    to ``smem_limit`` bytes of shared memory.  Every such shape has a
    cluster size whose plan fits (:func:`cluster_fits`)."""
    return (s <= _build.MAX_BLOCK
            and smem_bytes(K, s) <= smem_limit - _build.RESERVED_SHARED_BYTES)


# ---- The plan of one launch (mirrors of pcg.cu) ----

def record_floats(s: int) -> int:
    """One knot's record: S_k and Pinv_k, three blocks each."""
    return 6 * s * s


def cta_threads(K: int, s: int, C: int) -> int:
    """Threads of one CTA: a row of its knots each, whole warps, from 64 to
    384."""
    t = -(-kb.cluster_knots(K, C) * s // 32) * 32
    return min(max(t, 64), 384)


def cta_smem_bytes(K: int, s: int, C: int, in_smem: bool) -> int:
    """Dynamic shared memory of one CTA: kernel B's fixed reduction area,
    the knots' records when ``in_smem``, lambda's rows, the halo rows of
    eight vectors and the seven other vectors."""
    kn = kb.cluster_knots(K, C)
    floats = (kb._FIXED_FLOATS + (kn * record_floats(s) if in_smem else 0) + kn * s
              + 2 * kb._NUM_VEC * s + 7 * kn * s)
    return 4 * floats


def ops_in_smem(K: int, s: int, C: int, smem_limit: int) -> bool:
    """True iff the records of a CTA fit its shared memory at this C."""
    return cta_smem_bytes(K, s, C, True) <= smem_limit - _build.RESERVED_SHARED_BYTES


def cluster_fits(K: int, s: int, C: int, smem_limit: int) -> bool:
    """True iff a cluster of C CTAs takes (K, s): at least a knot each, and
    the plan without the records fits shared memory."""
    return (C <= K and cta_smem_bytes(K, s, C, False)
            <= smem_limit - _build.RESERVED_SHARED_BYTES)


def cluster_size(B: int, K: int, s: int, n_sms: int, smem_limit: int) -> int:
    """The cluster size kernel A takes for B problems: kernel B's rule
    (``fused_solve.cluster_size``, whose note gives the reasons) on kernel
    A's plan: the largest C that fits with B C <= n_sms, never below the
    smallest C whose records (6 s^2 floats a knot, 235 KB a problem at IIWA
    K = 50) fit shared memory.  At IIWA K = 50: C = 16 at B = 1, the floor
    C = 2 from B = 34; at K = 688 only C = 16 holds the records, at any B."""
    fitting = [C for C in kb.CLUSTER_SIZES if cluster_fits(K, s, C, smem_limit)]
    if not fitting:
        raise ValueError(f"no cluster size takes (K, s) = ({K}, {s}) under "
                         f"{smem_limit} B of shared memory")
    return kb.rule(B, n_sms, fitting, lambda C: ops_in_smem(K, s, C, smem_limit))


@functools.cache
def launch_plan(B: int, K: int, s: int, index: int, cluster=None) -> tuple:
    """(C, ops_in_smem) of a launch of B problems at (K, s) on CUDA device
    ``index``; raises ValueError for a shape or forced ``cluster`` the
    kernel does not take, and RuntimeError when the card cannot hold one
    such cluster."""
    n_sms, limit = kb.device_limits(index)
    if not fits(K, s, limit):
        raise ValueError(f"{NAME}: K*s = {K * s} needs {smem_bytes(K, s)} B of shared "
                         f"memory per block, above the device's "
                         f"{limit - _build.RESERVED_SHARED_BYTES} B")
    if cluster is None:
        C = cluster_size(B, K, s, n_sms, limit)
    elif cluster not in kb.CLUSTER_SIZES or not cluster_fits(K, s, cluster, limit):
        raise ValueError(f"{NAME}: cluster={cluster!r} does not take (K, s) = ({K}, {s}); "
                         f"it must be one of {kb.CLUSTER_SIZES}, at most K, with a plan "
                         f"that fits {limit} B")
    else:
        C = cluster
    in_smem = ops_in_smem(K, s, C, limit)
    kb.require_resident(NAME, "gato_pcg_max_clusters", index, (K, s, C, int(in_smem)), C,
                        cta_smem_bytes(K, s, C, in_smem), f"(K, s) = ({K}, {s})")
    return C, in_smem


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
    cluster=None,
) -> PCGResult:
    """Solve B block-tridiagonal systems S lam = gamma by PCG; the same
    contract as ``gato_tpu_torch.pcg.pcg`` with one leading batch axis.  On
    CUDA tensors ``cluster`` forces the cluster size (one of 1, 2, 4, 8, 16;
    a size the shape or the card does not take raises); None takes
    :func:`cluster_size`."""
    if lam0 is None:
        lam0 = torch.zeros_like(gamma)
    dev = gamma.device
    if dev.type == "cpu":
        return pcg_batched_plain(S, Pinv, gamma, lam0, exit_tol=exit_tol,
                                 max_iters=max_iters, poly_degree=poly_degree)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {dev} are neither CPU nor CUDA")
    if gamma.ndim != 3:
        raise ValueError(f"{NAME}: gamma must be (B, K, s), got {tuple(gamma.shape)}")
    Bn, K, s = gamma.shape
    ops = torch.Size((Bn, K, 3, s, s))
    S = _build.checked(NAME, "S", S, ops, dev)
    Pinv = _build.checked(NAME, "Pinv", Pinv, ops, dev)
    gamma = _build.checked(NAME, "gamma", gamma, gamma.shape, dev)
    lam0 = _build.checked(NAME, "lam0", lam0, gamma.shape, dev)
    if s > _build.MAX_BLOCK:
        raise ValueError(f"{NAME}: state size {s} > {_build.MAX_BLOCK}")
    if not isinstance(poly_degree, int) or poly_degree < 1:
        raise ValueError(f"{NAME}: poly_degree must be an int >= 1")
    C, in_smem = launch_plan(Bn, K, s, dev.index, cluster)
    lam = torch.empty_like(gamma)
    iters = torch.empty(Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        _build.launch(NAME, "gato_pcg_batched", dev,
                      *(t.data_ptr() for t in (S, Pinv, gamma, lam0, lam, iters, conv, eta)),
                      Bn, K, s, float(exit_tol), int(max_iters), poly_degree, C,
                      int(in_smem))
        global LAUNCHES, LAST_CLUSTER
        LAUNCHES += 1
        LAST_CLUSTER = C
    return PCGResult(lam=lam, iters=iters, converged=conv != 0, eta=eta)

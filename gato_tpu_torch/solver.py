"""High-level solver: condense -> PCG -> recover, single or batched.

Backends, named after ``gato_tpu``'s:

* ``'torch'``: plain PyTorch ops on any device (``gato_tpu``'s ``'jax'``);
  the CPU default, the float64 path and the numerics oracle.
* ``'pcg_kernel'``: condensation in PyTorch ops, then the CUDA PCG kernel
  (kernel A, kernels/pcg_kernel.py; ``gato_tpu``'s ``'pallas'``).
* ``'fused'``: the whole solve in the CUDA fused kernel (kernel B,
  kernels/fused_solve.py), ``gato_tpu``'s TPU default.

Auto-selection (``pcg_backend=None``) picks ``'fused'`` for float32 on CUDA
and ``'torch'`` on the CPU or for float64.  An explicit kernel backend with
float64, an unknown backend, and ``method='direct'`` raise.  Every entry point
takes ``device=`` (default ``"cuda"``) and raises if that device is CUDA and
no CUDA device is available: nothing falls back to the CPU silently.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import assemble, pcg as pcg_mod, recover
from .formats import KKTBlocks, blocks_to_torch, check_block_shapes, interleave_dz
from .kernels import fused_solve as fused_kernel
from .kernels import pcg_kernel
from .problem import ProblemSpec, SolverOptions

VALID_PCG_BACKENDS = ("torch", "pcg_kernel", "fused")
KERNEL_BACKENDS = ("pcg_kernel", "fused")
DIRECT_NOT_PORTED = (
    "method='direct' is not in gato_tpu_torch yet: it comes with ROADMAP.md "
    "queue 1 item 9 (direct.py and method='direct' in the solver); use "
    "method='pcg' or gato_tpu")


class SolveResult(NamedTuple):
    lam: torch.Tensor        # (..., K, s)   multipliers
    dz_x: torch.Tensor       # (..., K, s)   state steps
    dz_u: torch.Tensor       # (..., K-1, c) control steps
    iters: torch.Tensor      # (...)         PCG iterations (int32)
    converged: torch.Tensor  # (...)         bool
    eta: torch.Tensor        # (...)         final |r . M r|

    def dz_flat(self) -> np.ndarray:
        """Interleaved [dz_x0, dz_u0, ..., dz_x_{K-1}] of a single solve."""
        dz_x = self.dz_x.detach().cpu().numpy()
        dz_u = self.dz_u.detach().cpu().numpy()
        K, s = dz_x.shape
        return interleave_dz(ProblemSpec(s, dz_u.shape[-1], K), dz_x, dz_u)

    def lam_flat(self) -> np.ndarray:
        return self.lam.detach().cpu().numpy().reshape(-1)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def default_pcg_backend(device, dtype="float32") -> str:
    """'fused' for float32 on CUDA; 'torch' on the CPU or for float64."""
    if torch.device(device).type == "cuda" and _torch_dtype(dtype) == torch.float32:
        return "fused"
    return "torch"


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return getattr(torch, str(np.dtype(dtype)))
    except (TypeError, AttributeError):
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def _resolve_backend(pcg_backend: Optional[str], options: SolverOptions,
                     device) -> str:
    """Validate an explicit backend choice, or auto-select.  Requests that
    cannot be honoured raise instead of degrading."""
    if options.method == "direct":
        raise NotImplementedError(DIRECT_NOT_PORTED)
    if pcg_backend is None:
        return default_pcg_backend(device, options.dtype)
    if pcg_backend not in VALID_PCG_BACKENDS:
        raise ValueError(
            f"unknown pcg_backend {pcg_backend!r}; valid choices are "
            f"{VALID_PCG_BACKENDS} or None for auto-selection")
    if pcg_backend in KERNEL_BACKENDS and _torch_dtype(options.dtype) != torch.float32:
        raise ValueError(
            f"pcg_backend={pcg_backend!r} runs float32-only CUDA kernels; "
            f"dtype={options.dtype!r} needs pcg_backend None (auto) or 'torch'")
    return pcg_backend


def _solve_core(b: KKTBlocks, lam0: torch.Tensor, options: SolverOptions,
                backend: str) -> SolveResult:
    """The batched solve on staged tensors (one leading batch axis)."""
    kw = dict(exit_tol=options.exit_tol, max_iters=options.max_iters,
              poly_degree=options.precond_poly_degree)
    if backend == "fused":
        res, dz_x, dz_u = fused_kernel.fused_solve_cuda(
            *b, lam0, rho=options.rho,
            preconditioner=options.preconditioner.value, **kw)
        return SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)
    sys = assemble.condense(*b, options.rho, options.preconditioner)
    if backend == "pcg_kernel":
        res = pcg_kernel.pcg_batched_cuda(sys.S, sys.Pinv, sys.gamma, lam0, **kw)
    else:
        res = pcg_mod.pcg(sys.S, sys.Pinv, sys.gamma, lam0, **kw)
    dz_x, dz_u = recover.recover_dz(sys.Qinv, sys.Rinv, b.A, b.B, b.q, b.r,
                                    res.lam)
    return SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)


def _stage(spec, blocks, options, lam0, device, lead):
    dev = resolve_device(device)
    dtype = _torch_dtype(options.dtype)
    b = blocks_to_torch(blocks, dev, dtype)
    check_block_shapes(spec, b, lead=lead)
    shape = tuple(lead) + (spec.knot_points, spec.state_size)
    if options.warm_start and lam0 is not None:
        lam0 = torch.as_tensor(lam0, dtype=dtype, device=dev).reshape(shape)
    else:
        lam0 = torch.zeros(shape, dtype=dtype, device=dev)
    return dev, b, lam0


def solve(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0=None,
    pcg_backend: Optional[str] = None,
    *,
    device="cuda",
) -> SolveResult:
    """Solve one KKT system.

    Args:
      spec: problem shape (checked against ``blocks``).
      blocks: KKTBlocks of NumPy arrays or tensors (formats.pack_kkt).
      options: runtime solver options.
      lam0: optional (K, s) warm-start multipliers, used only when
        ``options.warm_start``.
      pcg_backend: 'torch' | 'pcg_kernel' | 'fused' | None (auto).
      device: where to solve; default "cuda".
    """
    backend = _resolve_backend(pcg_backend, options, device)
    dev, b, lam0 = _stage(spec, blocks, options, lam0, device, ())
    res = _solve_core(KKTBlocks(*(a.unsqueeze(0) for a in b)),
                      lam0.unsqueeze(0), options, backend)
    return SolveResult(*(t[0] for t in res))


def solve_batched(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0=None,
    pcg_backend: Optional[str] = None,
    *,
    device="cuda",
) -> SolveResult:
    """Solve a batch of independent KKT systems (a leading batch axis on
    every array of ``blocks``).  A problem that converges early stops
    updating while the rest of the batch iterates."""
    backend = _resolve_backend(pcg_backend, options, device)
    Q = blocks.Q
    if Q.ndim != 4:
        raise ValueError(
            f"solve_batched expects a leading batch axis on every array "
            f"(Q (B, K, s, s)); got Q shape {tuple(Q.shape)}")
    dev, b, lam0 = _stage(spec, blocks, options, lam0, device, (Q.shape[0],))
    return _solve_core(b, lam0, options, backend)

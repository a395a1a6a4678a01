"""High-level solver: condense -> PCG or an exact solve -> recover, single
or batched.

Backends, named after ``gato_tpu``'s:

* ``'torch'``: plain PyTorch ops on any device (``gato_tpu``'s ``'jax'``);
  the CPU default, the float64 path and the numerics oracle.  With
  ``method='direct'``: condense, direct.btd_solve_auto (block Thomas), the
  true residual, recover_dz.
* ``'pcg_kernel'``: condensation in PyTorch ops, then the CUDA PCG kernel
  (kernel A, kernels/pcg_kernel.py; ``gato_tpu``'s ``'pallas'``); past
  kernel A's shared memory (``longk.should_dispatch``) the long-K tier
  instead, condensation, PCG and recovery in its CUDA kernels
  (kernels/longk.py, ``gato_tpu``'s ``longk.solve_longk_batched``).  With
  ``method='direct'`` the long-K exact tier at any K
  (``longk.solve_direct_longk_batched``: condensation, block cyclic
  reduction, recovery), as ``gato_tpu``'s ``'pallas'`` runs its ladder.
* ``'fused'``: the whole solve in hand-written CUDA kernels, ``gato_tpu``'s
  TPU default: kernel B (kernels/fused_solve.py) for ``method='pcg'``; for
  ``method='direct'`` the cyclic-reduction kernel (row 4,
  kernels/direct_fused.py), or from B >= 16 the block-Thomas pair (rows 5
  and 6, kernels/thomas_batch.py, ``thomas_batch.should_dispatch``).

Auto-selection (``pcg_backend=None``) picks ``'fused'`` for float32 on CUDA
and ``'torch'`` on the CPU or for float64.  Where no 'fused' kernel takes
the shape it picks ``'pcg_kernel'`` (``gato_tpu``'s ``'pallas'`` there):
with ``method='pcg'`` past kernel B's shared memory (the long-K tier),
with ``method='direct'`` past row 4's where the Thomas pair declines the
batch width (IIWA K >= 741 at B < 16 on an H100: the long-K exact tier).
An explicit kernel backend with float64, an unknown backend and an
explicit ``'fused'`` past those limits raise.  Every entry point takes
``device=`` (default ``"cuda"``) and raises if that device is CUDA and no
CUDA device is available: nothing falls back to the CPU silently.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import assemble, direct, pcg as pcg_mod, recover
from .formats import KKTBlocks, blocks_to_torch, check_block_shapes, interleave_dz
from .kernels import _build, direct_fused, longk, thomas_batch
from .kernels import fused_solve as fused_kernel
from .kernels import pcg_kernel
from .problem import ProblemSpec, SolverOptions
from .spans import span

VALID_PCG_BACKENDS = ("torch", "pcg_kernel", "fused")
KERNEL_BACKENDS = ("pcg_kernel", "fused")


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


def shared_limit(device, smem_limit: Optional[int] = None) -> int:
    """The per-block shared memory the kernel routes plan for: ``smem_limit``
    if given, the CUDA device's opt-in bytes, or an H100's for the CPU (so
    that the plain versions take the route the card would)."""
    if smem_limit is not None:
        return smem_limit
    dev = resolve_device(device)
    if dev.type == "cuda":
        return _build.max_shared_bytes(dev)
    return longk.H100_SHARED_BYTES


def _past_fused(options: SolverOptions, shape: tuple, limit: int,
                batch: int) -> bool:
    """True iff no kernel of the 'fused' backend takes the shape: for
    ``method='pcg'`` kernel B's shared memory does not hold it; for
    ``'direct'`` row 4's does not and the Thomas pair declines the batch
    width."""
    if options.method == "pcg":
        return not fused_kernel.fits(*shape, limit)
    return (longk.should_dispatch_direct(*shape, limit)
            and not thomas_batch.should_dispatch(batch, *shape))


def _resolve_backend(pcg_backend: Optional[str], options: SolverOptions,
                     device, shape: Optional[tuple] = None,
                     smem_limit: Optional[int] = None, batch: int = 1) -> str:
    """Validate an explicit backend choice, or auto-select.  Requests that
    cannot be honoured raise instead of degrading.  ``shape`` (K, s, c),
    where given, with ``batch`` problems, routes past the 'fused' kernels
    (``smem_limit``, default :func:`shared_limit`; :func:`_past_fused`):
    auto takes ``'pcg_kernel'`` there, an explicit ``'fused'`` raises."""
    def past_fused():
        return shape is not None and _past_fused(
            options, shape, shared_limit(device, smem_limit), batch)

    if pcg_backend is None:
        backend = default_pcg_backend(device, options.dtype)
        return "pcg_kernel" if backend == "fused" and past_fused() else backend
    if pcg_backend not in VALID_PCG_BACKENDS:
        raise ValueError(
            f"unknown pcg_backend {pcg_backend!r}; valid choices are "
            f"{VALID_PCG_BACKENDS} or None for auto-selection")
    if pcg_backend in KERNEL_BACKENDS and _torch_dtype(options.dtype) != torch.float32:
        raise ValueError(
            f"pcg_backend={pcg_backend!r} runs float32-only CUDA kernels; "
            f"dtype={options.dtype!r} needs pcg_backend None (auto) or 'torch'")
    if pcg_backend == "fused" and past_fused():
        kernel = fused_kernel if options.method == "pcg" else direct_fused
        limit = shared_limit(device, smem_limit) - _build.RESERVED_SHARED_BYTES
        raise ValueError(kernel.past_limit_message(
            "pcg_backend='fused'", *shape, kernel.smem_bytes(*shape), limit))
    return pcg_backend


def spec_shape(spec: ProblemSpec) -> tuple:
    """(K, s, c) of a spec, as the routing reads it."""
    return spec.knot_points, spec.state_size, spec.control_size


def _direct_torch(b: KKTBlocks, rho: float) -> SolveResult:
    """method='direct' on the 'torch' backend: condense, block Thomas, the
    true residual, recover (gato_tpu.solver._direct_result)."""
    sys = assemble.condense(*b, rho, None)
    lam = direct.btd_solve_auto(sys.S, sys.gamma)
    eta, gamma_sq = direct.residual_norms(sys.S, sys.gamma, lam)
    dz_x, dz_u = recover.recover_dz(sys.Qinv, sys.Rinv, b.A, b.B, b.q, b.r, lam)
    iters = torch.zeros(eta.shape, dtype=torch.int32, device=eta.device)
    return SolveResult(lam, dz_x, dz_u, iters,
                       direct.residual_converged(eta, gamma_sq), eta)


def _direct_kernels(b: KKTBlocks, rho: float) -> SolveResult:
    """method='direct' on the 'fused' backend: the block-Thomas pair from
    B >= 16 (thomas_batch.should_dispatch), else the cyclic-reduction
    kernel, whose wrapper raises past its shared memory.  On CPU tensors
    the wrappers run their plain versions."""
    Bn, K, s, _ = b.Q.shape
    if thomas_batch.should_dispatch(Bn, K, s, b.R.shape[-1]):
        res, dz_x, dz_u = thomas_batch.solve_direct_thomas_cuda(*b, rho=rho)
    else:
        res, dz_x, dz_u = direct_fused.direct_fused_cuda(*b, rho=rho)
    return SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)


def _solve_core(b: KKTBlocks, lam0: torch.Tensor, options: SolverOptions,
                backend: str) -> SolveResult:
    """The batched solve on staged tensors (one leading batch axis)."""
    if options.method == "direct":
        if backend == "fused":
            return _direct_kernels(b, options.rho)
        if backend == "pcg_kernel":
            res, dz_x, dz_u = longk.solve_direct_longk_batched(*b, rho=options.rho)
            return SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)
        return _direct_torch(b, options.rho)
    kw = dict(exit_tol=options.exit_tol, max_iters=options.max_iters,
              poly_degree=options.precond_poly_degree)
    if backend == "fused":
        res, dz_x, dz_u = fused_kernel.fused_solve_cuda(
            *b, lam0, rho=options.rho,
            preconditioner=options.preconditioner.value, **kw)
        return SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)
    Bn, K, s, _ = b.Q.shape
    if backend == "pcg_kernel" and longk.should_dispatch(
            K, s, b.R.shape[-1], shared_limit(b.q.device)):
        res, dz_x, dz_u = longk.solve_longk_batched(
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
        ``options.warm_start`` (and not by ``method='direct'``).
      pcg_backend: 'torch' | 'pcg_kernel' | 'fused' | None (auto).
      device: where to solve; default "cuda".
    """
    with span("gato.solve"):
        with span("gato.route"):
            backend = _resolve_backend(pcg_backend, options, device, spec_shape(spec))
        with span("gato.stage"):
            dev, b, lam0 = _stage(spec, blocks, options, lam0, device, ())
        with span("gato.solve_core"):
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
    with span("gato.solve_batched"):
        Q = blocks.Q
        with span("gato.route"):
            backend = _resolve_backend(pcg_backend, options, device, spec_shape(spec),
                                       batch=Q.shape[0])
        if Q.ndim != 4:
            raise ValueError(
                f"solve_batched expects a leading batch axis on every array "
                f"(Q (B, K, s, s)); got Q shape {tuple(Q.shape)}")
        with span("gato.stage"):
            dev, b, lam0 = _stage(spec, blocks, options, lam0, device, (Q.shape[0],))
        with span("gato.solve_core"):
            return _solve_core(b, lam0, options, backend)

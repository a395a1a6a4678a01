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
Widths above ``_build.MAX_BLOCK`` (32): kernel B takes the pairs compiled
into it (``fused_solve.COMPILED_WIDTHS``: (36, 12)) within its shared
memory; with ``method='pcg'``, ``'pcg_kernel'`` takes a control size above
32 (its condensation is PyTorch's) where kernel A holds the horizon.  Every
other such shape, and every one with ``method='direct'``, auto-selects
``'torch'`` (``gato_tpu``'s ``'jax'``, which it takes for any width off
the TPU).  An explicit kernel backend with float64, an unknown backend, an
explicit ``'fused'`` past those limits and an explicit kernel backend at a
shape it has no kernel for raise.  Every entry point takes
``device=`` (default ``"cuda"``) and raises if that device is CUDA and no
CUDA device is available: nothing falls back to the CPU silently.

``solve_batched`` keeps a launch plan per call signature (:func:`launch_plan`):
a repeat call whose tensors are already staged routes, stages and plans
nothing, and on kernel B or row 4 allocates its outputs and launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import assemble, direct, pcg as pcg_mod, recover
from .formats import KKTBlocks, blocks_to_torch, check_block_shapes, interleave_dz
from .kernels import _build, direct_fused, fused_sequence, longk, thomas_batch
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


def _pcg_kernel_takes(options: SolverOptions, shape: tuple, limit: int) -> bool:
    """True iff the 'pcg_kernel' backend has a kernel for ``shape`` (K, s, c)
    under ``limit`` bytes of shared memory a block: for ``method='pcg'``
    kernel A (s <= MAX_BLOCK, any c) within its shared memory, past it the
    long-K tier (s, c <= MAX_BLOCK); for ``'direct'`` the long-K exact tier
    (s, c <= MAX_BLOCK)."""
    K, s, c = shape
    if options.method == "pcg":
        return pcg_kernel.fits(K, s, limit) or longk.should_dispatch(K, s, c, limit)
    return fused_kernel.takes_widths(s, c, ())


def _past_fused(options: SolverOptions, shape: tuple, limit: int,
                batch: int, farm: bool = False) -> bool:
    """True iff no kernel of the 'fused' backend takes the shape: for
    ``method='pcg'`` kernel B (with ``farm``, the farm kernel) does not
    take its widths or its shared memory does not hold it; for ``'direct'``
    the widths are above MAX_BLOCK, or row 4's shared memory does not hold
    it and the Thomas pair declines the batch width."""
    if options.method == "pcg":
        return not (fused_sequence if farm else fused_kernel).fits(*shape, limit)
    return not fused_kernel.takes_widths(*shape[1:], ()) or (
        longk.should_dispatch_direct(*shape, limit)
        and not thomas_batch.should_dispatch(batch, *shape))


def _resolve_backend(pcg_backend: Optional[str], options: SolverOptions,
                     device, shape: Optional[tuple] = None,
                     smem_limit: Optional[int] = None, batch: int = 1,
                     farm: bool = False) -> str:
    """Validate an explicit backend choice, or auto-select.  Requests that
    cannot be honoured raise instead of degrading.  ``shape`` (K, s, c),
    where given, with ``batch`` problems (``farm``: of the farm entry,
    whose 'fused' kernel is the farm kernel), routes past the 'fused'
    kernels (``smem_limit``, default :func:`shared_limit`;
    :func:`_past_fused`): auto takes ``'pcg_kernel'`` there where it has a
    kernel for the shape (:func:`_pcg_kernel_takes`), else ``'torch'``;
    an explicit ``'fused'`` raises there, and an explicit ``'pcg_kernel'``
    where it has no kernel."""
    def limit():
        return shared_limit(device, smem_limit)

    def past_fused():
        return shape is not None and _past_fused(options, shape, limit(), batch, farm)

    if pcg_backend is None:
        backend = default_pcg_backend(device, options.dtype)
        if backend == "fused" and past_fused():
            return "pcg_kernel" if _pcg_kernel_takes(options, shape, limit()) else "torch"
        return backend
    if pcg_backend not in VALID_PCG_BACKENDS:
        raise ValueError(
            f"unknown pcg_backend {pcg_backend!r}; valid choices are "
            f"{VALID_PCG_BACKENDS} or None for auto-selection")
    if pcg_backend in KERNEL_BACKENDS and _torch_dtype(options.dtype) != torch.float32:
        raise ValueError(
            f"pcg_backend={pcg_backend!r} runs float32-only CUDA kernels; "
            f"dtype={options.dtype!r} needs pcg_backend None (auto) or 'torch'")
    if pcg_backend == "pcg_kernel" and shape is not None \
            and not _pcg_kernel_takes(options, shape, limit()):
        raise ValueError(_pcg_kernel_message(options, shape))
    if pcg_backend == "fused" and past_fused():
        if not fused_kernel.takes_widths(*shape[1:], ()):
            # Past the kernel's widths, or a wide pair past its shared memory.
            wide = fused_kernel.COMPILED_WIDTHS if options.method == "pcg" and not farm else ()
            raise ValueError(fused_kernel.width_message("pcg_backend='fused'", *shape, wide))
        kernel = fused_kernel if options.method == "pcg" else direct_fused
        raise ValueError(kernel.past_limit_message(
            "pcg_backend='fused'", *shape, kernel.smem_bytes(*shape),
            limit() - _build.RESERVED_SHARED_BYTES))
    return pcg_backend


def _pcg_kernel_message(options: SolverOptions, shape: tuple) -> str:
    K, s, c = shape
    what = (f"kernel A takes s <= {_build.MAX_BLOCK} within its shared memory, the "
            f"long-K tier past it s, c <= {_build.MAX_BLOCK}" if options.method == "pcg"
            else f"the long-K exact tier takes s, c <= {_build.MAX_BLOCK}")
    return (f"pcg_backend='pcg_kernel': (K, s, c) = ({K}, {s}, {c}): {what}; pass "
            "pcg_backend None (auto) or 'torch', which solve any widths")


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


# ---- The launch plans of solve_batched ----
#
# What solve_batched decides from its call signature alone (spec, options,
# pcg_backend, device, B), built on a signature's first call and kept for
# later ones: at most PLAN_CACHE_SIZE plans, the oldest evicted.  A
# signature whose route or plan raises is never kept.  PLAN_BUILDS and
# PLAN_HITS count the builds and the lookups that found a plan.

PLAN_CACHE_SIZE = 64
PLAN_BUILDS = 0
PLAN_HITS = 0
_PLANS: dict = {}


class LaunchPlan(NamedTuple):
    """A signature's route, and what a call's tensors must be to skip
    staging: ``dtype``, contiguous, on ``device``, of ``shapes`` (Q, R, A,
    B, q, r, c, then lam0's)."""
    backend: str
    device: torch.device
    dtype: torch.dtype
    shapes: tuple
    lam0: Optional[torch.Tensor]  # kernel B's zero lam0: the kernel only reads it
    launch: Optional[tuple]       # (kernel module, its Launch): kernel B or row 4


def _plan_device(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device without an index at the
    current one's (where CUDA is present)."""
    dev = device if isinstance(device, torch.device) else torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _build_plan(spec, options, pcg_backend, device, dev, batch) -> LaunchPlan:
    with span("gato.plan"):
        K, s, c = shape = spec_shape(spec)
        backend = _resolve_backend(pcg_backend, options, device, shape, batch=batch)
        expect = fused_kernel.block_shapes((batch,), K, s, c)
        shapes = tuple(map(torch.Size, expect.values())) + (torch.Size((batch, K, s)),)
        lam0 = launch = None
        if backend == "fused" and dev.type == "cuda":
            if options.method == "pcg":
                launch = fused_kernel, fused_kernel.plan(
                    batch, K, s, c, dev, rho=options.rho, exit_tol=options.exit_tol,
                    max_iters=options.max_iters, poly_degree=options.precond_poly_degree,
                    preconditioner=options.preconditioner.value)
                lam0 = torch.zeros(shapes[-1], dtype=torch.float32, device=dev)
            elif not thomas_batch.should_dispatch(batch, K, s, c):
                launch = direct_fused, direct_fused.plan(batch, K, s, c, dev,
                                                         rho=options.rho)
        return LaunchPlan(backend, dev, _torch_dtype(options.dtype), shapes, lam0, launch)


def launch_plan(spec: ProblemSpec, options: SolverOptions, pcg_backend, device,
                batch: int) -> LaunchPlan:
    """The plan of ``solve_batched``'s call signature: the kept one, or one
    built now (raising what the route or the kernel's plan raises)."""
    global PLAN_BUILDS, PLAN_HITS
    dev = _plan_device(device)
    key = (spec, options, pcg_backend, dev, batch)
    plan = _PLANS.get(key)
    if plan is not None:
        PLAN_HITS += 1
        return plan
    plan = _build_plan(spec, options, pcg_backend, device, dev, batch)
    if len(_PLANS) >= PLAN_CACHE_SIZE:
        del _PLANS[next(iter(_PLANS))]
    _PLANS[key] = plan
    PLAN_BUILDS += 1
    return plan


def _staged(plan: LaunchPlan, fields: tuple) -> bool:
    """True iff every field is a tensor as the plan expects it: its dtype,
    contiguous, on its device, of its shape."""
    dtype, dev = plan.dtype, plan.device
    for t, shape in zip(fields, plan.shapes):
        if not (isinstance(t, torch.Tensor) and t.dtype is dtype and t.device == dev
                and t.shape == shape and t.is_contiguous()):
            return False
    return True


def _run_plan(plan: LaunchPlan, b: KKTBlocks, lam0, options: SolverOptions) -> SolveResult:
    """The batched solve of staged tensors under ``plan``: its kernel's
    launch, or :func:`_solve_core` on its backend.  From lam = 0, only
    kernel B takes the plan's lam0; other paths take a fresh one, as
    staging makes it, since the plain PCG returns lam0 itself as lam where
    no iteration runs."""
    is_pcg = options.method == "pcg"
    if is_pcg and lam0 is None:
        lam0 = plan.lam0 if plan.lam0 is not None else torch.zeros(
            plan.shapes[-1], dtype=plan.dtype, device=plan.device)
    if plan.launch is None:
        return _solve_core(KKTBlocks(*b), lam0, options, plan.backend)
    kernel, launch = plan.launch
    args = (*b, lam0) if is_pcg else b
    res, dz_x, dz_u = kernel.run(launch, *args)
    return SolveResult(res.lam, dz_x, dz_u, res.iters, res.converged, res.eta)


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
    updating while the rest of the batch iterates.

    The route and the kernel's plan come from :func:`launch_plan`, kept per
    call signature.  Tensors already of the options' dtype, contiguous, on
    ``device`` and of the spec's shapes are used as they are; any other
    input is staged (copied, cast, made contiguous and checked) first."""
    with span("gato.solve_batched"):
        Q = blocks.Q
        with span("gato.route"):
            plan = launch_plan(spec, options, pcg_backend, device, Q.shape[0])
        if Q.ndim != 4:
            raise ValueError(
                f"solve_batched expects a leading batch axis on every array "
                f"(Q (B, K, s, s)); got Q shape {tuple(Q.shape)}")
        with span("gato.stage"):
            warm = options.warm_start and lam0 is not None
            staged = _staged(plan, (*blocks, lam0) if warm else blocks)
            if not staged:
                _, b, lam0 = _stage(spec, blocks, options, lam0, device, (Q.shape[0],))
        with span("gato.solve_core"):
            if staged:
                return _run_plan(plan, blocks, lam0 if warm else None, options)
            return _solve_core(b, lam0, options, plan.backend)

"""Packed-input serving API: stage the inputs once, not per call.

The counterpart of ``gato_tpu.packed`` on its PCG tier.  ``solve`` and
``solve_batched`` convert and copy their NumPy (or tensor) inputs to the
device on every call.  This module makes the staged form a reusable value,
for callers that solve the same arrays again (rho or tolerance sweeps,
repeated serving of a fixed linearization) or change only the right-hand
side between calls (MPC tracking with frozen dynamics):

    packed = pack(spec, blocks)                    # stage once
    res = solve_packed(packed, options)            # one kernel launch
    packed = update_vectors(packed, q, r, c)       # restage ONLY the rhs
    res = solve_packed(packed, options, lam0=res.lam_packed)   # warm start

and, for a warm-started farm of B streams served window by window,

    seq = pack_sequence(spec, window)              # (T, B, ...) blocks
    out = solve_packed_sequence(seq, options, lam0=prev.lam_tail_packed)

The "packed" form is the kernels' own layout: contiguous float32 tensors on
the device in the public (B, K, ...) shapes (with a leading T axis for a
sequence), so a carried lambda needs no relayout between calls.
``gato_tpu``'s lane packing (``PackPlan``'s ``K_sub``, ``g``, ``L``,
``n_groups``, ``sp``) and the method relabelling of its ``solve_packed``
exist for TPU lanes and have no counterpart here.

``solve_packed`` launches kernel B (kernels/fused_solve.py) for
``method='pcg'``, or, past its shared memory, the long-K tier
(kernels/longk.py; ``pack`` records ``tier='longk'`` in its plan, as
``gato_tpu.packed.pack`` does); for ``method='direct'`` the plan's tier:
``'cr'``, the cyclic-reduction kernel (row 4, kernels/direct_fused.py),
``'thomas'``, the block-Thomas pair (rows 5 and 6, kernels/thomas_batch.py),
which ``pack(method='direct')`` picks from B >= 16 as ``solve_batched``
does (``tier=`` overrides), or past row 4's shared memory ``'longk'``, the
long-K exact tier (kernels/longk.py; ``gato_tpu``'s ``tier='longk'`` too).
A ``'longk'`` pack, for either method, is solved exactly on that tier.
Where no kernel takes the widths (s or c above 32, but kernel B's compiled
pairs for 'pcg'), ``pack`` records ``tier='torch'``: the plain PyTorch path
on the pack's device, for either method, as ``solve`` auto-selects there.
Every tier reads the same staged tensors, so a pack serves either method.
``solve_packed_sequence`` launches the sequence kernel
(kernels/fused_sequence.py), or past its shared memory runs the window's
steps one after another on the long-K tier, and is PCG-only, as in
``gato_tpu``.
Tensors packed on the CPU run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .formats import KKTBlocks, blocks_to_torch, check_block_shapes
from .kernels import _build, direct_fused, fused_sequence, fused_solve, longk, thomas_batch
from .mpc import _sequence_core
from .problem import ProblemSpec, SolverOptions
from .solver import SolveResult, _solve_core, _torch_dtype, resolve_device, shared_limit

DIRECT_TIERS = ("cr", "thomas")


class PackPlan(NamedTuple):
    """What a packed value holds.

    ``method`` is the method it was packed for ('pcg' or 'direct');
    ``batched`` records whether the caller passed a leading batch axis
    (``unpack`` restores the caller's shapes); ``batch`` is the number of
    problems (streams for a sequence); ``tier`` is the direct route ('cr',
    'thomas', or 'longk' past row 4's shared memory) of a 'direct' pack,
    and for 'pcg' None (kernel B or the farm kernel) or 'longk' (past their
    shared memory: the long-K tier); 'torch' where no kernel takes the
    widths (the plain PyTorch path)."""

    method: str
    batched: bool
    batch: int
    K: int
    s: int
    c: int
    tier: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PackedKKT:
    """KKT blocks staged for kernel B: float32 tensors on one device,
    matrices (B, K, n, m) and vectors (B, K, n) as in ``formats.KKTBlocks``
    with a leading batch axis (B = 1 for an unbatched pack)."""

    Qb: torch.Tensor
    Rb: torch.Tensor
    Ab: torch.Tensor
    Bb: torch.Tensor
    qb: torch.Tensor
    rb: torch.Tensor
    cb: torch.Tensor
    plan: PackPlan


@dataclasses.dataclass(frozen=True)
class PackedSolveResult:
    """Solve outputs in kernel layout: ``lam_p``, ``dzx_p`` (B, K, s),
    ``dzu_p`` (B, K-1, c); ``iters``, ``converged``, ``eta`` (B,)."""

    lam_p: torch.Tensor
    dzx_p: torch.Tensor
    dzu_p: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    eta: torch.Tensor
    plan: PackPlan

    @property
    def lam_packed(self) -> torch.Tensor:
        """Multipliers in kernel layout: feed as ``solve_packed(lam0=...)``
        to warm-start the next solve with no relayout."""
        return self.lam_p

    def unpack(self) -> SolveResult:
        """Public SolveResult shapes: (B, K, s) batched, (K, s) otherwise."""
        res = SolveResult(self.lam_p, self.dzx_p, self.dzu_p, self.iters,
                          self.converged, self.eta)
        if self.plan.batched:
            return res
        return SolveResult(*(t[0] for t in res))


def _is_float32(a) -> bool:
    return (a.dtype == torch.float32 if torch.is_tensor(a)
            else np.asarray(a).dtype == np.float32)


def _check_options(options: SolverOptions, caller: str) -> None:
    if _torch_dtype(options.dtype) != torch.float32:
        raise ValueError(f"{caller} runs float32-only CUDA kernels; "
                         f"dtype={options.dtype!r} needs the standard solve() API")


def _kernel_kw(options: SolverOptions) -> dict:
    return dict(exit_tol=options.exit_tol, max_iters=options.max_iters,
                poly_degree=options.precond_poly_degree,
                preconditioner=options.preconditioner.value)


def _warm_start(lam0, carry_shape, public_shape, device) -> torch.Tensor:
    """lam0 as a kernel-layout tensor: zeros, the carry itself, or a public
    array of ``public_shape``."""
    if lam0 is None:
        return torch.zeros(carry_shape, dtype=torch.float32, device=device)
    lam0 = torch.as_tensor(lam0, dtype=torch.float32, device=device)
    if tuple(lam0.shape) == carry_shape:
        return lam0.contiguous()
    if tuple(lam0.shape) == public_shape:
        return lam0.reshape(carry_shape).contiguous()
    raise ValueError(f"lam0 shape {tuple(lam0.shape)} is neither the packed carry "
                     f"{carry_shape} nor the public {public_shape}")


def _pcg_tier(K: int, s: int, c: int, device, farm: bool = False) -> Optional[str]:
    """The method='pcg' route of these widths on ``device``: None where
    kernel B (with ``farm``, the farm kernel) takes them, 'longk' past its
    shared memory where the long-K tier takes the widths, else 'torch'."""
    kernel = fused_sequence if farm else fused_solve
    if kernel.fits(K, s, c, shared_limit(device)):
        return None
    return "longk" if fused_solve.takes_widths(s, c, ()) else "torch"


def _direct_tier(tier: Optional[str], Bn: int, K: int, s: int, c: int,
                 device) -> str:
    """The direct route of a pack: 'thomas' from B >= 16 when its stacks
    fit (thomas_batch.should_dispatch), else 'cr', or 'longk' (the long-K
    exact tier) past row 4's shared memory on ``device``, where an explicit
    'cr' goes too (gato_tpu.packed's rule); 'torch' at widths above 32,
    where no exact kernel runs.  A forced 'thomas' that does not fit, or a
    forced 'cr' at such widths, raises."""
    if not fused_solve.takes_widths(s, c, ()):
        if tier is not None:
            raise ValueError(
                f"tier={tier!r}: (K, s, c) = ({K}, {s}, {c}): the exact kernels take "
                f"s, c <= {_build.MAX_BLOCK}; pass tier=None, which packs these "
                "widths for the plain PyTorch path")
        return "torch"
    if tier == "thomas":
        if not thomas_batch.fits(Bn, K, s, c):
            raise ValueError(
                f"tier='thomas' was requested but the block-Thomas kernels decline "
                f"(B={Bn}, K={K}, s={s}, c={c}): their factor stacks exceed "
                f"{thomas_batch.FACTOR_BUDGET_BYTES} B or a block is too wide "
                "(thomas_batch.fits)")
        return tier
    if tier is None and thomas_batch.should_dispatch(Bn, K, s, c):
        return "thomas"
    return "longk" if longk.should_dispatch_direct(K, s, c, shared_limit(device)) else "cr"


def pack(spec: ProblemSpec, blocks: KKTBlocks, *, method: str = "pcg",
         tier: Optional[str] = None, device="cuda") -> PackedKKT:
    """Stage KKT blocks for the kernels.

    Args:
      spec: problem shape (checked against ``blocks``).
      blocks: float32 KKT data (formats.pack_kkt), with or without a
        leading batch axis (``Q.ndim == 4`` means batched).
      method: 'pcg' or 'direct', the method ``solve_packed`` runs on the
        pack's own kernel (``options.method`` may ask for the other: the
        layout is the same).
      tier: method='direct' only: None (the batch-width pick of
        solve_batched), 'cr' (row 4) or 'thomas' (rows 5 and 6; raises
        where their stacks do not fit).  Past row 4's shared memory None
        below B = 16 and 'cr' record 'longk'.
      device: where to stage; default "cuda".

    Raises ValueError for blocks that are not float32 (the kernels take
    float32; float64 runs the plain path through ``solve``), that do not
    match ``spec``, or for a tier that the method does not have."""
    if method not in ("pcg", "direct"):
        raise ValueError(f"unknown method {method!r}; valid: 'pcg', 'direct'")
    if tier is not None and not (method == "direct" and tier in DIRECT_TIERS):
        raise ValueError(
            f"tier={tier!r} is not a choice for method={method!r}; explicit "
            f"tiers exist for method='direct' only: {DIRECT_TIERS}")
    if not all(_is_float32(a) for a in blocks):
        raise ValueError("pack() feeds float32-only CUDA kernels; cast the "
                         "blocks to float32 (float64 runs the plain path via "
                         "solve())")
    dev = resolve_device(device)
    b = blocks_to_torch(blocks, dev)
    batched = b.Q.ndim == 4
    if not batched:
        b = KKTBlocks(*(a.unsqueeze(0) for a in b))
    Bn = b.Q.shape[0]
    check_block_shapes(spec, b, lead=(Bn,))
    K, s, c = spec.knot_points, spec.state_size, spec.control_size
    if method == "direct":
        tier = _direct_tier(tier, Bn, K, s, c, dev)
    else:
        tier = _pcg_tier(K, s, c, dev)
    plan = PackPlan(method=method, batched=batched, batch=Bn, K=K, s=s, c=c,
                    tier=tier)
    return PackedKKT(*b, plan=plan)


def _torch_result(b: KKTBlocks, lam0, options: SolverOptions,
                  plan: PackPlan) -> PackedSolveResult:
    """A 'torch' pack's solve: the plain PyTorch path (solver._solve_core)."""
    out = _solve_core(b, lam0, options, "torch")
    return PackedSolveResult(out.lam, out.dz_x, out.dz_u, out.iters,
                             out.converged, out.eta, plan)


def update_vectors(packed: PackedKKT, q, r, c) -> PackedKKT:
    """A PackedKKT with fresh right-hand sides (q, r, c) and the SAME
    matrices: the cheap refresh for serving a frozen linearization."""
    plan = packed.plan
    if not all(_is_float32(x) for x in (q, r, c)):
        raise ValueError("update_vectors feeds float32-only CUDA kernels; cast "
                         "the vectors to float32")
    dev = packed.qb.device
    q, r, c = (torch.as_tensor(x, device=dev) for x in (q, r, c))
    if not plan.batched:
        q, r, c = q.unsqueeze(0), r.unsqueeze(0), c.unsqueeze(0)
    expect = {"q": (plan.batch, plan.K, plan.s),
              "r": (plan.batch, plan.K - 1, plan.c),
              "c": (plan.batch, plan.K, plan.s)}
    for name, arr in (("q", q), ("r", r), ("c", c)):
        if tuple(arr.shape) != expect[name]:
            note = "" if plan.batched else " (unbatched pack)"
            raise ValueError(f"{name} shape {tuple(arr.shape)} does not match the "
                             f"packed plan's {expect[name]}{note}")
    return dataclasses.replace(packed, qb=q.contiguous(), rb=r.contiguous(),
                               cb=c.contiguous())


def solve_packed(packed: PackedKKT, options: SolverOptions = SolverOptions(),
                 lam0=None) -> PackedSolveResult:
    """Solve from staged inputs: one launch of kernel B for
    ``options.method == 'pcg'`` (past its shared memory, a 'longk' pack,
    the long-K tier: kernels/longk.py); for 'direct' the pack's tier
    (a 'longk' pack of either method the long-K exact tier; another pack
    made for 'pcg' takes solve_batched's batch-width pick), one launch of
    row 4, one of each of rows 5 and 6, or the long-K exact tier.  Widths
    that no kernel of the method takes run the plain PyTorch path.

    ``lam0``: None (cold start), the packed carry (B, K, s) (a previous
    ``PackedSolveResult.lam_packed``) or a public array ((K, s) for an
    unbatched pack).  A supplied ``lam0`` is used whatever
    ``options.warm_start`` says: chaining is the point of this API.  An
    exact solve reads no ``lam0``."""
    plan = packed.plan
    _check_options(options, "solve_packed")
    blocks = (packed.Qb, packed.Rb, packed.Ab, packed.Bb, packed.qb, packed.rb,
              packed.cb)
    if options.method == "direct":
        tier = (plan.tier if plan.method == "direct" or plan.tier is not None else
                _direct_tier(None, plan.batch, plan.K, plan.s, plan.c,
                             packed.qb.device))
        if tier == "torch":
            return _torch_result(KKTBlocks(*blocks), None, options, plan)
        solve = {"thomas": thomas_batch.solve_direct_thomas_cuda,
                 "cr": direct_fused.direct_fused_cuda,
                 "longk": longk.solve_direct_longk_batched}[tier]
        res, dz_x, dz_u = solve(*blocks, rho=options.rho)
        return PackedSolveResult(res.lam, dz_x, dz_u, res.iters, res.converged,
                                 res.eta, plan)
    carry = (plan.batch, plan.K, plan.s)
    public = carry if plan.batched else (plan.K, plan.s)
    lb = _warm_start(lam0, carry, public, packed.qb.device)
    tier = _pcg_tier(plan.K, plan.s, plan.c, packed.qb.device)
    if tier == "torch":
        return _torch_result(KKTBlocks(*blocks), lb, options, plan)
    if tier == "longk":
        res, dz_x, dz_u = longk.solve_longk_batched(
            *blocks, lb, rho=options.rho, **_kernel_kw(options))
    else:
        res, dz_x, dz_u = fused_solve.fused_solve_cuda(
            *blocks, lb, rho=options.rho, **_kernel_kw(options))
    return PackedSolveResult(res.lam, dz_x, dz_u, res.iters, res.converged,
                             res.eta, plan)


# ---------------------------------------------------------------------------
# Sequence farms: stage a (T, B) window once, carry lambda between windows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedKKTSequence:
    """A (T, B) farm window staged for the sequence kernel: matrices
    (T, B, K, n, m), vectors (T, B, K, n), float32 on one device."""

    Qb: torch.Tensor
    Rb: torch.Tensor
    Ab: torch.Tensor
    Bb: torch.Tensor
    qb: torch.Tensor
    rb: torch.Tensor
    cb: torch.Tensor
    plan: PackPlan

    @property
    def T(self) -> int:
        return self.Qb.shape[0]


@dataclasses.dataclass(frozen=True)
class PackedSequenceResult:
    """Farm outputs in kernel layout: ``lam_p``, ``dzx_p`` (T, B, K, s),
    ``dzu_p`` (T, B, K-1, c); ``iters``, ``converged``, ``eta`` (T, B)."""

    lam_p: torch.Tensor
    dzx_p: torch.Tensor
    dzu_p: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    eta: torch.Tensor
    plan: PackPlan

    @property
    def lam_tail_packed(self) -> torch.Tensor:
        """The last step's multipliers (B, K, s): feed as the next window's
        ``solve_packed_sequence(lam0=...)``."""
        return self.lam_p[-1]

    def unpack(self) -> SolveResult:
        """Public shapes: lam, dz_x (T, B, K, s), dz_u (T, B, K-1, c), the
        rest (T, B)."""
        return SolveResult(self.lam_p, self.dzx_p, self.dzu_p, self.iters,
                           self.converged, self.eta)


def pack_sequence(spec: ProblemSpec, blocks: KKTBlocks, *, method: str = "pcg",
                  device="cuda") -> PackedKKTSequence:
    """Stage a (T, B) farm window once, for solve_packed_sequence.

    ``blocks`` arrays carry leading (T, B) axes (the
    mpc.solve_sequence_batched convention) and are cast to float32.  Only
    the warm-started PCG farm is served: an exact farm has no warm-start
    carry, so its (T, B) grid folds into one batch of T*B solves."""
    if method != "pcg":
        raise ValueError(
            "pack_sequence serves the warm-started PCG farm only; the exact "
            "farm folds its (T, B) grid into one batch of T*B solves")
    dev = resolve_device(device)
    b = blocks_to_torch(blocks, dev)
    if b.Q.ndim != 5:
        raise ValueError(f"pack_sequence expects leading (T, B) axes on every "
                         f"array (Q is {b.Q.ndim}-d); for a single sequence add "
                         "a B=1 axis")
    T, Bn = b.Q.shape[:2]
    check_block_shapes(spec, b, lead=(T, Bn))
    K, s, c = spec.knot_points, spec.state_size, spec.control_size
    plan = PackPlan(method="pcg", batched=True, batch=Bn, K=K, s=s, c=c,
                    tier=_pcg_tier(K, s, c, dev, farm=True))
    return PackedKKTSequence(*b, plan=plan)


def solve_packed_sequence(packed: PackedKKTSequence,
                          options: SolverOptions = SolverOptions(),
                          lam0=None) -> PackedSequenceResult:
    """Run a whole warm-started farm window from staged inputs: one launch
    of the sequence kernel, every step at ``options.rho``; for a
    ``tier='longk'`` pack the long-K tier step after step, each
    warm-started from the last (a ``tier='torch'`` pack: the plain PyTorch
    path so).

    ``lam0``: None (cold start) or a (B, K, s) array, for example the
    previous window's ``lam_tail_packed``; it is used whatever
    ``options.warm_start`` says."""
    plan = packed.plan
    if options.method != "pcg":
        raise ValueError(
            "solve_packed_sequence is the warm-started PCG farm; "
            "method='direct' sequences fold into one batch of T*B solves")
    _check_options(options, "solve_packed_sequence")
    carry = (plan.batch, plan.K, plan.s)
    dev = packed.qb.device
    lb = _warm_start(lam0, carry, carry, dev)
    blocks = KKTBlocks(packed.Qb, packed.Rb, packed.Ab, packed.Bb, packed.qb,
                       packed.rb, packed.cb)
    tier = _pcg_tier(plan.K, plan.s, plan.c, dev, farm=True)
    if tier is not None:
        out = _sequence_core(blocks, lb, np.full(packed.T, options.rho), options,
                             "pcg_kernel" if tier == "longk" else "torch")
        return PackedSequenceResult(out.lam, out.dz_x, out.dz_u, out.iters,
                                    out.converged, out.eta, plan)
    rhos = torch.full((packed.T,), options.rho, dtype=torch.float32,
                      device=dev)
    res, dz_x, dz_u = fused_sequence.fused_sequence_cuda(
        *blocks, lb, rhos, **_kernel_kw(options))
    return PackedSequenceResult(res.lam, dz_x, dz_u, res.iters,
                                res.converged, res.eta, plan)

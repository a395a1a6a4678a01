"""Kernel B: the whole batched KKT solve as one hand-written CUDA kernel.

Replaces ``gato_tpu/kernels/fused_solve.py::_fused_kernel`` (entry points
``_call_fused`` and ``solve_fused_batched``): rho-condensation with the
zero-pivot flag, any of the three preconditioners, the PCG loop, and dz
recovery.  The CUDA source is ``gato_tpu_torch/csrc/fused_solve.cu``, with
the per-problem body in ``cluster_body.cuh`` (shared with the farm kernel,
fused_sequence.py); their notes give the design: one thread-block cluster
of C CTAs a problem, CTA r owning a contiguous range of knots (its
operators in its shared memory where they fit, else in a global scratch
slice that this wrapper allocates), halos and dot products through
distributed shared memory.

The plan of a launch is pure Python here, mirrored by the library's
``gato_cluster_*`` functions: :func:`knot_range`, :func:`cta_threads`,
:func:`cta_smem_bytes`, :func:`ops_in_smem`, :func:`cluster_fits` and the
rule :func:`cluster_size`.  :func:`fused_solve_cuda` takes tensors on a
CUDA device to the kernel and raises if the kernel cannot take them
(``cluster=`` forces C, for tests and measurements), in two steps that
``solver.solve_batched``'s kept plans share: :func:`plan`, the launch of a
shape, and :func:`run`, its outputs and the launch.  Tensors on the CPU go
to the plain version, :func:`fused_solve_plain`: ``condense(flag=True)``
-> ``pcg`` with flagged problems frozen -> ``recover_dz``.  ``LAUNCHES``
counts the kernel's launches, ``LAST_CLUSTER`` holds the C of the last,
and ``SCRATCH_FLOATS`` sums the floats of the global record slices they
allocated (0 for a launch whose records sit in shared memory).

Widths: any s, c <= ``_build.MAX_BLOCK`` (32), the generic body or one
compiled in, and above that only the pairs of :data:`COMPILED_WIDTHS`
(36, 12: a quadruped's whole-body MPC); :func:`takes_widths`.  The farm
kernel (fused_sequence.py), kernel A, row 4 and the long-K tiers take
s, c <= 32 alone; the routing sends every other width to the plain path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..assemble import condense
from ..pcg import PCGResult, pcg
from ..problem import Preconditioner
from ..recover import recover_dz
from . import _build

NAME = "fused_solve_cuda"
SOURCE = "gato_tpu_torch/csrc/fused_solve.cu"
REPLACES = "gato_tpu/kernels/fused_solve.py:568"
# The kernel's preconditioner codes (enum Precond in cluster_body.cuh).
PRECOND_CODES = {"jacobi": 0, "block_jacobi": 1, "symmetric_stair": 2}
# The cluster sizes the kernels take (16 is a non-portable size on Hopper).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# cluster_body.cuh's fixed area and its eight vectors with halo rows.
_FIXED_FLOATS = 96
_NUM_VEC = 8

# The width pairs compiled into the kernel (csrc/fused_solve.cu's
# fused_kernel_for; the library's gato_fused_compiled answers for it):
# IIWA, the pendulum and a quadruped's whole body.  Any other s, c <=
# _build.MAX_BLOCK runs the generic body; no other width runs.
COMPILED_WIDTHS = ((14, 7), (2, 1), (36, 12))

LAUNCHES = 0
LAST_CLUSTER = None
SCRATCH_FLOATS = 0


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


# ---- The horizons kernel B serves (the routing's domain) ----

def smem_bytes(K: int, s: int, cdim: int) -> int:
    """The shared memory one block of the one-CTA-a-problem kernel B needed:
    a Gauss-Jordan work area of at most 64 KB and, reusing it, six PCG
    vectors.  It no longer sizes a launch (:func:`cta_smem_bytes` does); it
    fixes the horizons that kernel B and the farm kernel serve, so that the
    routing to the long-K tier (IIWA K >= 689 on an H100) stays where it
    was."""
    def gj(n):
        return 2 * n * n + 3 * n + 2
    floats = max(6 * max(K * s, (K - 1) * cdim), gj(s), gj(cdim),
                 min(K * gj(s), 16384))
    return 4 * floats


def instance(s: int, cdim: int) -> str:
    """The body a launch of kernel B at (s, c) selects: ``'14x7'``,
    ``'2x1'``, ``'36x12'``, or ``'generic'``."""
    return f"{s}x{cdim}" if (s, cdim) in COMPILED_WIDTHS else "generic"


def takes_widths(s: int, cdim: int, wide: tuple = COMPILED_WIDTHS) -> bool:
    """True iff a kernel has a body for (s, c): s, c <= MAX_BLOCK, or one of
    the ``wide`` pairs compiled into it.  Kernel B takes its
    :data:`COMPILED_WIDTHS`; every other kernel passes ``()``."""
    return max(s, cdim) <= _build.MAX_BLOCK or (s, cdim) in wide


def fits(K: int, s: int, cdim: int, smem_limit: int,
         wide: tuple = COMPILED_WIDTHS) -> bool:
    """True iff kernel B (with ``wide=()``, the farm kernel:
    ``fused_sequence.fits``) serves (K, s, c) on a device whose blocks may
    opt in to ``smem_limit`` bytes of shared memory: widths it has a body
    for (:func:`takes_widths`) at a horizon within :func:`smem_bytes`.
    Every such shape has a cluster size whose plan fits
    (:func:`cluster_fits`)."""
    return (K >= 2 and takes_widths(s, cdim, wide)
            and smem_bytes(K, s, cdim) <= smem_limit - _build.RESERVED_SHARED_BYTES)


def width_message(name: str, K: int, s: int, cdim: int, wide: tuple = ()) -> str:
    """Why a kernel with the ``wide`` pairs does not take (K, s, c): (s, c)
    is neither within MAX_BLOCK nor one of those pairs, or is one at a
    horizon past its shared memory."""
    wide = [p for p in wide if max(p) > _build.MAX_BLOCK]
    if (s, cdim) in wide:
        why = f"the kernel takes (s, c) = ({s}, {cdim}) only within its shared memory"
    else:
        why = f"the kernel takes s, c <= {_build.MAX_BLOCK}" + (
            f", or (s, c) in {wide}" if wide else "")
    return (f"{name}: (K, s, c) = ({K}, {s}, {cdim}): {why}; pass pcg_backend "
            "None (auto) or 'torch', which solve any widths")


def past_limit_message(name: str, K: int, s: int, cdim: int, smem: int,
                       limit: int) -> str:
    return (f"{name}: (K, s, c) = ({K}, {s}, {cdim}) needs {smem} B of shared "
            f"memory per block, above the device's {limit} B; this horizon is "
            "served by the long-K tier (kernels/longk.py): pass pcg_backend "
            "None (auto) or 'pcg_kernel'")


# ---- The plan of one launch (mirrors of cluster_body.cuh) ----

def knot_range(K: int, C: int, r: int) -> tuple:
    """Knots [k0, k1) of CTA r in a cluster of C: contiguous, balanced to
    within one knot (cluster_body.cuh's knot_begin)."""
    return r * K // C, (r + 1) * K // C


def cluster_knots(K: int, C: int) -> int:
    """The most knots one CTA holds."""
    return -(-K // C)


def record_floats(s: int, cdim: int) -> int:
    """One knot's record: S, Pinv (three blocks each), Qinv, Rinv_{k-1}
    and B_{k-1} Rinv_{k-1}."""
    return 7 * s * s + cdim * cdim + s * cdim


def cta_threads(K: int, s: int, cdim: int, C: int) -> int:
    """Threads of one CTA: a row of its Gauss-Jordan batch each (its knots,
    and the halo knot when C > 1), whole warps, from 64 to 384."""
    t = -(-(cluster_knots(K, C) + (C > 1)) * max(s, cdim) // 32) * 32
    return min(max(t, 64), 384)


def cta_smem_bytes(K: int, s: int, cdim: int, C: int, in_smem: bool) -> int:
    """Dynamic shared memory of one CTA: the fixed reduction area, the
    knots' records when ``in_smem``, lambda's rows, the halo rows of eight
    vectors and three halo blocks, and the larger of the Gauss-Jordan pivot
    rows and seven vectors with the recovery's dz_u temporary."""
    kn, nt = cluster_knots(K, C), cta_threads(K, s, cdim, C)

    def gj(count, n):
        chunk = min(nt // n, count)
        return 2 * chunk * n * n + 2 * chunk * n + chunk

    union = max(gj(kn + 1, s), gj(kn, cdim), 7 * kn * s + kn * cdim)
    floats = (_FIXED_FLOATS + (kn * record_floats(s, cdim) if in_smem else 0)
              + kn * s + 2 * _NUM_VEC * s + 3 * s * s + union)
    return 4 * floats


def ops_in_smem(K: int, s: int, cdim: int, C: int, smem_limit: int) -> bool:
    """True iff the records of a CTA fit its shared memory at this C."""
    return cta_smem_bytes(K, s, cdim, C, True) <= smem_limit - _build.RESERVED_SHARED_BYTES


def cluster_fits(K: int, s: int, cdim: int, C: int, smem_limit: int) -> bool:
    """True iff a cluster of C CTAs takes (K, s, c): at least a knot each,
    and the plan without the records fits shared memory."""
    return (C <= K and cta_smem_bytes(K, s, cdim, C, False)
            <= smem_limit - _build.RESERVED_SHARED_BYTES)


def cluster_size(B: int, K: int, s: int, cdim: int, n_sms: int,
                 smem_limit: int) -> int:
    """The cluster size kernel B takes for B problems (and the farm kernel
    for B streams, so that a farm and B chained kernel-B launches compute
    the same bits): the largest C that fits with B C <= n_sms, but never
    below the floor, the smallest C whose records fit shared memory (else
    the smallest C that fits).  Non-increasing in B.

    Why: one problem is a chain of dependent stages (three Gauss-Jordan
    batches of s pivot steps, then ~27 PCG iterations of two matvecs and
    two cluster-wide reductions), so at small B its time is latency, and
    spreading its knots over C SMs cuts each stage's work by C while a
    cluster barrier costs well under a microsecond.  Once B C CTAs would
    pass the card's SMs, more CTAs only queue.  The floor: where the
    records (S, Pinv, ... ; 304 KB a problem at IIWA) stay in global
    memory, every PCG matvec streams them from L2, since an SM's L1 beside
    its shared memory holds less; on the chip that costs more than the
    extra waves of a cluster size whose records sit in shared memory (at
    IIWA, B = 256: C = 2 against C = 1, PERF.md §6).  Every C the rule can
    pick is co-resident on an H100 (the wrapper checks it with
    cudaOccupancyMaxActiveClusters and raises otherwise).  The chip's
    numbers for each C at B = 1, 4, 16, 64 and 256 are in PERF.md §6
    (chip_smoke.py phase 5)."""
    fitting = [C for C in CLUSTER_SIZES if cluster_fits(K, s, cdim, C, smem_limit)]
    if not fitting:
        raise ValueError(f"no cluster size takes (K, s, c) = ({K}, {s}, {cdim}) "
                         f"under {smem_limit} B of shared memory")
    return rule(B, n_sms, fitting, lambda C: ops_in_smem(K, s, cdim, C, smem_limit))


def rule(B: int, n_sms: int, fitting: list, in_smem) -> int:
    """:func:`cluster_size`'s rule over the cluster sizes that fit
    (``fitting``, ascending) and whether a size holds its records in shared
    memory (``in_smem(C)``); kernel A and row 4 take it with their own
    plans (kernels/pcg_kernel.py, kernels/direct_fused.py)."""
    floor = next((C for C in fitting if in_smem(C)), fitting[0])
    pick = max((C for C in fitting if B * C <= n_sms), default=0)
    return max(pick, floor)


def require_resident(name: str, occupancy: str, index: int, args: tuple, C: int,
                     smem: int, shape: str) -> None:
    """Raise unless the card holds one cluster of C CTAs of a kernel
    (``occupancy``, the library's cudaOccupancyMaxActiveClusters query,
    called with ``args``) on CUDA device ``index``."""
    with torch.cuda.device(index):
        held = _build.function(occupancy)(*args)
    if held < 0:
        _build.check_launch(-held, name)
    if held == 0:
        raise RuntimeError(f"{name}: the card holds no cluster of {C} CTAs of "
                           f"{smem} B at {shape}")


@functools.cache
def device_limits(index: int) -> tuple:
    """(SMs, opt-in shared bytes a block) of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, _build.max_shared_bytes(index)


def launch_plan(name: str, B: int, K: int, s: int, cdim: int, poly_degree,
                device: torch.device, cluster=None, *,
                occupancy: str = "gato_fused_max_clusters",
                wide: tuple = COMPILED_WIDTHS) -> tuple:
    """(C, ops_in_smem) of a launch of B problems (or streams) at (K, s, c)
    on ``device``; raises ValueError for a shape, poly degree or forced
    ``cluster`` the kernel does not take, and RuntimeError when the card
    cannot hold one such cluster (``occupancy`` names the library's
    cudaOccupancyMaxActiveClusters query for the kernel).  The kernel takes
    s, c <= MAX_BLOCK and the ``wide`` pairs (the farm kernel: none)."""
    if not isinstance(poly_degree, int) or poly_degree < 1:
        raise ValueError(f"{name}: poly_degree must be an int >= 1")
    return _plan(name, B, K, s, cdim, device.index, cluster, occupancy, wide)


@functools.cache
def _plan(name: str, B: int, K: int, s: int, cdim: int, index: int, cluster,
          occupancy: str, wide: tuple) -> tuple:
    if K < 2:
        raise ValueError(f"{name}: needs K >= 2; got K={K}")
    if not takes_widths(s, cdim, wide):
        raise ValueError(width_message(name, K, s, cdim, wide))
    n_sms, limit = device_limits(index)
    if not fits(K, s, cdim, limit):
        raise ValueError(past_limit_message(
            name, K, s, cdim, smem_bytes(K, s, cdim), limit - _build.RESERVED_SHARED_BYTES))
    if cluster is None:
        C = cluster_size(B, K, s, cdim, n_sms, limit)
    elif cluster not in CLUSTER_SIZES or not cluster_fits(K, s, cdim, cluster, limit):
        raise ValueError(f"{name}: cluster={cluster!r} does not take (K, s, c) = "
                         f"({K}, {s}, {cdim}); it must be one of {CLUSTER_SIZES}, "
                         f"at most K, with a plan that fits {limit} B")
    else:
        C = cluster
    in_smem = ops_in_smem(K, s, cdim, C, limit)
    require_resident(name, occupancy, index, (K, s, cdim, C, int(in_smem)), C,
                     cta_smem_bytes(K, s, cdim, C, in_smem), f"(K, s, c) = ({K}, {s}, {cdim})")
    return C, in_smem


def outputs(lead: tuple, K: int, s: int, cdim: int, device) -> tuple:
    """The kernels' outputs: lam, dz_x (*lead, K, s), dz_u (*lead, K-1, c),
    eta (*lead) float32, iters (*lead) int32 and converged (*lead) bool."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)
    return (empty(*lead, K, s), empty(*lead, K, s), empty(*lead, K - 1, cdim),
            empty(*lead), empty(*lead, dtype=torch.int32), empty(*lead, dtype=torch.bool))


class Launch(NamedTuple):
    """A planned launch of kernel B or row 4 (kernels/direct_fused.py): the
    device, the shape (B, K, s, c), the plan (C, ops_in_smem), the
    launcher's arguments after its pointers and, for kernel B, the body it
    selects (:func:`instance`; None for row 4)."""
    device: torch.device
    shape: tuple
    cluster: int
    in_smem: bool
    args: tuple
    instance: Optional[str] = None


def plan(Bn: int, K: int, s: int, cdim: int, device: torch.device, *,
         rho: float, exit_tol: float, max_iters: int, poly_degree: int,
         preconditioner: str, cluster=None) -> Launch:
    """The launch of B problems at (K, s, c) on CUDA ``device``
    (:func:`launch_plan`, which raises where the kernel cannot take it)."""
    C, in_smem = launch_plan(NAME, Bn, K, s, cdim, poly_degree, device, cluster)
    return Launch(device, (Bn, K, s, cdim), C, in_smem,
                  (Bn, K, s, cdim, float(rho), float(exit_tol), int(max_iters),
                   poly_degree, PRECOND_CODES[preconditioner], C, int(in_smem)),
                  instance(s, cdim))


def run(launch: Launch, Q, R, A, B, q, r, c, lam0):
    """Launch a :func:`plan` on tensors that have its shapes and are float32,
    contiguous and on its device.  The kernel only reads ``lam0``.  Returns
    (PCGResult, dz_x, dz_u), each a fresh tensor."""
    global LAUNCHES, LAST_CLUSTER, SCRATCH_FLOATS
    dev = launch.device
    Bn, K, s, cdim = launch.shape
    floats = 0 if launch.in_smem else Bn * K * record_floats(s, cdim)
    scratch = None if launch.in_smem else torch.empty(
        floats, dtype=torch.float32, device=dev)
    lam, dz_x, dz_u, eta, iters, conv = outputs((Bn,), K, s, cdim, dev)
    if Bn > 0:
        _build.launch(NAME, "gato_fused_solve", dev,
                      *(t.data_ptr() for t in (Q, R, A, B, q, r, c, lam0)),
                      None if scratch is None else scratch.data_ptr(),
                      lam.data_ptr(), dz_x.data_ptr(), dz_u.data_ptr(),
                      iters.data_ptr(), conv.data_ptr(), eta.data_ptr(), *launch.args)
        LAUNCHES += 1
        LAST_CLUSTER = launch.cluster
        SCRATCH_FLOATS += floats
    res = PCGResult(lam=lam, iters=iters, converged=conv, eta=eta)
    return res, dz_x, dz_u


def fused_solve_cuda(
    Q, R, A, B, q, r, c, lam0=None, *,
    rho: float = 0.0, exit_tol: float = 1e-6, max_iters: int = 100,
    poly_degree: int = 1, preconditioner: str = "symmetric_stair",
    cluster=None,
):
    """Whole batched solve (condense + PCG + recover).

    Arguments follow ``formats.KKTBlocks`` with one leading batch axis.
    Returns (PCGResult with a batch axis, dz_x (B, K, s), dz_u (B, K-1, c)).
    A problem whose condensation met a zero pivot in a live Q or R block
    reports iters = max_iters, converged False and eta = 1e30.  On CUDA
    tensors ``cluster`` forces the cluster size (one of 1, 2, 4, 8, 16; a
    size the shape or the card does not take raises); None takes
    :func:`cluster_size`."""
    if preconditioner not in PRECOND_CODES:
        raise ValueError(f"unknown preconditioner {preconditioner!r}; valid: "
                         f"{sorted(PRECOND_CODES)}")
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    dev = q.device
    if dev.type == "cpu":
        return fused_solve_plain(Q, R, A, B, q, r, c, lam0, rho=rho,
                                 exit_tol=exit_tol, max_iters=max_iters,
                                 poly_degree=poly_degree,
                                 preconditioner=preconditioner)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {dev} are neither CPU nor CUDA")
    if Q.ndim != 4:
        raise ValueError(f"{NAME}: Q must be (B, K, s, s), got {tuple(Q.shape)}")
    Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = dict(block_shapes((Bn,), K, s, cdim), lam0=(Bn, K, s))
    tensors = [_build.checked(NAME, key, t, torch.Size(expect[key]), dev)
               for key, t in zip(expect, (Q, R, A, B, q, r, c, lam0))]
    launch = plan(Bn, K, s, cdim, dev, rho=rho, exit_tol=exit_tol, max_iters=max_iters,
                  poly_degree=poly_degree, preconditioner=preconditioner,
                  cluster=cluster)
    return run(launch, *tensors)

"""Row 4: the whole batched exact solve as one hand-written CUDA kernel.

Replaces ``gato_tpu/kernels/direct_fused.py::_direct_kernel`` (entry points
``_call_direct`` and ``solve_direct_fused_batched``): rho-condensation with
the zero-pivot flag, block cyclic reduction of S lambda = gamma, dz
recovery, the squared true residual eta = ||gamma - S lambda||^2 against the
original S, iters = 0 and converged = direct.residual_converged(eta,
||gamma||^2).  The CUDA source is ``gato_tpu_torch/csrc/direct_fused.cu``;
its note gives the design: one thread-block cluster of C CTAs a problem on
kernel B's layout (``cluster_body.cuh``: its condensation and recovery
stages), each CTA's records (S and the copy W the reduction overwrites) in
its shared memory where they fit, else in a global scratch slice that this
wrapper allocates; a warp inverts each odd row, one cluster barrier a
level.

A problem in which a used inversion clamped a zero pivot (singular input)
gets eta = 1e30 (finite), so it reports converged False; its lambda and dz
stay finite.  (Rows 5 and 6, kernels/thomas_batch.py, report such a
problem non-finite instead: each kernel keeps its TPU kernel's contract.)

The plan of a launch is pure Python here, mirrored by the library's
``gato_direct_cluster_smem_bytes``: :func:`cta_smem_bytes`,
:func:`ops_in_smem`, :func:`cluster_fits` and :func:`cluster_size`, kernel
B's rule (``fused_solve.rule``) on row 4's plan.  :func:`smem_bytes` and
:func:`fits` keep the horizons row 4 serves (the routing reads them).

:func:`direct_fused_cuda` takes tensors on a CUDA device to the kernel and
raises if the kernel cannot take them (``cluster=`` forces C), in kernel
B's two steps (:func:`plan`, :func:`run`); tensors on the CPU go to the
plain version, :func:`direct_fused_plain`:
``condense(flag=True)`` -> ``direct.btd_solve_cr(flag=True)`` ->
``recover_dz``, with the residual and the 1e30 poison.  ``LAUNCHES`` counts
the kernel's launches, ``LAST_CLUSTER`` holds the C of the last.
"""

from __future__ import annotations

import functools

import torch

from ..assemble import condense
from ..direct import btd_solve_cr, residual_converged, residual_norms
from ..pcg import PCGResult
from ..recover import recover_dz
from . import _build
from . import fused_solve as kb

NAME = "direct_fused_cuda"
SOURCE = "gato_tpu_torch/csrc/direct_fused.cu"
REPLACES = "gato_tpu/kernels/direct_fused.py:350"
# eta of a problem whose used inversions clamped a zero pivot.
POISON_ETA = 1e30
# Even rows whose A and B a level of the kernel keeps at a time (kCrChunk).
CR_CHUNK = 8

LAUNCHES = 0
LAST_CLUSTER = None


def smem_bytes(K: int, s: int, cdim: int) -> int:
    """The shared memory one block of the one-CTA-a-problem row 4 needed
    (``gato_direct_smem_bytes``): a Gauss-Jordan work area of at most
    64 KB and four vectors.  It no longer sizes a launch
    (:func:`cta_smem_bytes` does); it fixes the horizons row 4 serves
    (:func:`fits`), so that the routing stays where it was."""
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


# ---- The plan of one launch (mirrors of direct_fused.cu) ----

def cta_smem_bytes(K: int, s: int, cdim: int, C: int, in_smem: bool) -> int:
    """Dynamic shared memory of one CTA: kernel B's plan
    (``fused_solve.cta_smem_bytes``; the same records, W in Pinv's slot)
    with a union area that also holds gamma, b, the back-substitution's
    temporary, the copies of two odd rows (L, D^{-1}, U and b each) and
    A and B of up to ``CR_CHUNK`` even rows."""
    kn, nt = kb.cluster_knots(K, C), kb.cta_threads(K, s, cdim, C)

    def gj(count, n):
        chunk = min(nt // n, count)
        return 2 * chunk * n * n + 2 * chunk * n + chunk

    union = max(gj(kn + 1, s), gj(kn, cdim), 7 * kn * s + kn * cdim,
                3 * kn * s + 2 * (3 * s * s + s) + min((kn + 1) // 2, CR_CHUNK) * 2 * s * s)
    floats = (kb._FIXED_FLOATS + (kn * kb.record_floats(s, cdim) if in_smem else 0)
              + kn * s + 2 * kb._NUM_VEC * s + 3 * s * s + union)
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
    """The cluster size row 4 takes for B problems: kernel B's rule
    (``fused_solve.cluster_size``, whose note gives the reasons) on row 4's
    plan: the largest C that fits with B C <= n_sms, never below the
    smallest C whose records fit shared memory.  At IIWA K = 50: C = 16 at
    B = 1, 8 at B = 15, the floor C = 2 from B = 34; at K = 740 no C holds
    the records (the global slice), C = 16 at B = 1."""
    fitting = [C for C in kb.CLUSTER_SIZES if cluster_fits(K, s, cdim, C, smem_limit)]
    if not fitting:
        raise ValueError(f"no cluster size takes (K, s, c) = ({K}, {s}, {cdim}) "
                         f"under {smem_limit} B of shared memory")
    return kb.rule(B, n_sms, fitting, lambda C: ops_in_smem(K, s, cdim, C, smem_limit))


@functools.cache
def launch_plan(B: int, K: int, s: int, cdim: int, index: int, cluster=None) -> tuple:
    """(C, ops_in_smem) of a launch of B problems at (K, s, c) on CUDA
    device ``index``; raises ValueError for a shape or forced ``cluster``
    the kernel does not take, and RuntimeError when the card cannot hold
    one such cluster."""
    if K < 2 or s > _build.MAX_BLOCK or cdim > _build.MAX_BLOCK:
        raise ValueError(f"{NAME}: needs K >= 2 and s, c <= {_build.MAX_BLOCK}; got "
                         f"K={K}, s={s}, c={cdim}")
    n_sms, limit = kb.device_limits(index)
    if not fits(K, s, cdim, limit):
        raise ValueError(past_limit_message(NAME, K, s, cdim, smem_bytes(K, s, cdim),
                                            limit - _build.RESERVED_SHARED_BYTES))
    if cluster is None:
        C = cluster_size(B, K, s, cdim, n_sms, limit)
    elif cluster not in kb.CLUSTER_SIZES or not cluster_fits(K, s, cdim, cluster, limit):
        raise ValueError(f"{NAME}: cluster={cluster!r} does not take (K, s, c) = "
                         f"({K}, {s}, {cdim}); it must be one of {kb.CLUSTER_SIZES}, "
                         f"at most K, with a plan that fits {limit} B")
    else:
        C = cluster
    in_smem = ops_in_smem(K, s, cdim, C, limit)
    kb.require_resident(NAME, "gato_direct_max_clusters", index,
                        (K, s, cdim, C, int(in_smem)), C,
                        cta_smem_bytes(K, s, cdim, C, in_smem),
                        f"(K, s, c) = ({K}, {s}, {cdim})")
    return C, in_smem


def plan(Bn: int, K: int, s: int, cdim: int, device: torch.device, *,
         rho: float, cluster=None) -> kb.Launch:
    """The launch of B problems at (K, s, c) on CUDA ``device``
    (:func:`launch_plan`); raises where the kernel cannot take it, or where
    the records' global slice would not fit the device's memory."""
    C, in_smem = launch_plan(Bn, K, s, cdim, device.index, cluster)
    if not in_smem:
        floats = Bn * K * kb.record_floats(s, cdim)
        total = torch.cuda.get_device_properties(device).total_memory
        if floats * 4 > total:
            raise ValueError(f"{NAME}: {Bn} problems need {floats * 4} B of scratch, "
                             f"above the device's {total} B; split the batch")
    return kb.Launch(device, (Bn, K, s, cdim), C, in_smem,
                     (Bn, K, s, cdim, float(rho), C, int(in_smem)))


def run(launch: kb.Launch, Q, R, A, B, q, r, c):
    """Launch a :func:`plan` on tensors that have its shapes and are float32,
    contiguous and on its device.  Returns (PCGResult, dz_x, dz_u), each a
    fresh tensor."""
    global LAUNCHES, LAST_CLUSTER
    dev = launch.device
    Bn, K, s, cdim = launch.shape
    scratch = None if launch.in_smem else torch.empty(
        Bn * K * kb.record_floats(s, cdim), dtype=torch.float32, device=dev)
    lam = torch.empty_like(q)
    dz_x = torch.empty_like(q)
    dz_u = torch.empty_like(r)
    conv = torch.empty(Bn, dtype=torch.int32, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        _build.launch(NAME, "gato_direct_fused", dev,
                      *(t.data_ptr() for t in (Q, R, A, B, q, r, c)),
                      None if scratch is None else scratch.data_ptr(),
                      *(t.data_ptr() for t in (lam, dz_x, dz_u, conv, eta)),
                      *launch.args)
        LAUNCHES += 1
        LAST_CLUSTER = launch.cluster
    res = PCGResult(lam=lam, iters=torch.zeros(Bn, dtype=torch.int32, device=dev),
                    converged=conv != 0, eta=eta)
    return res, dz_x, dz_u


def direct_fused_cuda(Q, R, A, B, q, r, c, *, rho: float = 0.0, cluster=None):
    """Whole batched exact solve (condense + cyclic reduction + recover).

    Arguments follow ``formats.KKTBlocks`` with one leading batch axis.
    Returns (PCGResult with a batch axis: iters = 0, eta the squared true
    residual, converged derived from it; dz_x (B, K, s), dz_u (B, K-1, c)).
    On CUDA tensors ``cluster`` forces the cluster size (one of 1, 2, 4, 8,
    16; a size the shape or the card does not take raises); None takes
    :func:`cluster_size`."""
    dev = q.device
    if dev.type == "cpu":
        return direct_fused_plain(Q, R, A, B, q, r, c, rho=rho)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {dev} are neither CPU nor CUDA")
    if Q.ndim != 4:
        raise ValueError(f"{NAME}: Q must be (B, K, s, s), got {tuple(Q.shape)}")
    Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = kb.block_shapes((Bn,), K, s, cdim)
    tensors = [_build.checked(NAME, key, t, torch.Size(expect[key]), dev)
               for key, t in zip(expect, (Q, R, A, B, q, r, c))]
    return run(plan(Bn, K, s, cdim, dev, rho=rho, cluster=cluster), *tensors)

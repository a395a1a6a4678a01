"""Rows 16, 17 and 18: the measurement probes as hand-written CUDA kernels.

Latency floors of the primitives the solver's kernels are built from, each
beside its plain PyTorch version (the CUDA source and its note:
``gato_tpu_torch/csrc/probes.cu``; the tools that time them:
``gato_tpu_torch/tools/probe_*.py``):

* row 18, :func:`null_copy_cuda` (``bench.py``'s ``null_kernel``, the
  dispatch floor): ``out = q * 1.0000001`` on B problems' rhs, one float4
  a thread, through the short call path of ``_build`` that row 15 takes;
* row 16, :func:`null_chain_cuda` (``tools/probe_iter_floor.py``'s null
  kernel): trips of n_mv block-tridiagonal matvec contractions, n_dot
  reduce -> broadcast -> axpy steps and three freeze selects, on the
  schedule of the kernel each scope bounds: 'block' on kernel B's cluster
  (:func:`chain_cluster_plan`: C CTAs a problem, halo rows pushed into the
  neighbours' shared memory, a cluster_sum a reduction) and 'grid' on
  rows 8/10's cooperative rounds (:func:`chain_grid_rounds`: per CTAs a
  problem, boundary rows published and pulled, grid_common.cuh's
  meetings), meeting only where the chain's dependences require it
  (:func:`trip_meetings`);
* row 17, :func:`fma_chain_cuda` (``tools/probe_throughput.py``'s probe D
  kernel): trips x depth dependent block-diagonal matvecs, s dependent
  FMAs an output row, at IIWA's s = 14 only, one CTA a problem, each
  knot's y in registers at each of its lanes (:func:`fma_plan`: 16 lanes
  a knot and an exchange through shared memory up to FMA_WARP_KNOTS
  knots, else two lanes a knot, seven rows each, and shuffles).

:func:`chain_operator` and :func:`fma_operator` make the chains' inputs
for the checks and the floors: each knot's own step is a scaled orthogonal
block, so every knot's y keeps its size over any number of trips (the TPU
probes' M of all ones contracts y to exactly 0 within a few hundred trips).

The ``*_cuda`` wrappers take CUDA tensors to their kernel through
``_build.checked`` / ``_build.launch`` and raise where it cannot take
them; CPU tensors go to the plain versions.  The ``*_LAUNCHES`` counters
count kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build, longk
from . import fused_solve as kb

SOURCE = "gato_tpu_torch/csrc/probes.cu"
COPY_NAME = "null_copy_cuda"
CHAIN_BLOCK_NAME = "null_chain_block_cuda"
CHAIN_GRID_NAME = "null_chain_grid_cuda"
FMA_NAME = "fma_chain_cuda"
COPY_REPLACES = "bench.py:899"
CHAIN_REPLACES = "tools/probe_iter_floor.py:105"
FMA_REPLACES = "tools/probe_throughput.py:222"
SCOPES = ("block", "grid")
# Row 17's one width, IIWA's state size (its rows of 0.01 M live in
# registers, so the kernel is compiled for it).
FMA_WIDTH = 14
COPY_FACTOR = 1.0000001
# A matvec step of either chain is y <- 0.5 y + 0.25 (0.01 M) y: M's
# diagonal block 400 (c Q - 0.5 I) makes a knot's own step c Q.
_STEP_SCALE = 0.25 * 0.01
# Row 16's inputs: a knot's own step CHAIN_CONTRACTION Q (Q orthogonal),
# the trip's dot steps (y grows by 1 + 0.125 / (1 + |y|^2)) holding |y| at a
# fixed point; entries of the off-diagonal blocks CHAIN_COUPLING, so that
# |0.0025 (L + U)| ~ 0.004, small beside the diagonal.
CHAIN_CONTRACTION = 0.99
CHAIN_COUPLING = 0.1

COPY_LAUNCHES = 0
CHAIN_BLOCK_LAUNCHES = 0
CHAIN_GRID_LAUNCHES = 0
FMA_LAUNCHES = 0


def _orthogonal_steps(rng, shape: tuple, s: int, contraction: float) -> np.ndarray:
    """M blocks (*shape, s, s) whose step 0.5 I + 0.0025 M is contraction
    times a random orthogonal matrix."""
    Q = np.linalg.qr(rng.normal(size=(*shape, s, s)))[0]
    return (contraction * Q - 0.5 * np.eye(s)) / _STEP_SCALE


def chain_operator(B: int, K: int, s: int, *, seed: int, device="cpu",
                   dtype=torch.float32) -> tuple:
    """Row 16's inputs M (B, K, 3, s, s) and y0 (B, K, s), from ``seed``:
    each knot's own matvec step CHAIN_CONTRACTION times a random
    orthogonal block, its neighbours coupled by N(0, CHAIN_COUPLING^2)
    blocks (the slots past either end hold values the matvec must
    ignore), y0 N(0, 1).  Every knot's y stays within a few times every
    other's over a hundred trips, and |y| stays at the dot steps' fixed
    point (2.4 to 5 at IIWA, K = 50) for any number of trips."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, K, 3, s, s)) * CHAIN_COUPLING
    M[:, :, 1] = _orthogonal_steps(rng, (B, K), s, CHAIN_CONTRACTION)
    y0 = rng.normal(size=(B, K, s))
    return (torch.tensor(M, dtype=dtype, device=device),
            torch.tensor(y0, dtype=dtype, device=device))


def fma_operator(B: int, K: int, *, seed: int, device="cpu",
                 dtype=torch.float32) -> tuple:
    """Row 17's inputs M (B, K, 14, 14) and y0 (B, K, 14), from ``seed``:
    each knot's matvec step a random orthogonal block, so every knot's y
    keeps its size over any number of matvecs; y0 N(0, 1)."""
    rng = np.random.default_rng(seed)
    M = _orthogonal_steps(rng, (B, K), FMA_WIDTH, 1.0)
    y0 = rng.normal(size=(B, K, FMA_WIDTH))
    return (torch.tensor(M, dtype=dtype, device=device),
            torch.tensor(y0, dtype=dtype, device=device))


def null_copy_plain(q: torch.Tensor) -> torch.Tensor:
    """Row 18's plain version: ``q * 1.0000001``."""
    return q * COPY_FACTOR


def null_chain_plain(M: torch.Tensor, y0: torch.Tensor, *, n_mv: int,
                     n_dot: int, trips: int) -> torch.Tensor:
    """Row 16's plain version on M (B, K, 3, s, s) and y0 (B, K, s)."""
    Mc = M * 0.01
    y = y0
    zero = torch.zeros_like(y[..., :1, :])
    for _ in range(trips):
        for _ in range(n_mv):
            halo = torch.stack([torch.cat([zero, y[..., :-1, :]], -2), y,
                                torch.cat([y[..., 1:, :], zero], -2)], -2)
            acc = torch.einsum("...kjab,...kjb->...ka", Mc, halo)
            y = acc * 0.25 + y * 0.5
        for _ in range(n_dot):
            sc = (y * y).sum(dim=(-2, -1), keepdim=True)
            a = torch.where(sc != 0, 1.0 / (1.0 + sc), torch.zeros_like(sc))
            y = y + a * (y * 0.125)
        live = y[..., :1, :1] > -1e30
        y = torch.where(live, y, y * 0.5)
        y = torch.where(live, y, y + 1.0)
        y = torch.where(live, y, y * 0.25)
    return y


def fma_chain_plain(M: torch.Tensor, y0: torch.Tensor, *, depth: int,
                    trips: int) -> torch.Tensor:
    """Row 17's plain version on M (B, K, 14, 14) and y0 (B, K, 14)."""
    Mc = M * 0.01
    y = y0
    for _ in range(trips * depth):
        acc = torch.einsum("...kab,...kb->...ka", Mc, y)
        y = acc * 0.25 + y * 0.5
    return y


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are neither CPU nor CUDA")


def _counts(name: str, **counts) -> None:
    for key, value in counts.items():
        if not isinstance(value, int) or value < 0:
            raise ValueError(f"{name}: {key} must be an int >= 0, got {value!r}")


def null_copy_cuda(q: torch.Tensor) -> torch.Tensor:
    """out = q * 1.0000001 on q (B, K, s): one float4 a thread.  The call
    takes row 15's short path (``_build.checked`` / ``_build.launch``), so
    its cost is what a kernel call of the port costs at least."""
    dev = q.device
    if dev.type == "cpu":
        return null_copy_plain(q)
    _check_device(COPY_NAME, q)
    if q.ndim != 3:
        raise ValueError(f"{COPY_NAME}: q must be (B, K, s), got {tuple(q.shape)}")
    Bn, K, s = q.shape
    q = _build.checked(COPY_NAME, "q", q, (Bn, K, s), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch(COPY_NAME, "gato_null_copy", dev, q.data_ptr(), out.data_ptr(),
                  Bn, K * s)
    global COPY_LAUNCHES
    COPY_LAUNCHES += 1
    return out


# Row 16's plans (csrc/probes.cu holds the layout and the threads; the card
# test compares chain_smem_bytes and chain_threads with the library's).

# cluster_body.cuh's bound on a cluster CTA's threads.
CHAIN_MAX_THREADS = 384
# cluster_body.cuh's fixed area of cluster_sum, in floats.
_CLUSTER_FIXED_FLOATS = 96


def _round4(floats: int) -> int:
    return (floats + 3) // 4 * 4


def chain_smem_bytes(kn: int, s: int, H: int, cluster: bool, resident: bool) -> int:
    """A chain CTA's dynamic shared memory for ``kn`` own knots (the most a
    CTA of the launch owns) and a halo of H knots each side: cluster_sum's
    area (cluster scope), two first-row slots, the halo rows by parity
    (4 H s), the windows y and z ((kn + 2 H) s each) and, where resident,
    0.01 M of kn + 2 (H - 1) knots."""
    floats = (_CLUSTER_FIXED_FLOATS if cluster else 0) + 4 + _round4(4 * H * s)
    floats += 2 * _round4((kn + 2 * H) * s)
    if resident:
        floats += _round4((kn + 2 * (H - 1)) * 3 * s * s)
    return 4 * floats


def chain_threads(kn: int, s: int, H: int) -> int:
    """Threads of a cluster-scope CTA: a row of its widest matvec (own
    knots and H - 1 more each side), whole warps, 64 to
    CHAIN_MAX_THREADS."""
    return min(max(-(-(kn + 2 * (H - 1)) * s // 32) * 32, 64), CHAIN_MAX_THREADS)


def chain_cdim(s: int) -> int:
    """The control size the cluster rule is asked with for state size s:
    half of it, as at IIWA (14, 7) and the pendulum (2, 1)."""
    return max(s // 2, 1)


def trip_meetings(n_mv: int, n_dot: int, H: int) -> int:
    """Meetings (cluster barriers, or grid meetings) a trip takes at halo
    depth H: one between matvec groups of H, one a dot step, and one
    after the matvecs where no dot step follows."""
    groups = -(-n_mv // H)
    if n_dot == 0:
        return groups
    return max(groups - 1, 0) + n_dot


def cta_barriers(n_mv: int, H: int) -> int:
    """__syncthreads a trip takes between the matvecs of one group (none at
    H = 1)."""
    return n_mv - -(-n_mv // H)


class ChainClusterPlan(NamedTuple):
    """Row 16 at cluster scope: C CTAs a problem (kernel B's knots of each
    rank), halo depth H, threads and dynamic shared bytes of a CTA."""

    C: int
    H: int
    threads: int
    smem: int


def chain_cluster_plan(B: int, K: int, s: int, n_mv: int, n_sms: int, optin: int,
                       cluster=None, halo=None) -> ChainClusterPlan:
    """Kernel B's cluster for B problems of K knots (fused_solve.
    cluster_size with the opt-in ``optin`` bytes, or ``cluster`` forced:
    one of CLUSTER_SIZES, at most K) and a halo of min(n_mv, K // C) knots
    (at least 1) unless ``halo`` forces one; raises ValueError where the
    plan does not fit."""
    if cluster is None:
        C = kb.cluster_size(B, K, s, chain_cdim(s), n_sms, optin)
    elif cluster in kb.CLUSTER_SIZES and cluster <= K:
        C = cluster
    else:
        raise ValueError(f"{CHAIN_BLOCK_NAME}: cluster={cluster!r} must be one of "
                         f"{kb.CLUSTER_SIZES} and at most K = {K}")
    H = max(min(n_mv, K // C), 1) if halo is None else halo
    if not isinstance(H, int) or not 1 <= H <= K // C:
        raise ValueError(f"{CHAIN_BLOCK_NAME}: halo={H!r} must be an int from 1 to "
                         f"the fewest own knots of a CTA, {K // C}")
    kn = -(-K // C)
    smem = chain_smem_bytes(kn, s, H, True, True)
    limit = optin - _build.RESERVED_SHARED_BYTES
    if smem > limit:
        raise ValueError(f"{CHAIN_BLOCK_NAME}: {kn} knots a CTA at C = {C} need {smem} B "
                         f"of shared memory, above the device's {limit} B")
    return ChainClusterPlan(C, H, chain_threads(kn, s, H), smem)


class ChainRound(NamedTuple):
    """One cooperative launch of row 16 at grid scope: a round of
    longk.pcg_rounds's plan (problems first .. first + nprob - 1, per CTAs
    each, meeting by ``meet``), 0.01 M in shared memory iff ``resident``,
    halo depth H, dynamic shared bytes of a CTA."""

    first: int
    nprob: int
    per: int
    resident: bool
    meet: str
    H: int
    smem: int


def chain_grid_rounds(B: int, K: int, s: int, n_mv: int, n_sms: int, limit: int,
                      halo=None) -> tuple:
    """Rows 8/10's rounds for B problems of K knots (``limit``: the shared
    bytes a block may use), each with the operator resident where the
    round holds S in shared memory and the chain's layout fits there, and
    a halo of min(n_mv, ceil(K / per)) knots (at least 1) unless ``halo``
    forces one; raises ValueError where a round's layout does not fit.

    Why that halo (at both scopes): the matvecs of a group then meet no
    other CTA, so a trip meets only at its dot steps, as the kernels'
    iterations do; a one-knot halo meets after every matvec but the last
    and, on an H100 (tools/probe_iter_floor.py --halo 1, PERF.md §6), ran
    each (2, 2) trip 0.6-1.6 us slower."""
    rounds = []
    for rd in longk.pcg_rounds(B, K, s, n_sms, limit):
        nk = -(-K // rd.per)
        H = max(min(n_mv, nk), 1) if halo is None else halo
        if not isinstance(H, int) or not 1 <= H <= nk:
            raise ValueError(f"{CHAIN_GRID_NAME}: halo={H!r} must be an int from 1 to a "
                             f"CTA's {nk} knots")
        lim = longk._share_limit(limit, -(-rd.nprob * rd.per // n_sms))
        resident = (bool(rd.flags & longk.S_RESIDENT)
                    and chain_smem_bytes(nk, s, H, False, True) <= lim)
        smem = chain_smem_bytes(nk, s, H, False, resident)
        if smem > lim:
            raise ValueError(f"{CHAIN_GRID_NAME}: {nk} knots a CTA need {smem} B of "
                             f"shared memory, above the {lim} B a CTA may plan with")
        rounds.append(ChainRound(rd.first, rd.nprob, rd.per, resident, rd.meet, H, smem))
    return tuple(rounds)


def null_chain_cuda(M: torch.Tensor, y0: torch.Tensor, *, n_mv: int, n_dot: int,
                    trips: int, scope: str = "block", cluster=None,
                    _halo=None) -> torch.Tensor:
    """Row 16 on M (B, K, 3, s, s) and y0 (B, K, s) at ``scope`` 'block'
    (kernel B's cluster of C CTAs a problem; ``cluster`` forces C) or
    'grid' (rows 8/10's cooperative rounds, a launch a round); returns y
    after ``trips`` trips.  ``_halo`` forces the halo depth (the sweeps of
    chip_smoke.py and tools/probe_iter_floor.py)."""
    if scope not in SCOPES:
        raise ValueError(f"unknown scope {scope!r}; valid: {SCOPES}")
    name = CHAIN_BLOCK_NAME if scope == "block" else CHAIN_GRID_NAME
    _counts(name, n_mv=n_mv, n_dot=n_dot, trips=trips)
    if y0.device.type == "cpu":
        return null_chain_plain(M, y0, n_mv=n_mv, n_dot=n_dot, trips=trips)
    _check_device(name, y0)
    if y0.ndim != 3:
        raise ValueError(f"{name}: y0 must be (B, K, s), got {tuple(y0.shape)}")
    Bn, K, s = y0.shape
    dev = y0.device
    M = _build.checked(name, "M", M, (Bn, K, 3, s, s), dev)
    y0 = _build.checked(name, "y0", y0, (Bn, K, s), dev)
    if s > _build.MAX_BLOCK:
        raise ValueError(f"{name}: state size {s} > {_build.MAX_BLOCK}")
    out = torch.empty_like(y0)
    if Bn == 0 or K == 0:
        return out
    n_sms, optin = kb.device_limits(dev.index)
    global CHAIN_BLOCK_LAUNCHES, CHAIN_GRID_LAUNCHES
    if scope == "block":
        plan = chain_cluster_plan(Bn, K, s, n_mv, n_sms, optin, cluster, _halo)
        _build.launch(f"{name} ({Bn} clusters of {plan.C})", "gato_null_chain_cluster", dev,
                      M.data_ptr(), y0.data_ptr(), out.data_ptr(), Bn, K, s, n_mv, n_dot,
                      trips, plan.C, plan.H, plan.threads)
        CHAIN_BLOCK_LAUNCHES += 1
        return out
    rounds = chain_grid_rounds(Bn, K, s, n_mv, n_sms, optin - _build.RESERVED_SHARED_BYTES,
                               _halo)
    ctas = max(rd.nprob * rd.per for rd in rounds)
    xch = torch.empty(ctas * 4 * max(rd.H for rd in rounds) * s, dtype=torch.float32,
                      device=dev)
    y00 = torch.empty(2 * Bn, dtype=torch.float32, device=dev)
    parts = torch.empty(8 * ctas, dtype=torch.float32, device=dev)
    for rd in rounds:
        _build.launch(f"{name} (cooperative, {rd.nprob} x {rd.per} CTAs)",
                      "gato_null_chain_grid", dev, M.data_ptr(), y0.data_ptr(),
                      out.data_ptr(), xch.data_ptr(), y00.data_ptr(), parts.data_ptr(),
                      rd.first, rd.nprob, rd.per, int(rd.resident), int(rd.meet == "flags"),
                      K, s, n_mv, n_dot, trips, rd.H)
        CHAIN_GRID_LAUNCHES += 1
    return out


# Row 17's plan (csrc/probes.cu holds it too; the card test compares
# fma_plan with the library's gato_fma_chain_lanes, _threads, _smem_bytes).

# Floats of a knot's slot of y in shared memory (the 16-lane layout).
FMA_SLOT = 16
# The most knots the 16-lane layout takes (on an H100 it leads the two-lane
# one up to 40 knots and trails it from 50: tools/fma_bench.cu), and the
# most the two-lane one takes (256 threads of ~146 registers).
FMA_WARP_KNOTS = 40
FMA_MAX_KNOTS = 128


class FmaPlan(NamedTuple):
    """Row 17's launch for B problems of K knots: ``ctas`` (one a problem)
    of ``threads`` threads, ``lanes`` a knot, ``rows`` rows of 0.01 M a
    lane, ``smem`` dynamic shared bytes a CTA."""

    ctas: int
    lanes: int
    rows: int
    threads: int
    smem: int


def fma_plan(B: int, K: int) -> FmaPlan:
    """Up to FMA_WARP_KNOTS knots 16 lanes a knot (a row a lane, lanes 14
    and 15 idle, the exchange through the knot's slot in shared memory),
    else two lanes a knot (seven rows a lane, the exchange by shuffles, no
    shared memory); raises ValueError past FMA_MAX_KNOTS knots."""
    if not 1 <= K <= FMA_MAX_KNOTS:
        raise ValueError(f"{FMA_NAME}: K = {K} knots; the kernel takes 1 <= K <= "
                         f"{FMA_MAX_KNOTS} (two lanes a knot, one CTA of at most "
                         f"{2 * FMA_MAX_KNOTS} threads a problem)")
    lanes = 16 if K <= FMA_WARP_KNOTS else 2
    rows = 1 if lanes == 16 else FMA_WIDTH // 2
    smem = 2 * K * FMA_SLOT * 4 if lanes == 16 else 0
    return FmaPlan(B, lanes, rows, -(-lanes * K // 32) * 32, smem)


def fma_chain_cuda(M: torch.Tensor, y0: torch.Tensor, *, depth: int,
                   trips: int) -> torch.Tensor:
    """Row 17 on M (B, K, 14, 14) and y0 (B, K, 14), 1 <= K <=
    FMA_MAX_KNOTS on the card; returns y after ``trips * depth`` matvecs."""
    _counts(FMA_NAME, depth=depth, trips=trips)
    if y0.ndim != 3:
        raise ValueError(f"{FMA_NAME}: y0 must be (B, K, s), got {tuple(y0.shape)}")
    Bn, K, s = y0.shape
    if s != FMA_WIDTH:
        raise ValueError(f"{FMA_NAME}: width s = {s}; the kernel takes s = {FMA_WIDTH}")
    if y0.device.type == "cpu":
        return fma_chain_plain(M, y0, depth=depth, trips=trips)
    _check_device(FMA_NAME, y0)
    dev = y0.device
    M = _build.checked(FMA_NAME, "M", M, (Bn, K, s, s), dev)
    y0 = _build.checked(FMA_NAME, "y0", y0, (Bn, K, s), dev)
    if K:
        fma_plan(Bn, K)
    out = torch.empty_like(y0)
    if Bn == 0 or K == 0:
        return out
    _build.launch(FMA_NAME, "gato_fma_chain", dev, M.data_ptr(), y0.data_ptr(),
                  out.data_ptr(), Bn, K, depth, trips)
    global FMA_LAUNCHES
    FMA_LAUNCHES += 1
    return out

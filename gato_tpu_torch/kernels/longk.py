"""Rows 7-13: the long-horizon tiers as hand-written CUDA kernels, for
horizons past the shared memory of kernels A and B (PCG) and of row 4
(the exact solve).

Replace ``gato_tpu/kernels/longk.py``: ``_condense_kernel`` (row 7), the
inner kernel of ``_pcg_xl_call`` (row 8) and ``_pcg_stream_kernel`` (row
10), ``_fused_xl_kernel`` (row 9), the inner kernel of ``_direct_xl_call``
(row 11), ``_peel_kernel`` (row 12) and ``_recover_kernel`` (row 13),
entry points ``solve_longk_batched`` / ``solve_longk`` and
``solve_direct_longk_batched`` / ``solve_direct_longk``.  The CUDA sources
are ``gato_tpu_torch/csrc/longk.cu`` (rows 7-10 and 13: condensation tiles
that recompute their neighbour knots instead of carrying them, on kernel
B's Gauss-Jordan; a cooperative PCG launch whose CTAs each hold a knot
range with a one-knot halo and meet twice an iteration, per-CTA partial
sums added in one fixed order; knot-parallel recovery) and
``csrc/longk_direct.cu`` (row 11: block cyclic reduction, its first
levels on a cooperative grid, each problem's last rows
(:func:`cr_tail_stride`) on one CTA in shared memory, then the grid's
back-substitution; row 12: a compacting level in two launches, a warp a
block row, and the back-substitution of a compacted level); their notes
give the designs.  Rows 8 and 10 compute one function, PCG on condensed
operators, which the TPU split by whether the operators fit VMEM; on the
card the launch plan (:func:`pcg_rounds`) puts each CTA's blocks of S and
Pinv in its shared memory where they fit and streams them where they do
not, so one kernel, :func:`pcg_longk_cuda`, replaces both.  The TPU layout
(knots on 128 lanes, ``plan_longk`` chunking, VMEM budgets, the lane shift
of the stair's slot 2, the peel's lane padding and chunk schedule) has no
counterpart: the port works in the public (B, K, ...) layout.

Each wrapper takes tensors on a CUDA device to its kernel and raises if the
kernel cannot take them; CPU tensors go to its plain version:

* :func:`condense_longk_cuda` (row 7): ``assemble.condense(flag=True)``;
* :func:`pcg_longk_cuda` (rows 8 and 10): ``pcg.pcg(frozen=...)``;
* :func:`fused_longk_cuda` (row 9): the two together;
* :func:`cr_longk_cuda` (row 11): ``direct.btd_solve_cr(flag=True)``;
* :func:`peel_longk_cuda` (row 12): one ``direct.cr_level``;
* :func:`unpeel_longk_cuda`: its back-substitution, ``direct.cr_back_level``;
* :func:`recover_longk_cuda` (row 13): ``recover.recover_dz``.

``*_LAUNCHES`` count each kernel's launches.  :func:`solve_longk_batched`
runs a PCG tier: ``'fused_xl'`` is row 9 then row 13; ``'xl'`` and
``'stream'`` are both row 7, rows 8/10, row 13 (on this card they are the
same route).  :func:`solve_direct_longk_batched` runs an exact tier:
``'xl'`` is rows 7, 11 and 13; ``'hybrid'`` peels with row 12 before row
11 and back-substitutes after it.  :func:`should_dispatch` and
:func:`should_dispatch_direct` say where the solver routes ``method='pcg'``
and ``method='direct'`` here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..assemble import condense
from ..direct import (btd_solve_cr, cr_back_level, cr_level, residual_converged,
                      residual_norms)
from ..pcg import PCGResult, pcg
from ..problem import Preconditioner
from ..recover import recover_dz
from . import _build, direct_fused, pcg_kernel
from .fused_solve import PRECOND_CODES, block_shapes, device_limits

SOURCE = "gato_tpu_torch/csrc/longk.cu"
DIRECT_SOURCE = "gato_tpu_torch/csrc/longk_direct.cu"
CONDENSE_NAME = "condense_longk_cuda"
PCG_NAME = "pcg_longk_cuda"
FUSED_NAME = "fused_longk_cuda"
RECOVER_NAME = "recover_longk_cuda"
CR_NAME = "cr_longk_cuda"
PEEL_NAME = "peel_longk_cuda"
UNPEEL_NAME = "unpeel_longk_cuda"
CONDENSE_REPLACES = "gato_tpu/kernels/longk.py:352"
PCG_REPLACES = "gato_tpu/kernels/longk.py:430, gato_tpu/kernels/longk.py:661"
FUSED_REPLACES = "gato_tpu/kernels/longk.py:547"
RECOVER_REPLACES = "gato_tpu/kernels/longk.py:1464"
CR_REPLACES = "gato_tpu/kernels/longk.py:860"
PEEL_REPLACES = "gato_tpu/kernels/longk.py:1171"
# Not a TPU kernel: gato_tpu back-substitutes a peeled level in XLA.
UNPEEL_REPLACES = "gato_tpu/kernels/longk.py:1062 (_cr_unpeel, XLA)"

CONDENSE_LAUNCHES = 0
PCG_LAUNCHES = 0
FUSED_LAUNCHES = 0
RECOVER_LAUNCHES = 0
CR_LAUNCHES = 0
PEEL_LAUNCHES = 0
UNPEEL_LAUNCHES = 0

TIERS = ("fused_xl", "xl", "stream")
# The tier of a call that forces none: rows 7 + 8/10 + 13, the faster
# route on an H100 at the shapes chip_smoke.py phase 5d times (K =
# 1024-8192, B = 1 and 16; PERF.md): row 9 condenses on the PCG loop's
# CTAs, one an SM, where row 7 runs two tiles an SM, and its PCG keeps
# one CTA an SM, which makes the 'fused_xl' route up to ~40 % slower
# (within the host's spread at K = 1024, B = 1).
AUTO_TIER = "xl"
# The per-block shared memory an H100 lets a kernel opt in to: the limit
# the routing assumes for tensors on the CPU, whose plain versions then
# take the route the card would.
H100_SHARED_BYTES = 232448

DIRECT_TIERS = ("xl", "hybrid", "xla")
# The exact tier of a call that forces none is 'hybrid' from this many
# block rows in the batch (B * K), else 'xl'.  On an H100 (700 W;
# chip_smoke.py phase 5e, whole route, IIWA widths) 'xl' was the faster at
# B = 1 for K = 1024-8192 (0.91 / 0.71 / 1.06 / 1.22 ms against 1.04 /
# 0.95 / 1.46 / 1.55: a peel adds three launches), 'hybrid' at B = 15 for
# the same K (1.53 / 2.60 / 4.43 / 8.32 ms against 1.60 / 2.72 / 4.96 /
# 9.48: the peel kernels run the widest levels on more warps than the
# cooperative grid holds).  B * K = 8192 took 'xl', 15360 'hybrid'; the
# shapes between were not measured.
HYBRID_MIN_ROWS = 12288
# 'hybrid' peels (row 12) until the reduced system has at most this many
# rows, and at least once, before row 11 solves it.
HYBRID_CR_ROWS = 1024


class LongkOperators(NamedTuple):
    """Row 7's outputs, with a leading batch axis: S and Pinv (B, K, 3, s,
    s), gamma (B, K, s), Qinv (B, K, s, s), Rinv (B, K-1, c, c) and the
    zero-pivot flag of each problem (B,)."""

    S: torch.Tensor
    Pinv: torch.Tensor
    gamma: torch.Tensor
    Qinv: torch.Tensor
    Rinv: torch.Tensor
    bad: torch.Tensor


def should_dispatch(K: int, s: int, c: int, smem_limit: int) -> bool:
    """True iff ``method='pcg'`` on the kernel routes belongs to this tier:
    kernel A's vectors exceed a block's shared memory (``smem_limit``, the
    device's opt-in bytes), and a condensation tile takes the widths."""
    return (pcg_kernel.smem_bytes(K, s) > smem_limit - _build.RESERVED_SHARED_BYTES
            and max(s, c) <= _build.MAX_BLOCK)


def should_dispatch_direct(K: int, s: int, c: int, smem_limit: int) -> bool:
    """True iff ``method='direct'`` on the kernel routes belongs to the
    exact tier here: row 4's shared memory does not take the horizon (IIWA
    K >= 741 on an H100) and the kernels take the widths."""
    return (K >= 2 and max(s, c) <= _build.MAX_BLOCK
            and not direct_fused.fits(K, s, c, smem_limit))


def direct_tier(Bn: int, K: int) -> str:
    """The exact tier of a call that forces none, for Bn problems of horizon
    K: 'hybrid' from ``HYBRID_MIN_ROWS`` block rows, else 'xl'."""
    return "hybrid" if Bn * K >= HYBRID_MIN_ROWS else "xl"


def hybrid_peels(K: int) -> int:
    """Row 12 levels of the 'hybrid' tier at horizon K: until at most
    ``HYBRID_CR_ROWS`` rows are left, at least one."""
    peels, rows = 1, (K + 1) // 2
    while rows > HYBRID_CR_ROWS:
        peels, rows = peels + 1, (rows + 1) // 2
    return peels


# --------------------------------------------------------------------------
# The launch plans of rows 7, 8/10 and 9 (mirrors of longk.cu's; the card
# tests compare them with the library's gato_longk_* functions).  ``limit``
# is the shared memory a block may use, in bytes.

THREADS = 256
# Own knots of a condensation tile, at most, and the tiles an SM aims at.
MAX_TILE_KNOTS = 6
TILES_PER_SM = 2
# Knots of one buffer of a streamed operator's two-buffer ring.
RING_KNOTS = 8
# Knots a PCG CTA takes at least.
MIN_CTA_KNOTS = 8
# What a PCG CTA holds in shared memory: its vectors, S's and Pinv's blocks.
VEC_IN_SMEM, S_RESIDENT, P_RESIDENT = 1, 2, 4
_FLAG_ORDER = (7, 3, 1, 6, 2, 0)
# How a PCG CTA meets its problem's other CTAs at each dot product:
# flagged partials (a problem's CTAs alone) or cg::grid_group::sync (the
# whole launch, so only in a round of one problem).
BARRIERS = ("flags", "grid")
# Static shared memory of a PCG CTA, at most (its reduction slots).
_STATIC_SHARED = 256


def _round4(floats: int) -> int:
    return (floats + 3) // 4 * 4


def _gj_round_floats(chunk: int, n: int) -> int:
    """One Gauss-Jordan round of ``chunk`` n x n matrices (gauss_jordan.cuh)."""
    return 2 * chunk * n * n + 2 * chunk * n + chunk


class TilePlan(NamedTuple):
    """A condensation tile's shared memory, in floats: Qinv of its window
    of nk + 3 knots, Rinv of the window's intervals, phi / theta / phi^T,
    theta^{-1}, and the Gauss-Jordan round."""

    nk: int
    qinv: int
    rinv: int
    ops: int
    thinv: int
    gj: int
    total: int


def tile_plan(nk: int, s: int, cdim: int) -> TilePlan:
    nw, ss = nk + 3, s * s
    rinv = _round4(nw * ss)
    ops = rinv + _round4((nw - 1) * cdim * cdim)
    thinv = ops + _round4(3 * nw * ss)
    gj = thinv + _round4(nw * ss)
    area = max(_gj_round_floats(min(THREADS // s, nw), s),
               _gj_round_floats(min(THREADS // cdim, nw - 1), cdim))
    return TilePlan(nk, 0, rinv, ops, thinv, gj, gj + area)


def tile_threads(nk: int, s: int, cdim: int) -> int:
    """Threads of a row 7 CTA: one a row of its window's Gauss-Jordan
    batch, whole warps, from 64 to 256 (row 9 runs its tiles on the PCG
    loop's 256)."""
    return min(max(-(-(nk + 3) * max(s, cdim) // 32) * 32, 64), THREADS)


@functools.cache
def tile_knots(B: int, K: int, s: int, cdim: int, n_sms: int, limit: int) -> int:
    """Own knots of a row 7 / row 9 tile: ``TILES_PER_SM`` tiles an SM
    where the knots allow (ceil(B K / (2 n_sms))), no more than one
    Gauss-Jordan round's rows in the window ((nk + 3) max(s, c) <= 256), at
    most ``MAX_TILE_KNOTS`` and K, and the tile's plan within ``limit``.

    Why: a tile is a chain of three Gauss-Jordan batches (2 s CTA
    barriers each), so its time hardly depends on its size, and the SMs
    hide one tile's barriers behind another's work.  On an H100 at IIWA
    widths (chip_smoke.py phase 5d's tile sweep, PERF.md), B = 1: at K =
    1024 tiles of 2, 3, 4 and 6 knots took 0.061, 0.061, 0.058 and
    0.066-0.068 ms, at K = 8192 0.41, 0.34, 0.32 and 0.29 ms."""
    cap = min(THREADS // max(s, cdim) - 3, MAX_TILE_KNOTS, K)
    nk = max(min(-(-B * K // (n_sms * TILES_PER_SM)), cap), 1)
    while nk > 1 and tile_plan(nk, s, cdim).total * 4 > limit:
        nk -= 1
    return nk


def tile_range(K: int, nk: int, tile: int) -> tuple:
    """Own knots [k0, k1) of tile ``tile``."""
    k0 = tile * nk
    return k0, min(k0 + nk, K)


def tile_window(K: int, k0: int, k1: int) -> tuple:
    """The knots [w0, w1) a tile condenses: two left of its own, one right."""
    return max(k0 - 2, 0), min(k1 + 1, K)


class PcgPlan(NamedTuple):
    """A PCG CTA's shared memory, in floats: lambda's rows and five halo
    vectors (``vec_floats``) when VEC_IN_SMEM, S's and Pinv's blocks of its
    knots when resident, and the two-buffer ring of ``ring`` knots a buffer
    when either streams."""

    per: int
    nk: int
    flags: int
    ring: int
    vec_floats: int
    off_S: int
    off_P: int
    off_ring: int
    total: int


def pcg_plan(K: int, s: int, per: int, flags: int, ring: int) -> PcgPlan:
    nk = -(-K // per)
    kf = 3 * s * s
    vec = _round4(nk * s + 5 * (nk + 2) * s)
    off_S = vec if flags & VEC_IN_SMEM else 0
    off_P = off_S + (_round4(nk * kf) if flags & S_RESIDENT else 0)
    off_ring = off_P + (_round4(nk * kf) if flags & P_RESIDENT else 0)
    both = S_RESIDENT | P_RESIDENT
    total = off_ring + (0 if flags & both == both else 2 * _round4(ring * kf))
    return PcgPlan(per, nk, flags, ring, vec, off_S, off_P, off_ring, total)


def pcg_flags(K: int, s: int, per: int, limit: int) -> int:
    """What a CTA of ``per`` holds in shared memory within ``limit``, with a
    ring of ``RING_KNOTS``: the vectors first, then S, then Pinv; -1 if not
    even the ring fits."""
    ring = min(-(-K // per), RING_KNOTS)
    return next((f for f in _FLAG_ORDER
                 if pcg_plan(K, s, per, f, ring).total * 4 <= limit), -1)


def pcg_ring(K: int, s: int, per: int, flags: int, limit: int) -> int:
    """Knots of a ring buffer: all the shared memory ``flags`` leaves, at
    least ``RING_KNOTS`` (or nk), at most nk: fewer, larger chunks keep more
    of a streamed operator in flight."""
    nk = -(-K // per)
    base = min(nk, RING_KNOTS)
    free = limit // 4 - pcg_plan(K, s, per, flags, base).off_ring - 8
    return max(min(free // (2 * 3 * s * s), nk), base)


def pcg_per(nprob: int, K: int, n_sms: int) -> int:
    """CTAs a problem for a round of ``nprob`` problems, one CTA an SM: the
    SMs shared out, at least ``MIN_CTA_KNOTS`` knots a CTA, and then as
    few CTAs as give every CTA that many knots (none empty).  On an H100
    at IIWA K = 1024, B = 1 (chip_smoke.py phase 5d's sweep) an iteration
    took 7.6, 6.7, 6.2, 5.7, 6.2 and 7.3 us on 56, 64, 96, 128 (this
    rule), 132 and 264 CTAs: fewer knots a CTA until the barriers'
    arrivals and the extra halo work cost more."""
    per = max(min(n_sms // nprob, -(-K // MIN_CTA_KNOTS)), 1)
    nk = -(-K // per)
    return -(-K // nk)


def cta_range(K: int, per: int, part: int) -> tuple:
    """Own knots [k0, k1) of CTA ``part`` of ``per``: ceil(K / per) each in
    order, the last ones short or empty."""
    nk = -(-K // per)
    k0 = min(part * nk, K)
    return k0, min(k0 + nk, K)


class PcgRound(NamedTuple):
    """One cooperative launch: problems first .. first + nprob - 1, ``per``
    CTAs each, shared memory by ``flags`` and ``ring``, its CTAs meeting by
    ``meet`` (one of ``BARRIERS``; 'grid' only for one problem)."""

    first: int
    nprob: int
    per: int
    flags: int
    ring: int
    meet: str


def _share_limit(limit: int, per_sm: int) -> int:
    """Shared bytes a CTA may plan with when ``per_sm`` CTAs share an SM
    (``limit`` for one)."""
    if per_sm == 1:
        return limit
    return ((limit + _build.RESERVED_SHARED_BYTES) // per_sm
            - _build.RESERVED_SHARED_BYTES - _STATIC_SHARED)


@functools.cache
def pcg_rounds(B: int, K: int, s: int, n_sms: int, limit: int,
               ctas: Optional[int] = None, per_sm: int = 2) -> tuple:
    """The rounds of a PCG launch of B problems: as many problems as SMs a
    round, :func:`pcg_per` CTAs each, and twice as many CTAs (two an SM,
    up to ``per_sm``) where neither operator fits on chip at one CTA an SM
    and the vectors stay where they were: more streams in flight.  On an
    H100 at IIWA (chip_smoke.py phase 5d, PERF.md) two CTAs an SM run
    rows 8/10 faster where the operators stream (K = 8192, B = 16) and
    slower where they push the vectors out of shared memory (K = 4096, B =
    16).
    ``ctas`` (1 to 2 n_sms) forces the CTAs a problem, at most 2 n_sms CTAs
    a round.  A round of more CTAs than SMs plans each CTA within its share
    of an SM's shared memory, so that the cooperative launch's CTAs are all
    resident.
    A round of one problem meets on grid barriers, one of several on
    flagged partials (each problem then leaves the loop at its own exit,
    and grid barriers would bind it to the others).  On an H100 at IIWA
    (chip_smoke.py phase 5d) an iteration took 5.7 us on grid barriers and
    10.9 on flagged partials at K = 1024, B = 1 (15.4 and 21.8 at K =
    8192)."""
    if ctas is not None and (not isinstance(ctas, int) or not 1 <= ctas <= 2 * n_sms):
        raise ValueError(f"{PCG_NAME}: ctas must be an int from 1 to {2 * n_sms}, "
                         f"got {ctas!r}")
    both = S_RESIDENT | P_RESIDENT
    rounds, first = [], 0
    while first < B:
        if ctas is None:
            nprob = min(B - first, n_sms)
            per = pcg_per(nprob, K, n_sms)
            flags = pcg_flags(K, s, per, limit)
            lim = limit
            if per_sm > 1 and flags >= 0 and not flags & both:
                per2 = pcg_per(nprob, K, 2 * n_sms)
                lim2 = _share_limit(limit, -(-nprob * per2 // n_sms))
                flags2 = pcg_flags(K, s, per2, lim2)
                if per2 > per and flags2 >= 0 and flags2 & VEC_IN_SMEM >= flags & VEC_IN_SMEM:
                    per, flags, lim = per2, flags2, lim2
        else:
            per = ctas
            nprob = min(B - first, max(2 * n_sms // ctas, 1))
            lim = _share_limit(limit, -(-nprob * per // n_sms))
            flags = pcg_flags(K, s, per, lim)
        if flags < 0:
            raise ValueError(f"{PCG_NAME}: no plan of {per} CTAs a problem takes "
                             f"(K, s) = ({K}, {s}) within {lim} B of shared memory")
        rounds.append(PcgRound(first, nprob, per, flags, pcg_ring(K, s, per, flags, lim),
                               "grid" if nprob == 1 else "flags"))
        first += nprob
    return tuple(rounds)


# Row 13's plan (mirrors of longk.cu's; the card test compares
# recover_smem_bytes with gato_longk_recover_smem_bytes): a warp a knot,
# RECOVER_KNOTS knots a CTA, each warp's window copied into its own slice
# of shared memory before the first product.
RECOVER_KNOTS = 4


def recover_width(s: int) -> int:
    """The recovery kernel's width: 14 compiled in, else 16 or 32."""
    return 14 if s == 14 else (16 if s <= 16 else 32)


class RecoverLayout(NamedTuple):
    """A recovery warp's slice of shared memory, in floats: Qinv_k (s rows
    of ``ldq``), A_k, B_k, Rinv_k (c rows of ``ldr``), q_k, lambda_k,
    lambda_{k+1}, rx, r_k and ru, each offset a multiple of 4."""

    ldq: int
    ldr: int
    qi: int
    at: int
    bt: int
    ri: int
    qv: int
    x0: int
    xp: int
    rx: int
    rv: int
    ru: int
    total: int


def recover_layout(s: int, cdim: int) -> RecoverLayout:
    """Qinv's row stride is 14 at IIWA's width and recover_width(s) + 1
    past it, Rinv's c made odd: lane a reading row a meets no bank
    conflict."""
    w = recover_width(s)
    ldq = 14 if w == 14 else w + 1
    ldr = cdim | 1
    v, u = _round4(s), _round4(cdim)
    qi = 0
    at = qi + _round4(s * ldq)
    bt = at + _round4(s * s)
    ri = bt + _round4(s * cdim)
    qv = ri + _round4(cdim * ldr)
    x0, xp, rx = qv + v, qv + 2 * v, qv + 3 * v
    rv = qv + 4 * v
    ru = rv + u
    return RecoverLayout(ldq, ldr, qi, at, bt, ri, qv, x0, xp, rx, rv, ru, ru + u)


def recover_smem_bytes(s: int, cdim: int) -> int:
    """Dynamic shared memory of a recovery CTA."""
    return 4 * RECOVER_KNOTS * recover_layout(s, cdim).total


def recover_grid(B: int, K: int) -> int:
    """CTAs of a recovery launch: B ceil(K / RECOVER_KNOTS); knot k of
    problem b is warp k % RECOVER_KNOTS of CTA b ceil(K / 4) + k // 4."""
    return B * -(-K // RECOVER_KNOTS)


def recover_window(K: int, k: int) -> tuple:
    """The blocks knot k's warp copies: the last knot only its own Qinv, q
    and lambda."""
    own = ("Qinv", "q", "lam")
    return own + ("A", "B", "Rinv", "r", "lam_next") if k < K - 1 else own


# Row 11's plan (mirrors of longk_direct.cu's; the card tests compare
# them with the library's gato_longk_cr_* functions): the rows k = 0 mod
# ht of a problem go to one CTA's shared memory (the tail), the levels
# below ht run on the cooperative grid.

TAIL_THREADS = 512
CR_WARPS = 8


def cr_tail_row_floats(s: int) -> int:
    """A tail row's floats: [L D U | b | x]."""
    return _round4(3 * s * s + 2 * s)


def cr_tail_floats(rows: int, s: int) -> int:
    """The tail's shared memory, in floats: its rows, then A and B of a
    level's ceil(rows / 2) even rows."""
    return rows * cr_tail_row_floats(s) + (rows + 1) // 2 * 2 * s * s


def cr_grid_floats(s: int) -> int:
    """A grid CTA's shared memory, in floats: CR_WARPS groups' D^{-1} of
    both neighbours, A and B."""
    return CR_WARPS * _round4(4 * s * s)


def cr_tail_stride(K: int, s: int, limit: int) -> int:
    """ht, the power of two from which a problem's rows (k = 0 mod ht,
    ceil(K / ht) of them) fit the tail's ``limit`` bytes of shared memory:
    at IIWA widths on an H100 up to 71 rows (ht = 16 at K = 1024, 128 at K
    = 8192; K <= 71 runs in the tail alone)."""
    ht = 1
    while cr_tail_floats((K - 1) // ht + 1, s) * 4 > limit:
        ht *= 2
    return ht


def cr_group_warps(tasks: int, warps: int) -> int:
    """Warps of a group at a grid level of ``tasks`` even rows on ``warps``
    resident warps: CR_WARPS (a CTA) down to 1, the most that still gives
    every task a group (longk_direct.cu's group_warps)."""
    g = CR_WARPS
    while g > 1 and tasks * g > warps:
        g //= 2
    return g


# Row 12's and the unpeel's plan (mirrors of longk_direct.cu's; the card
# tests compare them with gato_longk_peel_smem_bytes and
# gato_longk_unpeel_smem_bytes): the peel's inversions and the unpeel a row
# a warp, CR_WARPS warps a CTA; its reductions a row a warp, PEEL_THREADS /
# 32 warps a CTA.
PEEL_THREADS = 128


def peel_floats(s: int) -> int:
    """A reduction warp's staged rows, in floats: the even row's [L D U],
    its neighbours' L and U in the same places, both D^{-1}, A and B
    (13 s^2), then the three rows' b."""
    return _round4(13 * s * s + 3 * s)


def peel_smem_bytes(s: int) -> int:
    """Dynamic shared memory of a CTA of the peel's reductions."""
    return 4 * (PEEL_THREADS // 32) * peel_floats(s)


def peel_grid(B: int, W: int) -> tuple:
    """CTAs of the peel's two launches (the inversions', the reductions')
    for a level of W rows of B problems."""
    return -(-B * (W // 2) // CR_WARPS), -(-B * ((W + 1) // 2) // (PEEL_THREADS // 32))


def unpeel_smem_bytes(s: int) -> int:
    """Dynamic shared memory of an unpeel CTA: each warp's L_o, U_o,
    D_o^{-1}, b_o, both x_half rows and the bracket."""
    return 4 * CR_WARPS * _round4(3 * s * s + 4 * s)


def grid_barriers(poly_degree: int) -> int:
    """Barriers a PCG iteration meets: one after each dot product, and two
    for each Horner term past the first."""
    return 2 * poly_degree


# --------------------------------------------------------------------------
# Plain versions.


def condense_longk_plain(Q, R, A, B, q, r, c, *, rho=0.0,
                         preconditioner="symmetric_stair") -> LongkOperators:
    """Row 7's plain version: ``assemble.condense(flag=True)``."""
    sys = condense(Q, R, A, B, q, r, c, rho, Preconditioner(preconditioner),
                   flag=True)
    return LongkOperators(sys.S, sys.Pinv, sys.gamma, sys.Qinv, sys.Rinv,
                          sys.bad)


def pcg_longk_plain(S, Pinv, gamma, lam0, frozen=None, *, exit_tol=1e-6,
                    max_iters=100, poly_degree=1) -> PCGResult:
    """Rows 8/10's plain version: ``pcg.pcg`` with frozen problems."""
    return pcg(S, Pinv, gamma, lam0, exit_tol=exit_tol, max_iters=max_iters,
               poly_degree=poly_degree, frozen=frozen)


def fused_longk_plain(Q, R, A, B, q, r, c, lam0, *, rho=0.0, exit_tol=1e-6,
                      max_iters=100, poly_degree=1,
                      preconditioner="symmetric_stair"):
    """Row 9's plain version: rows 7 and 8/10's.  Returns (PCGResult, Qinv,
    Rinv)."""
    ops = condense_longk_plain(Q, R, A, B, q, r, c, rho=rho,
                               preconditioner=preconditioner)
    res = pcg_longk_plain(ops.S, ops.Pinv, ops.gamma, lam0, ops.bad,
                          exit_tol=exit_tol, max_iters=max_iters,
                          poly_degree=poly_degree)
    return res, ops.Qinv, ops.Rinv


def recover_longk_plain(Qinv, Rinv, A, B, q, r, lam):
    """Row 13's plain version: ``recover.recover_dz``."""
    return recover_dz(Qinv, Rinv, A, B, q, r, lam)


class PeelLevel(NamedTuple):
    """What the back-substitution of one compacted level reads: the level's
    input S (B, W, 3, s, s) and b (B, W, s), whose odd rows' L, U and b it
    uses, the odd rows' D^{-1} Doinv (B, W // 2, s, s), and ``bad``
    (B, W // 2), True where that inversion clamped a zero pivot in a block
    whose diagonal is not all zero."""

    S: torch.Tensor
    b: torch.Tensor
    Doinv: torch.Tensor
    bad: torch.Tensor


def cr_longk_plain(S, gamma):
    """Row 11's plain version: ``direct.btd_solve_cr(flag=True)``, returning
    (lam, bad) with lam unpoisoned."""
    return btd_solve_cr(S, gamma, flag=True)


def peel_longk_plain(S, b):
    """Row 12's plain version: one ``direct.cr_level`` on S (B, W, 3, s, s)
    and b (B, W, s).  Returns (S' (B, ceil(W/2), 3, s, s), b', PeelLevel)."""
    (L, D, U, bh), (Doinv, _, _, _), bad = cr_level(
        S[..., 0, :, :], S[..., 1, :, :], S[..., 2, :, :], b, flag=True)
    return torch.stack([L, D, U], dim=-3), bh, PeelLevel(S, b, Doinv, bad)


def unpeel_longk_plain(x_half, level: PeelLevel):
    """The back-substitution of one peeled level (gato_tpu's XLA
    ``_cr_unpeel``): ``direct.cr_back_level``, x (B, W, s) from the reduced
    system's x_half (B, ceil(W/2), s)."""
    S, b = level.S, level.b
    return cr_back_level(x_half, level.Doinv, S[..., 1::2, 0, :, :],
                         S[..., 1::2, 2, :, :], b[..., 1::2, :], b.shape[-2])


# --------------------------------------------------------------------------
# The wrappers.


def _check_args(name: str, q: torch.Tensor, preconditioner=None,
                poly_degree=None) -> None:
    if preconditioner is not None and preconditioner not in PRECOND_CODES:
        raise ValueError(f"unknown preconditioner {preconditioner!r}; valid: "
                         f"{sorted(PRECOND_CODES)}")
    if poly_degree is not None and (not isinstance(poly_degree, int)
                                    or poly_degree < 1):
        raise ValueError(f"{name}: poly_degree must be an int >= 1")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {q.device} are neither CPU nor CUDA")


def _check_widths(name: str, K: int, s: int, c: int) -> None:
    if K < 2 or max(s, c) > _build.MAX_BLOCK:
        raise ValueError(f"{name}: needs K >= 2 and s, c <= {_build.MAX_BLOCK}; "
                         f"got K={K}, s={s}, c={c}")


@functools.cache
def _resident_ctas(device_index: int, s: int) -> int:
    """Row 11's occupancy query (gato_longk_cr_grid), once per device and
    width."""
    with torch.cuda.device(device_index):
        return _build.library().gato_longk_cr_grid(s)


def _grid(name: str, s: int, dev) -> int:
    """Resident CTAs of row 11's cooperative kernels on ``dev``; raises with
    the numbers when none fits."""
    grid = _resident_ctas(dev.index, s)
    if grid < 1:
        lib = _build.library()
        smem = lib.gato_longk_cr_grid_smem_bytes(s)
        why = (f"CUDA error {-grid} ({lib.gato_error_string(-grid).decode()})"
               if grid < 0 else "0 resident blocks")
        raise RuntimeError(
            f"{name}: the cooperative grid does not fit the device: the "
            f"occupancy query for blocks of 256 threads and {smem} B of "
            f"dynamic shared memory at s = {s} gave {why}")
    return grid


def _limits(dev) -> tuple:
    """(SMs, shared bytes a block may use) of a CUDA device: the opt-in
    limit less what the runtime keeps."""
    n_sms, optin = device_limits(dev.index)
    return n_sms, optin - _build.RESERVED_SHARED_BYTES


def _loop_buffers(rounds, K: int, s: int, dev):
    """The PCG rounds' global buffers, each sized for the widest round: the
    CTAs' vectors where they are not in shared memory, the published
    boundary rows (six knots' rows a CTA) and the meetings' words (two
    8-byte {partial, tag} words a CTA and two {sum, tag} words a problem,
    or two partials a CTA for grid barriers)."""
    grid = max(rd.nprob * rd.per for rd in rounds)
    vec_floats = max((rd.nprob * rd.per * pcg_plan(K, s, rd.per, 0, 0).vec_floats
                      for rd in rounds if not rd.flags & VEC_IN_SMEM), default=0)
    vec = torch.empty(vec_floats, dtype=torch.float32, device=dev) if vec_floats else None
    xch = torch.empty(grid * 6 * s, dtype=torch.float32, device=dev)
    parts = torch.empty(8 * grid, dtype=torch.float32, device=dev)
    return vec, xch, parts


def _ptr(t):
    return None if t is None else t.data_ptr()


def _round_args(rd: PcgRound, bufs) -> tuple:
    """The launcher's buffer pointers (vec, xch, parts) and the round's
    plan."""
    vec, xch, parts = bufs
    return (_ptr(vec), xch.data_ptr(), parts.data_ptr(), rd.first, rd.nprob, rd.per,
            rd.flags, rd.ring)


def _kkt(name: str, Q, R, A, B, q, r, c):
    """The seven block tensors, checked (float32 on q's CUDA device, the
    KKTBlocks shapes with a batch axis) and contiguous; returns (Bn, K, s,
    c, tensors)."""
    if Q.ndim != 4:
        raise ValueError(f"{name}: Q must be (B, K, s, s), got {tuple(Q.shape)}")
    Bn, K, s, _ = Q.shape
    cdim = R.shape[-1]
    expect = block_shapes((Bn,), K, s, cdim)
    tensors = [_build.checked(name, key, x, shape, q.device)
               for (key, shape), x in zip(expect.items(), (Q, R, A, B, q, r, c))]
    _check_widths(name, K, s, cdim)
    return Bn, K, s, cdim, tensors


def condense_longk_cuda(Q, R, A, B, q, r, c, *, rho: float = 0.0,
                        preconditioner: str = "symmetric_stair",
                        _tile: Optional[int] = None) -> LongkOperators:
    """Row 7: the batched condensation with the zero-pivot flag.  Arguments
    follow ``formats.KKTBlocks`` with one leading batch axis.  ``_tile``,
    for measurements and checks on CUDA tensors, overrides the plan's knots
    a condensation tile (:func:`tile_knots`; the outputs do not depend on
    it)."""
    _check_args(CONDENSE_NAME, q, preconditioner)
    if q.device.type == "cpu":
        return condense_longk_plain(Q, R, A, B, q, r, c, rho=rho,
                                    preconditioner=preconditioner)
    Bn, K, s, cdim, t = _kkt(CONDENSE_NAME, Q, R, A, B, q, r, c)
    dev = q.device
    n_sms, limit = _limits(dev)
    nk = tile_knots(Bn, K, s, cdim, n_sms, limit) if _tile is None else _forced_tile(
        CONDENSE_NAME, _tile, K, s, cdim, limit)
    S = torch.empty(Bn, K, 3, s, s, dtype=torch.float32, device=dev)
    ops = LongkOperators(S=S, Pinv=torch.empty_like(S), gamma=torch.empty_like(q),
                         Qinv=torch.empty_like(Q), Rinv=torch.empty_like(R),
                         bad=torch.empty(Bn, dtype=torch.bool, device=dev))
    if Bn > 0:
        _build.launch(CONDENSE_NAME, "gato_longk_condense", dev,
                      *(x.data_ptr() for x in (*t, *ops)), Bn, K, s, cdim,
                      float(rho), PRECOND_CODES[preconditioner], nk)
        global CONDENSE_LAUNCHES
        CONDENSE_LAUNCHES += 1
    return ops


def _forced_tile(name: str, tile, K: int, s: int, cdim: int, limit: int) -> int:
    if (not isinstance(tile, int) or not 1 <= tile <= min(K, MAX_TILE_KNOTS)
            or (tile + 3) * max(s, cdim) > THREADS
            or tile_plan(tile, s, cdim).total * 4 > limit):
        raise ValueError(f"{name}: _tile={tile!r} does not take (K, s, c) = ({K}, {s}, "
                         f"{cdim}): 1 <= tile <= min(K, {MAX_TILE_KNOTS}), its window's "
                         f"rows within {THREADS} threads and its plan within {limit} B")
    return tile


def _frozen(frozen, Bn: int, dev):
    """``frozen`` as contiguous bools on ``dev`` (None stays None)."""
    if frozen is None:
        return None
    if tuple(frozen.shape) != (Bn,):
        raise ValueError(f"{PCG_NAME}: frozen shape {tuple(frozen.shape)}, "
                         f"expected {(Bn,)}")
    return frozen.to(device=dev, dtype=torch.bool).contiguous()


def _forced_rounds(rounds, Bn: int) -> tuple:
    """``rounds`` if they are a plan of :class:`PcgRound` that covers the
    Bn problems in order, grid barriers only in a round of one problem."""
    first = 0
    for rd in rounds:
        if (not isinstance(rd, PcgRound) or rd.first != first or rd.nprob < 1
                or rd.per < 1 or rd.meet not in BARRIERS
                or (rd.meet == "grid" and rd.nprob != 1)):
            raise ValueError(f"{PCG_NAME}: _rounds must be PcgRounds covering the "
                             f"{Bn} problems in order, grid barriers only for one "
                             f"problem; got {rounds!r}")
        first += rd.nprob
    if first != Bn:
        raise ValueError(f"{PCG_NAME}: _rounds cover {first} problems, not {Bn}")
    return tuple(rounds)


def pcg_longk_cuda(S, Pinv, gamma, lam0=None, frozen=None, *,
                   exit_tol: float = 1e-6, max_iters: int = 100,
                   poly_degree: int = 1, _rounds=None) -> PCGResult:
    """Rows 8 and 10: PCG on condensed operators S, Pinv (B, K, 3, s, s) and
    gamma (B, K, s), one cooperative launch a round (:func:`pcg_rounds`).
    ``frozen`` (B,) marks problems that run no iteration and report
    max_iters, not converged and eta = 1e30 (row 7's ``bad``).  ``_rounds``,
    for measurements and checks on CUDA tensors, overrides the plan with
    one of :func:`pcg_rounds`'s (its CTAs a problem or CTAs an SM) or with
    a round's other meeting: the bits depend on the CTAs a problem, not on
    the meeting."""
    if lam0 is None:
        lam0 = torch.zeros_like(gamma)
    _check_args(PCG_NAME, gamma, poly_degree=poly_degree)
    if gamma.device.type == "cpu":
        return pcg_longk_plain(S, Pinv, gamma, lam0, frozen, exit_tol=exit_tol,
                               max_iters=max_iters, poly_degree=poly_degree)
    if gamma.ndim != 3:
        raise ValueError(f"{PCG_NAME}: gamma must be (B, K, s), got "
                         f"{tuple(gamma.shape)}")
    Bn, K, s = gamma.shape
    dev = gamma.device
    S, Pinv, gamma, lam0 = (
        _build.checked(PCG_NAME, key, x, shape, dev)
        for key, x, shape in (("S", S, (Bn, K, 3, s, s)), ("Pinv", Pinv, (Bn, K, 3, s, s)),
                              ("gamma", gamma, (Bn, K, s)), ("lam0", lam0, (Bn, K, s))))
    frozen = _frozen(frozen, Bn, dev)
    _check_widths(PCG_NAME, K, s, 1)
    lam = torch.empty_like(gamma)
    iters = torch.empty(Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(Bn, dtype=torch.bool, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    if Bn > 0:
        rounds = (pcg_rounds(Bn, K, s, *_limits(dev)) if _rounds is None
                  else _forced_rounds(_rounds, Bn))
        bufs = _loop_buffers(rounds, K, s, dev)
        head = (S.data_ptr(), Pinv.data_ptr(), gamma.data_ptr(), lam0.data_ptr(),
                _ptr(frozen), lam.data_ptr(), iters.data_ptr(), conv.data_ptr(),
                eta.data_ptr())
        global PCG_LAUNCHES
        for rd in rounds:
            _build.launch(f"{PCG_NAME} (cooperative, {rd.nprob} x {rd.per} CTAs)",
                          "gato_longk_pcg", dev, *head, *_round_args(rd, bufs), K, s,
                          float(exit_tol), int(max_iters), poly_degree,
                          int(rd.meet == "flags"))
            PCG_LAUNCHES += 1
    return PCGResult(lam=lam, iters=iters, converged=conv, eta=eta)


def fused_longk_cuda(Q, R, A, B, q, r, c, lam0=None, *, rho: float = 0.0,
                     exit_tol: float = 1e-6, max_iters: int = 100,
                     poly_degree: int = 1,
                     preconditioner: str = "symmetric_stair"):
    """Row 9: condensation and PCG in one cooperative launch a round (rows 7
    and 8/10's plans, so their bits).  Returns (PCGResult, Qinv, Rinv) for
    the recovery; a problem whose condensation met a zero pivot is frozen
    as in :func:`pcg_longk_cuda`."""
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    _check_args(FUSED_NAME, q, preconditioner, poly_degree)
    if q.device.type == "cpu":
        return fused_longk_plain(Q, R, A, B, q, r, c, lam0, rho=rho,
                                 exit_tol=exit_tol, max_iters=max_iters,
                                 poly_degree=poly_degree,
                                 preconditioner=preconditioner)
    Bn, K, s, cdim, t = _kkt(FUSED_NAME, Q, R, A, B, q, r, c)
    dev = q.device
    lam0 = _build.checked(FUSED_NAME, "lam0", lam0, (Bn, K, s), dev)
    lam = torch.empty_like(q)
    iters = torch.empty(Bn, dtype=torch.int32, device=dev)
    conv = torch.empty(Bn, dtype=torch.bool, device=dev)
    eta = torch.empty(Bn, dtype=torch.float32, device=dev)
    Qinv = torch.empty_like(Q)
    Rinv = torch.empty_like(R)
    if Bn > 0:
        n_sms, limit = _limits(dev)
        # Row 9 condenses on the same CTAs, one an SM.
        rounds = pcg_rounds(Bn, K, s, n_sms, limit, per_sm=1)
        nk = tile_knots(Bn, K, s, cdim, n_sms, limit)
        S = torch.empty(Bn, K, 3, s, s, dtype=torch.float32, device=dev)
        P = torch.empty_like(S)
        gamma = torch.empty_like(q)
        bad = torch.zeros(Bn, dtype=torch.bool, device=dev)
        bufs = _loop_buffers(rounds, K, s, dev)
        head = (*(x.data_ptr() for x in (*t, lam0, lam, iters, conv, eta, Qinv, Rinv,
                                         S, P, gamma, bad)),)
        global FUSED_LAUNCHES
        for rd in rounds:
            _build.launch(f"{FUSED_NAME} (cooperative, {rd.nprob} x {rd.per} CTAs)",
                          "gato_longk_fused", dev, *head, *_round_args(rd, bufs), nk,
                          K, s, cdim, float(rho), float(exit_tol), int(max_iters),
                          poly_degree, PRECOND_CODES[preconditioner],
                          int(rd.meet == "flags"))
            FUSED_LAUNCHES += 1
    return PCGResult(lam=lam, iters=iters, converged=conv, eta=eta), Qinv, Rinv


def recover_longk_cuda(Qinv, Rinv, A, B, q, r, lam):
    """Row 13: dz_x (B, K, s) and dz_u (B, K-1, c) from the multipliers and
    the condensation's inverses."""
    _check_args(RECOVER_NAME, q)
    if q.device.type == "cpu":
        return recover_longk_plain(Qinv, Rinv, A, B, q, r, lam)
    if q.ndim != 3:
        raise ValueError(f"{RECOVER_NAME}: q must be (B, K, s), got {tuple(q.shape)}")
    Bn, K, s = q.shape
    cdim = r.shape[-1]
    _check_widths(RECOVER_NAME, K, s, cdim)
    shapes = block_shapes((Bn,), K, s, cdim)
    dev = q.device
    t = [_build.checked(RECOVER_NAME, key, x, torch.Size(shapes[ref]), dev)
         for key, ref, x in (("Qinv", "Q", Qinv), ("Rinv", "R", Rinv), ("A", "A", A),
                             ("B", "B", B), ("q", "q", q), ("r", "r", r), ("lam", "q", lam))]
    dz_x = torch.empty_like(q)
    dz_u = torch.empty_like(r)
    if Bn > 0:
        _build.launch(RECOVER_NAME, "gato_longk_recover", dev,
                      *(x.data_ptr() for x in (*t, dz_x, dz_u)), Bn, K, s, cdim)
        global RECOVER_LAUNCHES
        RECOVER_LAUNCHES += 1
    return dz_x, dz_u


def _system(name: str, S, b):
    """(S (B, W, 3, s, s), b (B, W, s)) checked by ``_build.checked`` on b's
    device, W >= 2 and s <= MAX_BLOCK; returns (B, W, s, S, b)."""
    if S.ndim != 5 or b.ndim != 3:
        raise ValueError(f"{name}: S must be (B, W, 3, s, s) and b (B, W, s), got "
                         f"{tuple(S.shape)} and {tuple(b.shape)}")
    Bn, W, s = b.shape
    dev = b.device
    S = _build.checked(name, "S", S, (Bn, W, 3, s, s), dev)
    b = _build.checked(name, "b", b, (Bn, W, s), dev)
    if W < 2 or s > _build.MAX_BLOCK:
        raise ValueError(f"{name}: needs at least 2 rows and s <= {_build.MAX_BLOCK}; "
                         f"got W={W}, s={s}")
    return Bn, W, s, S, b


def cr_longk_cuda(S, gamma):
    """Row 11: S lam = gamma (S (B, K, 3, s, s), gamma (B, K, s)) by block
    cyclic reduction: the levels below :func:`cr_tail_stride` on the
    cooperative grid (one meeting a level), the rest of each problem on one
    CTA in shared memory, then the grid's back-substitution; up to three
    launches, one call.  Returns (lam, bad (B,)): ``bad`` where a used
    inversion clamped a zero pivot in a block whose diagonal is not all
    zero; lam is not poisoned."""
    _check_args(CR_NAME, gamma)
    if gamma.device.type == "cpu":
        return cr_longk_plain(S, gamma)
    if S.ndim != 5 or gamma.ndim != 3:
        raise ValueError(f"{CR_NAME}: S must be (B, K, 3, s, s) and gamma (B, K, s), "
                         f"got {tuple(S.shape)} and {tuple(gamma.shape)}")
    Bn, K, s = gamma.shape
    dev = gamma.device
    S = _build.checked(CR_NAME, "S", S, (Bn, K, 3, s, s), dev)
    gamma = _build.checked(CR_NAME, "gamma", gamma, (Bn, K, s), dev)
    if s > _build.MAX_BLOCK:
        raise ValueError(f"{CR_NAME}: needs s <= {_build.MAX_BLOCK}; got s={s}")
    lam = torch.empty_like(gamma)
    bad = torch.zeros(Bn, dtype=torch.int32, device=dev)
    if Bn > 0:
        ht = cr_tail_stride(K, s, _limits(dev)[1])
        W = bv = Dinv = None
        grid = 0
        if ht > 1:
            grid = _grid(CR_NAME, s, dev)
            W = torch.empty_like(S)
            bv = torch.empty_like(gamma)
            Dinv = torch.empty(Bn, K, s, s, dtype=torch.float32, device=dev)
        _build.launch(f"{CR_NAME} (tail stride {ht}, up to {grid} resident CTAs)",
                      "gato_longk_cr", dev, S.data_ptr(), gamma.data_ptr(), _ptr(W),
                      _ptr(bv), _ptr(Dinv), lam.data_ptr(), bad.data_ptr(), Bn, K, s,
                      ht, grid)
        global CR_LAUNCHES
        CR_LAUNCHES += 1
    return lam, bad != 0


def peel_longk_cuda(S, b):
    """Row 12: one compacting cyclic-reduction level of the W >= 2 rows of
    S (B, W, 3, s, s) and b (B, W, s), in two launches (the odd rows'
    inverses, then the even rows' reductions).  Returns (S' (B, ceil(W/2),
    3, s, s), b' (B, ceil(W/2), s), PeelLevel)."""
    _check_args(PEEL_NAME, b)
    if b.device.type == "cpu":
        return peel_longk_plain(S, b)
    Bn, W, s, S, b = _system(PEEL_NAME, S, b)
    dev = b.device
    we, wo = (W + 1) // 2, W // 2
    Sh = torch.empty(Bn, we, 3, s, s, dtype=torch.float32, device=dev)
    bh = torch.empty(Bn, we, s, dtype=torch.float32, device=dev)
    Doinv = torch.empty(Bn, wo, s, s, dtype=torch.float32, device=dev)
    flags = torch.empty(Bn, wo, dtype=torch.int32, device=dev)
    if Bn > 0:
        _build.launch(PEEL_NAME, "gato_longk_peel", dev,
                      *(t.data_ptr() for t in (S, b, Sh, bh, Doinv, flags)), Bn, W, s)
        global PEEL_LAUNCHES
        PEEL_LAUNCHES += 1
    return Sh, bh, PeelLevel(S, b, Doinv, flags != 0)


def unpeel_longk_cuda(x_half, level: PeelLevel):
    """The back-substitution of one peeled level: x (B, W, s) from the
    reduced system's solution x_half (B, ceil(W/2), s), knot-parallel."""
    _check_args(UNPEEL_NAME, x_half)
    if x_half.device.type == "cpu":
        return unpeel_longk_plain(x_half, level)
    Bn, W, s, S, b = _system(UNPEEL_NAME, level.S, level.b)
    dev = b.device
    x_half = _build.checked(UNPEEL_NAME, "x_half", x_half, (Bn, (W + 1) // 2, s), dev)
    Doinv = _build.checked(UNPEEL_NAME, "Doinv", level.Doinv, (Bn, W // 2, s, s), dev)
    x = torch.empty_like(b)
    if Bn > 0:
        _build.launch(UNPEEL_NAME, "gato_longk_unpeel", dev,
                      *(t.data_ptr() for t in (S, b, Doinv, x_half, x)), Bn, W, s)
        global UNPEEL_LAUNCHES
        UNPEEL_LAUNCHES += 1
    return x


# --------------------------------------------------------------------------
# The tier.


def solve_longk_batched(
    Q, R, A, B, q, r, c, lam0=None, *,
    rho: float = 0.0, exit_tol: float = 1e-6, max_iters: int = 100,
    poly_degree: int = 1, preconditioner: str = "symmetric_stair",
    force_tier: Optional[str] = None,
):
    """Whole batched solve (condense + PCG + recover) for long horizons.

    Arguments follow ``formats.KKTBlocks`` with a leading batch axis;
    returns (PCGResult with a batch axis, dz_x (B, K, s), dz_u (B, K-1, c)),
    the contract of ``gato_tpu.kernels.longk.solve_longk_batched``.  A
    problem whose condensation clamped a zero pivot in a live Q or R block
    reports iters = max_iters, converged False and eta = 1e30; the others
    are solved as if it were absent.

    ``force_tier`` ('fused_xl' | 'xl' | 'stream'), a test knob as in
    ``gato_tpu``: 'fused_xl' runs row 9 then row 13; 'xl' and 'stream' both
    run row 7, rows 8/10 and row 13, one route on this card (the TPU split
    them by VMEM).  None takes ``AUTO_TIER``."""
    if force_tier not in (None, *TIERS):
        raise ValueError(f"unknown force_tier {force_tier!r}; valid: {TIERS} "
                         "or None")
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    kw = dict(exit_tol=exit_tol, max_iters=max_iters, poly_degree=poly_degree)
    tier = force_tier or AUTO_TIER
    if tier == "fused_xl":
        res, Qinv, Rinv = fused_longk_cuda(Q, R, A, B, q, r, c, lam0, rho=rho,
                                           preconditioner=preconditioner, **kw)
    else:
        ops = condense_longk_cuda(Q, R, A, B, q, r, c, rho=rho,
                                  preconditioner=preconditioner)
        res = pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, lam0, ops.bad, **kw)
        Qinv, Rinv = ops.Qinv, ops.Rinv
    dz_x, dz_u = recover_longk_cuda(Qinv, Rinv, A, B, q, r, res.lam)
    return res, dz_x, dz_u


def solve_longk(Q, R, A, B, q, r, c, lam0=None, **kw):
    """Single-problem wrapper (the B=1 case of solve_longk_batched)."""
    res, dz_x, dz_u = solve_longk_batched(
        *(x.unsqueeze(0) for x in (Q, R, A, B, q, r, c)),
        None if lam0 is None else lam0.unsqueeze(0), **kw)
    return PCGResult(*(x[0] for x in res)), dz_x[0], dz_u[0]


def _hybrid(S, gamma):
    """'hybrid': :func:`hybrid_peels` row 12 levels, row 11 on what is
    left, then each level's back-substitution.  Returns (lam, bad) as
    :func:`cr_longk_cuda`, ``bad`` also where a peel clamped."""
    levels = []
    bad = torch.zeros(gamma.shape[0], dtype=torch.bool, device=gamma.device)
    for _ in range(hybrid_peels(S.shape[1])):
        S, gamma, level = peel_longk_cuda(S, gamma)
        bad = bad | level.bad.any(-1)
        levels.append(level)
    lam, bad_cr = cr_longk_cuda(S, gamma)
    for level in reversed(levels):
        lam = unpeel_longk_cuda(lam, level)
    return lam, bad | bad_cr


def solve_direct_longk_batched(
    Q, R, A, B, q, r, c, *, rho: float = 0.0, force_tier: Optional[str] = None,
):
    """Whole batched exact solve for long horizons: row 7's condensation
    (with the scalar Jacobi branch, whose preconditioner is unused), block
    cyclic reduction of S lambda = gamma, the true residual, row 13's
    recovery.

    Arguments follow ``formats.KKTBlocks`` with a leading batch axis;
    returns (PCGResult with a batch axis: iters = 0, eta the squared true
    residual, converged = direct.residual_converged(eta, ||gamma||^2);
    dz_x (B, K, s), dz_u (B, K-1, c)), the contract of
    ``gato_tpu.kernels.longk.solve_direct_longk_batched``.  A problem whose
    condensation clamped a zero pivot in a live Q or R block gets eta +=
    1e30; one whose reduction did (an odd row of a level or the root) gets
    1e30 added to its lambda and its eta.  Either way it reports converged
    False and its outputs stay finite; the other problems are solved as if
    it were absent.

    ``force_tier`` ('xl' | 'hybrid' | 'xla'), gato_tpu's test knob: 'xl'
    runs row 11 on the whole operator; 'hybrid' peels
    :func:`hybrid_peels` levels with row 12 before it and
    back-substitutes them after; 'xla' is the plain PyTorch cyclic
    reduction (``cr_longk_plain``) on the condensed operator, on any
    device.  None takes :func:`direct_tier`."""
    if force_tier not in (None, *DIRECT_TIERS):
        raise ValueError(
            f"force_tier={force_tier!r}; valid direct tiers are 'xl' (row 11 "
            "alone), 'hybrid' (row 12 peels, then row 11) and 'xla' (the plain "
            "PyTorch cyclic reduction)")
    Bn, K = q.shape[:2]
    tier = force_tier or direct_tier(Bn, K)
    ops = condense_longk_cuda(Q, R, A, B, q, r, c, rho=rho, preconditioner="jacobi")
    if tier == "xl":
        x, bad = cr_longk_cuda(ops.S, ops.gamma)
    elif tier == "hybrid":
        x, bad = _hybrid(ops.S, ops.gamma)
    else:
        x, bad = cr_longk_plain(ops.S, ops.gamma)
    eta, gamma_sq = residual_norms(ops.S, ops.gamma, x)
    poison = torch.where(bad, direct_fused.POISON_ETA, 0.0).to(x.dtype)
    eta = eta + torch.where(bad | ops.bad, direct_fused.POISON_ETA, 0.0).to(eta.dtype)
    lam = x + poison[:, None, None]
    dz_x, dz_u = recover_longk_cuda(ops.Qinv, ops.Rinv, A, B, q, r, lam)
    res = PCGResult(lam=lam, iters=torch.zeros(Bn, dtype=torch.int32, device=q.device),
                    converged=residual_converged(eta, gamma_sq), eta=eta)
    return res, dz_x, dz_u


def solve_direct_longk(Q, R, A, B, q, r, c, **kw):
    """Single-problem wrapper (the B=1 case of solve_direct_longk_batched)."""
    res, dz_x, dz_u = solve_direct_longk_batched(
        *(x.unsqueeze(0) for x in (Q, R, A, B, q, r, c)), **kw)
    return PCGResult(*(x[0] for x in res)), dz_x[0], dz_u[0]

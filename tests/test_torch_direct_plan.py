"""The launch plans of rows 5 and 11 (kernels/thomas_batch.py and
kernels/longk.py, mirrors of csrc/thomas_batch.cu and csrc/longk_direct.cu)
and float64 models of their schedules, on the CPU.

(a) Row 5: the condensation tiles cover [0, K) once, each tile's window is
one Gauss-Jordan round (so its per-knot flags are the round's), and the
walks' CTAs cover the batch within the shared memory.  A NumPy model of one
warp's walk holds the lanes' layout: column J of [Dhat_j | I] in lane J mod
32, slot J / 32, Dhat's columns at P and the identity's at the other half,
P alternating from knot to knot, the blocks padded to the walk's width (14,
16 or 32); M_j's columns shuffled round the warp; the Gauss-Jordan reading
the pivot column from lane P + i; the ring slot j mod 4 holding knot j when
it is walked.  It must give thomas_fwd_plain's Cinv
and bhat in float64 (1e-9), non-finite exactly where the plain version's
poison is.

(b) Row 11: the tail stride (the rows k = 0 mod ht that fit one CTA's
shared memory), the group sizes of the grid levels, and a model of the
schedule: a grid level of few rows one meeting, each even row's group
inverting its odd neighbours and owning its right one, a level of many two
meetings (a warp an odd row, then a warp an even row); either way each odd
row's D^{-1} written once,
the tail's levels, root and back-substitution in its own index space, then
the grid's back levels.  It must give cr_longk_plain's solution in float64
(1e-9 relative) and its flags.  The library's copies of the plan functions
are compared with these on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import gato_tpu_torch as gt
from gato_tpu_torch import testing as tt
from gato_tpu_torch.blocktri import block_inv_flag
from gato_tpu_torch.kernels import longk as kl
from gato_tpu_torch.kernels import thomas_batch as kt

torch.set_num_threads(1)

H100_SMS = 132
LIMIT = 232448 - 1024
RHO = 1e-3


# ---- (a) row 5 ----

@pytest.mark.parametrize("sizes", [(14, 7), (20, 9), (32, 32), (2, 1), (5, 7)])
@pytest.mark.parametrize("K", [2, 3, 50, 741, 1024])
@pytest.mark.parametrize("B", [1, 15, 16, 256, 4096])
def test_thomas_plan_covers_the_knots_and_the_batch(sizes, K, B):
    s, c = sizes
    nk, walks = kt.fwd_plan(B, K, s, c, H100_SMS, LIMIT)
    covered = []
    for tile in range(-(-K // nk)):
        k0, k1 = kl.tile_range(K, nk, tile)
        covered += range(k0, k1)
    assert covered == list(range(K))
    threads = kl.tile_threads(nk, s, c)
    # The window (nk + 3 knots, nk + 2 intervals) is one Gauss-Jordan round.
    assert threads // s >= nk + 3 and threads // c >= nk + 2
    assert kl.tile_plan(nk, s, c).total * 4 <= LIMIT
    assert 1 <= walks <= kt.MAX_WALKS and kt.walk_smem_bytes(s, walks) <= LIMIT
    assert -(-B // walks) * walks >= B


def warp_walk(phi, theta, gamma, knot_bad, kN):
    """One warp's walk (thomas_batch.cu's walk_step and walk_knot), lane by
    lane in float64, on blocks padded to kN (phi and gamma with zeros,
    theta with the identity); returns Cinv (K, n, n) and bhat (K, n)."""
    K, n = gamma.shape
    kC = (2 * kN + 31) // 32
    lanes = np.arange(32)
    PH = np.zeros((K, kN, kN))
    TH = np.tile(np.eye(kN), (K, 1, 1))
    GM = np.zeros((K, kN))
    PH[:, :n, :n], TH[:, :n, :n], GM[:, :n] = phi, theta, gamma
    col = np.zeros((32, kC, kN))
    bh = np.zeros((32, kN))
    Cinv, bhat = np.zeros((K, n, n)), np.zeros((K, n))
    ring = [j if j < K else None for j in range(kt.WALK_RING)]
    for j in range(K):
        assert ring[j % kt.WALK_RING] == j
        ph, th, gm = PH[j], TH[j], GM[j]
        P = 0 if j % 2 == 0 else kN
        Q = (P + kN) % (2 * kN)
        sP, sQ, lP, lQ = P // 32, Q // 32, P % 32, Q % 32
        cP, cQ = lanes - lP, lanes - lQ
        ownP, ownQ = (cP >= 0) & (cP < kN), (cQ >= 0) & (cQ < kN)
        cc = np.where(ownP, cP, 0)
        bc = np.zeros((32, kN))
        if j == 0:
            col[:, sP] = th[:, cc].T
            bc[:] = gm
        else:
            m = col[:, sP] @ ph.T                     # lane l: phi_j col[l]
            shuffled = m[lP:lP + kN]                  # M's column e, from lane lP + e
            col[:, sP] = th[:, cc].T - ph[cc] @ shuffled
            bc[:] = gm - bh @ shuffled
        for k in range(kC):
            for lane in range(32):
                if k == sQ and ownQ[lane]:
                    col[lane, k] = 0
                    col[lane, k, cQ[lane]] = 1
                elif not (k == sP and ownP[lane]):
                    col[lane, k] = 0
        live = any(col[lane, sP, cP[lane]] != 0 for lane in lanes[ownP & (cP < n)])
        zero = False
        for i in range(kN):
            piv = col[lP + i, sP, i]
            zero |= piv == 0
            rv = col[:, :, i] * (1.0 / (piv if piv != 0 else 1.0))
            f = col[lP + i, sP, :].copy()
            for r in range(kN):
                if r != i:
                    col[:, :, r] -= f[r] * rv
            col[:, :, i] = rv
        add = np.inf if knot_bad[j] or (zero and live) else 0.0
        bh = np.where(np.arange(kN) < n, bc + add, 0.0)
        bhat[j] = bh[0, :n]
        for lane in lanes[ownQ & (cQ < n)]:
            Cinv[j, :, cQ[lane]] = col[lane, sQ, :n]
        if j + kt.WALK_RING < K:
            ring[j % kt.WALK_RING] = j + kt.WALK_RING
    return Cinv, bhat


@pytest.mark.parametrize("spec", [(14, 7, 9), (16, 5, 6), (20, 9, 7), (32, 32, 4), (3, 2, 2),
                                  (5, 7, 5)])
def test_warp_walk_model_matches_the_plain_forward(spec):
    kN = kt.walk_width(spec[0])
    sp = gt.ProblemSpec(*spec)
    b = gt.blocks_to_torch(tt.random_batch(sp, 1, seed0=5), "cpu", torch.float64)
    f = kt.thomas_fwd_plain(*b, rho=RHO)
    knot_bad = np.zeros(spec[2], dtype=bool)
    Cinv, bhat = warp_walk(*(t[0].numpy() for t in (f.phi, f.theta, f.gamma)), knot_bad, kN)
    np.testing.assert_allclose(Cinv, f.Cinv[0].numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(bhat, f.bhat[0].numpy(), rtol=1e-9, atol=1e-9)


def test_warp_walk_model_poisons_where_the_plain_forward_does():
    """A zero row and column in Q[2] at rho = 0: the knot's flag (from the
    tile) poisons bhat_2 on, as the plain version's does."""
    sp = gt.ProblemSpec(4, 2, 6)
    b = gt.blocks_to_torch(tt.singular_blocks(sp, seed=3, knot=2), "cpu")
    b = gt.KKTBlocks(*(a.double()[None] for a in b))
    f = kt.thomas_fwd_plain(*b, rho=0.0)
    flags = block_inv_flag(b.Q[0])[1].numpy()
    Cinv, bhat = warp_walk(*(t[0].numpy() for t in (f.phi, f.theta, f.gamma)), flags,
                           kt.walk_width(4))
    ref = f.bhat[0].numpy()
    assert not np.isfinite(bhat[2:]).all() and np.isfinite(bhat[:2]).all()
    np.testing.assert_array_equal(np.isfinite(bhat), np.isfinite(ref))
    np.testing.assert_allclose(bhat[:2], ref[:2], rtol=1e-9)


# ---- (b) row 11 ----

@pytest.mark.parametrize("s", [2, 14, 20, 32])
@pytest.mark.parametrize("K", [1, 2, 3, 50, 71, 72, 741, 1024, 1025, 8192])
def test_cr_tail_stride_fits_and_is_the_least(s, K):
    ht = kl.cr_tail_stride(K, s, LIMIT)
    rows = (K - 1) // ht + 1
    assert ht & (ht - 1) == 0
    assert kl.cr_tail_floats(rows, s) * 4 <= LIMIT
    if ht > 1:
        assert kl.cr_tail_floats((K - 1) // (ht // 2) + 1, s) * 4 > LIMIT
    assert kl.cr_grid_floats(s) * 4 <= LIMIT


def test_cr_tail_stride_at_iiwa():
    assert [kl.cr_tail_stride(K, 14, LIMIT) for K in (50, 71, 72, 741, 1024, 8192)] == [
        1, 1, 2, 16, 16, 128]


@pytest.mark.parametrize("tasks,warps", [(1, 8), (512, 4224), (513, 4224), (61440, 4224),
                                         (30, 256), (4224, 4224)])
def test_cr_groups_take_every_task_once(tasks, warps):
    G = kl.cr_group_warps(tasks, warps)
    assert G in (1, 2, 4, 8)
    assert G == 1 or tasks * G <= warps
    grid = warps // kl.CR_WARPS
    per_cta = kl.CR_WARPS // G
    seen = np.zeros(tasks, dtype=int)
    for cta in range(grid):
        for g in range(per_cta):
            seen[cta * per_cta + g::grid * per_cta] += 1
    assert (seen == 1).all()


def _inv(D):
    return block_inv_flag(D)


def cr_model(S, gamma, ht, warps=4224):
    """cr_longk_cuda's schedule in torch ops on ``warps`` resident warps:
    returns (x, bad, Dinv writes per (problem, row))."""
    B, K, _, s, _ = S.shape
    W, bv = S.clone(), gamma.clone()
    Dinv = torch.zeros(B, K, s, s, dtype=S.dtype)
    writes = torch.zeros(B, K, dtype=torch.int64)
    bad = torch.zeros(B, dtype=torch.bool)
    x = torch.zeros_like(gamma)
    src, bsrc = S, gamma
    h = 1
    while h < ht:
        h2, n_even = 2 * h, (K - 1) // (2 * h) + 1
        snap, bsnap = src.clone(), bsrc.clone()
        two = kl.cr_group_warps(B * n_even, warps) == 1
        if two:  # a warp inverts each odd row into Dinv, then a grid barrier
            for b in range(B):
                for k in range(h, K, h2):
                    Dinv[b, k], f = _inv(snap[b, k, 1])
                    bad[b] |= bool(f)
                    writes[b, k] += 1
                    if h == 1:
                        W[b, k, 0], W[b, k, 2] = snap[b, k, 0], snap[b, k, 2]
                        bv[b, k] = bsnap[b, k]
        for t in range(B * n_even):
            b, k = t // n_even, (t % n_even) * h2
            hl, hr = k >= h, k + h < K
            DL = DR = None
            if two:
                DL = Dinv[b, k - h] if hl else None
                DR = Dinv[b, k + h] if hr else None
            else:
                if hl:
                    DL, f = _inv(snap[b, k - h, 1])
                    bad[b] |= bool(f)
                if hr:  # the owner of the right neighbour
                    DR, f = _inv(snap[b, k + h, 1])
                    bad[b] |= bool(f)
                    Dinv[b, k + h] = DR
                    writes[b, k + h] += 1
                    if h == 1:
                        W[b, k + h, 0], W[b, k + h, 2] = snap[b, k + h, 0], snap[b, k + h, 2]
                        bv[b, k + h] = bsnap[b, k + h]
            L, D, U, bb = snap[b, k, 0], snap[b, k, 1], snap[b, k, 2], bsnap[b, k]
            A = L @ DL if hl else torch.zeros_like(D)
            Bm = U @ DR if hr else torch.zeros_like(D)
            Lp = -(A @ snap[b, k - h, 0]) if hl else torch.zeros_like(D)
            Up = -(Bm @ snap[b, k + h, 2]) if hr else torch.zeros_like(D)
            Dp = D - (A @ snap[b, k - h, 2] if hl else 0) - (Bm @ snap[b, k + h, 0] if hr else 0)
            bp = bb - (A @ bsnap[b, k - h] if hl else 0) - (Bm @ bsnap[b, k + h] if hr else 0)
            W[b, k, 0], W[b, k, 1], W[b, k, 2], bv[b, k] = Lp, Dp, Up, bp
        src, bsrc = W, bv
        h *= 2
    # The tail, in its own index space i (row k = i ht).
    rows = (K - 1) // ht + 1
    T = src[:, ::ht].clone()
    tb, tx = bsrc[:, ::ht].clone(), torch.zeros(B, rows, s, dtype=S.dtype)
    for b in range(B):
        hh = 1
        while hh < rows:
            h2 = 2 * hh
            for i in range(hh, rows, h2):
                T[b, i, 1], f = _inv(T[b, i, 1])
                bad[b] |= bool(f)
            AB = {}
            for i in range(0, rows, h2):
                AB[i] = (T[b, i, 0] @ T[b, i - hh, 1] if i >= hh else None,
                         T[b, i, 2] @ T[b, i + hh, 1] if i + hh < rows else None)
            for i in range(0, rows, h2):
                A, Bm = AB[i]
                L, D, U, bb = T[b, i, 0], T[b, i, 1], T[b, i, 2], tb[b, i]
                Lp, Up, Dp, bp = torch.zeros_like(D), torch.zeros_like(D), D, bb
                if A is not None:
                    Lp = -(A @ T[b, i - hh, 0])
                    Dp = Dp - A @ T[b, i - hh, 2]
                    bp = bp - A @ tb[b, i - hh]
                if Bm is not None:
                    Up = -(Bm @ T[b, i + hh, 2])
                    Dp = Dp - Bm @ T[b, i + hh, 0]
                    bp = bp - Bm @ tb[b, i + hh]
                T[b, i, 0], T[b, i, 1], T[b, i, 2], tb[b, i] = Lp, Dp, Up, bp
            hh = h2
        T[b, 0, 1], f = _inv(T[b, 0, 1])
        bad[b] |= bool(f)
        tx[b, 0] = T[b, 0, 1] @ tb[b, 0]
        hh //= 2
        while hh >= 1:
            for i in range(hh, rows, 2 * hh):
                r = tb[b, i] - T[b, i, 0] @ tx[b, i - hh]
                if i + hh < rows:
                    r = r - T[b, i, 2] @ tx[b, i + hh]
                tx[b, i] = T[b, i, 1] @ r
            hh //= 2
    x[:, ::ht] = tx
    h = ht // 2
    while h >= 1:
        for b in range(B):
            for k in range(h, K, 2 * h):
                r = bv[b, k] - W[b, k, 0] @ x[b, k - h]
                if k + h < K:
                    r = r - W[b, k, 2] @ x[b, k + h]
                x[b, k] = Dinv[b, k] @ r
        h //= 2
    return x, bad, writes


@pytest.mark.parametrize("K,ht,warps", [(1, 1, 4224), (2, 1, 4224), (7, 1, 4224),
                                        (50, 1, 4224), (9, 2, 4224), (50, 4, 4224),
                                        (50, 4, 16), (71, 8, 24), (72, 2, 4224),
                                        (131, 16, 64), (741, 16, 4224), (1024, 16, 4224),
                                        (1025, 16, 256), (1024, 128, 2112)])
def test_cr_schedule_model_matches_the_plain_reduction(K, ht, warps):
    """The schedule at IIWA widths (and forced tail strides and resident
    warps, so that levels take one meeting or two), two problems, float64:
    the plain cyclic reduction's solution and flags, each grid level's odd
    row's D^{-1} written once."""
    spec = gt.ProblemSpec(14, 7, K) if K >= 2 else None
    if spec is None:
        S = torch.randn(2, 1, 3, 14, 14, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
        S[:, :, 1] = S[:, :, 1] @ S[:, :, 1].transpose(-1, -2) + 14 * torch.eye(14)
        gamma = torch.randn(2, 1, 14, dtype=torch.float64)
    else:
        b = gt.blocks_to_torch(tt.random_batch(spec, 2, seed0=7), "cpu", torch.float64)
        ops = kl.condense_longk_plain(*b, rho=RHO, preconditioner="jacobi")
        S, gamma = ops.S, ops.gamma
    x, bad, writes = cr_model(S, gamma, ht, warps)
    xp, badp = kl.cr_longk_plain(S, gamma)
    scale = float(xp.abs().max())
    assert float((x - xp).abs().max()) <= 1e-9 * scale
    assert bad.tolist() == badp.tolist() == [False, False]
    want = torch.zeros(K, dtype=torch.int64)
    h = 1
    while h < ht:
        want[h::2 * h] = 1
        h *= 2
    assert torch.equal(writes, want.expand(2, K))


def test_cr_schedule_model_flags_a_zero_pivot_alone():
    """A zero pivot in problem 1's odd row 5 at K = 50 through a grid level
    (ht = 4) and in the tail alone (ht = 1): problem 1 flagged, as plain."""
    spec = gt.ProblemSpec(14, 7, 50)
    b = gt.blocks_to_torch(tt.random_batch(spec, 2, seed0=9), "cpu", torch.float64)
    ops = kl.condense_longk_plain(*b, rho=RHO, preconditioner="jacobi")
    S = ops.S.clone()
    S[1, 5, 1, 0, :] = 0.0
    S[1, 5, 1, :, 0] = 0.0
    assert kl.cr_longk_plain(S, ops.gamma)[1].tolist() == [False, True]
    for ht, warps in ((1, 4224), (4, 4224), (4, 16)):
        assert cr_model(S, ops.gamma, ht, warps)[1].tolist() == [False, True]

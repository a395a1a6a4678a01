"""Rows 6 and 12's launch plans (kernels/thomas_batch.py and kernels/longk.py,
mirrors of csrc/thomas_batch.cu and csrc/longk_direct.cu) and float64 NumPy
models of their schedules, against gato_tpu on the CPU.

(a) Row 6: one warp walks a problem back, lane a on row a (lanes past the
padded width kN repeat rows), x_{j+1} shuffled to the lanes, Cinv_j,
phi_{j+1} and bhat_j read from ring slot i mod 8 (step i walks knot
K - 1 - i) at a row stride of 14 or kN + 1 with zero padding; then the
epilogue, a warp a knot and four knots a CTA, sums ||res_j||^2 and
||gamma_j||^2 by the warp's tree, its CTA's knots in order, and the
problem's tiles lane by lane (tiles l, l + 32, ...) then by the tree.  The
model must give thomas_rev_plain's lambda, dz and eta in float64 (1e-9 of
scale; eta within 1e-10 (1 + ||gamma||^2)) and gato_tpu's
solve_direct_thomas_batched (its Pallas kernels in interpret mode) within
tests/test_torch_direct.py's tolerance (rtol 1e-4, atol 1e-5 of scale),
converged equal; an exactly singular problem is non-finite alone.

(b) Row 12: the peel's two launches (a warp an odd row's inverse, then a
warp an even row's reduction from its staged rows) write every output
once, all ceil(W/2) reduced rows included; the model of the level's
algebra (warp_gj_pad's Gauss-Jordan, warp_reduce_rows' products) and of
the unpeel must give gato_tpu's XLA
reference peel _cr_peel and its back-substitution _cr_unpeel within 1e-5
of scale (tests/test_torch_longk_direct.py's peel tolerance) at W = 2, 3,
400 and 1536 (past gato_tpu's peel kernel's tail fault, so held against
_cr_peel, not _peel_call), the flags per odd row included.

(c) The plan mirrors at their edges: walks a CTA, ring and epilogue bytes,
the epilogue's and the peel's grids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.kernels import longk as jlk
from gato_tpu.kernels import thomas_batch as jtb

import gato_tpu_torch as gt
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import longk as kl
from gato_tpu_torch.kernels import thomas_batch as kt

torch.set_num_threads(1)

H100_SMS = 132
LIMIT = 232448 - 1024
RTOL_SQ = 1e-6      # direct.residual_converged's DIRECT_CONV_RTOL ** 2


def warp_sum(v):
    """pcg_common.cuh's warp_sum: a shuffle-down tree over 32 lanes, the
    total in lane 0."""
    v = np.array(v, dtype=np.float64)
    for off in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[off:], np.zeros(off)])
    return v[0]


# ---- (a) row 6 ----

def rev_walk(Cinv, bhat, phi, kN):
    """One warp's reverse walk of one problem (thomas_rev_walk_kernel):
    lambda (K, n)."""
    K, n = bhat.shape
    ld = 14 if kN == 14 else kN + 1
    CI, PH, BH = (np.zeros((K, kN, ld)), np.zeros((K, kN, ld)), np.zeros((K, kN)))
    CI[:, :n, :n], PH[:, :n, :n], BH[:, :n] = Cinv, phi, bhat
    ring = [K - 1 - i if K - 1 - i >= 0 else None for i in range(kt.REV_RING)]
    rows = np.arange(32) % kN
    lam = np.zeros((K, n))
    x = np.zeros(32)
    with np.errstate(invalid="ignore"):
        for i in range(K):
            j = K - 1 - i
            slot = i % kt.REV_RING
            assert ring[slot] == j
            rhs = BH[j, rows]
            if i > 0:
                u = np.zeros(32)
                for e in range(kN):
                    u = u + PH[j + 1, e, rows] * x[e]       # x[e]: lane e's, by shuffle
                rhs = rhs - u
            xj = np.zeros(32)
            for e in range(kN):
                xj = xj + CI[j, rows, e] * rhs[e]
            x = xj
            lam[j] = x[:n]
            ring[slot] = j - kt.REV_RING if j - kt.REV_RING >= 0 else None
    return lam


def rev_epilogue(f, q, A, B, r, lam):
    """thomas_rev_epilogue_kernel on one problem: (dz_x, dz_u, eta,
    converged), the sums in the kernel's order."""
    K, n = q.shape
    c = r.shape[-1]
    dz_x, dz_u = np.zeros((K, n)), np.zeros((K - 1, c))
    tiles = kt.epi_tiles(K)
    part = np.zeros((tiles, 2))
    with np.errstate(invalid="ignore"):
        for t in range(tiles):
            red = np.zeros((kt.EPI_KNOTS, 2))
            for w in range(kt.EPI_KNOTS):
                j = t * kt.EPI_KNOTS + w
                if j >= K:
                    continue
                x0 = lam[j]
                xm = lam[j - 1] if j > 0 else np.zeros(n)
                xp = lam[j + 1] if j + 1 < K else np.zeros(n)
                tx = f.theta[j] @ x0
                px = f.phi[j] @ xm if j > 0 else 0.0
                u = f.phi[j + 1].T @ xp if j + 1 < K else 0.0
                at = A[j].T @ xp if j + 1 < K else 0.0
                res = ((f.gamma[j] - tx) - u) - px
                dz_x[j] = f.Qinv[j] @ ((q[j] - x0) - at)
                if j + 1 < K:
                    dz_u[j] = f.Rinv[j] @ (r[j] - B[j].T @ xp)
                lanes = np.zeros((2, 32))
                lanes[0, :n], lanes[1, :n] = res * res, f.gamma[j] ** 2
                red[w] = warp_sum(lanes[0]), warp_sum(lanes[1])
            for w in range(kt.EPI_KNOTS):
                part[t] += red[w]
        lanes = np.zeros((2, 32))
        for lane in range(32):
            for k in range(lane, tiles, 32):
                lanes[:, lane] += part[k]
    eta, g2 = warp_sum(lanes[0]), warp_sum(lanes[1])
    return dz_x, dz_u, eta, bool(eta <= RTOL_SQ * (1 + g2))


def rev_model(f, q, A, B, r):
    """Row 6 on a batch: (lam, dz_x, dz_u, eta, converged), float64."""
    np64 = [x.double().numpy() for x in (*f, q, A, B, r)]
    f = kt.ThomasFactors(*np64[:7])
    q, A, B, r = np64[7:]
    kN = kt.walk_width(q.shape[-1])
    out = []
    for p in range(q.shape[0]):
        fp = kt.ThomasFactors(*(x[p] for x in f))
        lam = rev_walk(fp.Cinv, fp.bhat, fp.phi, kN)
        out.append((lam, *rev_epilogue(fp, q[p], A[p], B[p], r[p], lam)))
    return [np.array(col) for col in zip(*out)]


def _close(ours, ref, rtol, atol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("sizes", [(3, 2, 2), (3, 2, 3), (3, 2, 17), (3, 2, 50),
                                   (14, 7, 50)])
@pytest.mark.parametrize("Bn", [1, 3])
def test_rev_model_matches_the_plain_reverse_and_gato_tpu(sizes, Bn):
    bb = tt.random_batch(gt.ProblemSpec(*sizes), Bn, seed0=70)
    b64 = gt.KKTBlocks(*(a.double() for a in gt.blocks_to_torch(bb, "cpu")))
    f = kt.thomas_fwd_plain(*b64, rho=1e-2)
    lam, dzx, dzu, eta, conv = rev_model(f, b64.q, b64.A, b64.B, b64.r)
    ref, rx, ru = kt.thomas_rev_plain(f, b64.q, b64.A, b64.B, b64.r)
    for x, y in ((lam, ref.lam), (dzx, rx), (dzu, ru)):
        _close(x, y.numpy(), 1e-9, 1e-9)
    g2 = (f.gamma ** 2).sum((-2, -1)).numpy()
    assert np.all(np.abs(eta - ref.eta.numpy()) <= 1e-10 * (1 + g2))
    assert conv.tolist() == ref.converged.tolist() == [True] * Bn
    jres, jx, ju = jtb.solve_direct_thomas_batched(
        *[jnp.asarray(np.asarray(a)) for a in bb], rho=1e-2)
    assert np.asarray(jres.converged).tolist() == conv.tolist()
    for x, y in ((lam, jres.lam), (dzx, jx), (dzu, ju)):
        _close(x, y, 1e-4, 1e-5)


def test_rev_model_confines_a_singular_problem():
    """An exactly singular problem (zero row and column in Q[2], rho = 0):
    row 5's +inf in its bhat turns its lambda, dz and eta non-finite in the
    model, converged False, and the others are what they are alone, as in
    thomas_rev_plain and gato_tpu."""
    spec = gt.ProblemSpec(3, 2, 7)
    good = [tt.random_blocks(spec, seed=s) for s in (1, 2, 4)]
    mix = tt.stack_blocks(good[:1] + [tt.singular_blocks(spec, seed=3, knot=2)] + good[1:])
    b64 = gt.KKTBlocks(*(a.double() for a in gt.blocks_to_torch(mix, "cpu")))
    f = kt.thomas_fwd_plain(*b64, rho=0.0)
    lam, dzx, dzu, eta, conv = rev_model(f, b64.q, b64.A, b64.B, b64.r)
    assert conv.tolist() == [True, False, True, True]
    for x in (lam[1], dzx[1], dzu[1], eta[1]):
        assert not np.isfinite(x).any()
    keep = [0, 2, 3]
    a64 = gt.KKTBlocks(*(a.double() for a in gt.blocks_to_torch(tt.stack_blocks(good), "cpu")))
    alone = rev_model(kt.thomas_fwd_plain(*a64, rho=0.0), a64.q, a64.A, a64.B, a64.r)
    for x, y in zip((lam, dzx, dzu, eta), alone):
        np.testing.assert_array_equal(x[keep], y)
    ref, rx, ru = kt.thomas_rev_plain(f, b64.q, b64.A, b64.B, b64.r)
    assert ref.converged.tolist() == conv.tolist()
    jres = jtb.solve_direct_thomas_batched(*[jnp.asarray(np.asarray(a)) for a in mix],
                                           rho=0.0)[0]
    assert np.asarray(jres.converged).tolist() == conv.tolist()
    _close(lam[keep], np.asarray(jres.lam)[keep], 1e-4, 1e-5)


def test_rev_model_pads_the_wide_widths():
    """s = 5 and 20 walk at kN = 16 and 32 (row stride 17 and 33), with the
    plain reverse's lambda."""
    for sizes in ((5, 3, 9), (20, 9, 6)):
        b64 = gt.KKTBlocks(*(a.double() for a in gt.blocks_to_torch(
            tt.random_batch(gt.ProblemSpec(*sizes), 2, seed0=71), "cpu")))
        f = kt.thomas_fwd_plain(*b64, rho=1e-2)
        lam = rev_model(f, b64.q, b64.A, b64.B, b64.r)[0]
        ref = kt.thomas_rev_plain(f, b64.q, b64.A, b64.B, b64.r)[0]
        _close(lam, ref.lam.numpy(), 1e-9, 1e-9)


# ---- (b) row 12 ----

def gj_pad(M, kN):
    """warp_gj_pad: Gauss-Jordan on [M | I] padded to kN with the identity,
    no pivoting, the pivot row scaled by the reciprocal of the pivot, a zero
    pivot taken as 1.  Returns (M^{-1}, flag)."""
    n = M.shape[0]
    col = np.eye(kN, 2 * kN, kN)
    col[:, :kN] = np.eye(kN)
    col[:n, :n] = M
    col[:n, kN:kN + n] = np.eye(n)
    live = bool(np.any(np.diag(M) != 0))
    zero = False
    for i in range(kN):
        piv = col[i, i]
        zero |= piv == 0
        rv = col[i] * (1.0 / (piv if piv != 0 else 1.0))
        f = col[:, i].copy()
        for rr in range(kN):
            if rr != i:
                col[rr] -= f[rr] * rv
        col[i] = rv
    return col[:n, kN:kN + n], zero and live


def reduce_row(row, lft, rgt, DinvL, DinvR):
    """warp_reduce_rows / group_reduce on one even row: (L', D', U', b')."""
    (L, D, U), b = row
    A = L @ DinvL if lft is not None else np.zeros_like(D)
    Bm = U @ DinvR if rgt is not None else np.zeros_like(D)
    zero = np.zeros_like(D)
    (Ll, _, Ul), bl = lft if lft is not None else ((zero, zero, zero), np.zeros_like(b))
    (Lr, _, Ur), br = rgt if rgt is not None else ((zero, zero, zero), np.zeros_like(b))
    return -(A @ Ll), (D - A @ Ul) - Bm @ Lr, -(Bm @ Ur), (b - A @ bl) - Bm @ br


def peel_model(S, b):
    """Row 12 on (B, W, 3, s, s), (B, W, s), its two launches' writes
    counted; returns (S', b', Doinv, flags, writes)."""
    Bn, W, _, s, _ = S.shape
    kN = 14 if s == 14 else (16 if s <= 16 else 32)
    we, wo = (W + 1) // 2, W // 2
    Sh, bh = np.zeros((Bn, we, 3, s, s)), np.zeros((Bn, we, s))
    Doinv, flags = np.zeros((Bn, wo, s, s)), np.zeros((Bn, wo), bool)
    writes = {"S'": np.zeros((Bn, we), int), "Doinv": np.zeros((Bn, wo), int)}

    def rows(p, k):
        return (S[p, k, 0], S[p, k, 1], S[p, k, 2]), b[p, k]

    blocks_inv, blocks_red = kl.peel_grid(Bn, W)
    assert blocks_inv * kl.CR_WARPS >= Bn * wo > (blocks_inv - 1) * kl.CR_WARPS
    per = kl.PEEL_THREADS // 32
    assert blocks_red * per >= Bn * we > (blocks_red - 1) * per
    for t in range(Bn * wo):                # launch 1: a warp an odd row
        p, j = divmod(t, wo)
        Doinv[p, j], flags[p, j] = gj_pad(S[p, 2 * j + 1, 1], kN)
        writes["Doinv"][p, j] += 1
    for t in range(Bn * we):                # launch 2: a warp an even row
        p, j = divmod(t, we)
        hl, hr = j >= 1, j < wo
        out = reduce_row(rows(p, 2 * j), rows(p, 2 * j - 1) if hl else None,
                         rows(p, 2 * j + 1) if hr else None,
                         Doinv[p, j - 1] if hl else None, Doinv[p, j] if hr else None)
        Sh[p, j], bh[p, j] = np.stack(out[:3]), out[3]
        writes["S'"][p, j] += 1
    return Sh, bh, Doinv, flags, writes


def unpeel_model(xh, S, b, Doinv):
    """unpeel_kernel: a warp an even row j, x_{2j} = xh_j and the odd row
    after it from its staged blocks."""
    Bn, W = b.shape[:2]
    we, wo = (W + 1) // 2, W // 2
    x = np.full(b.shape, np.nan)
    for t in range(Bn * we):
        p, j = divmod(t, we)
        x[p, 2 * j] = xh[p, j]
        if j < wo:
            xr = S[p, 2 * j + 1, 2] @ xh[p, j + 1] if j + 1 < we else 0.0
            x[p, 2 * j + 1] = Doinv[p, j] @ ((b[p, 2 * j + 1] - S[p, 2 * j + 1, 0] @ xh[p, j])
                                             - xr)
    assert not np.isnan(x).any()
    return x


def _lanes(S, b, sp, Kp):
    """(K, 3, s, s), (K, s) -> gato_tpu's lane layout (3, s, sp, Kp), (sp, Kp)."""
    K, _, s, _ = S.shape
    Sp = np.zeros((3, s, sp, Kp), np.float32)
    Sp[:, :, :s, :K] = np.transpose(S, (1, 3, 2, 0))
    bp = np.zeros((sp, Kp), np.float32)
    bp[:s, :K] = b.T
    return jnp.asarray(Sp), jnp.asarray(bp)


def _blocks(M, s, n):
    """(s, sp, W) one-slot lane stack -> (n, s, s) blocks."""
    return np.transpose(np.asarray(M)[:, :s, :n], (2, 1, 0))


@pytest.mark.parametrize("W", [2, 3, 400, 1536])
def test_peel_model_matches_gato_tpus_reference_peel(W):
    """The peel and unpeel models on the port's condensed operators of
    (3, 2, W), two problems, problem 1's odd row 1 with a zero pivot on a
    live block, against gato_tpu's _cr_peel and _cr_unpeel."""
    s, sp = 3, 8
    ops = kl.condense_longk_plain(*gt.blocks_to_torch(
        tt.random_batch(gt.ProblemSpec(s, 2, W), 2, seed0=90), "cpu"), rho=1e-3,
        preconditioner="jacobi")
    S, g = ops.S.clone(), ops.gamma
    S[1, 1, 1, 0, :] = 0.0
    S[1, 1, 1, :, 0] = 0.0
    S, g = S.double().numpy(), g.double().numpy()
    Sh, bh, Doinv, flags, writes = peel_model(S, g)
    we, wo = (W + 1) // 2, W // 2
    assert (writes["S'"] == 1).all() and (writes["Doinv"] == 1).all()
    assert flags.nonzero()[0].tolist() == [1] and flags.nonzero()[1].tolist() == [0]
    rng = np.random.default_rng(3)
    xh = rng.normal(size=(2, we, s))
    x = unpeel_model(xh, S, g, Doinv)
    Kp = W + (W % 2)
    for p in range(2):
        Sp, bp = _lanes(S[p].astype(np.float32), g[p].astype(np.float32), sp, Kp)
        Sx, bx, saved, flag = jlk._cr_peel(Sp, bp, Kp // 2, s=s, sp=sp)
        for slot in range(3):
            _close(Sh[p, :, slot], _blocks(Sx[slot], s, we), 1e-5, 1e-5)
        _close(bh[p], np.asarray(bx)[:s, :we].T, 1e-5, 1e-5)
        _close(Doinv[p], _blocks(saved[0], s, wo), 1e-5, 1e-5)
        assert bool(float(flag) > 0) == bool(flags[p].any())
        xhp = np.zeros((sp, Kp // 2), np.float32)
        xhp[:s, :we] = xh[p].T
        ref = np.asarray(jlk._cr_unpeel(jnp.asarray(xhp), saved, Kp, s=s, sp=sp))
        _close(x[p], ref[:s, :W].T, 1e-5, 1e-5)


def test_peel_model_matches_the_plain_peel_at_iiwa():
    """IIWA width (kN = 14) at W = 9, float64: the model against
    peel_longk_plain and unpeel_longk_plain."""
    ops = kl.condense_longk_plain(*gt.blocks_to_torch(
        tt.random_batch(gt.ProblemSpec(14, 7, 9), 2, seed0=91), "cpu"), rho=1e-3,
        preconditioner="jacobi")
    S, g = ops.S.double(), ops.gamma.double()
    Sh, bh, level = kl.peel_longk_plain(S, g)
    mSh, mbh, mD, mflags, _ = peel_model(S.numpy(), g.numpy())
    for x, y in ((mSh, Sh), (mbh, bh), (mD, level.Doinv)):
        _close(x, y.numpy(), 1e-9, 1e-9)
    assert mflags.tolist() == level.bad.tolist()
    xh = torch.randn(2, 5, 14, dtype=torch.float64)
    _close(unpeel_model(xh.numpy(), S.numpy(), g.numpy(), mD),
           kl.unpeel_longk_plain(xh, level).numpy(), 1e-9, 1e-9)


# ---- (c) the plan mirrors ----

@pytest.mark.parametrize("s", [2, 5, 14, 16, 20, 32])
@pytest.mark.parametrize("B", [1, 15, 16, 132, 133, 256, 1056, 1057, 4096])
def test_rev_walks_fit_and_cover_the_batch(s, B):
    walks = kt.rev_plan(B, 50, s, H100_SMS, LIMIT)[0]
    assert 1 <= walks <= kt.MAX_WALKS and kt.rev_smem_bytes(s, walks) <= LIMIT
    assert walks == min(-(-B // H100_SMS), kt.MAX_WALKS, max(
        w for w in range(1, kt.MAX_WALKS + 1) if kt.rev_smem_bytes(s, w) <= LIMIT))
    w = kt.walk_width(s)
    ld = kt.rev_ld(s)
    assert ld == (14 if s == 14 else w + 1)
    assert s == 14 or ld % 2 == 1
    assert kt.rev_smem_bytes(s, 1) == 4 * kt.REV_RING * (2 * (-(-w * ld // 4) * 4)
                                                         + -(-w // 4) * 4)


@pytest.mark.parametrize("K", [2, 3, 4, 5, 50, 1024, 1025, 8192])
def test_epilogue_tiles_cover_the_knots(K):
    tiles = kt.epi_tiles(K)
    assert (tiles - 1) * kt.EPI_KNOTS < K <= tiles * kt.EPI_KNOTS
    B, s, c = 3, 14, 7
    assert kt.rev_plan(B, K, s, H100_SMS, LIMIT) == (1, tiles)
    # every (problem, knot) is one CTA's warp
    seen = sorted((blk // tiles, (blk % tiles) * kt.EPI_KNOTS + w)
                  for blk in range(B * tiles) for w in range(kt.EPI_KNOTS)
                  if (blk % tiles) * kt.EPI_KNOTS + w < K)
    assert seen == [(p, j) for p in range(B) for j in range(K)]
    assert kt.epi_smem_bytes(s, c) <= LIMIT and kt.epi_smem_bytes(32, 32) <= LIMIT


@pytest.mark.parametrize("B", [1, 15])
@pytest.mark.parametrize("W", [2, 3, 1025, 8192])
def test_peel_grids_cover_the_rows(B, W):
    we, wo = (W + 1) // 2, W // 2
    inv, red = kl.peel_grid(B, W)
    assert (inv - 1) * kl.CR_WARPS < B * wo <= inv * kl.CR_WARPS
    assert (red - 1) * (kl.PEEL_THREADS // 32) < B * we <= red * (kl.PEEL_THREADS // 32)
    for s in (2, 14, 32):
        assert kl.peel_smem_bytes(s) <= LIMIT and kl.unpeel_smem_bytes(s) <= LIMIT

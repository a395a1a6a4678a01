"""The launch plans of the long-K kernels (rows 7, 8/10 and 9,
kernels/longk.py's mirrors of csrc/longk.cu) and a torch-ops model of the
PCG kernel's two-barrier schedule, on the CPU.

(a) The plans at IIWA (14, 7) on an H100 (132 SMs, 232,448 B opt-in, 1 KB
kept by the runtime): the CTAs' knot ranges and the tiles cover [0, K)
exactly once, no CTA's shared memory passes the limit, the rounds cover the
batch.  The library's copies of these functions are compared with them on
the card (tests/test_torch_cuda.py).

(b) The schedule: each CTA of a problem holds its knots' rows of r and p
with a one-knot halo on each side, publishes the boundary rows of S p and
of y = M r before the barrier after each dot product, forms its halo rows of
the next r and p itself from what its neighbours published, and sums the
dot products' partials in CTA order.  Run in float64 on the plan's splits
(and on edge splits: one knot a CTA, K not a multiple of the CTAs, empty
trailing CTAs, one CTA), it must give pcg_longk_plain's iteration counts
exactly and its lambda within 1e-10 relative; in float32 at (3, 2, 200) it
must agree with gato_tpu's long-K PCG (tests/test_torch_longk.py's
tolerance: lambda within 5e-4 of scale, iterations equal but for a +-1 exit
at an eta within 1e-3 of exit_tol, a float32 round-off tie).  This
catches halo and indexing errors of the schedule before any card time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.kernels import longk as jlk

import gato_tpu_torch as gt
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import longk as kl

torch.set_num_threads(1)

H100_SMS = 132
LIMIT = 232448 - 1024
IIWA = (14, 7)
HORIZONS = (2, 50, 689, 1024, 1025, 8192, 16384)
BATCHES = (1, 15, 16)
RHO = 1e-3


# ---- (a) the plans ----

HALF_SM = (LIMIT + 1024) // 2 - 1024 - 256


@pytest.mark.parametrize("K", HORIZONS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("per_sm", [1, 2])
def test_pcg_rounds_cover_the_batch_and_the_knots(K, B, per_sm):
    s = IIWA[0]
    rounds = kl.pcg_rounds(B, K, s, H100_SMS, LIMIT, per_sm=per_sm)
    assert rounds[0].first == 0
    for rd, nxt in zip(rounds, rounds[1:]):
        assert nxt.first == rd.first + rd.nprob
    assert rounds[-1].first + rounds[-1].nprob == B
    for rd in rounds:
        # Grid barriers bind the launch: only a round of one problem.
        assert rd.meet == ("grid" if rd.nprob == 1 else "flags")
        ctas = rd.nprob * rd.per
        assert 1 <= ctas <= per_sm * H100_SMS
        plan = kl.pcg_plan(K, s, rd.per, rd.flags, rd.ring)
        # Two CTAs an SM only where neither operator sits on chip, each
        # within half an SM.
        limit = LIMIT if ctas <= H100_SMS else HALF_SM
        if ctas > H100_SMS:
            assert not rd.flags & (kl.S_RESIDENT | kl.P_RESIDENT)
        assert rd.flags == kl.pcg_flags(K, s, rd.per, limit) >= 0
        assert plan.total * 4 <= limit
        ranges = [kl.cta_range(K, rd.per, i) for i in range(rd.per)]
        owned = np.concatenate([np.arange(k0, k1) for k0, k1 in ranges])
        assert np.array_equal(owned, np.arange(K))
        assert all(k1 > k0 for k0, k1 in ranges)          # no empty CTA
        assert max(k1 - k0 for k0, k1 in ranges) == plan.nk
        if rd.per > 1:
            assert plan.nk >= kl.MIN_CTA_KNOTS


def test_pcg_plan_at_the_measured_shapes():
    """B = 1, K = 1024: more CTAs than the parent design's 56 (rows / 256),
    S and Pinv both on chip; K = 8192: S on chip, Pinv streamed; B = 16:
    the operators stream, the vectors stay on chip."""
    s = IIWA[0]
    (one,) = kl.pcg_rounds(1, 1024, s, H100_SMS, LIMIT)
    assert one.per > 56 and one.flags == kl.VEC_IN_SMEM | kl.S_RESIDENT | kl.P_RESIDENT
    (long_,) = kl.pcg_rounds(1, 8192, s, H100_SMS, LIMIT)
    assert long_.flags == kl.VEC_IN_SMEM | kl.S_RESIDENT
    (batch,) = kl.pcg_rounds(16, 1024, s, H100_SMS, LIMIT)
    assert batch.nprob == 16 and batch.flags == kl.VEC_IN_SMEM
    assert kl.grid_barriers(1) == 2 and kl.grid_barriers(3) == 6
    # Two CTAs an SM where the operators stream and the vectors stay put;
    # one where the vectors would leave shared memory (K = 4096, B = 16),
    # and for row 9 (per_sm=1).
    for K, B, per in ((1024, 16, 16), (8192, 16, 16), (4096, 16, 8), (16384, 1, 261),
                      (8192, 1, 131), (1024, 1, 128)):
        (rd,) = kl.pcg_rounds(B, K, s, H100_SMS, LIMIT)
        assert rd.per == per, (K, B, rd)
    (rd,) = kl.pcg_rounds(16, 8192, s, H100_SMS, LIMIT, per_sm=1)
    assert rd.per == 8


@pytest.mark.parametrize("ctas", [56, 132, 200, 264])
def test_forced_ctas_cover_the_knots_with_empty_ctas_allowed(ctas):
    K, s = 1024, IIWA[0]
    for rd in kl.pcg_rounds(16, K, s, H100_SMS, LIMIT, ctas):
        assert rd.per == ctas and rd.nprob * rd.per <= 2 * H100_SMS
        owned = np.concatenate([np.arange(*kl.cta_range(K, ctas, i)) for i in range(ctas)])
        assert np.array_equal(owned, np.arange(K))
    with pytest.raises(ValueError, match="ctas"):
        kl.pcg_rounds(1, K, s, H100_SMS, LIMIT, 0)


def test_forced_rounds_must_cover_the_batch_and_keep_grid_barriers_to_one_problem():
    """The wrapper's private plan override takes a plan of pcg_rounds, a
    round of one problem on either meeting, and refuses a plan that skips
    or repeats problems or puts several problems on grid barriers."""
    s = IIWA[0]
    plan = kl.pcg_rounds(3, 1024, s, H100_SMS, LIMIT, 56)
    assert kl._forced_rounds(plan, 3) == plan
    (one,) = kl.pcg_rounds(1, 1024, s, H100_SMS, LIMIT)
    for meet in kl.BARRIERS:
        assert kl._forced_rounds([one._replace(meet=meet)], 1) == (one._replace(meet=meet),)
    for bad, n in (([plan[0]._replace(meet="grid")], 3), (plan, 4),
                   ([plan[0]._replace(first=1)], 3), ([one._replace(meet="sync")], 1),
                   ([tuple(one)], 1)):
        with pytest.raises(ValueError, match="_rounds"):
            kl._forced_rounds(bad, n)


@pytest.mark.parametrize("K", HORIZONS)
@pytest.mark.parametrize("B", BATCHES)
def test_tiles_cover_the_knots_within_the_plan(K, B):
    s, c = IIWA
    nk = kl.tile_knots(B, K, s, c, H100_SMS, LIMIT)
    assert 1 <= nk <= min(K, kl.MAX_TILE_KNOTS)
    assert (nk + 3) * max(s, c) <= kl.THREADS
    assert kl.tile_plan(nk, s, c).total * 4 <= LIMIT
    ntiles = -(-K // nk)
    ranges = [kl.tile_range(K, nk, t) for t in range(ntiles)]
    owned = np.concatenate([np.arange(k0, k1) for k0, k1 in ranges])
    assert np.array_equal(owned, np.arange(K))
    for k0, k1 in ranges:
        w0, w1 = kl.tile_window(K, k0, k1)
        assert w0 == max(k0 - 2, 0) and w1 == min(k1 + 1, K) and w1 - w0 <= nk + 3


def test_tiles_cover_the_sms_at_one_problem():
    """One problem at K = 1024 takes ``TILES_PER_SM`` tiles an SM or fewer,
    and more tiles than SMs; a batch that fills the card takes the
    largest tile."""
    s, c = IIWA
    nk = kl.tile_knots(1, 1024, s, c, H100_SMS, LIMIT)
    assert H100_SMS <= -(-1024 // nk) <= kl.TILES_PER_SM * H100_SMS
    assert kl.tile_knots(16, 8192, s, c, H100_SMS, LIMIT) == kl.MAX_TILE_KNOTS


@pytest.mark.parametrize("s,c", [(2, 1), (3, 2), (20, 9), (32, 32), (1, 32)])
def test_plans_fit_other_widths(s, c):
    for K in (2, 37, 1000):
        nk = kl.tile_knots(4, K, s, c, H100_SMS, LIMIT)
        assert kl.tile_plan(nk, s, c).total * 4 <= LIMIT
        assert (nk + 3) * max(s, c) <= kl.THREADS
        for rd in kl.pcg_rounds(4, K, s, H100_SMS, LIMIT):
            assert kl.pcg_plan(K, s, rd.per, rd.flags, rd.ring).total * 4 <= LIMIT


# ---- (b) the two-barrier schedule ----

def _rows(M, xh, k0, k1, K):
    """Rows [k0, k1) of M x (M (K, 3, s, s) block-tridiagonal), x from a
    halo vector xh (k1 - k0 + 2, s): no neighbour past either end."""
    nk = k1 - k0
    ks = torch.arange(k0, k1)
    left = torch.einsum("kab,kb->ka", M[k0:k1, 0], xh[0:nk])
    mid = torch.einsum("kab,kb->ka", M[k0:k1, 1], xh[1:nk + 1])
    right = torch.einsum("kab,kb->ka", M[k0:k1, 2], xh[2:nk + 2])
    left[ks == 0] = 0
    right[ks == K - 1] = 0
    return (left + right) + mid


def two_barrier_pcg(S, P, gamma, lam0, per, *, exit_tol, max_iters, poly=1):
    """One problem's PCG on the kernel's schedule over ``per`` CTAs
    (kl.cta_range): returns (lam, iters, converged, eta)."""
    K, s = gamma.shape
    ctas = [kl.cta_range(K, per, i) for i in range(per)]
    has_l = [k1 > k0 > 0 for k0, k1 in ctas]
    has_r = [K > k1 > k0 for k0, k1 in ctas]

    def halo():
        return [torch.zeros(k1 - k0 + 2, s, dtype=gamma.dtype) for k0, k1 in ctas]

    r, p, y, ups, tmp = halo(), halo(), halo(), halo(), halo()
    lam = [lam0[k0:k1].clone() for k0, k1 in ctas]
    pub = {}

    def publish(kind, i, own):
        if own.shape[0]:
            pub[kind, i] = (own[0].clone(), own[-1].clone())

    def left(kind, i):       # the left neighbour's last own knot
        return pub[kind, i - 1][1]

    def right(kind, i):      # the right neighbour's first own knot
        return pub[kind, i + 1][0]

    def pull(kind, i, vh):
        if has_l[i]:
            vh[0] = left(kind, i)
        if has_r[i]:
            vh[-1] = right(kind, i)

    def total(parts):        # the partials in CTA order
        out = torch.zeros((), dtype=gamma.dtype)
        for v in parts:
            out = out + v
        return out

    def precond():
        for i, (k0, k1) in enumerate(ctas):
            y[i][1:-1] = _rows(P, r[i], k0, k1, K)
            publish("y", i, y[i][1:-1])
        for _ in range(1, poly):
            # grid barrier
            for i, (k0, k1) in enumerate(ctas):
                pull("y", i, y[i])
                tmp[i][1:-1] = r[i][1:-1] - _rows(S, y[i], k0, k1, K)
                publish("tmp", i, tmp[i][1:-1])
            # grid barrier
            for i, (k0, k1) in enumerate(ctas):
                pull("tmp", i, tmp[i])
                y[i][1:-1] = y[i][1:-1] + _rows(P, tmp[i], k0, k1, K)
                publish("y", i, y[i][1:-1])
        return [(r[i][1:-1] * y[i][1:-1]).sum() for i in range(per)]

    # r = gamma - S lambda_0 on own and halo knots, from the global lambda_0.
    lam0_h = torch.cat([torch.zeros(1, s, dtype=gamma.dtype), lam0,
                        torch.zeros(1, s, dtype=gamma.dtype)])
    full = gamma - _rows(S, lam0_h, 0, K, K)
    for i, (k0, k1) in enumerate(ctas):
        lo, hi = k0 - has_l[i], k1 + has_r[i]
        r[i][lo - k0 + 1:hi - k0 + 1] = full[lo:hi]
    parts = precond()
    for i in range(per):
        p[i][1:-1] = y[i][1:-1]
    # grid barrier
    eta = total(parts)
    for i in range(per):
        pull("y", i, p[i])
    iters, conv = max_iters, False
    for it in range(max_iters):
        parts = []
        for i, (k0, k1) in enumerate(ctas):
            u = _rows(S, p[i], k0, k1, K)
            ups[i][1:-1] = u
            publish("ups", i, u)
            parts.append((p[i][1:-1] * u).sum())
        # grid barrier 1
        nu = total(parts)
        alpha = eta / nu if nu != 0 else torch.zeros_like(nu)
        for i in range(per):
            lam[i] = lam[i] + alpha * p[i][1:-1]
            r[i][1:-1] = r[i][1:-1] - alpha * ups[i][1:-1]
            if has_l[i]:
                r[i][0] = r[i][0] - alpha * left("ups", i)
            if has_r[i]:
                r[i][-1] = r[i][-1] - alpha * right("ups", i)
        parts = precond()
        # grid barrier 2
        eta_new = total(parts)
        beta = eta_new / eta if eta != 0 else torch.zeros_like(eta)
        for i in range(per):
            p[i][1:-1] = y[i][1:-1] + beta * p[i][1:-1]
            if has_l[i]:
                p[i][0] = left("y", i) + beta * p[i][0]
            if has_r[i]:
                p[i][-1] = right("y", i) + beta * p[i][-1]
        eta = eta_new
        if abs(float(eta_new)) < exit_tol:
            iters, conv = it, True
            break
    return torch.cat(lam), iters, conv, abs(float(eta))


def _ops(spec, seed, prec, dtype):
    blocks = gt.blocks_to_torch(tt.stack_blocks([tt.random_blocks(spec, seed=seed,
                                                                  dtype=np.float64)]),
                                "cpu", dtype)
    return blocks, kl.condense_longk_plain(*blocks, rho=RHO, preconditioner=prec)


SCHEDULES = [
    # (K, per, preconditioner, poly): the plan's split, one knot a CTA, K
    # not a multiple of the CTAs, empty trailing CTAs, one CTA, Horner.
    (200, kl.pcg_per(1, 200, H100_SMS), "symmetric_stair", 1),
    (60, 60, "symmetric_stair", 1),
    (201, 7, "block_jacobi", 1),
    (10, 6, "symmetric_stair", 1),
    (50, 1, "jacobi", 1),
    (200, kl.pcg_per(1, 200, H100_SMS), "symmetric_stair", 2),
    (97, 9, "block_jacobi", 3),
    (120, 17, "symmetric_stair", 1),
]


@pytest.mark.parametrize("K,per,prec,poly", SCHEDULES)
def test_schedule_model_matches_the_plain_pcg(K, per, prec, poly):
    spec = gt.ProblemSpec(3, 2, K)
    _, ops = _ops(spec, K + per, prec, torch.float64)
    gen = torch.Generator().manual_seed(K)
    lam0 = 0.1 * torch.randn(1, K, 3, generator=gen, dtype=torch.float64)
    kw = dict(exit_tol=1e-12, max_iters=400)
    ref = kl.pcg_longk_plain(ops.S, ops.Pinv, ops.gamma, lam0, poly_degree=poly, **kw)
    lam, iters, conv, _ = two_barrier_pcg(ops.S[0], ops.Pinv[0], ops.gamma[0], lam0[0],
                                          per, poly=poly, **kw)
    assert iters == int(ref.iters[0]) and conv == bool(ref.converged[0])
    err = float((lam - ref.lam[0]).abs().max()) / float(ref.lam[0].abs().max())
    assert err <= 1e-10, err


@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi"])
def test_schedule_model_matches_gato_tpu(prec):
    """At (3, 2, 200) in float32 on the plan's split: the same iterations
    and lambda as gato_tpu's long-K PCG (its 'xl' tier in interpret mode)."""
    spec = gt.ProblemSpec(3, 2, 200)
    exit_tol = 1e-8
    blocks, ops = _ops(spec, 7, prec, torch.float32)
    jres, _, _ = jlk.solve_longk_batched(
        *[jnp.asarray(x.numpy()) for x in blocks], rho=RHO, exit_tol=exit_tol,
        max_iters=300, preconditioner=prec, force_tier="xl", chunk_lanes=128)
    per = kl.pcg_per(1, 200, H100_SMS)
    lam, iters, conv, eta = two_barrier_pcg(
        ops.S[0], ops.Pinv[0], ops.gamma[0], torch.zeros(200, 3), per,
        exit_tol=exit_tol, max_iters=300)
    ji, je = int(np.asarray(jres.iters)[0]), float(np.asarray(jres.eta)[0])
    assert conv and bool(np.asarray(jres.converged)[0])
    if iters != ji:
        early = eta if iters < ji else je
        assert abs(iters - ji) == 1 and abs(early - exit_tol) <= 1e-3 * exit_tol
    ref = np.asarray(jres.lam)[0]
    assert np.abs(lam.numpy() - ref).max() <= 5e-4 * np.abs(ref).max()

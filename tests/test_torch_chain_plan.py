"""Row 16 (the iteration-floor probe) on the CPU: a NumPy float32 model of the
two schedules csrc/probes.cu runs, held against null_chain_plain, and the
plans kernels/probes.py gives them.

The model runs the kernel's trip (chain_trips) CTA by CTA: which knots each
CTA owns (kernel B's knot_begin at the cluster scope, longk.cta_range at
the grid scope), the halo rows it receives (H knots each side, by parity)
and the ones it forms itself (the matvecs a group computes past its own
knots; the dot steps' axpys on the received rows; the pending axpy and
freeze applied by the next trip's first matvec), the first row y[0] that
the problem's first CTA sends and every CTA carries, and each reduction in
the kernel's order (a thread's rows in order, a shuffle tree a warp, the
warps in order, then at the cluster scope the C slots in rank order, at
the grid scope meet's partials j, j + 32, ... then a tree).  Rows that no send fills hold NaN, and each phase runs its CTAs
forward and backward: a row read before it is sent, or a parity that a
send overwrites while a CTA still reads it, would change the result.  It
counts the meetings (cluster barriers or grid meetings) and the
__syncthreads of each trip.  Tolerance: 1e-4 of each (problem, knot)'s
scale over 100 trips, as the card test holds the kernel
(tests/test_torch_cuda.py::test_null_chain_matches_plain); the matvecs run
as float32 einsums (another order than the kernel's fmaf chains), the
reductions in the kernel's order.
"""

import numpy as np
import pytest
import torch

from gato_tpu_torch.kernels import fused_solve as kb
from gato_tpu_torch.kernels import longk
from gato_tpu_torch.kernels import probes

torch.set_num_threads(1)

F32 = np.float32
H100_SMS, H100_OPTIN = 132, 232448
H100_LIMIT = H100_OPTIN - 1024
CASES = [(2, 2), (1, 2), (4, 2), (2, 1), (2, 4), (0, 2), (3, 0), (0, 0)]
TRIPS = 100


def _tree(v):
    """Lane 0 of warp_sum: shfl_down by 16, 8, 4, 2, 1 on 32 lanes."""
    v = np.asarray(v, F32).copy()
    for off in (16, 8, 4, 2, 1):
        v[:32 - off] = v[:32 - off] + v[off:].copy()
    return v[0]


def _thread_partials(rows, nt):
    """Each thread's fmaf chain over its rows t = tid, tid + nt, ..."""
    rows = np.asarray(rows, F32)
    part = np.zeros(nt, F32)
    for i in range(0, len(rows), nt):
        v = rows[i:i + nt].astype(np.float64)
        part[:len(v)] = (v * v + part[:len(v)]).astype(F32)
    return part


def _warp_partials(part):
    return [_tree(part[w:w + 32]) for w in range(0, len(part), 32)]


def _cta_partial(rows, nt):
    """A CTA's partial: a shuffle tree a warp, then the warps in order."""
    w = _warp_partials(_thread_partials(rows, nt))
    acc = w[0]
    for x in w[1:]:
        acc = F32(acc + x)
    return acc


def cluster_sum(rows_by_cta, nt):
    """cluster_sum: each CTA's partial, then the C slots in rank order."""
    slots = [_cta_partial(rows, nt) for rows in rows_by_cta]
    total = slots[0]
    for x in slots[1:]:
        total = F32(total + x)
    return total


def grid_sum(rows_by_cta, nt):
    """Each CTA's partial, then meet's sum (lane j adds partials j, j + 32,
    ... in order, then a tree)."""
    lanes = np.zeros(32, F32)
    for j, rows in enumerate(rows_by_cta):
        lanes[j % 32] = F32(lanes[j % 32] + _cta_partial(rows, nt))
    return _tree(lanes)


def pend(v, p):
    g, has_g, live = p
    if has_g:
        v = (np.float64(g) * np.float64(F32(v * F32(0.125))) + v).astype(F32)
    if not live:
        v = ((v * F32(0.5)) + F32(1.0)) * F32(0.25)
    return v.astype(F32)


IDLE = (F32(0), False, True)


class Cta:
    def __init__(self, k0, kn, H, s):
        self.k0, self.kn = k0, kn
        self.Y = np.full((kn + 2 * H, s), np.nan, F32)
        self.Z = np.full((kn + 2 * H, s), np.nan, F32)
        self.inbox = np.full((2, 2, H, s), np.nan, F32)
        self.y00 = np.full(2, np.nan, F32)


def model_chain(M, y0, n_mv, n_dot, trips, ranges, H, nt, scope, order):
    """One problem's y after the trips, and the meetings and __syncthreads
    of each trip (lists)."""
    K, s = y0.shape
    Mc = (M * F32(0.01)).astype(F32)
    ctas = [Cta(k0, kn, H, s) for k0, kn in ranges]
    n = len(ctas)
    for c in ctas:
        c.Y[H:H + c.kn] = y0[c.k0:c.k0 + c.kn]
        for i in range(H):
            if 0 <= c.k0 - H + i and c.k0 > 0:
                c.inbox[0, 0, i] = y0[c.k0 - H + i]
            if c.k0 + c.kn + i < K and c.k0 + c.kn < K:
                c.inbox[0, 1, i] = y0[c.k0 + c.kn + i]
    y00 = y0[0, 0]
    p, par = IDLE, 0
    meetings, syncs = [], []
    reduce = cluster_sum if scope == "cluster" else grid_sum
    seq = list(range(n)) if order > 0 else list(range(n))[::-1]

    def knot(c, kl, first):
        if first and kl < 0:
            return c.inbox[par, 0, kl + H]
        if first and kl >= c.kn:
            return c.inbox[par, 1, kl - c.kn]
        return c.Y[kl + H]

    for t in range(trips):
        nm = ns = 0
        for m in range(n_mv):
            j = m % H
            size = min(H, n_mv - (m - j))
            first, last, ext = j == 0, j == size - 1, size - 1 - j
            pm = p if m == 0 else IDLE
            for i in seq:
                c = ctas[i]
                lo, hi = -min(ext, c.k0), min(c.kn + ext, K - c.k0)
                W = c.Y.copy()
                if first:
                    W[:H], W[H + c.kn:] = c.inbox[par, 0], c.inbox[par, 1]
                W = pend(W, pm)
                idx = np.arange(lo - 1, hi + 1)
                k = c.k0 + idx
                X = np.where(((k >= 0) & (k < K))[:, None], W[np.clip(idx + H, 0, None)], 0)
                ks = np.arange(c.k0 + lo, c.k0 + hi)
                acc = (np.einsum("kab,kb->ka", Mc[ks, 0], X[:-2])
                       + np.einsum("kab,kb->ka", Mc[ks, 2], X[2:])
                       + np.einsum("kab,kb->ka", Mc[ks, 1], X[1:-1])).astype(F32)
                c.Z[lo + H:hi + H] = F32(0.25) * acc + F32(0.5) * X[1:-1]
                if ext == 0:      # the group's last matvec sends its edge knots
                    for kl in range(c.kn):
                        if kl < H and i > 0:
                            ctas[i - 1].inbox[par ^ 1, 1, kl] = c.Z[kl + H]
                        if kl >= c.kn - H and i < n - 1:
                            ctas[i + 1].inbox[par ^ 1, 0, kl - c.kn + H] = c.Z[kl + H]
                    if m == n_mv - 1 and c.k0 == 0:
                        for d in ctas:
                            d.y00[t & 1] = c.Z[H, 0]
            p = IDLE
            for c in ctas:
                c.Y, c.Z = c.Z, c.Y
                c.Z[:] = np.nan
            if not last:
                ns += 1
            elif m < n_mv - 1:
                nm += 1
                par ^= 1
        sent = n_mv > 0
        if sent and n_dot == 0:
            nm += 1
            par ^= 1
            y00 = ctas[0].y00[t & 1]
            sent = False
        for d in range(n_dot):
            rows = []
            for i in seq:
                c = ctas[i]
                own = c.Y[H:H + c.kn]
                if p != IDLE:
                    own[:] = pend(own, p)
                    if n_mv > 0:
                        c.inbox[par] = pend(c.inbox[par], p)
                rows.append((i, own.reshape(-1).copy()))
            rows = [r for _, r in sorted(rows, key=lambda x: x[0])]
            sc = reduce(rows, nt)
            nm += 1
            if sent:
                par ^= 1
                y00 = ctas[0].y00[t & 1]
                sent = False
            g = F32(1.0) / (F32(1.0) + sc) if sc != 0 else F32(0.0)
            y00 = pend(np.array(y00, F32), (g, True, True))[()]
            p = (g, True, True)
        live = bool(y00 > F32(-1e30))
        y00 = pend(np.array(y00, F32), (F32(0), False, live))[()]
        p = (p[0], p[1], live)
        if n_mv == 0 and p != IDLE:
            for c in ctas:
                c.Y[H:H + c.kn] = pend(c.Y[H:H + c.kn], p)
            p = IDLE
        meetings.append(nm)
        syncs.append(ns)
    out = np.concatenate([pend(c.Y[H:H + c.kn], p) for c in ctas])
    return out, meetings, syncs


def cluster_ranges(K, C):
    return [(r * K // C, (r + 1) * K // C - r * K // C) for r in range(C)]


def grid_ranges(K, per):
    return [(k0, k1 - k0) for k0, k1 in (longk.cta_range(K, per, j) for j in range(per))]


def _knots_close(got, ref, tol):
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert np.isfinite(got).all()
    assert (np.abs(got - ref) <= tol * scale).all(), float((np.abs(got - ref) / scale).max())


def _run(scope, ranges, H, n_mv, n_dot, K, seed):
    M, y0 = probes.chain_operator(1, K, 14, seed=seed)
    ref = probes.null_chain_plain(M, y0, n_mv=n_mv, n_dot=n_dot, trips=TRIPS)[0].numpy()
    Mn, yn = M[0].numpy(), y0[0].numpy()
    nt = (probes.chain_threads(max(kn for _, kn in ranges), 14, H) if scope == "cluster"
          else longk.THREADS)
    outs = []
    for order in (1, -1):
        out, meetings, syncs = model_chain(Mn, yn, n_mv, n_dot, TRIPS, ranges, H, nt,
                                           scope, order)
        outs.append(out)
        assert meetings == [probes.trip_meetings(n_mv, n_dot, H)] * TRIPS
        assert syncs == [probes.cta_barriers(n_mv, H)] * TRIPS
    np.testing.assert_array_equal(outs[0], outs[1])
    _knots_close(outs[0].reshape(K, 14), ref, 1e-4)


@pytest.mark.parametrize("n_mv,n_dot", CASES)
@pytest.mark.parametrize("C", [1, 2, 4, 16])
def test_cluster_schedule_matches_plain(C, n_mv, n_dot):
    """The cluster scope at kernel B's knots of each rank, IIWA K = 50, the
    plan's halo min(n_mv, K // C) and a one-knot halo."""
    K = 50
    for H in sorted({1, min(max(n_mv, 1), K // C)}):
        _run("cluster", cluster_ranges(K, C), H, n_mv, n_dot, K, seed=C + 7 * n_mv + n_dot)


@pytest.mark.parametrize("n_mv,n_dot", CASES)
@pytest.mark.parametrize("per", range(1, 9))
def test_grid_schedule_matches_plain(per, n_mv, n_dot):
    """The grid scope at longk.cta_range's knots of per = 1-8 CTAs (K = 37,
    the last CTA short), the plan's halo min(n_mv, nk) and a one-knot
    halo."""
    K = 37
    nk = -(-K // per)
    for H in sorted({1, max(min(n_mv, nk), 1)}):
        _run("grid", grid_ranges(K, per), H, n_mv, n_dot, K, seed=per + 5 * n_mv + n_dot)


def test_meetings_a_trip_at_the_real_body():
    """(n_mv, n_dot) = (2, 2) at the plans' two-knot halo: two meetings
    (cluster barriers, or grid meetings) and one __syncthreads at both
    scopes; a one-knot halo takes three meetings and none; the schedules
    they replace met 2 n_mv + 2 n_dot + 1 = 9 times."""
    assert probes.trip_meetings(2, 2, 1) == 3 and probes.cta_barriers(2, 1) == 0
    assert probes.trip_meetings(2, 2, 2) == 2 and probes.cta_barriers(2, 2) == 1
    assert [probes.trip_meetings(m, d, 1) for m, d in CASES] == [3, 2, 5, 2, 5, 2, 3, 0]
    plan = probes.chain_grid_rounds(1, 1024, 14, 2, H100_SMS, H100_LIMIT)
    assert [(r.per, r.H, r.resident, r.meet) for r in plan] == [(128, 2, True, "grid")]
    cplan = probes.chain_cluster_plan(1, 50, 14, 2, H100_SMS, H100_OPTIN)
    assert (cplan.C, cplan.H, cplan.threads) == (16, 2, 96)


@pytest.mark.parametrize("B,K", [(1, 50), (3, 37), (1, 1024), (1, 2), (132, 50), (256, 50)])
def test_cluster_size_is_kernel_bs(B, K):
    """The cluster scope takes fused_solve.cluster_size's C for each (B, K)
    the tools and the card tests probe (16 at IIWA K = 50, B = 1)."""
    plan = probes.chain_cluster_plan(B, K, 14, 2, H100_SMS, H100_OPTIN)
    assert plan.C == kb.cluster_size(B, K, 14, 7, H100_SMS, H100_OPTIN)
    assert plan.H == min(2, K // plan.C) and plan.smem <= H100_LIMIT
    kn = -(-K // plan.C)
    assert plan.threads == min(max(-(-(kn + 2 * (plan.H - 1)) * 14 // 32) * 32, 64), 384)
    assert probes.chain_cluster_plan(1, 50, 14, 2, H100_SMS, H100_OPTIN).C == 16


@pytest.mark.parametrize("B,K", [(1, 1024), (1, 8192), (16, 1024), (3, 37), (200, 50)])
def test_grid_rounds_are_rows_8_10s(B, K):
    """The grid scope's rounds are longk.pcg_rounds's (problems, CTAs a
    problem, meeting), the operator resident where the round holds S in
    shared memory and the chain's layout fits, each CTA's bytes within its
    share of an SM."""
    rounds = probes.chain_grid_rounds(B, K, 14, 2, H100_SMS, H100_LIMIT)
    pcg = longk.pcg_rounds(B, K, 14, H100_SMS, H100_LIMIT)
    assert [(r.first, r.nprob, r.per, r.meet) for r in rounds] == \
        [(r.first, r.nprob, r.per, r.meet) for r in pcg]
    for r, q in zip(rounds, pcg):
        lim = longk._share_limit(H100_LIMIT, -(-r.nprob * r.per // H100_SMS))
        assert r.smem <= lim
        assert r.resident <= bool(q.flags & longk.S_RESIDENT)
        assert r.H == min(2, -(-K // r.per))


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="cluster"):
        probes.chain_cluster_plan(1, 50, 14, 2, H100_SMS, H100_OPTIN, cluster=3)
    with pytest.raises(ValueError, match="halo"):
        probes.chain_cluster_plan(1, 50, 14, 2, H100_SMS, H100_OPTIN, cluster=16, halo=4)
    with pytest.raises(ValueError, match="halo"):
        probes.chain_grid_rounds(1, 1024, 14, 2, H100_SMS, H100_LIMIT, halo=9)
    with pytest.raises(ValueError, match="shared memory"):
        probes.chain_cluster_plan(1, 400, 14, 2, H100_SMS, H100_OPTIN, cluster=1)

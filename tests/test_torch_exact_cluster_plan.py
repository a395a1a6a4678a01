"""The cluster plans of kernel A and row 4 (kernels/pcg_kernel.py and
kernels/direct_fused.py, mirrors of csrc/pcg.cu and csrc/direct_fused.cu),
a float64 model of row 4's level schedule on a cluster, and the routing
that the two kernels' redesign leaves where it was, on the CPU.

(a) Both cluster-size rules are kernel B's rule on each kernel's own plan:
every shape a kernel serves has a cluster size that fits one CTA an SM
(shared memory and threads), the rule is deterministic and non-increasing
in the batch, its floor holds the records in shared memory where any size
does, and its picks at IIWA, the pendulum and s = 32 are the documented
ones.  The library's copies of the plan functions are compared with these
on the card (tests/test_torch_cuda.py).

(b) Row 4's cyclic reduction as direct_fused.cu runs it, CTA by CTA in
float64: at each level every CTA inverts its own odd rows, then reduces its
even rows reading only its own rows and copies of at most two odd rows of
other CTAs (the left neighbour of its first even row, the right one of its
last); the root on CTA 0; back-substitution reading at most two even rows
of other CTAs.  Driven to a solution from the condensation and the
recovery, it must give gato_tpu's exact path (solve_batched with
method='direct', float64) to 1e-9 of scale at K = 2, 3, 50, 51 and 740.

(c) The routing at IIWA on a grid of (K, B): kernel A's and row 4's
horizons, the Thomas pair's batch rule and the long-K exact tier's choice,
against the formulas of the one-CTA kernels that set them.
"""

import jax
import numpy as np
import pytest
import torch

import gato_tpu
import gato_tpu_torch as gt
from gato_tpu_torch import assemble, recover, solver
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import direct_fused as kd
from gato_tpu_torch.kernels import fused_solve as kb
from gato_tpu_torch.kernels import longk as kl
from gato_tpu_torch.kernels import pcg_kernel as ka
from gato_tpu_torch.kernels import thomas_batch as kt

torch.set_num_threads(1)

H100_SMS = 132
SHARED = kl.H100_SHARED_BYTES
LIMIT = SHARED - 1024
BATCHES = (1, 2, 4, 8, 9, 15, 16, 17, 33, 34, 64, 66, 67, 132, 133, 256, 4096)


def pcg_horizons(s):
    top = 1
    while ka.fits(top + 1, s, SHARED):
        top += 1
    return sorted(set(range(1, min(top, 40) + 1)) | set(range(1, top + 1, 53)) | {top}), top


def row4_horizons(s, c):
    top = 2
    while kd.fits(top + 1, s, c, SHARED):
        top += 1
    return sorted(set(range(2, min(top, 40) + 1)) | set(range(2, top + 1, 53)) | {top}), top


# ---- (a) the cluster-size rules ----

@pytest.mark.parametrize("s", [14, 2, 5, 20, 32])
def test_kernel_a_plan_fits_every_served_shape(s):
    ks, top = pcg_horizons(s)
    assert not ka.fits(top + 1, s, SHARED)
    for K in ks:
        sizes = [C for C in kb.CLUSTER_SIZES if ka.cluster_fits(K, s, C, SHARED)]
        assert sizes, (K, s)
        for C in sizes:
            assert C <= K and ka.cta_threads(K, s, C) <= 384
            assert ka.cta_smem_bytes(K, s, C, False) <= LIMIT
            if ka.ops_in_smem(K, s, C, SHARED):
                assert ka.cta_smem_bytes(K, s, C, True) <= LIMIT
        picks = [ka.cluster_size(B, K, s, H100_SMS, SHARED) for B in BATCHES]
        assert all(a >= b for a, b in zip(picks, picks[1:])), (K, picks)
        floor = next((C for C in sizes if ka.ops_in_smem(K, s, C, SHARED)), sizes[0])
        for B, C in zip(BATCHES, picks):
            assert C in sizes and C >= floor
            assert B * C <= H100_SMS or C == floor


@pytest.mark.parametrize("s,c", [(14, 7), (2, 1), (5, 3), (20, 9), (32, 32), (1, 32)])
def test_row4_plan_fits_every_served_shape(s, c):
    ks, top = row4_horizons(s, c)
    assert not kd.fits(top + 1, s, c, SHARED)
    for K in ks:
        sizes = [C for C in kb.CLUSTER_SIZES if kd.cluster_fits(K, s, c, C, SHARED)]
        assert sizes, (K, s, c)
        for C in sizes:
            assert C <= K and kb.cta_threads(K, s, c, C) <= 384
            # Row 4's CTA is kernel B's with room for two copied odd rows.
            for ops in (False, True):
                assert kd.cta_smem_bytes(K, s, c, C, ops) >= kb.cta_smem_bytes(K, s, c, C, ops)
            assert kd.cta_smem_bytes(K, s, c, C, False) <= LIMIT
            if kd.ops_in_smem(K, s, c, C, SHARED):
                assert kd.cta_smem_bytes(K, s, c, C, True) <= LIMIT
        picks = [kd.cluster_size(B, K, s, c, H100_SMS, SHARED) for B in BATCHES]
        assert picks == [kd.cluster_size(B, K, s, c, H100_SMS, SHARED) for B in BATCHES]
        assert all(a >= b for a, b in zip(picks, picks[1:])), (K, picks)
        floor = next((C for C in sizes if kd.ops_in_smem(K, s, c, C, SHARED)), sizes[0])
        for B, C in zip(BATCHES, picks):
            assert C in sizes and C >= floor
            assert B * C <= H100_SMS or C == floor


def test_cluster_rules_at_iiwa():
    """IIWA K = 50: 16 CTAs a problem at B = 1, 8 at B = 15, then the floor
    C = 2 (C = 1 cannot hold a problem's records: 235,200 B for kernel A,
    303,800 B for row 4).  K = 688 (kernel A's last horizon): only C = 16
    holds the records.  K = 740 (row 4's): no C holds them (the global
    slice), and C = 1 does not fit at all."""
    for rule in (lambda B: ka.cluster_size(B, 50, 14, H100_SMS, SHARED),
                 lambda B: kd.cluster_size(B, 50, 14, 7, H100_SMS, SHARED)):
        assert [rule(B) for B in (1, 8, 9, 15, 16, 17, 33, 34, 256)] == \
            [16, 16, 8, 8, 8, 4, 4, 2, 2]
    assert ka.record_floats(14) * 4 * 50 == 235200
    assert not ka.ops_in_smem(50, 14, 1, SHARED) and ka.ops_in_smem(50, 14, 2, SHARED)
    assert not kd.ops_in_smem(50, 14, 7, 1, SHARED) and kd.ops_in_smem(50, 14, 7, 2, SHARED)
    assert [ka.ops_in_smem(688, 14, C, SHARED) for C in kb.CLUSTER_SIZES] == \
        [False] * 4 + [True]
    assert [ka.cluster_size(B, 688, 14, H100_SMS, SHARED) for B in (1, 256)] == [16, 16]
    assert not any(kd.ops_in_smem(740, 14, 7, C, SHARED) for C in kb.CLUSTER_SIZES)
    assert not kd.cluster_fits(740, 14, 7, 1, SHARED)
    assert [kd.cluster_size(B, 740, 14, 7, H100_SMS, SHARED) for B in (1, 15, 256)] == \
        [16, 8, 2]


def test_cluster_rules_at_the_pendulum_and_wide_blocks():
    """The pendulum (2, 1) holds its records at C = 1 from K = 2 up, so a
    wide batch takes C = 1; s = 32 (c = 32) at K = 6: C = 4 at B = 1 (each
    CTA at least a knot), kernel A's records in shared memory at C = 1 too
    (147 KB)."""
    for K in (2, 5, 50):
        assert ka.ops_in_smem(K, 2, 1, SHARED) and kd.ops_in_smem(K, 2, 1, 1, SHARED)
        assert ka.cluster_size(4096, K, 2, H100_SMS, SHARED) == 1
        assert kd.cluster_size(4096, K, 2, 1, H100_SMS, SHARED) == 1
    assert ka.cluster_size(1, 6, 32, H100_SMS, SHARED) == 4
    assert ka.ops_in_smem(6, 32, 1, SHARED) and ka.cluster_size(256, 6, 32, H100_SMS, SHARED) == 1
    assert kd.cluster_size(1, 6, 32, 32, H100_SMS, SHARED) == 4


def test_cluster_rules_refuse_what_nothing_takes():
    with pytest.raises(ValueError, match="no cluster size"):
        ka.cluster_size(1, 50, 14, H100_SMS, 2048)
    with pytest.raises(ValueError, match="no cluster size"):
        kd.cluster_size(1, 50, 14, 7, H100_SMS, 4096)


# ---- (b) row 4's level schedule on a cluster ----

def cluster_cr(S, gamma, C):
    """Row 4's reduction of one problem, CTA by CTA: S (K, 3, s, s), gamma
    (K, s) in float64; returns (x, levels) with, per level, the rows each
    CTA inverted and copied from other CTAs (at most two: asserted)."""
    K, _, s, _ = S.shape
    ranges = [kb.knot_range(K, C, r) for r in range(C)]
    owner = np.array([((k + 1) * C - 1) // K for k in range(K)])
    for r, (k0, k1) in enumerate(ranges):
        assert (owner[k0:k1] == r).all()
    W = [{k: S[k].copy() for k in range(k0, k1)} for k0, k1 in ranges]
    bv = [{k: gamma[k].copy() for k in range(k0, k1)} for k0, k1 in ranges]
    x = [dict() for _ in range(C)]
    log = []
    h = 1
    while h < K:
        h2 = 2 * h
        inverted = {r: [k for k in range(*ranges[r]) if k % h2 == h] for r in range(C)}
        for r in range(C):
            for k in inverted[r]:
                W[r][k][1] = np.linalg.inv(W[r][k][1])
        # (cluster barrier)  Even rows read odd rows only: nothing writes them.
        copied = {}
        for r, (k0, k1) in enumerate(ranges):
            even = [k for k in range(k0, k1) if k % h2 == 0]
            copy = {}
            for i in even:
                for j in (i - h, i + h):
                    if 0 <= j < K and not k0 <= j < k1:
                        assert j in (even[0] - h, even[-1] + h)
                        assert j % h2 == h
                        copy[j] = (W[owner[j]][j].copy(), bv[owner[j]][j].copy())
            copied[r] = sorted(copy)
            for i in even:
                def odd(j):
                    return copy[j] if j in copy else (W[r][j], bv[r][j])
                L, D, U = W[r][i]
                Dn, bn = D.copy(), bv[r][i].copy()
                Ln, Un = np.zeros_like(L), np.zeros_like(U)
                if i >= h:
                    (Ll, Dl, Ul), bl = odd(i - h)
                    A = L @ Dl
                    Ln, Dn, bn = -A @ Ll, Dn - A @ Ul, bn - A @ bl
                if i + h < K:
                    (Lr, Dr, Ur), br = odd(i + h)
                    B = U @ Dr
                    Un, Dn, bn = -B @ Ur, Dn - B @ Lr, bn - B @ br
                W[r][i] = np.stack([Ln, Dn, Un])
                bv[r][i] = bn
        log.append((h, inverted, copied))
        h = h2
    x[0][0] = np.linalg.solve(W[0][0][1], bv[0][0])   # the root, on CTA 0
    for h, _, _ in reversed(log):
        h2 = 2 * h
        for r, (k0, k1) in enumerate(ranges):
            odd_rows = [k for k in range(k0, k1) if k % h2 == h]
            for k in odd_rows:
                def even(j):
                    if not k0 <= j < k1:
                        assert j in (odd_rows[0] - h, odd_rows[-1] + h)
                    return x[owner[j]][j]
                L, Dinv, U = W[r][k]
                t = bv[r][k] - L @ even(k - h)
                if k + h < K:
                    t = t - U @ even(k + h)
                x[r][k] = Dinv @ t
        # (cluster barrier)
    return np.stack([x[owner[k]][k] for k in range(K)]), log


@pytest.mark.parametrize("K", [2, 3, 50, 51, 740])
def test_cluster_cr_model_matches_gato_tpu_exact_path(K):
    """The model, from the condensation to the recovery, against gato_tpu's
    exact path in float64 at the rule's C for B = 1 and at C = 2 (every
    size that fits for K <= 51)."""
    spec = gt.ProblemSpec(14, 7, K)
    blocks = tt.random_blocks(spec, seed=K + 7, dtype=np.float64)
    rho = 1e-3
    with jax.enable_x64(True):
        ref = gato_tpu.solve_batched(
            gato_tpu.ProblemSpec(14, 7, K),
            gato_tpu.KKTBlocks(*(np.asarray(a)[None] for a in blocks)),
            gato_tpu.SolverOptions(rho=rho, method="direct", dtype="float64"),
            pcg_backend="jax")
        ref = [np.asarray(a)[0] for a in (ref.lam, ref.dz_x, ref.dz_u)]
    b = gt.blocks_to_torch(blocks, "cpu", torch.float64)
    sys_ = assemble.condense(*b, rho, None)
    sizes = [C for C in kb.CLUSTER_SIZES if kd.cluster_fits(K, 14, 7, C, SHARED)]
    runs = sizes if K <= 51 else sorted({kd.cluster_size(1, K, 14, 7, H100_SMS, SHARED), 2})
    for C in runs:
        lam, _ = cluster_cr(sys_.S.numpy(), sys_.gamma.numpy(), C)
        dz_x, dz_u = recover.recover_dz(sys_.Qinv, sys_.Rinv, b.A, b.B, b.q, b.r,
                                        torch.tensor(lam))
        for got, want in zip((lam, dz_x.numpy(), dz_u.numpy()), ref):
            scale = max(float(np.abs(want).max()), 1.0)
            assert float(np.abs(got - want).max()) <= 1e-9 * scale, (K, C)


# ---- (c) the routing at IIWA ----

def _pcg_smem_one_cta(K, s):
    return 6 * K * s * 4


def _row4_smem_one_cta(K, s, c):
    def gj(n):
        return 2 * n * n + 3 * n + 2
    arena = max(gj(s), gj(c), min(K * gj(s), 16384))
    return 4 * (arena + 4 * max(K * s, (K - 1) * c))


@pytest.mark.parametrize("K", [2, 3, 50, 51, 400, 688, 689, 700, 740, 741, 1024, 2048, 8192])
def test_routing_at_iiwa_is_unchanged(K):
    """The one-CTA kernels' shared-memory formulas still set the horizons:
    kernel A (and its routing to the long-K tier) to IIWA K <= 688, row 4 to
    K <= 740; below B = 16 the exact route is row 4 there and the long-K
    exact tier past it, from B = 16 the Thomas pair where its stacks fit,
    and the long-K exact tier's 'hybrid' from B K >= 12,288 rows."""
    s, c = 14, 7
    assert ka.smem_bytes(K, s) == _pcg_smem_one_cta(K, s)
    assert kd.smem_bytes(K, s, c) == _row4_smem_one_cta(K, s, c)
    assert ka.fits(K, s, SHARED) == (K <= 688)
    assert kd.fits(K, s, c, SHARED) == (K <= 740)
    assert kl.should_dispatch(K, s, c, SHARED) == (K >= 689)
    assert kl.should_dispatch_direct(K, s, c, SHARED) == (K >= 741)
    pcg = gt.SolverOptions(method="pcg")
    direct = gt.SolverOptions(method="direct")
    for B in (1, 4, 15, 16, 17, 64, 256):
        assert solver._past_fused(pcg, (K, s, c), SHARED, B) == (K >= 689)
        pair = kt.should_dispatch(B, K, s, c)
        assert pair == (B >= kt.MIN_BATCH and kt.fits(B, K, s, c))
        assert solver._past_fused(direct, (K, s, c), SHARED, B) == (K >= 741 and not pair)
        assert kl.direct_tier(B, K) == ("hybrid" if B * K >= 12288 else "xl")

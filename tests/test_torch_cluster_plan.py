"""The launch plan of kernel B and the farm kernel (one thread-block cluster
of C CTAs a problem), in pure Python on the CPU: the cluster-size rule, the
knot partition, the per-CTA shared-memory plan and the halo rule that the
kernel's condensation relies on.  The kernel itself is held against its
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py); its
library's mirrors of these functions are compared there too.
"""

import numpy as np
import pytest
import torch

import gato_tpu_torch as gt
from gato_tpu_torch import assemble, blocktri
from gato_tpu_torch import testing as tt
from gato_tpu_torch.kernels import fused_solve as kb
from gato_tpu_torch.kernels.longk import H100_SHARED_BYTES

H100_SMS = 132
WIDTHS = [(14, 7), (2, 1), (5, 3), (1, 32), (32, 32), (20, 9), (36, 12)]
BATCHES = (1, 2, 3, 4, 8, 16, 17, 33, 64, 65, 128, 132, 133, 256, 1000, 4096)


def horizons(s, c):
    """Every K that kernel B serves at (s, c) on an H100, thinned."""
    top = 2
    while kb.fits(top + 1, s, c, H100_SHARED_BYTES):
        top += 1
    ks = set(range(2, min(top, 40) + 1)) | set(range(2, top + 1, 37)) | {top}
    return sorted(ks), top


@pytest.mark.parametrize("s,c", WIDTHS)
def test_every_served_shape_has_a_cluster_size_that_fits(s, c):
    ks, top = horizons(s, c)
    assert not kb.fits(top + 1, s, c, H100_SHARED_BYTES)
    for K in ks:
        sizes = [C for C in kb.CLUSTER_SIZES if kb.cluster_fits(K, s, c, C, H100_SHARED_BYTES)]
        assert sizes, (K, s, c)
        for C in sizes:
            assert C <= K
            assert kb.cta_smem_bytes(K, s, c, C, False) <= H100_SHARED_BYTES - 1024
            if kb.ops_in_smem(K, s, c, C, H100_SHARED_BYTES):
                assert kb.cta_smem_bytes(K, s, c, C, True) <= H100_SHARED_BYTES - 1024


@pytest.mark.parametrize("s,c", WIDTHS)
def test_cluster_rule_is_deterministic_non_increasing_and_admitted(s, c):
    ks, _ = horizons(s, c)
    for K in ks:
        picks = [kb.cluster_size(B, K, s, c, H100_SMS, H100_SHARED_BYTES) for B in BATCHES]
        again = [kb.cluster_size(B, K, s, c, H100_SMS, H100_SHARED_BYTES) for B in BATCHES]
        assert picks == again
        assert all(a >= b for a, b in zip(picks, picks[1:])), (K, picks)
        for C in picks:
            assert C in kb.CLUSTER_SIZES
            assert kb.cluster_fits(K, s, c, C, H100_SHARED_BYTES)


def test_cluster_rule_at_iiwa():
    """IIWA (14, 7, 50): many CTAs a problem at small batches; once the
    batch fills the card, the floor: the smallest C whose records (6,076 B
    a knot, 304 KB a problem) fit shared memory, C = 2."""
    picks = {B: kb.cluster_size(B, 50, 14, 7, H100_SMS, H100_SHARED_BYTES)
             for B in (1, 4, 16, 64, 256, 4096)}
    assert picks[1] >= 8 and picks[64] == 2 and picks[256] == picks[4096] == 2
    assert kb.record_floats(14, 7) * 4 == 6076
    assert not kb.ops_in_smem(50, 14, 7, 1, H100_SHARED_BYTES)
    for C in (2, 4, 8, 16):
        assert kb.ops_in_smem(50, 14, 7, C, H100_SHARED_BYTES)


def test_cluster_rule_refuses_a_shape_nothing_takes():
    with pytest.raises(ValueError, match="no cluster size"):
        kb.cluster_size(1, 50, 14, 7, H100_SMS, 4096)


@pytest.mark.parametrize("K,C", [(K, C) for K in (2, 3, 5, 16, 17, 50, 51, 97, 688)
                                 for C in (1, 2, 4, 8, 16) if C <= K])
def test_knot_partition_owns_each_knot_once_in_balanced_ranges(K, C):
    ranges = [kb.knot_range(K, C, r) for r in range(C)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    sizes = [k1 - k0 for k0, k1 in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(sizes) == kb.cluster_knots(K, C)
    owned = np.concatenate([np.arange(k0, k1) for k0, k1 in ranges])
    assert np.array_equal(owned, np.arange(K))


def _condense_by_ranges(blocks, rho, C, prec):
    """The kernel's halo rule on the CPU: each range of knots condenses with
    assemble.condense on itself plus one knot either side (Q_{k0-1} for
    phi_{k0}, A_{k1-1} for phi_{k1}^T), keeps its own rows of S and gamma,
    and forms its preconditioner from its own theta^{-1} and its
    neighbours' boundary theta^{-1} (exchanged, not recomputed).  Returns S,
    Pinv, gamma of the whole problem."""
    Q, R, A, B, q, r, c = blocks
    K = Q.shape[0]
    parts = []
    for rank in range(C):
        k0, k1 = kb.knot_range(K, C, rank)
        h0, h1 = max(k0 - 1, 0), min(k1 + 1, K)
        sub = assemble.condense(Q[h0:h1], R[h0:h1 - 1], A[h0:h1 - 1], B[h0:h1 - 1],
                                q[h0:h1], r[h0:h1 - 1], c[h0:h1], rho, None)
        own = slice(k0 - h0, k1 - h0)
        S = sub.S[own].clone()
        if k1 == K:
            S[-1, 2] = 0
        parts.append((S, sub.gamma[own]))
    S = torch.cat([p[0] for p in parts])
    gamma = torch.cat([p[1] for p in parts])
    theta, phi = S[:, 1], S[:, 0]
    if prec == "jacobi":
        Pinv = assemble._preconditioner(theta, phi[1:], gt.Preconditioner(prec), False)
        return S, Pinv, gamma
    # each range inverts its own theta; the stair reads its neighbours'
    ti_parts = [blocktri.block_inv(theta[slice(*kb.knot_range(K, C, rank))])
                for rank in range(C)]
    Pinv = torch.zeros_like(S)
    for rank in range(C):
        k0, k1 = kb.knot_range(K, C, rank)
        left = ti_parts[rank - 1][-1] if rank > 0 else None
        right = ti_parts[rank + 1][0] if rank + 1 < C else None
        ti = ti_parts[rank]
        for k in range(k0, k1):
            Pinv[k, 1] = ti[k - k0]
            if prec != "symmetric_stair":
                continue
            if k > 0:
                prev = left if k == k0 else ti[k - k0 - 1]
                Pinv[k, 0] = -(ti[k - k0] @ phi[k]) @ prev
            if k < K - 1:
                nxt = right if k == k1 - 1 else ti[k - k0 + 1]
                Pinv[k, 2] = -(ti[k - k0] @ S[k, 2]) @ nxt
    return S, Pinv, gamma


@pytest.mark.parametrize("prec", ["symmetric_stair", "block_jacobi", "jacobi"])
@pytest.mark.parametrize("C", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_halo_rule_reproduces_the_whole_condensation(prec, C, dtype, tol):
    spec = gt.ProblemSpec(5, 3, 23)
    blocks = gt.blocks_to_torch(tt.random_blocks(spec, seed=C + 10, dtype=np.float64),
                                "cpu", dtype)
    whole = assemble.condense(*blocks, 1e-3, gt.Preconditioner(prec))
    S, Pinv, gamma = _condense_by_ranges(blocks, 1e-3, C, prec)
    for name, got, ref in (("S", S, whole.S), ("Pinv", Pinv, whole.Pinv),
                           ("gamma", gamma, whole.gamma)):
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        assert err <= tol * scale, (name, err, scale)


def test_halo_rule_at_iiwa_widths_one_knot_ranges():
    """A range of one knot (K = C) takes both halos from its neighbours."""
    spec = gt.ProblemSpec(14, 7, 8)
    blocks = gt.blocks_to_torch(tt.random_blocks(spec, seed=4, dtype=np.float64),
                                "cpu", torch.float64)
    whole = assemble.condense(*blocks, 1e-3)
    S, Pinv, gamma = _condense_by_ranges(blocks, 1e-3, 8, "symmetric_stair")
    for got, ref in ((S, whole.S), (Pinv, whole.Pinv), (gamma, whole.gamma)):
        assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())

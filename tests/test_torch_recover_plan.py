"""Row 13 (the long-K recovery of dz from lambda) on the CPU: its launch plan,
a NumPy float32 model of its warp-a-knot schedule, the plain version and
gato_tpu's recovery kernel.

kernels/longk.py mirrors the plan of csrc/longk.cu's recover_longk_kernel
(RECOVER_KNOTS knots a CTA, a warp each; each warp's slice of shared
memory, ``recover_layout``; the blocks a knot copies, ``recover_window``).
The model fills each warp's slice as the kernel's copies do (every word
nothing copies holds NaN, so a wrong offset or stride shows) and computes
dz_x and dz_u as condense.cuh's warp_recover_dz does: lane a on row a,
each product an fmaf chain from 0 in column order (fmaf modelled as the
float64 product and sum of float32 operands, rounded once to float32).
Tolerances: the model against recover_longk_plain (float32 einsums, another
summation order) within 1e-5 of each output's scale; the plain version
against gato_tpu's _recover_call in Pallas interpret mode within 1e-5, as
tests/test_torch_longk.py holds it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gato_tpu.kernels import longk as jlk
from gato_tpu.kernels.fused_solve import _pack_mat, _pack_vec, _unpack_vec

from gato_tpu_torch.kernels import longk as kl

torch.set_num_threads(1)

WIDTHS = [(14, 7), (2, 1), (20, 9)]   # IIWA, the pendulum, a padded width
HORIZONS = [2, 33, 1024]
TOL = 1e-5


def _inputs(B, K, s, c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return dict(Qinv=f(B, K, s, s), Rinv=f(B, K - 1, c, c), A=f(B, K - 1, s, s),
                B=f(B, K - 1, s, c), q=f(B, K, s), r=f(B, K - 1, c), lam=f(B, K, s))


def _fmaf(a, b, acc):
    return (a.astype(np.float64) * b.astype(np.float64) + acc).astype(np.float32)


def _rows(base, rows, cols, ld):
    return base + np.arange(rows)[:, None] * ld + np.arange(cols)[None, :]


def model_recover(x: dict) -> tuple:
    """dz_x, dz_u by the kernel's schedule: every knot's warp slice filled
    by its copies, then warp_recover_dz's lanes."""
    Bn, K, s = x["q"].shape
    c = x["r"].shape[-1]
    L = kl.recover_layout(s, c)
    W = np.full((Bn, K, L.total), np.nan, np.float32)
    W[:, :, _rows(L.qi, s, s, L.ldq)] = x["Qinv"]
    W[:, :, L.qv:L.qv + s] = x["q"]
    W[:, :, L.x0:L.x0 + s] = x["lam"]
    inner = slice(0, K - 1)          # the knots with an interval (not the last)
    Wi = W[:, inner]                 # a view: the copies below land in W
    Wi[..., L.at:L.at + s * s] = x["A"].reshape(Bn, K - 1, s * s)
    Wi[..., L.bt:L.bt + s * c] = x["B"].reshape(Bn, K - 1, s * c)
    Wi[:, :, _rows(L.ri, c, c, L.ldr)] = x["Rinv"]
    Wi[..., L.rv:L.rv + c] = x["r"]
    Wi[..., L.xp:L.xp + s] = x["lam"][:, 1:]
    lanes, cl = np.arange(s), np.arange(c)
    at = np.zeros((Bn, K, s), np.float32)
    for e in range(s):
        at[:, inner] = _fmaf(Wi[..., L.at + e * s + lanes], Wi[..., L.xp + e, None],
                             at[:, inner])
    W[..., L.rx + lanes] = (W[..., L.qv + lanes] - W[..., L.x0 + lanes]) - at
    bt = np.zeros((Bn, K - 1, c), np.float32)
    for e in range(s):
        bt = _fmaf(Wi[..., L.bt + e * c + cl], Wi[..., L.xp + e, None], bt)
    Wi[..., L.ru:L.ru + c] = Wi[..., L.rv + cl] - bt
    dzx = np.zeros((Bn, K, s), np.float32)
    for e in range(s):
        dzx = _fmaf(W[..., L.qi + lanes * L.ldq + e], W[..., L.rx + e, None], dzx)
    dzu = np.zeros((Bn, K - 1, c), np.float32)
    for e in range(c):
        dzu = _fmaf(Wi[..., L.ri + cl * L.ldr + e], Wi[..., L.ru + e, None], dzu)
    return dzx, dzu


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("s,c", WIDTHS + [(16, 8), (32, 32), (30, 3)])
def test_layout_slices_are_disjoint_aligned_and_padded(s, c):
    """Every region of a warp's slice starts on a 16-byte boundary, no two
    overlap, Qinv's and Rinv's row strides are odd past IIWA's width (14
    at it), and the CTA's bytes are RECOVER_KNOTS slices."""
    L = kl.recover_layout(s, c)
    regions = [("qi", s * L.ldq), ("at", s * s), ("bt", s * c), ("ri", c * L.ldr),
               ("qv", s), ("x0", s), ("xp", s), ("rx", s), ("rv", c), ("ru", c)]
    used = np.zeros(L.total, int)
    for name, size in regions:
        off = getattr(L, name)
        assert off % 4 == 0, name
        used[off:off + size] += 1
    assert used.max() == 1
    assert L.ldq == 14 if s == 14 else L.ldq == kl.recover_width(s) + 1
    assert L.ldq % 2 == 1 or s == 14
    assert L.ldr % 2 == 1 and L.ldr >= c and L.ldq >= s
    assert kl.recover_smem_bytes(s, c) == 4 * kl.RECOVER_KNOTS * L.total


def test_plan_at_the_main_shapes():
    """IIWA: a warp's slice 624 floats (2,496 B), a CTA 9,984 B; at K = 1024,
    B = 1 the launch has hundreds of CTAs (256 on an H100's 132 SMs); at K
    = 8192, B = 16 32,768."""
    assert kl.recover_layout(14, 7).total == 624
    assert kl.recover_smem_bytes(14, 7) == 9984
    assert kl.recover_grid(1, 1024) == 256 > 132
    assert kl.recover_grid(16, 8192) == 32768
    assert kl.recover_grid(3, 33) == 3 * 9
    assert kl.recover_width(14) == 14 and kl.recover_width(2) == 16
    assert kl.recover_width(16) == 16 and kl.recover_width(17) == 32


@pytest.mark.parametrize("K", HORIZONS)
def test_each_knot_has_one_warp_and_the_last_knot_copies_less(K):
    """Knot k of problem b is warp k % 4 of CTA b ceil(K / 4) + k // 4:
    every knot exactly once, no CTA without a knot; only the last knot
    leaves out A, B, Rinv, r and lambda_{k+1}."""
    B = 3
    tiles = -(-K // kl.RECOVER_KNOTS)
    seen = np.zeros((B, K), int)
    for cta in range(kl.recover_grid(B, K)):
        b, t = divmod(cta, tiles)
        knots = [t * kl.RECOVER_KNOTS + w for w in range(kl.RECOVER_KNOTS)]
        assert any(k < K for k in knots)
        for k in knots:
            if k < K:
                seen[b, k] += 1
    assert (seen == 1).all()
    full = ("Qinv", "q", "lam", "A", "B", "Rinv", "r", "lam_next")
    assert all(kl.recover_window(K, k) == full for k in range(K - 1))
    assert kl.recover_window(K, K - 1) == ("Qinv", "q", "lam")


@pytest.mark.parametrize("K", HORIZONS)
@pytest.mark.parametrize("s,c", WIDTHS)
def test_model_matches_the_plain_version(s, c, K):
    B = 2 if K < 1024 else 1
    x = _inputs(B, K, s, c, seed=K + s)
    dzx, dzu = model_recover(x)
    px, pu = kl.recover_longk_plain(*(torch.from_numpy(x[k]) for k in
                                      ("Qinv", "Rinv", "A", "B", "q", "r", "lam")))
    _close(dzx, px.numpy(), TOL)
    _close(dzu, pu.numpy(), TOL)


@pytest.mark.parametrize("K", HORIZONS)
@pytest.mark.parametrize("s,c", WIDTHS)
def test_plain_version_matches_recover_call(s, c, K):
    """The CPU wrapper (the plain version) against gato_tpu's recovery
    kernel in interpret mode, which reads lambda_{k+1} from a copy shifted
    one lane left (tests/test_torch_longk.py's packing)."""
    x = _inputs(1, K, s, c, seed=3 * K + c)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    dz_x, dz_u = kl.recover_longk_cuda(t["Qinv"], t["Rinv"], t["A"], t["B"], t["q"],
                                       t["r"], t["lam"])
    sp, Kp = -(-s // 8) * 8, max(-(-K // 128) * 128, 128)
    pm = functools.partial(_pack_mat, K_sub=Kp, g=1, L=Kp, n_groups=1, sp=sp)
    pv = functools.partial(_pack_vec, K_sub=Kp, g=1, L=Kp, n_groups=1, sp=sp)
    lamb = pv(jnp.asarray(x["lam"]))
    dzxb, dzub = jlk._recover_call(
        pm(jnp.asarray(x["Qinv"])), pm(jnp.asarray(x["Rinv"])), pm(jnp.asarray(x["A"])),
        pm(jnp.asarray(x["B"])), pv(jnp.asarray(x["q"])), pv(jnp.asarray(x["r"])), lamb,
        jlk._shift_left_lane(lamb), s=s, c=c, sp=sp, Kp=Kp, Lc=128, n_chunks=Kp // 128,
        interpret=True)
    ref_x = np.asarray(_unpack_vec(dzxb, 1, K, s, Kp, 1))
    ref_u = np.asarray(_unpack_vec(dzub, 1, K, c, Kp, 1))[:, :K - 1]
    _close(dz_x.numpy(), ref_x, TOL)
    _close(dz_u.numpy(), ref_u, TOL)

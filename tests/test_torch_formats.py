"""gato_tpu_torch.formats / testing against gato_tpu's (NumPy, bit-equal)."""

import numpy as np
import pytest
import torch

import gato_tpu.formats as jf
import gato_tpu.testing as jt
from gato_tpu import ProblemSpec as JSpec

import gato_tpu_torch as gt
from gato_tpu_torch import formats as tf
from gato_tpu_torch import testing as tt

torch.set_num_threads(1)

SPECS = [(2, 1, 5), (3, 2, 6), (14, 7, 50)]


def _specs(sizes):
    return JSpec(*sizes), gt.ProblemSpec(*sizes)


@pytest.mark.parametrize("sizes", SPECS)
def test_random_blocks_identical(sizes):
    js, ts = _specs(sizes)
    for seed in (0, 7):
        a = jt.random_blocks(js, seed=seed)
        b = tt.random_blocks(ts, seed=seed)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), y)
            assert np.asarray(x).dtype == y.dtype


@pytest.mark.parametrize("sizes", SPECS)
def test_pack_kkt_bit_equal(sizes):
    """CSR -> blocks through both packers: every block bit-equal."""
    js, ts = _specs(sizes)
    blocks = tt.random_blocks(ts, seed=3)
    p = tt.blocks_to_csr(ts, blocks)
    jp = jt.blocks_to_csr(js, jt.random_blocks(js, seed=3))
    assert (p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val, p.g, p.c) == \
        (jp.G_row, jp.G_col, jp.G_val, jp.C_row, jp.C_col, jp.C_val, jp.g, jp.c)
    ours = tf.pack_kkt(ts, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                       p.C_val, p.g, p.c)
    ref = jf.pack_kkt(js, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                      p.C_val, p.g, p.c)
    for name, x, y in zip(tf.KKTBlocks._fields, ours, ref):
        assert x.dtype == np.asarray(y).dtype, name
        assert np.array_equal(x, np.asarray(y)), name
        assert np.array_equal(x, getattr(blocks, name)), name


def test_pendulum_pack_bit_equal():
    p = tt.pendulum_problem()
    jp = jt.pendulum_problem()
    assert p.spec == gt.ProblemSpec(2, 1, 5)
    ours = tf.pack_kkt(p.spec, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                       p.C_val, p.g, p.c)
    ref = jf.pack_kkt(jp.spec, jp.G_row, jp.G_col, jp.G_val, jp.C_row,
                      jp.C_col, jp.C_val, jp.g, jp.c)
    for x, y in zip(ours, ref):
        assert np.array_equal(x, np.asarray(y))


def test_interleave_and_dense_kkt_match():
    js, ts = _specs((3, 2, 6))
    rng = np.random.default_rng(0)
    dz_x = rng.normal(size=(6, 3)).astype(np.float32)
    dz_u = rng.normal(size=(5, 2)).astype(np.float32)
    assert np.array_equal(tf.interleave_dz(ts, dz_x, dz_u),
                          jf.interleave_dz(js, dz_x, dz_u))
    blocks = tt.random_blocks(ts, seed=2)
    K1, r1 = tf.blocks_to_dense_kkt(ts, blocks, rho=1e-3)
    K2, r2 = jf.blocks_to_dense_kkt(js, jf.KKTBlocks(*blocks), rho=1e-3)
    assert np.array_equal(K1, K2) and np.array_equal(r1, r2)
    l1, d1 = tt.dense_oracle(ts, blocks, rho=1e-3)
    l2, d2 = jt.dense_oracle(js, jf.KKTBlocks(*blocks), rho=1e-3)
    np.testing.assert_allclose(l1, l2, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(d1, d2, rtol=1e-12, atol=1e-12)


def test_out_of_pattern_entries_are_errors():
    ts = gt.ProblemSpec(2, 1, 3)
    p = tt.blocks_to_csr(ts, tt.random_blocks(ts, seed=0))
    # G: a state-control cross term in knot 0 (row 0, col 2).
    G_row = [0, 3] + [r + 1 for r in p.G_row[2:]]
    G_col = [0, 1, 2] + p.G_col[2:]
    G_val = [1.0, 0.5, 0.25] + p.G_val[2:]
    for pack in (tf.pack_G, lambda *a: jf.pack_G(*a[:4], dtype=np.float64)):
        with pytest.raises(ValueError, match="cross terms"):
            pack(ts, G_row, G_col, G_val)
    # C: an entry two column blocks right of its interval.
    C_row = list(p.C_row)
    C_col = list(p.C_col)
    C_val = list(p.C_val)
    row = 2  # first dynamics row
    C_col.insert(C_row[row + 1], 7)
    C_val.insert(C_row[row + 1], 1.0)
    C_row = C_row[: row + 1] + [x + 1 for x in C_row[row + 1:]]
    with pytest.raises(ValueError, match="right of the x_"):
        tf.pack_C(ts, C_row, C_col, C_val)
    with pytest.raises(ValueError):
        tf.pack_vectors(ts, [0.0] * 3, [0.0] * ts.nl)


def test_check_block_shapes_and_blocks_to_torch():
    ts = gt.ProblemSpec(3, 2, 6)
    blocks = tt.random_blocks(ts, seed=1)
    tb = tf.blocks_to_torch(blocks, "cpu", torch.float64)
    assert all(t.dtype == torch.float64 and t.is_contiguous() for t in tb)
    assert all(np.array_equal(t.numpy(), a.astype(np.float64))
               for t, a in zip(tb, blocks))
    tf.check_block_shapes(ts, tb)
    # a field already on the device in the dtype is not copied
    again = tf.blocks_to_torch(tb, "cpu", torch.float64)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(tb, again))
    bad = blocks._replace(c=blocks.c[:-1])
    with pytest.raises(ValueError, match="blocks.c"):
        tf.check_block_shapes(ts, bad)
    batch = tt.random_batch(ts, 4)
    tf.check_block_shapes(ts, batch, lead=(4,))


def test_infer_spec_matches():
    import gato_tpu

    for sizes in ((2, 1, 5), (14, 7, 50)):
        ts = gt.ProblemSpec(*sizes)
        p = tt.blocks_to_csr(ts, tt.random_blocks(ts, seed=0))
        got = gt.infer_spec(p.C_row, p.g, p.c)
        ref = gato_tpu.infer_spec(p.C_row, p.g, p.c)
        assert (got.state_size, got.control_size, got.knot_points) == \
            (ref.state_size, ref.control_size, ref.knot_points) == sizes
    with pytest.raises(ValueError):
        gt.infer_spec([0, 1, 2], [0.0] * 5, [0.0] * 2)


def test_options_validate_like_gato_tpu():
    import gato_tpu

    o = gt.SolverOptions(preconditioner="block_jacobi")
    assert o.preconditioner is gt.Preconditioner.BLOCK_JACOBI
    for kw in ({"method": "qr"}, {"precond_poly_degree": 0},
               {"preconditioner": "ilu"}):
        with pytest.raises(ValueError):
            gt.SolverOptions(**kw)
        with pytest.raises(ValueError):
            gato_tpu.SolverOptions(**kw)
    assert [p.value for p in gt.Preconditioner] == \
        [p.value for p in gato_tpu.Preconditioner]
    with pytest.raises(ValueError):
        gt.ProblemSpec(1, 1, 1)
    assert gt.ProblemSpec(14, 7, 50).nz == gato_tpu.ProblemSpec(14, 7, 50).nz

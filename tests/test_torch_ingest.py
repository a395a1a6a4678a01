"""The host ingestion layer of gato_tpu_torch against gato_tpu's, on the CPU.

* native.py (the port's copy of the C++ packer, built with g++ into
  build/gato_tpu_torch/): blocks bit-equal to the port's NumPy path and to
  gato_tpu.formats.pack_kkt (tests/test_native.py's cases), the same
  rejections, the NumPy path where no compiler is found, a failed build
  raising, and linsys_solve packing through it.
* formats.pack_kkt_sparse against the raw-CSR path and gato_tpu's
  (tests/test_formats.py), bit-equal.
* blocktri.btd_transpose against gato_tpu.blocktri.btd_transpose and the
  dense transpose (exact: a transpose moves values, it computes none).
* The public names: set(gato_tpu.__all__) - set(gato_tpu_torch.__all__)
  is empty.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import gato_tpu
import gato_tpu.formats as jf
from gato_tpu import blocktri as jbt

import gato_tpu_torch as gt
from gato_tpu_torch import blocktri, formats, native
from gato_tpu_torch import testing as tt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

needs_cxx = pytest.mark.skipif(native.compiler() is None,
                               reason="no C++ compiler to build the native packer")


def _numpy_pack(spec, p, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(formats, "USE_NATIVE", False)
        return formats.pack_kkt(spec, p.G_row, p.G_col, p.G_val,
                                p.C_row, p.C_col, p.C_val, p.g, p.c)


CASES = {
    "pendulum": None,
    "2-1-5": gt.ProblemSpec(2, 1, 5),
    "iiwa": gt.ProblemSpec(14, 7, 50),
    "5-3-17": gt.ProblemSpec(5, 3, 17),
}


def _case(key):
    if key == "pendulum":
        p = tt.pendulum_problem()
        return p.spec, p
    spec = CASES[key]
    return spec, tt.blocks_to_csr(spec, tt.random_blocks(spec, seed=len(key)))


@needs_cxx
@pytest.mark.parametrize("key", CASES)
def test_native_matches_numpy_and_gato_tpu(key, monkeypatch):
    spec, p = _case(key)
    ref = _numpy_pack(spec, p, monkeypatch)
    Q, R = native.pack_G_native(spec, p.G_row, p.G_col, p.G_val)
    A, B = native.pack_C_native(spec, p.C_row, p.C_col, p.C_val)
    jref = jf.pack_kkt(gato_tpu.ProblemSpec(spec.state_size, spec.control_size,
                                            spec.knot_points),
                       p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val, p.g, p.c)
    for name, got in zip("QRAB", (Q, R, A, B)):
        assert got.dtype == np.float32, name
        assert np.array_equal(got, getattr(ref, name)), name
        assert np.array_equal(got, np.asarray(getattr(jref, name))), name


@needs_cxx
def test_native_is_the_default_float32_path():
    spec, p = _case("pendulum")
    before = native.CALLS
    blocks = formats.pack_kkt(spec, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                              p.C_val, p.g, p.c)
    assert native.CALLS == before + 2
    assert formats.USE_NATIVE and native.available()
    assert blocks.Q.dtype == np.float32 and blocks.Q.shape == (5, 2, 2)
    # Other dtypes take the NumPy path.
    formats.pack_kkt(spec, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                     p.C_val, p.g, p.c, dtype=np.float64)
    assert native.CALLS == before + 2


@needs_cxx
def test_native_builds_into_the_ports_build_directory():
    path = native.library_path()
    assert path.parent == REPO / "build" / "gato_tpu_torch"
    assert path.name.startswith("libgato_pack_") and path.suffix == ".so"
    assert native.SOURCE == REPO / "gato_tpu_torch" / "csrc" / "gato_pack.cpp"
    assert native.build() and path.exists()
    from gato_tpu_torch.kernels import _build
    assert "gato_pack.cpp" not in _build.SOURCES


@needs_cxx
def test_linsys_solve_packs_natively():
    p = tt.pendulum_problem()
    before = native.CALLS
    lam, dz = gt.linsys_solve(p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
                              p.g, p.c, [0.0] * p.spec.nl, 1, 1e-6, 10, False, 1e-3,
                              verbose=False, device="cpu")
    assert native.CALLS == before + 2
    assert len(lam) == p.spec.nl and len(dz) == p.spec.nz


REJECTIONS = {
    # name: (packer, spec, indptr, indices, data, message)
    "cross_term": ("G", (2, 1, 3), [0, 1] + [1] * 7, [2], [1.0], "cross terms"),
    "cross_knot": ("G", (2, 1, 3), [0, 1] + [1] * 7, [4], [1.0], "knot"),
    "C_column_past_end": ("C", (2, 1, 3), [0, 1, 2, 3, 3, 3, 3], [0, 1, 99],
                          [1.0] * 3, "out of range"),
    "C_column_negative": ("C", (2, 1, 3), [0, 1, 2, 3, 3, 3, 3], [0, 1, -1],
                          [1.0] * 3, "out of range"),
    "C_right_of_identity": ("C", (2, 1, 3), [0, 1, 2, 3, 3, 3, 3], [0, 1, 7],
                            [1.0] * 3, "right of the x_"),
    "G_column_past_end": ("G", (2, 1, 3), [0, 1] + [1] * 7, [8], [1.0], "out of range"),
}


@needs_cxx
@pytest.mark.parametrize("case", REJECTIONS)
def test_native_rejections(case, monkeypatch):
    which, sizes, indptr, indices, data, msg = REJECTIONS[case]
    spec = gt.ProblemSpec(*sizes)
    fn = native.pack_G_native if which == "G" else native.pack_C_native
    with pytest.raises(ValueError, match=msg):
        fn(spec, indptr, indices, data)
    # The formats entry point raises the same way on both paths.
    pack = formats.pack_G if which == "G" else formats.pack_C
    for use_native in (True, False):
        with monkeypatch.context() as m:
            m.setattr(formats, "USE_NATIVE", use_native)
            with pytest.raises(ValueError):
                pack(spec, indptr, indices, data)


@needs_cxx
@pytest.mark.parametrize("indptr", [[0, 1, 5] + [5] * 7, [0, 2, 1] + [2] * 7, [-1, 1] + [1] * 8],
                         ids=["past_the_indices", "falling", "negative"])
def test_native_rejects_a_malformed_indptr(indptr):
    """indptr bounds the C walk's reads: one that does not is refused
    before the call."""
    spec = gt.ProblemSpec(2, 1, 3)  # nz = 8: nine indptr entries
    before = native.CALLS
    with pytest.raises(ValueError, match="malformed CSR"):
        native.pack_G_native(spec, indptr[:9], [0, 1], [1.0, 1.0])
    assert native.CALLS == before


def test_no_compiler_takes_the_numpy_path(monkeypatch, tmp_path):
    spec, p = _case("2-1-5")
    ref = _numpy_pack(spec, p, monkeypatch)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "compiler", lambda: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "absent.so")
    before = native.CALLS
    assert native.pack_G_native(spec, p.G_row, p.G_col, p.G_val) is None
    assert not native.available() and not native.build()
    got = formats.pack_kkt(spec, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col,
                           p.C_val, p.g, p.c)
    assert native.CALLS == before
    for name in formats.KKTBlocks._fields:
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name


@needs_cxx
def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    spec, p = _case("2-1-5")
    with pytest.raises(RuntimeError, match="failed"):
        formats.pack_G(spec, p.G_row, p.G_col, p.G_val)
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_pack_kkt_sparse_matches_raw_csr(use_native, monkeypatch):
    if use_native and native.compiler() is None:
        pytest.skip("no C++ compiler to build the native packer")
    monkeypatch.setattr(formats, "USE_NATIVE", use_native)
    spec = gt.ProblemSpec(4, 2, 6)
    p = tt.blocks_to_csr(spec, tt.random_blocks(spec, seed=5))
    G = sp.csr_matrix((p.G_val, p.G_col, p.G_row))
    C = sp.csr_matrix((p.C_val, p.C_col, p.C_row))
    ref = gt.pack_kkt(spec, p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
                      p.g, p.c)
    jref = jf.pack_kkt_sparse(gato_tpu.ProblemSpec(4, 2, 6), G, C, p.g, p.c)
    for M_G, M_C in ((G, C), (G.tocoo(), C.tocoo()), (G.tocsc(), C.tocsc())):
        got = gt.pack_kkt_sparse(spec, M_G, M_C, p.g, p.c)
        for name, x, y, z in zip(formats.KKTBlocks._fields, got, ref, jref):
            assert x.dtype == np.float32, name
            assert np.array_equal(x, y), name
            assert np.array_equal(x, np.asarray(z)), name
    with pytest.raises(TypeError, match="scipy.sparse"):
        gt.pack_kkt_sparse(spec, object(), C, p.g, p.c)
    with pytest.raises(TypeError, match="C must be"):
        gt.pack_kkt_sparse(spec, G, np.zeros((3, 3)), p.g, p.c)


def _random_btd(lead, K, s, seed):
    S = np.random.default_rng(seed).normal(size=lead + (K, 3, s, s)).astype(np.float32)
    S[..., 0, 0, :, :] = 0.0
    S[..., -1, 2, :, :] = 0.0
    return S


@pytest.mark.parametrize("K,s", [(6, 3), (2, 4), (3, 1), (50, 14)])
def test_btd_transpose_matches_gato_tpu_and_dense(K, s):
    S = _random_btd((), K, s, seed=K)
    St = blocktri.btd_transpose(torch.from_numpy(S))
    assert torch.equal(St, torch.from_numpy(np.array(jbt.btd_transpose(S))))
    assert np.array_equal(blocktri.btd_to_dense(St), jbt.btd_to_dense(S).T)
    assert torch.equal(blocktri.btd_transpose(St), torch.from_numpy(S))


def test_btd_transpose_batched():
    S = _random_btd((2, 3), 5, 2, seed=1)
    St = blocktri.btd_transpose(torch.from_numpy(S))
    assert St.shape == S.shape
    for i in range(2):
        for j in range(3):
            assert np.array_equal(blocktri.btd_to_dense(St[i, j]),
                                  blocktri.btd_to_dense(S[i, j]).T)


def test_public_names_cover_gato_tpu():
    assert set(gato_tpu.__all__) - set(gt.__all__) == set()
    for name in ("kkt_solve", "kkt_solve_batched", "pack_kkt_sparse"):
        assert callable(getattr(gt, name))

"""ctypes binding of the native C++ CSR packer (csrc/gato_pack.cpp).

The packer is host code: one pass over the CSR arrays, in a shared library
with a plain C interface that ``g++`` builds on first use into
``build/gato_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the source and the flags (an unchanged tree does not
rebuild).  :mod:`gato_tpu_torch.formats` packs through it by default for
float32 and takes its NumPy path, the semantics oracle, where no compiler
is found.  Where a compiler is found and the build fails, or a call fails,
this module raises; nothing goes back to NumPy quietly.

``CALLS`` counts the calls into the library (one for G, one for C).

Build by hand:  python -m gato_tpu_torch.native
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "gato_pack.cpp"
BUILD_DIR = _PKG.parent / "build" / "gato_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra")
ERR_BYTES = 256

CALLS = 0

_lib: Optional[ctypes.CDLL] = None


def compiler() -> Optional[str]:
    """``g++`` on PATH, or None."""
    return shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgato_pack_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> bool:
    """Compile the packer unless a build of this source exists.  Returns
    True when the library exists afterwards, False when no compiler is
    found; raises RuntimeError with the compiler's output when the build
    fails."""
    out = library_path()
    if out.exists():
        return True
    cxx = compiler()
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose:
            print(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if no compiler."""
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(str(library_path()))
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    for name in ("gato_pack_G", "gato_pack_C"):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = [p_i64, i64, p_i64, p_f32, i64, i64, i64,
                       p_f32, p_f32, ctypes.c_char_p, i64]
    _lib = lib
    return lib


def available() -> bool:
    """True when the library is built or can be (a compiler is found)."""
    return _load() is not None


def _call(name: str, spec, indptr, indices, data, shapes):
    lib = _load()
    if lib is None:
        return None
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float32)
    # The C walk trusts indptr to bound its reads of indices and data.
    if (indptr.ndim != 1 or indptr.size == 0 or indptr[0] < 0
            or indptr[-1] > min(indices.size, data.size) or np.any(np.diff(indptr) < 0)):
        raise ValueError(f"native {name[5:]}: malformed CSR: indptr must rise from >= 0 "
                         "to at most the number of indices and data")
    out = tuple(np.zeros(shape, dtype=np.float32) for shape in shapes)
    err = ctypes.create_string_buffer(ERR_BYTES)
    rc = getattr(lib, name)(indptr, len(indptr) - 1, indices, data,
                            s, c, K, *out, err, len(err))
    global CALLS
    CALLS += 1
    if rc != 0:
        raise ValueError(f"native {name[5:]}: {err.value.decode()}")
    return out


def pack_G_native(spec, indptr, indices, data) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native pack of the CSR cost Hessian G -> (Q, R); None if no
    compiler is found."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    return _call("gato_pack_G", spec, indptr, indices, data,
                 ((K, s, s), (K - 1, c, c)))


def pack_C_native(spec, indptr, indices, data) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native pack of the CSR constraint Jacobian C -> (A, B); None if no
    compiler is found."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    return _call("gato_pack_C", spec, indptr, indices, data,
                 ((K - 1, s, s), (K - 1, s, c)))


if __name__ == "__main__":
    import sys

    ok = build(verbose=True)
    print(f"native packer: {library_path() if ok else 'no C++ compiler found'}")
    sys.exit(0 if ok else 1)

"""Build and load the hand-written CUDA kernels.

The sources under ``gato_tpu_torch/csrc/`` are compiled by ``nvcc`` into one
shared library with a plain C interface, in ``build/gato_tpu_torch/`` at the
root of the checkout, and loaded with ``ctypes``.  The library's file name
carries a hash of the sources and flags, so an unchanged tree does not
rebuild.  Nothing happens at import: the first CUDA call builds, so a
machine without ``nvcc`` can import the package and run its plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("pcg.cu", "fused_solve.cu")
HEADERS = ("pcg_common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "gato_tpu_torch"
# Largest state or control size the kernels take (gato_tpu's unrolled
# Gauss-Jordan limit, blocktri.block_inv); the wrappers refuse larger.
MAX_BLOCK = 32
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# name -> (restype, argtypes) of every exported function.
_SIGNATURES = {
    "gato_pcg_batched": (_I, [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P]),
    "gato_pcg_smem_bytes": (_LL, [_I, _I]),
    "gato_fused_solve": (_I, [_P] * 15 + [_I, _I, _I, _I, _F, _F, _I, _I, _I, _P]),
    "gato_fused_scratch_floats": (_LL, [_I, _I, _I]),
    "gato_fused_smem_bytes": (_LL, [_I, _I, _I]),
    "gato_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of gato_tpu_torch cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libgato_kernels_{source_hash()}.so"


def build() -> dict:
    """Compile the library unless a build of these exact sources exists.

    Returns {"path", "seconds", "built", "log"}; ``log`` is nvcc's output
    (with ptxas's register and shared-memory report) when it ran.  Raises
    RuntimeError with nvcc's stderr when the build fails."""
    out = library_path()
    if out.exists():
        return {"path": out, "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return {"path": out, "seconds": seconds, "built": True,
            "log": proc.stderr + proc.stdout}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()["path"]))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().gato_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's device address as a 64-bit ctypes pointer."""
    return ctypes.c_void_p(t.data_ptr())


def max_shared_bytes(device) -> int:
    """Per-block shared memory a kernel may opt in to on ``device``."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       props.shared_memory_per_block))

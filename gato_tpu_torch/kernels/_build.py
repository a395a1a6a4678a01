"""Build and load the hand-written CUDA kernels.

The sources under ``gato_tpu_torch/csrc/`` are compiled by ``nvcc`` into one
shared library with a plain C interface, in ``build/gato_tpu_torch/`` at the
root of the checkout, and loaded with ``ctypes``: one ``nvcc -c`` for each
source, all started together, then one link.  The library's file name
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

from ..spans import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("pcg.cu", "fused_solve.cu", "fused_sequence.cu", "direct_fused.cu",
           "thomas_batch.cu", "longk.cu", "longk_direct.cu", "halo_matvec.cu",
           "probes.cu")
HEADERS = ("pcg_common.cuh", "condense.cuh", "cluster_body.cuh", "grid_common.cuh",
           "gauss_jordan.cuh", "condense_tile.cuh", "warp_gj.cuh", "smem_limit.cuh")
BUILD_DIR = _PKG.parent / "build" / "gato_tpu_torch"
# Largest state or control size the kernels' generic bodies take (gato_tpu's
# unrolled Gauss-Jordan limit, blocktri.block_inv; fused_solve.takes_widths).
# Above it kernel B runs only at the width pairs compiled into it
# (fused_solve.COMPILED_WIDTHS), and kernel A, which sees no control size,
# behind a PyTorch condensation; every other kernel's wrapper refuses, and
# the routing (solver._resolve_backend, packed) sends such shapes to the
# plain PyTorch path.
MAX_BLOCK = 32
# Shared memory a block leaves to the runtime: the routing's pure checks
# subtract it from the opt-in limit, as the kernel wrappers do.
RESERVED_SHARED_BYTES = 1024
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
# Extra preprocessor flags of the build, part of the library's hash: empty
# for the shipped build; tools/stage_split.py sets ("-DGATO_STAGE_STAMPS",)
# before the first CUDA call to build the stage-stamped kernel B beside it.
DEFINES: tuple = ()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# name -> (restype, argtypes) of every exported function.
_SIGNATURES = {
    "gato_pcg_batched": (_I, [_P] * 8 + [_I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "gato_pcg_smem_bytes": (_LL, [_I, _I]),
    "gato_pcg_cluster_smem_bytes": (_LL, [_I] * 4),
    "gato_pcg_cluster_threads": (_I, [_I] * 3),
    "gato_pcg_max_clusters": (_I, [_I] * 4),
    "gato_pcg_stamps": (_I, [_P]),
    "gato_fused_solve": (_I, [_P] * 15 + [_I] * 4 + [_F, _F] + [_I] * 5 + [_P]),
    "gato_fused_scratch_floats": (_LL, [_I, _I, _I]),
    "gato_fused_compiled": (_I, [_I, _I]),
    "gato_fused_max_clusters": (_I, [_I] * 5),
    "gato_fused_stage_stamps": (_I, [_P]),
    "gato_cluster_smem_bytes": (_LL, [_I] * 5),
    "gato_cluster_threads": (_I, [_I] * 4),
    "gato_cluster_size": (_I, [_I] * 5 + [_LL]),
    "gato_fused_sequence": (_I, [_P] * 16 + [_I] * 5 + [_F] + [_I] * 5 + [_P]),
    "gato_sequence_max_clusters": (_I, [_I] * 5),
    "gato_direct_fused": (_I, [_P] * 13 + [_I] * 4 + [_F, _I, _I, _P]),
    "gato_direct_cluster_smem_bytes": (_LL, [_I] * 5),
    "gato_direct_max_clusters": (_I, [_I] * 5),
    "gato_direct_scratch_floats": (_LL, [_I, _I, _I]),
    "gato_direct_smem_bytes": (_LL, [_I, _I, _I]),
    "gato_direct_stamps": (_I, [_P]),
    "gato_thomas_fwd": (_I, [_P] * 15 + [_I] * 4 + [_F, _I, _I, _P]),
    "gato_thomas_rev": (_I, [_P] * 17 + [_I] * 5 + [_P]),
    "gato_thomas_rev_smem_bytes": (_LL, [_I, _I]),
    "gato_thomas_epi_smem_bytes": (_LL, [_I, _I]),
    "gato_thomas_stamps": (_I, [_P]),
    "gato_thomas_rev_stamps": (_I, [_P]),
    "gato_thomas_walk_smem_bytes": (_LL, [_I, _I]),
    "gato_longk_tile_smem_bytes": (_LL, [_I] * 3),
    "gato_longk_tile_threads": (_I, [_I] * 3),
    "gato_longk_pcg_smem_bytes": (_LL, [_I] * 5),
    "gato_longk_pcg_vec_floats": (_LL, [_I] * 3),
    "gato_longk_condense": (_I, [_P] * 13 + [_I] * 4 + [_F, _I, _I, _P]),
    "gato_longk_pcg": (_I, [_P] * 12 + [_I] * 7 + [_F] + [_I] * 3 + [_P]),
    "gato_longk_fused": (_I, [_P] * 21 + [_I] * 9 + [_F, _F] + [_I] * 4 + [_P]),
    "gato_longk_recover": (_I, [_P] * 9 + [_I] * 4 + [_P]),
    "gato_longk_recover_smem_bytes": (_LL, [_I, _I]),
    "gato_longk_cr_grid": (_I, [_I]),
    "gato_longk_cr_stamps": (_I, [_P]),
    "gato_peel_stamps": (_I, [_P]),
    "gato_longk_cr_grid_smem_bytes": (_LL, [_I]),
    "gato_longk_cr_tail_smem_bytes": (_LL, [_I, _I]),
    "gato_longk_cr": (_I, [_P] * 7 + [_I] * 5 + [_P]),
    "gato_longk_peel": (_I, [_P] * 6 + [_I] * 3 + [_P]),
    "gato_longk_peel_smem_bytes": (_LL, [_I]),
    "gato_longk_unpeel_smem_bytes": (_LL, [_I]),
    "gato_longk_unpeel": (_I, [_P] * 5 + [_I] * 3 + [_P]),
    "gato_halo_matvec": (_I, [_P] * 5 + [_I, _I, _P]),
    "gato_null_copy": (_I, [_P, _P, _I, _I, _P]),
    "gato_null_chain_smem_bytes": (_LL, [_I] * 5),
    "gato_null_chain_threads": (_I, [_I] * 3),
    "gato_null_chain_cluster": (_I, [_P] * 3 + [_I] * 9 + [_P]),
    "gato_null_chain_grid": (_I, [_P] * 6 + [_I] * 11 + [_P]),
    "gato_fma_chain": (_I, [_P] * 3 + [_I] * 4 + [_P]),
    "gato_fma_chain_lanes": (_I, [_I]),
    "gato_fma_chain_threads": (_I, [_I]),
    "gato_fma_chain_smem_bytes": (_LL, [_I]),
    "gato_fma_stamps": (_I, [_P]),
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
    h.update(" ".join(NVCC_FLAGS + DEFINES).encode())
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
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    procs = []
    log = ""
    t0 = time.perf_counter()
    try:
        for name, obj in zip(SOURCES, objects):
            cmd = [nvcc, *NVCC_FLAGS, *DEFINES, "-c", "-o", str(obj), str(CSRC / name)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log += text
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{text}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        log += link.stderr + link.stdout
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {link.returncode}): "
                               f"{' '.join(cmd)}\n{link.stderr}{link.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return {"path": out, "seconds": time.perf_counter() - t0, "built": True,
            "log": log}


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


# The short call path (rows 15 and 18): checks that cost a few attribute
# reads, pointers and the stream passed as Python ints (the argtypes,
# c_void_p, keep them 64 bits), the launcher looked up once, and the device
# guard entered only where the tensors' device is not the current one.


def checked(what: str, key: str, t: torch.Tensor, shape: tuple,
            device: torch.device) -> torch.Tensor:
    """``t`` itself if it has ``shape``, is float32 on ``device`` and is
    contiguous, a contiguous copy if only the last fails; raises
    ValueError otherwise."""
    if t.shape != shape:
        raise ValueError(f"{what}: {key} shape {tuple(t.shape)}, expected {shape}")
    if t.dtype is not torch.float32:
        raise ValueError(f"{what}: {key} is {t.dtype}; the kernel takes float32")
    if t.device != device:
        raise ValueError(f"{what}: {key} is on {t.device}, expected {device}")
    return t if t.is_contiguous() else t.contiguous()


@functools.cache
def function(name: str):
    """The exported launcher ``name`` of the kernel library (built and
    loaded on first use)."""
    return getattr(library(), name)


def launch(what: str, name: str, device: torch.device, *args) -> None:
    """Call launcher ``name`` with ``args`` and the current stream of
    ``device`` as its last argument, on ``device``; raise RuntimeError if it
    returns a CUDA error code.  Pointers in ``args`` are ``data_ptr()``
    ints, or None for a null pointer.  Inside a ``torch.profiler`` session
    the call is the span ``gato.launch``."""
    with span("gato.launch"):
        fn = function(name)
        index = device.index
        if index == torch.cuda.current_device():
            code = fn(*args, torch.cuda.current_stream(index).cuda_stream)
        else:
            with torch.cuda.device(index):
                code = fn(*args, torch.cuda.current_stream(index).cuda_stream)
        if code:
            check_launch(code, what)


def max_shared_bytes(device) -> int:
    """Per-block shared memory a kernel may opt in to on ``device``."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       props.shared_memory_per_block))

"""Rows 16, 17 and 18: the measurement probes as hand-written CUDA kernels.

Latency floors of the primitives the solver's kernels are built from, each
beside its plain PyTorch version (the CUDA source and its note:
``gato_tpu_torch/csrc/probes.cu``; the tools that time them:
``gato_tpu_torch/tools/probe_*.py``):

* row 18, :func:`null_copy_cuda` (``bench.py``'s ``null_kernel``, the
  dispatch floor): ``out = q * 1.0000001`` on B problems' rhs, one float4
  a thread, through the short call path of ``_build`` that row 15 takes;
* row 16, :func:`null_chain_cuda` (``tools/probe_iter_floor.py``'s null
  kernel): trips of n_mv block-tridiagonal matvec contractions, n_dot
  reduce -> broadcast -> axpy steps and three freeze selects, at block
  scope (one CTA a problem, as kernels A and B) or grid scope (one
  cooperative grid, a grid barrier after every phase);
* row 17, :func:`fma_chain_cuda` (``tools/probe_throughput.py``'s probe D
  kernel): trips x depth dependent block-diagonal matvecs, one thread an
  output row, s dependent FMAs each, at IIWA's s = 14 only.

:func:`chain_operator` and :func:`fma_operator` make the chains' inputs
for the checks and the floors: each knot's own step is a scaled orthogonal
block, so every knot's y keeps its size over any number of trips (the TPU
probes' M of all ones contracts y to exactly 0 within a few hundred trips).

The ``*_cuda`` wrappers take CUDA tensors to their kernel and raise where
it cannot take them; CPU tensors go to the plain versions.  The
``*_LAUNCHES`` counters count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .fused_solve import check_tensors

SOURCE = "gato_tpu_torch/csrc/probes.cu"
COPY_NAME = "null_copy_cuda"
CHAIN_BLOCK_NAME = "null_chain_block_cuda"
CHAIN_GRID_NAME = "null_chain_grid_cuda"
FMA_NAME = "fma_chain_cuda"
COPY_REPLACES = "bench.py:899"
CHAIN_REPLACES = "tools/probe_iter_floor.py:105"
FMA_REPLACES = "tools/probe_throughput.py:222"
SCOPES = ("block", "grid")
# Row 17's one width, IIWA's state size (its row of 0.01 M lives in
# registers, so the kernel is compiled for it).
FMA_WIDTH = 14
COPY_FACTOR = 1.0000001
# A matvec step of either chain is y <- 0.5 y + 0.25 (0.01 M) y: M's
# diagonal block 400 (c Q - 0.5 I) makes a knot's own step c Q.
_STEP_SCALE = 0.25 * 0.01
# Row 16's inputs: a knot's own step CHAIN_CONTRACTION Q (Q orthogonal),
# the trip's dot steps (y grows by 1 + 0.125 / (1 + |y|^2)) holding |y| at a
# fixed point; entries of the off-diagonal blocks CHAIN_COUPLING, so that
# |0.0025 (L + U)| ~ 0.004, small beside the diagonal.
CHAIN_CONTRACTION = 0.99
CHAIN_COUPLING = 0.1

COPY_LAUNCHES = 0
CHAIN_BLOCK_LAUNCHES = 0
CHAIN_GRID_LAUNCHES = 0
FMA_LAUNCHES = 0


def _orthogonal_steps(rng, shape: tuple, s: int, contraction: float) -> np.ndarray:
    """M blocks (*shape, s, s) whose step 0.5 I + 0.0025 M is contraction
    times a random orthogonal matrix."""
    Q = np.linalg.qr(rng.normal(size=(*shape, s, s)))[0]
    return (contraction * Q - 0.5 * np.eye(s)) / _STEP_SCALE


def chain_operator(B: int, K: int, s: int, *, seed: int, device="cpu",
                   dtype=torch.float32) -> tuple:
    """Row 16's inputs M (B, K, 3, s, s) and y0 (B, K, s), from ``seed``:
    each knot's own matvec step CHAIN_CONTRACTION times a random
    orthogonal block, its neighbours coupled by N(0, CHAIN_COUPLING^2)
    blocks (the slots past either end hold values the matvec must
    ignore), y0 N(0, 1).  Every knot's y stays within a few times every
    other's over a hundred trips, and |y| stays at the dot steps' fixed
    point (2.4 to 5 at IIWA, K = 50) for any number of trips."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, K, 3, s, s)) * CHAIN_COUPLING
    M[:, :, 1] = _orthogonal_steps(rng, (B, K), s, CHAIN_CONTRACTION)
    y0 = rng.normal(size=(B, K, s))
    return (torch.tensor(M, dtype=dtype, device=device),
            torch.tensor(y0, dtype=dtype, device=device))


def fma_operator(B: int, K: int, *, seed: int, device="cpu",
                 dtype=torch.float32) -> tuple:
    """Row 17's inputs M (B, K, 14, 14) and y0 (B, K, 14), from ``seed``:
    each knot's matvec step a random orthogonal block, so every knot's y
    keeps its size over any number of matvecs; y0 N(0, 1)."""
    rng = np.random.default_rng(seed)
    M = _orthogonal_steps(rng, (B, K), FMA_WIDTH, 1.0)
    y0 = rng.normal(size=(B, K, FMA_WIDTH))
    return (torch.tensor(M, dtype=dtype, device=device),
            torch.tensor(y0, dtype=dtype, device=device))


def null_copy_plain(q: torch.Tensor) -> torch.Tensor:
    """Row 18's plain version: ``q * 1.0000001``."""
    return q * COPY_FACTOR


def null_chain_plain(M: torch.Tensor, y0: torch.Tensor, *, n_mv: int,
                     n_dot: int, trips: int) -> torch.Tensor:
    """Row 16's plain version on M (B, K, 3, s, s) and y0 (B, K, s)."""
    Mc = M * 0.01
    y = y0
    zero = torch.zeros_like(y[..., :1, :])
    for _ in range(trips):
        for _ in range(n_mv):
            halo = torch.stack([torch.cat([zero, y[..., :-1, :]], -2), y,
                                torch.cat([y[..., 1:, :], zero], -2)], -2)
            acc = torch.einsum("...kjab,...kjb->...ka", Mc, halo)
            y = acc * 0.25 + y * 0.5
        for _ in range(n_dot):
            sc = (y * y).sum(dim=(-2, -1), keepdim=True)
            a = torch.where(sc != 0, 1.0 / (1.0 + sc), torch.zeros_like(sc))
            y = y + a * (y * 0.125)
        live = y[..., :1, :1] > -1e30
        y = torch.where(live, y, y * 0.5)
        y = torch.where(live, y, y + 1.0)
        y = torch.where(live, y, y * 0.25)
    return y


def fma_chain_plain(M: torch.Tensor, y0: torch.Tensor, *, depth: int,
                    trips: int) -> torch.Tensor:
    """Row 17's plain version on M (B, K, 14, 14) and y0 (B, K, 14)."""
    Mc = M * 0.01
    y = y0
    for _ in range(trips * depth):
        acc = torch.einsum("...kab,...kb->...ka", Mc, y)
        y = acc * 0.25 + y * 0.5
    return y


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are neither CPU nor CUDA")


def _counts(name: str, **counts) -> None:
    for key, value in counts.items():
        if not isinstance(value, int) or value < 0:
            raise ValueError(f"{name}: {key} must be an int >= 0, got {value!r}")


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def null_copy_cuda(q: torch.Tensor) -> torch.Tensor:
    """out = q * 1.0000001 on q (B, K, s): one float4 a thread.  The call
    takes row 15's short path (``_build.checked`` / ``_build.launch``), so
    its cost is what a kernel call of the port costs at least."""
    dev = q.device
    if dev.type == "cpu":
        return null_copy_plain(q)
    _check_device(COPY_NAME, q)
    if q.ndim != 3:
        raise ValueError(f"{COPY_NAME}: q must be (B, K, s), got {tuple(q.shape)}")
    Bn, K, s = q.shape
    q = _build.checked(COPY_NAME, "q", q, (Bn, K, s), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch(COPY_NAME, "gato_null_copy", dev, q.data_ptr(), out.data_ptr(),
                  Bn, K * s)
    global COPY_LAUNCHES
    COPY_LAUNCHES += 1
    return out


@functools.cache
def grid_ctas(device_index: int) -> int:
    """Resident CTAs of the grid-scope chain kernel on a device (the caller
    has made it current); raises where none fits."""
    lib = _build.library()
    grid = lib.gato_null_chain_grid_ctas()
    if grid < 1:
        why = (f"CUDA error {-grid} ({lib.gato_error_string(-grid).decode()})"
               if grid < 0 else "0 resident blocks")
        raise RuntimeError(f"{CHAIN_GRID_NAME}: the cooperative grid does not fit "
                           f"the device: {why}")
    return grid


def null_chain_cuda(M: torch.Tensor, y0: torch.Tensor, *, n_mv: int, n_dot: int,
                    trips: int, scope: str = "block") -> torch.Tensor:
    """Row 16 on M (B, K, 3, s, s) and y0 (B, K, s) at ``scope`` 'block' or
    'grid'; returns y after ``trips`` trips."""
    if scope not in SCOPES:
        raise ValueError(f"unknown scope {scope!r}; valid: {SCOPES}")
    name = CHAIN_BLOCK_NAME if scope == "block" else CHAIN_GRID_NAME
    _counts(name, n_mv=n_mv, n_dot=n_dot, trips=trips)
    if y0.device.type == "cpu":
        return null_chain_plain(M, y0, n_mv=n_mv, n_dot=n_dot, trips=trips)
    _check_device(name, y0)
    if y0.ndim != 3:
        raise ValueError(f"{name}: y0 must be (B, K, s), got {tuple(y0.shape)}")
    Bn, K, s = y0.shape
    check_tensors(name, {"M": (Bn, K, 3, s, s), "y0": (Bn, K, s)},
                  {"M": M, "y0": y0}, y0.device)
    if s > _build.MAX_BLOCK:
        raise ValueError(f"{name}: state size {s} > {_build.MAX_BLOCK}")
    M, y0 = M.contiguous(), y0.contiguous()
    dev = y0.device
    out = torch.empty_like(y0)
    if Bn == 0 or K == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        Mc = torch.empty_like(M)
        if scope == "block":
            smem = 2 * K * s * 4
            limit = _build.max_shared_bytes(dev) - _build.RESERVED_SHARED_BYTES
            if smem > limit:
                raise ValueError(f"{name}: y of {K * s} floats needs {smem} B of "
                                 f"shared memory, above the device's {limit} B")
            buf = parts = out
            grid_max = 0
        else:
            grid_max = grid_ctas(torch.cuda.current_device())
            if Bn > grid_max:
                raise ValueError(f"{name}: {Bn} problems need a CTA each, above the "
                                 f"{grid_max} the cooperative grid holds")
            per = lib.gato_null_chain_grid_per(Bn, K * s, grid_max)
            buf = torch.empty(Bn, 2, K * s, dtype=torch.float32, device=dev)
            parts = torch.empty(Bn * per, dtype=torch.float32, device=dev)
        code = lib.gato_null_chain(*map(_build.ptr, (M, y0, Mc, out, buf, parts)),
                                   Bn, K, s, n_mv, n_dot, trips,
                                   SCOPES.index(scope), grid_max, _stream(dev))
    _build.check_launch(code, name)
    global CHAIN_BLOCK_LAUNCHES, CHAIN_GRID_LAUNCHES
    if scope == "block":
        CHAIN_BLOCK_LAUNCHES += 1
    else:
        CHAIN_GRID_LAUNCHES += 1
    return out


def fma_chain_cuda(M: torch.Tensor, y0: torch.Tensor, *, depth: int,
                   trips: int) -> torch.Tensor:
    """Row 17 on M (B, K, 14, 14) and y0 (B, K, 14); returns y after
    ``trips * depth`` matvecs."""
    _counts(FMA_NAME, depth=depth, trips=trips)
    if y0.ndim != 3:
        raise ValueError(f"{FMA_NAME}: y0 must be (B, K, s), got {tuple(y0.shape)}")
    Bn, K, s = y0.shape
    if s != FMA_WIDTH:
        raise ValueError(f"{FMA_NAME}: width s = {s}; the kernel takes s = {FMA_WIDTH}")
    if y0.device.type == "cpu":
        return fma_chain_plain(M, y0, depth=depth, trips=trips)
    _check_device(FMA_NAME, y0)
    check_tensors(FMA_NAME, {"M": (Bn, K, s, s), "y0": (Bn, K, s)},
                  {"M": M, "y0": y0}, y0.device)
    if K * s > 1024:
        raise ValueError(f"{FMA_NAME}: one thread an output row takes K s <= 1024, "
                         f"got {K * s}")
    M, y0 = M.contiguous(), y0.contiguous()
    out = torch.empty_like(y0)
    if Bn == 0 or K == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(y0.device):
        code = lib.gato_fma_chain(*map(_build.ptr, (M, y0, out)), Bn, K, depth, trips,
                                  _stream(y0.device))
    _build.check_launch(code, FMA_NAME)
    global FMA_LAUNCHES
    FMA_LAUNCHES += 1
    return out

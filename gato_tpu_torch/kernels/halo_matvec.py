"""Row 15: the block-tridiagonal matvec of one knot shard as a hand-written
CUDA kernel.

Replaces ``gato_tpu/parallel/sharded.py::_mv_halo_kernel`` (through
``_packed_matvec``): on one shard of Kl knots, y_k = L_k x_{k-1} + D_k x_k +
U_k x_{k+1}, with x_{-1} and x_{Kl} the halo rows ``left`` and ``right``,
the boundary rows of the neighbouring shards (zeros at the trajectory's
ends).  The CUDA source is ``gato_tpu_torch/csrc/halo_matvec.cu``; its note
gives the design: a CTA stages a run of block rows of S into shared memory
with 16-byte loads, and a thread computes one output element.

:func:`halo_matvec_cuda` takes tensors on a CUDA device to the kernel and
raises if the kernel cannot take them; tensors on the CPU go to the plain
version, :func:`halo_matvec_plain` (``blocktri.btd_matvec`` with the halos
in place of its zero padding).  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..blocktri import btd_matvec
from . import _build
from .fused_solve import check_tensors

NAME = "halo_matvec_cuda"
SOURCE = "gato_tpu_torch/csrc/halo_matvec.cu"
REPLACES = "gato_tpu/parallel/sharded.py:136"

LAUNCHES = 0


def halo_matvec_plain(S, x, left=None, right=None) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``blocktri.btd_matvec``."""
    return btd_matvec(S, x, left, right)


def halo_matvec_cuda(
    S: torch.Tensor,                       # (Kl, 3, s, s)
    x: torch.Tensor,                       # (Kl, s)
    left: Optional[torch.Tensor] = None,   # (s,) x_{-1}; zeros if None
    right: Optional[torch.Tensor] = None,  # (s,) x_{Kl}; zeros if None
) -> torch.Tensor:
    """y (Kl, s) = S x on one shard, its halo rows ``left`` and ``right``."""
    if x.device.type == "cpu":
        return halo_matvec_plain(S, x, left, right)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {x.device} are neither CPU nor CUDA")
    if x.ndim != 2:
        raise ValueError(f"{NAME}: x must be (Kl, s), got {tuple(x.shape)}")
    Kl, s = x.shape
    zero = None
    if left is None or right is None:
        zero = torch.zeros(s, dtype=x.dtype, device=x.device)
    tensors = {"S": S, "x": x, "left": zero if left is None else left,
               "right": zero if right is None else right}
    check_tensors(NAME, {"S": (Kl, 3, s, s), "x": (Kl, s), "left": (s,),
                         "right": (s,)}, tensors, x.device)
    if s > _build.MAX_BLOCK:
        raise ValueError(f"{NAME}: state size {s} > {_build.MAX_BLOCK}")
    S, x, left, right = (t.contiguous() for t in tensors.values())
    y = torch.empty_like(x)
    if Kl == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.gato_halo_matvec(*map(_build.ptr, (S, x, left, right, y)),
                                    Kl, s, ctypes.c_void_p(stream))
    _build.check_launch(code, NAME)
    global LAUNCHES
    LAUNCHES += 1
    return y

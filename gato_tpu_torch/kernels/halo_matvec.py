"""Row 15: the block-tridiagonal matvec of one knot shard as a hand-written
CUDA kernel.

Replaces ``gato_tpu/parallel/sharded.py::_mv_halo_kernel`` (through
``_packed_matvec``): on one shard of Kl knots, y_k = L_k x_{k-1} + D_k x_k +
U_k x_{k+1}, with x_{-1} and x_{Kl} the halo rows ``left`` and ``right``,
the boundary rows of the neighbouring shards (None for zeros, at the
trajectory's ends).  The CUDA source is ``gato_tpu_torch/csrc/halo_matvec.cu``;
its note gives the design: a warp a block row, its operator loaded with
16-byte loads straight into registers, the products summed through a small
shared transpose.

:func:`halo_matvec_cuda` takes tensors on a CUDA device to the kernel and
raises if the kernel cannot take them; tensors on the CPU go to the plain
version, :func:`halo_matvec_plain` (``blocktri.btd_matvec`` with the halos
in place of its zero padding).  A call allocates ``y`` and nothing else
(an absent halo is a null pointer, not a tensor of zeros) and launches one
kernel, through ``_build``'s short call path.  ``LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..blocktri import btd_matvec
from . import _build

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
    dev = x.device
    if dev.type == "cpu":
        return halo_matvec_plain(S, x, left, right)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: tensors on {dev} are neither CPU nor CUDA")
    if x.ndim != 2:
        raise ValueError(f"{NAME}: x must be (Kl, s), got {tuple(x.shape)}")
    Kl, s = x.shape
    if s > _build.MAX_BLOCK:
        raise ValueError(f"{NAME}: state size {s} > {_build.MAX_BLOCK}")
    S = _build.checked(NAME, "S", S, (Kl, 3, s, s), dev)
    x = _build.checked(NAME, "x", x, (Kl, s), dev)
    if left is not None:
        left = _build.checked(NAME, "left", left, (s,), dev)
    if right is not None:
        right = _build.checked(NAME, "right", right, (s,), dev)
    y = torch.empty_like(x)
    if Kl == 0 or s == 0:
        return y
    _build.launch(NAME, "gato_halo_matvec", dev, S.data_ptr(), x.data_ptr(),
                  None if left is None else left.data_ptr(),
                  None if right is None else right.data_ptr(), y.data_ptr(), Kl, s)
    global LAUNCHES
    LAUNCHES += 1
    return y

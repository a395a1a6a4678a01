"""A mesh of devices, and the collectives the sharded paths use on it.

``gato_tpu.parallel`` runs on a ``jax.sharding.Mesh`` under ``shard_map``:
one program drives every device of the mesh, neighbours trade rows with
``lax.ppermute``, dots are summed with ``lax.psum`` and small systems
gathered with ``lax.all_gather``.  The port is single-controller too: one
Python process holds an ordered list of torch devices, one shard on each,
and runs each shard's work on its device in turn (CUDA launches are
asynchronous, so shards on different cards overlap).  A device may repeat:
``Mesh(["cuda:0"] * 4)`` is four shards on one card, as ``gato_tpu``'s
tests put eight virtual devices on one CPU.

The collectives are explicit copies between the shards' devices:

* :func:`shift_right` / :func:`shift_left` stand for ``ppermute`` to the
  next / previous shard: shard i receives a copy of shard i-1's (i+1's)
  value, and the shard at the mesh's edge receives zeros, which is the
  trajectory's boundary (``sharded.py:49-67``);
* :func:`psum` adds the shards' partial values in shard order on the
  first device, one fixed order whatever the placement; :func:`replicate`
  hands the sum back to every shard;
* :func:`all_gather` stacks the shards' values on one device, and
  :func:`gather` concatenates them there.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..solver import resolve_device


class Mesh:
    """An ordered list of torch devices along one named axis.

    ``mesh.shape[axis_name]`` is the number of shards, as in JAX.  Each
    device is checked with ``solver.resolve_device``, so a CUDA device
    raises where CUDA is absent; ``"cuda"`` without an index means the
    current CUDA device.  There is no default placement: the caller names
    every device."""

    def __init__(self, devices: Sequence, axis_name: str = "knot"):
        devs = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise ValueError("a Mesh needs at least one device")
        self.devices = tuple(devs)
        self.axis_name = axis_name

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}

    def size(self, axis_name: str) -> int:
        """The number of shards along ``axis_name``; raises for another name."""
        if axis_name != self.axis_name:
            raise ValueError(f"this mesh's axis is {self.axis_name!r}, not "
                             f"{axis_name!r}; build it as Mesh(devices, "
                             f"{axis_name!r}) or pass axis_name={self.axis_name!r}")
        return len(self.devices)

    @property
    def all_cuda(self) -> bool:
        return all(d.type == "cuda" for d in self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


def shift_right(values: Sequence[torch.Tensor], devices, *, edge_zeros=True) -> list:
    """``ppermute`` i -> i+1: shard i gets a copy of shard i-1's value on
    its own device, shard 0 zeros (None if not ``edge_zeros``)."""
    out = [torch.zeros_like(values[0]) if edge_zeros else None]
    for i in range(1, len(devices)):
        out.append(values[i - 1].to(devices[i], copy=True))
    return out


def shift_left(values: Sequence[torch.Tensor], devices, *, edge_zeros=True) -> list:
    """``ppermute`` i -> i-1: shard i gets a copy of shard i+1's value on
    its own device, the last shard zeros (None if not ``edge_zeros``)."""
    n = len(devices)
    out = [values[i + 1].to(devices[i], copy=True) for i in range(n - 1)]
    out.append(torch.zeros_like(values[n - 1]) if edge_zeros else None)
    return out


def psum(values: Sequence[torch.Tensor], devices) -> torch.Tensor:
    """The shards' values added in shard order, ((v0 + v1) + v2) + ..., on
    the first device."""
    total = values[0]
    for v in values[1:]:
        total = total + v.to(devices[0])
    return total


def replicate(value: torch.Tensor, devices) -> list:
    """``value`` on every shard's device (the same tensor where it already
    lies there)."""
    return [value.to(d) for d in devices]


def all_gather(values: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' values stacked along a new leading axis on ``device``."""
    return torch.stack([v.to(device) for v in values])


def gather(values: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards' values concatenated along ``dim`` on ``device``."""
    return torch.cat([v.to(device) for v in values], dim=dim)

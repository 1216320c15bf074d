"""Sharding of the HMM pipeline over several devices (torch port of
``hommx_tpu/parallel/sharding.py``).

The reference drives a 1D ``jax.sharding.Mesh`` from one process: the micro
stage is split over the macro-cell batch with the micro operators
replicated, which needs no communication, and the per-cell tensors are
gathered for the macro assembly.  The port keeps that model: a
:class:`ShardMesh` is a tuple of torch devices driven by one process, each
shard's work runs on its own device and the results are copied to the first
one.  Devices may repeat: ``ShardMesh(["cuda:0"] * 4)`` runs four logical
shards on one card (every piece of the sharded path, each on the card) and
``ShardMesh(["cpu"] * 8)`` is the counterpart of the reference tests' eight
virtual host devices.  On a host with several cards each shard goes on its
own card and the copies become peer-to-peer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from hommx_tpu_torch.config import as_device

__all__ = ["ShardMesh", "device_mesh", "shard_cells"]


@dataclasses.dataclass(frozen=True, init=False)
class ShardMesh:
    """A 1D mesh of torch devices driven by one process.

    Attributes:
        devices: the shards' devices, in order (repeats allowed).
        axis_names: ``(axis,)``, the reference mesh's axis name.
    """

    devices: tuple
    axis_names: tuple

    def __init__(self, devices: Sequence, axis: str = "cells"):
        devs = tuple(as_device(d) for d in devices)
        if not devs:
            raise ValueError("ShardMesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", (axis,))

    @property
    def size(self) -> int:
        return len(self.devices)


def device_mesh(devices=None, axis: str = "cells") -> ShardMesh:
    """A mesh over ``devices``, by default every visible CUDA device.
    Raises when there is none: the default never falls back to the CPU."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("device_mesh(): no CUDA device is visible; pass the devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    return ShardMesh(devices, axis)


def _gather(outs, device, n: int):
    """Concatenate the shards' outputs (tensors or tuples of tensors) on
    ``device`` and keep the first ``n`` rows."""
    if isinstance(outs[0], tuple):
        return tuple(_gather([o[k] for o in outs], device, n) for k in range(len(outs[0])))
    return torch.cat([o.to(device) for o in outs])[:n]


def shard_cells(mesh: ShardMesh, tensor_fn: Callable, centers: torch.Tensor):
    """Run ``tensor_fn(centers_block)`` on each shard and gather the
    results.

    The batch is padded to a multiple of the shard count by repeating
    ``centers[:1]``; shard i takes the i-th contiguous block on
    ``mesh.devices[i]``; the outputs (a tensor or a tuple of tensors, batch
    first) are concatenated on ``mesh.devices[0]`` and the padding rows
    dropped.  The copies are ``.to`` and ``torch.cat``, so the result stays
    differentiable in whatever ``tensor_fn`` is differentiable in."""
    n = centers.shape[0]
    nd = mesh.size
    n_pad = (-n) % nd
    if n_pad:
        centers = torch.cat([centers, centers[:1].expand(n_pad, *centers.shape[1:])])
    block = centers.shape[0] // nd
    outs = [tensor_fn(centers[i * block:(i + 1) * block].to(dev))
            for i, dev in enumerate(mesh.devices)]
    return _gather(outs, mesh.devices[0], n)

"""Meshes of shards — counterpart of ``phylo_hmrf_tpu/parallel/mesh.py``.

A `Mesh` is a 1-D row of shards, each with the ``torch.device`` its
tensors live on. One Python process drives every shard, as ``shard_map``
does from one controller: the multi-device E-steps (``parallel/halo.py``,
``parallel/sharding.py``) loop over the shards, launching each shard's work
on its own device, and move the exchanged rows and the statistics between
devices. Several shards may share a device: N shards on one card, or on
the CPU in the tests, are the counterpart of the JAX tests' virtual CPU
devices.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards along one axis; shard i lives on ``devices[i]``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        """The shard-to-device map, e.g. ``0:cuda:0 1:cuda:0``."""
        return " ".join(f"{i}:{d}" for i, d in enumerate(self.devices))


def make_mesh(mesh_shape=None, devices=None) -> Mesh:
    """A 1-D mesh of ``mesh_shape[0]`` shards (default: one per device).

    ``devices`` (default: every visible CUDA device) are dealt to the
    shards round-robin, so ``make_mesh((8,), devices=[torch.device("cpu")])``
    puts eight shards on the CPU. Raises when no device is given and CUDA
    is absent."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: empty device list")
    if not mesh_shape:
        mesh_shape = (len(devices),)
    if len(mesh_shape) != 1 or int(mesh_shape[0]) < 1:
        raise ValueError(f"only 1-D meshes of >= 1 shard are supported, got "
                         f"{tuple(mesh_shape)}")
    n = int(mesh_shape[0])
    return Mesh(tuple(devices[i % len(devices)] for i in range(n)))

"""Meshes of shards — counterpart of ``phylo_hmrf_tpu/parallel/mesh.py``.

A `Mesh` is a 1-D row of shards, each with the ``torch.device`` its
tensors live on and the process that owns it. In one process (every owner
0, the default) one Python process drives every shard, as ``shard_map``
does from one controller: the multi-device E-steps (``parallel/halo.py``,
``parallel/sharding.py``) loop over the shards, launching each shard's work
on its own device, and move the exchanged rows and the statistics between
devices. Several shards may share a device: N shards on one card, or on
the CPU in the tests, are the counterpart of the JAX tests' virtual CPU
devices.

``make_mesh(..., processes=True)`` is the counterpart of the JAX package's
global ``make_mesh()`` after ``initialize_distributed``: the shards are
dealt over the processes of the ``torch.distributed`` group, process 0
first, and every process runs the same program on its own shards (SPMD).
What a shard of another process holds crosses the process boundary through
``parallel/distributed.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from phylo_hmrf_tpu_torch.parallel.distributed import (process_count,
                                                       process_index)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards along one axis; shard i lives on ``devices[i]`` in process
    ``owners[i]``, and this process is ``rank``. A shard of another
    process records the device its owner deals it to (that process's
    devices are not visible here), so only its owner reads it."""

    devices: tuple
    owners: tuple = None
    rank: int = 0

    def __post_init__(self):
        if self.owners is None:
            object.__setattr__(self, "owners", (0,) * len(self.devices))
        if len(self.owners) != len(self.devices):
            raise ValueError(f"{len(self.owners)} owners for "
                             f"{len(self.devices)} shards")
        if self.rank not in self.owners:
            raise ValueError(f"process {self.rank} owns no shard of "
                             f"owners {self.owners}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        """True when another process owns some shard."""
        return any(o != self.rank for o in self.owners)

    def is_local(self, i: int) -> bool:
        return self.owners[i] == self.rank

    @property
    def first_device(self):
        """The device of this process's first shard: where the model keeps
        what is not split over the shards."""
        return self.devices[self.owners.index(self.rank)]

    def describe(self) -> str:
        """The shard-to-device map, e.g. ``0:cuda:0 1:cuda:0``; with the
        owning process when the mesh spans processes (``2:cuda:0@p1``)."""
        if len(set(self.owners)) == 1:
            return " ".join(f"{i}:{d}" for i, d in enumerate(self.devices))
        return " ".join(f"{i}:{d}@p{o}" for i, (d, o) in
                        enumerate(zip(self.devices, self.owners)))


def make_mesh(mesh_shape=None, devices=None, processes: bool = False) -> Mesh:
    """A 1-D mesh of ``mesh_shape[0]`` shards (default: one per device).

    ``devices`` (default: every visible CUDA device) are dealt to the
    shards round-robin, so ``make_mesh((8,), devices=[torch.device("cpu")])``
    puts eight shards on the CPU. Raises when no device is given and CUDA
    is absent.

    ``processes=True`` (after ``initialize_distributed``) deals the shards
    over the processes in blocks of ``mesh_shape[0] / process_count()``,
    process 0 first, as JAX orders its global devices; each process's
    block goes round-robin over its own ``devices``. Raises when the shard
    count does not divide. With one process it is the default mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: empty device list")
    n_proc = process_count() if processes else 1
    if not mesh_shape:
        mesh_shape = (len(devices) * n_proc,)
    if len(mesh_shape) != 1 or int(mesh_shape[0]) < 1:
        raise ValueError(f"only 1-D meshes of >= 1 shard are supported, got "
                         f"{tuple(mesh_shape)}")
    n = int(mesh_shape[0])
    if n % n_proc:
        raise ValueError(f"{n} shards do not split over {n_proc} processes")
    per = n // n_proc
    return Mesh(tuple(devices[i % per % len(devices)] for i in range(n)),
                tuple(i // per for i in range(n)),
                process_index() if processes else 0)

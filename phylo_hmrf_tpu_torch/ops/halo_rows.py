"""Row sources of the row-shard kernels K7 (``mf_sweeps_halo``) and K8
(``icm_sweep_halo_``), and what their launches share.

A region's rows are split over the shards of a mesh (``parallel/halo.py``).
A sweep or phase of shard i reads one row beyond each of its edges: the
last row of shard i - 1 and the first row of shard i + 1. Its
``RowSource`` says where that row is read: in the neighbour's own tensor
when the neighbour is on the same device (the kernel reads it in place),
or in a one-row buffer copied from the neighbour's device before each
launch (``remote``, the counterpart of ``ppermute``). At the ends of the
mesh there is no source (``None``): the row reads as zeros (label 0, q 0),
and the weights of the edges into it are 0.

On a mesh that spans processes (``parallel/mesh.py``) a per-shard list
holds ``None`` in the place of a shard of another process. A row of such
a shard is ``remote`` too, and its ``RowSource`` names the ``process``:
the buffer is filled by an exchange with that process
(``parallel/distributed.py::exchange_tensors``, one message per process
and direction), in which this process sends back the rows of its own
shards that the other process reads. Every process makes the same
exchanges in the same order (SPMD).

One launch covers every shard of a device; it chains its sweeps or phases
behind a grid barrier when no source is remote, and runs one sweep or
phase after the exchange otherwise. The plain versions exchange the rows
of every shard with ``extend_rows`` (whatever the devices), as the
per-shard route did.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.parallel.distributed import (all_gather_tensors,
                                                       exchange_tensors)

MAX_SHARDS = 16   # shards of one device a launch takes (csrc/common.cuh)


class RowSource(NamedTuple):
    shard: int      # the shard whose row is read
    row: int        # that row: its last for the row above, 0 for below
    remote: bool    # on another device: copied into a buffer per launch
    process: int | None = None   # its process, when another one owns it


def row_sources(devices, heights, owners=None):
    """(above, below) ``RowSource`` per shard of a 1-D mesh whose shard i
    has ``heights[i]`` rows on ``devices[i]`` (any labels that compare
    equal for one device) in process ``owners[i]`` (default: all in this
    one); ``None`` at the ends of the mesh. A neighbour in another process
    is remote and names that process."""
    n = len(devices)
    if len(heights) != n or min(heights, default=1) < 1:
        raise ValueError(f"row_sources: heights {list(heights)} for {n} "
                         "shards")
    if owners is not None and len(owners) != n:
        raise ValueError(f"row_sources: owners {list(owners)} for {n} "
                         "shards")

    def source(i, j, row):
        if not 0 <= j < n:
            return None
        other = owners is not None and owners[j] != owners[i]
        return RowSource(j, row, other or devices[j] != devices[i],
                         owners[j] if other else None)
    return [(source(i, i - 1, heights[i - 1] - 1), source(i, i + 1, 0))
            for i in range(n)]


def source_peers(sources) -> dict:
    """{shard: its process} of the row sources that another process
    owns."""
    return {s.shard: s.process for pair in sources for s in pair
            if s is not None and s.process is not None}


def first_local(xs):
    """The first tensor of a per-shard list (``None`` marks a shard of
    another process)."""
    return next(x for x in xs if x is not None)


def rows_from_processes(xs, depth: int, owners) -> dict:
    """The rows that the local shards of ``xs`` (rows on axis -2; ``None``
    for a shard of another process) read from a neighbour in another
    process: {(i, 0): the last ``depth`` rows of shard i - 1, (i, 1): the
    first ``depth`` rows of shard i + 1}, each on shard i's device.
    ``owners[j]`` is the process of each shard j that is ``None``. One
    exchange with each neighbouring process, in which this process sends
    the rows of its shards that the other reads; the pieces of a message
    go in the order of the shard boundaries, on both sides."""
    sends, likes, keys = {}, {}, {}
    for j in range(len(xs) - 1):
        a, b = xs[j], xs[j + 1]
        if (a is None) == (b is None):
            continue
        if b is None:    # shard j here, shard j + 1 in another process
            p, key, send, like = owners[j + 1], (j, 1), a[..., -depth:, :], \
                a[..., :depth, :]
        else:
            p, key, send, like = owners[j], (j + 1, 0), b[..., :depth, :], \
                b[..., :depth, :]
        sends.setdefault(p, []).append(send)
        likes.setdefault(p, []).append(like)
        keys.setdefault(p, []).append(key)
    if not sends:
        return {}
    got = exchange_tensors(sends, likes)
    return {k: t for p in keys for k, t in zip(keys[p], got[p])}


def gather_shards(xs, owners, device) -> list:
    """Every shard's tensor of ``xs`` on ``device``, in shard order: the
    local ones moved there, those of other processes (``None`` here; the
    process of shard j is ``owners[j]``) all-gathered from their processes
    in one call. The tensors of all the shards share a shape and dtype."""
    local = [x for x in xs if x is not None]
    if len(local) == len(xs):     # one process: no call
        return [x.to(device) for x in xs]
    got = all_gather_tensors([x.to(device) for x in local],
                             max(Counter(owners).values()))
    taken = {}
    out = []
    for o in owners:
        k = taken[o] = taken.get(o, -1) + 1
        out.append(got[o][k])
    return out


def extend_rows(xs, depth: int = 1, owners=None):
    """Add ``depth`` rows on each side of axis -2 of every shard's tensor:
    the last rows of the shard above and the first rows of the shard below,
    zeros at the ends of the mesh. Each shard needs ``depth`` <= its row
    count. A ``None`` in ``xs`` is a shard of process ``owners[i]`` and
    stays ``None``; the rows of such a neighbour come from
    `rows_from_processes`."""
    far = (rows_from_processes(xs, depth, owners)
           if any(x is None for x in xs) else {})
    out = []
    for i, x in enumerate(xs):
        if x is None:
            out.append(None)
            continue
        shape = list(x.shape)
        shape[-2] = depth
        above = (far[(i, 0)] if (i, 0) in far
                 else xs[i - 1][..., -depth:, :].to(x.device) if i > 0
                 else x.new_zeros(shape))
        below = (far[(i, 1)] if (i, 1) in far
                 else xs[i + 1][..., :depth, :].to(x.device)
                 if i + 1 < len(xs) else x.new_zeros(shape))
        out.append(torch.cat([above, x, below], dim=-2))
    return out


def is_chained(sources) -> bool:
    """True when no row source is remote: one launch a device runs all the
    sweeps or phases."""
    return not any(s is not None and s.remote
                   for pair in sources for s in pair)


def device_groups(xs, sources):
    """{device: [shard indices in order]} of the shards' tensors ``xs``
    (this process's: ``None`` marks a shard of another process). Raises
    when a source that is not remote lies on another device, or a device
    holds more shards than a launch takes."""
    groups = {}
    for i, x in enumerate(xs):
        if x is not None:
            groups.setdefault(x.device, []).append(i)
    for i, pair in enumerate(sources):
        if xs[i] is None:
            continue
        for src in pair:
            if src is not None and not src.remote \
                    and xs[src.shard].device != xs[i].device:
                raise ValueError(f"row source {src} of shard {i} is on "
                                 f"{xs[src.shard].device}, not "
                                 f"{xs[i].device}: mark it remote")
    for dev, idx in groups.items():
        if len(idx) > MAX_SHARDS:
            raise ValueError(f"{len(idx)} shards on {dev}; a launch takes "
                             f"at most {MAX_SHARDS}")
    return groups


def remote_row_buffers(xs, sources):
    """Per shard, [above, below]: a one-row buffer (shape of
    ``x[..., :1, :]``) on the shard's device for each remote source, else
    None (and for a shard of another process)."""
    bufs = []
    for x, pair in zip(xs, sources):
        if x is None:
            bufs.append([None, None])
            continue
        shape = list(x.shape)
        shape[-2] = 1
        bufs.append([torch.empty(shape, dtype=x.dtype, device=x.device)
                     if s is not None and s.remote else None for s in pair])
    return bufs


def fill_remote_rows(bufs, xs, sources) -> None:
    """Copy each remote source's row of ``xs`` into its buffer (PyTorch
    orders a copy between devices after both devices' pending work); the
    row of a shard of another process comes from `rows_from_processes`
    (every process calls this at the same time)."""
    peers = source_peers(sources)
    far = rows_from_processes(xs, 1, peers) if peers else {}
    for i, (pair, bpair) in enumerate(zip(sources, bufs)):
        for side, (src, buf) in enumerate(zip(pair, bpair)):
            if buf is None:
                continue
            buf.copy_(far[(i, side)] if src.process is not None
                      else xs[src.shard][..., src.row:src.row + 1, :])


def neighbour_columns(i, pair, bpair, local):
    """The row-source columns of shard i's table row: pointers of the
    remote buffers above and below (0 if none), then the table indices of
    the neighbours read in place (-1 if none). ``local`` maps a shard to
    its index in the device's table."""
    ptrs = [0 if b is None else b.data_ptr() for b in bpair]
    idx = [local[s.shard] if s is not None and not s.remote else -1
           for s in pair]
    return ptrs + idx


def table(rows) -> np.ndarray:
    """The int64 shard table handed to a C entry point."""
    return np.ascontiguousarray(np.array(rows, dtype=np.int64))


_barriers = {}


def barrier_for(t) -> torch.Tensor:
    """The zeroed grid-barrier word of ``t``'s device and stream. Each
    barrier of a launch flips its top bit and leaves its low bits 0, so it
    serves every launch on that stream (launches on one stream do not
    overlap)."""
    key = (t.device, _build.stream_of(t))
    buf = _barriers.get(key)
    if buf is None:
        buf = _barriers[key] = torch.zeros(1, dtype=torch.int32,
                                           device=t.device)
    return buf

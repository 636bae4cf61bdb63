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

One launch covers every shard of a device; it chains its sweeps or phases
behind a grid barrier when no source is remote, and runs one sweep or
phase after the exchange otherwise. The plain versions exchange the rows
of every shard with ``extend_rows`` (whatever the devices), as the
per-shard route did.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phylo_hmrf_tpu_torch import _build

MAX_SHARDS = 16   # shards of one device a launch takes (csrc/common.cuh)


class RowSource(NamedTuple):
    shard: int      # the shard whose row is read
    row: int        # that row: its last for the row above, 0 for below
    remote: bool    # on another device: copied into a buffer per launch


def row_sources(devices, heights):
    """(above, below) ``RowSource`` per shard of a 1-D mesh whose shard i
    has ``heights[i]`` rows on ``devices[i]`` (any labels that compare
    equal for one device); ``None`` at the ends of the mesh."""
    n = len(devices)
    if len(heights) != n or min(heights, default=1) < 1:
        raise ValueError(f"row_sources: heights {list(heights)} for {n} "
                         "shards")
    out = []
    for i in range(n):
        up = (RowSource(i - 1, heights[i - 1] - 1,
                        devices[i - 1] != devices[i]) if i > 0 else None)
        dn = (RowSource(i + 1, 0, devices[i + 1] != devices[i])
              if i + 1 < n else None)
        out.append((up, dn))
    return out


def extend_rows(xs, depth: int = 1):
    """Add ``depth`` rows on each side of axis -2 of every shard's tensor:
    the last rows of the shard above and the first rows of the shard below,
    zeros at the ends of the mesh. Each shard needs ``depth`` <= its row
    count."""
    out = []
    for i, x in enumerate(xs):
        shape = list(x.shape)
        shape[-2] = depth
        above = (xs[i - 1][..., -depth:, :].to(x.device) if i > 0
                 else x.new_zeros(shape))
        below = (xs[i + 1][..., :depth, :].to(x.device) if i + 1 < len(xs)
                 else x.new_zeros(shape))
        out.append(torch.cat([above, x, below], dim=-2))
    return out


def is_chained(sources) -> bool:
    """True when no row source is remote: one launch a device runs all the
    sweeps or phases."""
    return not any(s is not None and s.remote
                   for pair in sources for s in pair)


def device_groups(xs, sources):
    """{device: [shard indices in order]} of the shards' tensors ``xs``.
    Raises when a source that is not remote lies on another device, or a
    device holds more shards than a launch takes."""
    groups = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.device, []).append(i)
    for i, pair in enumerate(sources):
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
    None."""
    bufs = []
    for x, pair in zip(xs, sources):
        shape = list(x.shape)
        shape[-2] = 1
        bufs.append([torch.empty(shape, dtype=x.dtype, device=x.device)
                     if s is not None and s.remote else None for s in pair])
    return bufs


def fill_remote_rows(bufs, xs, sources) -> None:
    """Copy each remote source's row of ``xs`` into its buffer (PyTorch
    orders a copy between devices after both devices' pending work)."""
    for pair, bpair in zip(sources, bufs):
        for src, buf in zip(pair, bpair):
            if buf is not None:
                buf.copy_(xs[src.shard][..., src.row:src.row + 1, :])


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

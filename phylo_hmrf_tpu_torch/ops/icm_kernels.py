"""K2 and K8: checkerboard ICM on K-major fields, with the CUDA kernels.

Counterpart of ``phylo_hmrf_tpu/ops/icm_pallas.py``: ``icm_sweep_pair``
(K2, the tile kernel of ``csrc/icm.cu``: the eight phases of a sweep pair
in one launch, planned by ``icm_tile_plan``) replaces
``_icm_sweep_pair_padded``, ``icm_sweep_halo_`` (K8: the phases of a sweep
over all the row shards of a device in one launch, ``ops/halo_rows.py``)
replaces ``icm_phase_pallas(halo_extended=True)``, and ``icm_kmajor`` is
the ``icm_pallas`` loop. ``icm_phase_`` (the phase kernel) and
``icm_sweep_pair_chained`` (eight of it) are the reference K2 is held to
on the card, ``icm_sweep_halo_chained`` (it per phase and shard on the
exchanged slabs) that of K8. Layout: labels, mask (R, H, W) int32; unary_k
(R, K, H, W) and wmaps (R, 4, H, W) float32.

On a CPU tensor, or with ``plain=True``, the wrappers run their plain
versions (in their operands' dtype); on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.halo_rows import (
    barrier_for, device_groups, extend_rows, fill_remote_rows, first_local,
    is_chained, neighbour_columns, remote_row_buffers, source_peers, table)
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2

# the four colours of a sweep; two sweeps, in the TPU kernel's order
_SWEEP_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
_PAIR_PHASES = _SWEEP_PHASES * 2
ICM_HALO = 8     # K2's border: 8 phases of radius 1


class ICMTilePlan(NamedTuple):
    th: int         # interior rows of a tile (even)
    tw: int         # interior columns (even)
    threads: int    # threads a block, each owning up to two 2 x 2 quads
    smem: int       # dynamic shared memory bytes a block: labels, the 4
    #                 forward weights, the label-free minimum and its state


def icm_tile(th: int, tw: int, quads_per_thread: int = 2) -> ICMTilePlan:
    """The plan of a th x tw interior (even) with its 8-pixel border."""
    lh, lw = th + 2 * ICM_HALO, tw + 2 * ICM_HALO
    threads = -(-(-(-(lh * lw // 4) // quads_per_thread)) // 32) * 32
    return ICMTilePlan(th, tw, threads, 7 * 4 * lh * lw)


def icm_tile_plan(K: int) -> ICMTilePlan:
    """The tile of K2 for K states: a 56 x 64 interior (72 x 80 loaded, two
    quads a thread, 736 threads), the fastest of the shapes
    ``tools/estep_tiles.py`` timed on an H100 at K = 10 and K = 30. Its
    shared memory does not depend on K: the unary is read from device
    memory."""
    if not 1 <= K <= 32:
        raise ValueError(f"icm_tile_plan: K={K}")
    return icm_tile(56, 64)


def _best_plain(labels, unary_k, wmaps, beta, rows):
    """argmin_k unary - beta * agree at the rows ``rows`` of labels/wmaps
    (all of unary's rows)."""
    R, K = unary_k.shape[:2]
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    agree = unary_k.new_zeros((R, K) + tuple(labels.shape[-2:]))
    for d, (dr, dc) in enumerate(DIRS):
        nb = _shift2(labels, dr, dc, -1)[:, None]
        agree = agree + wmaps[:, d, None] * (nb == ks).to(unary_k.dtype)
        w_bwd = _shift2(wmaps[:, d], -dr, -dc)
        nbm = _shift2(labels, -dr, -dc, -1)[:, None]
        agree = agree + w_bwd[:, None] * (nbm == ks).to(unary_k.dtype)
    score = unary_k - beta * agree[..., rows, :]
    return torch.argmin(score, dim=1).to(torch.int32)


def _phase(H, W, a, b, device):
    rows = torch.arange(H, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    return (rows % 2 == a) & (cols % 2 == b)


def icm_phase_plain(labels, unary_k, wmaps, mask_i, beta, a: int, b: int):
    """Plain version of K2: the labels after one phase (a new tensor)."""
    R, K, H, W = unary_k.shape
    best = _best_plain(labels, unary_k, wmaps, beta, slice(None))
    phase = _phase(H, W, a, b, labels.device)
    return torch.where(phase & (mask_i != 0), best, labels)


def icm_phase_halo_plain(lab_ext, unary_k, w_ext, mask_i, beta, a: int,
                         b: int):
    """One phase of a row shard (the step of K8's plain version): lab_ext
    (R, H+2, W) after one phase of its center rows (a new tensor; the
    halo rows are copied unchanged)."""
    R, K, H, W = unary_k.shape
    center = slice(1, H + 1)
    best = _best_plain(lab_ext, unary_k, w_ext, beta, center)
    phase = _phase(H, W, a, b, lab_ext.device)
    out = lab_ext.clone()
    out[:, center] = torch.where(phase & (mask_i != 0), best,
                                 lab_ext[:, center])
    return out


def icm_phase_(labels, unary_k, wmaps, mask_i, beta, a: int, b: int, *,
               plain: bool = False):
    """One checkerboard phase, updating ``labels`` in place (safe: pixels
    of one colour are never neighbours); returns ``labels``."""
    if plain or labels.device.type == "cpu":
        return labels.copy_(icm_phase_plain(labels, unary_k, wmaps, mask_i,
                                            beta, a, b))
    R, K, H, W = unary_k.shape
    _build.check_tensors(
        "icm_phase_", labels=(labels, torch.int32, (R, H, W)),
        unary_k=(unary_k, torch.float32, (R, K, H, W)),
        wmaps=(wmaps, torch.float32, (R, 4, H, W)),
        mask=(mask_i, torch.int32, (R, H, W)))
    lib = _build.load()
    with _build.on_device(labels):
        _build.check(lib.phmrf_icm_phase(
            labels.data_ptr(), unary_k.data_ptr(), wmaps.data_ptr(),
            mask_i.data_ptr(), R, K, H, W, float(beta), int(a), int(b),
            _build.stream_of(labels)), "K2 icm_phase")
    icm_phase_.launches += 1
    return labels


icm_phase_.launches = 0


def icm_sweep_halo_plain(labels, unary_k, w_ext, mask_i, beta, changed, *,
                         row0, phase0: int = 0, n_phases: int = 4,
                         owners=None):
    """Plain version of K8: for each phase, an exchange of one label row a
    side (``extend_rows``), then ``icm_phase_halo_plain`` on every shard
    with the colour parity of its global rows; labels updated in place,
    the changed labels counted into ``changed[device]``. A shard of
    another process (whose process ``owners`` names) is ``None``."""
    for a, b in _SWEEP_PHASES[phase0:phase0 + n_phases]:
        lab_ext = extend_rows(labels, 1, owners)
        for i, (le, u, w, m) in enumerate(zip(lab_ext, unary_k, w_ext,
                                              mask_i)):
            if le is None:
                continue
            new = icm_phase_halo_plain(le, u, w, m, beta, (a + row0[i]) % 2,
                                       b)[:, 1:-1]
            count = changed[labels[i].device]
            count.add_(torch.count_nonzero(new != labels[i]).to(count.dtype))
            labels[i].copy_(new)
    return labels


def icm_sweep_halo_(labels, unary_k, w_ext, mask_i, beta, changed, *, row0,
                    sources, phase0: int = 0, n_phases: int = 4,
                    plain: bool = False):
    """Checkerboard phases ``phase0 .. phase0 + n_phases - 1`` (of (0,0),
    (0,1), (1,0), (1,1); default one whole sweep) of row shards (K8),
    updating ``labels`` in place.

    Lists per shard: labels, mask_i (1, Hl, W) int32; unary_k (1, K, Hl, W);
    w_ext (1, 4, Hl+2, W), the weights with one exchanged row a side;
    ``row0`` each shard's first global row (its colour parity);
    ``sources`` the (above, below) ``RowSource`` of each shard. The number
    of labels changed on each device's shards is added to
    ``changed[device]`` (one int32). Returns ``labels``. A shard of
    another process is ``None`` in every list. On CUDA: with no remote
    source, one launch a device runs the phases behind a grid barrier;
    otherwise each phase copies the remote rows (exchanges them with the
    other processes), then launches once a device."""
    if plain or first_local(labels).device.type == "cpu":
        return icm_sweep_halo_plain(labels, unary_k, w_ext, mask_i, beta,
                                    changed, row0=row0, phase0=phase0,
                                    n_phases=n_phases,
                                    owners=source_peers(sources))
    if not (0 <= phase0 and n_phases >= 1 and phase0 + n_phases <= 4):
        raise ValueError(f"icm_sweep_halo_: phases {phase0} + {n_phases}")
    u0 = first_local(unary_k)
    K, W = u0.shape[1], u0.shape[-1]
    for i, (lab, u, w, m) in enumerate(zip(labels, unary_k, w_ext, mask_i)):
        if lab is None:
            continue
        Hl = lab.shape[-2]
        _build.check_tensors(
            f"icm_sweep_halo_ shard {i}", labels=(lab, torch.int32, (1, Hl, W)),
            unary_k=(u, torch.float32, (1, K, Hl, W)),
            w_ext=(w, torch.float32, (1, 4, Hl + 2, W)),
            mask=(m, torch.int32, (1, Hl, W)))
    groups = device_groups(labels, sources)
    for dev in groups:
        c = changed.get(dev)
        if c is None or c.device != dev or c.dtype != torch.int32 \
                or c.numel() != 1:
            raise ValueError(f"icm_sweep_halo_: changed needs one int32 on "
                             f"{dev}")
    lib = _build.load()
    rows = None if is_chained(sources) else remote_row_buffers(labels,
                                                               sources)

    def launch(p0, n):
        for dev, idx in groups.items():
            local = {i: j for j, i in enumerate(idx)}
            tab = table([
                [labels[i].data_ptr(), unary_k[i].data_ptr(),
                 mask_i[i].data_ptr(), w_ext[i].data_ptr(),
                 *neighbour_columns(i, sources[i],
                                    rows[i] if rows else (None, None),
                                    local), labels[i].shape[-2],
                 row0[i] % 2] for i in idx])
            first = labels[idx[0]]
            with _build.on_device(first):
                _build.check(lib.phmrf_icm_halo(
                    tab.ctypes.data, len(idx), K, W, p0, n, float(beta),
                    changed[dev].data_ptr(), barrier_for(first).data_ptr(),
                    _build.stream_of(first)), "K8 icm_sweep_halo_")
            icm_sweep_halo_.launches += 1

    if rows is None:
        launch(phase0, n_phases)
    else:
        for p in range(phase0, phase0 + n_phases):
            fill_remote_rows(rows, labels, sources)
            launch(p, 1)
    return labels


icm_sweep_halo_.launches = 0


def icm_sweep_halo_chained(labels, unary_k, w_ext, mask_i, beta, *, row0,
                           phase0: int = 0, n_phases: int = 4):
    """K8's work on the per-shard route it replaced: each phase exchanges
    one label row a side (``extend_rows``), then runs the phase kernel
    (``icm_phase_``) on every shard's (Hl + 2)-row slab, whose padded rows
    have mask 0 (never updated), with the slab rows' colour parity, and
    counts the changed labels. Returns (new labels per shard, the count,
    a 0-d tensor on the first shard's device); ``labels`` is not written.
    The reference K8 is held to on the card (tests, ``chip_smoke.py``); no
    path of the fit calls it. CUDA tensors only."""
    unary_ext = [F.pad(u, (0, 0, 1, 1)) for u in unary_k]
    mask_ext = [F.pad(m, (0, 0, 1, 1)) for m in mask_i]
    labels = [lab.clone() for lab in labels]
    changed = torch.zeros((), dtype=torch.int64, device=labels[0].device)
    for a, b in _SWEEP_PHASES[phase0:phase0 + n_phases]:
        lab_ext = extend_rows(labels, 1)
        for i, (le, u, w, m) in enumerate(zip(lab_ext, unary_ext, w_ext,
                                              mask_ext)):
            icm_phase_(le, u, w, m, beta, (a + row0[i] + 1) % 2, b)
            new = le[:, 1:-1].contiguous()
            changed += torch.count_nonzero(new != labels[i]).to(
                changed.device)
            labels[i] = new
    return labels, changed


def icm_sweep_pair(labels, unary_k, wmaps, mask_i, beta, *,
                   plain: bool = False, row_offset: int = 0, flag=None,
                   tag: int = 1, plan: ICMTilePlan | None = None):
    """Two checkerboard sweeps (eight phases); returns new labels (labels
    is not written). Row r of the arrays has the colour parity of global
    row r + ``row_offset`` (a row shard's slab starts at its first row
    minus the halo depth). On CUDA: one launch of the K2 tile kernel
    (``icm_tile_plan`` unless given). ``flag``, a 0-d int32 tensor, is set
    to ``tag`` iff some label changed. ``plain`` runs the plain version on
    any device."""
    if plain or labels.device.type == "cpu":
        new = labels.clone()
        for a, b in _PAIR_PHASES:
            new = icm_phase_plain(new, unary_k, wmaps, mask_i, beta,
                                  (a + row_offset) % 2, b)
        if flag is not None and bool(torch.any(new != labels)):
            flag.fill_(tag)
        return new
    R, K, H, W = unary_k.shape
    plane = (R, H, W)
    specs = dict(labels=(labels, torch.int32, plane),
                 unary_k=(unary_k, torch.float32, (R, K, H, W)),
                 wmaps=(wmaps, torch.float32, (R, 4, H, W)),
                 mask=(mask_i, torch.int32, plane))
    if flag is not None:
        specs["flag"] = (flag, torch.int32, ())
    _build.check_tensors("icm_sweep_pair", **specs)
    plan = icm_tile_plan(K) if plan is None else plan
    out = torch.empty_like(labels)
    with _build.on_device(labels):
        _build.check(_build.load().phmrf_icm_pair(
            labels.data_ptr(), out.data_ptr(), unary_k.data_ptr(),
            wmaps.data_ptr(), mask_i.data_ptr(), R, K, H, W, float(beta),
            row_offset % 2, plan.th, plan.tw, plan.threads,
            0 if flag is None else flag.data_ptr(), int(tag),
            _build.stream_of(labels)), "K2 icm_sweep_pair")
    icm_sweep_pair.launches += 1
    return out


icm_sweep_pair.launches = 0


def icm_sweep_pair_chained(labels, unary_k, wmaps, mask_i, beta, *,
                           row_offset: int = 0):
    """The sweep pair as eight launches of the phase kernel
    (``icm_phase_``) on a copy of ``labels``: the reference the K2 tile
    kernel is held to on the card (tests, ``chip_smoke.py``); no path of
    the fit calls it."""
    new = labels.clone()
    for a, b in _PAIR_PHASES:
        icm_phase_(new, unary_k, wmaps, mask_i, beta, (a + row_offset) % 2, b)
    return new


def icm_kmajor(unary_k, wmaps, mask, init_labels, beta,
               max_sweeps: int = 60, *, plain: bool = False):
    """Batched checkerboard ICM (the ``icm_pallas`` loop).

    Runs sweep pairs while any label of the bucket changed and fewer than
    ``max_sweeps`` sweeps ran; like the JAX loop, a capped run may
    overshoot an odd ``max_sweeps`` by one sweep. Each pair sets a device
    word to its own tag iff some label changed, read once per pair (one
    host sync). Returns labels (R, H, W) int32."""
    mask_i = mask.to(torch.int32)
    labels = torch.where(mask, init_labels, 0).to(torch.int32).contiguous()
    flag = torch.zeros((), dtype=torch.int32, device=labels.device)
    changed, sweep = True, 0
    while changed and sweep < max_sweeps:
        tag = sweep // 2 + 1
        labels = icm_sweep_pair(labels, unary_k, wmaps, mask_i, beta,
                                plain=plain, flag=flag, tag=tag)
        changed = int(flag) == tag
        sweep += 2
    return labels

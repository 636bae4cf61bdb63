"""K1 and K7: annealed mean field on K-major fields, with the CUDA sweep
kernels.

Counterpart of ``phylo_hmrf_tpu/ops/mf_pallas.py``: ``mf_sweeps`` (K1, the
tile kernel of ``csrc/mf.cu``: up to 8 sweeps a launch on shared-memory
tiles, planned by ``mf_tile_plan``) replaces ``mf_sweeps_pallas``,
``mf_sweeps_halo`` (K7: the sweeps of all the row shards of a device in
one launch, ``ops/halo_rows.py``) replaces
``mf_sweep_pallas(halo_extended=True)``, and ``mean_field_kmajor``
replaces ``mean_field_pallas_kmajor``. ``mf_sweeps_chained`` runs the
one-sweep kernel once per sweep: the reference K1 is held to bitwise on the
card; ``mf_sweeps_halo_chained`` runs it per sweep and shard on the
exchanged slabs, the reference of K7. Layout: q, base, unary_k
(R, K, H, W); wmaps (R, 4, H, W); float32.

On a CPU tensor, or with ``plain=True``, the wrappers run their plain
versions (``mf_sweeps_plain``, ``mf_sweeps_halo_plain``); on a CUDA tensor
they launch the kernel or raise. The per-E-step ``base`` and the final
argmin stay plain tensor code, as they stay XLA code in the JAX package.
The plain versions keep their operands' dtype; in float64 the softmax
over the states and the incident weight sum take a fixed order
(``ops/potts.py``), so a pixel's sweep is bitwise the same on a row
shard's slab and on the whole grid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.halo_rows import (
    barrier_for, device_groups, extend_rows, fill_remote_rows, is_chained,
    neighbour_columns, remote_row_buffers, table)
from phylo_hmrf_tpu_torch.ops.icm import MF_TEMPS
from phylo_hmrf_tpu_torch.ops.potts import pinned, softmax


def _shift2(x: torch.Tensor, dr: int, dc: int, fill=0) -> torch.Tensor:
    """result[..., r, c] = x[..., r + dr, c + dc], ``fill`` outside (the
    last two axes are rows and columns)."""
    H, W = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    r0, r1 = max(0, -dr), H - max(0, dr)
    c0, c1 = max(0, -dc), W - max(0, dc)
    out[..., r0:r1, c0:c1] = x[..., r0 + dr:r1 + dr, c0 + dc:c1 + dc]
    return out


def _sweep_plain(q, q_c, base, wmaps, w_bwd, T, damp, beta, rows):
    """One Jacobi sweep: the agreement over all rows of q, then the update
    of the center rows ``rows`` (q_c = q[..., rows, :])."""
    agree = torch.zeros_like(q)
    for d, (dr, dc) in enumerate(DIRS):
        # forward edge: neighbour at (+dr, +dc), weight at the pixel
        agree = agree + wmaps[:, d, None] * _shift2(q, dr, dc)
        # backward edge: neighbour at (-dr, -dc), weight at the neighbour
        agree = agree + w_bwd[d][:, None] * _shift2(q, -dr, -dc)
    field = base - beta * agree[..., rows, :]
    z = -field / T
    if pinned(z.dtype):
        return damp * q_c + (1.0 - damp) * softmax(z, dim=1)
    z = z - torch.amax(z, dim=1, keepdim=True)
    e = torch.exp(z)
    return damp * q_c + (1.0 - damp) * (e / torch.sum(e, dim=1, keepdim=True))


def _w_bwd(wmaps):
    return [_shift2(wmaps[:, d], -dr, -dc) for d, (dr, dc) in enumerate(DIRS)]


def mf_sweeps_plain(q, base, wmaps, T, damp, beta, n_inner: int):
    """Plain version of K1: ``n_inner`` Jacobi sweeps at temperature T."""
    w_bwd = _w_bwd(wmaps)
    every = slice(None)
    for _ in range(n_inner):
        q = _sweep_plain(q, q, base, wmaps, w_bwd, T, damp, beta, every)
    return q


def mf_sweep_halo_plain(q_ext, base, w_ext, T, damp, beta):
    """One sweep of the center rows of a row shard (the step of K7's plain
    version). q_ext (R, K, H+2, W) and w_ext (R, 4, H+2, W) carry one exchanged row
    on each side; base (R, K, H, W). Returns the new center q."""
    center = slice(1, q_ext.shape[-2] - 1)
    return _sweep_plain(q_ext, q_ext[..., center, :], base, w_ext,
                        _w_bwd(w_ext), T, damp, beta, center)


SMEM_MAX = 232_448      # dynamic shared memory of one H100 block
MF_MAX_DEPTH = 8        # sweeps one K1 launch can run (csrc/mf.cu)
MF_MAX_PX = 2 * 1024    # tile pixels: two a thread, 1024 threads
# the most a tile may recompute: loaded pixels over interior pixels
MF_MAX_HALO_RATIO = 2.5


class MFTilePlan(NamedTuple):
    th: int         # interior rows of a tile
    tw: int         # interior columns
    depth: int      # halo = sweeps one launch can run
    threads: int    # threads a block
    smem: int       # dynamic shared memory bytes a block
    launches: int   # launches for n_inner sweeps


def mf_smem_per_pixel(K: int) -> int:
    """Shared memory a tile pixel takes in K1: q and base (K floats each)
    and the next q (max(K, 4) floats)."""
    return 4 * (2 * K + max(K, 4))


@functools.lru_cache(maxsize=None)
def mf_tile_plan(K: int, n_inner: int) -> MFTilePlan:
    """The tile of K1 for K states and ``n_inner`` sweeps: the fewest
    launches whose depth (ceil(n_inner / launches) <= 8) leaves a tile
    whose loaded pixels are at most ``MF_MAX_HALO_RATIO`` times its
    interior, and the tile of least ratio that shared memory holds at
    that depth (ties: the wider). One launch per temperature for K <= 10;
    two from K = 11 on."""
    if not 1 <= K <= 32 or n_inner < 1:
        raise ValueError(f"mf_tile_plan: K={K}, n_inner={n_inner}")
    max_px = min(SMEM_MAX // mf_smem_per_pixel(K), MF_MAX_PX)
    for launches in range(1, n_inner + 1):
        depth = -(-n_inner // launches)
        if depth > MF_MAX_DEPTH:
            continue
        best = None
        for lw in range(2 * depth + 1, max_px // (2 * depth + 1) + 1):
            lh = max_px // lw
            th, tw = lh - 2 * depth, lw - 2 * depth
            if th < 1:
                continue
            key = (lh * lw / (th * tw), -tw)
            if best is None or key < best[0]:
                best = (key, th, tw, lh * lw)
        if best[0][0] <= MF_MAX_HALO_RATIO or depth == 1:
            _, th, tw, npx = best
            per = -(-npx // 1024)
            threads = -(-(-(-npx // per)) // 32) * 32
            return MFTilePlan(th, tw, depth, threads,
                              npx * mf_smem_per_pixel(K), launches)
    raise AssertionError("unreachable: depth 1 always plans")


def mf_sweeps(q, base, wmaps, T, damp, beta, *, n_inner: int,
              plan: MFTilePlan | None = None, plain: bool = False):
    """``n_inner`` damped mean-field sweeps at temperature ``T``.

    q, base (R, K, H, W); wmaps (R, 4, H, W). Returns the new q (a new
    tensor; q is never written). On CUDA: the K1 tile kernel, one launch
    per ``plan.depth`` sweeps (``mf_tile_plan`` unless given), over two
    buffers when it takes several."""
    if plain or q.device.type == "cpu":
        return mf_sweeps_plain(q, base, wmaps, T, damp, beta, n_inner)
    R, K, H, W = q.shape
    _build.check_tensors("mf_sweeps", q=(q, torch.float32, (R, K, H, W)),
                         base=(base, torch.float32, (R, K, H, W)),
                         wmaps=(wmaps, torch.float32, (R, 4, H, W)))
    plan = mf_tile_plan(K, n_inner) if plan is None else plan
    lib = _build.load()
    stream = _build.stream_of(q)
    n_launch = -(-n_inner // plan.depth)
    bufs = [torch.empty_like(q), torch.empty_like(q) if n_launch > 1 else None]
    cur, left = q, n_inner
    with _build.on_device(q):
        for i in range(n_launch):
            n, dst = min(plan.depth, left), bufs[i % 2]
            _build.check(lib.phmrf_mf_tiles(
                cur.data_ptr(), base.data_ptr(), wmaps.data_ptr(),
                dst.data_ptr(), R, K, H, W, n, float(T), float(damp),
                float(1.0 - damp), float(beta), plan.th, plan.tw, plan.depth,
                plan.threads, stream), "K1 mf_sweeps")
            mf_sweeps.launches += 1
            cur, left = dst, left - n
    return cur


mf_sweeps.launches = 0


def mf_sweeps_chained(q, base, wmaps, T, damp, beta, *, n_inner: int):
    """``n_inner`` sweeps as ``n_inner`` launches of the one-sweep kernel
    over two buffers: the reference the K1 tile kernel is held to bitwise
    on the card (tests, ``chip_smoke.py``); no path of the fit calls it.
    CUDA tensors only."""
    R, K, H, W = q.shape
    _build.check_tensors("mf_sweeps_chained",
                         q=(q, torch.float32, (R, K, H, W)),
                         base=(base, torch.float32, (R, K, H, W)),
                         wmaps=(wmaps, torch.float32, (R, 4, H, W)))
    lib = _build.load()
    stream = _build.stream_of(q)
    bufs = [torch.empty_like(q), torch.empty_like(q) if n_inner > 1 else None]
    cur = q
    with _build.on_device(q):
        for i in range(n_inner):
            dst = bufs[i % 2]
            _build.check(lib.phmrf_mf_sweep(
                cur.data_ptr(), base.data_ptr(), wmaps.data_ptr(),
                dst.data_ptr(), R, K, H, W, float(T), float(damp),
                float(1.0 - damp), float(beta), stream), "mf_sweeps_chained")
            cur = dst
    return cur


MF_HALO_MAX_ROWS = 8    # rows of a K7 tile, a warp each (csrc/mf.cu)


def mf_halo_rows(heights) -> int:
    """Rows of K7's tiles for shards of ``heights`` rows: the tallest
    shard's, at most ``MF_HALO_MAX_ROWS``."""
    return max(1, min(MF_HALO_MAX_ROWS, max(heights)))


def mf_sweeps_halo_plain(q, base, w_ext, T, damp, beta, n_sweeps: int):
    """Plain version of K7: ``n_sweeps`` sweeps of the row shards, each an
    exchange of one row a side (``extend_rows``) and ``mf_sweep_halo_plain``
    on every shard. Returns the new q per shard."""
    q = list(q)
    for _ in range(n_sweeps):
        q = [mf_sweep_halo_plain(qe, b, w, T, damp, beta) for qe, b, w in
             zip(extend_rows(q, 1), base, w_ext)]
    return q


def mf_sweeps_halo(q, base, w_ext, T, damp, beta, *, n_sweeps: int,
                   sources, plain: bool = False):
    """``n_sweeps`` damped mean-field sweeps of row shards (K7).

    Lists per shard: q, base (1, K, Hl, W); w_ext (1, 4, Hl+2, W), the
    weights with one exchanged row a side (zeros at the mesh ends);
    ``sources`` the (above, below) ``RowSource`` of each shard
    (``row_sources``). Returns the new q per shard (new tensors; q is never
    written). On CUDA: with no remote source, one launch a device runs
    all the sweeps behind a grid barrier; otherwise each sweep copies the
    remote rows, then launches once a device."""
    if n_sweeps < 1:
        return list(q)
    if plain or q[0].device.type == "cpu":
        return mf_sweeps_halo_plain(q, base, w_ext, T, damp, beta, n_sweeps)
    K, W = q[0].shape[1], q[0].shape[-1]
    heights = [x.shape[-2] for x in q]
    for i, (x, b, w) in enumerate(zip(q, base, w_ext)):
        Hl = heights[i]
        _build.check_tensors(
            f"mf_sweeps_halo shard {i}", q=(x, torch.float32, (1, K, Hl, W)),
            base=(b, torch.float32, (1, K, Hl, W)),
            w_ext=(w, torch.float32, (1, 4, Hl + 2, W)))
    groups = device_groups(q, sources)
    chained = is_chained(sources)
    th = mf_halo_rows(heights)
    lib = _build.load()
    bufs = [(torch.empty_like(x),
             torch.empty_like(x) if n_sweeps > 1 else None) for x in q]
    rows = None if chained else remote_row_buffers(q, sources)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def launch(src, n, write):
        for dev, idx in groups.items():
            local = {i: j for j, i in enumerate(idx)}
            tab = table([
                [src[i].data_ptr(), ptr(bufs[i][write]),
                 ptr(bufs[i][1 - write]), base[i].data_ptr(),
                 w_ext[i].data_ptr(),
                 *neighbour_columns(i, sources[i],
                                    rows[i] if rows else (None, None),
                                    local), heights[i]] for i in idx])
            first = q[idx[0]]
            with _build.on_device(first):
                _build.check(lib.phmrf_mf_halo(
                    tab.ctypes.data, len(idx), K, W, th, n, float(T),
                    float(damp), float(1.0 - damp), float(beta),
                    barrier_for(first).data_ptr(), _build.stream_of(first)),
                    "K7 mf_sweeps_halo")
            mf_sweeps_halo.launches += 1

    if chained:
        launch(q, n_sweeps, 0)
        return [b[(n_sweeps - 1) & 1] for b in bufs]
    cur = list(q)
    for s in range(n_sweeps):
        fill_remote_rows(rows, cur, sources)
        launch(cur, 1, s & 1)
        cur = [b[s & 1] for b in bufs]
    return cur


mf_sweeps_halo.launches = 0


def mf_sweeps_halo_chained(q, base, w_ext, T, damp, beta, *, n_sweeps: int):
    """K7's work on the per-shard route it replaced: each sweep exchanges
    one row a side (``extend_rows``), then runs the one-sweep kernel
    on every shard's (Hl + 2)-row slab (base padded with zero rows) and
    keeps its center rows, which it computes op for op as the per-shard
    kernel with a one-row halo did. The reference K7 is held to bitwise on
    the card (tests, ``chip_smoke.py``); no path of the fit calls it. CUDA
    tensors only."""
    base_ext = [F.pad(b, (0, 0, 1, 1)) for b in base]
    q = list(q)
    for _ in range(n_sweeps):
        q = [mf_sweeps_chained(qe, be, w, T, damp, beta, n_inner=1)
             [..., 1:-1, :].contiguous() for qe, be, w in
             zip(extend_rows(q, 1), base_ext, w_ext)]
    return q


def incident_weight_sum(wmaps):
    """(R, H, W): the weights of the edges at each pixel, forward and
    backward, added direction by direction: the order ``parallel/halo.py``
    adds them on a row shard's halo-extended weights."""
    wsum = torch.zeros_like(wmaps[:, 0])
    for d, (dr, dc) in enumerate(DIRS):
        wsum = wsum + wmaps[:, d] + _shift2(wmaps[:, d], -dr, -dc)
    return wsum


def expected_field_sums(qk, wmaps):
    """(agree (R, K, H, W), wsum (R, H, W)) of the expected field, with the
    adds in `neighbor_sums_soft`'s order: the final hard assignment of the
    mean field is argmin_k unary + beta * (wsum - agree)."""
    agree = torch.zeros_like(qk)
    wsum = torch.zeros_like(qk[:, 0])
    for d, (dr, dc) in enumerate(DIRS):
        w = wmaps[:, d]
        agree = agree + w[:, None] * _shift2(qk, dr, dc)
        wsum = wsum + w
        agree = agree + _shift2(w[:, None] * qk, -dr, -dc)
        wsum = wsum + _shift2(w, -dr, -dc)
    return agree, wsum


def mean_field_kmajor(unary_k: torch.Tensor, wmaps: torch.Tensor,
                      beta: float, temps=MF_TEMPS, iters_per_temp: int = 8,
                      damping: float = 0.5, *, plain: bool = False
                      ) -> torch.Tensor:
    """Annealed mean field on a K-major unary (R, K, H, W); returns labels
    (R, H, W) int32. ``plain`` runs the sweeps' plain version on any
    device (the reference the kernel path is checked against)."""
    qk = softmax(-unary_k, dim=1)
    # wsum[p] = sum_d (w_d[p] + w_d[p - (dr, dc)]): constant per E-step
    if pinned(unary_k.dtype):
        wsum = incident_weight_sum(wmaps)
    else:
        wsum = torch.sum(wmaps, dim=1)
        for d, (dr, dc) in enumerate(DIRS):
            wsum = wsum + _shift2(wmaps[:, d], -dr, -dc)
    base = unary_k + beta * wsum[:, None]
    for T in temps:
        qk = mf_sweeps(qk, base, wmaps, T, damping, beta,
                       n_inner=iters_per_temp, plain=plain)
    # final hard assignment: argmin of the expected field
    agree, wsum = expected_field_sums(qk, wmaps)
    field = unary_k + beta * (wsum[:, None] - agree)
    return torch.argmin(field, dim=1).to(torch.int32)

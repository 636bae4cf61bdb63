"""K1 and K7: annealed mean field on K-major fields, with the CUDA sweep
kernels.

Counterpart of ``phylo_hmrf_tpu/ops/mf_pallas.py``: ``mf_sweeps`` (K1, the
tile kernel of ``csrc/mf.cu``: up to 8 sweeps a launch on shared-memory
tiles, planned by ``mf_tile_plan``) replaces ``mf_sweeps_pallas``,
``mf_sweep_halo`` (K7, the one-sweep kernel of ``csrc/mf.cu`` with a
1-row halo) replaces ``mf_sweep_pallas(halo_extended=True)``, and
``mean_field_kmajor`` replaces ``mean_field_pallas_kmajor``.
``mf_sweeps_chained`` runs the one-sweep kernel once per sweep: the
reference K1 is held to bitwise on the card. Layout: q, base, unary_k
(R, K, H, W); wmaps (R, 4, H, W); float32.

On a CPU tensor the wrappers run their plain versions
(``mf_sweeps_plain``, ``mf_sweep_halo_plain``); on a CUDA tensor they
launch the kernel or raise. The per-E-step ``base`` and the final argmin
stay plain tensor code, as they stay XLA code in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.icm import MF_TEMPS


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
    """Plain version of K7: one sweep of the center rows of a row shard.
    q_ext (R, K, H+2, W) and w_ext (R, 4, H+2, W) carry one exchanged row
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
              plan: MFTilePlan | None = None):
    """``n_inner`` damped mean-field sweeps at temperature ``T``.

    q, base (R, K, H, W); wmaps (R, 4, H, W). Returns the new q (a new
    tensor; q is never written). On CUDA: the K1 tile kernel, one launch
    per ``plan.depth`` sweeps (``mf_tile_plan`` unless given), over two
    buffers when it takes several."""
    if q.device.type == "cpu":
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
    (K7's code with no halo rows) over two buffers: the reference the K1
    tile kernel is held to bitwise on the card (tests, ``chip_smoke.py``);
    no path of the fit calls it. CUDA tensors only."""
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
                dst.data_ptr(), R, K, H, W, 0, float(T), float(damp),
                float(1.0 - damp), float(beta), stream), "mf_sweeps_chained")
            cur = dst
    return cur


def mf_sweep_halo(q_ext, base, w_ext, T, damp, beta):
    """One damped mean-field sweep of a row shard (K7): q_ext
    (R, K, H+2, W) and w_ext (R, 4, H+2, W) carry the neighbouring shards'
    boundary rows (zeros at the mesh ends), base (R, K, H, W) the center
    only. Returns the new center q (R, K, H, W), a new tensor."""
    if q_ext.device.type == "cpu":
        return mf_sweep_halo_plain(q_ext, base, w_ext, T, damp, beta)
    R, K, H, W = base.shape
    _build.check_tensors(
        "mf_sweep_halo", q_ext=(q_ext, torch.float32, (R, K, H + 2, W)),
        base=(base, torch.float32, (R, K, H, W)),
        w_ext=(w_ext, torch.float32, (R, 4, H + 2, W)))
    lib = _build.load()
    out = torch.empty_like(base)
    with _build.on_device(out):
        _build.check(lib.phmrf_mf_sweep(
            q_ext.data_ptr(), base.data_ptr(), w_ext.data_ptr(),
            out.data_ptr(), R, K, H, W, 1, float(T), float(damp),
            float(1.0 - damp), float(beta), _build.stream_of(out)),
            "K7 mf_sweep_halo")
    mf_sweep_halo.launches += 1
    return out


mf_sweep_halo.launches = 0


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
    sweeps = mf_sweeps_plain if plain else mf_sweeps
    qk = F.softmax(-unary_k, dim=1)
    # wsum[p] = sum_d (w_d[p] + w_d[p - (dr, dc)]): constant per E-step
    wsum = torch.sum(wmaps, dim=1)
    for d, (dr, dc) in enumerate(DIRS):
        wsum = wsum + _shift2(wmaps[:, d], -dr, -dc)
    base = unary_k + beta * wsum[:, None]
    for T in temps:
        qk = sweeps(qk, base, wmaps, T, damping, beta, n_inner=iters_per_temp)
    # final hard assignment: argmin of the expected field
    agree, wsum = expected_field_sums(qk, wmaps)
    field = unary_k + beta * (wsum[:, None] - agree)
    return torch.argmin(field, dim=1).to(torch.int32)

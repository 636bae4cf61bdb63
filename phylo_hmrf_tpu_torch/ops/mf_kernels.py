"""K1 and K7: annealed mean field on K-major fields, with the CUDA sweep
kernel.

Counterpart of ``phylo_hmrf_tpu/ops/mf_pallas.py``: ``mf_sweeps`` (K1)
replaces ``mf_sweeps_pallas``, ``mf_sweep_halo`` (K7) replaces
``mf_sweep_pallas(halo_extended=True)`` (both kernels in ``csrc/mf.cu``),
and ``mean_field_kmajor`` replaces ``mean_field_pallas_kmajor``. Layout: q,
base, unary_k (R, K, H, W); wmaps (R, 4, H, W); float32.

On a CPU tensor the wrappers run their plain versions
(``mf_sweeps_plain``, ``mf_sweep_halo_plain``); on a CUDA tensor they
launch the kernel or raise. The per-E-step ``base`` and the final argmin
stay plain tensor code, as they stay XLA code in the JAX package.
"""

from __future__ import annotations

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


def mf_sweeps(q, base, wmaps, T, damp, beta, *, n_inner: int):
    """``n_inner`` damped mean-field sweeps at temperature ``T``.

    q, base (R, K, H, W); wmaps (R, 4, H, W). Returns the new q (a new
    tensor; q is never written). On CUDA: one kernel launch per sweep over
    two ping-pong buffers, since a sweep must read the old q everywhere."""
    if q.device.type == "cpu":
        return mf_sweeps_plain(q, base, wmaps, T, damp, beta, n_inner)
    R, K, H, W = q.shape
    _build.check_tensors("mf_sweeps", q=(q, torch.float32, (R, K, H, W)),
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
                float(1.0 - damp), float(beta), stream), "K1 mf_sweep")
            mf_sweeps.launches += 1
            cur = dst
    return cur


mf_sweeps.launches = 0


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

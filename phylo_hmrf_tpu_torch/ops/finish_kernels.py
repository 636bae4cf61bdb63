"""K3 (Potts energy) and K4 (posterior / cost / stats pass), K-major.

Counterpart of ``phylo_hmrf_tpu/ops/finish_pallas.py``: ``potts_energy``
replaces ``potts_energy_pallas`` and ``finish_stats`` replaces
``finish_stats_pallas``; both kernels are in ``csrc/finish.cu``. Layout:
unary_k / logprob_k (R, K, H, W), img_f (R, F, H, W), wmaps (R, 4, H, W)
float32; mask, labels (R, H, W) int32.

Both reduce in a fixed order (per-tile partial sums, then the tiles of a
region in order, in float64), so repeated calls are bitwise equal. The
plain versions accumulate in float64 as well. On a CPU tensor the wrappers
run the plain version; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2


def _f32(x: float) -> float:
    """The float32 value the kernels receive for a Python scalar."""
    return float(np.float32(x))


def potts_energy_plain(unary_k, mask_i, labels, wmaps, beta):
    """Plain version of K3: per-region energy (R,) float32."""
    K = unary_k.shape[1]
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    onehot = (labels[:, None] == ks).to(unary_k.dtype)
    u_at = torch.sum(unary_k * onehot, dim=1)
    e_u = torch.where(mask_i != 0, u_at, 0.0).double().sum(dim=(1, 2))
    e_p = torch.zeros_like(e_u)
    for d, (dr, dc) in enumerate(DIRS):
        nb = _shift2(labels, dr, dc, -1)
        diff = (labels != nb).to(wmaps.dtype)
        e_p = e_p + (wmaps[:, d] * diff).double().sum(dim=(1, 2))
    return (e_u + _f32(beta) * e_p).to(torch.float32)


def potts_energy(unary_k, mask_i, labels, wmaps, beta):
    """Per-region MRF energy sum_p(valid) unary[p, s_p]
    + beta * sum_d sum_p w_d[p] [s_p != s_{p+d}] (forward edges). (R,)."""
    if unary_k.device.type == "cpu":
        return potts_energy_plain(unary_k, mask_i, labels, wmaps, beta)
    R, K, H, W = unary_k.shape
    _build.check_tensors(
        "potts_energy", unary_k=(unary_k, torch.float32, (R, K, H, W)),
        mask=(mask_i, torch.int32, (R, H, W)),
        labels=(labels, torch.int32, (R, H, W)),
        wmaps=(wmaps, torch.float32, (R, 4, H, W)))
    lib = _build.load()
    n_tiles = lib.phmrf_energy_tiles(H)
    partial = torch.empty(R * n_tiles * 2, dtype=torch.float64,
                          device=unary_k.device)
    out = torch.empty(R, dtype=torch.float32, device=unary_k.device)
    with _build.on_device(out):
        _build.check(lib.phmrf_potts_energy(
            unary_k.data_ptr(), mask_i.data_ptr(), labels.data_ptr(),
            wmaps.data_ptr(), partial.data_ptr(), out.data_ptr(), R, K, H, W,
            float(beta), _build.stream_of(out)), "K3 potts_energy")
    potts_energy.launches += 1
    return out


potts_energy.launches = 0


def finish_stats_plain(lp_k, img_f, mask_i, labels, wpp, beta, small_eps,
                       negate: bool = False, float64: bool = False):
    """Plain version of K4 (same outputs as `finish_stats`)."""
    R, K, H, W = lp_k.shape
    Fd = img_f.shape[1]
    logprob = -lp_k if negate else lp_k
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    agree = torch.zeros_like(logprob)
    wsum = torch.zeros_like(logprob[:, 0])
    for d, (dr, dc) in enumerate(DIRS):
        w = wpp[:, d]
        nb = _shift2(labels, dr, dc, -1)[:, None]
        agree = agree + w[:, None] * (nb == ks).to(w.dtype)
        wsum = wsum + w
        w_bwd = _shift2(w, -dr, -dc)
        nbm = _shift2(labels, -dr, -dc, -1)[:, None]
        agree = agree + w_bwd[:, None] * (nbm == ks).to(w.dtype)
        wsum = wsum + w_bwd
    pp = beta * (wsum[:, None] - agree)

    z1 = logprob - pp
    e1 = torch.exp(z1 - torch.amax(z1, dim=1, keepdim=True))
    g = e1 / torch.sum(e1, dim=1, keepdim=True)
    z2 = -pp - torch.amax(-pp, dim=1, keepdim=True)
    e2 = torch.exp(z2)
    ppn = e2 / torch.sum(e2, dim=1, keepdim=True)

    onehot = (labels[:, None] == ks).to(logprob.dtype)
    valid = mask_i != 0
    pp_map = torch.sum(pp * onehot, dim=1)
    lp_map = torch.sum(logprob * onehot, dim=1)
    ppn_map = torch.sum(ppn * onehot, dim=1)

    def vsum(v):
        return torch.where(valid, v, 0.0).double().sum(dim=(1, 2))

    zero = torch.zeros(R, dtype=torch.float64, device=lp_k.device)
    sums = torch.stack([vsum(pp_map), vsum(torch.log(ppn_map + small_eps)),
                        vsum(lp_map), valid.double().sum(dim=(1, 2)),
                        zero, zero, zero, zero], dim=1)
    gm = torch.where(valid[:, None], g, 0.0).double().reshape(R, K, H * W)
    x = img_f.double().reshape(R, Fd, H * W)
    xx = (x[:, :, None] * x[:, None, :]).reshape(R, Fd * Fd, H * W)
    post = gm.sum(dim=-1)
    obs = torch.einsum("rkn,rfn->rkf", gm, x)
    obs2 = torch.einsum("rkn,rqn->rkq", gm, xx).reshape(R, K, Fd, Fd)
    out = (post, obs, obs2, sums)
    return out if float64 else tuple(t.float() for t in out)


def cost_vec_from_sums(sums):
    """(sums (R, 8) of `finish_stats`) -> (cost_vec (R, 4) = [pairwise,
    pairwise_nrm, unary, cost1] as means over the valid pixels (the JAX
    `posteriors_and_costs` semantics), n_valid (R,))."""
    n_valid = sums[:, 3]
    nv = torch.clamp(n_valid, min=1.0)
    pairwise_cost = sums[:, 0] / nv
    pairwise_nrm = -sums[:, 1] / nv
    unary_cost = -sums[:, 2] / nv
    return torch.stack([pairwise_cost, pairwise_nrm, unary_cost,
                        unary_cost + pairwise_nrm], dim=-1), n_valid


def finish_stats(lp_k, img_f, mask_i, labels, wpp, beta, small_eps, *,
                 negate: bool = False, float64: bool = False):
    """Fused posterior / cost / stats pass over a region batch.

    lp_k (R, K, H, W) log-densities, or with ``negate`` the unary
    (-logprob), flipped inside (bitwise identical, no second K-major
    tensor). wpp (R, 4, H, W) are the pairwise-potential weights
    (`weight_maps` for estimate_type 3, `valid_maps` otherwise). Returns
    (post (R, K), obs (R, K, F), obs2 (R, K, F, F),
    sums (R, 8) = [pp_sum, ppn_sum, lp_sum, n_valid, 0, 0, 0, 0]), float32,
    or with ``float64`` the float64 sums before their one rounding (for
    adding up the row shards of a region)."""
    if lp_k.device.type == "cpu":
        return finish_stats_plain(lp_k, img_f, mask_i, labels, wpp, beta,
                                  small_eps, negate, float64)
    R, K, H, W = lp_k.shape
    Fd = img_f.shape[1]
    _build.check_tensors(
        "finish_stats", lp_k=(lp_k, torch.float32, (R, K, H, W)),
        img_f=(img_f, torch.float32, (R, Fd, H, W)),
        mask=(mask_i, torch.int32, (R, H, W)),
        labels=(labels, torch.int32, (R, H, W)),
        wpp=(wpp, torch.float32, (R, 4, H, W)))
    lib = _build.load()
    nstat = K * (1 + Fd + Fd * Fd)
    nout = nstat + 4
    n_tiles = lib.phmrf_finish_tiles(H)
    dev = lp_k.device
    partial = torch.empty(R * n_tiles * nout, dtype=torch.float64, device=dev)
    dtype = torch.float64 if float64 else torch.float32
    out = torch.empty(R, nout, dtype=dtype, device=dev)
    with _build.on_device(out):
        _build.check(lib.phmrf_finish_stats(
            lp_k.data_ptr(), img_f.data_ptr(), mask_i.data_ptr(),
            labels.data_ptr(), wpp.data_ptr(), partial.data_ptr(),
            out.data_ptr(), R, K, Fd, H, W, float(beta), float(small_eps),
            int(bool(negate)), int(bool(float64)), _build.stream_of(out)),
            "K4 finish_stats")
    finish_stats.launches += 1
    post = out[:, :K]
    obs = out[:, K:K + K * Fd].reshape(R, K, Fd)
    obs2 = out[:, K + K * Fd:nstat].reshape(R, K, Fd, Fd)
    sums = torch.cat([out[:, nstat:], out.new_zeros(R, 4)], dim=1)
    return post, obs, obs2, sums


finish_stats.launches = 0

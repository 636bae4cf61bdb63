"""K3 (Potts energy) and K4 (posterior / cost / stats pass), K-major.

Counterpart of ``phylo_hmrf_tpu/ops/finish_pallas.py``: ``potts_energy``
replaces ``potts_energy_pallas`` and ``finish_stats`` replaces
``finish_stats_pallas``; both kernels are in ``csrc/finish.cu``. Layout:
unary_k / logprob_k (R, K, H, W), img_f (R, F, H, W), wmaps (R, 4, H, W)
float32; mask, labels (R, H, W) int32.

Each call is one launch. Both reduce in a fixed order (float64 partial
sums per block, then the blocks of a region in block order, inside the
launch), so repeated calls are bitwise equal. ``potts_energy_pair`` takes
two labelings of the same operands in one launch; each of its energies is
bitwise what ``potts_energy`` gives for that labeling. The plain versions
accumulate in float64 as well. On a CPU tensor, or with ``plain=True``,
the wrappers run the plain version; on a CUDA tensor they launch the
kernel or raise (on any operand that is not float32 among them).

The plain versions keep their operands' dtype. In float64 (the model's
strict-parity mode, which runs no kernel) they reduce in the pinned order
of ``ops/potts.py``: per-row sums (`energy_rows`, `finish_rows`), then a
fold over the rows, so a row-sharded region folds its shards' rows into
bitwise the single-device sums.
"""

from __future__ import annotations

import numpy as np
import torch

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2
from phylo_hmrf_tpu_torch.ops.potts import (fold_rows, pinned, row_sums,
                                            seq_max, seq_sum, stats_rows)


def _f32(x: float) -> float:
    """The float32 value the kernels receive for a Python scalar."""
    return float(np.float32(x))


def energy_rows(unary_k, mask_i, labels, wmaps):
    """Per-row terms of the float64 energy, (R, 5, H): the unary at the
    labels over the valid pixels, then the weights of the cut forward
    edges of each direction, each row summed by `row_sums`."""
    K = unary_k.shape[1]
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    u_at = torch.sum(unary_k * (labels[:, None] == ks).to(unary_k.dtype),
                     dim=1)
    terms = [torch.where(mask_i != 0, u_at, 0.0)]
    for d, (dr, dc) in enumerate(DIRS):
        nb = _shift2(labels, dr, dc, -1)
        terms.append(wmaps[:, d] * (labels != nb).to(wmaps.dtype))
    return row_sums(torch.stack(terms, dim=1))


def energy_from_rows(rows, beta):
    """The energies (R,) from the `energy_rows` of all a region's rows."""
    tot = fold_rows(rows)
    e_p = tot[:, 1]
    for d in range(2, 5):
        e_p = e_p + tot[:, d]
    return tot[:, 0] + beta * e_p


def potts_energy_plain(unary_k, mask_i, labels, wmaps, beta):
    """Plain version of K3: per-region energy (R,) float32 (float64 in the
    pinned order for float64 operands)."""
    if pinned(unary_k.dtype):
        return energy_from_rows(energy_rows(unary_k, mask_i, labels, wmaps),
                                beta)
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


def potts_energy_pair_plain(unary_k, mask_i, labels_a, labels_b, wmaps,
                           beta):
    """Plain version of the K3 pair: the single version on each labeling,
    (2, R) float32."""
    return torch.stack([
        potts_energy_plain(unary_k, mask_i, lab, wmaps, beta)
        for lab in (labels_a, labels_b)])


_tickets = {}


def _tickets_for(t, R: int):
    """K3's and K4's per-region tickets on ``t``'s device and stream, all
    0: the last block of a region resets its ticket before the launch
    ends, so a buffer made once serves every later launch there."""
    key = (t.device, _build.stream_of(t))
    buf = _tickets.get(key)
    if buf is None or buf.numel() < R:
        buf = _tickets[key] = torch.zeros(max(R, 64), dtype=torch.int32,
                                          device=t.device)
    return buf


def _energy_launch(unary_k, mask_i, labelings, wmaps, beta):
    """One K3 launch over one or two labelings: (len(labelings), R)."""
    R, K, H, W = unary_k.shape
    _build.check_tensors(
        "potts_energy", unary_k=(unary_k, torch.float32, (R, K, H, W)),
        mask=(mask_i, torch.int32, (R, H, W)),
        wmaps=(wmaps, torch.float32, (R, 4, H, W)),
        **{f"labels_{i}": (lab, torch.int32, (R, H, W))
           for i, lab in enumerate(labelings)})
    lib = _build.load()
    dev = unary_k.device
    partial = torch.empty(lib.phmrf_energy_slots(R, H, W),
                          dtype=torch.float64, device=dev)
    out = torch.empty(len(labelings), R, dtype=torch.float32, device=dev)
    second = labelings[1].data_ptr() if len(labelings) == 2 else None
    with _build.on_device(out):
        _build.check(lib.phmrf_potts_energy(
            unary_k.data_ptr(), mask_i.data_ptr(), labelings[0].data_ptr(),
            second, wmaps.data_ptr(), partial.data_ptr(),
            _tickets_for(out, R).data_ptr(), out.data_ptr(), R, K, H, W,
            float(beta), _build.stream_of(out)), "K3 potts_energy")
    potts_energy.launches += 1
    return out


def potts_energy(unary_k, mask_i, labels, wmaps, beta, *,
                 plain: bool = False):
    """Per-region MRF energy sum_p(valid) unary[p, s_p]
    + beta * sum_d sum_p w_d[p] [s_p != s_{p+d}] (forward edges). (R,)."""
    if plain or unary_k.device.type == "cpu":
        return potts_energy_plain(unary_k, mask_i, labels, wmaps, beta)
    return _energy_launch(unary_k, mask_i, (labels,), wmaps, beta)[0]


potts_energy.launches = 0   # K3 launches, the pair's included


def potts_energy_pair(unary_k, mask_i, labels_a, labels_b, wmaps, beta, *,
                      plain: bool = False):
    """The energies of two labelings of the same operands, (2, R): row i
    bitwise ``potts_energy`` of labeling i, from one launch that reads the
    mask and the weights once."""
    if plain or unary_k.device.type == "cpu":
        return potts_energy_pair_plain(unary_k, mask_i, labels_a, labels_b,
                                       wmaps, beta)
    return _energy_launch(unary_k, mask_i, (labels_a, labels_b), wmaps, beta)


def finish_rows(lp_k, img_f, mask_i, labels, wpp, beta, small_eps,
                negate: bool = False):
    """Per-row sums of K4's float64 outputs, (R, H, Q) with Q = 4 + K (1 +
    F + F^2): [pp, log(ppn + eps), lp, n_valid, post, obs, obs2] of each
    row, summed over the columns by `row_sums`, the softmax over the states
    in a fixed order. `finish_from_rows` folds them."""
    R, K, H, W = lp_k.shape
    logprob = -lp_k if negate else lp_k
    pp = _pairwise_kmajor(labels, wpp, K, beta)
    z1 = logprob - pp
    e1 = torch.exp(z1 - seq_max(z1, 1, keepdim=True))
    g = e1 / seq_sum(e1, 1, keepdim=True)
    z2 = -pp - seq_max(-pp, 1, keepdim=True)
    e2 = torch.exp(z2)
    ppn = e2 / seq_sum(e2, 1, keepdim=True)
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    onehot = (labels[:, None] == ks).to(logprob.dtype)
    valid = mask_i != 0

    def at(v):
        return torch.where(valid, torch.sum(v * onehot, dim=1), 0.0)
    sums = row_sums(torch.stack([
        at(pp), torch.where(valid, torch.log(torch.sum(ppn * onehot, dim=1)
                                             + small_eps), 0.0),
        at(logprob), valid.to(logprob.dtype)], dim=1))       # (R, 4, H)
    p, o, o2 = stats_rows(torch.where(valid[:, None], g, 0.0), img_f)
    return torch.cat([sums, p, o.reshape(R, -1, H), o2.reshape(R, -1, H)],
                     dim=1).transpose(1, 2)


def finish_from_rows(rows, K: int, Fd: int):
    """K4's outputs (post, obs, obs2, sums (R, 8)) from the `finish_rows`
    of all a region's rows, folded in row order."""
    tot = fold_rows(rows, dim=1)
    R = tot.shape[0]
    zero = tot.new_zeros(R, 4)
    post = tot[:, 4:4 + K]
    obs = tot[:, 4 + K:4 + K + K * Fd].reshape(R, K, Fd)
    obs2 = tot[:, 4 + K + K * Fd:].reshape(R, K, Fd, Fd)
    return post, obs, obs2, torch.cat([tot[:, :4], zero], dim=1)


def _pairwise_kmajor(labels, wpp, K: int, beta):
    """pp (R, K, H, W) = beta * (incident weight - agreeing weight)."""
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    agree = torch.zeros((labels.shape[0], K) + tuple(labels.shape[1:]),
                        dtype=wpp.dtype, device=wpp.device)
    wsum = torch.zeros_like(agree[:, 0])
    for d, (dr, dc) in enumerate(DIRS):
        w = wpp[:, d]
        nb = _shift2(labels, dr, dc, -1)[:, None]
        agree = agree + w[:, None] * (nb == ks).to(w.dtype)
        wsum = wsum + w
        w_bwd = _shift2(w, -dr, -dc)
        nbm = _shift2(labels, -dr, -dc, -1)[:, None]
        agree = agree + w_bwd[:, None] * (nbm == ks).to(w.dtype)
        wsum = wsum + w_bwd
    return beta * (wsum[:, None] - agree)


def finish_stats_plain(lp_k, img_f, mask_i, labels, wpp, beta, small_eps,
                       negate: bool = False, float64: bool = False):
    """Plain version of K4 (same outputs as `finish_stats`; float64
    operands give float64 outputs in the pinned order)."""
    R, K, H, W = lp_k.shape
    if pinned(lp_k.dtype):
        return finish_from_rows(finish_rows(
            lp_k, img_f, mask_i, labels, wpp, beta, small_eps, negate),
            K, img_f.shape[1])
    Fd = img_f.shape[1]
    logprob = -lp_k if negate else lp_k
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    pp = _pairwise_kmajor(labels, wpp, K, beta)

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
                 negate: bool = False, float64: bool = False,
                 plain: bool = False):
    """Fused posterior / cost / stats pass over a region batch.

    lp_k (R, K, H, W) log-densities, or with ``negate`` the unary
    (-logprob), flipped inside (bitwise identical, no second K-major
    tensor). wpp (R, 4, H, W) are the pairwise-potential weights
    (`weight_maps` for estimate_type 3, `valid_maps` otherwise). Returns
    (post (R, K), obs (R, K, F), obs2 (R, K, F, F),
    sums (R, 8) = [pp_sum, ppn_sum, lp_sum, n_valid, 0, 0, 0, 0]), float32,
    or with ``float64`` the float64 sums before their one rounding (for
    adding up the row shards of a region)."""
    if plain or lp_k.device.type == "cpu":
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
    dev = lp_k.device
    partial = torch.empty(lib.phmrf_finish_slots(R, K, Fd, H, W),
                          dtype=torch.float64, device=dev)
    dtype = torch.float64 if float64 else torch.float32
    # the kernel writes every column, the sums' 4 zeros included
    out = torch.empty(R, nstat + 8, dtype=dtype, device=dev)
    with _build.on_device(out):
        _build.check(lib.phmrf_finish_stats(
            lp_k.data_ptr(), img_f.data_ptr(), mask_i.data_ptr(),
            labels.data_ptr(), wpp.data_ptr(), partial.data_ptr(),
            _tickets_for(out, R).data_ptr(), out.data_ptr(), R, K, Fd, H, W,
            float(beta), float(small_eps), int(bool(negate)),
            int(bool(float64)), _build.stream_of(out)), "K4 finish_stats")
    finish_stats.launches += 1
    post = out[:, :K]
    obs = out[:, K:K + K * Fd].reshape(R, K, Fd)
    obs2 = out[:, K + K * Fd:nstat].reshape(R, K, Fd, Fd)
    return post, obs, obs2, out[:, nstat:]


finish_stats.launches = 0

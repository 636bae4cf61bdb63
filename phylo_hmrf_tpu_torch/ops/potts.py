"""Weighted-Potts MRF operations on dense masked grids — plain PyTorch.

Counterpart of ``phylo_hmrf_tpu/ops/potts.py``, same names and the same
per-region layout: labels (H, W), fields (H, W, K), weight maps (4, H, W).
These are the plain reference the E-step kernels are held to (K3 against
``potts_energy``, K4 against ``pairwise_potential`` +
``posteriors_and_costs`` + ``sufficient_stats``). Only the float32 paths
are ported; the pinned-order float64 reductions of the JAX module wait for
the float64 mode.

Edge convention (``data/regions.py::DIRS``): ``w[d, i, j]`` weighs the edge
from (i, j) to its DIRS[d]-neighbour; 0 = no edge. Out-of-grid neighbour
labels are filled with K, whose one-hot over K classes is the zero vector.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from phylo_hmrf_tpu_torch.data.regions import DIRS


def weight_maps(dmaps: torch.Tensor, beta1: float) -> torch.Tensor:
    """w_e = exp(-beta1 * d_e); +inf distance -> weight exactly 0."""
    return torch.exp(-beta1 * dmaps)


def valid_maps(dmaps: torch.Tensor) -> torch.Tensor:
    """Unweighted edge indicators (for estimate_type != 3 potentials)."""
    return torch.isfinite(dmaps).to(torch.float32)


def _shift_fwd(arr: torch.Tensor, di: int, dj: int, fill) -> torch.Tensor:
    """result[i, j] = arr[i + di, j + dj], `fill` outside (axes 0, 1)."""
    H, W = arr.shape[0], arr.shape[1]
    out = torch.full_like(arr, fill)
    src = arr[di:, max(0, dj):W + min(0, dj)]
    out[:H - di, max(0, -dj):W - max(0, dj)] = src
    return out


def _shift_bwd(arr: torch.Tensor, di: int, dj: int, fill) -> torch.Tensor:
    """result[i, j] = arr[i - di, j - dj], `fill` outside (axes 0, 1)."""
    H, W = arr.shape[0], arr.shape[1]
    out = torch.full_like(arr, fill)
    src = arr[:H - di, max(0, -dj):W - max(0, dj)]
    out[di:, max(0, dj):W + min(0, dj)] = src
    return out


def _one_hot(labels: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """one_hot with out-of-range labels (the K fill) mapping to zeros."""
    ks = torch.arange(K, device=labels.device)
    return (labels[..., None] == ks).to(dtype)


def neighbor_sums(labels: torch.Tensor, wmaps: torch.Tensor, n_states: int):
    """(agree (H, W, K), wsum (H, W)): weighted neighbour-label agreement
    and total incident edge weight per pixel."""
    K = n_states
    onehot = _one_hot(labels, K, wmaps.dtype)
    agree = torch.zeros(labels.shape + (K,), dtype=wmaps.dtype,
                        device=wmaps.device)
    wsum = torch.zeros(labels.shape, dtype=wmaps.dtype, device=wmaps.device)
    for d, (di, dj) in enumerate(DIRS):
        w = wmaps[d]
        nb_label = _shift_fwd(labels, di, dj, K)
        agree = agree + w[..., None] * _one_hot(nb_label, K, wmaps.dtype)
        wsum = wsum + w
        agree = agree + _shift_bwd(w[..., None] * onehot, di, dj, 0.0)
        wsum = wsum + _shift_bwd(w, di, dj, 0.0)
    return agree, wsum


def neighbor_sums_soft(q: torch.Tensor, wmaps: torch.Tensor):
    """Mean-field analogue of `neighbor_sums` for a label distribution
    q (H, W, K)."""
    agree = torch.zeros_like(q)
    wsum = torch.zeros(q.shape[:2], dtype=q.dtype, device=q.device)
    for d, (di, dj) in enumerate(DIRS):
        w = wmaps[d]
        agree = agree + w[..., None] * _shift_fwd(q, di, dj, 0.0)
        wsum = wsum + w
        agree = agree + _shift_bwd(w[..., None] * q, di, dj, 0.0)
        wsum = wsum + _shift_bwd(w, di, dj, 0.0)
    return agree, wsum


def pairwise_potential(labels: torch.Tensor, wmaps: torch.Tensor,
                       n_states: int, beta: float) -> torch.Tensor:
    """pp[p, c] = beta * sum_{edges at p} w_e [c != label(other)]."""
    agree, wsum = neighbor_sums(labels, wmaps, n_states)
    return beta * (wsum[..., None] - agree)


def potts_energy(labels: torch.Tensor, unary: torch.Tensor,
                 wmaps: torch.Tensor, mask: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """sum_p unary[p, s_p] + beta * sum_e w_e [s_u != s_v] (forward edges)."""
    onehot = _one_hot(labels, unary.shape[-1], unary.dtype)
    u = torch.sum(unary * onehot, dim=-1)
    e_unary = torch.sum(torch.where(mask, u, 0.0))
    e_pair = 0.0
    for d, (di, dj) in enumerate(DIRS):
        nb = _shift_fwd(labels, di, dj, -1)
        diff = (labels != nb).to(wmaps.dtype)
        e_pair = e_pair + torch.sum(wmaps[d] * diff)
    return e_unary + beta * e_pair


def posteriors_and_costs(logprob: torch.Tensor, labels: torch.Tensor,
                         pp: torch.Tensor, mask: torch.Tensor,
                         small_eps: float = 1e-16):
    """Posteriors softmax(logprob - pp) and the four reference costs
    [pairwise, pairwise_nrm, unary, cost1], means over valid pixels.
    Returns (posteriors, cost_vec (4,), n_valid)."""
    m = mask.to(logprob.dtype)
    n_valid = torch.sum(m)
    n_valid_safe = torch.clamp(n_valid, min=1.0)
    posteriors = F.softmax(logprob - pp, dim=-1)
    pp_norm = F.softmax(-pp, dim=-1)
    onehot = _one_hot(labels, logprob.shape[-1], logprob.dtype)
    pp_map = torch.sum(pp * onehot, dim=-1)
    lp_map = torch.sum(logprob * onehot, dim=-1)
    ppn_map = torch.sum(pp_norm * onehot, dim=-1)
    pairwise_cost = torch.sum(torch.where(mask, pp_map, 0.0)) / n_valid_safe
    unary_cost = -torch.sum(torch.where(mask, lp_map, 0.0)) / n_valid_safe
    pairwise_cost_nrm = -torch.sum(torch.where(
        mask, torch.log(ppn_map + small_eps), 0.0)) / n_valid_safe
    cost1 = unary_cost + pairwise_cost_nrm
    cost_vec = torch.stack([pairwise_cost, pairwise_cost_nrm, unary_cost,
                            cost1])
    return posteriors, cost_vec, n_valid


def sufficient_stats(posteriors: torch.Tensor, img: torch.Tensor,
                     mask: torch.Tensor):
    """Masked sufficient statistics: post (K,), obs (K, F), obs2 (K, F, F)."""
    K = posteriors.shape[-1]
    Fd = img.shape[-1]
    g = torch.where(mask[..., None], posteriors, 0.0).reshape(-1, K)
    x = img.reshape(-1, Fd)
    post = torch.sum(g, dim=0)
    obs = g.T @ x
    xx = (x[:, :, None] * x[:, None, :]).reshape(-1, Fd * Fd)
    obs2 = (g.T @ xx).reshape(K, Fd, Fd)
    return post, obs, obs2

"""Weighted-Potts MRF operations on dense masked grids — plain PyTorch.

Counterpart of ``phylo_hmrf_tpu/ops/potts.py``, same names and the same
per-region layout: labels (H, W), fields (H, W, K), weight maps (4, H, W).
These are the plain reference the E-step kernels are held to (K3 against
``potts_energy``, K4 against ``pairwise_potential`` +
``posteriors_and_costs`` + ``sufficient_stats``).

In float64 (the strict-parity mode) every grid reduction takes a pinned
order, as in the JAX module: per-row sums over the columns as a pairwise
tree over the next power of two of W (`row_sums`), then a sequential fold
over the rows in row order (`fold_rows`). Zero columns or rows appended to
a grid add exact zeros, and a row split into blocks folds in the same
order, so a float64 sum does not depend on the padding, the bucketing or
the number of row shards. The small sums over the K states and F
features take a sequential order too (`seq_sum`, `seq_max`): a library
reduction may pick its order from the tensor's shape.

Edge convention (``data/regions.py::DIRS``): ``w[d, i, j]`` weighs the edge
from (i, j) to its DIRS[d]-neighbour; 0 = no edge. Out-of-grid neighbour
labels are filled with K, whose one-hot over K classes is the zero vector.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from phylo_hmrf_tpu_torch.data.regions import DIRS


def pinned(dtype) -> bool:
    """Whether reductions in ``dtype`` take the pinned order (float64)."""
    return dtype == torch.float64


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis of x (..., W): a pairwise tree over the next
    power of two of W, the columns beyond W zero. Zero columns appended to
    x leave every sum bitwise the same (each extra level adds 0)."""
    W = x.shape[-1]
    n = 1 << max(0, (W - 1).bit_length())
    if n != W:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (n - W,))], dim=-1)
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def fold_rows(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sequential sum over ``dim`` in index order, from zero (the JAX
    module's ``lax.scan`` over rows): rows split into consecutive blocks
    and joined again fold bitwise the same."""
    x = x.movedim(dim, 0)
    acc = torch.zeros_like(x[0])
    for r in x:
        acc = acc + r
    return acc


def grid_sum(x: torch.Tensor) -> torch.Tensor:
    """Pinned sum over the last two axes (rows, columns) of x."""
    return fold_rows(row_sums(x))


def seq_sum(x: torch.Tensor, dim: int, keepdim: bool = False):
    """Sequential sum over a short axis (the K states, the F features)."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc.unsqueeze(dim) if keepdim else acc


def seq_max(x: torch.Tensor, dim: int, keepdim: bool = False):
    """Maximum over a short axis, taken one index at a time."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = torch.maximum(acc, x.select(dim, i))
    return acc.unsqueeze(dim) if keepdim else acc


def softmax(z: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax over ``dim``, in the pinned order for float64."""
    if not pinned(z.dtype):
        return F.softmax(z, dim=dim)
    e = torch.exp(z - seq_max(z, dim, keepdim=True))
    return e / seq_sum(e, dim, keepdim=True)


def weight_maps(dmaps: torch.Tensor, beta1: float) -> torch.Tensor:
    """w_e = exp(-beta1 * d_e); +inf distance -> weight exactly 0."""
    return torch.exp(-beta1 * dmaps)


def valid_maps(dmaps: torch.Tensor) -> torch.Tensor:
    """Unweighted edge indicators (for estimate_type != 3 potentials), in
    the distances' dtype."""
    return torch.isfinite(dmaps).to(dmaps.dtype)


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
    gsum = grid_sum if pinned(unary.dtype) else torch.sum
    onehot = _one_hot(labels, unary.shape[-1], unary.dtype)
    u = torch.sum(unary * onehot, dim=-1)
    e_unary = gsum(torch.where(mask, u, 0.0))
    e_pair = 0.0
    for d, (di, dj) in enumerate(DIRS):
        nb = _shift_fwd(labels, di, dj, -1)
        diff = (labels != nb).to(wmaps.dtype)
        e_pair = e_pair + gsum(wmaps[d] * diff)
    return e_unary + beta * e_pair


def posteriors_and_costs(logprob: torch.Tensor, labels: torch.Tensor,
                         pp: torch.Tensor, mask: torch.Tensor,
                         small_eps: float = 1e-16):
    """Posteriors softmax(logprob - pp) and the four reference costs
    [pairwise, pairwise_nrm, unary, cost1], means over valid pixels.
    Returns (posteriors, cost_vec (4,), n_valid)."""
    gsum = grid_sum if pinned(logprob.dtype) else torch.sum
    m = mask.to(logprob.dtype)
    n_valid = torch.sum(m)
    n_valid_safe = torch.clamp(n_valid, min=1.0)
    posteriors = softmax(logprob - pp, dim=-1)
    pp_norm = softmax(-pp, dim=-1)
    onehot = _one_hot(labels, logprob.shape[-1], logprob.dtype)
    pp_map = torch.sum(pp * onehot, dim=-1)
    lp_map = torch.sum(logprob * onehot, dim=-1)
    ppn_map = torch.sum(pp_norm * onehot, dim=-1)
    pairwise_cost = gsum(torch.where(mask, pp_map, 0.0)) / n_valid_safe
    unary_cost = -gsum(torch.where(mask, lp_map, 0.0)) / n_valid_safe
    pairwise_cost_nrm = -gsum(torch.where(
        mask, torch.log(ppn_map + small_eps), 0.0)) / n_valid_safe
    cost1 = unary_cost + pairwise_cost_nrm
    cost_vec = torch.stack([pairwise_cost, pairwise_cost_nrm, unary_cost,
                            cost1])
    return posteriors, cost_vec, n_valid


def sufficient_stats(posteriors: torch.Tensor, img: torch.Tensor,
                     mask: torch.Tensor):
    """Masked sufficient statistics: post (K,), obs (K, F), obs2 (K, F, F);
    in float64 in the pinned order (`sufficient_stats_pinned`)."""
    if pinned(posteriors.dtype):
        return sufficient_stats_pinned(posteriors, img, mask)
    K = posteriors.shape[-1]
    Fd = img.shape[-1]
    g = torch.where(mask[..., None], posteriors, 0.0).reshape(-1, K)
    x = img.reshape(-1, Fd)
    post = torch.sum(g, dim=0)
    obs = g.T @ x
    xx = (x[:, :, None] * x[:, None, :]).reshape(-1, Fd * Fd)
    obs2 = (g.T @ xx).reshape(K, Fd, Fd)
    return post, obs, obs2


def stats_rows(g: torch.Tensor, x: torch.Tensor):
    """Per-row statistics of masked posteriors g (..., K, H, W) and
    features x (..., F, H, W) (``...`` the same leading axes): post
    (..., K, H), obs (..., K, F, H), obs2 (..., K, F, F, H), each summed
    over the columns by `row_sums`. The products are the JAX
    ``_sufficient_stats_pinned``'s: g x_f, and g (x_f x_g)."""
    xx = x[..., :, None, :, :] * x[..., None, :, :, :]
    return (row_sums(g), row_sums(g[..., :, None, :, :]
                                  * x[..., None, :, :, :]),
            row_sums(g[..., :, None, None, :, :] * xx[..., None, :, :, :, :]))


def sufficient_stats_pinned(posteriors: torch.Tensor, img: torch.Tensor,
                            mask: torch.Tensor):
    """The float64 statistics in the pinned order: per-row sums over the
    columns, folded over the rows in row order (the JAX
    ``_sufficient_stats_pinned``)."""
    g = torch.where(mask[..., None], posteriors, 0.0).permute(2, 0, 1)
    p, o, o2 = stats_rows(g, img.permute(2, 0, 1))
    return fold_rows(p), fold_rows(o), fold_rows(o2)

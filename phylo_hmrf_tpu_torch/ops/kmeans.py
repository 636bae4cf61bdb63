"""K-means initialization — PyTorch counterpart of
``phylo_hmrf_tpu/ops/kmeans.py``.

k-means++ seeding on a subsample of at most ``pp_subsample`` points, then
the best (lowest inertia) of ``n_init`` Lloyd runs of ``n_iters`` steps.
Randomness comes from an explicit ``torch.Generator``; its draws are not
JAX's, so the two packages' results are compared by inertia, never by bits.
It only seeds the EM: determinism matters, equality with sklearn does not.
"""

from __future__ import annotations

import torch


def _pairwise_sq_dists(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(N, F) x (K, F) -> (N, K) squared distances."""
    xx = torch.sum(X * X, dim=1, keepdim=True)
    cc = torch.sum(C * C, dim=1)
    return xx + cc[None, :] - 2.0 * (X @ C.T)


def _kmeans_pp_init(gen: torch.Generator, X: torch.Tensor, k: int):
    n = X.shape[0]
    first = torch.randint(0, n, (1,), generator=gen, device=X.device)
    centers = X.new_zeros(k, X.shape[1])
    centers[0] = X[first[0]]
    d2 = torch.full((n,), torch.inf, dtype=X.dtype, device=X.device)
    for i in range(1, k):
        d2 = torch.minimum(d2, _pairwise_sq_dists(X, centers[i - 1:i])[:, 0])
        # sample proportional to the squared distance (the expanded form
        # can round a zero distance below 0; multinomial refuses that)
        idx = torch.multinomial(torch.clamp(d2, min=0.0) + 1e-12, 1,
                                generator=gen)
        centers[i] = X[idx[0]]
    return centers


def _lloyd(X: torch.Tensor, centers: torch.Tensor, k: int, n_iters: int):
    for _ in range(n_iters):
        assign = torch.argmin(_pairwise_sq_dists(X, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ X
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        # an empty cluster keeps its old center
        centers = torch.where(counts[:, None] > 0, new, centers)
    d2 = _pairwise_sq_dists(X, centers)
    return centers, torch.sum(torch.min(d2, dim=1).values)


def kmeans(gen: torch.Generator, X: torch.Tensor, k: int, n_iters: int = 100,
           n_init: int = 10, pp_subsample: int = 65536):
    """Best-of-``n_init`` Lloyd k-means with k-means++ seeding.

    ``gen`` must live on X's device. Returns (centers (k, F),
    labels (N,) int32, inertia); nothing is read back to the host."""
    n = X.shape[0]
    m = min(n, pp_subsample)
    best_c, best_i = None, None
    for _ in range(n_init):
        if m < n:
            idx = torch.randperm(n, generator=gen, device=X.device)[:m]
            seed_X = X[idx]
        else:
            seed_X = X
        centers, inertia = _lloyd(X, _kmeans_pp_init(gen, seed_X, k), k,
                                  n_iters)
        if best_c is None:
            best_c, best_i = centers, inertia
        else:
            # strict: ties keep the earlier trial, as argmin does
            better = inertia < best_i
            best_c = torch.where(better, centers, best_c)
            best_i = torch.where(better, inertia, best_i)
    labels = torch.argmin(_pairwise_sq_dists(X, best_c), dim=1)
    return best_c, labels.to(torch.int32), best_i

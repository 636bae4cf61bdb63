"""Synthetic Phylo-HMRF data generation.

Fills the reference's `_generate_sample_from_state` stub (base.py:555) with a
full simulator: hidden state maps from a Potts Gibbs sampler (or blocky
patterns), emissions from the per-state OU Gaussians. Used for tests,
benchmarks and method validation (the simulation studies of the paper).
"""

from __future__ import annotations

import numpy as np

from phylo_hmrf_tpu_torch.data.regions import flat_index_order, \
    region_from_samples
from phylo_hmrf_tpu_torch.tree import PhyloTree


def ou_moments_np(params: np.ndarray, tree: PhyloTree):
    """Host-side OU moments (same recursion as models.ou.ou_moments)."""
    n = tree.n_nodes
    B = n - 1
    alpha, lam, theta = (params[1:1 + B], params[1 + B:1 + 2 * B],
                         params[1 + 2 * B:])
    mean, var = np.zeros(n), np.zeros(n)
    mean[0], var[0] = theta[0], params[0]
    for node in tree.topo_order[1:]:
        node = int(node)
        a = alpha[node - 1]
        e = np.exp(-a)
        ratio = lam[node - 1] / (2 * a) if a > 1e-7 else 0.0
        p = int(tree.parent[node])
        mean[node] = mean[p] * e + theta[node] * (1 - e)
        var[node] = ratio * (1 - e ** 2) + var[p] * e ** 2
    L = tree.n_leaves
    cov = np.zeros((L, L))
    alpha_full = np.concatenate([[0.0], alpha])
    for k in range(tree.pair_list.shape[0]):
        mrca = tree.pair_list[k, 2]
        s = np.exp(-(tree.A2[k] * alpha_full).sum()) * var[mrca]
        i, j = tree.pair_rows[k], tree.pair_cols[k]
        cov[i, j] = cov[j, i] = s
    for i, leaf in enumerate(tree.leaf_nodes):
        cov[i, i] = var[leaf]
    return mean[tree.leaf_nodes], cov


def sample_potts_labels(rng: np.random.Generator, H: int, W: int, K: int,
                        beta: float = 1.0, n_sweeps: int = 30) -> np.ndarray:
    """Gibbs-sample a K-state Potts field on an 8-connected grid."""
    labels = rng.integers(0, K, (H, W)).astype(np.int32)
    for _ in range(n_sweeps):
        for parity_i in (0, 1):
            for parity_j in (0, 1):
                agree = np.zeros((H, W, K))
                for di, dj in ((0, 1), (1, 0), (1, 1), (1, -1)):
                    for sgn in (1, -1):
                        si, sj = sgn * di, sgn * dj
                        nb = np.full((H, W), -1, np.int32)
                        rs = slice(max(0, -si), H - max(0, si))
                        rd = slice(max(0, si), H - max(0, -si))
                        cs = slice(max(0, -sj), W - max(0, sj))
                        cd = slice(max(0, sj), W - max(0, -sj))
                        nb[rs, cs] = labels[rd, cd]
                        valid = nb >= 0
                        onehot = np.eye(K + 1)[np.where(valid, nb, K)]
                        agree += onehot[..., :K]
                logits = beta * agree
                p = np.exp(logits - logits.max(-1, keepdims=True))
                p /= p.sum(-1, keepdims=True)
                u = rng.random((H, W, 1))
                draw = (p.cumsum(-1) < u).sum(-1).clip(0, K - 1)
                upd = (np.indices((H, W))[0] % 2 == parity_i) & (
                    np.indices((H, W))[1] % 2 == parity_j)
                labels = np.where(upd, draw, labels).astype(np.int32)
    return labels


def simulate_region(rng: np.random.Generator, tree: PhyloTree,
                    params: np.ndarray, H0: int, W0: int, is_diag: bool,
                    beta: float = 1.0, noise_scale: float = 1.0,
                    min_covar: float = 1e-3, label_mode: str = "potts",
                    pad_h: int = 8, pad_w: int = 128):
    """Simulate one region. params: (K, n_params) OU parameters per state.

    Returns (RegionGrid, true label grid (H0, W0))."""
    K = params.shape[0]
    if label_mode == "potts":
        labels = sample_potts_labels(rng, H0, W0, K, beta)
    else:
        ii, jj = np.indices((H0, W0))
        labels = ((ii // 6 + jj // 6) % K).astype(np.int32)
    if is_diag:
        labels = np.triu(labels) + np.triu(labels, 1).T   # symmetric map

    moments = [ou_moments_np(params[c], tree) for c in range(K)]
    F = tree.n_leaves
    rows, cols = flat_index_order(H0, W0, is_diag)
    lab_flat = labels[rows, cols]
    x = np.empty((lab_flat.shape[0], F), np.float32)
    for c in range(K):
        sel = lab_flat == c
        if not sel.any():
            continue
        m, V = moments[c]
        Vf = (V + min_covar * np.eye(F)) * noise_scale
        L = np.linalg.cholesky(Vf)
        x[sel] = m + rng.standard_normal((int(sel.sum()), F)) @ L.T
    x = np.abs(x) + 1e-3   # pipeline features are non-negative
    region = region_from_samples(x, H0, W0, is_diag, pad_h=pad_h,
                                 pad_w=pad_w)
    return region, labels


def generate_sample_from_state(rng: np.random.Generator, tree: PhyloTree,
                               params_c: np.ndarray, n: int,
                               min_covar: float = 1e-3) -> np.ndarray:
    """Draw n emission vectors from one state's OU Gaussian."""
    m, V = ou_moments_np(params_c, tree)
    return rng.multivariate_normal(
        m, V + min_covar * np.eye(tree.n_leaves), size=n)

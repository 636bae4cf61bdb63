"""Ornstein-Uhlenbeck emission moments on a phylogenetic tree — PyTorch.

Counterpart of ``phylo_hmrf_tpu/models/ou.py``. Per hidden state the
parameter vector is

    [sigma2_root, alpha_1..alpha_B, lambda_1..lambda_B, theta_0..theta_B]

(B = n_nodes - 1 branches) and the leaf moments follow the OU recursion

    E[i]   = E[p(i)] e_i + theta_i (1 - e_i),        e_i = exp(-alpha_i)
    Var[i] = lambda_i / (2 alpha_i) (1 - e_i^2) + Var[p(i)] e_i^2
    Cov(a, b) = Var[mrca] exp(-sum of the alphas below the mrca).

Every function takes parameters with any leading batch shape (..., P) and
broadcasts the per-state statistics from the right, so the M-step solves
all K states, and all line-search trials, in one batch.

``check_params`` and ``propagate_mean_guess`` are numpy; they are copied
here from the JAX module, which imports jax and so cannot be imported by
this package (and the JAX package is not changed by the port).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phylo_hmrf_tpu_torch.config import SMALL_EPS
from phylo_hmrf_tpu_torch.tree import PhyloTree

_ALPHA_FLOOR = 1e-7   # ratio = lambda / (2 alpha) only where alpha > 1e-7


@dataclasses.dataclass(frozen=True, eq=False)
class TreeTensors:
    """The tree's index structures as tensors on one device, built once per
    model so the M-step objective copies nothing to the device."""
    tree: PhyloTree
    A2T: torch.Tensor        # (n_nodes, n_pairs)
    pair_mrca: torch.Tensor
    pair_rows: torch.Tensor
    pair_cols: torch.Tensor
    leaf_nodes: torch.Tensor
    leaf_pos: torch.Tensor   # arange(n_leaves)
    index: torch.Tensor      # int32 `kernel_index`, for the fused solve


def kernel_index(tree: PhyloTree) -> np.ndarray:
    """The tree's index arrays as the fused L-BFGS kernel reads them
    (``csrc/lbfgs.cu``), int32: parent, topo_order, leaf_nodes, pair_mrca,
    then the (L, L) table of each leaf pair's index in the pair list (-1
    on the diagonal). `build_tree` lists every pair."""
    L = tree.n_leaves
    pair_of = np.full((L, L), -1, np.int64)
    for q, (r, c) in enumerate(zip(tree.pair_rows, tree.pair_cols)):
        pair_of[r, c] = pair_of[c, r] = q
    if (pair_of < 0).sum() != L:
        raise ValueError("the tree's pair list misses a pair of leaves")
    return np.concatenate([np.asarray(a, np.int64).ravel() for a in (
        tree.parent, tree.topo_order, tree.leaf_nodes, tree.pair_mrca,
        pair_of)]).astype(np.int32)


def tree_tensors(tree: PhyloTree, device, dtype=torch.float32) -> TreeTensors:
    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    return TreeTensors(
        tree=tree,
        A2T=torch.as_tensor(np.asarray(tree.A2).T.copy(), dtype=dtype,
                            device=device),
        pair_mrca=idx(tree.pair_mrca), pair_rows=idx(tree.pair_rows),
        pair_cols=idx(tree.pair_cols), leaf_nodes=idx(tree.leaf_nodes),
        leaf_pos=idx(np.arange(tree.n_leaves)),
        index=torch.as_tensor(kernel_index(tree), device=device))


def split_params(params: torch.Tensor, n_nodes: int):
    """(sigma2_root, alpha, lam, theta); theta[..., 0] is the root optimum."""
    B = n_nodes - 1
    return (params[..., 0], params[..., 1:1 + B], params[..., 1 + B:1 + 2 * B],
            params[..., 1 + 2 * B:])


def ou_moments(params: torch.Tensor, tt: TreeTensors):
    """(..., P) -> (leaf_mean (..., L), leaf_cov (..., L, L))."""
    tree = tt.tree
    n = tree.n_nodes
    sigma2_root, alpha, lam, theta = split_params(params, n)
    zero = torch.zeros_like(alpha[..., :1])
    alpha_full = torch.cat([zero, alpha], dim=-1)
    ratio = torch.where(alpha > _ALPHA_FLOOR, lam / (2.0 * alpha), 0.0)
    ratio_full = torch.cat([zero, ratio], dim=-1)
    e_full = torch.cat([zero, torch.exp(-alpha)], dim=-1)

    # the tree is static and tiny: unrolled recursion over nodes
    mean_l = [None] * n
    var_l = [None] * n
    mean_l[0] = theta[..., 0]
    var_l[0] = sigma2_root
    for node in tree.topo_order[1:]:
        node = int(node)
        p = int(tree.parent[node])
        e = e_full[..., node]
        mean_l[node] = mean_l[p] * e + theta[..., node] * (1.0 - e)
        var_l[node] = ratio_full[..., node] * (1.0 - e * e) + var_l[p] * (e * e)
    mean = torch.stack(mean_l, dim=-1)
    var = torch.stack(var_l, dim=-1)

    s1 = alpha_full @ tt.A2T
    s2 = var[..., tt.pair_mrca] * torch.exp(-s1)
    L = tree.n_leaves
    cov = params.new_zeros(params.shape[:-1] + (L, L))
    cov[..., tt.pair_rows, tt.pair_cols] = s2
    cov = cov + cov.transpose(-1, -2)
    cov[..., tt.leaf_pos, tt.leaf_pos] = var[..., tt.leaf_nodes]
    return mean[..., tt.leaf_nodes], cov


def ou_moments_batch(params_batch: torch.Tensor, tt: TreeTensors):
    """(K, P) -> ((K, L), (K, L, L)); `ou_moments` already batches."""
    return ou_moments(params_batch, tt)


def _chol_unrolled(V: torch.Tensor):
    """Cholesky of a tiny SPD matrix (..., F, F) as straight-line code.

    Returns the lower-triangular entries as a list of lists L[i][j]
    (i >= j, each (...,)) and ``bad`` (...,): True where a pivot was not
    positive (V not PD). Pivots are clamped away from zero so a non-PD V
    gives finite (meaningless) factors; callers turn ``bad`` into +inf."""
    F = V.shape[-1]
    L = [[None] * F for _ in range(F)]
    bad = torch.zeros(V.shape[:-2], dtype=torch.bool, device=V.device)
    for j in range(F):
        s = V[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        bad = bad | (s <= 0)
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-30))
        for i in range(j + 1, F):
            t = V[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t / L[j][j]
    return L, bad


def _logdet_trace_solve(V: torch.Tensor, Sn: torch.Tensor):
    """(log(det V + small_eps), tr(V^{-1} Sn)) from one unrolled Cholesky;
    +inf log-determinant where V is not PD (the line search rejects it)."""
    F = V.shape[-1]
    L, bad = _chol_unrolled(V)
    det = L[0][0] * L[0][0]
    for j in range(1, F):
        det = det * (L[j][j] * L[j][j])
    logdet = torch.where(bad, torch.inf, torch.log(det + SMALL_EPS))
    # forward-substitute Y = L^{-1} Sn row by row, then back-substitute
    # Z = L^{-T} Y; tr(V^{-1} Sn) = tr(Z)
    Y = [None] * F
    for i in range(F):
        t = Sn[..., i, :]
        for k in range(i):
            t = t - L[i][k][..., None] * Y[k]
        Y[i] = t / L[i][i][..., None]
    Z = [None] * F
    trace = torch.zeros_like(det)
    for i in range(F - 1, -1, -1):
        t = Y[i]
        for k in range(i + 1, F):
            t = t - L[k][i][..., None] * Z[k]
        Z[i] = t / L[i][i][..., None]
        trace = trace + Z[i][..., i]
    return logdet, trace


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def ou_nll_stats(params, post_c, obs_c, obs2_c, tt: TreeTensors,
                 n_samples: float, lambda_0: float, min_covar: float):
    """M-step loss per state from sufficient statistics:

        post_c log(det V + eps) / n + tr(V^{-1} S_c) / n
        + lambda_0 / sqrt(n) ||params||^2,
        S_c = obs2_c - obs_c m^T - m obs_c^T + post_c m m^T.

    params (..., K, P); post_c (K,), obs_c (K, F), obs2_c (K, F, F)."""
    m, cov = ou_moments(params, tt)
    F = cov.shape[-1]
    eye = torch.eye(F, dtype=cov.dtype, device=cov.device)
    V = cov + min_covar * eye
    obsmean = _outer(obs_c, m)
    Sn = (obs2_c - obsmean - obsmean.transpose(-1, -2)
          + post_c[..., None, None] * _outer(m, m))
    logdet, trace_term = _logdet_trace_solve(V, Sn)
    coef = ridge_coef(params.dtype, n_samples, lambda_0)
    return (post_c * logdet / n_samples + trace_term / n_samples
            + coef * torch.sum(params * params, dim=-1))


def ridge_coef(dtype, n_samples: float, lambda_0: float) -> float:
    """The M-step's ridge coefficient lambda_0 / sqrt(n) in ``dtype``, the
    order the JAX objective uses."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    lam1 = ft(1.0) / np.sqrt(ft(n_samples))
    return float(ft(lambda_0) * lam1)


def ou_nll_init(params, xbar, xxT, tt: TreeTensors, min_covar: float):
    """Init-time per-cluster loss log det V + tr(V^{-1} S) with
    S = xxT - xbar m^T - m xbar^T + m m^T; xbar (K, F), xxT (K, F, F)."""
    m, cov = ou_moments(params, tt)
    F = cov.shape[-1]
    eye = torch.eye(F, dtype=cov.dtype, device=cov.device)
    V = cov + min_covar * eye
    obsmean = _outer(xbar, m)
    Sn = xxT - obsmean - obsmean.transpose(-1, -2) + _outer(m, m)
    logdet, trace_term = _logdet_trace_solve(V, Sn)
    return logdet + trace_term


def check_params(params: np.ndarray, n_nodes: int,
                 lo: float = 0.0, hi: float = 100.0) -> int:
    """Validity flag of one state's params: 1 = ok, -1 = out of box,
    -2 = NaN (reference ``_check_params``)."""
    params = np.asarray(params)
    B = n_nodes - 1
    p1 = params[..., 1:]
    alpha, lam, theta = p1[..., :B], p1[..., B:2 * B], p1[..., 2 * B:]
    if np.isnan(p1).any():
        return -2
    ok = ((alpha >= lo).all() and (alpha <= hi).all()
          and (lam >= lo).all() and (lam <= hi).all()
          and (theta >= -hi).all() and (theta <= hi).all())
    return 1 if ok else -1


def propagate_mean_guess(mean_values: np.ndarray, tree: PhyloTree,
                         rng: np.random.Generator,
                         w2: float, n_params: int) -> np.ndarray:
    """Tree-propagated initial guess (reference ``_ou_init_guess``): thetas
    start from the leaf means averaged up the tree; the other params are
    w2 * U[0, 1) draws from ``rng``."""
    n = tree.n_nodes
    guess = w2 * rng.random(n_params)
    mean_full = np.zeros(n)
    flag = np.zeros(n)
    mean_full[tree.leaf_nodes] = mean_values
    flag[tree.leaf_nodes] = 2
    for j in range(n - 1, 0, -1):
        p = int(tree.parent[j])
        if flag[p] == 0:
            mean_full[p] = mean_full[j]
            flag[p] += 1
        elif flag[p] == 1:
            mean_full[p] = 0.5 * mean_full[p] + 0.5 * mean_full[j]
            flag[p] += 1
    guess[n_params - n:] = mean_full
    return guess

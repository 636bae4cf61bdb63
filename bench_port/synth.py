"""The benchmark's own synthetic data: blocky Potts states with Gaussian
OU-on-a-tree emissions, made from a seed with numpy alone.

A frozen copy of the port's ``synth.py`` (``bench_tree``,
``ou_moments_np``, ``synteny_problem``), extended to several regions. The
K states' OU moments are the configuration's own, the same for every seed
(drawn once from ``STATE_SEED``): how separable the states are sets how
much work the labelers do, so a seed that drew them would change the work.
The seed draws the order of the states over the blocks and the samples:
each region's blocky true labels (24-bin blocks, shifted by the region's
index) and its Gaussian samples. It imports nothing of the program, so
the reference reads the same numbers the program is given.
"""

from __future__ import annotations

import numpy as np

# the reference's example tree (example_input/edge.1.txt): 8 nodes, 7
# branches, 4 leaf species, 23 OU parameters a state
TREE_EDGES = ((0, 1), (1, 2), (1, 3), (3, 4), (4, 5), (4, 6), (3, 7))
BRANCH_LENGTHS = (0, 32, 20, 6, 6, 6, 12)
BLOCK = 24
STATE_SEED = 0


class Tree:
    """The tree's index structures, as the OU recursion reads them.

    Nodes are numbered so that a parent's index is below its children's
    (the reference's convention); ``pairs`` holds, per leaf pair, the two
    leaf positions, their most recent common ancestor and the branches
    strictly below it on the path between them."""

    def __init__(self, edges=TREE_EDGES):
        n = max(max(e) for e in edges) + 1
        parent = [-1] * n
        for a, b in edges:
            parent[max(a, b)] = min(a, b)
        parent[0] = 0
        self.n_nodes = n
        self.parent = parent
        children = {i: [] for i in range(n)}
        for c in range(1, n):
            children[parent[c]].append(c)
        self.leaves = [i for i in range(n) if not children[i]]

        def path(v):
            out = [v]
            while v != 0:
                v = parent[v]
                out.append(v)
            return out[::-1]

        self.pairs = []
        for i, a in enumerate(self.leaves):
            for j in range(i + 1, len(self.leaves)):
                b = self.leaves[j]
                pa, pb = path(a), path(b)
                common = set(pa) & set(pb)
                below = [v for v in pa + pb if v not in common]
                self.pairs.append((i, j, max(common), below))

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    @property
    def n_params(self) -> int:
        """[sigma2_root, alpha_1..B, lambda_1..B, theta_0..theta_B]."""
        return self.n_nodes + 2 * (self.n_nodes - 1) + 1


def ou_moments(p: np.ndarray, tree: Tree):
    """Leaf mean (L,) and covariance (L, L) of one state's OU params."""
    nn = tree.n_nodes
    B = nn - 1
    alpha, lam, theta = p[1:1 + B], p[1 + B:1 + 2 * B], p[1 + 2 * B:]
    mean, var = np.zeros(nn), np.zeros(nn)
    mean[0], var[0] = theta[0], p[0]
    for v in range(1, nn):
        a = alpha[v - 1]
        e = np.exp(-a)
        ratio = lam[v - 1] / (2 * a) if a > 1e-7 else 0.0
        par = tree.parent[v]
        mean[v] = mean[par] * e + theta[v] * (1 - e)
        var[v] = ratio * (1 - e ** 2) + var[par] * e ** 2
    L = tree.n_leaves
    cov = np.zeros((L, L))
    for i, j, mrca, below in tree.pairs:
        s = np.exp(-sum(alpha[v - 1] for v in below)) * var[mrca]
        cov[i, j] = cov[j, i] = s
    for i, leaf in enumerate(tree.leaves):
        cov[i, i] = var[leaf]
    return mean[tree.leaves], cov


def flat_order(h0: int, w0: int, is_diag: bool):
    """Grid rows and columns of the flat samples: row-major, the upper
    triangle (j >= i) of a diagonal block."""
    if is_diag:
        rows, cols = np.triu_indices(h0, m=w0)
    else:
        rows, cols = np.indices((h0, w0)).reshape(2, -1)
    return rows.astype(np.int64), cols.astype(np.int64)


def state_moments(rng: np.random.Generator, K: int, tree: Tree):
    """Per-state OU params of separated optima and their moments, with the
    1e-3 jitter of the port's generator."""
    P = tree.n_params
    params = rng.random((K, P)) * 0.5 + 0.2
    for c in range(K):
        params[c, P - tree.n_nodes:] = 0.25 * c + 0.2
    F = tree.n_leaves
    means = np.zeros((K, F))
    covs = np.zeros((K, F, F))
    for c in range(K):
        m, V = ou_moments(params[c], tree)
        means[c] = m
        covs[c] = V + 1e-3 * np.eye(F)
    return means, covs


def region_samples(rng: np.random.Generator, h0: int, w0: int,
                   is_diag: bool, means, covs, order, shift: int = 0):
    """(samples (N, F) float32, true labels (N,)) of one region: blocky
    states in the given ``order``, Gaussian emissions at half the state
    covariance, folded to positive values."""
    K, F = means.shape
    ii, jj = np.indices((h0, w0))
    true = np.asarray(order)[(ii // BLOCK + jj // BLOCK + shift) % K]
    true = true.astype(np.int32)
    rows, cols = flat_order(h0, w0, is_diag)
    lab = true[rows, cols]
    x = np.empty((lab.shape[0], F), np.float32)
    for c in range(K):
        sel = lab == c
        Lc = np.linalg.cholesky(covs[c] * 0.5)
        x[sel] = means[c] + rng.standard_normal((int(sel.sum()), F)) @ Lc.T
    return np.abs(x).astype(np.float32) + np.float32(0.05), lab


def make_data(seed: int, regions, K: int):
    """The inputs of a configuration from ``seed``: a list of
    ``{"h0", "w0", "is_diag", "chrom", "x", "true"}`` per region, in the
    configuration's order, and the true state moments (the same for every
    seed)."""
    means, covs = state_moments(np.random.default_rng(STATE_SEED), K, Tree())
    rng = np.random.default_rng(seed)
    order = rng.permutation(K)
    out = []
    for idx, reg in enumerate(regions):
        h0, w0, is_diag = int(reg["h0"]), int(reg["w0"]), bool(reg["is_diag"])
        x, true = region_samples(rng, h0, w0, is_diag, means, covs, order,
                                 shift=idx)
        out.append(dict(h0=h0, w0=w0, is_diag=is_diag,
                        chrom=int(reg.get("chrom", -1)), x=x, true=true))
    return out, means, covs

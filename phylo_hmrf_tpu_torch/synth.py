"""The repo's headline problem, made from a seed: one chr21-like diagonal
synteny region of 653 x 653 bins (50 kb), 4 species, K = 10 states; the
same generator makes the 10 kb-scale region (3264 x 3264 bins) of the
spatial E-step and off-diagonal blocks.

The same generator as ``bench.py`` (``_bench_tree_and_moments`` and
``_sample_blocky``): blocky true labels, per-state Gaussian emissions
with OU moments of separated states, and a 15%-corrupted warm start. It is
numpy only, so it runs where JAX is not installed.

`write_example` writes the same kind of data as files in the reference's
input layout, for the command line (``python -m phylo_hmrf_tpu_torch.cli``).
"""

from __future__ import annotations

import os

import numpy as np

from phylo_hmrf_tpu_torch.data.regions import (flat_index_order,
                                               region_from_samples)
from phylo_hmrf_tpu_torch.tree import build_tree

CHR21_H0 = 653     # chr21 synteny 14.0-46.7 Mb at 50 kb
CHR21_K = 10
CHR21_F = 4


TREE_EDGES = [(0, 1), (1, 2), (1, 3), (3, 4), (4, 5), (4, 6), (3, 7)]
BRANCH_LENGTHS = [0, 32, 20, 6, 6, 6, 12]
SPECIES = ["speciesA", "speciesB", "speciesC", "speciesD"]


def bench_tree(species=()):
    """The 4-species tree of the benchmark."""
    return build_tree(TREE_EDGES, branch_lengths=BRANCH_LENGTHS,
                      species=species)


def ou_moments_np(p, tree):
    """Numpy OU moment recursion (leaf mean, leaf covariance)."""
    nn = tree.n_nodes
    B = nn - 1
    alpha, lam, theta = p[1:1 + B], p[1 + B:1 + 2 * B], p[1 + 2 * B:]
    mean, var = np.zeros(nn), np.zeros(nn)
    mean[0], var[0] = theta[0], p[0]
    for node in tree.topo_order[1:]:
        node = int(node)
        a = alpha[node - 1]
        e = np.exp(-a)
        ratio = lam[node - 1] / (2 * a) if a > 1e-7 else 0.0
        par = int(tree.parent[node])
        mean[node] = mean[par] * e + theta[node] * (1 - e)
        var[node] = ratio * (1 - e ** 2) + var[par] * e ** 2
    L = tree.n_leaves
    cov = np.zeros((L, L))
    alpha_full = np.concatenate([[0.0], alpha])
    for k2 in range(tree.pair_list.shape[0]):
        mrca = tree.pair_list[k2, 2]
        s = np.exp(-(tree.A2[k2] * alpha_full).sum()) * var[mrca]
        i, j = tree.pair_rows[k2], tree.pair_cols[k2]
        cov[i, j] = cov[j, i] = s
    for i, leaf in enumerate(tree.leaf_nodes):
        cov[i, i] = var[leaf]
    return mean[tree.leaf_nodes], cov


def chr21_problem(seed: int = 0, h0: int = CHR21_H0, K: int = CHR21_K):
    """(tree, region, means, covs, warm_flat, true_flat) for one diagonal
    h0 x h0 region, padded to multiples of (32, 128) like the benchmark."""
    return synteny_problem(seed, h0, h0, True, K)


def synteny_problem(seed: int = 0, h0: int = CHR21_H0, w0: int = CHR21_H0,
                    is_diag: bool = True, K: int = CHR21_K,
                    pad_h: int = 32):
    """`chr21_problem` for an h0 x w0 region, diagonal or off-diagonal
    (an off-diagonal synteny block pairs two chromosome stretches); the
    same seed gives the same state moments whatever the shape."""
    rng = np.random.default_rng(seed)
    tree = bench_tree()
    F = tree.n_leaves
    params = rng.random((K, tree.n_params)) * 0.5 + 0.2
    for c in range(K):
        params[c, tree.n_params - tree.n_nodes:] = 0.25 * c + 0.2
    means = np.zeros((K, F))
    covs = np.zeros((K, F, F))
    for c in range(K):
        m, V = ou_moments_np(params[c], tree)
        means[c] = m
        covs[c] = V + 1e-3 * np.eye(F)

    ii, jj = np.indices((h0, w0))
    true_lab = ((ii // 24 + jj // 24) % K).astype(np.int32)
    rows, cols = flat_index_order(h0, w0, is_diag)
    lab_flat = true_lab[rows, cols]
    x = np.empty((lab_flat.shape[0], F), np.float32)
    for c in range(K):
        sel = lab_flat == c
        Lc = np.linalg.cholesky(covs[c] * 0.5)
        x[sel] = means[c] + rng.standard_normal((sel.sum(), F)) @ Lc.T
    x = np.abs(x).astype(np.float32) + 0.05
    warm = lab_flat.copy()
    flip = rng.random(warm.shape[0]) < 0.15
    warm[flip] = rng.integers(0, K, flip.sum())
    region = region_from_samples(x, h0, w0, is_diag, pad_h=pad_h, pad_w=128)
    return tree, region, means, covs, warm, lab_flat


def kernel_inputs(region, means, covs, warm_flat, device, beta=1.0,
                  beta1=0.5):
    """The operands the E-step hands its four kernels for one region
    (R = 1), as the E-step forms them: the K-major unary, the edge
    weights, masks, the warm labels, the feature image, and the first
    mean-field state and base field."""
    import torch

    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf_kmajor
    from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2
    from phylo_hmrf_tpu_torch.ops.potts import weight_maps
    from phylo_hmrf_tpu_torch.data.regions import DIRS

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype,
                               device=device).contiguous()

    img = dev(region.img)
    mask = dev(region.mask, torch.bool)
    w = weight_maps(dev(region.dmaps), beta1).contiguous()
    unary_k = -gaussian_logpdf_kmajor(
        img, dev(means)[0], dev(covs)[0]).contiguous()
    wsum = torch.sum(w, dim=1)
    for d, (dr, dc) in enumerate(DIRS):
        wsum = wsum + _shift2(w[:, d], -dr, -dc)
    return dict(
        unary_k=unary_k, w=w, mask=mask, mask_i=mask.to(torch.int32),
        warm=dev(region.labels_to_grid(warm_flat), torch.int32),
        img=img, img_f=img.permute(0, 3, 1, 2).contiguous(),
        q0=torch.softmax(-unary_k, dim=1).contiguous(),
        base=(unary_k + beta * wsum[:, None]).contiguous())


def write_example(out: str, n_bins: int = 120, n_states: int = 5,
                  chroms=(21, 22), seed: int = 0,
                  resolution: int = 50000) -> list:
    """Write a synthetic dataset in the reference's input layout into
    ``out``: ``edge.1.txt``, ``branch_length.1.txt``,
    ``species_name.1.txt``, ``path_list.txt`` (absolute species
    directories), ``hg38.chrom.sizes``, ``hic_<species>/chrN.<kb>K.txt``
    (start1, start2 in bp, value as ``%.4f``; a random 10% of the upper
    triangle dropped) and ``chrN.synteny.txt`` (one block, bins
    [2, n_bins - 2)), the files ``examples/make_synthetic_example.py``
    writes. The states are blocky (24-bin blocks), the values a distance
    decay times OU-Gaussian signal per state and species. One diagonal
    region of ``n_bins - 4`` bins a chromosome: ``n_bins=657`` gives the
    chr21 cell's 653 x 653 region. Returns the species directories."""
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    tree = bench_tree(SPECIES)
    with open(os.path.join(out, "edge.1.txt"), "w") as f:
        f.write("".join(f"{a}\t{b}\n" for a, b in TREE_EDGES))
    with open(os.path.join(out, "branch_length.1.txt"), "w") as f:
        f.write("\t".join(str(v) for v in BRANCH_LENGTHS) + "\n")
    with open(os.path.join(out, "species_name.1.txt"), "w") as f:
        f.write("\n".join(SPECIES) + "\n")
    paths = [os.path.abspath(os.path.join(out, f"hic_{s}")) for s in SPECIES]
    for d in paths:
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(out, "path_list.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    with open(os.path.join(out, "hg38.chrom.sizes"), "w") as f:
        f.write("".join(f"chr{c}\t{n_bins * resolution}\n" for c in chroms))

    # per-state OU params with spread optima
    K = n_states
    params = rng.random((K, tree.n_params)) * 0.5 + 0.2
    for c in range(K):
        params[c, tree.n_params - tree.n_nodes:] = 0.8 * c / K + 0.4
    moments = [ou_moments_np(params[c], tree) for c in range(K)]
    means = np.array([m for m, _ in moments])                   # (K, F)
    var = np.array([np.diag(v) for _, v in moments]) + 1e-3     # (K, F)

    ii, jj = np.triu_indices(n_bins)
    lab = (ii // 24 + jj // 24) % K
    decay = np.exp(-0.05 * (jj - ii))
    for c in chroms:
        for si, d in enumerate(paths):
            sig = np.expm1(np.abs(
                means[lab, si]
                + rng.standard_normal(ii.shape[0]) * np.sqrt(var[lab, si])))
            values = 50.0 * decay * (0.3 + sig)
            keep = rng.random(ii.shape[0]) > 0.1
            np.savetxt(os.path.join(d, f"chr{c}.{resolution // 1000}K.txt"),
                       np.stack([ii[keep] * resolution, jj[keep] * resolution,
                                 values[keep]], axis=1),
                       fmt=["%d", "%d", "%.4f"], delimiter="\t")
        start, stop = 2 * resolution, (n_bins - 2) * resolution
        with open(os.path.join(out, f"chr{c}.synteny.txt"), "w") as f:
            f.write(f"{start}\t{stop}\t{stop - start}\n")
    return paths

"""Label-comparison metrics (reference `utility.compare_labeling`,
utility.py:794-820) plus helpers for parity evaluation — the port's copy
of ``phylo_hmrf_tpu/utils/metrics.py``.

The JAX package takes NMI, AMI and ARI from scikit-learn, which the GPU
machine does not have. Here they are scikit-learn's formulas on the
contingency table, written out with numpy and ``scipy.special.gammaln``
(``sklearn.metrics.cluster._supervised`` and
``_expected_mutual_info_fast``, the arithmetic-mean normalisation of NMI
and AMI, and their degenerate cases: one cluster on both sides, one on
either side, identical labelings). ``cnt_estimate``, ``meanvalue_state``
and ``best_match_accuracy`` are numpy copies.
"""

from __future__ import annotations

from math import log

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.special import comb, gammaln

_EPS = np.finfo("float64").eps


def _contingency(labels_true, labels_pred) -> np.ndarray:
    """(n_classes, n_clusters) int64 counts over the sorted label values."""
    classes, ci = np.unique(labels_true, return_inverse=True)
    clusters, ki = np.unique(labels_pred, return_inverse=True)
    c = np.zeros((classes.shape[0], clusters.shape[0]), np.int64)
    np.add.at(c, (ci.ravel(), ki.ravel()), 1)
    return c


def _mutual_info(c: np.ndarray) -> float:
    """scikit-learn's ``mutual_info_score`` of a contingency table: the
    terms of its nonzero cells in row-major order."""
    nzx, nzy = np.nonzero(c)
    nz_val = c[nzx, nzy]
    total = c.sum()
    pi, pj = c.sum(axis=1), c.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    log_nm = np.log(nz_val)
    nm = nz_val / total
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + log(pi.sum()) + log(pj.sum())
    mi = nm * (log_nm - log(total)) + nm * log_outer
    mi = np.where(np.abs(mi) < _EPS, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def _entropy(labels) -> float:
    """scikit-learn's ``_entropy``: 1 for no samples, 0 for one cluster."""
    if len(labels) == 0:
        return 1.0
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - log(pi_sum))))


def _expected_mutual_info(c: np.ndarray, n: int) -> float:
    """scikit-learn's ``expected_mutual_information``: its terms, per cell
    over every feasible n_ij at once."""
    a = c.sum(axis=1).astype(np.int64)
    b = c.sum(axis=0).astype(np.int64)
    if a.size == 1 or b.size == 1:
        return 0.0
    nijs = np.arange(0, max(np.max(a), np.max(b)) + 1, dtype="float")
    nijs[0] = 1
    term1 = nijs / n
    log_a, log_b = np.log(a), np.log(b)
    log_nnij = np.log(n) + np.log(nijs)
    gln_a, gln_b = gammaln(a + 1), gammaln(b + 1)
    gln_na, gln_nb = gammaln(n - a + 1), gammaln(n - b + 1)
    gln_nnij = gammaln(nijs + 1) + gammaln(n + 1)
    emi = 0.0
    for i in range(a.size):
        for j in range(b.size):
            nij = np.arange(max(1, a[i] - n + b[j]), min(a[i], b[j]) + 1)
            if nij.size == 0:
                continue
            term2 = log_nnij[nij] - log_a[i] - log_b[j]
            gln = (gln_a[i] + gln_b[j] + gln_na[i] + gln_nb[j]
                   - gln_nnij[nij] - gammaln(a[i] - nij + 1)
                   - gammaln(b[j] - nij + 1)
                   - gammaln(n - a[i] - b[j] + nij + 1))
            emi += float(np.sum(term1[nij] * term2 * np.exp(gln)))
    return emi


def _nmi_ami(label1, label2):
    """scikit-learn's ``normalized_mutual_info_score`` and
    ``adjusted_mutual_info_score`` with the arithmetic mean."""
    n1 = np.unique(label1).shape[0]
    n2 = np.unique(label2).shape[0]
    if n1 == n2 == 1 or n1 == n2 == 0:
        return 1.0, 1.0
    c = _contingency(label1, label2)
    mi = _mutual_info(c)
    normalizer = float(np.mean([_entropy(label1), _entropy(label2)]))
    nmi = 0.0 if mi == 0 else float(mi / normalizer)
    if n1 == 1 or n2 == 1:
        return nmi, 0.0
    emi = _expected_mutual_info(c, label1.shape[0])
    den = normalizer - emi
    den = min(den, -_EPS) if den < 0 else max(den, _EPS)
    num = mi - emi
    num = min(num, -_EPS) if num < 0 else max(num, _EPS)
    return nmi, float(num / den)


def _ari(label1, label2) -> float:
    """scikit-learn's ``adjusted_rand_score`` from its pair confusion
    matrix, in Python integers."""
    n = np.int64(label1.shape[0])
    c = _contingency(label1, label2)
    n_c, n_k = c.sum(axis=1), c.sum(axis=0)
    sum_squares = (c ** 2).sum()
    tp = int(sum_squares - n)
    fp = int((c @ n_k).sum() - sum_squares)
    fn = int((c.T @ n_c).sum() - sum_squares)
    tn = int(n ** 2 - fp - fn - sum_squares)
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))


def compare_labeling(label1, label2):
    """NMI, AMI, ARI, RI, precision, recall, F1 between two labelings —
    byte-for-byte the reference's metric set."""
    label1 = np.asarray(label1).astype(np.int64)
    label2 = np.asarray(label2).astype(np.int64)
    nmi, ami = _nmi_ami(label1, label2)
    ari = _ari(label1, label2)

    n1 = label1.shape[0]
    tp = 0.0
    for i in np.unique(label1):
        t1 = np.bincount(label2[label1 == i])
        tp += comb(t1, 2).sum()
    a = comb(np.bincount(label2), 2).sum()
    b = comb(np.bincount(label1), 2).sum()
    fp = a - tp
    fn = b - tp
    s1 = comb(n1, 2)
    tn = s1 - tp - fp - fn
    ri = (tp + tn) / s1
    precision = tp / a if a > 0 else 0.0
    recall = tp / b if b > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return nmi, ami, ari, ri, precision, recall, f1


def best_match_accuracy(pred, true) -> float:
    """Accuracy under the optimal label permutation (Hungarian matching);
    labels are identifiable only up to permutation."""
    pred = np.asarray(pred).astype(np.int64)
    true = np.asarray(true).astype(np.int64)
    k = int(max(pred.max(), true.max())) + 1
    conf = np.zeros((k, k), dtype=np.int64)
    np.add.at(conf, (pred, true), 1)
    row, col = linear_sum_assignment(-conf)
    return conf[row, col].sum() / pred.shape[0]


def cnt_estimate(state, n_components):
    """Per-state counts and fractions (reference `utility.py:687-699`)."""
    state = np.asarray(state)
    state_vec = np.unique(state)
    cnt_vec = np.zeros(n_components)
    for i in range(n_components):
        if i < len(state_vec):
            cnt_vec[i] = np.sum(state == state_vec[i])
    return cnt_vec, cnt_vec / cnt_vec.sum(), state_vec


def meanvalue_state(x, state):
    """Per-state feature percentiles (reference `utility.py:760-791`)."""
    x = np.asarray(x)
    state = np.asarray(state)
    vec1 = np.unique(state)
    percentiles = [5, 25, 50, 75, 95]
    m_vec, cnt_vec = [], np.zeros(len(vec1))
    for i, s in enumerate(vec1):
        sel = state == s
        cnt_vec[i] = sel.sum()
        for p in percentiles:
            m_vec.append(np.percentile(x[sel], p, axis=0))
    return np.asarray(m_vec), cnt_vec

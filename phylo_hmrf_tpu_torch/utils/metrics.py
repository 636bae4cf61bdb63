"""``best_match_accuracy``, copied from ``phylo_hmrf_tpu/utils/metrics.py``
(whose module imports scikit-learn at the top for its other metrics).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["best_match_accuracy"]


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

"""Result comparison tool: parity metrics between two estimation outputs.

    python -m phylo_hmrf_tpu_torch.compare ref_estimate.mat ours_estimate.mat

Loads two reference-schema result files (.mat or .npz), aligns their state
maps and prints the BASELINE parity metrics: label agreement under optimal
state matching, NMI/AMI/ARI/RI/precision/recall/F1
(reference `utility.compare_labeling`), and cost trajectories.

The port's copy of ``phylo_hmrf_tpu/compare.py``, over the port's own
``.mat`` reader and metrics (no scikit-learn).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from phylo_hmrf_tpu_torch.utils.io import load_estimate
from phylo_hmrf_tpu_torch.utils.metrics import (best_match_accuracy,
                                                compare_labeling)


def compare_results(file_a: str, file_b: str) -> dict:
    a = load_estimate(file_a)
    b = load_estimate(file_b)
    sa = np.asarray(a["state_vec"]).ravel().astype(np.int64)
    sb = np.asarray(b["state_vec"]).ravel().astype(np.int64)
    if sa.shape != sb.shape:
        raise ValueError(f"state_vec sizes differ: {sa.shape} vs {sb.shape}")
    nmi, ami, ari, ri, p, r, f1 = compare_labeling(sa, sb)
    out = {
        "n_samples": int(sa.shape[0]),
        "agreement_best_match": float(best_match_accuracy(sa, sb)),
        "nmi": float(nmi), "ami": float(ami), "ari": float(ari),
        "ri": float(ri), "precision": float(p), "recall": float(r),
        "f1": float(f1),
    }
    for key, d in (("a", a), ("b", b)):
        cv = np.asarray(d["cost_vec"])
        if cv.size:
            out[f"final_cost1_{key}"] = float(np.asarray(cv)[-1, -1])
            out[f"n_iters_{key}"] = int(cv.shape[0])
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    print(json.dumps(compare_results(argv[0], argv[1]), indent=1))


if __name__ == "__main__":
    main()

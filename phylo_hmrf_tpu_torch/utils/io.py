"""Result output in the reference's .mat schema (+ an npz twin) — the
port's own copy of ``phylo_hmrf_tpu/utils/io.py``.

Schema parity: reference driver `phylo_hmrf.py:1743-1748` and
outputfile_description.txt:1-50 — keys state_vec, len_vec, params_vec1
(best-cost params), params_vec2 (best-from-iter-3 params), iter_id1,
iter_id2, cost_vec. The MATLAB post-processing under processing/ reads this
file unchanged.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io


def estimate_filename(output_path: str, run_id: int, lambda_0: float,
                      n_states: int, ext: str = "mat") -> str:
    return os.path.join(
        output_path, f"estimate_ou_{run_id}_{lambda_0:.2f}_{n_states}.{ext}")


def result_dict(result, len_vec) -> dict:
    return {
        "state_vec": np.asarray(result.labels),
        "len_vec": np.asarray(len_vec),
        "params_vec1": np.asarray(result.params_vec),
        "params_vec2": np.asarray(result.params_vec1),
        "iter_id1": result.iter_id1,
        "iter_id2": result.iter_id2,
        "cost_vec": np.asarray(result.cost_vec),
    }


def save_estimate(result, len_vec, output_path: str, run_id: int,
                  lambda_0: float, n_states: int, save_npz: bool = True):
    os.makedirs(output_path, exist_ok=True)
    mdict = result_dict(result, len_vec)
    mat_file = estimate_filename(output_path, run_id, lambda_0, n_states)
    scipy.io.savemat(mat_file, mdict)
    if save_npz:
        npz_file = estimate_filename(output_path, run_id, lambda_0, n_states,
                                     "npz")
        np.savez_compressed(npz_file, means=result.means,
                            covars=result.covars,
                            params_list=result.params_list, **mdict)
    return mat_file


def load_estimate(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    return scipy.io.loadmat(path)

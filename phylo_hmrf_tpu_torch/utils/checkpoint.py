"""EM checkpoint/resume.

The reference only caches preprocessing (--reload, `phylo_hmrf.py:1676`);
EM state lives in memory and a crash loses the run (SURVEY.md section 5).
Here the full EM state — OU params, moments, warm-start label grids, RNG
state and convergence bookkeeping — checkpoints to a single npz and
`PhyloHMRF.fit(checkpoint_path=..., resume=True)` continues mid-run.
"""

from __future__ import annotations

import json
import os

import numpy as np


def history_path(path: str) -> str:
    return path + ".hist"


def append_history(path: str, records, truncate_to: int | None = None
                   ) -> int:
    """Append per-iteration records to the side-car history log.

    ``records`` is a list of per-iteration entries, each a list of arrays
    (e.g. ``[params_row]`` or ``[params_row, state_row]``). Each array is
    written with ``np.save`` into ``path + ".hist"``, so a checkpoint costs
    O(rows since last save), not O(total history). ``truncate_to`` discards
    bytes past a known-good offset first (crash recovery: the main npz is
    replaced atomically *after* the append, so on resume the npz's recorded
    offset is authoritative and any partial tail is dropped here).
    Returns the end-of-file byte offset after the append.
    """
    hp = history_path(path)
    mode = "r+b" if os.path.exists(hp) else "w+b"
    with open(hp, mode) as f:
        if truncate_to is not None:
            f.truncate(truncate_to)
        f.seek(0, os.SEEK_END)
        for rec in records:
            for arr in rec:
                np.save(f, np.ascontiguousarray(arr))
        f.flush()
        os.fsync(f.fileno())
        return f.tell()


def read_history(path: str, n_records: int, arrays_per_record: int):
    """Read the first ``n_records`` per-iteration entries back."""
    out = []
    with open(history_path(path), "rb") as f:
        for _ in range(n_records):
            out.append([np.load(f) for _ in range(arrays_per_record)])
    return out


def save_checkpoint(path: str, model, bookkeeping: dict,
                    extra_arrays: dict | None = None) -> None:
    arrays = {
        "params_vec": model.params_vec,
        "init_ou_params": model.init_ou_params,
        "means": model.means_,
        "covars": model.covars_,
        "init_labels": model.init_labels,
    }
    for i, g in enumerate(model.labels_local):
        arrays[f"labels_local_{i}"] = g
    if extra_arrays:
        arrays.update(extra_arrays)
    meta = {
        "n_regions": len(model.labels_local),
        "rng_state": model._rng.bit_generator.state,
        "bookkeeping": {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in bookkeeping.items()},
        "config": model.cfg.to_dict(),
    }
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns (arrays dict, meta dict) or None if the file is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return arrays, meta


def restore_model(model, arrays: dict, meta: dict) -> dict:
    """Load checkpoint state into the model; returns the bookkeeping dict."""
    model.params_vec = arrays["params_vec"].copy()
    model.init_ou_params = arrays["init_ou_params"].copy()
    model.means_ = arrays["means"].copy()
    model.covars_ = arrays["covars"].copy()
    model.init_labels = arrays["init_labels"].copy()
    n = meta["n_regions"]
    if n != len(model.regions):
        raise ValueError(
            f"checkpoint has {n} regions, model has {len(model.regions)} — "
            f"resume needs the same region partition it was saved under")
    labels_local = []
    for i in range(n):
        grid = arrays[f"labels_local_{i}"]
        r = model.regions[i]
        if tuple(grid.shape) != tuple(r.shape):
            # padded grid shapes depend on config pad_h/pad_w; the flat
            # sample area (H0 x W0) is padding-invariant, so a checkpoint
            # written under a different padding re-grids losslessly as
            # long as the unpadded region still fits
            if grid.shape[0] < r.H0 or grid.shape[1] < r.W0:
                saved = meta.get("config", {})
                raise ValueError(
                    f"checkpoint region {i} grid {tuple(grid.shape)} is "
                    f"smaller than the region's unpadded {r.H0}x{r.W0} "
                    f"(saved with pad_h={saved.get('pad_h')}, "
                    f"pad_w={saved.get('pad_w')}) — not the same dataset?")
            grid = r.labels_to_grid(grid[r.flat_rows, r.flat_cols])
        labels_local.append(np.array(grid, copy=True))
    model.labels_local = labels_local
    model._rng.bit_generator.state = meta["rng_state"]
    return meta["bookkeeping"]

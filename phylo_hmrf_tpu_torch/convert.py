"""Carry EM state between the JAX package's model and the port's.

``export_state`` reads, and ``import_state`` sets, the fit state under the
names ``phylo_hmrf_tpu/utils/checkpoint.py`` saves: ``params_vec``,
``init_ou_params``, ``means``, ``covars``, ``init_labels``,
``labels_local_{i}`` per region and the numpy RNG state (``rng_state``).
Both work on either package's ``PhyloHMRF`` — they only touch attributes
the two share — so a port model can start from a JAX model's
``initialize()`` and follow the same trajectory, and a later resume can
read the same keys.
"""

from __future__ import annotations

import copy

import numpy as np


def to_numpy(a) -> np.ndarray:
    """A host copy of a torch tensor (any device), jax or numpy array."""
    if hasattr(a, "detach"):             # torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.array(a, copy=True)        # numpy or anything with __array__


def export_state(model) -> dict:
    """The model's fit state as host arrays (and the RNG state dict)."""
    state = {
        "params_vec": to_numpy(model.params_vec),
        "init_ou_params": to_numpy(model.init_ou_params),
        "means": to_numpy(model.means_),
        "covars": to_numpy(model.covars_),
        "init_labels": to_numpy(model.init_labels),
        "rng_state": copy.deepcopy(model._rng.bit_generator.state),
    }
    for i, g in enumerate(model.labels_local):
        state[f"labels_local_{i}"] = to_numpy(g).astype(np.int32)
    return state


def import_state(model, state: dict) -> None:
    """Set a state from `export_state` on ``model`` (either package)."""
    n = sum(1 for k in state if k.startswith("labels_local_"))
    if n != len(model.regions):
        raise ValueError(f"state has {n} regions, model has "
                         f"{len(model.regions)}")
    labels_local = []
    for i, r in enumerate(model.regions):
        g = np.array(state[f"labels_local_{i}"], dtype=np.int32, copy=True)
        if tuple(g.shape) != tuple(r.shape):
            raise ValueError(f"region {i}: state grid {g.shape} != region "
                             f"grid {r.shape}")
        labels_local.append(g)
    model.params_vec = np.array(state["params_vec"], np.float64, copy=True)
    model.init_ou_params = np.array(state["init_ou_params"], np.float64,
                                    copy=True)
    model.means_ = np.array(state["means"], np.float64, copy=True)
    model.covars_ = np.array(state["covars"], np.float64, copy=True)
    model.init_labels = np.array(state["init_labels"], copy=True)
    model.labels_local = labels_local
    model._rng.bit_generator.state = copy.deepcopy(state["rng_state"])
    if hasattr(model, "_moments_dev"):
        # the JAX engine's device copy of the moments: the next E-step must
        # read the host moments just set
        model._moments_dev = None

"""The comparison that decides ``correct``: the numbers a fit's outputs
give against the plain reference (``reference.py``), stage by stage.

A fit is judged on what its timed path produced (``record.py``): the
init's k-means centers, labels and OU params; the last E-step's labels,
statistics and costs under the moments it was given; the last M-step's
params and moments from the statistics it was given; the final polish's
labels and energy (or, for an exact labeler, the last E-step's energy).
The reference follows the fit stage by stage: each stage is recomputed
from the benchmark's own samples and the inputs the program handed that
stage (its moments, its statistics), which the other checks judge in
turn. Every number is a distance from what the reference says, in
float64; 0 is a perfect answer.

- ``kmeans_gap``: the most by which a sample's squared distance to its
  assigned center exceeds its distance to the nearest center.
- ``kmeans_center_err``: the largest gap between a center and the mean of
  the samples assigned to it.
- ``init_fit_gap``: the most by which an occupied cluster's OU init loss
  at the program's params lies above the least the reference finds near
  them (projected Newton in float64, inside the box). The program's
  L-BFGS stops at its own tolerance, so this is not 0; a solve that
  returns its start reads far more.
- ``estep_gain``, ``polish_gain``: the most that changing one pixel's
  label alone would lower the MRF energy (0 at an ICM, swap or expansion
  fixed point).
- ``estep_stats_err``: the largest error of the E-step's posterior sums,
  first and second moments (each relative to its array's largest entry)
  and costs (relative), recomputed at the program's labels.
- ``estep_energy_err``, ``polish_energy_err``: the relative error of the
  energy the exact moves report for their labels.
- ``estep_change``, ``polish_change`` (exact E-step, polish): the
  relative change of energy from the labels the exact moves were handed
  (mean field + ICM's) to the labels they returned, (E - E0) / |E0|.
  Moves only lower the energy: below 0 by what they gained, exactly 0
  when they return their start.
- ``mstep_mean_err``: the largest error of the M-step's means against the
  OU means of its params, relative to the largest mean.
- ``mstep_cov_err``: the largest relative error of an entry of the
  M-step's covariances against the OU covariances of its params (plus
  the jitter); ``mstep_cov_median``: the median entry's.
- ``mstep_fit_gap``: as ``init_fit_gap``, for the M-step loss of each
  state that the M-step solved (a state left on the fallback to its init
  params is not a solve).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import reference as ref
from synth import Tree


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


class Judge:
    """The reference's view of one configuration's inputs, built once a
    run and used for every fit judged."""

    def __init__(self, data, model_cfg: dict):
        self.cfg = model_cfg
        self.regions = [ref.Region(d, model_cfg.get("num_neighbor", 8))
                        for d in data]
        self.X = np.concatenate([r.x for r in self.regions])
        self.tree = Tree()
        self.beta = float(model_cfg["beta"])
        self.beta1 = float(model_cfg["beta1"])
        self.weighted_pp = int(model_cfg.get("estimate_type", 0)) == 3
        self.w_cut = [r.weights(self.beta1, True) for r in self.regions]
        self.w_pp = [r.weights(self.beta1, self.weighted_pp)
                     for r in self.regions]

    # -- stages -------------------------------------------------------------

    def kmeans(self, init) -> dict:
        X, c, lab = self.X, np.asarray(init["centers"]), init["labels"]
        d2 = ((X[:, None, :] - c[None]) ** 2).sum(-1)
        gap = float((d2[np.arange(len(lab)), lab] - d2.min(1)).max())
        err = 0.0
        for k in range(c.shape[0]):
            sel = lab == k
            if sel.any():
                err = max(err, float(np.abs(X[sel].mean(0) - c[k]).max()))
        return {"kmeans_gap": gap, "kmeans_center_err": err}

    def init_fit(self, init) -> dict:
        X, lab = self.X, init["labels"]
        K = np.asarray(init["centers"]).shape[0]
        occ = [k for k in range(K) if (lab == k).any()]
        xbar = np.stack([X[lab == k].mean(0) for k in occ])
        xxT = np.stack([(X[lab == k].T @ X[lab == k]) / (lab == k).sum()
                        for k in occ])
        fun = functools.partial(ref.init_objective, tree=self.tree,
                                min_covar=self.cfg["min_covar"])
        f0, f, _ = ref.refine(fun, np.asarray(init["params"])[occ],
                              (xbar, xxT),
                              self.cfg["param_lo"], self.cfg["param_hi"])
        return {"init_fit_gap": float(np.max(f0 - f))}

    def _moves(self, st, stage: str) -> dict:
        """The exact moves' numbers of a stage: the error of the energy
        they report, and the change of energy from their start labels to
        their result."""
        e = e0 = 0.0
        for ri, (r, lab) in enumerate(zip(self.regions, st["labels"])):
            un = ref.unary(r, st["means"], st["covars"])
            e += ref.energy(r.grid(lab), un, self.w_cut[ri], r.mask,
                            self.beta)
            if st.get("start") is not None:
                e0 += ref.energy(r.grid(st["start"][ri]), un,
                                 self.w_cut[ri], r.mask, self.beta)
        out = {f"{stage}_energy_err": abs(st["energy"] - e) / abs(e)}
        if st.get("start") is not None:
            out[f"{stage}_change"] = (e - e0) / abs(e0)
        return out

    def estep(self, e) -> dict:
        gains, errs = [], []
        for ri, (r, lab) in enumerate(zip(self.regions, e["labels"])):
            un = ref.unary(r, e["means"], e["covars"])
            g = r.grid(lab)
            gains.append(ref.local_gains(g, un, self.w_cut[ri], r.mask,
                                         self.beta).max())
            post, obs, obs2, costs = ref.estep_outputs(
                r, un, g, self.w_pp[ri], self.beta)
            errs += [_rel(e["post"][ri], post), _rel(e["obs"][ri], obs),
                     _rel(e["obs2"][ri], obs2),
                     float(np.max(np.abs(e["costs"][ri] - costs)
                                  / np.abs(costs)))]
        out = {"estep_gain": float(max(gains)),
               "estep_stats_err": float(max(errs))}
        if e.get("energy") is not None:
            out.update(self._moves(e, "estep"))
        return out

    def mstep(self, m) -> dict:
        cfg = self.cfg
        p = torch.as_tensor(np.asarray(m["params"], np.float64))
        mean, cov = ref.ou_moments(p, self.tree)
        F = cov.shape[-1]
        cov = cov + cfg["min_covar"] * torch.eye(F, dtype=cov.dtype)
        c = cov.numpy()
        cov_rel = (np.abs(np.asarray(m["covars"]) - c)
                   / np.maximum(np.abs(c), 1e-300))
        out = {"mstep_mean_err": _rel(m["means"], mean.numpy()),
               "mstep_cov_err": float(cov_rel.max()),
               "mstep_cov_median": float(np.median(cov_rel))}
        solved = ~np.all(np.asarray(m["params"])
                         == np.asarray(m["init_params"]), axis=1)
        if solved.any():
            fun = functools.partial(
                ref.mstep_objective, tree=self.tree, n=float(len(self.X)),
                lambda_0=cfg["cons_param"], min_covar=cfg["min_covar"])
            s = np.flatnonzero(solved)
            f0, f, _ = ref.refine(fun, np.asarray(m["params"])[s],
                               (m["post"][s], m["obs"][s], m["obs2"][s]),
                               cfg["param_lo"], cfg["param_hi"])
            out["mstep_fit_gap"] = float(np.max(f0 - f))
        return out

    def polish(self, pl) -> dict:
        gains = []
        for ri, (r, lab) in enumerate(zip(self.regions, pl["labels"])):
            un = ref.unary(r, pl["means"], pl["covars"])
            gains.append(ref.local_gains(r.grid(lab), un, self.w_cut[ri],
                                         r.mask, self.beta).max())
        return {"polish_gain": float(max(gains)), **self._moves(pl, "polish")}

    def numbers(self, rec) -> dict:
        """Every number of one fit's record."""
        out = {}
        out.update(self.kmeans(rec["init"]))
        out.update(self.init_fit(rec["init"]))
        out.update(self.estep(rec["estep"]))
        if rec.get("mstep") is not None:
            out.update(self.mstep(rec["mstep"]))
        if rec.get("polish") is not None:
            out.update(self.polish(rec["polish"]))
        return out


def verdict(numbers: dict, limits: dict):
    """(correct, checks): every limited number at or under its limit; a
    limited number that a fit did not give (a stage it lacks) fails. A
    NaN fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        checks[name] = [v, limit]
        if v is None or not (v <= limit):
            ok = False
    return ok, checks

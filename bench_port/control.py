"""Readings for the judge's limits: the program's numbers over many seeds
and the control's, at a cell's own size.

    python3 bench_port/control.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] \
        [--out readings.jsonl]

For each seed: the cell's data, one fit at fit seed ``seed + 1`` (as a
run's first timed fit) with its record, and the judge's numbers
(``"side": "program"``). For each control seed the same fit's stage
inputs go to the control: the reference in the program's place, computed
in the next precision below the configuration's (bfloat16 for float32,
float32 for float64), and judged alike (``"side": "control"``):

- k-means: k-means++ seeding (numpy, from the seed) and 30 Lloyd steps
  with distances, assignments and centers in the lower precision;
- the OU solves (init and M-step): the reference's float64 optimum from
  the stage's own statistics, rounded to the lower precision: the best a
  solve in that precision can hold; the M-step's moments computed in it;
- the E-step and the polish: ICM in the lower precision from the stage's
  input labels under its input moments (unary, scores and updates in that
  precision), then the statistics, costs and energy in it.

For each fault seed, the faults of a stage that returns its start
(``"side": "fault:<name>"``): ``init_start`` and ``mstep_start`` put the
init solve's and the last M-step solve's start points (the recorded
guesses, with the M-step's moments worked out from them) in the place of
their results, the stage's numbers judged; ``moves_start`` runs a fit
with the exact moves planted to return their mean field + ICM start
(`moves_return_start`) and judges it whole.

The benchmark's runs never run this; it decides the limits in
``limits/<workload>.json`` (see PERF.md).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402
import reference as ref  # noqa: E402
from judge import Judge  # noqa: E402


def lower_dtype(model_dtype: str):
    return torch.float32 if model_dtype == "float64" else torch.bfloat16


def control_kmeans(X: np.ndarray, K: int, seed: int, dtype, iters=30):
    rng = np.random.default_rng(seed)
    c = [X[rng.integers(len(X))]]
    d2 = ((X - c[0]) ** 2).sum(1)
    for _ in range(1, K):
        c.append(X[rng.choice(len(X), p=d2 / d2.sum())])
        d2 = np.minimum(d2, ((X - c[-1]) ** 2).sum(1))
    Xt = torch.as_tensor(X).to(dtype)
    C = torch.as_tensor(np.stack(c)).to(dtype)
    for _ in range(iters):
        lab = torch.argmin(((Xt[:, None] - C[None]) ** 2).sum(-1), 1)
        for k in range(K):
            sel = lab == k
            if bool(sel.any()):
                C[k] = Xt[sel].mean(0)
    lab = torch.argmin(((Xt[:, None] - C[None]) ** 2).sum(-1), 1)
    return C.double().numpy(), lab.numpy().astype(np.int64)


def _round(a, dtype):
    return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).double().numpy()


def control_record(judge: Judge, rec: dict, seed: int, dtype) -> dict:
    """The control's outputs for each stage of ``rec`` (the program's
    record, read for the stages' inputs only)."""
    cfg = judge.cfg
    K = np.asarray(rec["init"]["centers"]).shape[0]
    out = dict(n_iters=rec["n_iters"])

    # init: k-means, then the rounded optimum of each cluster's init loss
    centers, labels = control_kmeans(judge.X, K, seed, dtype)
    X = judge.X
    params = np.asarray(rec["init"]["params"], np.float64).copy()
    occ = [k for k in range(K) if (labels == k).any()]
    xbar = np.stack([X[labels == k].mean(0) for k in occ])
    xxT = np.stack([(X[labels == k].T @ X[labels == k]) / (labels == k).sum()
                    for k in occ])
    fun = functools.partial(ref.init_objective, tree=judge.tree,
                            min_covar=cfg["min_covar"])
    params[occ] = _solve(fun, params[occ], (xbar, xxT), cfg, dtype)
    out["init"] = dict(centers=centers, labels=labels, params=params)

    # the E-step: ICM from its warm labels, its outputs, all in dtype
    e = rec["estep"]
    out["estep"] = _label_stage(judge, e, dtype, stats=True,
                                energy=e.get("energy") is not None)

    m = rec.get("mstep")
    if m is not None:
        fun = functools.partial(
            ref.mstep_objective, tree=judge.tree, n=float(len(X)),
            lambda_0=cfg["cons_param"], min_covar=cfg["min_covar"])
        p = _solve(fun, m["params"], (m["post"], m["obs"], m["obs2"]), cfg,
                   dtype)
        mean, cov = ref.ou_moments(torch.as_tensor(p).to(dtype), judge.tree)
        cov = cov + cfg["min_covar"] * torch.eye(cov.shape[-1], dtype=dtype)
        out["mstep"] = dict(m, params=p, means=mean.double().numpy(),
                            covars=cov.double().numpy(),
                            init_params=np.full_like(p, np.nan))
    pl = rec.get("polish")
    if pl is not None:
        out["polish"] = _label_stage(judge, pl, dtype, stats=False,
                                     energy=True)
    return out


def _solve(fun, p0, args, cfg, dtype):
    """The reference's float64 optimum near p0, rounded to ``dtype``."""
    _, _, p = ref.refine(fun, np.asarray(p0, np.float64), args,
                         cfg["param_lo"], cfg["param_hi"])
    return _round(p, dtype)


def _label_stage(judge: Judge, st: dict, dtype, stats: bool, energy: bool):
    labels, post, obs, obs2, costs, E = [], [], [], [], [], 0.0
    for ri, r in enumerate(judge.regions):
        un = ref.unary(r, st["means"], st["covars"], dtype)
        w = judge.w_cut[ri].to(dtype)
        g = ref.icm(un, w, r.mask, r.grid(st["warm"][ri]), judge.beta)
        labels.append(g[r.rows, r.cols])
        if stats:
            o = ref.estep_outputs(r, un, g, judge.w_pp[ri], judge.beta, dtype)
            post.append(o[0])
            obs.append(o[1])
            obs2.append(o[2])
            costs.append(o[3])
        if energy:
            E += ref.energy(g, un, w, r.mask, judge.beta, dtype)
    out = dict(st, labels=labels, energy=E if energy else None)
    if stats:
        out.update(post=np.stack(post), obs=np.stack(obs),
                   obs2=np.stack(obs2), costs=np.stack(costs))
    return out


def start_labels(unary_k, wmaps, mask, init_labels, beta, n_states, *a,
                 stats=None, **kw):
    """``ops/maxflow.py::_optimize_batched`` with the fault of exact moves
    that do nothing: it returns its start labels (mean field + ICM's, in
    ``exact_labels_batched``) and reports their energy as start and
    end."""
    from phylo_hmrf_tpu_torch.ops import maxflow

    labels = torch.where(mask, init_labels, 0).to(torch.int32)
    if stats is not None:
        b = (maxflow._f32(beta) if unary_k.dtype == torch.float32
             else float(beta))
        e, _ = maxflow._energy_hist(labels, unary_k, wmaps, mask, b,
                                    n_states)
        stats.energy_start += float(e.sum())
        stats.energy_end += float(e.sum())
    return labels


@contextlib.contextmanager
def moves_return_start():
    """`start_labels` in the place of the exact moves."""
    from phylo_hmrf_tpu_torch.ops import maxflow

    opt0 = maxflow._optimize_batched
    maxflow._optimize_batched = start_labels
    try:
        yield
    finally:
        maxflow._optimize_batched = opt0


def start_faults(judge: Judge, rec: dict) -> dict:
    """{fault: numbers} of the OU solves that return their start points,
    from a sound fit's record."""
    init = rec["init"]
    params = np.array(init["params"])
    occ = [k for k in range(len(params))
           if (np.asarray(init["labels"]) == k).any()]
    params[occ] = np.asarray(init["start"])[occ]
    out = {"init_start": judge.init_fit(dict(init, params=params))}
    m = rec.get("mstep")
    if m is not None:
        p = np.asarray(m["start"], np.float64)
        mean, cov = ref.ou_moments(torch.as_tensor(p), judge.tree)
        cov = cov + judge.cfg["min_covar"] * torch.eye(cov.shape[-1],
                                                       dtype=cov.dtype)
        out["mstep_start"] = judge.mstep(dict(
            m, params=p, means=mean.numpy(), covars=cov.numpy()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(args.threads, os.cpu_count() or 1))
    spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.cell_from_spec(spec, harness.ROOT, args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    dtype = lower_dtype(cell.model["dtype"])
    sink = open(args.out, "a") if args.out else None
    every = set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)
    for seed in sorted(every):
        data, regions, tree = harness._inputs(cell, seed)
        fits = harness.Fits(cell, data, regions, tree, device)
        t0 = time.perf_counter()
        rec, info = fits.fit(seed + 1)
        fit_s = time.perf_counter() - t0
        judge = Judge(data, cell.model)
        rows = []
        if seed in args.seeds:
            t0 = time.perf_counter()
            rows.append(dict(side="program", numbers=judge.numbers(rec),
                             judge_s=time.perf_counter() - t0))
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            crec = control_record(judge, rec, seed, dtype)
            rows.append(dict(side="control", dtype=str(dtype),
                             numbers=judge.numbers(crec),
                             control_s=time.perf_counter() - t0))
        if seed in args.fault_seeds:
            for name, nums in start_faults(judge, rec).items():
                rows.append(dict(side="fault:" + name, numbers=nums))
            with moves_return_start():
                frec, _ = fits.fit(seed + 1)
            rows.append(dict(side="fault:moves_start",
                             numbers=judge.numbers(frec)))
        for row in rows:
            row.update(workload=args.workload, seed=seed,
                       n_iters=info["n_iters"], fit_s=fit_s, device=device)
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()


if __name__ == "__main__":
    main()

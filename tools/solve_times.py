#!/usr/bin/env python3
"""Device time of one M-step OU solve on its three routes, and where the
fused kernel's solve ends beside the plain driver's own twins, on one
NVIDIA GPU: the chr21 tree, the statistics of the chr21 problem's true
labels, K = 10 and 20 states, float32 and float64, 150 steps.

    python3 tools/solve_times.py [--reps 20] [--twins 16]

* fused: ``ops/lbfgs.py::fused_ou_solve`` (one launch of
  ``csrc/lbfgs.cu``), CUDA events around ``reps`` solves queued back to
  back; the rows' step counts;
* graph: ``GraphSolve`` (the route of a tree above the kernel's caps),
  CUDA events around ``reps`` solves after its capture; the capture's
  seconds;
* plain: the plain driver ``minimize_boxed`` (a host read a step), one
  solve on the synchronized host clock.

The losses are compared in float64 at each solve's params, relative to
the plain driver's loss on the card, row by row; a gap is the largest
over the K rows. The stop rule (5 steps without a relative gain of 1e-7)
makes where a solve ends sensitive to rounding, so the fused kernel's
gap is set beside the plain driver's twins: the plain driver on the card
from ``twins`` starts moved by one ulp (a random sign a coordinate), and
on the CPU. The fused kernel runs from the same moved starts (its own
twins). In float64 the 1-5-step solves of both routes agree to rounding
(``short_max_rel``), and ``diverge`` follows the params' relative
distance as the step cap grows: the fused kernel's from the plain
driver's on the card, beside the plain driver's on the CPU from it.

Prints the kernel's ``ptxas`` lines, then one JSON line per (K, dtype):
ms per solve of each route, the rows' step counts, the gaps, the card's
name and power limit.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def one(K: int, dtype, reps: int, twins: int, dev) -> dict:
    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.models.ou import (ou_nll_stats, ridge_coef,
                                                tree_tensors)
    from phylo_hmrf_tpu_torch.ops import lbfgs
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    tree, region, _, _, _, true = chr21_problem(0, K=K)
    X = region.flat_values().astype(np.float64)
    cfg = PhyloHMRFConfig()
    g = np.eye(K)[true]
    post, obs, obs2 = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (
        g.sum(0), g.T @ X, np.einsum("nk,nf,ng->kfg", g, X, X)))
    p0 = torch.as_tensor(np.random.default_rng(0).random((K, tree.n_params))
                         * 0.8 + 0.2, dtype=dtype, device=dev)
    n = float(X.shape[0])
    lo, hi, iters = cfg.param_lo, cfg.param_hi, cfg.mstep_iters
    tt = tree_tensors(tree, dev, dtype)
    objective = functools.partial(ou_nll_stats, tt=tt, n_samples=n,
                                  lambda_0=cfg.lambda_0,
                                  min_covar=cfg.min_covar)
    tt64 = tree_tensors(tree, "cpu", torch.float64)

    def loss(p):
        return ou_nll_stats(p.cpu().double(), post.cpu().double(),
                            obs.cpu().double(), obs2.cpu().double(), tt64, n,
                            cfg.lambda_0, cfg.min_covar)

    def fused(start=p0, n_iters=iters):
        return lbfgs.fused_ou_solve(
            start, tt.index, tt.A2T, obs, obs2, post, n_samples=n,
            coef=ridge_coef(dtype, n, cfg.lambda_0), min_covar=cfg.min_covar,
            lo=lo, hi=hi, n_iters=n_iters)

    def plain(start=p0, n_iters=iters, on=dev):
        t = tree_tensors(tree, on, dtype)
        obj = functools.partial(ou_nll_stats, tt=t, n_samples=n,
                                lambda_0=cfg.lambda_0,
                                min_covar=cfg.min_covar)
        a = [x.to(on) for x in (post, obs, obs2)]
        return lbfgs.minimize_boxed(lambda q: obj(q, *a), start.to(on), lo,
                                    hi, n_iters)[0]

    rec = dict(K=K, dtype=str(dtype)[6:], fused_ms=_events_ms(fused, reps))
    pk, fk, steps = fused()
    rec.update(steps_max=int(steps.max()), steps_mean=float(
        steps.float().mean()))
    t0 = time.perf_counter()
    graph = lbfgs.GraphSolve(objective, p0, (post, obs, obs2), lo, hi, iters)
    rec["graph_capture_s"] = time.perf_counter() - t0
    rec["graph_ms"] = _events_ms(lambda: graph(p0, post, obs, obs2), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps = plain()
    torch.cuda.synchronize()
    rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
    fs = loss(ps)

    def gap(p):   # the largest of the rows' relative excess over fs
        return float(((loss(p) - fs) / fs.abs()).max())

    rec["loss_gap_fused_vs_plain"] = gap(pk)
    rec["loss_gap_cpu_twin"] = gap(plain(on="cpu"))
    gen = torch.Generator().manual_seed(1)
    ulp = float(torch.finfo(dtype).eps)
    plain_twins, fused_twins = [], []
    for _ in range(twins):
        sign = torch.randint(0, 2, tuple(p0.shape), generator=gen) * 2 - 1
        start = p0 * (1 + sign.to(dev, dtype) * ulp)
        plain_twins.append(gap(plain(start)))
        fused_twins.append(gap(fused(start)[0]))
    rec.update(plain_twins=sorted(plain_twins), fused_twins=sorted(
        fused_twins))
    if dtype == torch.float64:
        short, diverge = 0.0, {}
        for k in (1, 2, 3, 4, 5, 10, 20, 40):
            pp, pf = plain(n_iters=k), fused(n_iters=k)[0]
            scale = float(pp.abs().max())
            d = float((pf - pp).abs().max()) / scale
            if k <= 5:
                short = max(short, d)
            else:
                pc = plain(n_iters=k, on="cpu").to(dev)
                diverge[k] = dict(fused=d, cpu=float(
                    (pc - pp).abs().max()) / scale)
        rec.update(short_max_rel=short, diverge=diverge)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--twins", type=int, default=16)
    a = ap.parse_args()
    import torch

    from phylo_hmrf_tpu_torch import _build

    _build.load()
    keep = False
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            keep = "lbfgs" in line or "ou_value_grad" in line
        if keep:
            print(f"[ptxas] {line.strip()}")
    dev = torch.device("cuda")
    card = _power_limit()
    for K in (10, 20):
        for dtype in (torch.float32, torch.float64):
            rec = one(K, dtype, a.reps, a.twins, dev)
            rec["card"] = card
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

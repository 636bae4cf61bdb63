"""Per-phase timers and the EM convergence monitor — the port's own copy
of ``PhaseTimer`` and ``ConvergenceMonitor`` from
``phylo_hmrf_tpu/utils/profiling.py`` — and `torch_trace`, the
counterpart of its ``jax_trace``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall-clock per named phase; thread-unsafe by design
    (one per fit loop)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_s": round(self.totals[k] / max(self.counts[k], 1),
                                    4)}
                for k in sorted(self.totals)}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=1)


class ConvergenceMonitor:
    """EM convergence record (upgrades the reference's ConvergenceMonitor,
    base.py:22-94, which printed to stderr and whose `converged` flag was
    never consulted). Tracks the cost rows the graph path actually uses and
    can persist them as JSON-lines."""

    def __init__(self, tol: float, patience: int, log_file: str | None = None,
                 verbose: bool = False):
        self.tol = tol
        self.patience = patience
        self.verbose = verbose
        self.log_file = log_file
        self.history = []   # rows [iter, pairwise, unary, cost1]
        self.best = (0, float("inf"))

    def report(self, it: int, pairwise: float, unary: float, cost1: float):
        row = [it, pairwise, unary, cost1]
        self.history.append(row)
        if cost1 < self.best[1]:
            self.best = (it, cost1)
        if self.verbose:
            print(f"[monitor] iter={it} pairwise={pairwise:.6f} "
                  f"unary={unary:.6f} cost1={cost1:.6f}")
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps({"iter": it, "pairwise": pairwise,
                                    "unary": unary, "cost1": cost1}) + "\n")

    @property
    def converged(self) -> bool:
        if len(self.history) < 2:
            return False
        prev, cur = self.history[-2][3], self.history[-1][3]
        rel = abs((cur - prev) / prev) if prev != 0 else float("inf")
        return rel < self.tol

    @property
    def exhausted_patience(self) -> bool:
        if not self.history:
            return False
        return self.history[-1][0] - self.best[0] > self.patience


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """``torch.profiler`` scope over the host and, where CUDA is present,
    the device; writes a Chrome trace (``trace_<pid>.json``) into
    ``log_dir`` on exit. No-op when log_dir is empty."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"trace -> {path}")

"""Checkerboard ICM and annealed mean field — plain PyTorch, one region.

Counterpart of ``phylo_hmrf_tpu/ops/icm.py`` (same names, the per-region
(H, W, K) layout). The E-step runs the K-major kernel versions in
``mf_kernels.py`` and ``icm_kernels.py``; these are the readable
references the tests hold both packages to.

Pixels split into 4 colours by (i % 2, j % 2); no two pixels of a colour
are 8-neighbours, so updating a whole colour at once is an exact
block-coordinate-descent step and the energy never rises.
"""

from __future__ import annotations

import numpy as np
import torch

from phylo_hmrf_tpu_torch.ops.potts import (
    neighbor_sums, neighbor_sums_soft, potts_energy, softmax)

MF_TEMPS = (4.0, 2.0, 1.0, 0.5, 0.25)


def _phase_masks(H: int, W: int, device):
    i = torch.arange(H, device=device)[:, None]
    j = torch.arange(W, device=device)[None, :]
    return [(i % 2 == a) & (j % 2 == b) for a in (0, 1) for b in (0, 1)]


def icm(unary: torch.Tensor, wmaps: torch.Tensor, mask: torch.Tensor,
        init_labels: torch.Tensor, beta: float, max_sweeps: int = 60,
        beta_ramp: int = 0) -> torch.Tensor:
    """Checkerboard ICM from ``init_labels`` until no label changes or
    ``max_sweeps`` sweeps ran; returns labels (H, W) int32.

    unary (H, W, K); wmaps (4, H, W); mask (H, W) bool. ``beta_ramp > 0``
    first runs that many sweeps at the strength
    beta * min(1, (t + 1) / beta_ramp), t = 0, 1, ..., computed in the
    unary's float32 or float64 (a deterministic anneal for cold starts)."""
    H, W, K = unary.shape
    phases = _phase_masks(H, W, unary.device)
    labels = torch.where(mask, init_labels, 0).to(torch.int32)

    def one_sweep(labels, beta_t):
        changed = 0
        for ph in phases:
            agree, _ = neighbor_sums(labels, wmaps, K)
            score = unary - beta_t * agree
            best = torch.argmin(score, dim=-1).to(torch.int32)
            new = torch.where(ph & mask, best, labels)
            changed += int(torch.sum(new != labels))
            labels = new
        return labels, changed

    # the ramp in the unary's precision, as the JAX loop computes it (in
    # float64 under the strict-parity mode's x64)
    ft = np.float64 if unary.dtype == torch.float64 else np.float32
    for t in range(beta_ramp):
        ramp = np.minimum(ft(1.0), ft(t + 1.0) / ft(beta_ramp))
        labels, _ = one_sweep(labels, float(ft(beta) * ramp))
    changed, sweep = 1, 0
    while changed > 0 and sweep < max_sweeps:
        labels, changed = one_sweep(labels, beta)
        sweep += 1
    return labels


def icm_with_energy(unary, wmaps, mask, init_labels, beta,
                    max_sweeps: int = 60, beta_ramp: int = 0):
    """ICM plus the final MRF energy."""
    labels = icm(unary, wmaps, mask, init_labels, beta, max_sweeps,
                 beta_ramp)
    return labels, potts_energy(labels, unary, wmaps, mask, beta)


def mean_field(unary: torch.Tensor, wmaps: torch.Tensor, beta: float,
               temps=MF_TEMPS, iters_per_temp: int = 8,
               damping: float = 0.5) -> torch.Tensor:
    """Annealed, damped mean-field relaxation; returns the hardened labels
    (H, W) int32 (argmin of the expected field after the last sweep)."""
    q = softmax(-unary, dim=-1)
    for T in temps:
        for _ in range(iters_per_temp):
            agree, wsum = neighbor_sums_soft(q, wmaps)
            field = unary + beta * (wsum[..., None] - agree)
            q = damping * q + (1.0 - damping) * softmax(-field / T, dim=-1)
    agree, wsum = neighbor_sums_soft(q, wmaps)
    field = unary + beta * (wsum[..., None] - agree)
    return torch.argmin(field, dim=-1).to(torch.int32)


def label_optimize(unary: torch.Tensor, wmaps: torch.Tensor,
                   mask: torch.Tensor, init_labels: torch.Tensor,
                   beta: float, method: str = "mf_icm",
                   max_sweeps: int = 60, beta_ramp: int = 0) -> torch.Tensor:
    """One region's E-step labeling. ``method`` "mf_icm": annealed mean
    field proposes, ICM polishes the proposal and the warm labels, the
    lower energy wins; "icm": ICM from the warm labels; "lbp": as
    "mf_icm" with a min-sum loopy BP proposal (``ops/lbp.py``)."""
    if method == "icm":
        return icm(unary, wmaps, mask, init_labels, beta, max_sweeps,
                   beta_ramp)
    if method == "lbp":
        from phylo_hmrf_tpu_torch.ops.lbp import lbp_labels
        prop = lbp_labels(unary, wmaps, mask, beta)
    elif method == "mf_icm":
        prop = mean_field(unary, wmaps, beta)
    else:
        raise ValueError(f"unknown label method {method!r}")
    cand_a, e_a = icm_with_energy(unary, wmaps, mask, prop, beta, max_sweeps)
    cand_b, e_b = icm_with_energy(unary, wmaps, mask, init_labels, beta,
                                  max_sweeps)
    return torch.where(e_a <= e_b, cand_a, cand_b)

"""Loopy belief propagation (min-sum) for the weighted-Potts grid MRF —
plain PyTorch, one region.

Counterpart of ``phylo_hmrf_tpu/ops/lbp.py`` (same names, the (H, W, K)
layout). One synchronous iteration updates the eight directed messages
into every pixel. For the Potts cost beta * w_e * [j != k] the inner
minimisation has the closed form

    m_{u->v}(k) = min( mu(k), min_j mu(j) + beta * w_uv ),

with mu the sender's unary plus its incoming messages except the one from
v. Messages are normalised to min 0 and damped; edges of weight 0 (mask
boundaries, grid borders) give messages that normalise to zero.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch.ops.potts import _shift_bwd, _shift_fwd


def _message(mu: torch.Tensor, w: torch.Tensor, beta) -> torch.Tensor:
    """Closed-form Potts min-sum message from the sender field mu
    (H, W, K) across edges of weight w (H, W); normalised to min 0."""
    floor = torch.amin(mu, dim=-1, keepdim=True) + beta * w[..., None]
    m = torch.minimum(mu, floor)
    return m - torch.amin(m, dim=-1, keepdim=True)


def _sum8(M: torch.Tensor) -> torch.Tensor:
    """The eight message planes added in slot order."""
    total = M[0]
    for i in range(1, M.shape[0]):
        total = total + M[i]
    return total


def lbp_min_sum(unary: torch.Tensor, wmaps: torch.Tensor, mask: torch.Tensor,
                beta, n_iters: int = 30, damping: float = 0.5):
    """Min-sum LBP for sum_p unary[p, s_p] + beta * sum_e w_e [s_u != s_v].

    unary (H, W, K); wmaps (4, H, W) forward edge weights (``ops/potts.py``
    conventions); mask (H, W) bool. Returns (labels (H, W) int32, beliefs
    (H, W, K))."""
    # M[2d]: message into p from its forward neighbour p + delta_d (edge
    # weight stored at p); M[2d + 1]: from its backward neighbour
    # p - delta_d (weight stored at the neighbour)
    w_in_fwd = [wmaps[d] for d in range(4)]
    w_in_bwd = [_shift_bwd(wmaps[d], dr, dc, 0.0)
                for d, (dr, dc) in enumerate(DIRS)]
    M = torch.zeros((8,) + tuple(unary.shape), dtype=unary.dtype,
                    device=unary.device)
    inf = float("inf")
    for _ in range(n_iters):
        total = unary + _sum8(M)
        new = []
        for d, (dr, dc) in enumerate(DIRS):
            # the sender's field leaves out what it received from p
            mu_f = _shift_fwd(total - M[2 * d + 1], dr, dc, inf)
            new.append(_message(mu_f, w_in_fwd[d], beta))
            mu_b = _shift_bwd(total - M[2 * d], dr, dc, inf)
            new.append(_message(mu_b, w_in_bwd[d], beta))
        Mn = torch.stack(new)
        # shifted-in inf fields give nan/inf messages at the borders; no
        # edge crosses there, so the message is 0
        Mn = torch.where(torch.isfinite(Mn), Mn, 0.0)
        M = damping * M + (1.0 - damping) * Mn
    beliefs = unary + _sum8(M)
    labels = torch.argmin(beliefs, dim=-1).to(torch.int32)
    return torch.where(mask, labels, 0), beliefs


def lbp_labels(unary, wmaps, mask, beta, n_iters: int = 30,
               damping: float = 0.5) -> torch.Tensor:
    """The labels of `lbp_min_sum`."""
    return lbp_min_sum(unary, wmaps, mask, beta, n_iters, damping)[0]

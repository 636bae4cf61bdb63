"""K2: checkerboard ICM on K-major fields, with its CUDA phase kernel.

Counterpart of ``phylo_hmrf_tpu/ops/icm_pallas.py``: ``icm_phase_`` (kernel
in ``csrc/icm.cu``) times eight makes the sweep pair of
``_icm_sweep_pair_padded``, and ``icm_kmajor`` is the ``icm_pallas`` loop.
Layout: labels, mask (R, H, W) int32; unary_k (R, K, H, W) and wmaps
(R, 4, H, W) float32.

On a CPU tensor ``icm_phase_`` runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2

# two sweeps of the four colours, in the TPU kernel's order
_PAIR_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1)) * 2


def icm_phase_plain(labels, unary_k, wmaps, mask_i, beta, a: int, b: int):
    """Plain version of K2: the labels after one phase (a new tensor)."""
    R, K, H, W = unary_k.shape
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    agree = torch.zeros_like(unary_k)
    for d, (dr, dc) in enumerate(DIRS):
        nb = _shift2(labels, dr, dc, -1)[:, None]
        agree = agree + wmaps[:, d, None] * (nb == ks).to(unary_k.dtype)
        w_bwd = _shift2(wmaps[:, d], -dr, -dc)
        nbm = _shift2(labels, -dr, -dc, -1)[:, None]
        agree = agree + w_bwd[:, None] * (nbm == ks).to(unary_k.dtype)
    score = unary_k - beta * agree
    best = torch.argmin(score, dim=1).to(torch.int32)
    rows = torch.arange(H, device=labels.device)[:, None]
    cols = torch.arange(W, device=labels.device)[None, :]
    phase = (rows % 2 == a) & (cols % 2 == b)
    return torch.where(phase & (mask_i != 0), best, labels)


def icm_phase_(labels, unary_k, wmaps, mask_i, beta, a: int, b: int):
    """One checkerboard phase, updating ``labels`` in place (safe: pixels
    of one colour are never neighbours); returns ``labels``."""
    if labels.device.type == "cpu":
        return labels.copy_(icm_phase_plain(labels, unary_k, wmaps, mask_i,
                                            beta, a, b))
    R, K, H, W = unary_k.shape
    _build.check_tensors(
        "icm_phase_", labels=(labels, torch.int32, (R, H, W)),
        unary_k=(unary_k, torch.float32, (R, K, H, W)),
        wmaps=(wmaps, torch.float32, (R, 4, H, W)),
        mask=(mask_i, torch.int32, (R, H, W)))
    lib = _build.load()
    _build.check(lib.phmrf_icm_phase(
        labels.data_ptr(), unary_k.data_ptr(), wmaps.data_ptr(),
        mask_i.data_ptr(), R, K, H, W, float(beta), int(a), int(b),
        _build.stream_of(labels)), "K2 icm_phase")
    icm_phase_.launches += 1
    return labels


icm_phase_.launches = 0


def icm_sweep_pair(labels, unary_k, wmaps, mask_i, beta, *,
                   plain: bool = False):
    """Two checkerboard sweeps (eight phases); returns new labels."""
    new = labels.clone()
    for a, b in _PAIR_PHASES:
        if plain:
            new = icm_phase_plain(new, unary_k, wmaps, mask_i, beta, a, b)
        else:
            icm_phase_(new, unary_k, wmaps, mask_i, beta, a, b)
    return new


def icm_kmajor(unary_k, wmaps, mask, init_labels, beta,
               max_sweeps: int = 60, *, plain: bool = False):
    """Batched checkerboard ICM (the ``icm_pallas`` loop).

    Runs sweep pairs while any label of the bucket changed and fewer than
    ``max_sweeps`` sweeps ran; like the JAX loop, a capped run may
    overshoot an odd ``max_sweeps`` by one sweep. Reads the change count
    once per pair (one host sync). Returns labels (R, H, W) int32."""
    mask_i = mask.to(torch.int32)
    labels = torch.where(mask, init_labels, 0).to(torch.int32).contiguous()
    changed, sweep = 1, 0
    while changed > 0 and sweep < max_sweeps:
        new = icm_sweep_pair(labels, unary_k, wmaps, mask_i, beta,
                             plain=plain)
        changed = int(torch.count_nonzero(new != labels))
        labels = new
        sweep += 2
    return labels

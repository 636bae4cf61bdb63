"""K2 and K8: checkerboard ICM on K-major fields, with the CUDA phase
kernel.

Counterpart of ``phylo_hmrf_tpu/ops/icm_pallas.py``: ``icm_phase_`` (K2)
times eight makes the sweep pair of ``_icm_sweep_pair_padded``,
``icm_phase_halo_`` (K8) replaces ``icm_phase_pallas(halo_extended=True)``
(both kernels in ``csrc/icm.cu``), and ``icm_kmajor`` is the
``icm_pallas`` loop. Layout: labels, mask (R, H, W) int32; unary_k
(R, K, H, W) and wmaps (R, 4, H, W) float32.

On a CPU tensor the wrappers run their plain versions; on a CUDA tensor
they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2

# two sweeps of the four colours, in the TPU kernel's order
_PAIR_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1)) * 2


def _best_plain(labels, unary_k, wmaps, beta, rows):
    """argmin_k unary - beta * agree at the rows ``rows`` of labels/wmaps
    (all of unary's rows)."""
    R, K = unary_k.shape[:2]
    ks = torch.arange(K, device=labels.device).view(1, K, 1, 1)
    agree = unary_k.new_zeros((R, K) + tuple(labels.shape[-2:]))
    for d, (dr, dc) in enumerate(DIRS):
        nb = _shift2(labels, dr, dc, -1)[:, None]
        agree = agree + wmaps[:, d, None] * (nb == ks).to(unary_k.dtype)
        w_bwd = _shift2(wmaps[:, d], -dr, -dc)
        nbm = _shift2(labels, -dr, -dc, -1)[:, None]
        agree = agree + w_bwd[:, None] * (nbm == ks).to(unary_k.dtype)
    score = unary_k - beta * agree[..., rows, :]
    return torch.argmin(score, dim=1).to(torch.int32)


def _phase(H, W, a, b, device):
    rows = torch.arange(H, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    return (rows % 2 == a) & (cols % 2 == b)


def icm_phase_plain(labels, unary_k, wmaps, mask_i, beta, a: int, b: int):
    """Plain version of K2: the labels after one phase (a new tensor)."""
    R, K, H, W = unary_k.shape
    best = _best_plain(labels, unary_k, wmaps, beta, slice(None))
    phase = _phase(H, W, a, b, labels.device)
    return torch.where(phase & (mask_i != 0), best, labels)


def icm_phase_halo_plain(lab_ext, unary_k, w_ext, mask_i, beta, a: int,
                         b: int):
    """Plain version of K8: lab_ext (R, H+2, W) after one phase of its
    center rows (a new tensor; the halo rows are copied unchanged)."""
    R, K, H, W = unary_k.shape
    center = slice(1, H + 1)
    best = _best_plain(lab_ext, unary_k, w_ext, beta, center)
    phase = _phase(H, W, a, b, lab_ext.device)
    out = lab_ext.clone()
    out[:, center] = torch.where(phase & (mask_i != 0), best,
                                 lab_ext[:, center])
    return out


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
    with _build.on_device(labels):
        _build.check(lib.phmrf_icm_phase(
            labels.data_ptr(), unary_k.data_ptr(), wmaps.data_ptr(),
            mask_i.data_ptr(), R, K, H, W, 0, float(beta), int(a), int(b),
            _build.stream_of(labels)), "K2 icm_phase")
    icm_phase_.launches += 1
    return labels


icm_phase_.launches = 0


def icm_phase_halo_(lab_ext, unary_k, w_ext, mask_i, beta, a: int, b: int):
    """One checkerboard phase of a row shard (K8), updating the center
    rows of ``lab_ext`` (R, H+2, W) in place; its first and last rows and
    those of w_ext (R, 4, H+2, W) hold the neighbouring shards' boundary
    rows (zeros at the mesh ends). unary_k (R, K, H, W) and mask_i
    (R, H, W) cover the center; ``a`` is the colour's row parity in the
    shard's local rows. Returns ``lab_ext``."""
    if lab_ext.device.type == "cpu":
        return lab_ext.copy_(icm_phase_halo_plain(lab_ext, unary_k, w_ext,
                                                  mask_i, beta, a, b))
    R, K, H, W = unary_k.shape
    _build.check_tensors(
        "icm_phase_halo_", lab_ext=(lab_ext, torch.int32, (R, H + 2, W)),
        unary_k=(unary_k, torch.float32, (R, K, H, W)),
        w_ext=(w_ext, torch.float32, (R, 4, H + 2, W)),
        mask=(mask_i, torch.int32, (R, H, W)))
    lib = _build.load()
    with _build.on_device(lab_ext):
        _build.check(lib.phmrf_icm_phase(
            lab_ext.data_ptr(), unary_k.data_ptr(), w_ext.data_ptr(),
            mask_i.data_ptr(), R, K, H, W, 1, float(beta), int(a), int(b),
            _build.stream_of(lab_ext)), "K8 icm_phase_halo")
    icm_phase_halo_.launches += 1
    return lab_ext


icm_phase_halo_.launches = 0


def icm_sweep_pair(labels, unary_k, wmaps, mask_i, beta, *,
                   plain: bool = False, row_offset: int = 0):
    """Two checkerboard sweeps (eight phases); returns new labels. Row r
    of the arrays has the colour parity of global row r + ``row_offset``
    (a row shard's slab starts at its first row minus the halo depth)."""
    new = labels.clone()
    for a, b in _PAIR_PHASES:
        a = (a + row_offset) % 2
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

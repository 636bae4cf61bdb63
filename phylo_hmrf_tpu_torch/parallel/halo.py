"""Spatial (row-sharded) E-step with halo exchange — counterpart of
``phylo_hmrf_tpu/parallel/halo.py``.

One region's rows are split over the shards of a mesh (`parallel/mesh.py`)
for the grids that dominate a fit, such as a chromosome at 10 kb. Every
function takes and returns per-shard lists: element i lives on shard i's
device. `extend_rows` is the counterpart of ``ppermute``: each shard gets
its neighbours' boundary rows, zeros at the ends of the mesh; `psum` sums
per-shard values in shard order on the first shard's device.

Correctness of the halo (as in the JAX module): every Potts operator reads
per-direction edge-weight maps; an edge crossing a shard boundary has its
weight stored on exactly one side, so extending labels / q and the weights
by the exchanged rows makes each shard's center rows exact. Zero-filled
end rows are the "no edge" encoding: label 0, mask 0, weight 0, q 0, never
updated (mask 0) and never weighed (weight exactly 0).

Per-shard kernel operands use the batched layout of the kernels with one
region: q, unary_k (1, K, Hl, W); weights (1, 4, Hl, W); labels, mask
(1, Hl, W); rows are axis -2 throughout. Which kernels run:

* mean field: with 1 <= ``iters_per_temp`` <= 8 and Hl >= 8, one 8-row
  exchange per temperature and K1 (``mf_sweeps``) on the extended slabs
  (the exchanged rows evolve in the kernel exactly as the neighbour
  computes them for the first 8 sweeps); otherwise K7
  (``mf_sweeps_halo``), all of a temperature's sweeps in one call;
* ICM: with Hl >= 8, one 8-row exchange per sweep pair and K2 on the
  extended slabs with the global colour parity; otherwise K8
  (``icm_sweep_halo_``), one call per sweep, which counts the labels it
  changed on the device (one int read per sweep and device).

K7 and K8 take every shard of a device in one launch and read the rows
beyond a shard's edges where they lie (``ops/halo_rows.py``, the table of
``row_sources``): on one device (the one-card mesh), one launch runs a
temperature's sweeps or a sweep's four phases behind a grid barrier;
across devices, each sweep or phase first copies the one row a side that
lies on another device (the counterpart of ``ppermute``), then launches
once a device.

The JAX package takes its kernel branch only for TPU tile shapes (Hl % 8 ==
0, W % 128 == 0); the CUDA kernels take any shape, so this port takes it
for every shard. The energies of both ICM candidates (K3's pair entry, one
launch) and the finishing statistics (K4) run on each shard's 1-row
halo-extended slab with the halo rows masked out.

Across processes (a mesh of ``make_mesh(..., processes=True)``), every
process runs these functions on its own shards (SPMD), with ``owners``
the mesh's process of each shard: the per-shard lists hold ``None`` for
the shards of other processes, `extend_rows` and K7/K8's remote rows
exchange the rows at a process boundary (``ops/halo_rows.py``), `psum`
all-gathers the shards' partials and adds them in shard order, so every
process gets bitwise the sum of the one-process mesh, and the ICM
stopping test reads that global count on every process (a process that
stopped a sweep early would leave the others waiting on its exchange).
The results are the one-process mesh's on every process.

``plain=True`` runs the kernels' plain versions on any device (the
model's float64 mode). In float64 the shards' energies and statistics
are not summed per shard: each shard gives its rows' sums
(``finish_kernels.energy_rows`` / ``finish_rows``), and the rows of all
the shards, in row order, fold into bitwise the single-device numbers.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu_torch.config import SMALL_EPS
from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf_kmajor
from phylo_hmrf_tpu_torch.ops.finish_kernels import (
    cost_vec_from_sums, energy_from_rows, energy_rows, finish_from_rows,
    finish_rows, finish_stats, potts_energy_pair)
from phylo_hmrf_tpu_torch.ops.icm import MF_TEMPS
from phylo_hmrf_tpu_torch.ops.halo_rows import (extend_rows, first_local,
                                                gather_shards, row_sources)
from phylo_hmrf_tpu_torch.parallel.distributed import all_gather_tensors
from phylo_hmrf_tpu_torch.ops.icm_kernels import (icm_sweep_halo_,
                                                  icm_sweep_pair)
from phylo_hmrf_tpu_torch.ops.mf_kernels import (
    expected_field_sums, incident_weight_sum, mf_sweeps, mf_sweeps_halo)
from phylo_hmrf_tpu_torch.ops.potts import (pinned, softmax, valid_maps,
                                            weight_maps)

HALO = 8   # deep-halo depth: K1 sweeps / K2 phases per exchange


def psum(xs, owners=None):
    """Sum of the shards' values in shard order, on the first device (this
    process's first, when the mesh spans processes: the partials of the
    other processes' shards, ``None`` here, are all-gathered first)."""
    xs = gather_shards(xs, owners, first_local(xs).device)
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def _each(fn, *lists):
    """``fn`` over the shards' entries of ``lists``; ``None`` for a shard
    of another process."""
    return [None if args[0] is None else fn(*args) for args in zip(*lists)]


def _row_sources(xs, owners=None):
    """The row sources of the shards' tensors ``xs`` (rows on axis -2;
    equal row blocks, so a shard of another process has the height of
    this process's)."""
    Hl = first_local(xs).shape[-2]
    return row_sources([None if x is None else x.device for x in xs],
                       [Hl if x is None else x.shape[-2] for x in xs],
                       owners)


def _center(x, depth: int):
    return x[..., depth:x.shape[-2] - depth, :].contiguous()


def _zero_rows(x):
    """``x`` with one zero row on each side of axis -2."""
    shape = list(x.shape)
    shape[-2] = 1
    z = x.new_zeros(shape)
    return torch.cat([z, x, z], dim=-2)


def _mf_base(unary_k, w_ext, beta):
    """base = unary + beta * wsum with the cross-shard backward weights.
    unary_k (1, K, Hl, W); w_ext (1, 4, Hl+2, W) halo-extended."""
    return unary_k + beta * incident_weight_sum(w_ext)[:, None, 1:-1]


def _mean_field_halo_kernels(unary_k, w_ext, beta, temps, iters_per_temp,
                             damping, plain: bool = False, owners=None):
    """Annealed mean field on the row shards; returns labels per shard
    (1, Hl, W) int32. K1 on 8-row-extended slabs, or K7 per temperature
    (module docstring)."""
    base = _each(lambda u, w: _mf_base(u, w, beta), unary_k, w_ext)
    q = _each(lambda u: softmax(-u, dim=1), unary_k)
    if 1 <= iters_per_temp <= HALO and first_local(q).shape[-2] >= HALO:
        # the per-E-step constant slabs are exchanged once
        base_ext = extend_rows(base, HALO, owners)
        w_ext8 = extend_rows(_each(lambda w: _center(w, 1), w_ext), HALO,
                             owners)
        for T in temps:
            q = _each(lambda qe, be, we: _center(mf_sweeps(
                qe, be, we, T, damping, beta, n_inner=iters_per_temp,
                plain=plain), HALO), extend_rows(q, HALO, owners), base_ext,
                w_ext8)
    else:
        sources = _row_sources(q, owners)
        for T in temps:
            q = mf_sweeps_halo(q, base, w_ext, T, damping, beta,
                               n_sweeps=iters_per_temp, sources=sources,
                               plain=plain)

    # final hard assignment at T -> 0, as `mean_field_kmajor` does
    def hard(qe, w, u):
        agree, wsum = expected_field_sums(qe, w)
        field = u + beta * (wsum[:, None, 1:-1] - agree[..., 1:-1, :])
        return torch.argmin(field, dim=1).to(torch.int32)
    return _each(hard, extend_rows(q, 1, owners), w_ext, unary_k)


def _icm_halo_kernels(unary_k, w_ext, mask, init_labels, beta,
                      max_sweeps: int, plain: bool = False, owners=None):
    """Checkerboard ICM on the row shards from ``init_labels``; returns
    labels per shard (1, Hl, W) int32. The colour parity is that of the
    global row (a shard starts at row shard * Hl). Runs while any label of
    the region changed (summed over the shards, read once per sweep pair
    on the K2 branch, once per sweep and device on the K8 branch; across
    processes the count of every process, so all stop at the same sweep)
    and fewer than ``max_sweeps`` sweeps ran."""
    Hl = first_local(unary_k).shape[-2]
    row0 = [i * Hl for i in range(len(unary_k))]
    mask_i = _each(lambda m: m.to(torch.int32), mask)
    labels = _each(lambda m, w: torch.where(m, w, 0).to(torch.int32)
                   .contiguous(), mask, init_labels)
    changed, sweep = 1, 0
    if Hl >= HALO:
        # per-E-step constant slabs exchanged once
        unp = extend_rows(unary_k, HALO, owners)
        wp = extend_rows(_each(lambda w: _center(w, 1), w_ext), HALO, owners)
        maskp = extend_rows(mask_i, HALO, owners)
        while changed > 0 and sweep < max_sweeps:
            new = _each(lambda lp, u, w, m, r0: _center(icm_sweep_pair(
                lp, u, w, m, beta, plain=plain, row_offset=r0 - HALO), HALO),
                extend_rows(labels, HALO, owners), unp, wp, maskp, row0)
            changed = int(psum(_each(lambda a, b: torch.count_nonzero(a != b),
                                     new, labels), owners))
            labels = new
            sweep += 2
        return labels

    sources = _row_sources(labels, owners)
    # one int32 a device and sweep, zeroed once: K8 adds its changes there
    counts = {d: torch.zeros(max(max_sweeps, 1), dtype=torch.int32, device=d)
              for d in dict.fromkeys(lab.device for lab in labels
                                     if lab is not None)}
    while changed > 0 and sweep < max_sweeps:
        icm_sweep_halo_(labels, unary_k, w_ext, mask_i, beta,
                        {d: c[sweep] for d, c in counts.items()}, row0=row0,
                        sources=sources, plain=plain)
        changed = sum(int(c[sweep]) for c in counts.values())
        if any(lab is None for lab in labels):   # the other processes'
            changed = sum(int(c[0]) for c in all_gather_tensors(
                [torch.tensor(changed, dtype=torch.int64)], 1))
        sweep += 1
    return labels


def _energy_halo_pair(labels_a, labels_b, unary_z, w_z, mask_z, beta,
                      plain: bool = False, owners=None):
    """The region's MRF energies of two labelings, (2, 1): K3's pair entry
    (one launch a shard, each row bitwise the single K3 of its labeling)
    on each shard's slabs of exchanged labels with one halo row on each
    side, where unary, mask and weights are zero (``*_z``). So each shard
    counts its own pixels and the forward edges whose weights it stores,
    into the next shard's first row. Summed over the shards in shard
    order, float64. In float64: the energies folded from the rows of all
    the shards (the halo rows dropped, their terms are zero)."""
    u0 = first_local(unary_z)
    if pinned(u0.dtype):
        return torch.stack([energy_from_rows(torch.cat(gather_shards(_each(
            lambda lab, u, w, m: energy_rows(u, m, lab, w)[..., 1:-1],
            extend_rows(labels, 1, owners), unary_z, w_z, mask_z), owners,
            u0.device), dim=-1), beta) for labels in (labels_a, labels_b)])
    return psum(_each(lambda la, lb, u, w, m: potts_energy_pair(
        u, m, la, lb, w, beta, plain=plain).double(),
        extend_rows(labels_a, 1, owners), extend_rows(labels_b, 1, owners),
        unary_z, w_z, mask_z), owners)


def estep_region_rowsharded(img, mask, dmaps, warm, means, covars, beta,
                            beta1, *, weighted_pp: bool, max_sweeps: int,
                            temps=MF_TEMPS, iters_per_temp: int = 8,
                            damping: float = 0.5, plain: bool = False,
                            owners=None):
    """The E-step of one region whose rows are split over shards. Lists
    per shard, each on its shard's device: img (Hl, W, F), mask (Hl, W)
    bool, dmaps (4, Hl, W), warm (Hl, W); means (K, F) and covars
    (K, F, F) on any device. Across processes (``owners``, the mesh's
    process of each shard) the lists hold ``None`` for the shards of other
    processes, and every process calls this at the same time.

    Returns (labels per shard (Hl, W) int32, ``None`` for another
    process's shard, stats (post (K,), obs (K, F), obs2 (K, F, F)),
    cost_vec (4,), n_valid ()), the last three summed over all the shards
    in shard order (float64, then float32) on the first (local) shard's
    device; for float64 operands, folded from all the shards' rows in row
    order (float64). ``plain`` runs the kernels' plain versions."""
    def unary(x):
        return -gaussian_logpdf_kmajor(x[None], means.to(x.device),
                                       covars.to(x.device)).contiguous()
    unary_k = _each(unary, img)
    w_cut = _each(lambda dm: weight_maps(dm[None], beta1).contiguous(), dmaps)
    mask_b = _each(lambda m: m[None], mask)
    w_ext = extend_rows(w_cut, 1, owners)
    warm_b = _each(lambda w: w[None].to(torch.int32), warm)

    mf = _mean_field_halo_kernels(unary_k, w_ext, beta, temps,
                                  iters_per_temp, damping, plain, owners)
    cand_a = _icm_halo_kernels(unary_k, w_ext, mask_b, mf, beta, max_sweeps,
                               plain, owners)
    cand_b = _icm_halo_kernels(unary_k, w_ext, mask_b, warm_b, beta,
                               max_sweeps, plain, owners)
    # K3 and K4 on the halo-extended slabs: the halo rows have mask 0, so
    # only the center pixels count
    unary_z = _each(_zero_rows, unary_k)
    mask_z = _each(lambda m: _zero_rows(m.to(torch.int32)), mask_b)
    w_z = _each(_zero_rows, w_cut)
    e = _energy_halo_pair(cand_a, cand_b, unary_z, w_z, mask_z, beta, plain,
                          owners)
    labels = cand_a if bool(e[0] <= e[1]) else cand_b

    # K4's pairwise potential at a center pixel reads the labels and the
    # backward-edge weights of the exchanged rows
    w_pp = w_cut if weighted_pp else _each(lambda dm: valid_maps(dm[None]),
                                           dmaps)
    slabs = (extend_rows(labels, 1, owners), extend_rows(w_pp, 1, owners),
             unary_z, _each(lambda x: _zero_rows(x[None].permute(0, 3, 1, 2)),
                            img), mask_z)
    x0 = first_local(img)
    if pinned(x0.dtype):
        rows = torch.cat(gather_shards(_each(
            lambda le, we, u, xz, m: finish_rows(
                u, xz, m, le, we, beta, SMALL_EPS, negate=True)[:, 1:-1],
            *slabs), owners, x0.device), dim=1)
        post, obs, obs2, sums = finish_from_rows(
            rows, first_local(unary_k).shape[1], x0.shape[-1])
    else:
        parts = _each(lambda le, we, u, xz, m: finish_stats(
            u, xz, m, le, we, beta, SMALL_EPS, negate=True, float64=True,
            plain=plain), *slabs)
        post, obs, obs2, sums = (
            psum([None if p is None else p[k] for p in parts], owners)
            .float() for k in range(4))
    cost_vec, n_valid = cost_vec_from_sums(sums)
    return (_each(lambda lab: lab[0], labels), (post[0], obs[0], obs2[0]),
            cost_vec[0], n_valid[0])


def shard_rows(mesh, x: torch.Tensor, row_axis: int = 0):
    """Split ``x`` into ``mesh.size`` equal row blocks along ``row_axis``,
    block i on shard i's device; ``None`` for a shard of another
    process."""
    n = mesh.size
    if x.shape[row_axis] % n:
        raise ValueError(f"{x.shape[row_axis]} rows do not split over "
                         f"{n} shards")
    return [c.to(d).contiguous() if mesh.is_local(i) else None
            for i, (c, d) in enumerate(zip(torch.chunk(x, n, dim=row_axis),
                                           mesh.devices))]


def gather_rows(xs, device, owners=None) -> torch.Tensor:
    """The per-shard row blocks (rows on axis 0) joined into one tensor on
    ``device``; across processes (``owners``) the blocks of the other
    processes' shards are all-gathered, so every process holds the
    whole grid."""
    return torch.cat(gather_shards(xs, owners, device))


def make_rowsharded_estep(mesh, *, weighted_pp: bool, max_sweeps: int,
                          iters_per_temp: int = 8, plain: bool = False):
    """The row-sharded E-step on global tensors: img (H, W, F), mask
    (H, W), dmaps (4, H, W), warm (H, W) with H divisible by the mesh size
    (pad rows with mask=False). Returns (labels (H, W) on the first
    (local) shard's device, summed stats, cost_vec, n_valid); across
    processes every process calls it with the same tensors and gets the
    same results."""
    owners = mesh.owners

    def run(img, mask, dmaps, warm, means, covars, beta, beta1):
        labels, stats, cost_vec, n_valid = estep_region_rowsharded(
            shard_rows(mesh, img), shard_rows(mesh, mask),
            shard_rows(mesh, dmaps, 1), shard_rows(mesh, warm), means,
            covars, beta, beta1, weighted_pp=weighted_pp,
            max_sweeps=max_sweeps, iters_per_temp=iters_per_temp,
            plain=plain, owners=owners)
        return (gather_rows(labels, mesh.first_device, owners), stats,
                cost_vec, n_valid)
    return run

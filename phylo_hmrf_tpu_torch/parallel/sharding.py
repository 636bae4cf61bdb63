"""Region-sharded E-step — counterpart of
``phylo_hmrf_tpu/parallel/sharding.py``.

Each shape bucket's region axis is padded to a multiple of the mesh size
with empty regions and dealt to the shards in contiguous blocks, as
``P("data")`` lays out the JAX bucket; every shard runs the single-device
`_estep_bucket` on its block on its own device, and the labels and
per-region statistics come back to the first shard's device in region
order. Regions share no Potts edges, so no halo is needed. The host sums
the per-region statistics in float64 in region order, as for one device,
so a region-sharded E-step gives the single-device numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_bucket_to_devices(img, mask, dmaps, n_devices: int):
    """Pad a region bucket's leading axis to a multiple of n_devices with
    empty (all-masked-out) regions. Empty regions contribute zero stats and
    their costs are ignored by the caller (n_valid == 0)."""
    R = img.shape[0]
    pad = (-R) % n_devices
    if pad == 0:
        return img, mask, dmaps, R
    img = np.concatenate(
        [img, np.zeros((pad,) + img.shape[1:], img.dtype)], axis=0)
    mask = np.concatenate(
        [mask, np.zeros((pad,) + mask.shape[1:], bool)], axis=0)
    dmaps = np.concatenate(
        [dmaps, np.full((pad,) + dmaps.shape[1:], np.inf, dmaps.dtype)],
        axis=0)
    return img, mask, dmaps, R


def shard_regions(mesh, x):
    """Split a padded bucket array (numpy or torch) along its region axis
    into ``mesh.size`` contiguous blocks, block i on shard i's device."""
    x = torch.as_tensor(x)
    return [c.to(d).contiguous()
            for c, d in zip(torch.chunk(x, mesh.size), mesh.devices)]


def device_put_bucket(mesh, img, mask, dmaps):
    """Place a padded bucket's arrays on the shards (per-shard lists)."""
    return (shard_regions(mesh, img), shard_regions(mesh, mask),
            shard_regions(mesh, dmaps))


def make_sharded_estep(mesh, *, weighted_pp: bool, max_sweeps: int,
                       labeler: str = "mf_icm", plain: bool = False):
    """The region-sharded E-step: `_estep_bucket` with ``labeler`` on every
    shard's block of regions. Takes per-shard lists img, mask, dmaps (`device_put_bucket`)
    and the padded warm labels (R_pad, H, W) on any device; returns the
    `_estep_bucket` outputs for all R_pad regions on the first shard's
    device. ``plain`` runs the kernels' plain versions."""
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket

    def run(img, mask, dmaps, warm, means, covars, beta, beta1):
        outs = []
        for x, m, dm, w in zip(img, mask, dmaps, shard_regions(mesh, warm)):
            dev = x.device
            outs.append(_estep_bucket(
                x, m, dm, w, means.to(dev), covars.to(dev), beta, beta1,
                weighted_pp=weighted_pp, max_sweeps=max_sweeps,
                labeler=labeler, plain=plain))
        dev0 = mesh.devices[0]

        def cat(ts):
            return torch.cat([t.to(dev0) for t in ts])
        labels, stats, cost_vec, n_valid = zip(*outs)
        return (cat(labels), tuple(cat(s) for s in zip(*stats)),
                cat(cost_vec), cat(n_valid))
    return run

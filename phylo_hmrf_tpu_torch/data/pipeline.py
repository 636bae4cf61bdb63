"""End-to-end data pipeline: contact files -> RegionGrids — the port's
copy of ``phylo_hmrf_tpu/data/pipeline.py``.

Host-side (numpy) redesign of the reference's multi-process loader
(``load_data_chromosome2`` and friends, utility.py:267-534): the per-pixel
Python scatter/fill loops become vectorized numpy + the C++ hole-fill kernel,
and the mp.Queue fan-out becomes an optional process pool. Output preserves
the reference's flat-sample, len_vec and .npy-cache contracts so cached
preprocessing is interchangeable (with the JAX package's too).

Both process pools use the spawn context: the caller may hold a CUDA
context, which a forked child must not inherit.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
from phylo_hmrf_tpu_torch.data.contacts import (
    align_species_contacts, normalize_feature, quantile_contact_vec,
    x_max_from_quantiles)
from phylo_hmrf_tpu_torch.data.filters import hole_fill, smooth_image
from phylo_hmrf_tpu_torch.data.regions import (
    flat_edge_list, flat_index_order, region_from_samples)
from phylo_hmrf_tpu_torch.data.synteny import (
    select_region_samples, split_regions, read_synteny_file)


def _pool(n_workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(max_workers=n_workers,
                               mp_context=mp.get_context("spawn"))


def rasterize_region(x_sel: np.ndarray, pos_sel: np.ndarray, is_diag: bool,
                     cfg: PhyloHMRFConfig):
    """Scatter selected samples into a dense image, hole-fill, denoise and
    re-flatten (reference ``write_matrix_image_Ctrl_unsym1`` for diagonal
    blocks, ``..._sym1`` for off-diagonal, utility.py:1519-1783).

    Returns (values_flat (N, F), H0, W0, start1, start2).
    """
    F = x_sel.shape[1]
    if is_diag:
        start = int(min(pos_sel[:, 0].min(), pos_sel[:, 1].min()))
        stop = int(max(pos_sel[:, 0].max(), pos_sel[:, 1].max()))
        H0 = W0 = stop - start + 1
        start1 = start2 = start
        img = np.zeros((H0, W0, F), dtype=np.float64)
        r = pos_sel[:, 0] - start
        c = pos_sel[:, 1] - start
        img[r, c] = x_sel
        img[c, r] = x_sel          # symmetric fill (utility.py:2214-2221)
    else:
        start1 = int(pos_sel[:, 0].min())
        start2 = int(pos_sel[:, 1].min())
        H0 = int(pos_sel[:, 0].max()) - start1 + 1
        W0 = int(pos_sel[:, 1].max()) - start2 + 1
        img = np.zeros((H0, W0, F), dtype=np.float64)
        img[pos_sel[:, 0] - start1, pos_sel[:, 1] - start2] = x_sel

    keep = None
    if getattr(cfg, "mask_mode", "structural") == "observed":
        keep = observed_support_mask(img, H0, W0, is_diag)

    for f in range(F):
        img[..., f] = hole_fill(img[..., f], symmetric=is_diag)
    img = smooth_image(img, cfg.filter_mode, cfg.filter_sigma,
                       cfg.filter_param1, cfg.filter_param2)

    rows, cols = flat_index_order(H0, W0, is_diag)
    values = img[rows, cols].astype(np.float32)
    if keep is not None:
        values = values[keep]
    return values, H0, W0, start1, start2, keep


def observed_support_mask(img: np.ndarray, H0: int, W0: int,
                          is_diag: bool) -> np.ndarray:
    """Observed-support sample filter (reference
    ``write_matrix_image_v1_mask``, utility.py:2231-2292): keep pixels whose
    2x2 upper-left neighborhood carries any signal; border pixels are always
    kept (the reference only zeroes interior pixels)."""
    support = img.sum(-1) > 0
    inner = np.zeros((H0, W0), dtype=bool)
    inner[1:-1, 1:-1] = True
    patch = (support
             | np.roll(support, 1, axis=0)
             | np.roll(support, 1, axis=1)
             | np.roll(np.roll(support, 1, axis=0), 1, axis=1))
    mask2d = np.where(inner, patch, True)
    rows, cols = flat_index_order(H0, W0, is_diag)
    return mask2d[rows, cols]


def _load_one_region(args):
    (x, position, pair, cfg_dict, chrom) = args
    cfg = PhyloHMRFConfig.from_dict(cfg_dict)
    pos1, pos2, pos1a, pos2a = pair[0], pair[1], pair[2], pair[3]
    region_id1 = pair[7]
    is_diag = (pos1 == pos1a) and (pos2 == pos2a)
    x_sel, idx = select_region_samples(position, x, pos1, pos2, pos1a, pos2a,
                                       cfg.resolution, border_type=0)
    pos_sel = position[idx, :2]
    values, H0, W0, start1, start2, keep = rasterize_region(
        x_sel, pos_sel, is_diag, cfg)
    return region_from_samples(
        values, H0, W0, is_diag, num_neighbor=cfg.num_neighbor,
        pad_h=cfg.pad_h, pad_w=cfg.pad_w, chrom=int(chrom),
        region_id=int(region_id1), start1=start1, start2=start2, keep=keep)


def load_chromosome(chrom, cfg: PhyloHMRFConfig, chrom_sizes_file: str,
                    paths, species, synteny_dir: str, x_max: float,
                    n_workers: int = 0, region_filter=None):
    """All RegionGrids for one chromosome (reference
    ``load_data_chromosome_sub1_2``, utility.py:335-468).

    ``region_filter`` (a collection of region_ids) keeps only those
    regions — the pod-scale region-granularity partition
    (`multiproc.partition_chromosome_regions`) loads one chromosome's
    contact list on several processes but rasterizes disjoint regions."""
    position, values = align_species_contacts(
        chrom, cfg.resolution, chrom_sizes_file, paths, species,
        cfg.legacy_bin_count)
    x, _, _, _ = normalize_feature(values, cfg.x_min, x_max)
    x = np.log(1.0 + x)        # log transform (utility.py:363)

    synteny_file = os.path.join(synteny_dir, f"chr{chrom}.synteny.txt")
    blocks = read_synteny_file(synteny_file)
    _, pairs = split_regions(blocks[:, :3], chrom, cfg.resolution,
                             cfg.centromere_splits)
    if cfg.diagonal_type == 1:
        pairs = [p for p in pairs if p[0] == p[2] and p[1] == p[3]]
    if region_filter is not None:
        keep = set(int(r) for r in region_filter)
        pairs = [p for p in pairs if int(p[7]) in keep]

    args = [(x, position, p, cfg.to_dict(), chrom) for p in pairs]
    if n_workers > 1:
        with _pool(n_workers) as pool:
            regions = list(pool.map(_load_one_region, args))
    else:
        regions = [_load_one_region(a) for a in args]
    return regions


def load_dataset(chrom_vec, cfg: PhyloHMRFConfig, chrom_sizes_file: str,
                 paths, species, synteny_dir: str, x_max: float | None = None,
                 n_workers: int = 0, region_filters=None):
    """Load all chromosomes. Returns (regions, x_max). When x_max is None it
    is computed from the quantile stats (reference `phylo_hmrf.py:1658-1664`).

    With n_workers > 1 chromosomes load in a process pool — the
    reference's parallelism unit (one mp.Process per chromosome,
    utility.py:284-298). Contact-list parsing dominates the
    per-chromosome cost, so the speedup is ~min(n_workers, n_chroms) until
    disk bandwidth saturates.
    """
    if x_max is None:
        m_vec = quantile_contact_vec(chrom_vec, cfg.resolution,
                                     chrom_sizes_file, paths, species,
                                     cfg.legacy_bin_count)
        x_max = x_max_from_quantiles(m_vec)
    def _filter(chrom):
        return None if region_filters is None else region_filters.get(
            int(chrom))

    regions = []
    if n_workers > 1 and len(chrom_vec) > 1:
        with _pool(min(n_workers, len(chrom_vec))) as pool:
            futs = [pool.submit(load_chromosome, chrom, cfg,
                                chrom_sizes_file, paths, species,
                                synteny_dir, x_max, 0, _filter(chrom))
                    for chrom in chrom_vec]
            for f in futs:
                regions.extend(f.result())
        return regions, x_max
    for chrom in chrom_vec:
        regions.extend(load_chromosome(chrom, cfg, chrom_sizes_file, paths,
                                       species, synteny_dir, x_max,
                                       n_workers, _filter(chrom)))
    return regions, x_max


# ---------------------------------------------------------------------------
# preprocessing cache (reference `phylo_hmrf.py:1676-1707` file contract)
# ---------------------------------------------------------------------------

def cache_paths(output_path: str, resolution: int, run_id: int,
                annot: str = "observed"):
    kb = resolution // 1000
    return (os.path.join(output_path, f"data.{kb}Kb.{annot}.{run_id}.npy"),
            os.path.join(output_path, f"edgelist.{kb}Kb.{annot}.{run_id}.npy"),
            os.path.join(output_path, f"lenvec.{kb}Kb.{annot}.{run_id}.txt"),
            os.path.join(output_path, f"meta.{kb}Kb.{annot}.{run_id}.npy"))


def save_cache(regions, output_path: str, cfg: PhyloHMRFConfig):
    os.makedirs(output_path, exist_ok=True)
    f_data, f_edge, f_len, f_meta = cache_paths(output_path, cfg.resolution,
                                                cfg.run_id)
    samples = np.concatenate([r.flat_values() for r in regions], axis=0)
    if getattr(cfg, "mask_mode", "structural") == "observed":
        keeps = np.empty(len(regions), dtype=object)
        for i, r in enumerate(regions):
            rows, cols = flat_index_order(r.H0, r.W0, r.is_diag)
            # vectorized membership via linear pixel serials (unique per pair)
            serials = rows.astype(np.int64) * r.W0 + cols
            have = r.flat_rows.astype(np.int64) * r.W0 + r.flat_cols
            keeps[i] = np.isin(serials, have)
        np.save(f_meta[:-4], keeps, allow_pickle=True)
    np.save(f_data[:-4], samples)
    edge_lists = np.empty(len(regions), dtype=object)
    for i, r in enumerate(regions):
        edge_lists[i] = flat_edge_list(r, cfg.num_neighbor)
    np.save(f_edge[:-4], edge_lists, allow_pickle=True)
    len_vec = []
    off = 0
    for r in regions:
        len_vec.append(r.len_vec_row(off, off + r.n_samples))
        off += r.n_samples
    np.savetxt(f_len, np.asarray(len_vec, dtype=np.int64), fmt="%d",
               delimiter="\t")
    return f_data, f_edge, f_len


def load_cache(output_path: str, cfg: PhyloHMRFConfig):
    """Rebuild RegionGrids from the cached flat samples + len_vec. Returns
    None when the cache is missing (caller recomputes, like --reload 1)."""
    f_data, f_edge, f_len, f_meta = cache_paths(output_path, cfg.resolution,
                                                cfg.run_id)
    if not (os.path.exists(f_data) and os.path.exists(f_len)):
        return None
    samples = np.load(f_data)
    len_vec = np.loadtxt(f_len, dtype=np.int64, delimiter="\t")
    if len_vec.ndim == 1:
        len_vec = len_vec.reshape(1, -1)
    keeps = None
    if os.path.exists(f_meta):
        keeps = np.load(f_meta, allow_pickle=True)
    regions = []
    for ri, row in enumerate(len_vec):
        n, start, stop, H0, W0, s1, s2, rid, type_id, chrom = row
        keep = keeps[ri] if keeps is not None else None
        regions.append(region_from_samples(
            samples[start:stop], int(H0), int(W0), bool(type_id),
            num_neighbor=cfg.num_neighbor, pad_h=cfg.pad_h, pad_w=cfg.pad_w,
            chrom=int(chrom), region_id=int(rid), start1=int(s1),
            start2=int(s2), keep=keep))
    return regions


def write_matrix_image_v1_mask(value: np.ndarray, pos: np.ndarray):
    """Full port of the reference's masked rasterizer
    (``write_matrix_image_v1_mask``, utility.py:2231-2292): per-feature 5%
    quantile flooring of positive values, symmetric scatter into a dense
    square window, and a 2x2-upper-left-neighborhood observed-support mask
    over interior upper-triangle pixels (mirrored to the lower triangle).

    Returns (mtx (ws, ws, F), start_region, value_index1, value_index2) —
    value_index1 = flat pixels with any signal, value_index2 = flat pixels
    kept by the neighborhood mask.
    """
    value = np.array(value, dtype=np.float64)
    pos = np.asarray(pos, dtype=np.int64)
    start_region = int(min(pos[:, 0].min(), pos[:, 1].min()))
    stop_region = int(max(pos[:, 0].max(), pos[:, 1].max()))
    ws = stop_region - start_region + 1
    F = value.shape[1]

    for f in range(F):
        t1 = value[:, f]
        positive = t1[t1 > 0]
        if positive.size:
            t1[t1 < np.quantile(positive, 0.05)] = 0
        value[:, f] = t1

    mtx = np.zeros((ws, ws, F))
    r = pos[:, 0] - start_region
    c = pos[:, 1] - start_region
    mtx[r, c] = value
    mtx[c, r] = value

    temp1 = mtx.sum(2)
    value_index1 = np.where(temp1.ravel() > 0)[0]
    temp1[temp1 <= 0] = 0

    # blk[i, j] = temp1[i-1:i+1, j-1:j+1].sum() for i, j >= 1
    blk = (temp1 + np.roll(temp1, 1, 0) + np.roll(temp1, 1, 1)
           + np.roll(np.roll(temp1, 1, 0), 1, 1))
    ii = np.arange(ws)[:, None]
    jj = np.arange(ws)[None, :]
    interior = (ii >= 1) & (ii <= ws - 2) & (jj > ii) & (jj <= ws - 2)
    dead = interior & (blk <= 0)
    mask = np.ones((ws, ws))
    mask[dead] = 0
    mask[dead.T] = 0
    value_index2 = np.where(mask.ravel() > 0)[0]
    return mtx, start_region, value_index1, value_index2


def load_region_with_positions(x: np.ndarray, position: np.ndarray, pair,
                               cfg: PhyloHMRFConfig, chrom):
    """Load one region and also return each flat sample's genomic bin-pair
    coordinates (reference ``load_data_chromosome_sub3_position``,
    utility.py:536-601 — the worker variant whose queue payload carries
    ``t_position``). Returns (RegionGrid, positions (N, 2) int64)."""
    region = _load_one_region((x, position, pair, cfg.to_dict(), chrom))
    positions = np.stack([
        region.start1 + region.flat_rows.astype(np.int64),
        region.start2 + region.flat_cols.astype(np.int64)], axis=1)
    return region, positions

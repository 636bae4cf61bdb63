"""Region grids — the port's own copy of ``phylo_hmrf_tpu/data/regions.py``
(``DIRS``, ``RegionGrid``, ``flat_index_order``, ``edge_distance_maps``,
``region_from_samples``, ``flat_edge_list``, ``save_edge_dump``,
``pack_regions``), numpy only.

The reference stores each synteny region as a flat sample array plus an
explicit edge list (``utility.py:1871-2053``) and runs a serial general-graph
optimizer over it. On TPU, masks beat edge lists: a region becomes a padded
dense image with

* ``img``   (H, W, F)  feature image (zeros outside the mask)
* ``mask``  (H, W)     valid sample pixels (upper triangle for diagonal
                       blocks — the reference's `type_id1 == 1`)
* ``dmaps`` (4, H, W)  raw edge *distances* per direction d in
                       DIRS = (right, down, down-right, down-left);
                       ``dmaps[d, i, j]`` is the distance on the edge from
                       pixel (i, j) to (i+di, j+dj); +inf marks a missing
                       edge so that exp(-beta1 * d) = 0 exactly.

Distances follow the reference (`utility.py:1935-1953`):
    d_e = ||x_u - x_v||^2 / (||x_u|| ||x_v|| + 1e-16),
halved when both endpoints lie on the matrix main diagonal of a diagonal
block. The model applies w_e = exp(-beta1 * d_e) (`phylo_hmrf.py:585`).

A `RegionGrid` also keeps the flat-sample view (`flat_rows`, `flat_cols`) so
outputs keep the reference's `state_vec`/`len_vec` contract
(outputfile_description.txt:8-41).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from phylo_hmrf_tpu_torch.config import SMALL_EPS

# direction order: right, down, down-right, down-left
DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))


@dataclasses.dataclass
class RegionGrid:
    """One synteny-region MRF as padded dense arrays (host numpy)."""

    img: np.ndarray          # (H, W, F) float32, padded
    mask: np.ndarray         # (H, W) bool
    dmaps: np.ndarray        # (4, H, W) float32 raw distances, +inf = no edge
    flat_rows: np.ndarray    # (N,) int32 — grid row of flat sample k
    flat_cols: np.ndarray    # (N,) int32
    is_diag: bool
    H0: int                  # unpadded dims
    W0: int
    chrom: int = -1
    region_id: int = -1
    start1: int = 0          # genomic bin offset of row 0 / col 0
    start2: int = 0

    @property
    def n_samples(self) -> int:
        return int(self.flat_rows.shape[0])

    @property
    def shape(self):
        return self.img.shape[:2]

    def flat_values(self) -> np.ndarray:
        """(N, F) sample array in the reference's flat order."""
        return self.img[self.flat_rows, self.flat_cols]

    def labels_to_flat(self, labels_grid: np.ndarray) -> np.ndarray:
        return labels_grid[self.flat_rows, self.flat_cols]

    def labels_to_grid(self, labels_flat: np.ndarray,
                       fill: int = 0) -> np.ndarray:
        out = np.full(self.shape, fill, dtype=np.int32)
        out[self.flat_rows, self.flat_cols] = labels_flat
        return out

    def len_vec_row(self, start: int, stop: int) -> list:
        """10-column len_vec row (reference outputfile_description.txt:8-41):
        [n, start, stop, H0, W0, start1, start2, region_id, type, chrom]."""
        return [self.n_samples, start, stop, self.H0, self.W0,
                self.start1, self.start2, self.region_id,
                1 if self.is_diag else 0, self.chrom]


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def flat_index_order(H0: int, W0: int, is_diag: bool):
    """Flat sample order: row-major, upper triangle (j >= i) for diagonal
    blocks, full grid otherwise (reference `write_matrix_array_v1{,a}`)."""
    if is_diag:
        rows, cols = np.triu_indices(H0, m=W0)
    else:
        rows, cols = np.indices((H0, W0)).reshape(2, -1)
    return rows.astype(np.int32), cols.astype(np.int32)


def edge_distance_maps(img: np.ndarray, mask: np.ndarray, is_diag: bool,
                       num_neighbor: int = 8) -> np.ndarray:
    """Vectorized per-direction raw edge distances (+inf where no edge)."""
    H, W, _ = img.shape
    norm = np.sqrt((img * img).sum(-1))
    ndirs = 4 if num_neighbor == 8 else 2
    dmaps = np.full((4, H, W), np.inf, dtype=np.float32)
    for d in range(ndirs):
        di, dj = DIRS[d]
        # slices of source and neighbor pixels for in-bounds edges
        src = (slice(0, H - di), slice(max(0, -dj), W - max(0, dj)))
        nb = (slice(di, H), slice(max(0, dj), W - max(0, -dj)))
        valid = mask[src] & mask[nb]
        diff = img[src] - img[nb]
        dist = (diff * diff).sum(-1) / (norm[src] * norm[nb] + SMALL_EPS)
        if is_diag and di == 1 and dj == 1:
            # edges between two main-diagonal pixels are down-weighted 2x
            # (reference `utility.py:1942-1953`)
            i_idx, j_idx = np.indices(dist.shape)
            ii = i_idx + src[0].start
            jj = j_idx + src[1].start
            dist = np.where(ii == jj, 0.5 * dist, dist)
        block = np.where(valid, dist, np.inf)
        dmaps[d][src] = block
    return dmaps


def region_from_samples(values: np.ndarray, H0: int, W0: int, is_diag: bool,
                        num_neighbor: int = 8, pad_h: int = 8,
                        pad_w: int = 128, chrom: int = -1, region_id: int = -1,
                        start1: int = 0, start2: int = 0,
                        keep: np.ndarray | None = None) -> RegionGrid:
    """Build a RegionGrid from the flat sample array (N, F).

    ``keep`` (optional bool over the structural flat order) restricts the
    sample set to a subset of pixels — the observed-support masking of the
    reference's `write_matrix_image_v1_mask` path (utility.py:2231-2292).
    """
    rows, cols = flat_index_order(H0, W0, is_diag)
    if keep is not None:
        rows, cols = rows[keep], cols[keep]
    if values.shape[0] != rows.shape[0]:
        raise ValueError(f"expected {rows.shape[0]} samples for "
                         f"{H0}x{W0} (diag={is_diag}), got {values.shape[0]}")
    F = values.shape[1]
    H, W = _pad_to(H0, pad_h), _pad_to(W0, pad_w)
    img = np.zeros((H, W, F), dtype=np.float32)
    img[rows, cols] = values
    mask = np.zeros((H, W), dtype=bool)
    mask[rows, cols] = True
    dmaps = edge_distance_maps(img, mask, is_diag, num_neighbor)
    return RegionGrid(img=img, mask=mask, dmaps=dmaps, flat_rows=rows,
                      flat_cols=cols, is_diag=is_diag, H0=H0, W0=W0,
                      chrom=chrom, region_id=region_id,
                      start1=start1, start2=start2)


def flat_edge_list(region: RegionGrid, num_neighbor: int = 8) -> np.ndarray:
    """Reference-format flat edge list (E, 3): [id1, id2, raw_distance] with
    flat sample ids, sorted by (id1, id2) (`utility.py:1959-1960`).

    Used for the .npy cache contract and for parity tests between the grid
    and edge-list representations.
    """
    H, W = region.shape
    flat_id = np.full((H, W), -1, dtype=np.int64)
    flat_id[region.flat_rows, region.flat_cols] = np.arange(
        region.n_samples, dtype=np.int64)
    ndirs = 4 if num_neighbor == 8 else 2
    out = []
    for d in range(ndirs):
        di, dj = DIRS[d]
        src = (slice(0, H - di), slice(max(0, -dj), W - max(0, dj)))
        dm = region.dmaps[d][src]
        valid = np.isfinite(dm)
        ii, jj = np.nonzero(valid)
        ii = ii + (src[0].start or 0)
        jj = jj + (src[1].start or 0)
        id1 = flat_id[ii, jj]
        id2 = flat_id[ii + di, jj + dj]
        w = dm[valid]
        out.append(np.stack([id1.astype(np.float64),
                             id2.astype(np.float64), w], axis=1))
    edges = np.concatenate(out, axis=0)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    return edges[order]


def save_edge_dump(region: RegionGrid, path: str, beta1: float | None = None,
                   num_neighbor: int = 8) -> None:
    """Write the reference-format edge-list debug dump
    (`edge_weightList_undirected.txt`, reference phylo_hmrf.py:631-636 /
    utility.py:1964-1971): tab-separated id1, id2, weight rows. With beta1
    given, weights are exp(-beta1 * d); otherwise raw distances."""
    edges = flat_edge_list(region, num_neighbor)
    w = np.exp(-beta1 * edges[:, 2]) if beta1 is not None else edges[:, 2]
    out = np.column_stack([edges[:, 0].astype(np.int64),
                           edges[:, 1].astype(np.int64), w])
    np.savetxt(path, out, fmt=["%d", "%d", "%.6f"], delimiter="\t")


def pack_regions(regions: list, pad_h: int = 8, pad_w: int = 128):
    """Bucket regions by padded shape and stack each bucket along a leading
    axis for vmapped/sharded E-steps. Returns
    ``{(H, W): (indices, img (R,H,W,F), mask (R,H,W), dmaps (R,4,H,W))}``."""
    buckets = {}
    for idx, r in enumerate(regions):
        buckets.setdefault(r.shape, []).append(idx)
    out = {}
    for shape, idxs in buckets.items():
        img = np.stack([regions[i].img for i in idxs])
        mask = np.stack([regions[i].mask for i in idxs])
        dmaps = np.stack([regions[i].dmaps for i in idxs])
        out[shape] = (np.asarray(idxs), img, mask, dmaps)
    return out

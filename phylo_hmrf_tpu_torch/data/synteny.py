"""Synteny-region decomposition.

Parity with reference ``subregion1`` (utility.py:2111-2189): reads a synteny
file of rows [start, stop, length], optionally splits blocks spanning a
configured centromere (the reference hard-codes hg38 chr3/chr6 positions at
utility.py:385; here they come from PhyloHMRFConfig.centromere_splits), and
emits every diagonal and off-diagonal sub-block combination as 9-column rows
[pos1, pos2, pos1a, pos2a, len, len1, region_id, region_id1, chrom].
"""

from __future__ import annotations

import numpy as np


def read_synteny_file(path: str) -> np.ndarray:
    arr = np.loadtxt(path, dtype=np.int64, delimiter="\t")
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr


def split_regions(blocks: np.ndarray, chrom, resolution: int,
                  centromere_splits: dict | None = None):
    """Apply centromere splits and enumerate block pairs.

    blocks: (n, 3) [start, stop, length]. Returns (region_list, region_pairs)
    where region_list is the (possibly split) block list rows
    [start, stop, length, region_id] and region_pairs is the 9-column list
    described in the module docstring.
    """
    region_list = [np.asarray([b[0], b[1], b[2], i], dtype=np.int64)
                   for i, b in enumerate(blocks)]

    threshold = resolution * 2
    chrom_int = int(chrom) if str(chrom).isdigit() else None
    points = []
    if centromere_splits and chrom_int is not None:
        if chrom_int in centromere_splits:
            points.append(centromere_splits[chrom_int])

    for point1, point2 in points:
        vec1 = np.asarray(region_list)
        hit = (vec1[:, 0] < point1 - threshold) & (vec1[:, 1] > point2 + threshold)
        b = np.where(hit)[0]
        if len(b) > 0:
            id1 = int(b[0])
            region_id = int(vec1[id1, 3])
            start1, stop1 = int(vec1[id1, 0]), int(point1)
            start2, stop2 = int(point2), int(vec1[id1, 1])
            region_list[id1] = np.asarray(
                [start2, stop2, stop2 - start2, region_id], dtype=np.int64)
            region_list.insert(id1, np.asarray(
                [start1, stop1, stop1 - start1, region_id], dtype=np.int64))

    arr = np.asarray(region_list)
    region_ids = np.sort(np.unique(arr[:, 3]))
    pairs = []
    region_id1 = 0
    chrom_val = chrom_int if chrom_int is not None else -1
    for rid in region_ids:
        b = np.where(arr[:, 3] == rid)[0]
        if len(b) == 1:
            p1, p2, length = arr[b[0], 0], arr[b[0], 1], arr[b[0], 2]
            pairs.append([p1, p2, p1, p2, length, length, rid, region_id1,
                          chrom_val])
            region_id1 += 1
        else:
            for i in range(len(b)):
                for j in range(i, len(b)):
                    r1, r2 = arr[b[i]], arr[b[j]]
                    pairs.append([r1[0], r1[1], r2[0], r2[1], r1[2], r2[2],
                                  rid, region_id1, chrom_val])
                    region_id1 += 1
    return region_list, pairs


def subregion1(path: str, chrom, resolution: int,
               centromere_splits: dict | None = None):
    """File-based entry point mirroring the reference signature."""
    return split_regions(read_synteny_file(path)[:, :3], chrom, resolution,
                         centromere_splits)


def select_region_samples(position: np.ndarray, x: np.ndarray,
                          pos1: int, pos2: int, pos1a: int, pos2a: int,
                          resolution: int, border_type: int = 0):
    """Select samples inside a genomic window (reference
    ``select_valuesPosition1_2``, utility.py:1331-1364)."""
    x1 = position[:, 0] * resolution
    x2 = (position[:, 1] + 1) * resolution
    if border_type == 0:
        b = (x1 >= pos1) & (x1 <= pos2) & (x2 >= pos1a) & (x2 <= pos2a)
    elif border_type == 1:
        b = (x1 >= pos1) & (x2 <= pos2)
    else:
        x2 = position[:, 1] * resolution
        b = (x1 >= pos1) & (x1 < pos2) & (x2 >= pos1a) & (x2 < pos2a)
    idx = np.where(b)[0]
    return x[idx], idx

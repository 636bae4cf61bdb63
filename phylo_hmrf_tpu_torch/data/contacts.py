"""Cross-species Hi-C contact alignment and quantile normalization stats
— the port's copy of ``phylo_hmrf_tpu/data/contacts.py``.

Behavioral parity with reference ``utility.py:2463-2662``
(``multi_contact_matrix3A``, ``quantile_contact_vec``,
``output_multi_contactMtx``), vectorized with numpy (the reference's
pandas/mapping_Idx joins become sorted-serial searchsorted joins).

The one change: ``load_contact_list`` parses the 3-column file with numpy
and Python's correctly rounded ``float``, where the JAX package calls
``pandas.read_table``. Both give the same float64 values for the decimal
strings the repo's writers produce (``%.4f``, ``%.6g``); pandas' own fast
parser can differ by a few ulps on 17-digit strings, which this reader
does not emulate.
"""

from __future__ import annotations

import os

import numpy as np


def read_chrom_sizes(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def bin_count(chrom_size: int, resolution: int,
              legacy: bool = True) -> int:
    """Number of bins N used for the serial encoding serial = N*x1 + x2.

    legacy=True reproduces the reference exactly: Python-2
    ``math.ceil(chrom_size/resolution)`` floor-divides first
    (`utility.py:2516`), so N = chrom_size // resolution unless divisible.
    """
    if legacy:
        return chrom_size // resolution
    return -(-chrom_size // resolution)


# the tokens pandas.read_table reads as NaN by default
_NA_TOKENS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def load_contact_list(path: str):
    """Read a 3-column contact file: start1 <tab> start2 <tab> value (bp).

    Columns 0-1 come back as int64 and column 2 as float64, with an empty
    or NA field as NaN, as ``pandas.read_table(path, header=None)`` gives
    them. ``np.loadtxt`` reads the usual all-numeric file; a file with
    empty or NA fields goes through the token-by-token reader."""
    try:
        data = np.loadtxt(path, delimiter="\t", dtype=np.float64, ndmin=2,
                          comments=None)
    except ValueError:
        return _load_contact_tokens(path)
    if data.shape[1] != 3:
        raise ValueError(f"{path}: {data.shape[1]} columns, expected 3")
    # bp coordinates are integers far below 2**53: exact through float64
    return (data[:, 0].astype(np.int64), data[:, 1].astype(np.int64),
            np.ascontiguousarray(data[:, 2]))


def _load_contact_tokens(path: str):
    """`load_contact_list` field by field, for files with empty or NA
    fields; blank lines are skipped."""
    with open(path) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines() if ln.strip()]
    for i, r in enumerate(rows):
        if len(r) != 3:
            raise ValueError(f"{path}: line {i + 1} does not have 3 "
                             f"tab-separated fields")
    if not rows:
        raise ValueError(f"{path}: no contact rows")
    c0, c1, c2 = zip(*rows)
    x1, x2 = (np.asarray(c, dtype=np.float64).astype(np.int64)
              for c in (c0, c1))
    value = np.fromiter(
        (np.nan if t.strip() in _NA_TOKENS else float(t) for t in c2),
        np.float64, count=len(c2))
    return x1, x2, value


def align_species_contacts(chrom, resolution: int, chrom_sizes_file: str,
                           paths, species, legacy: bool = True):
    """Union-align per-species contact lists for one chromosome.

    Returns (position (n, 3) int64 [bin1, bin2, serial], values (n, S)):
    the union of observed bin pairs across species, zero-filled where a
    species lacks the pair, NaN -> -1 (reference `utility.py:2546-2547`,
    union at :2555, assembly at :2631-2662).
    """
    sizes = read_chrom_sizes(chrom_sizes_file)
    key = f"chr{chrom}"
    if key not in sizes:
        raise ValueError(f"{key} not in {chrom_sizes_file}")
    N = bin_count(sizes[key], resolution, legacy)

    per_species = []
    union = None
    for sp_path in paths:
        fname = os.path.join(sp_path,
                             f"chr{chrom}.{resolution // 1000}K.txt")
        if not os.path.exists(fname):
            raise FileNotFoundError(fname)
        x1, x2, value = load_contact_list(fname)
        b1, b2 = x1 // resolution, x2 // resolution
        serial = N * b1 + b2
        value = value.copy()
        value[np.isnan(value)] = -1
        per_species.append((serial, b1, b2, value))
        union = serial if union is None else np.union1d(union, serial)

    union = np.sort(np.unique(union))
    n = union.shape[0]
    values = np.zeros((n, len(species)), dtype=np.float64)
    position = np.zeros((n, 3), dtype=np.int64)
    position[:, 2] = union
    for i, (serial, b1, b2, value) in enumerate(per_species):
        idx = np.searchsorted(union, serial)
        values[idx, i] = value
        position[idx, 0] = b1
        position[idx, 1] = b2
    return position, values


def quantile_contact(chrom, resolution: int, chrom_sizes_file: str,
                     paths, species, legacy: bool = True) -> np.ndarray:
    """Per-species contact-value stats for one chromosome: 10 columns
    [p5, p25, p50, p75, p95, min>0, max, max/p95, n>0, n>=0]
    (reference `quantile_contact`, utility.py:2475-2505)."""
    eps = 1e-16
    S = len(species)
    m_vec = np.zeros((S, 10))
    for i, sp_path in enumerate(paths):
        fname = os.path.join(sp_path,
                             f"chr{chrom}.{resolution // 1000}K.txt")
        _, _, value = load_contact_list(fname)
        value = value.copy()
        value[np.isnan(value)] = -1
        pos = value[value > 0]
        nonneg = value[value >= 0]
        m_vec[i, 0:5] = np.percentile(nonneg, [5, 25, 50, 75, 95])
        m_vec[i, 5] = pos.min() if pos.size else 0.0
        m_vec[i, 6] = value.max()
        m_vec[i, 7] = value.max() / (m_vec[i, 4] + eps)
        m_vec[i, 8], m_vec[i, 9] = pos.size, nonneg.size
    return m_vec


def quantile_contact_vec(chrom_vec, resolution, chrom_sizes_file, paths,
                         species, legacy: bool = True) -> np.ndarray:
    """Stacked per-chromosome stats (reference `quantile_contact_vec`).
    An empty chrom_vec yields a (0, 10) array — pod-scale partitions can
    leave a process with no chromosomes, and its allgather rows must keep
    the trailing dim."""
    rows = [quantile_contact(c, resolution, chrom_sizes_file, paths, species,
                             legacy)
            for c in chrom_vec]
    if not rows:
        return np.zeros((0, 10))
    return np.concatenate(rows, axis=0)


def x_max_from_quantiles(m_vec_list: np.ndarray) -> float:
    """x_max = median of the per species-chromosome maxima (column 6 —
    reference `phylo_hmrf.py:1662-1663`)."""
    return float(np.median(m_vec_list[:, 6]))


def normalize_feature1(x: np.ndarray, x_min: float, x_max: float):
    """Plain min-max rescale without negative clamping (reference
    `normalize_feature1`, utility.py:956-968)."""
    x = np.asarray(x, dtype=np.float64).copy()
    mins = x.min(axis=0)
    maxs = x.max(axis=0)
    x = x_min + (x - mins) * (x_max - x_min) / (maxs - mins)
    return x, np.stack([mins, maxs], axis=1)


def normalize_feature2(position: np.ndarray, x: np.ndarray, x_min: float,
                       x_max: float, norm_type: int = 0):
    """Outlier-clamped variant (reference `normalize_feature2`,
    utility.py:899-953): per species, values above a quantile of the positive
    *diagonal* (x1 == x2) contacts are clamped before min-max rescaling.
    norm_type 0: 99.7th pct; 1: 95.45th pct; 2: Tukey fence Q3+1.5 IQR;
    else: no clamp."""
    x = np.asarray(x, dtype=np.float64).copy()
    x[x < 0] = 0
    mins = x.min(axis=0)
    maxs = x.max(axis=0)
    vec1 = np.stack([mins, maxs], axis=1)
    if x_min < 0:
        x_min = float(np.median(mins))
    if x_max < 0:
        x_max = float(np.median(maxs))
    diag_rows = position[:, 0] == position[:, 1]
    for i in range(x.shape[1]):
        col = x[:, i]
        diag_pos = col[diag_rows]
        diag_pos = diag_pos[diag_pos > 0]
        if diag_pos.size == 0:
            limit = col.max()
        elif norm_type == 0:
            limit = np.quantile(diag_pos, 0.997)
        elif norm_type == 1:
            limit = np.quantile(diag_pos, 0.9545)
        elif norm_type == 2:
            q1, q3 = np.quantile(diag_pos, [0.25, 0.75])
            limit = q3 + 1.5 * (q3 - q1)
        else:
            limit = col.max()
        col = np.minimum(col, limit)
        x[:, i] = x_min + (col - mins[i]) * (x_max - x_min) / (
            limit - mins[i])
    return x, vec1, x_min, x_max


def normalize_feature(x: np.ndarray, x_min: float, x_max: float):
    """Per-species min-max rescale to [x_min, x_max] after clamping negatives
    to zero (reference `normalize_feature`, utility.py:867-897). Returns
    (x_scaled, per-col (min, max), x_min, x_max); x_min/x_max < 0 fall back
    to the medians of the per-column extremes."""
    x = np.asarray(x, dtype=np.float64).copy()
    x[x < 0] = 0
    mins = x.min(axis=0)
    maxs = x.max(axis=0)
    vec1 = np.stack([mins, maxs], axis=1)
    if x_min < 0:
        x_min = float(np.median(mins))
    if x_max < 0:
        x_max = float(np.median(maxs))
    scale = (x_max - x_min) / (maxs - mins)
    x = x_min + (x - mins) * scale
    return x, vec1, x_min, x_max

"""Post-processing: state-map smoothing and export.

Python port of the reference's MATLAB pipeline (processing/*.m, documented in
outputfile_description.txt:52-102):

* ``states_to_grid``      — per-region state matrices from the flat state_vec
                            (``read_state_test.m`` / ``index_sym1.m``)
* ``smooth_states``       — small-connected-component removal: components of a
                            state with area <= threshold are reassigned to the
                            predominant neighboring state when it covers >50%
                            of the 5x5 neighborhoods (``small_region_test.m``,
                            ``query_neighbor_state_test.m``)
* ``smooth_state_vec``    — apply over all regions of a chromosome and write
                            back into the flat vector (``read_state_test.m``)
* ``write_state_files``   — per-bin-pair text export
                            (``write_stateToFile_test.m``)
* ``states_to_rgb``       — RGB maps (``color_map2.m`` / ``write_toRGB``)

The port's copy of ``phylo_hmrf_tpu/postprocess/smooth.py``: numpy and
``scipy.ndimage``, as there, except ``save_state_image``, which writes a
PNG with ``zlib`` in place of a matplotlib figure (``read_state_image``
reads it back).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import scipy.ndimage

_STRUCT8 = np.ones((3, 3), dtype=bool)   # MATLAB bwconncomp 2D default
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def states_to_grid(state_flat: np.ndarray, H0: int, W0: int,
                   is_diag: bool) -> np.ndarray:
    """Dense per-region state matrix; diagonal regions are mirrored."""
    if is_diag:
        out = np.zeros((H0, W0), dtype=np.int64)
        rows, cols = np.triu_indices(H0, m=W0)
        out[rows, cols] = state_flat
        out[cols, rows] = state_flat
    else:
        out = np.asarray(state_flat, dtype=np.int64).reshape(H0, W0)
    return out


def grid_to_states(grid: np.ndarray, is_diag: bool) -> np.ndarray:
    if is_diag:
        rows, cols = np.triu_indices(grid.shape[0], m=grid.shape[1])
        return grid[rows, cols]
    return grid.ravel()


def _neighbor_state(grid, pixels, state_id, half: int,
                    ratio_threshold: float):
    """Predominant non-`state_id` value in the 5x5 windows around the
    component pixels (query_neighbor_state_test.m)."""
    H, W = grid.shape
    collected = []
    for i, j in zip(*pixels):
        if i - half < 0 or i + half >= H or j - half < 0 or j + half >= W:
            continue
        win = grid[i - half:i + half + 1, j - half:j + half + 1].ravel()
        collected.append(win[win != state_id])
    if not collected:
        return -1
    vals = np.concatenate(collected)
    if vals.size == 0:
        return -1
    counts = np.bincount(vals)
    mode = int(counts.argmax())
    if counts[mode] > vals.size * ratio_threshold:
        return mode
    return -1


def smooth_states(grid: np.ndarray, n_components: int,
                  threshold: int | None = None, window: int = 5,
                  n_iter: int = 1,
                  ratio_threshold: float = 0.5) -> np.ndarray:
    """Small-region removal over a dense state matrix."""
    grid = np.asarray(grid, dtype=np.int64).copy()
    if threshold is None:
        # read_state_test.m: 80, or 25 for windows under 100 bins
        threshold = 80 if grid.shape[0] >= 100 else 25
    half = (window - 1) // 2
    for _ in range(n_iter):
        out = grid.copy()
        for state_id in range(n_components):
            mask = grid == state_id
            lab, n_obj = scipy.ndimage.label(mask, structure=_STRUCT8)
            if n_obj == 0:
                continue
            areas = np.bincount(lab.ravel())[1:]
            for obj in np.where(areas <= threshold)[0] + 1:
                pixels = np.where(lab == obj)
                t = _neighbor_state(grid, pixels, state_id, half,
                                    ratio_threshold)
                if t != -1:
                    out[pixels] = t
        grid = out
    return grid


def smooth_state_vec(state_vec: np.ndarray, len_vec: np.ndarray,
                     n_components: int, **kw) -> np.ndarray:
    """Apply `smooth_states` region by region on the flat state vector.
    len_vec rows: [n, start, stop, H0, W0, s1, s2, rid, type, chrom]."""
    out = np.asarray(state_vec, dtype=np.int64).copy()
    for row in np.asarray(len_vec, dtype=np.int64):
        n, start, stop, H0, W0 = row[0], row[1], row[2], row[3], row[4]
        is_diag = bool(row[8])
        grid = states_to_grid(out[start:stop], int(H0), int(W0), is_diag)
        grid = smooth_states(grid, n_components, **kw)
        out[start:stop] = grid_to_states(grid, is_diag)
    return out


def write_state_files(state_vec: np.ndarray, len_vec: np.ndarray, chrom: int,
                      bin_size: int, output_path: str,
                      annotation: str = "ori") -> str:
    """Per-bin-pair text export (write_stateToFile_test.m): rows
    [chrom, start1, stop1, chrom, start2, stop2, state]; for diagonal regions
    only the upper triangle is written. Also dumps each region's dense state
    matrix."""
    os.makedirs(output_path, exist_ok=True)
    fname = os.path.join(output_path,
                         f"estimate_test{chrom}.{annotation}.txt")
    len_vec = np.asarray(len_vec, dtype=np.int64)
    rows_out = []
    for ridx, row in enumerate(len_vec):
        if int(row[9]) != int(chrom):
            continue
        n, start, stop, H0, W0, s1, s2 = (int(row[0]), int(row[1]),
                                          int(row[2]), int(row[3]),
                                          int(row[4]), int(row[5]),
                                          int(row[6]))
        is_diag = bool(row[8])
        grid = states_to_grid(state_vec[start:stop], H0, W0, is_diag)
        np.savetxt(os.path.join(
            output_path, f"estimate_test{chrom}.{ridx}.{annotation}.txt"),
            grid, fmt="%d", delimiter="\t")
        ii, jj = np.indices((H0, W0))
        if is_diag:
            keep = jj >= ii
            ii, jj = ii[keep], jj[keep]
            states = grid[ii, jj]
        else:
            states = grid.ravel()
            ii, jj = ii.ravel(), jj.ravel()
        p1 = (ii + s1) * bin_size
        p2 = (jj + s2) * bin_size
        block = np.stack([np.full_like(p1, chrom), p1, p1 + bin_size,
                          np.full_like(p2, chrom), p2, p2 + bin_size,
                          states], axis=1)
        rows_out.append(block)
    if rows_out:
        np.savetxt(fname, np.concatenate(rows_out), fmt="%d", delimiter="\t")
    return fname


def default_palette(n: int) -> np.ndarray:
    """Deterministic (K, 3) uint8 palette (evenly spaced hues)."""
    import colorsys
    cols = [colorsys.hsv_to_rgb(i / n, 0.65 + 0.3 * (i % 2), 0.9)
            for i in range(n)]
    return (np.asarray(cols) * 255).astype(np.uint8)


def states_to_rgb(grid: np.ndarray, palette: np.ndarray | None = None,
                  n_components: int | None = None) -> np.ndarray:
    """(H, W) states -> (H, W, 3) uint8 image."""
    grid = np.asarray(grid, dtype=np.int64)
    if n_components is None:
        n_components = int(grid.max()) + 1
    if palette is None:
        palette = default_palette(n_components)
    return palette[np.clip(grid, 0, palette.shape[0] - 1)]


def load_color_vec(path: str) -> np.ndarray:
    """Load a reference-format color table (3 tab-separated ints/line)."""
    return np.loadtxt(path, dtype=np.int64, delimiter="\t").astype(np.uint8)


def save_state_image(grid: np.ndarray, path: str,
                     palette: np.ndarray | None = None,
                     n_components: int | None = None,
                     title: str | None = None) -> None:
    """Save a state map as an image file (the reference renders JPGs from
    MATLAB, color_map_sub.m / imshow).

    The port writes the `states_to_rgb` array itself as an 8-bit RGB PNG,
    one pixel a bin pair, with ``zlib`` alone, and ``title`` in a
    ``tEXt`` chunk (keyword ``Title``): the GPU machine has no matplotlib.
    The pixels are what users read; the axes and margins of the JAX
    package's matplotlib figure are not drawn. `read_state_image` reads
    the file back."""
    img = np.ascontiguousarray(states_to_rgb(grid, palette, n_components),
                               dtype=np.uint8)
    h, w = img.shape[:2]
    # filter type 0 (none) before every scanline
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    if title:
        chunks.append((b"tEXt", b"Title\x00"
                       + title.encode("latin-1", errors="replace")))
    chunks += [(b"IDAT", zlib.compress(raw, 9)), (b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        for tag, data in chunks:
            f.write(struct.pack(">I", len(data)) + tag + data
                    + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def read_state_image(path: str):
    """(rgb (H, W, 3) uint8, title or None) of a PNG `save_state_image`
    wrote (8-bit RGB, unfiltered scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    at, idat, title, shape = 8, [], None, None
    while at < len(data):
        n, tag = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        at += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not an 8-bit RGB PNG")
            shape = (h, w)
        elif tag == b"tEXt" and body.startswith(b"Title\x00"):
            title = body[6:].decode("latin-1")
        elif tag == b"IDAT":
            idat.append(body)
    h, w = shape
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not read here")
    return rows[:, 1:].reshape(h, w, 3).copy(), title


# ---------------------------------------------------------------------------
# symmetric-index helpers (reference utility.py:701-758)
# ---------------------------------------------------------------------------

def symmetric_idx(dim1: int, dim2: int) -> np.ndarray:
    """Flat (raveled) indices of the upper triangle (row <= col) of a
    dim1 x dim2 grid (reference ``symmetric_idx``, utility.py:729-742)."""
    row_id = np.repeat(np.arange(dim1), dim2)
    col_id = np.tile(np.arange(dim2), dim1)
    return np.where(row_id <= col_id)[0]


def symmetric_idx1(dim1: int, dim2: int):
    """Upper (row <= col) and lower (row >= col) flat index sets
    (reference ``symmetric_idx1``, utility.py:744-758)."""
    row_id = np.repeat(np.arange(dim1), dim2)
    col_id = np.tile(np.arange(dim2), dim1)
    return (np.where(row_id <= col_id)[0], np.where(row_id >= col_id)[0])


def symmetric_state(state: np.ndarray) -> np.ndarray:
    """Mirror the upper triangle onto the lower triangle in place
    (reference ``symmetric_state``, utility.py:701-709)."""
    iu = np.triu_indices(state.shape[0], k=1, m=state.shape[1])
    state[iu[1], iu[0]] = state[iu]
    return state


def symmetric_state1(state_flat: np.ndarray, window_size: int) -> np.ndarray:
    """Scatter a flat upper-triangle state vector into a dense
    (window_size, window_size) matrix and symmetrize (reference
    ``symmetric_state1``, utility.py:711-719)."""
    out = np.zeros((window_size, window_size))
    out.ravel()[symmetric_idx(window_size, window_size)] = state_flat
    return symmetric_state(out)


def symmetric_state1_vec(state_vec_list, len_vec) -> list:
    """Densify+symmetrize every diagonal region's flat states (reference
    ``symmetric_state1_vec``, utility.py:721-727 — which drops the
    window-size argument; the intended per-region window from len_vec
    column 3 is used here). Returns the concatenated raveled rows."""
    len_vec = np.asarray(len_vec)
    out = []
    for i in range(len_vec.shape[0]):
        out.extend(symmetric_state1(state_vec_list[i], int(len_vec[i, 3])))
    return out

"""Image denoising for rasterized Hi-C regions — the port's copy of
``phylo_hmrf_tpu/data/filters.py``.

Reimplements the three filters the reference selects by ``filter_mode``
(reference utility.py:1566-1588):

* mode 0 — Perona-Malik anisotropic diffusion with medpy's update scheme
  (``medpy.filter.smoothing.anisotropic_diffusion`` semantics, including its
  zero-flux first-row boundary quirk);
* mode 1 — bilateral filter (skimage ``denoise_bilateral``-style Gaussian
  spatial x Gaussian range kernel; a faithful approximation, not bit-exact);
* else  — Gaussian blur (scipy.ndimage, identical to the reference).

Plus the sequential median hole-fill (reference ``near_interpolation1{,a}``)
in C++ (``native/gridops.cc``). Where the JAX package falls back to the
numpy loop when the C++ call fails, this copy raises (`NativeBuildError`
for a failed build); ``_hole_fill_python`` stays as the plain version the
tests hold the C++ fill to.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage

from phylo_hmrf_tpu_torch import native
from phylo_hmrf_tpu_torch.config import THRESH1


# ---------------------------------------------------------------------------
# hole fill
# ---------------------------------------------------------------------------

def _hole_fill_python(mtx: np.ndarray, symmetric: bool,
                      threshold: float,
                      include_center: bool = False) -> np.ndarray:
    """The plain sequential fill (reference utility.py:603-685)."""
    n1, n2 = mtx.shape
    out = mtx
    for i in range(2, n1 - 1):
        js = i if symmetric else 2
        for j in range(js, n2 - 1):
            if out[i, j] < threshold:
                window = out[i - 1:i + 2, j - 1:j + 2].ravel()
                nb = window if include_center else np.delete(window, 4)
                m = np.median(nb)
                if m > threshold:
                    out[i, j] = m
                    if symmetric:
                        out[j, i] = m
    return out


def hole_fill(mtx: np.ndarray, symmetric: bool,
              threshold: float = THRESH1,
              include_center: bool = False) -> np.ndarray:
    """In-place sequential median hole-fill of one channel (float64 copy).

    ``include_center`` selects the reference's ``near_interpolation2``
    variant (utility.py:663-685): the median is taken over the full 3x3
    window including the below-threshold center (symmetric scan only).
    """
    if include_center and not symmetric:
        raise ValueError("include_center requires the symmetric variant "
                         "(reference near_interpolation2)")
    out = np.ascontiguousarray(mtx, dtype=np.float64)
    if out is mtx:
        out = out.copy()
    native.hole_fill(out, "sym2" if include_center
                     else "sym" if symmetric else "rect", threshold)
    hole_fill.calls += 1
    return out


hole_fill.calls = 0   # C++ fills run, for the smoke run's route check


# ---------------------------------------------------------------------------
# anisotropic diffusion (medpy semantics)
# ---------------------------------------------------------------------------

def anisotropic_diffusion(img: np.ndarray, niter: int = 10,
                          kappa: float = 50.0, gamma: float = 0.1,
                          option: int = 1) -> np.ndarray:
    """Perona-Malik diffusion with medpy's flux-difference update:

    per iteration, per axis a: delta_a = forward diff (last slice zero);
    flux_a = g(delta_a) * delta_a with g = exp(-(d/kappa)^2) (option 1) or
    1/(1+(d/kappa)^2) (option 2); then flux differences are accumulated,
    keeping the *raw* flux at index 0 along each axis (medpy's zero-ghost
    boundary), and out += gamma * sum_a dflux_a.
    """
    out = np.asarray(img, dtype=np.float64).copy()
    for _ in range(niter):
        total = np.zeros_like(out)
        for axis in range(out.ndim):
            delta = np.zeros_like(out)
            sl_head = [slice(None)] * out.ndim
            sl_head[axis] = slice(None, -1)
            delta[tuple(sl_head)] = np.diff(out, axis=axis)
            if option == 1:
                flux = np.exp(-(delta / kappa) ** 2.0) * delta
            else:
                flux = delta / (1.0 + (delta / kappa) ** 2.0)
            mat = flux.copy()
            sl_tail = [slice(None)] * out.ndim
            sl_tail[axis] = slice(1, None)
            mat[tuple(sl_tail)] = np.diff(flux, axis=axis)
            total += mat
        out += gamma * total
    return out


# ---------------------------------------------------------------------------
# bilateral filter
# ---------------------------------------------------------------------------

def bilateral_filter(img: np.ndarray, sigma_color: float = 0.5,
                     sigma_spatial: float = 5.0,
                     win_size: int | None = None) -> np.ndarray:
    """Gaussian bilateral filter, skimage-style window sizing
    (win_size = 2 * ceil(3 * sigma_spatial) + 1)."""
    img = np.asarray(img, dtype=np.float64)
    if win_size is None:
        win_size = int(max(5, 2 * np.ceil(3 * sigma_spatial) + 1))
    r = win_size // 2
    H, W = img.shape
    padded = np.pad(img, r, mode="edge")
    num = np.zeros_like(img)
    den = np.zeros_like(img)
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    inv2sc = 1.0 / (2.0 * sigma_color ** 2)
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            sw = np.exp(-(di * di + dj * dj) * inv2ss)
            shifted = padded[r + di:r + di + H, r + dj:r + dj + W]
            cw = np.exp(-((shifted - img) ** 2) * inv2sc)
            w = sw * cw
            num += w * shifted
            den += w
    return num / den


# ---------------------------------------------------------------------------
# dispatcher (reference utility.py:1566-1588)
# ---------------------------------------------------------------------------

def smooth_image(mtx: np.ndarray, filter_mode: int, sigma: float,
                 filter_param1: float, filter_param2: float) -> np.ndarray:
    """Apply the configured filter per feature channel of (H, W, F)."""
    out = np.asarray(mtx, dtype=np.float64).copy()
    for f in range(out.shape[-1]):
        ch = out[..., f]
        if filter_mode == 0:
            niter = 10 if filter_param1 < 0 else int(filter_param1)
            kappa = 50.0 if filter_param1 < 0 else float(filter_param2)
            out[..., f] = anisotropic_diffusion(ch, niter=niter, kappa=kappa,
                                                gamma=0.1, option=1)
        elif filter_mode == 1:
            sc = 0.5 if filter_param1 < 0 else float(filter_param1)
            ss = 5.0 if filter_param1 < 0 else float(filter_param2)
            out[..., f] = bilateral_filter(ch, sigma_color=sc,
                                           sigma_spatial=ss)
        else:
            if sigma > 0:
                out[..., f] = scipy.ndimage.gaussian_filter(ch, sigma)
    return out

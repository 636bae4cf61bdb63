"""Batched multivariate-Gaussian log-density via Cholesky — the E-step unary.

Counterpart of ``phylo_hmrf_tpu/models/emission.py``:

    logpdf(x; mu_k, V_k) = -0.5 (F log 2pi + log det V_k + ||L_k^{-1}(x-mu_k)||^2)

The quadratic form is a matmul against the inverse Cholesky factor. It
runs in full float32: the package turns TF32 off at import, because the
quadratic form feeds exp() downstream and reduced-precision inputs visibly
distort the posteriors. In float64 (the strict-parity mode) the K-major
form is computed pixel by pixel in a fixed order instead of a matmul,
whose reduction order a library may pick from the batch size: a pixel's
unary is then bitwise the same in any region batch or row shard.
"""

from __future__ import annotations

import torch

_LOG_2PI = 1.8378770664093453


def _chol_inv_and_logdet(covars: torch.Tensor):
    """covars (K, F, F) -> (Linv (K, F, F) lower-triangular, logdet (K,)).
    A factor that fails gives NaNs, as ``jnp.linalg.cholesky`` does; its
    error check is not read, so the E-step queues on the card without a
    host synchronization."""
    chol, _ = torch.linalg.cholesky_ex(covars, check_errors=False)
    K, F = covars.shape[0], covars.shape[-1]
    eye = torch.eye(F, dtype=covars.dtype, device=covars.device).expand(K, F, F)
    Linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                             dim=-1)
    return Linv, logdet


def gaussian_logpdf(X: torch.Tensor, means: torch.Tensor,
                    covars: torch.Tensor) -> torch.Tensor:
    """Log N(x; mu_k, V_k) for every sample and state: (..., F) -> (..., K)."""
    F = X.shape[-1]
    Linv, logdet = _chol_inv_and_logdet(covars)
    y = torch.einsum("...f,kgf->...kg", X, Linv)
    y_mu = torch.einsum("kf,kgf->kg", means, Linv)
    diff = y - y_mu
    quad = torch.sum(diff * diff, dim=-1)
    return -0.5 * (F * _LOG_2PI + logdet + quad)


def gaussian_logpdf_kmajor(X: torch.Tensor, means: torch.Tensor,
                           covars: torch.Tensor) -> torch.Tensor:
    """`gaussian_logpdf` in the state-major layout: X (R, H, W, F) ->
    (R, K, H, W), the layout every E-step kernel takes."""
    F = X.shape[-1]
    Linv, logdet = _chol_inv_and_logdet(covars)
    if X.dtype == torch.float64:
        return _kmajor_pinned(X, means, Linv, logdet)
    y = torch.einsum("rhwf,kgf->rkhwg", X, Linv)
    y_mu = torch.einsum("kf,kgf->kg", means, Linv)
    diff = y - y_mu[None, :, None, None, :]
    quad = torch.sum(diff * diff, dim=-1)
    return -0.5 * (F * _LOG_2PI + logdet[None, :, None, None] + quad)


def _kmajor_pinned(X, means, Linv, logdet):
    """The K-major log-density as elementwise adds in a fixed order:
    y_kg = sum_f x_f Linv_kgf, then quad_k = sum_g (y_kg - mu_kg)^2, each
    sum over f or g taken in index order."""
    F = X.shape[-1]
    xs = X.permute(0, 3, 1, 2)[:, :, None]            # (R, F, 1, H, W)
    y_mu = torch.einsum("kf,kgf->kg", means, Linv)     # (K, F): tiny, once
    quad = None
    for g in range(F):
        y = xs[:, 0] * Linv[None, :, g, 0, None, None]
        for f in range(1, F):
            y = y + xs[:, f] * Linv[None, :, g, f, None, None]
        diff = y - y_mu[None, :, g, None, None]
        quad = diff * diff if quad is None else quad + diff * diff
    return -0.5 * (F * _LOG_2PI + logdet[None, :, None, None] + quad)

"""Bounded L-BFGS for the OU M-step, batched over independent problems.

Counterpart of ``phylo_hmrf_tpu/ops/lbfgs.py``, where one solver runs per
state under ``vmap`` of a ``while_loop``. Here the B problems (the K
states) run as one batch: every tensor carries a leading batch axis, each
problem stops on its own (after ``n_iters`` steps, or after ``patience``
steps without relative improvement above ``tol``), and a stopped problem's
carry stays frozen while the others go on — what the vmapped while_loop
does. The box is a sigmoid reparameterization; the line search evaluates a
fixed geometric grid of step sizes in one batched call.

``fn`` maps x (..., B, P) to values (..., B), one independent problem per
row; gradients come from autograd on the sum over problems. The loop
reads one flag per iteration (the exit check) from the device.
"""

from __future__ import annotations

import torch

_LS_ETAS = (4.0, 2.0, 1.0, 0.5, 0.25, 0.1, 0.04, 0.015, 0.005, 0.001)


def box_encode(p: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Box coordinates -> unconstrained space (logit)."""
    t = torch.clamp((p - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
    return torch.log(t) - torch.log1p(-t)


def box_decode(z: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.sigmoid(z)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _two_loop(g, S, Y, rho, valid):
    """L-BFGS two-loop recursion over a ring buffer, batched.

    g (B, P); S, Y (B, M, P) oldest..newest; rho (B, M) = 1/(s.y);
    valid (B, M) marks filled slots."""
    M = S.shape[1]
    v = valid.to(g.dtype)
    q = g
    alphas = [None] * M
    for i in range(M - 1, -1, -1):           # newest to oldest
        a = rho[:, i] * _dot(S[:, i], q) * v[:, i]
        q = q - a[:, None] * Y[:, i]
        alphas[i] = a
    sy = _dot(S[:, M - 1], Y[:, M - 1])
    yy = _dot(Y[:, M - 1], Y[:, M - 1])
    gamma = torch.where(valid[:, M - 1], sy / torch.clamp(yy, min=1e-20), 1.0)
    r = gamma[:, None] * q
    for i in range(M):                       # oldest to newest
        b = rho[:, i] * _dot(Y[:, i], r) * v[:, i]
        r = r + (alphas[i] - b)[:, None] * S[:, i]
    return r


def _value_and_grad(fn, x):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fn(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


def _ring_push(buf, new, keep):
    """Drop the oldest slot and append ``new`` where ``keep`` (per row)."""
    shifted = torch.cat([buf[:, 1:], new[:, None]], dim=1)
    k = keep.view((-1,) + (1,) * (buf.dim() - 1))
    return torch.where(k, shifted, buf)


def minimize_lbfgs(fn, x0: torch.Tensor, n_iters: int, memory_size: int = 10,
                   etas=_LS_ETAS, tol: float = 0.0, patience: int = 5):
    """Minimize each row of ``fn`` from x0 (B, P); returns (x, f)."""
    B, P = x0.shape
    M = memory_size
    etas_t = torch.as_tensor(etas, dtype=x0.dtype, device=x0.device)

    x = x0.detach().clone()
    f, g = _value_and_grad(fn, x)
    S = x0.new_zeros(B, M, P)
    Y = x0.new_zeros(B, M, P)
    rho = x0.new_zeros(B, M)
    valid = torch.zeros(B, M, dtype=torch.bool, device=x0.device)
    stall = torch.zeros(B, dtype=torch.int32, device=x0.device)
    active = torch.ones(B, dtype=torch.bool, device=x0.device)

    for _ in range(n_iters):
        d = -_two_loop(g, S, Y, rho, valid)
        # steepest descent where d is not a finite descent direction
        ok = (_dot(d, g) < 0) & torch.isfinite(d).all(dim=-1)
        d = torch.where(ok[:, None], d, -g)

        cand = x[None] + etas_t[:, None, None] * d[None]      # (E, B, P)
        with torch.no_grad():
            fs = fn(cand)                                     # (E, B)
        fs = torch.where(torch.isfinite(fs), fs, torch.inf)
        best = torch.argmin(fs, dim=0)                        # (B,)
        f_try = fs.gather(0, best[None])[0]
        improved = f_try < f
        x_try = cand.gather(0, best.view(1, B, 1).expand(1, B, P))[0]
        x_new = torch.where(improved[:, None], x_try, x)
        f_new = torch.where(improved, f_try, f)
        _, g_new = _value_and_grad(fn, x_new)
        g_new = torch.where(torch.isfinite(g_new), g_new, g)

        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        keep = improved & (sy > 1e-12)
        S2 = _ring_push(S, s, keep)
        Y2 = _ring_push(Y, y, keep)
        rho2 = _ring_push(rho, 1.0 / torch.clamp(sy, min=1e-20), keep)
        valid2 = _ring_push(valid, torch.ones_like(keep), keep)

        if tol > 0:
            gain = (f - f_new) > tol * torch.clamp(torch.abs(f_new), min=1.0)
            stall2 = torch.where(gain, 0, stall + 1)
        else:
            stall2 = stall
        # a stopped problem keeps its carry, as in the vmapped while_loop
        a = active
        x = torch.where(a[:, None], x_new, x)
        f = torch.where(a, f_new, f)
        g = torch.where(a[:, None], g_new, g)
        S = torch.where(a[:, None, None], S2, S)
        Y = torch.where(a[:, None, None], Y2, Y)
        rho = torch.where(a[:, None], rho2, rho)
        valid = torch.where(a[:, None], valid2, valid)
        stall = torch.where(a, stall2, stall)
        active = stall < patience
        if not bool(active.any()):
            break
    return x, f


def minimize_boxed(fn, p0: torch.Tensor, lo: float, hi: float, n_iters: int,
                   tol: float = 1e-7):
    """Box-constrained minimize of fn(box_decode(z)) over z, batched over
    the rows of p0 (B, P). Returns (p (B, P), f (B,))."""
    z0 = box_encode(p0, lo, hi)
    z, f = minimize_lbfgs(lambda z: fn(box_decode(z, lo, hi)), z0, n_iters,
                          tol=tol)
    return box_decode(z, lo, hi), f

"""The plain reference of a Phylo-HMRF fit, in plain PyTorch on the CPU.

It rebuilds every quantity it needs from the benchmark's own inputs (the
samples of ``synth.make_data``, the configuration) and imports nothing of
the program: the region geometry and edge weights (the reference's
``utility.py:1935-1953`` distances, w = exp(-beta1 d)), the Gaussian unary,
the weighted Potts energy and each pixel's local (ICM) scores, the
E-step's posteriors, costs and sufficient statistics at given labels, the
OU moments on the tree and the init and M-step objectives.

Each function takes the ``dtype`` it computes in. The reference runs in
float64; the same code in a lower precision (bfloat16, or float32 for a
float64 configuration) is the control that the comparison must refuse
(``control.py``). Linear algebra that PyTorch offers only in float32 and
float64 (Cholesky, solves) is done in float64 and its results rounded to
the lower precision; every elementwise product and sum runs in ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from synth import Tree, flat_order

SMALL_EPS = 1e-16
LOG_2PI = math.log(2.0 * math.pi)
# forward edges: right, down, down-right, down-left
DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))


class Region:
    """One region on its unpadded (h0, w0) grid: the samples as an image,
    the valid mask, the flat order and the raw edge distances per forward
    direction (+inf where no edge)."""

    def __init__(self, reg: dict, num_neighbor: int = 8):
        h0, w0, is_diag = reg["h0"], reg["w0"], reg["is_diag"]
        x = np.asarray(reg["x"], np.float64)
        self.h0, self.w0, self.is_diag = h0, w0, is_diag
        self.rows, self.cols = flat_order(h0, w0, is_diag)
        F = x.shape[1]
        img = np.zeros((h0, w0, F))
        img[self.rows, self.cols] = x
        mask = np.zeros((h0, w0), bool)
        mask[self.rows, self.cols] = True
        norm = np.sqrt((img * img).sum(-1))
        dist = np.full((4, h0, w0), np.inf)
        for d, (di, dj) in enumerate(DIRS[:4 if num_neighbor == 8 else 2]):
            for i in range(h0 - di):
                j0, j1 = max(0, -dj), w0 - max(0, dj)
                a, b = img[i, j0:j1], img[i + di, j0 + dj:j1 + dj]
                ok = mask[i, j0:j1] & mask[i + di, j0 + dj:j1 + dj]
                dd = ((a - b) ** 2).sum(-1) / (norm[i, j0:j1]
                                               * norm[i + di, j0 + dj:j1 + dj]
                                               + SMALL_EPS)
                if is_diag and d == 2:
                    # an edge between two main-diagonal pixels counts half
                    jj = np.arange(j0, j1)
                    dd = np.where(jj == i, 0.5 * dd, dd)
                dist[d, i, j0:j1] = np.where(ok, dd, np.inf)
        self.img = img
        self.mask = mask
        self.dist = dist
        self.x = x

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    def grid(self, flat: np.ndarray) -> np.ndarray:
        """Flat labels -> (h0, w0) grid (0 off the mask)."""
        g = np.zeros((self.h0, self.w0), np.int64)
        g[self.rows, self.cols] = flat
        return g

    def weights(self, beta1: float, weighted: bool = True, dtype=torch.float64):
        """(4, h0, w0) forward-edge weights exp(-beta1 d), or the edge
        indicator when not ``weighted``."""
        w = (np.exp(-beta1 * self.dist) if weighted
             else np.isfinite(self.dist).astype(np.float64))
        return torch.as_tensor(w).to(dtype)


def _shift(a: torch.Tensor, di: int, dj: int, fill) -> torch.Tensor:
    """out[..., i, j] = a[..., i + di, j + dj], ``fill`` outside."""
    H, W = a.shape[-2:]
    out = torch.full_like(a, fill)
    r0, r1 = max(0, -di), H - max(0, di)
    c0, c1 = max(0, -dj), W - max(0, dj)
    out[..., r0:r1, c0:c1] = a[..., r0 + di:r1 + di, c0 + dj:c1 + dj]
    return out


def unary(region: Region, means, covars, dtype=torch.float64) -> torch.Tensor:
    """-log N(x_p; mu_k, V_k) as (K, h0, w0), in ``dtype``: the precision
    matrices and log-determinants in float64, then rounded; the quadratic
    form in ``dtype``."""
    means = torch.as_tensor(np.asarray(means, np.float64))
    covars = torch.as_tensor(np.asarray(covars, np.float64))
    K, F = means.shape
    prec = torch.linalg.inv(covars).to(dtype)
    logdet = torch.linalg.slogdet(covars)[1].to(dtype)
    img = torch.as_tensor(region.img).to(dtype)
    diff = img[None] - means.to(dtype)[:, None, None, :]       # (K, H, W, F)
    quad = torch.einsum("khwf,kfg,khwg->khw", diff, prec, diff)
    return (0.5 * (F * LOG_2PI + logdet[:, None, None] + quad)).to(dtype)


def agreement(labels: torch.Tensor, w: torch.Tensor, K: int) -> torch.Tensor:
    """(K, H, W): per pixel and state, the weight of the incident edges
    whose other end carries that state (both directions of every edge)."""
    ks = torch.arange(K)[:, None, None]
    out = torch.zeros((K,) + tuple(labels.shape), dtype=w.dtype)
    for d, (di, dj) in enumerate(DIRS):
        nb = _shift(labels, di, dj, -1)
        out = out + w[d] * (nb[None] == ks).to(w.dtype)
        # the backward end: the pixel at (i + di, j + dj) sees (i, j)
        back = (w[d] * (labels[None] == ks).to(w.dtype))
        out = out + _shift(back, -di, -dj, 0)
    return out


def local_gains(labels: np.ndarray, un: torch.Tensor, w: torch.Tensor,
                mask: np.ndarray, beta: float) -> np.ndarray:
    """Per valid pixel, how much a change of that pixel's label alone
    would lower the energy: score(label) - min_k score(k), score = unary
    - beta * agreement. 0 at every pixel of an ICM fixed point."""
    K = un.shape[0]
    lab = torch.as_tensor(labels)
    score = un - beta * agreement(lab, w, K)
    at = torch.gather(score, 0, lab[None].clamp(0, K - 1))[0]
    gain = (at - score.min(0).values).double().numpy()
    return gain[mask]


def energy(labels: np.ndarray, un: torch.Tensor, w: torch.Tensor,
           mask: np.ndarray, beta: float, dtype=torch.float64) -> float:
    """sum_p unary(p, s_p) + beta sum_e w_e [s_u != s_v] (forward edges),
    every term and sum in ``dtype``."""
    lab = torch.as_tensor(labels)
    K = un.shape[0]
    u = torch.gather(un.to(dtype), 0, lab[None].clamp(0, K - 1))[0]
    e = u[torch.as_tensor(mask)].sum()
    pair = torch.zeros((), dtype=dtype)
    for d, (di, dj) in enumerate(DIRS):
        nb = _shift(lab, di, dj, -1)
        pair = pair + (w[d].to(dtype) * (lab != nb).to(dtype)).sum()
    return float(e + beta * pair)


def icm(un: torch.Tensor, w: torch.Tensor, mask: np.ndarray,
        labels: np.ndarray, beta: float, max_sweeps: int = 60) -> np.ndarray:
    """ICM over the 4 colours (i % 2, j % 2), in the unary's dtype, until
    no label changes or ``max_sweeps`` sweeps: the control's labeler."""
    K, H, W = un.shape
    lab = torch.as_tensor(labels).clone()
    m = torch.as_tensor(mask)
    i = torch.arange(H)[:, None]
    j = torch.arange(W)[None, :]
    colours = [(i % 2 == a) & (j % 2 == b) & m for a in (0, 1) for b in (0, 1)]
    for _ in range(max_sweeps):
        changed = 0
        for c in colours:
            best = torch.argmin(un - beta * agreement(lab, w, K), dim=0)
            new = torch.where(c, best, lab)
            changed += int((new != lab).sum())
            lab = new
        if changed == 0:
            break
    return lab.numpy()


def estep_outputs(region: Region, un: torch.Tensor, labels: np.ndarray,
                  w_pp: torch.Tensor, beta: float, dtype=torch.float64):
    """What the E-step reports of a region at ``labels``: posteriors
    softmax(logprob - pp) and the costs [pairwise, pairwise_nrm, unary,
    cost1] as means over the valid pixels, the statistics post (K,),
    obs (K, F), obs2 (K, F, F). pp(p, k) = beta sum_{e at p} w_e
    [k != other end's label]."""
    K = un.shape[0]
    lab = torch.as_tensor(labels)
    m = torch.as_tensor(region.mask)
    agree = agreement(lab, w_pp.to(dtype), K)
    wsum = agreement(torch.zeros_like(lab), w_pp.to(dtype), 1)[0]
    pp = (beta * (wsum[None] - agree)).to(dtype)
    logprob = (-un).to(dtype)
    post = torch.softmax(logprob - pp, dim=0)
    ppn = torch.softmax(-pp, dim=0)
    at = lab[None].clamp(0, K - 1)
    nv = float(m.sum())
    pair = torch.gather(pp, 0, at)[0][m].sum() / nv
    pair_nrm = -torch.log(torch.gather(ppn, 0, at)[0][m] + SMALL_EPS).sum() / nv
    un_cost = -torch.gather(logprob, 0, at)[0][m].sum() / nv
    costs = torch.stack([pair, pair_nrm, un_cost, un_cost + pair_nrm])
    g = post[:, m]                                           # (K, N)
    x = torch.as_tensor(region.img).to(dtype)[m]             # (N, F)
    obs = g @ x
    obs2 = torch.einsum("kn,nf,ng->kfg", g, x, x)
    return (g.sum(1).double().numpy(), obs.double().numpy(),
            obs2.double().numpy(), costs.double().numpy())


# ---------------------------------------------------------------------------
# OU moments and objectives
# ---------------------------------------------------------------------------

def ou_moments(params: torch.Tensor, tree: Tree):
    """(..., P) -> leaf means (..., L) and covariances (..., L, L), in the
    params' dtype."""
    nn = tree.n_nodes
    B = nn - 1
    alpha = params[..., 1:1 + B]
    lam = params[..., 1 + B:1 + 2 * B]
    theta = params[..., 1 + 2 * B:]
    mean = [theta[..., 0]]
    var = [params[..., 0]]
    for v in range(1, nn):
        a = alpha[..., v - 1]
        e = torch.exp(-a)
        ratio = torch.where(a > 1e-7, lam[..., v - 1] / (2 * a),
                            torch.zeros_like(a))
        par = tree.parent[v]
        mean.append(mean[par] * e + theta[..., v] * (1 - e))
        var.append(ratio * (1 - e * e) + var[par] * e * e)
    L = tree.n_leaves
    rows = [[None] * L for _ in range(L)]
    for i, leaf in enumerate(tree.leaves):
        rows[i][i] = var[leaf]
    for i, j, mrca, below in tree.pairs:
        s = torch.exp(-sum(alpha[..., v - 1] for v in below)) * var[mrca]
        rows[i][j] = rows[j][i] = s
    cov = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return torch.stack([mean[v] for v in tree.leaves], dim=-1), cov


def _logdet_trace(V: torch.Tensor, S: torch.Tensor):
    """(log(det V + eps), tr(V^{-1} S)); +inf where V is not positive
    definite."""
    chol, info = torch.linalg.cholesky_ex(V)
    det = torch.prod(torch.diagonal(chol, dim1=-2, dim2=-1), -1) ** 2
    tr = torch.diagonal(torch.cholesky_solve(S, chol), dim1=-2,
                        dim2=-1).sum(-1)
    bad = info != 0
    return (torch.where(bad, torch.inf, torch.log(det + SMALL_EPS)),
            torch.where(bad, torch.inf, tr))


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def mstep_objective(p, post, obs, obs2, tree: Tree, n: float, lambda_0: float,
                    min_covar: float):
    """The M-step loss of one state (the reference's ``_ou_optimize2``
    objective): post log(det V + eps) / n + tr(V^{-1} S) / n
    + lambda_0 / sqrt(n) |p|^2, S = obs2 - obs m' - m obs' + post m m'."""
    m, cov = ou_moments(p, tree)
    V = cov + min_covar * torch.eye(cov.shape[-1], dtype=p.dtype)
    om = _outer(obs, m)
    S = obs2 - om - om.transpose(-1, -2) + post * _outer(m, m)
    logdet, tr = _logdet_trace(V, S)
    return (post * logdet / n + tr / n
            + lambda_0 / math.sqrt(n) * torch.sum(p * p, -1))


def init_objective(p, xbar, xxT, tree: Tree, min_covar: float):
    """The init loss of one cluster: log(det V + eps) + tr(V^{-1} S),
    S = xxT - xbar m' - m xbar' + m m'."""
    m, cov = ou_moments(p, tree)
    V = cov + min_covar * torch.eye(cov.shape[-1], dtype=p.dtype)
    om = _outer(xbar, m)
    S = xxT - om - om.transpose(-1, -2) + _outer(m, m)
    logdet, tr = _logdet_trace(V, S)
    return logdet + tr


def refine(fun, p0: np.ndarray, args, lo: float, hi: float,
           iters: int = 40):
    """The least values of ``fun`` (float64; params (P,), then the rows of
    ``args``) near the rows of ``p0`` (B, P), each inside the box
    [lo, hi]: damped projected Newton steps, all rows at once, each with a
    backtracking line search; a variable at a bound whose gradient points
    out stays there. Returns (f(p0) (B,), least f (B,))."""
    vfun = torch.func.vmap(fun)
    vgrad = torch.func.vmap(torch.func.grad(fun))
    vhess = torch.func.vmap(torch.func.hessian(fun))
    p = torch.as_tensor(np.clip(np.asarray(p0, np.float64), lo, hi))
    args = [torch.as_tensor(np.asarray(a, np.float64)) for a in args]
    f0 = f = vfun(p, *args)
    B, P = p.shape
    eye = torch.eye(P, dtype=p.dtype)
    ts = 0.5 ** torch.arange(30, dtype=p.dtype)
    live = torch.isfinite(f)
    for _ in range(iters):
        if not bool(live.any()):
            break
        g = vgrad(p, *args)
        Hm = vhess(p, *args)
        free = ~(((p <= lo) & (g > 0)) | ((p >= hi) & (g < 0)))
        ff = free[:, :, None] & free[:, None, :]
        Hm = torch.where(ff, 0.5 * (Hm + Hm.transpose(1, 2)), eye)
        g = torch.where(free, g, 0.0)
        scale = torch.diagonal(Hm, dim1=1, dim2=2).abs().amax(1)
        mu = torch.zeros(B, dtype=p.dtype)
        for _ in range(40):
            L, info = torch.linalg.cholesky_ex(Hm + mu[:, None, None] * eye)
            bad = info != 0
            if not bool(bad.any()):
                break
            mu = torch.where(bad, torch.clamp(10.0 * mu, min=1e-12 * scale),
                             mu)
        step = -torch.cholesky_solve(g[:, :, None], L)[:, :, 0]
        step = torch.where(torch.isfinite(step), step, 0.0)
        q = torch.clamp(p[:, None] + ts[None, :, None] * step[:, None],
                        lo, hi)                              # (B, T, P)
        fq = vfun(q.reshape(-1, P), *[a.repeat_interleave(len(ts), 0)
                                      for a in args]).reshape(B, len(ts))
        better = torch.isfinite(fq) & (fq < f[:, None])
        first = torch.argmax(better.to(torch.int8), dim=1)
        moved = better.any(1) & live
        pick = q[torch.arange(B), first]
        p = torch.where(moved[:, None], pick, p)
        f = torch.where(moved, fq[torch.arange(B), first], f)
        live = moved
    return f0.numpy(), f.numpy(), p.numpy()

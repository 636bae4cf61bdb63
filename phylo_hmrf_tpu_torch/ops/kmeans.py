"""K-means initialization — PyTorch counterpart of
``phylo_hmrf_tpu/ops/kmeans.py``.

k-means++ seeding on a subsample of at most ``pp_subsample`` points, then
the best (lowest inertia) of ``n_init`` Lloyd runs of ``n_iters`` steps.
Randomness comes from an explicit ``torch.Generator``; its draws are not
JAX's, so the two packages' results are compared by inertia, never by bits.
It only seeds the EM: determinism matters, equality with sklearn does not.

Two routes of one algorithm (`kmeans_route`):

* "kernel": a float32 CUDA tensor within the kernels' caps (K <= 32, F <=
  8, n_init <= 32, n_init K <= 1024) runs KM1 (the seeding of every trial)
  and KM2/KM3 (the Lloyd steps of all trials in lockstep, then the best
  trial's labels) of ``csrc/kmeans.cu``: the generator's draws and two
  launches a call.
* "plain": `kmeans_plain`, trial after trial in PyTorch ops; the CPU, and
  any other shape. It is the kernels' reference: it takes the same draws
  and the same arithmetic (see ``csrc/kmeans.cu``), so at one seed the two
  routes make the same picks and, but for float64 sums that differ in their
  last bits, the same centers.

Both take their draws up front, trial by trial (`_draws`): the subsample
permutation, the first pick, then K - 1 uniforms, each k-means++ pick the
first point whose prefix sum of the weights exceeds a uniform times their
total (`_pick`).

A traced fit's ``kmeans`` span has the ``route`` and ``launches``, the
call's launches of KM1 and KM2/KM3 (two on the "kernel" route, none on
the "plain" one), which ``kmeans.kernel_launches`` counts.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.halo_rows import barrier_for
from phylo_hmrf_tpu_torch.utils.profiling import span

KMAX = 32        # the kernels' caps (csrc/kmeans.cu)
FMAX = 8
TRIALS_MAX = 32
PAIRS_MAX = 1024     # n_init x k: the (trial, center) pairs of a block


def kmeans_route(device, dtype, n_features: int, k: int, n_init: int) -> str:
    """"kernel" for float32 on a CUDA device within the kernels' caps,
    else "plain"."""
    if (torch.device(device).type == "cuda" and dtype == torch.float32
            and 1 <= k <= KMAX and 1 <= n_features <= FMAX
            and 1 <= n_init <= TRIALS_MAX and n_init * k <= PAIRS_MAX):
        return "kernel"
    return "plain"


def _draws(gen: torch.Generator, n: int, m: int, k: int, n_init: int,
           device):
    """Every trial's draws, trial after trial: ``randperm(n)[:m]`` (only
    where m < n), the first pick ``randint(0, m)``, K - 1 float64
    uniforms. Returns (perm (n_init, m) int64 or None, first (n_init,)
    int64, u (n_init, k - 1) float64)."""
    perms, firsts, us = [], [], []
    for _ in range(n_init):
        if m < n:
            perms.append(torch.randperm(n, generator=gen,
                                        device=device)[:m])
        firsts.append(torch.randint(0, m, (1,), generator=gen,
                                    device=device))
        us.append(torch.rand(k - 1, generator=gen, device=device,
                             dtype=torch.float64))
    perm = torch.stack(perms) if perms else None
    return perm, torch.cat(firsts), torch.stack(us)


def _sq_dists(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(N, F) x (K, F) -> (N, K) squared distances, sum_f (x_f - c_f)^2
    with the features added in order."""
    d = None
    for f in range(X.shape[1]):
        diff = X[:, f, None] - C[None, :, f]
        sq = diff * diff
        d = sq if d is None else d + sq
    return d


def _pick(d2: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """k-means++'s pick, (1,) int64: the first index whose inclusive prefix
    sum of the weights max(d2, 0) + 1e-12 (float64) exceeds ``u`` times
    their total (the last index where rounding leaves none)."""
    cum = torch.cumsum(torch.clamp(d2, min=0.0).double() + 1e-12, 0)
    i = torch.searchsorted(cum, (u * cum[-1]).reshape(1), right=True)
    return torch.clamp(i, max=d2.shape[0] - 1)


def _seed_plain(X, perm_t, first_t, u_t, k: int) -> torch.Tensor:
    """One trial's k-means++ centers (k, F) from its draws."""
    seed_X = X if perm_t is None else X[perm_t]
    centers = X.new_empty(k, X.shape[1])
    centers[0] = seed_X[first_t]
    d2 = torch.full((seed_X.shape[0],), torch.inf, dtype=X.dtype,
                    device=X.device)
    for i in range(1, k):
        d2 = torch.minimum(d2, _sq_dists(seed_X, centers[i - 1:i])[:, 0])
        centers[i:i + 1] = seed_X[_pick(d2, u_t[i - 1])]
    return centers


def _lloyd_plain(X, centers, n_iters: int) -> torch.Tensor:
    k = centers.shape[0]
    X64 = X.double()
    for _ in range(n_iters):
        assign = torch.argmin(_sq_dists(X, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).double()
        counts = onehot.sum(0)
        new = (onehot.T @ X64) / torch.clamp(counts, min=1.0)[:, None]
        # an empty cluster keeps its old center
        centers = torch.where(counts[:, None] > 0, new.to(X.dtype), centers)
    return centers


def kmeans_plain(gen: torch.Generator, X: torch.Tensor, k: int,
                 n_iters: int = 100, n_init: int = 10,
                 pp_subsample: int = 65536):
    """`kmeans` in PyTorch ops, trial after trial: the CPU route and the
    kernels' reference."""
    n = X.shape[0]
    m = min(n, pp_subsample)
    perm, first, u = _draws(gen, n, m, k, n_init, X.device)
    best_c, best_i = None, None
    for t in range(n_init):
        centers = _lloyd_plain(
            X, _seed_plain(X, None if perm is None else perm[t], first[t],
                           u[t], k), n_iters)
        inertia = torch.sum(torch.min(_sq_dists(X, centers), dim=1)
                            .values.double())
        if best_c is None:
            best_c, best_i = centers, inertia
        else:
            # strict: ties keep the earlier trial, as argmin does
            better = inertia < best_i
            best_c = torch.where(better, centers, best_c)
            best_i = torch.where(better, inertia, best_i)
    labels = torch.argmin(_sq_dists(X, best_c), dim=1)
    return best_c, labels.to(torch.int32), best_i.to(X.dtype)


def _seed_kernel(X, perm, first, u, k: int) -> torch.Tensor:
    """KM1: every trial's k-means++ centers (n_init, k, F) from `_draws`."""
    n, F = X.shape
    T = first.shape[0]
    m = n if perm is None else perm.shape[1]
    f32 = dict(dtype=torch.float32, device=X.device)
    centers = torch.empty((T, k, F), **f32)
    d2 = torch.empty((T, m), **f32)
    xsub = None if perm is None else torch.empty((T, m, F), **f32)
    specs = dict(X=(X, torch.float32, (n, F)),
                 first=(first, torch.int64, (T,)),
                 u=(u, torch.float64, (T, k - 1)))
    if perm is not None:
        specs["perm"] = (perm, torch.int64, (T, m))
    _build.check_tensors("kmeans_seed", **specs)
    with _build.on_device(X):
        _build.check(_build.load().phmrf_kmeans_seed(
            X.data_ptr(), None if perm is None else perm.data_ptr(),
            first.data_ptr(), u.data_ptr(), n, m, F, k, T,
            None if xsub is None else xsub.data_ptr(), d2.data_ptr(),
            centers.data_ptr(), _build.stream_of(X)), "KM1 kmeans_seed")
    kmeans.kernel_launches += 1
    return centers


def _lloyd_kernel(X, centers, n_iters: int):
    """KM2 and KM3: ``n_iters`` Lloyd steps of every trial from centers
    (n_init, k, F), updated in place, then the best trial's (centers (k,
    F), labels (N,) int32, inertia)."""
    n, F = X.shape
    T, k, _ = centers.shape
    dev = X.device
    _build.check_tensors("kmeans_lloyd", X=(X, torch.float32, (n, F)),
                         centers=(centers, torch.float32, (T, k, F)))
    lib = _build.load()
    with _build.on_device(X):
        grid = lib.phmrf_kmeans_grid(n, F, k, T)
        if grid < 1:
            raise _build.KernelLaunchError(
                f"KM2 kmeans_lloyd: no grid (CUDA error {-grid})")
        f64 = dict(dtype=torch.float64, device=dev)
        part = torch.empty((T * k, F + 1, grid), **f64)
        ipart = torch.empty((grid, T), **f64)
        out_c = torch.empty((k, F), dtype=torch.float32, device=dev)
        labels = torch.empty(n, dtype=torch.int32, device=dev)
        inertia = torch.empty((), dtype=torch.float32, device=dev)
        _build.check(lib.phmrf_kmeans_lloyd(
            X.data_ptr(), n, F, k, T, int(n_iters), grid, centers.data_ptr(),
            part.data_ptr(), ipart.data_ptr(), out_c.data_ptr(),
            labels.data_ptr(), inertia.data_ptr(), barrier_for(X).data_ptr(),
            _build.stream_of(X)), "KM2 kmeans_lloyd")
    kmeans.kernel_launches += 1
    return out_c, labels, inertia


def _kmeans_kernel(gen, X, k, n_iters, n_init, pp_subsample):
    n = X.shape[0]
    m = min(n, pp_subsample)
    X = X.contiguous()
    perm, first, u = _draws(gen, n, m, k, n_init, X.device)
    return _lloyd_kernel(X, _seed_kernel(X, perm, first, u, k), n_iters)


def kmeans(gen: torch.Generator, X: torch.Tensor, k: int, n_iters: int = 100,
           n_init: int = 10, pp_subsample: int = 65536):
    """Best-of-``n_init`` Lloyd k-means with k-means++ seeding.

    ``gen`` must live on X's device. Returns (centers (k, F),
    labels (N,) int32, inertia); nothing is read back to the host."""
    route = kmeans_route(X.device, X.dtype, X.shape[1], k, n_init)
    run = _kmeans_kernel if route == "kernel" else kmeans_plain
    with span("kmeans", route=route) as sp:
        launches0 = kmeans.kernel_launches
        out = run(gen, X, k, n_iters, n_init, pp_subsample)
        sp.add(launches=kmeans.kernel_launches - launches0)
    return out


kmeans.kernel_launches = 0   # KM1 and KM2 launches, two a kernel-route call

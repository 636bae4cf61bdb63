"""The fused L-BFGS kernel of the OU solves (``csrc/lbfgs.cu``,
``ops/lbfgs.py::fused_ou_solve``) against autograd and the plain driver.

The route choice and the tree's kernel index run on the CPU; the kernel
tests are marked ``cuda`` and skip without a card. On a GPU machine:
``python -m pytest tests/test_torch_lbfgs_kernel.py -q --noconftest``.
Trees: the benchmark's chr21 tree (8 nodes, 4 leaves, 23 parameters) and
a 6-leaf tree (12 nodes, 35 parameters: two coordinates on some lanes).
Statistics: K states of samples drawn from OU models on the tree, with
soft weights, as an M-step sees them; and the M-step's statistics of the
chr21 problem's true labels at K = 10 and 20 (the benchmark's cells' tree
and data), from a seeded start.
"""

import functools

import numpy as np
import pytest
import torch

from phylo_hmrf_tpu_torch.models.ou import (kernel_index, ou_moments,
                                            ou_nll_init, ou_nll_stats,
                                            ridge_coef, tree_tensors)
from phylo_hmrf_tpu_torch.ops import lbfgs
from phylo_hmrf_tpu_torch.synth import bench_tree, chr21_problem
from phylo_hmrf_tpu_torch.tree import build_tree

LO, HI, MIN_COVAR, LAMBDA_0 = 1e-16, 100.0, 1e-3, 1.0
TOL = {torch.float32: 1e-5, torch.float64: 1e-11}


def _trees():
    return {"chr21": bench_tree(),
            "six": build_tree([(0, 1), (1, 2), (1, 3), (2, 4), (2, 5),
                               (3, 6), (3, 7), (4, 8), (4, 9), (5, 10),
                               (5, 11)])}


def _star(n_leaves):
    """A unary root over one node with ``n_leaves`` leaf children."""
    return build_tree([(0, 1)] + [(1, 2 + i) for i in range(n_leaves)])


def _problem(tree, K, seed, dtype, device, n_per=3000):
    """(p0, post, obs, obs2), n: K states of samples from OU models."""
    rng = np.random.default_rng(seed)
    n, P = tree.n_nodes, tree.n_params
    base = np.concatenate([rng.uniform(0.5, 2, 1), rng.uniform(0.2, 2, n - 1),
                           rng.uniform(0.5, 3, n - 1), rng.uniform(-2, 2, n)])
    true = base * rng.uniform(0.7, 1.3, (K, P))
    m, C = ou_moments(torch.as_tensor(true), tree_tensors(tree, "cpu",
                                                          torch.float64))
    post, obs, obs2 = [], [], []
    for k in range(K):
        X = rng.multivariate_normal(m[k].numpy(), C[k].numpy()
                                    + MIN_COVAR * np.eye(tree.n_leaves),
                                    size=n_per)
        w = rng.uniform(0.5, 1.0, n_per)
        post.append(w.sum())
        obs.append(w @ X)
        obs2.append(np.einsum("n,nf,ng->fg", w, X, X))
    p0 = rng.random((K, P)) * 0.8 + 0.2
    return [torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
            for a in (p0, post, obs, obs2)], float(n_per * K)


def _chr21_true(K, dtype, device):
    """(p0, post, obs, obs2), n: the M-step's statistics of the chr21
    problem's true labels at K states (one-hot weights) and a seeded
    start."""
    tree, region, _, _, _, true = chr21_problem(0, K=K)
    X = region.flat_values().astype(np.float64)
    g = np.eye(K)[true]
    p0 = np.random.default_rng(0).random((K, tree.n_params)) * 0.8 + 0.2
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in (
        p0, g.sum(0), g.T @ X, np.einsum("nk,nf,ng->kfg", g, X, X))], float(
            X.shape[0])


def _kernel_args(tree, dtype, device):
    tt = tree_tensors(tree, device, dtype)
    return tt, dict(index=tt.index, a2t=tt.A2T)


# ------------------------------------------------------------ on the CPU --

@pytest.mark.parametrize("case,route", [
    (("cpu", torch.float32, 8, 4), "plain"),
    (("cpu", torch.float64, 40, 20), "plain"),
    (("cuda", torch.float32, 8, 4), "fused"),
    (("cuda", torch.float64, 8, 4), "fused"),
    (("cuda", torch.float32, 16, 8), "fused"),
    (("cuda", torch.float32, 17, 8), "graph"),
    (("cuda", torch.float64, 11, 9), "graph"),
    (("cuda", torch.float16, 8, 4), "graph"),
    (("cuda:1", torch.float32, 12, 6), "fused"),
])
def test_solve_route(case, route):
    """The route is a function of the tree's size, the dtype and the
    device alone: the plain driver off CUDA, the fused kernel within its
    caps in float32 / float64, the captured graphs otherwise."""
    device, dtype, n_nodes, n_leaves = case
    assert lbfgs.solve_route(n_nodes, n_leaves, dtype,
                             torch.device(device)) == route


@pytest.mark.parametrize("name", ["chr21", "six"])
def test_kernel_index_layout(name):
    """The kernel's int32 tree index: parent, topo order, leaves, pair
    mrca, then each leaf pair's index in the pair list (-1 on the
    diagonal), as the objective reads them."""
    tree = _trees()[name]
    idx = kernel_index(tree)
    n, L, Q = tree.n_nodes, tree.n_leaves, len(tree.pair_mrca)
    assert idx.dtype == np.int32 and idx.shape == (2 * n + L + Q + L * L,)
    parts = np.split(idx, np.cumsum([n, n, L, Q]))
    for got, want in zip(parts, (tree.parent, tree.topo_order,
                                 tree.leaf_nodes, tree.pair_mrca)):
        np.testing.assert_array_equal(got, want)
    pair_of = parts[4].reshape(L, L)
    np.testing.assert_array_equal(np.diag(pair_of), -1)
    for q, (r, c) in enumerate(zip(tree.pair_rows, tree.pair_cols)):
        assert pair_of[r, c] == pair_of[c, r] == q
    assert tree.n_params == 3 * n - 1 <= 3 * lbfgs.FUSED_MAX_NODES - 1


# ------------------------------------------------------------ on the card --

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phylo_hmrf_tpu_torch import _build
    _build.load()
    return torch.device("cuda")


def _rel(a, b):
    """max |a - b| over max |b| (0 where both are all zeros)."""
    diff, scale = float((a - b).abs().max()), float(b.abs().max())
    return diff / scale if scale > 0 else diff


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["chr21", "six"])
def test_fused_value_grad_matches_autograd(dev, name, dtype):
    """The objective and gradient the kernel computes at each line-search
    point against autograd of ``ou_nll_stats`` and ``ou_nll_init`` on the
    card: rows at ordinary params, with alphas under ``_ALPHA_FLOOR``
    (the ratio's where), and with negative variances (V not PD: +inf or
    NaN, the same non-finite gradient entries)."""
    tree = _trees()[name]
    tt, kw = _kernel_args(tree, dtype, dev)
    (p, post, obs, obs2), n = _problem(tree, 6, 0, dtype, dev)
    B = tree.n_nodes - 1
    p[1, 1] = 1e-9
    p[2, 2], p[2, 3] = 5e-8, 1e-12
    p[3, 0] = -50.0
    p[3, B + 1:1 + 2 * B] = -5.0
    xbar, xxT = obs / post[:, None], obs2 / post[:, None, None]
    cases = (
        (functools.partial(ou_nll_stats, post_c=post, obs_c=obs, obs2_c=obs2,
                           tt=tt, n_samples=n, lambda_0=LAMBDA_0,
                           min_covar=MIN_COVAR),
         dict(obs=obs, obs2=obs2, w=post, n_samples=n,
              coef=ridge_coef(dtype, n, LAMBDA_0))),
        (functools.partial(ou_nll_init, xbar=xbar, xxT=xxT, tt=tt,
                           min_covar=MIN_COVAR),
         dict(obs=xbar, obs2=xxT)))
    for objective, args in cases:
        pg = p.clone().requires_grad_(True)
        f = objective(pg)
        (g,) = torch.autograd.grad(f.sum(), pg)
        fk, gk = lbfgs.fused_ou_value_grad(p, min_covar=MIN_COVAR, **kw,
                                           **args)
        ok = torch.isfinite(f)
        assert ok[:3].all() and not ok[3]
        assert torch.equal(torch.isfinite(fk), ok)
        assert torch.equal(torch.isinf(fk), torch.isinf(f))
        assert _rel(fk[ok], f[ok].detach()) <= TOL[dtype]
        for r in range(p.shape[0]):
            fin = torch.isfinite(g[r])
            assert torch.equal(torch.isfinite(gk[r]), fin)
            if fin.any():
                assert _rel(gk[r][fin], g[r][fin]) <= TOL[dtype], r


def _plain(tree, dtype, device, p0, post, obs, obs2, n, iters):
    tt = tree_tensors(tree, device, dtype)
    obj = functools.partial(ou_nll_stats, tt=tt, n_samples=n,
                            lambda_0=LAMBDA_0, min_covar=MIN_COVAR)
    return lbfgs.minimize_boxed(lambda q: obj(q, post, obs, obs2), p0, LO,
                                HI, iters)


def _fused(tree, dtype, device, p0, post, obs, obs2, n, iters):
    _, kw = _kernel_args(tree, dtype, device)
    return lbfgs.fused_ou_solve(
        p0, **kw, obs=obs, obs2=obs2, w=post, n_samples=n,
        coef=ridge_coef(dtype, n, LAMBDA_0), min_covar=MIN_COVAR, lo=LO,
        hi=HI, n_iters=iters)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chr21", "six", "chr21_true"])
def test_fused_short_solves_match_plain_driver(dev, name):
    """1-5 steps in float64: the kernel's params and losses equal the
    plain driver's within 1e-9 relative (the same steps; only the order
    of the sums differs), and every row took the steps it was given. On
    sampled statistics and on the chr21 problem's true labels (K=20)."""
    if name == "chr21_true":
        tree = bench_tree()
        (p0, post, obs, obs2), n = _chr21_true(20, torch.float64, dev)
    else:
        tree = _trees()[name]
        (p0, post, obs, obs2), n = _problem(tree, 10, 1, torch.float64,
                                            dev)
    for iters in range(1, 6):
        ps, fs = _plain(tree, torch.float64, dev, p0, post, obs, obs2, n,
                        iters)
        pk, fk, steps = _fused(tree, torch.float64, dev, p0, post, obs,
                               obs2, n, iters)
        assert _rel(pk, ps) <= 1e-9 and _rel(fk, fs) <= 1e-9, iters
        assert (steps == iters).all()


def _loss64(tree, p, post, obs, obs2, n):
    tt = tree_tensors(tree, p.device, torch.float64)
    return ou_nll_stats(p.double(), post.double(), obs.double(),
                        obs2.double(), tt, n, LAMBDA_0, MIN_COVAR)


def _quantile(t, q):
    return float(torch.quantile(t, q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_full_solves_reach_the_plain_drivers_loss(dev, dtype):
    """Whole 150-step solves of the chr21 tree, compared by loss (in
    float64 at each one's params, relative to the plain driver's loss on
    the card, row by row): 10 rows of sampled statistics a seed over 5
    seeds, and the chr21 problem's true-label statistics at K = 10 and
    20. The stopping rule (5 steps without a relative gain of 1e-7) makes
    where a solve ends sensitive to rounding: the plain driver's own
    twins land far from it in float64 too (up to ~6e-3 on the K = 20
    true-label rows). So the kernel is held to the twins. Per row, the
    twins are the plain driver on the card from 4 starts moved by one
    ulp (a random sign a coordinate) and on the CPU; the kernel runs from
    the start and from the same 4 moved starts. Over all rows, the
    kernel's excess over the plain driver's loss has a median no higher than
    the twins' median distance, a 90th percentile and a largest no more
    than twice the twins' (gaps within 1e-4 / 1e-9 relative pass either
    way); each row stopped within 150 steps."""
    tol = {torch.float32: 1e-4, torch.float64: 1e-9}[dtype]
    ulp = float(torch.finfo(dtype).eps)
    gen = torch.Generator().manual_seed(0)
    tree = _trees()["chr21"]
    problems = [_problem(tree, 10, seed, dtype, dev) for seed in range(5)]
    problems += [_chr21_true(K, dtype, dev) for K in (10, 20)]
    excess, twins = [], []
    for (p0, post, obs, obs2), n in problems:
        args = (post, obs, obs2, n)
        ps, _ = _plain(tree, dtype, dev, p0, *args, 150)
        fs = _loss64(tree, ps, *args).cpu()
        starts = [p0] + [p0 * (1 + (torch.randint(
            0, 2, tuple(p0.shape), generator=gen) * 2 - 1).to(dev, dtype)
            * ulp) for _ in range(4)]
        for start in starts:
            pk, _, steps = _fused(tree, dtype, dev, start, *args, 150)
            assert ((steps >= 1) & (steps <= 150)).all()
            excess.append((_loss64(tree, pk, *args).cpu() - fs) / fs.abs())
        for start in starts[1:]:
            pu, _ = _plain(tree, dtype, dev, start, *args, 150)
            twins.append((_loss64(tree, pu, *args).cpu() - fs).abs()
                         / fs.abs())
        pc, _ = _plain(tree, dtype, "cpu", p0.cpu(), post.cpu(), obs.cpu(),
                       obs2.cpu(), n, 150)
        fc = _loss64(tree, pc, post.cpu(), obs.cpu(), obs2.cpu(), n)
        twins.append((fc - fs).abs() / fs.abs())
    excess, twins = torch.cat(excess), torch.cat(twins)
    seen = {q: (_quantile(excess, q), _quantile(twins, q))
            for q in (0.5, 0.9, 1.0)}
    assert seen[0.5][0] <= max(tol, seen[0.5][1]), seen
    assert seen[0.9][0] <= max(tol, 2 * seen[0.9][1]), seen
    assert seen[1.0][0] <= max(tol, 2 * seen[1.0][1]), seen


@pytest.mark.cuda
def test_fused_solve_is_deterministic_counted_and_reads_nothing(dev):
    """Two solves of the same inputs are bitwise equal, each is one
    launch, and a solve enqueues without a host read (synchronizing
    calls raise under ``set_sync_debug_mode("error")``)."""
    tree = _trees()["six"]
    (p0, post, obs, obs2), n = _problem(tree, 20, 2, torch.float32, dev)
    _, kw = _kernel_args(tree, torch.float32, dev)
    kw.update(obs=obs, obs2=obs2, w=post, n_samples=n,
              coef=ridge_coef(torch.float32, n, LAMBDA_0),
              min_covar=MIN_COVAR, lo=LO, hi=HI, n_iters=150)
    lbfgs.fused_ou_solve(p0, **kw)
    torch.cuda.synchronize()
    before = lbfgs.fused_ou_solve.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [lbfgs.fused_ou_solve(p0, **kw) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert lbfgs.fused_ou_solve.launches == before + 2
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("solve", ["mstep", "init"])
def test_tree_above_the_caps_takes_the_graph_route(dev, solve):
    """A 9-leaf tree (above the kernel's 8) solves through
    ``GraphSolve``: one captured solve in the model's dict, no kernel
    launch, and the result bitwise the plain driver's. The init's solve
    reads the rows' flags once a chunk to stop early: bitwise the same
    as replaying every chunk."""
    from phylo_hmrf_tpu_torch.models.hmrf import (_init_solve,
                                                  _mstep_solve_full)

    tree = _star(9)
    assert lbfgs.solve_route(tree.n_nodes, tree.n_leaves, torch.float32,
                             dev) == "graph"
    (p0, post, obs, obs2), n = _problem(tree, 4, 3, torch.float32, dev,
                                        n_per=500)
    kw = dict(tt=tree_tensors(tree, dev, torch.float32), lo=LO, hi=HI,
              iters=20)
    if solve == "mstep":
        fn, args = _mstep_solve_full, (p0, post, obs, obs2, n, LAMBDA_0,
                                       MIN_COVAR)
    else:
        fn = _init_solve
        args = (p0, obs / post[:, None], obs2 / post[:, None, None],
                MIN_COVAR)
    before = lbfgs.fused_ou_solve.launches
    graphs = {}
    out = fn(*args, graphs=graphs, **kw)
    plain = fn(*args, **kw)
    assert len(graphs) == 1 and lbfgs.fused_ou_solve.launches == before
    if solve == "mstep":
        assert plain[4] is None and out[4] is None   # no step counts
        plain, out = plain[:4], out[:4]
    else:
        (captured,) = graphs.values()
        every = captured(*args[:3], early_exit=False)
        for a, b in zip(every, out):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for a, b in zip(plain, out):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))

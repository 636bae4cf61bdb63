"""The port's M-step and init against the JAX package, on CPU: OU moments
and objectives with their gradients, the batched boxed L-BFGS, k-means
and the init helpers. Inputs come from one numpy seed and go through both.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from phylo_hmrf_tpu_torch.synth import bench_tree  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree():
    return bench_tree()


@pytest.fixture(scope="module")
def tt(tree):
    from phylo_hmrf_tpu_torch.models.ou import tree_tensors
    return tree_tensors(tree, "cpu")


def _params(rng, tree, K):
    p = rng.random((K, tree.n_params)) * 0.8 + 0.2
    p[:, tree.n_params - tree.n_nodes:] = rng.random((K, tree.n_nodes)) + 0.3
    return p.astype(np.float32)


def _stats(rng, tree, K, n=4000):
    """Sufficient statistics of random soft assignments of positive data."""
    F = tree.n_leaves
    X = (np.abs(rng.normal(size=(n, F))) * 0.5 + 0.2).astype(np.float64)
    g = rng.dirichlet(np.ones(K), size=n)
    post = g.sum(0)
    obs = g.T @ X
    obs2 = np.einsum("nk,nf,ng->kfg", g, X, X)
    return (post.astype(np.float32), obs.astype(np.float32),
            obs2.astype(np.float32), n)


def test_ou_moments_match_jax(rng, tree, tt):
    """Leaf means and covariances: rtol 1e-5 (float32, same recursion)."""
    from phylo_hmrf_tpu.models.ou import ou_moments_batch as jax_moments
    from phylo_hmrf_tpu_torch.models.ou import ou_moments_batch

    p = _params(rng, tree, 6)
    m_t, c_t = ou_moments_batch(torch.from_numpy(p), tt)
    m_j, c_j = jax_moments(jnp.asarray(p), tree)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)


def test_ou_objectives_and_grads_match_jax(rng, tree, tt):
    """ou_nll_stats / ou_nll_init values and gradients at identical params:
    rtol 1e-5 (the issue's gate; same unrolled Cholesky in both)."""
    from phylo_hmrf_tpu.models import ou as jou
    from phylo_hmrf_tpu_torch.models import ou as tou

    K = 5
    p = _params(rng, tree, K)
    post, obs, obs2, n = _stats(rng, tree, K)
    xbar = obs / post[:, None]
    xxT = obs2 / post[:, None, None]

    pt = torch.from_numpy(p).requires_grad_(True)
    f_t = tou.ou_nll_stats(pt, torch.from_numpy(post), torch.from_numpy(obs),
                           torch.from_numpy(obs2), tt, float(n), 1.0, 1e-3)
    (g_t,) = torch.autograd.grad(f_t.sum(), pt)

    def jfn(pc, a, b, c):
        return jou.ou_nll_stats(pc, a, b, c, tree, jnp.float32(n),
                                jnp.float32(1.0), jnp.float32(1e-3))
    f_j, g_j = jax.vmap(jax.value_and_grad(jfn))(
        jnp.asarray(p), jnp.asarray(post), jnp.asarray(obs),
        jnp.asarray(obs2))
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j),
                               rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)

    pt = torch.from_numpy(p).requires_grad_(True)
    f_t = tou.ou_nll_init(pt, torch.from_numpy(xbar), torch.from_numpy(xxT),
                          tt, 1e-3)
    (g_t,) = torch.autograd.grad(f_t.sum(), pt)
    f_j, g_j = jax.vmap(jax.value_and_grad(
        lambda pc, a, b: jou.ou_nll_init(pc, a, b, tree, jnp.float32(1e-3))))(
        jnp.asarray(p), jnp.asarray(xbar), jnp.asarray(xxT))
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j),
                               rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-5)


def test_logdet_trace_nonpd_is_inf():
    """A non-PD matrix gives an +inf log-determinant (the line search
    rejects it), a PD one the exact values (tests/test_mstep.py)."""
    from phylo_hmrf_tpu_torch.models.ou import _logdet_trace_solve

    V = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.5], [0.5, 1.0]]])
    S = torch.eye(2).expand(2, 2, 2)
    logdet, trace = _logdet_trace_solve(V, S)
    assert torch.isinf(logdet[0]) and logdet[0] > 0
    np.testing.assert_allclose(float(logdet[1]), np.log(1.75), rtol=1e-6)
    np.testing.assert_allclose(float(trace[1]),
                               np.trace(np.linalg.inv(V[1].numpy())),
                               rtol=1e-6)


def test_host_helpers_are_the_jax_ones(rng, tree):
    """check_params / propagate_mean_guess are copies: equal outputs."""
    from phylo_hmrf_tpu.models import ou as jou
    from phylo_hmrf_tpu_torch.models import ou as tou

    for p in (_params(rng, tree, 1)[0], np.full(tree.n_params, 200.0),
              np.full(tree.n_params, np.nan)):
        assert tou.check_params(p, tree.n_nodes) == jou.check_params(
            p, tree.n_nodes)
    c = rng.random(tree.n_leaves)
    a = tou.propagate_mean_guess(c, tree, np.random.default_rng(5), 0.7,
                                 tree.n_params)
    b = jou.propagate_mean_guess(c, tree, np.random.default_rng(5), 0.7,
                                 tree.n_params)
    np.testing.assert_array_equal(a, b)


def test_minimize_boxed_matches_jax_on_convex(rng):
    """Run to the end on a convex boxed objective (interior optimum), the
    batched solver and the vmapped JAX one reach the same final objective
    within 1e-4 relative."""
    from phylo_hmrf_tpu.ops.lbfgs import minimize_boxed as jax_min
    from phylo_hmrf_tpu_torch.ops.lbfgs import minimize_boxed

    B, P = 5, 6
    c = (rng.random((B, P)) * 8 + 1).astype(np.float32)
    w = (rng.random((B, P)) * 3 + 0.1).astype(np.float32)
    p0 = (rng.random((B, P)) * 9 + 0.5).astype(np.float32)
    _, f_j = jax.vmap(lambda p, cc, ww: jax_min(
        lambda x: 1.0 + jnp.sum(ww * (x - cc) ** 2), p, 1e-16, 100.0, 150))(
        jnp.asarray(p0), jnp.asarray(c), jnp.asarray(w))
    ct, wt = torch.from_numpy(c), torch.from_numpy(w)
    _, f_t = minimize_boxed(
        lambda x: 1.0 + torch.sum(wt * (x - ct) ** 2, dim=-1),
        torch.from_numpy(p0), 1e-16, 100.0, 150)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), 1.0, rtol=1e-4)


def test_minimize_boxed_ou_steps_match_jax(rng, tree, tt):
    """On the OU objective from identical guesses and statistics, the
    solvers agree step for step: after 6 steps the objectives are within
    1e-4 relative (measured ~1e-6). The objective is not convex, and two
    float32 implementations separate after ~10 steps (1e-3 apart at 40,
    sometimes in different local minima), so this is where the port is
    held to JAX's algorithm; its objective and gradient are held to JAX's
    at rtol 1e-5 above."""
    from phylo_hmrf_tpu.models import ou as jou
    from phylo_hmrf_tpu.ops.lbfgs import minimize_boxed as jax_min
    from phylo_hmrf_tpu_torch.models import ou as tou
    from phylo_hmrf_tpu_torch.ops.lbfgs import minimize_boxed

    K = 4
    p0 = _params(rng, tree, K)
    post, obs, obs2, n = _stats(rng, tree, K)
    lo, hi, iters = 1e-16, 100.0, 6

    def one(p0_c, a, b, c):
        return jax_min(lambda p: jou.ou_nll_stats(
            p, a, b, c, tree, jnp.float32(n), jnp.float32(1.0),
            jnp.float32(1e-3)), p0_c, lo, hi, iters)
    _, f_j = jax.vmap(one)(jnp.asarray(p0), jnp.asarray(post),
                           jnp.asarray(obs), jnp.asarray(obs2))
    post_t, obs_t, obs2_t = (torch.from_numpy(a) for a in (post, obs, obs2))
    x_t, f_t = minimize_boxed(
        lambda p: tou.ou_nll_stats(p, post_t, obs_t, obs2_t, tt, float(n),
                                   1.0, 1e-3),
        torch.from_numpy(p0), lo, hi, iters)
    f_j = np.asarray(f_j, np.float64)
    assert (np.abs(f_t.numpy() - f_j) <= 1e-4 * np.abs(f_j)).all(), (
        f_t.numpy(), f_j)
    assert ((x_t >= lo) & (x_t <= hi)).all()


def test_batched_lbfgs_freezes_stopped_rows():
    """Each row stops on its own: solving a batch equals solving each row
    alone (the vmapped while_loop's semantics), rows of very different
    difficulty included."""
    from phylo_hmrf_tpu_torch.ops.lbfgs import minimize_lbfgs

    # row-wise Rosenbrock of different stiffness; the stiff row stalls at
    # its start (every line-search trial overshoots) and must stay frozen
    # there while the others run on
    scales = torch.tensor([1.0, 30.0, 0.01])

    def fn(x):
        return ((1 - x[..., 0]) ** 2
                + scales * 100 * (x[..., 1] - x[..., 0] ** 2) ** 2)

    x0 = torch.tensor([[0.1, 0.2], [-0.5, 0.3], [0.4, 0.1]])
    xb, fb = minimize_lbfgs(fn, x0, 200, tol=1e-7)
    for i in range(3):
        s = scales[i:i + 1]
        xi, fi = minimize_lbfgs(
            lambda x: (1 - x[..., 0]) ** 2
            + s * 100 * (x[..., 1] - x[..., 0] ** 2) ** 2,
            x0[i:i + 1], 200, tol=1e-7)
        np.testing.assert_allclose(xb[i].numpy(), xi[0].numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(fb[i].numpy(), fi[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(xb[[0, 2]].numpy(), np.ones((2, 2)),
                               atol=2e-2)


def test_kmeans_inertia_matches_jax(rng):
    """The two k-means draw different random numbers, so they are compared
    by inertia on well-separated blobs: within 1% of each other."""
    from phylo_hmrf_tpu.ops.kmeans import kmeans as jax_kmeans
    from phylo_hmrf_tpu_torch.ops.kmeans import kmeans

    centers = rng.random((5, 4)) * 10
    X = (centers[rng.integers(0, 5, 3000)]
         + rng.normal(size=(3000, 4)) * 0.3).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    c_t, lab_t, in_t = kmeans(gen, torch.from_numpy(X), 5, n_iters=30,
                              n_init=3, pp_subsample=1000)
    _, _, in_j = jax_kmeans(jax.random.PRNGKey(0), jnp.asarray(X), 5,
                            n_iters=30, n_init=3, pp_subsample=1000)
    assert lab_t.dtype == torch.int32 and c_t.shape == (5, 4)
    np.testing.assert_allclose(float(in_t), float(in_j), rtol=1e-2)
    # deterministic under the same seed
    gen2 = torch.Generator().manual_seed(0)
    c2, _, _ = kmeans(gen2, torch.from_numpy(X), 5, n_iters=30, n_init=3,
                      pp_subsample=1000)
    np.testing.assert_array_equal(c_t.numpy(), c2.numpy())


def test_init_helpers_match_jax(rng, tree):
    """Per-cluster stats (rtol 5e-6, float32 matmuls) and the tree-
    propagated guesses (same adds) against the JAX init helpers; an empty
    cluster included."""
    from phylo_hmrf_tpu.models.hmrf import (
        _init_cluster_stats as j_stats, _init_guess as j_guess)
    from phylo_hmrf_tpu_torch.models.hmrf import (
        _init_cluster_stats, _init_guess)

    K, F, N = 4, tree.n_leaves, 500
    X = rng.normal(size=(N, F)).astype(np.float32)
    labels = rng.integers(0, K, N).astype(np.int32)
    labels[labels == 2] = 0
    for a, b in zip(_init_cluster_stats(torch.from_numpy(X),
                                        torch.from_numpy(labels), K),
                    j_stats(jnp.asarray(X), jnp.asarray(labels), K)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-6,
                                   atol=1e-7)
    centers = rng.normal(size=(K, F)).astype(np.float32)
    rand = rng.random((K, tree.n_params)).astype(np.float32)
    np.testing.assert_array_equal(
        _init_guess(torch.from_numpy(centers), torch.from_numpy(rand), tree,
                    tree.n_params).numpy(),
        np.asarray(j_guess(jnp.asarray(centers), jnp.asarray(rand),
                           tree=tree, n_params=tree.n_params)))

"""The port's exact polish (ops/mincut_kernels.py, ops/maxflow.py) against
the JAX package, brute force and the C++ oracle, on CPU.

K5/K6 run their plain versions here (CPU tensors); the Pallas kernels they
replace run in interpret mode. Inputs are made with numpy from a seed and
handed to both packages. Gates are the JAX package's own
(tests/test_maxflow_tpu.py) unless a test says otherwise.
"""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from phylo_hmrf_tpu import native  # noqa: E402
from phylo_hmrf_tpu.data.regions import (  # noqa: E402
    flat_edge_list, flat_index_order, region_from_samples)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _potts_instance(rng, R, H, W, p_terminal=0.5):
    """Random weighted-Potts cut instances (R, ...): sparse terminal arcs
    and undirected neighbour arcs, 0 on arcs leaving the grid (the
    generator of tests/test_maxflow_tpu.py::test_fused_mincut_matches_jnp)."""
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import ALL_DIRS, _nb, _rev

    excess = (rng.random((R, H, W)) * 2
              * (rng.random((R, H, W)) < p_terminal)).astype(np.float32)
    cap_t = (rng.random((R, H, W)) * 2
             * (rng.random((R, H, W)) < p_terminal)).astype(np.float32)
    caps = np.zeros((R, 8, H, W), np.float32)
    for d in range(4):
        di, dj = ALL_DIRS[d]
        lam = (rng.random((R, H, W)) * 0.5).astype(np.float32)
        if di:
            lam[:, -di:, :] = 0
        if dj > 0:
            lam[:, :, -dj:] = 0
        elif dj < 0:
            lam[:, :, :-dj] = 0
        caps[:, d] += lam
        caps[:, _rev(d)] += _nb(_t(lam), _rev(d), 0.0).numpy()
    return excess, cap_t, caps


def _cut_cost(side, excess, cap_t, caps):
    """Source-side pixels pay their sink arcs, sink-side ones their source
    arcs; arcs from the source side to the sink side pay their capacity."""
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import _nb

    side = _t(side)
    c = float(torch.where(side, _t(cap_t), _t(excess)).double().sum())
    for d in range(8):
        nb_side = _nb(side, d, True)
        c += float((_t(caps)[:, d].double() * (side & ~nb_side)).sum())
    return c


def _relabelled_state(rng, R=2, H=16, W=128):
    """A min-cut state at iteration 0 of the fused loop: the instance's
    excess, sink and neighbour capacities, heights from the global
    relabel (the BFS fixpoint)."""
    from phylo_hmrf_tpu_torch.ops.maxflow import _bfs_fixpoint

    excess, cap_t, caps = _potts_instance(rng, R, H, W)
    n = H * W + 2
    d0 = torch.where(_t(cap_t) > 1e-6, 1, n).to(torch.int32)
    h = _bfs_fixpoint(d0, _t(caps), n, True, None).numpy()
    return excess, h, cap_t, caps, n


# ------------------------------------------------------------------ K5 --

@pytest.mark.parametrize("n_inner", [1, 4])
def test_k5_plain_matches_pr_iterations_pallas(n_inner):
    """K5's plain version vs pr_iterations_pallas(interpret=True) from a
    BFS-relabelled state: heights identical; e, cap_t and caps within atol
    1e-6 (same operations in the same order; the bound leaves room for XLA
    fusing the interpreted kernel's elementwise chain differently)."""
    from phylo_hmrf_tpu.ops.mincut_pallas import pr_iterations_pallas
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import pr_iterations

    e, h, cap_t, caps, n = _relabelled_state(np.random.default_rng(5))
    assert (h < n).any() and (h > 1).any()   # a real height field
    want = pr_iterations_pallas(jnp.asarray(e), jnp.asarray(h),
                                jnp.asarray(cap_t), jnp.asarray(caps),
                                jnp.int32(n), n_inner=n_inner,
                                interpret=True)
    got, _ = pr_iterations(*(_t(a) for a in (e, h, cap_t, caps)), n,
                           n_inner=n_inner)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=0, atol=1e-6)
    assert not np.array_equal(got[0].numpy(), e)    # flow moved


# ------------------------------------------------------------------ K6 --

@pytest.mark.parametrize("n_inner", [3, 8])
def test_k6_plain_matches_bfs_sweeps_pallas(n_inner):
    """K6's plain version vs bfs_sweeps_pallas(interpret=True): identical
    distances after ``n_inner`` sweeps from the sink seed."""
    from phylo_hmrf_tpu.ops.mincut_pallas import bfs_sweeps_pallas
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import bfs_sweeps

    rng = np.random.default_rng(6)
    _, cap_t, caps = _potts_instance(rng, 2, 16, 128, p_terminal=0.05)
    n = 16 * 128 + 2
    d0 = np.where(cap_t > 1e-6, 1, n).astype(np.int32)
    want = np.asarray(bfs_sweeps_pallas(jnp.asarray(d0), jnp.asarray(caps),
                                        jnp.int32(n), n_inner=n_inner,
                                        interpret=True))
    from phylo_hmrf_tpu_torch.ops.loops import new_loop
    d, loop = bfs_sweeps(_t(d0), _t(caps), n, n_inner=n_inner,
                         loop=new_loop(torch.device("cpu")))
    np.testing.assert_array_equal(d.numpy(), want)
    assert int(loop[0]) == 1 and (want < n).sum() > (d0 < n).sum()


# ------------------------------------------------------------ grid cut --

def test_grid_mincut_matches_bruteforce():
    """3 x 4 grids: the cut cost is the minimum over all 2^12 cuts."""
    from phylo_hmrf_tpu_torch.ops.maxflow import grid_mincut

    rng = np.random.default_rng(7)
    H, W = 3, 4
    excess, cap_t, caps = _potts_instance(rng, 6, H, W, p_terminal=1.0)
    excess *= 2
    side = grid_mincut(_t(excess), _t(cap_t), _t(caps)).numpy()
    for r in range(6):
        one = (excess[r:r + 1], cap_t[r:r + 1], caps[r:r + 1])
        best = min(
            _cut_cost(np.asarray(bits, bool).reshape(1, H, W), *one)
            for bits in itertools.product([False, True], repeat=H * W))
        assert _cut_cost(side[r:r + 1], *one) <= best + 1e-4, r


def test_grid_mincut_matches_jax():
    """Random weighted-Potts instances, batched (R=3): the port's cut has
    the cost of the JAX jnp push-relabel's per region, rel 1e-5 (cuts may
    differ where several minimum cuts exist; the cost may not). The move
    statistics count the work."""
    from phylo_hmrf_tpu.ops.maxflow_tpu import grid_mincut as jax_cut
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, grid_mincut

    rng = np.random.default_rng(8)
    excess, cap_t, caps = _potts_instance(rng, 3, 16, 128)
    stats = CutStats()
    side = grid_mincut(_t(excess), _t(cap_t), _t(caps), stats=stats).numpy()
    assert stats.moves == 1 and stats.capped == 0
    assert stats.pr_iterations % 4 == 0 and stats.pr_iterations > 0
    assert stats.bfs_sweeps % 8 == 0 and stats.bfs_sweeps > 0
    for r in range(3):
        one = (excess[r], cap_t[r], caps[r])
        want = np.asarray(jax_cut(*(jnp.asarray(a) for a in one)))
        one_b = tuple(a[None] for a in one)
        assert _cut_cost(side[r:r + 1], *one_b) == pytest.approx(
            _cut_cost(want[None], *one_b), rel=1e-5)


# --------------------------------------------------------------- moves --

def _brute_energy(lab, unary, beta):
    H, W = lab.shape
    e = float(np.sum(unary[np.arange(H)[:, None], np.arange(W)[None], lab]))
    e += beta * float((lab[:, :-1] != lab[:, 1:]).sum()
                      + (lab[:-1] != lab[1:]).sum()
                      + (lab[:-1, :-1] != lab[1:, 1:]).sum()
                      + (lab[:-1, 1:] != lab[1:, :-1]).sum())
    return e


def test_moves_with_dominance_freezing_exact():
    """Strong unaries (freezing fires on most pixels): one expansion move
    and one swap move each reach the brute-force minimum over their move
    space on 3 x 3 grids (tests/test_maxflow_tpu.py::
    test_dominance_freezing_exact)."""
    from phylo_hmrf_tpu_torch.ops.maxflow import (
        _expansion_graph, _expansion_move_batch, _incident_wsum,
        _swap_move_batch)

    rng = np.random.default_rng(9)
    H = W = 3
    K, beta = 3, 0.7
    wmaps = torch.ones((1, 4, H, W))
    mask = torch.ones((1, H, W), dtype=torch.bool)
    wsum = _incident_wsum(wmaps, beta)
    froze = 0
    for trial in range(6):
        unary = rng.random((H, W, K)).astype(np.float32)
        strong = rng.random((H, W)) < 0.6
        fav = rng.integers(0, K, (H, W))
        for k in range(K):
            unary[..., k] = np.where(strong & (fav == k), unary[..., k],
                                     unary[..., k] + 50.0 * strong)
        labels0 = rng.integers(0, K, (H, W)).astype(np.int32)
        unary_k = _t(np.transpose(unary, (2, 0, 1))[None])
        lab_t = _t(labels0[None])

        alpha = int(rng.integers(0, K))
        out, nch = _expansion_move_batch(lab_t, unary_k, wmaps, mask, alpha,
                                         beta, wsum, max_sweeps=3000)
        out = out[0].numpy()
        assert int(nch[0]) == int((out != labels0).sum())
        movable = [(i, j) for i in range(H) for j in range(W)
                   if labels0[i, j] != alpha]
        best = np.inf
        for bits in itertools.product([0, 1], repeat=len(movable)):
            lab = labels0.copy()
            for (i, j), s in zip(movable, bits):
                if s:
                    lab[i, j] = alpha
            best = min(best, _brute_energy(lab, unary, beta))
        assert _brute_energy(out, unary, beta) == pytest.approx(best,
                                                                abs=1e-3)
        in_play = _expansion_graph(lab_t, unary_k, wmaps, mask, alpha, beta,
                                   wsum)[3]
        froze += int(((lab_t != alpha) & ~in_play).sum())

        out2, _ = _swap_move_batch(lab_t, unary_k, wmaps, mask, 0, 1, beta,
                                   wsum, max_sweeps=3000)
        out2 = out2[0].numpy()
        movable = [(i, j) for i in range(H) for j in range(W)
                   if labels0[i, j] in (0, 1)]
        best = np.inf
        for bits in itertools.product([0, 1], repeat=len(movable)):
            lab = labels0.copy()
            for (i, j), s in zip(movable, bits):
                lab[i, j] = 0 if s else 1
            best = min(best, _brute_energy(lab, unary, beta))
        assert _brute_energy(out2, unary, beta) == pytest.approx(best,
                                                                 abs=1e-3)
    assert froze > 0


def _region_batch(rng, R=3, H0=16, K=4, beta1=0.5):
    """R diagonal regions with random unaries (K-major) and warm labels."""
    regions, unaries, warms = [], [], []
    for _ in range(R):
        rows, _ = flat_index_order(H0, H0, True)
        vals = (rng.random((rows.shape[0], 3)) + 0.1).astype(np.float32)
        reg = region_from_samples(vals, H0, H0, True, pad_h=4, pad_w=4)
        u = np.zeros((K,) + reg.shape, np.float32)
        u[:, reg.flat_rows, reg.flat_cols] = (
            rng.random((reg.n_samples, K)) * 2).T
        regions.append(reg)
        unaries.append(u)
        warms.append(reg.labels_to_grid(
            rng.integers(0, K, reg.n_samples).astype(np.int32)))
    wm = np.stack([np.exp(-beta1 * r.dmaps).astype(np.float32)
                   for r in regions])
    mask = np.stack([r.mask for r in regions])
    return regions, np.stack(unaries), wm, mask, np.stack(warms)


@pytest.mark.parametrize("method", ["expansion", "swap"])
def test_move_graphs_match_jax(method):
    """The move graphs (t-links, neighbour arcs, the in-play set after
    dominance freezing) and the energy/histogram of the port equal the
    JAX package's on the same labels: identical sets, capacities within
    2e-6 relative (float32 adds in the same order)."""
    from phylo_hmrf_tpu.ops import maxflow_tpu as jm
    from phylo_hmrf_tpu_torch.ops import maxflow as tm

    rng = np.random.default_rng(10)
    _, unary_k, wm, mask, warm = _region_batch(rng, R=2)
    labels = np.where(mask, warm, 0).astype(np.int32)
    beta = 1.3
    wsum_t = tm._incident_wsum(_t(wm), beta)
    wsum_j = jm._WSUM_BATCH(jnp.asarray(wm), jnp.float32(beta))
    np.testing.assert_allclose(wsum_t.numpy(), np.asarray(wsum_j), rtol=1e-6)
    for mv in ((0, 2), (3, 1)) if method == "swap" else ((1,), (3,)):
        if method == "swap":
            got = tm._swap_graph(_t(labels), _t(unary_k), _t(wm), _t(mask),
                                 *mv, beta, wsum_t)
            want = jax.vmap(lambda l, u, w, m, s: jm._swap_graph(
                l, u, w, m, mv[0], mv[1], jnp.float32(beta), s))(
                jnp.asarray(labels), jnp.asarray(unary_k), jnp.asarray(wm),
                jnp.asarray(mask), wsum_j)
        else:
            got = tm._expansion_graph(_t(labels), _t(unary_k), _t(wm),
                                      _t(mask), mv[0], beta, wsum_t)
            want = jax.vmap(lambda l, u, w, m, s: jm._expansion_graph(
                l, u, w, m, mv[0], jnp.float32(beta), s))(
                jnp.asarray(labels), jnp.asarray(unary_k), jnp.asarray(wm),
                jnp.asarray(mask), wsum_j)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert got[3].any()
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                       atol=2e-6)
    e_t, hist_t = tm._energy_hist(_t(labels), _t(unary_k), _t(wm), _t(mask),
                                  beta, 4)
    e_j, hist_j = jm._energy_hist(jnp.asarray(labels), jnp.asarray(unary_k),
                                  jnp.asarray(wm), jnp.asarray(mask),
                                  jnp.float32(beta), n_states=4)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-6)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))


@pytest.mark.parametrize("method", ["expansion", "swap"])
def test_exact_labels_batched_matches_jax(method):
    """R=3 regions of 16 x 16, K=4: the port's exact labeling reaches the
    JAX package's energy or better, per region (E <= E_jax + 1e-4 +
    1e-5 |E_jax|; both are exact move-making from starts that agree to
    near-ties)."""
    from phylo_hmrf_tpu.ops.maxflow_tpu import exact_labels_batched as jx
    from phylo_hmrf_tpu_torch.ops.maxflow import (CutStats, _energy_hist,
                                                  exact_labels_batched)

    rng = np.random.default_rng(11)
    _, unary_k, wm, mask, warm = _region_batch(rng)
    stats = CutStats()
    got = exact_labels_batched(_t(unary_k), _t(wm), _t(mask), _t(warm), 1.0,
                               4, max_cycles=3, method=method, stats=stats)
    want = np.array(jx(jnp.asarray(unary_k), jnp.asarray(wm),
                         jnp.asarray(mask), jnp.asarray(warm), 1.0, 4,
                         max_cycles=3, method=method))
    assert stats.moves > 0 and stats.capped == 0
    e_t, _ = _energy_hist(got, _t(unary_k), _t(wm), _t(mask), 1.0, 4)
    e_j, _ = _energy_hist(_t(want), _t(unary_k), _t(wm), _t(mask), 1.0, 4)
    for a, b in zip(e_t.tolist(), e_j.tolist()):
        assert a <= b + 1e-4 + 1e-5 * abs(b), (a, b)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_expansion_polish_matches_cpp_oracle():
    """The port's expansion labeling (one region) against the C++
    alpha-expansion from the same start: energy within the reference's
    slack (tests/test_maxflow_tpu.py::test_expansion_optimize_matches_cpp)."""
    from phylo_hmrf_tpu_torch.ops.maxflow import (_optimize_batched,
                                                  _start_batch)

    rng = np.random.default_rng(12)
    (reg,), unary_k, wm, mask, warm = _region_batch(rng, R=1, H0=20)
    start = _start_batch(_t(unary_k), _t(wm), _t(mask), _t(warm), 1.0, 60)
    out = _optimize_batched(_t(unary_k), _t(wm), _t(mask), start, 1.0, 4,
                            "expansion", max_cycles=4)
    edges = flat_edge_list(reg)
    w = np.exp(-0.5 * edges[:, 2])
    ei = edges[:, :2].astype(np.int64)
    unary_flat = unary_k[0][:, reg.flat_rows, reg.flat_cols].T.astype(
        np.float64)
    start_flat = reg.labels_to_flat(start[0].numpy()).astype(np.int32)
    cpp = native.potts_expansion(ei, w, unary_flat, 1.0, start_flat, 100)
    e_cpp = native.potts_energy(ei, w, unary_flat, 1.0, cpp)
    e_port = native.potts_energy(ei, w, unary_flat, 1.0,
                                 reg.labels_to_flat(out[0].numpy()))
    assert e_port <= e_cpp + 1e-6 + 1e-4 * abs(e_cpp), (e_port, e_cpp)


# ---------------------------------------------------------- boundaries --

def test_cpu_wrappers_run_plain_and_count_no_launch():
    """On CPU tensors K5/K6 run their plain versions into the buffers
    given (the inputs stay as they were) and never touch the kernel
    library: the launch counters stay where they were."""
    from phylo_hmrf_tpu_torch.ops import mincut_kernels as mk

    before = (mk.pr_iterations.launches, mk.bfs_sweeps.launches)
    e, h, cap_t, caps, n = _relabelled_state(np.random.default_rng(13),
                                             R=1, H=8, W=16)
    state = [_t(a.copy()) for a in (e, h, cap_t, caps)]
    want = mk.pr_iterations_plain(*state, n, 2)
    out = tuple(torch.empty_like(t) for t in state)
    got, _ = mk.pr_iterations(*state, n, n_inner=2, out=out)
    assert all(g is o for g, o in zip(got, out))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(state, (e, h, cap_t, caps)):
        np.testing.assert_array_equal(a.numpy(), b)
    from phylo_hmrf_tpu_torch.ops.loops import new_loop
    d, loop = mk.bfs_sweeps(_t(h), got[3], n, n_inner=8,
                            loop=new_loop(torch.device("cpu")))
    assert int(loop[0]) in (0, 1) and int(loop[3]) == 8
    np.testing.assert_array_equal(h, _relabelled_state(
        np.random.default_rng(13), R=1, H=8, W=16)[1])
    assert (mk.pr_iterations.launches, mk.bfs_sweeps.launches) == before
    with pytest.raises(ValueError):
        mk.bfs_sweeps(d, got[3], n, n_inner=9)
    with pytest.raises(ValueError):
        mk.pr_iterations(*state, n, n_inner=5)


def test_cpu_wrapper_flags_match_any_tests():
    """The loop words of the wrappers (their plain versions on the CPU)
    are the loop tests the plain path reads with ``torch.any``: K6's GO
    is set iff a distance changed, K5's iff a node is still active
    (e > EPS, h < n), call after call until the fixpoint and the cut end
    (where neither is set), and COUNT holds the sweeps / iterations
    run."""
    from phylo_hmrf_tpu_torch.ops import loops
    from phylo_hmrf_tpu_torch.ops import mincut_kernels as mk

    e, h, cap_t, caps, n = _relabelled_state(np.random.default_rng(14),
                                             R=2, H=6, W=10)
    loop = loops.new_loop(torch.device("cpu"))
    d = torch.where(_t(cap_t) > mk.EPS, 1, n).to(torch.int32)
    seen = set()
    for k in range(1, n):
        new, _ = mk.bfs_sweeps(d, _t(caps), n, n_inner=3, loop=loop)
        want = bool(torch.any(new != d))
        assert bool(loop[loops.LOOP_GO]) == want
        assert int(loop[loops.LOOP_COUNT]) == 3 * k
        seen.add(want)
        d = new
        if not want:
            break
    assert seen == {True, False}
    state = tuple(_t(a) for a in (e, h, cap_t, caps))
    loop = loops.new_loop(torch.device("cpu"))
    seen = set()
    for _ in range(500):
        state, _ = mk.pr_iterations(*state, n, n_inner=4, loop=loop)
        want = bool(torch.any((state[0] > mk.EPS) & (state[1] < n)))
        assert bool(loop[loops.LOOP_GO]) == want
        seen.add(want)
        if not want:
            break
    assert seen == {True, False}


def test_grid_mincut_wrapper_path_is_the_plain_path():
    """grid_mincut through the wrappers (their plain versions here, with
    the kernel path's buffers and flags) against ``plain=True`` (the
    ``torch.any`` tests): the same side, bitwise, and the same work,
    host reads included."""
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, grid_mincut

    excess, cap_t, caps = _potts_instance(np.random.default_rng(15), 2, 12,
                                          40)
    runs = []
    for plain in (False, True):
        stats = CutStats()
        side = grid_mincut(_t(excess), _t(cap_t), _t(caps), plain=plain,
                           stats=stats)
        runs.append((side, stats))
    (side_w, st_w), (side_p, st_p) = runs
    assert torch.equal(side_w, side_p)
    assert st_w == st_p and st_w.host_reads > 2 and st_w.capped == 0
    assert st_w.host_reads == (1 + st_w.pr_iterations // 4
                               + st_w.bfs_sweeps // 8)

"""The loop protocol behind the port's on-device loops of the exact cut and
of ICM (``ops/loops.py``, ``csrc/loops.cu``), on CPU.

The card's graphs cannot run on the CPU, so these tests hold what they
rest on: K2, K5 and K6 (their plain versions, with the loop word the
kernels get) pass their carry through bitwise once their loop has
stopped, and the graphs' bodies run a fixed number of times, no word
tested between them, give bitwise the labels and the counts of the
host-read loops (``grid_mincut_host``, ``icm_kmajor``'s host loop),
which the JAX package's loops match. The unrolled programs mirror the
node order of ``csrc/loops.cu``: the one-thread begin / cond nodes and
the seed and height-max kernels are written out here in tensor code.
Inputs are made with numpy from seeds.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from phylo_hmrf_tpu.data.regions import (  # noqa: E402
    flat_index_order, region_from_samples)

torch.set_num_threads(1)

from phylo_hmrf_tpu_torch.ops import loops  # noqa: E402
from phylo_hmrf_tpu_torch.ops import mincut_kernels as mk  # noqa: E402
from phylo_hmrf_tpu_torch.ops.icm_kernels import (  # noqa: E402
    icm_kmajor, icm_sweep_pair)

GO, COUNT, LIMIT, LAST = (loops.LOOP_GO, loops.LOOP_COUNT, loops.LOOP_LIMIT,
                          loops.LOOP_LAST)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cut_instance(seed, R=2, H=8, W=24, p_terminal=0.4):
    """A random weighted-Potts cut (R, H, W): sparse terminal arcs,
    undirected neighbour arcs, 0 on arcs leaving the grid."""
    rng = np.random.default_rng(seed)
    excess = (rng.random((R, H, W)) * 2
              * (rng.random((R, H, W)) < p_terminal)).astype(np.float32)
    cap_t = (rng.random((R, H, W)) * 2
             * (rng.random((R, H, W)) < p_terminal)).astype(np.float32)
    caps = np.zeros((R, 8, H, W), np.float32)
    for d in range(4):
        di, dj = mk.ALL_DIRS[d]
        lam = (rng.random((R, H, W)) * 0.5).astype(np.float32)
        if di:
            lam[:, -di:, :] = 0
        if dj > 0:
            lam[:, :, -dj:] = 0
        elif dj < 0:
            lam[:, :, :-dj] = 0
        caps[:, d] += lam
        caps[:, mk._rev(d)] += mk._nb(_t(lam), mk._rev(d), 0.0).numpy()
    return _t(excess), _t(cap_t), _t(caps)


def _icm_instance(seed, R=2, H0=14, K=4):
    """Random K-major ICM operands of R regions (triangles of H0 bins,
    masked as the model masks them)."""
    rng = np.random.default_rng(seed)
    regions = []
    for _ in range(R):
        rows, _ = flat_index_order(H0, H0, True)
        vals = rng.normal(size=(rows.shape[0], 3)).astype(np.float32)
        regions.append(region_from_samples(vals, H0, H0, True, pad_h=8,
                                           pad_w=8))
    H, W = regions[0].shape
    w = np.stack([np.exp(-0.5 * r.dmaps) for r in regions]).astype(
        np.float32)
    mask = np.stack([r.mask for r in regions])
    unary = (rng.random((R, K, H, W)) * 3).astype(np.float32)
    init = rng.integers(0, K, (R, H, W)).astype(np.int32)
    return _t(unary), _t(w), _t(mask), _t(init)


# ------------------------------------------------- stopped steps pass --

def _stopped(limit=50, count=12, last=1):
    loop = loops.new_loop(CPU, limit)
    loop[GO], loop[COUNT], loop[LAST] = 0, count, last
    return loop


@pytest.mark.parametrize("kernel", ["K5", "K6", "K2"])
def test_stopped_step_passes_carry_through(kernel):
    """A step whose loop word says the loop has stopped (GO 0) returns
    its carry bitwise and leaves the word as it was; the same step with
    GO set runs (the plain result) and counts."""
    excess, cap_t, caps = _cut_instance(1)
    n = excess.shape[1] * excess.shape[2] + 2
    if kernel == "K5":
        carry = (excess, torch.zeros_like(excess, dtype=torch.int32), cap_t,
                 caps)

        def step(loop):
            return mk.pr_iterations(*carry, n, n_inner=4, loop=loop)[0]
        ran = mk.pr_iterations_plain(*carry, n, 4)
        step_size = 4
    elif kernel == "K6":
        carry = (torch.where(cap_t > mk.EPS, 1, n).to(torch.int32),)

        def step(loop):
            return (mk.bfs_sweeps(carry[0], caps, n, n_inner=8,
                                  loop=loop)[0],)
        ran = (mk.bfs_sweeps_plain(carry[0], caps, n, 8),)
        step_size = 8
    else:
        unary, w, mask, init = _icm_instance(2)
        carry = (torch.where(mask, init, 0).to(torch.int32),)

        def step(loop):
            return (icm_sweep_pair(carry[0], unary, w, mask.to(torch.int32),
                                   1.0, loop=loop),)
        ran = (icm_sweep_pair(carry[0], unary, w, mask.to(torch.int32), 1.0),)
        step_size = 2
    assert not all(torch.equal(a, b) for a, b in zip(ran, carry))

    loop = _stopped()
    keep = loop.clone()
    for a, b in zip(step(loop), carry):
        assert torch.equal(a, b)
    assert torch.equal(loop, keep)

    loop = loops.new_loop(CPU, 50)
    for a, b in zip(step(loop), ran):
        assert torch.equal(a, b)
    assert int(loop[COUNT]) == step_size and int(loop[LAST]) == 1
    assert int(loop[GO]) == 1


# ----------------------------------------- the graphs' bodies unrolled --

def _bfs_begin(bfs, gate, n):
    """csrc/loops.cu::bfs_begin_kernel."""
    go = 1 if gate is None else int(gate[GO] != 0)
    bfs.copy_(loops.new_loop(CPU, n))
    bfs[GO], bfs[LAST] = go, go


def _bfs_bodies(d, caps, n, bfs, bodies):
    """``bodies`` bodies of the BFS WHILE (K6 d0 -> d1, K6 d1 -> d0) with
    no test of the word between them; returns d0."""
    d0, d1 = d, torch.empty_like(d)
    for _ in range(bodies):
        mk.bfs_sweeps(d0, caps, n, n_inner=8, out=d1, loop=bfs)
        mk.bfs_sweeps(d1, caps, n, n_inner=8, out=d0, loop=bfs)
    return d0


def _graph_cut(excess0, cap_t0, caps0, max_sweeps, periods, bodies):
    """The min-cut graph of csrc/loops.cu with every WHILE unrolled to a
    fixed count (``periods`` cut bodies, ``bodies`` BFS bodies a
    fixpoint). Returns (side, CutStats from the words read at the end of
    each loop)."""
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats

    R, H, W = excess0.shape
    n = H * W + 2
    a = [excess0.clone(), torch.zeros((R, H, W), dtype=torch.int32),
         cap_t0.clone(), caps0.clone()]
    b = [torch.empty_like(t) for t in a]
    pr, bfs = loops.new_loop(CPU, max_sweeps), loops.new_loop(CPU, n)
    pr[GO] = int(torch.any(excess0 > mk.EPS))     # the host's staging
    # cut_begin_kernel
    pr[LAST] = pr[GO]
    pr[GO] = int(pr[GO] != 0 and 0 < max_sweeps)
    sweeps = torch.zeros((), dtype=torch.int64)
    for _ in range(periods):
        # the relabel: seed, the BFS fixpoint (gated by the cut's word),
        # the height max (gated too)
        d = torch.where(a[2] > mk.EPS, 1, n).to(torch.int32)
        _bfs_begin(bfs, pr, n)
        d = _bfs_bodies(d, a[3], n, bfs, bodies)
        sweeps += bfs[COUNT]
        a[1] = torch.where(pr[GO] != 0, torch.maximum(a[1], d), a[1])
        for _ in range(4):        # 8 K5 launches, A -> B -> A
            mk.pr_iterations(*a, n, n_inner=4, out=b, loop=pr)
            mk.pr_iterations(*b, n, n_inner=4, out=a, loop=pr)
    d = torch.where(a[2] > mk.EPS, 1, n).to(torch.int32)
    _bfs_begin(bfs, None, n)
    d = _bfs_bodies(d, a[3], n, bfs, bodies)
    sweeps += bfs[COUNT]
    stats = CutStats(moves=1, pr_iterations=int(pr[COUNT]),
                     bfs_sweeps=int(sweeps),
                     capped=int(pr[GO] == 0 and pr[LAST] != 0))
    # the words say both loops have ended
    assert int(pr[GO]) == 0 and int(bfs[GO]) == 0
    return d >= n, stats


@pytest.mark.parametrize("seed,max_sweeps", [(0, 3000), (1, 3000),
                                             (2, 3000), (3, 3000), (4, 10)])
def test_fixed_periods_driver_matches_host_loop(seed, max_sweeps):
    """The cut graph's bodies run a fixed number of times (more than the
    loops need; the launches after a stop pass their carry through, a
    relabel on a stopped cut changes nothing): bitwise the side and the
    CutStats counts of ``grid_mincut_host`` (host reads aside), on random
    graphs of 4 seeds and on one capped by max_sweeps = 10."""
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, grid_mincut_host

    excess0, cap_t0, caps0 = _cut_instance(seed)
    R, H, W = excess0.shape
    want_stats = CutStats()
    want = grid_mincut_host(excess0, cap_t0, caps0, max_sweeps,
                            stats=want_stats)
    assert (want_stats.capped == 1) == (max_sweeps == 10)
    periods = want_stats.pr_iterations // 32 + 2
    bodies = (H * W + 2) // 16 + 1      # covers any fixpoint (k < n)
    got, got_stats = _graph_cut(excess0, cap_t0, caps0, max_sweeps, periods,
                                bodies)
    assert torch.equal(got, want)
    assert got_stats == dataclasses.replace(want_stats, host_reads=0)


def _graph_icm(unary, w, mask, init, beta, max_sweeps, pairs):
    """The ICM graph of csrc/loops.cu with its WHILE unrolled to ``pairs``
    bodies of two K2 pairs; returns (labels, the loop word)."""
    lab = [torch.where(mask, init, 0).to(torch.int32), None]
    loop = loops.new_loop(CPU, max_sweeps)
    loop[GO] = int(0 < max_sweeps)      # icm_begin_kernel
    mask_i = mask.to(torch.int32)
    for _ in range(pairs):
        lab[1] = icm_sweep_pair(lab[0], unary, w, mask_i, beta, loop=loop)
        lab[0] = icm_sweep_pair(lab[1], unary, w, mask_i, beta, loop=loop)
    return lab[0], loop


@pytest.mark.parametrize("seed,max_sweeps", [(0, 60), (1, 60), (2, 60),
                                             (3, 60), (4, 5), (5, 1)])
def test_fixed_pairs_driver_matches_icm(seed, max_sweeps):
    """The ICM graph's bodies run a fixed number of times: bitwise the
    labels of the host loop of ``icm_kmajor`` and of the JAX
    ``icm_pallas`` (interpret mode), with the sweeps counted as both
    count them, an odd max_sweeps overshot by one sweep."""
    from phylo_hmrf_tpu.ops.icm_pallas import icm_pallas

    unary, w, mask, init = _icm_instance(seed)
    want = icm_kmajor(unary, w, mask, init, 1.2, max_sweeps)
    got, loop = _graph_icm(unary, w, mask, init, 1.2, max_sweeps,
                           max_sweeps // 2 + 3)
    assert torch.equal(got, want)
    assert int(loop[GO]) == 0
    sweeps = int(loop[COUNT])
    assert sweeps % 2 == 0 and sweeps <= max_sweeps + 1
    if max_sweeps % 2:
        assert sweeps == max_sweeps + 1 or int(loop[LAST]) == 0
    jx = np.asarray(icm_pallas(None, jnp.asarray(w.numpy()),
                               jnp.asarray(mask.numpy()),
                               jnp.asarray(init.numpy()), 1.2, max_sweeps,
                               interpret=True,
                               unary_k=jnp.asarray(unary.numpy())))
    m = mask.numpy()
    np.testing.assert_array_equal(got.numpy()[m], jx[m])


# ------------------------------------------ the move loop, one read a cycle --

@pytest.mark.parametrize("method", ["expansion", "swap"])
def test_optimize_batched_matches_jax(method):
    """``_optimize_batched`` (its host reads now one before the first
    cycle and one a cycle, the loops' on top on this route) equals the
    JAX ``_optimize_batched(use_pallas=False)`` label for label, from the
    same start, on a batch of two regions; the host reads are 1 + cycles
    + the loops' tests."""
    from phylo_hmrf_tpu.ops.maxflow_tpu import _optimize_batched as jx
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, _optimize_batched

    unary, w, mask, init = _icm_instance(7, R=2, H0=16, K=4)
    stats = CutStats()
    got = _optimize_batched(unary, w, mask, init, 1.0, 4, method, 3,
                            stats=stats)
    want = np.asarray(jx(jnp.asarray(unary.numpy()), jnp.asarray(w.numpy()),
                         jnp.asarray(mask.numpy()),
                         jnp.asarray(init.numpy()), 1.0, 4, method, 3,
                         use_pallas=False))
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats.moves > 0 and (got != init)[mask].any()
    loop_reads = stats.moves + stats.pr_iterations // 4 \
        + stats.bfs_sweeps // 8
    cycles = stats.host_reads - loop_reads - 1
    assert 1 <= cycles <= 3

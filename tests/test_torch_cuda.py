"""The port's CUDA kernels against their plain PyTorch versions, on the
card (needs an NVIDIA GPU with sm_90a and nvcc; skipped without CUDA).

Run on a GPU machine: ``python -m pytest tests/test_torch_cuda.py -q
--noconftest``.
Shapes: a small ragged grid (H and W of no tile multiple) and the chr21
cell (R=1, K=10, H=672, W=768, F=4), for K1-K4 also the chr21 region at
K=30, for K7/K8 also the spatial fit's 24 x 768 off-diagonal block over 4
shards and 3 shards of 11 rows, for K3/K4 also two ragged regions (R=2)
and random edge shapes (F=1, F=8, K=32, an empty region). K5/K6 run on the graph of a real expansion
move (the one with the most pixels in play) of the K1-K3 start; K1, K2,
K5 and K6 also on random instances whose shapes put pixels on every kind
of tile edge.
"""

import numpy as np
import pytest
import torch

from phylo_hmrf_tpu_torch.config import SMALL_EPS

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phylo_hmrf_tpu_torch import _build
    _build.load()
    return torch.device("cuda")


def _inputs(dev, shape):
    from phylo_hmrf_tpu_torch.data.regions import region_from_samples
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    if shape == "chr21":
        _, region, means, covs, warm, _ = chr21_problem(0)
    elif shape == "k30":
        _, region, means, covs, warm, _ = chr21_problem(0, K=30)
    else:
        # 23 x 37 grid: no row or column tile divides it
        _, r0, means, covs, _, _ = chr21_problem(0, h0=23, K=5)
        rng = np.random.default_rng(1)
        vals = r0.flat_values()
        region = region_from_samples(vals, 23, 23, True, pad_h=1, pad_w=37)
        warm = rng.integers(0, 5, region.n_samples).astype(np.int32)
    return kernel_inputs(region, means, covs, warm, dev)


SHAPES = ["ragged", "chr21"]


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_kernel_matches_plain(dev, shape):
    """8 sweeps at T=1: rtol 2e-4, atol 1e-6 (tests/test_mf_pallas.py;
    expf and the K-sum order differ from PyTorch's by an ulp)."""
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        mean_field_kmajor, mf_sweeps, mf_sweeps_plain)

    x = _inputs(dev, shape)
    n0 = mf_sweeps.launches
    got = mf_sweeps(x["q0"], x["base"], x["w"], 1.0, 0.5, 1.0, n_inner=8)
    want = mf_sweeps_plain(x["q0"], x["base"], x["w"], 1.0, 0.5, 1.0, 8)
    torch.cuda.synchronize()
    assert mf_sweeps.launches - n0 == 1     # one launch per temperature
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6)
    lab = mean_field_kmajor(x["unary_k"], x["w"], 1.0)
    lab_p = mean_field_kmajor(x["unary_k"], x["w"], 1.0, plain=True)
    assert (lab == lab_p).float().mean().item() > 0.999


@pytest.mark.parametrize("shape", SHAPES + ["k30"])
def test_k1_tile_kernel_matches_chained(dev, shape):
    """The K1 tile kernel for every n_inner 1..8: bitwise equal to n_inner
    launches of the one-sweep kernel, within rtol 2e-4, atol 1e-6 of the
    plain version, in the plan's launches (1 per temperature at K <= 10,
    2 at K = 30), q untouched."""
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        mf_sweeps, mf_sweeps_chained, mf_sweeps_plain, mf_tile_plan)

    x = _inputs(dev, shape)
    K = x["q0"].shape[1]
    keep = x["q0"].clone()
    args = (x["q0"], x["base"], x["w"], 0.5, 0.5, 1.0)
    for n_inner in range(1, 9):
        n0 = mf_sweeps.launches
        got = mf_sweeps(*args, n_inner=n_inner)
        assert mf_sweeps.launches - n0 == mf_tile_plan(K, n_inner).launches
        assert torch.equal(got, mf_sweeps_chained(*args, n_inner=n_inner))
        torch.testing.assert_close(got, mf_sweeps_plain(*args, n_inner),
                                   rtol=2e-4, atol=1e-6)
    assert mf_tile_plan(K, 8).launches == (1 if K <= 10 else 2)
    assert torch.equal(x["q0"], keep)


@pytest.mark.parametrize("shape", SHAPES + ["k30"])
def test_k2_kernel_matches_plain(dev, shape):
    """The sweep pair at row parities 0 and 1 in one launch: labels
    identical to the 8 chained phase launches and to the plain version
    (the kernel adds and multiplies in the plain version's order, no FMA),
    the changed flag that of the labels; the whole ICM loop identical."""
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (
        icm_kmajor, icm_sweep_pair, icm_sweep_pair_chained)
    from phylo_hmrf_tpu_torch.ops.loops import LOOP_GO, new_loop

    x = _inputs(dev, shape)
    lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32).contiguous()
    args = (lab0, x["unary_k"], x["w"], x["mask_i"], 1.0)
    for ro in (0, 1):
        loop = new_loop(dev)
        n0 = icm_sweep_pair.launches
        got = icm_sweep_pair(*args, row_offset=ro, loop=loop)
        assert icm_sweep_pair.launches - n0 == 1
        want = icm_sweep_pair(*args, row_offset=ro, plain=True)
        assert torch.equal(got, want)
        assert torch.equal(got, icm_sweep_pair_chained(*args, row_offset=ro))
        assert bool(loop[LOOP_GO]) == bool(torch.any(want != lab0))
        # the loop has stopped (GO 0): the pair passes the labels through
        loop[LOOP_GO] = 0
        assert torch.equal(icm_sweep_pair(*args, row_offset=ro, loop=loop),
                           lab0)
    got = icm_kmajor(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0, 60)
    want = icm_kmajor(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0, 60,
                      plain=True)
    assert torch.equal(got, want)


# "ragged_x2": two ragged regions (R = 2), see `_cut_inputs`
FINISH_SHAPES = SHAPES + ["k30", "ragged_x2"]


@pytest.mark.parametrize("shape", FINISH_SHAPES)
def test_k3_kernel_matches_plain(dev, shape):
    """Energy: both sum float32 terms in float64, rtol 1e-6; one launch a
    call, three calls bitwise equal; the pair entry in one launch, each
    row bitwise the single call on its labeling."""
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (
        potts_energy, potts_energy_pair, potts_energy_plain)

    x = _cut_inputs(dev, shape)
    K = x["unary_k"].shape[1]
    other = ((x["warm"] + 3) % K).to(torch.int32)
    args = (x["unary_k"], x["mask_i"], x["warm"], x["w"], 1.3)
    n0 = potts_energy.launches
    got = [potts_energy(*args) for _ in range(3)]
    assert potts_energy.launches - n0 == 3
    torch.testing.assert_close(got[0], potts_energy_plain(*args), rtol=1e-6,
                               atol=0)
    assert all(torch.equal(g, got[0]) for g in got)
    n0 = potts_energy.launches
    pair = potts_energy_pair(x["unary_k"], x["mask_i"], x["warm"], other,
                             x["w"], 1.3)
    assert potts_energy.launches - n0 == 1
    assert pair.shape == (2, x["unary_k"].shape[0])
    assert torch.equal(pair[0], got[0])
    assert torch.equal(pair[1], potts_energy(x["unary_k"], x["mask_i"], other,
                                             x["w"], 1.3))


def _k4_check(args):
    """K4 on ``args`` (negate=True: the unary goes in) against its plain
    version, rtol 2e-5, atol 1e-6 on every output; one launch a call, three
    calls bitwise equal; the float64 sums round to the float32 outputs
    bitwise, for both values of ``negate`` (the logprob goes in with
    negate=False, bitwise the same outputs)."""
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (finish_stats,
                                                         finish_stats_plain)

    n0 = finish_stats.launches
    got = [finish_stats(*args, negate=True) for _ in range(3)]
    assert finish_stats.launches - n0 == 3
    want = finish_stats_plain(*args, negate=True)
    for a, b in zip(got[0], want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g, got[0]))
    flipped = (-args[0],) + tuple(args[1:])
    for negate, a in ((True, args), (False, flipped)):
        out32 = finish_stats(*a, negate=negate)
        out64 = finish_stats(*a, negate=negate, float64=True)
        for s, t, u in zip(out64, out32, got[0]):
            assert s.dtype == torch.float64
            assert torch.equal(s.float(), t) and torch.equal(t, u)
    assert not got[0][3][:, 4:].any()     # the sums' 4 zero columns


@pytest.mark.parametrize("shape", FINISH_SHAPES)
def test_k4_kernel_matches_plain(dev, shape):
    """Stats and cost sums: rtol 2e-5 (tests/test_finish_pallas.py), on the
    weight maps and on the 0/1 valid maps; see `_k4_check`."""
    x = _cut_inputs(dev, shape)
    for w in (x["w"], torch.isfinite(x["w"]).float()):
        _k4_check((x["unary_k"], x["img_f"], x["mask_i"], x["warm"], w, 1.0,
                   SMALL_EPS))


# (R, K, F, H, W, region with mask all 0): F = 1 and F = PHMRF_FMAX = 8,
# K = PHMRF_KMAX = 32, pixel counts that are not a multiple of a warp's 32
# or of a block's batch, two regions with one empty
K4_EDGE_SHAPES = [(1, 10, 1, 23, 37, None), (2, 7, 8, 19, 53, None),
                  (1, 32, 8, 17, 29, None), (2, 10, 4, 29, 31, 1),
                  (3, 5, 3, 5, 7, 0)]


@pytest.mark.parametrize("spec", K4_EDGE_SHAPES)
def test_k3_k4_edge_shapes_match_plain(dev, spec):
    """K3 and K4 on random operands at the edges of their range (positive
    features, as contact values are; labels of invalid pixels anywhere in
    [-1, K]): the gates of `test_k3_kernel_matches_plain` and
    `_k4_check`."""
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (
        potts_energy, potts_energy_pair, potts_energy_plain)

    R, K, F, H, W, empty = spec
    rng = np.random.default_rng(sum(spec[:5]))
    mask = rng.random((R, H, W)) < 0.7
    if empty is not None:
        mask[empty] = False
    w = rng.random((R, 4, H, W)) * (rng.random((R, 4, H, W)) >= 0.1)
    w[:, 0, :, -1] = w[:, 1, -1] = w[:, 2, -1] = w[:, 2, :, -1] = 0
    w[:, 3, -1] = w[:, 3, :, 0] = 0
    lab = np.where(mask, rng.integers(0, K, (R, H, W)),
                   rng.integers(-1, K + 1, (R, H, W)))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()
    unary = t(rng.random((R, K, H, W)) * 4)
    img = t(rng.random((R, F, H, W)) + 0.1)
    mask_i, labels, w = t(mask, torch.int32), t(lab, torch.int32), t(w)
    got = potts_energy(unary, mask_i, labels, w, 0.9)
    torch.testing.assert_close(got, potts_energy_plain(unary, mask_i, labels,
                                                       w, 0.9),
                               rtol=1e-6, atol=0)
    other = torch.flip(labels, dims=(-1,)).contiguous()
    pair = potts_energy_pair(unary, mask_i, labels, other, w, 0.9)
    assert torch.equal(pair[0], got)
    assert torch.equal(pair[1], potts_energy(unary, mask_i, other, w, 0.9))
    _k4_check((unary, img, mask_i, labels, w, 0.8, SMALL_EPS))


def _cut_inputs(dev, shape):
    """`_inputs`, or for "ragged_x2" a batch of two ragged regions (the
    second with other warm labels), so the cut kernels see R = 2."""
    if shape != "ragged_x2":
        return _inputs(dev, shape)
    a, b = _inputs(dev, "ragged"), _inputs(dev, "ragged")
    b["warm"] = (b["warm"] + 1) % b["unary_k"].shape[1]
    return {k: torch.cat([a[k], b[k]]).contiguous() for k in a}


CUT_SHAPES = ["ragged", "ragged_x2", "chr21"]


def _move_graph(x):
    """The expansion-move graph with the most pixels in play, from the
    K1-K3 start labels: (excess0, cap_t0, caps0, n)."""
    from phylo_hmrf_tpu_torch.ops import maxflow as mf

    K = x["unary_k"].shape[1]
    start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0,
                            60)
    wsum = mf._incident_wsum(x["w"], 1.0)
    graphs = [mf._expansion_graph(start, x["unary_k"], x["w"], x["mask"], a,
                                  1.0, wsum) for a in range(K)]
    excess0, cap_t0, caps0, in_play = max(graphs,
                                          key=lambda g: int(g[3].sum()))
    assert in_play.any()
    H, W = excess0.shape[1:]
    return excess0, cap_t0, caps0, H * W + 2


@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_k6_kernel_matches_plain(dev, shape):
    """8 sweeps in one launch: identical distances (Jacobi sweeps, integer
    min-plus), the input untouched, the changed flag that of the plain
    result; a launch after its loop stopped passes d through; then the
    fixpoint of both paths: identical."""
    from phylo_hmrf_tpu_torch.ops.maxflow import _bfs_fixpoint
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (bfs_sweeps,
                                                         bfs_sweeps_plain)

    excess0, cap_t0, caps0, n = _move_graph(_cut_inputs(dev, shape))
    d0 = torch.where(cap_t0 > 1e-6, 1, n).to(torch.int32).contiguous()
    keep = d0.clone()
    n0 = bfs_sweeps.launches
    from phylo_hmrf_tpu_torch.ops.loops import new_loop
    d, loop = bfs_sweeps(d0, caps0, n, n_inner=8, loop=new_loop(dev))
    want = bfs_sweeps_plain(d0, caps0, n, 8)
    assert bfs_sweeps.launches - n0 == 1
    assert torch.equal(d, want) and torch.equal(d0, keep)
    assert bool(loop[0]) == bool(torch.any(want != d0))
    assert loop[3].item() == 8
    loop[0] = 0
    assert torch.equal(bfs_sweeps(d0, caps0, n, n_inner=8, loop=loop)[0], d0)
    assert loop[3].item() == 8
    assert torch.equal(_bfs_fixpoint(d0.clone(), caps0, n, False, None),
                       _bfs_fixpoint(d0.clone(), caps0, n, True, None))


@pytest.mark.parametrize("shape", CUT_SHAPES)
@pytest.mark.parametrize("n_inner", [1, 4])
def test_k5_kernel_matches_plain(dev, shape, n_inner):
    """Push-relabel iterations from the BFS-relabelled state, 3 calls in a
    row: e, h, cap_t and caps bitwise equal to the plain version's (same
    operations in the same order with round-to-nearest intrinsics), one
    launch a call, the active flag that of the plain result."""
    from phylo_hmrf_tpu_torch.ops.maxflow import _bfs_fixpoint
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (
        EPS, pr_iterations, pr_iterations_plain)

    excess0, cap_t0, caps0, n = _move_graph(_cut_inputs(dev, shape))
    d0 = torch.where(cap_t0 > 1e-6, 1, n).to(torch.int32).contiguous()
    h = _bfs_fixpoint(d0, caps0, n, True, None)
    from phylo_hmrf_tpu_torch.ops.loops import new_loop

    got = want = (excess0, h, cap_t0, caps0)
    for _ in range(3):
        n0 = pr_iterations.launches
        got, loop = pr_iterations(*got, n, n_inner=n_inner,
                                  loop=new_loop(dev))
        assert pr_iterations.launches - n0 == 1
        want = pr_iterations_plain(*want, n, n_inner)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        active = bool(torch.any((want[0] > EPS) & (want[1] < n)))
        assert bool(loop[0]) == active
    loop[0] = 0     # stopped: the state passes through
    for a, b in zip(pr_iterations(*got, n, n_inner=n_inner, loop=loop)[0],
                    got):
        assert torch.equal(a, b)


def _random_cut(dev, shape, seed, directed):
    """A random weighted-Potts cut instance (R, H, W) made with numpy:
    undirected neighbour arcs (a swap move's graph) or forward arcs only
    (an expansion move's), 0 on arcs leaving the grid, sink arcs on 30% of
    the pixels; returns (excess, cap_t, caps, n, sparse BFS seed)."""
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import ALL_DIRS, _nb, _rev

    rng = np.random.default_rng(seed)
    R, H, W = shape
    excess = (rng.random(shape) * 2 * (rng.random(shape) < 0.5))
    cap_t = (rng.random(shape) * 2 * (rng.random(shape) < 0.3))
    caps = np.zeros((R, 8, H, W))
    for a in range(4):
        di, dj = ALL_DIRS[a]
        lam = rng.random(shape) * 0.5
        if di:
            lam[:, -di:, :] = 0
        if dj > 0:
            lam[:, :, -dj:] = 0
        elif dj < 0:
            lam[:, :, :-dj] = 0
        caps[:, a] += lam
        if not directed:
            caps[:, _rev(a)] += _nb(torch.from_numpy(lam), _rev(a),
                                    0.0).numpy()
    t = [torch.as_tensor(x, dtype=torch.float32, device=dev)
         for x in (excess, cap_t, caps)]
    n = H * W + 2
    few = torch.as_tensor(rng.random(shape) < 0.03, device=dev)
    seed_d = torch.where(few & (t[1] > 1e-6), 1, n).to(torch.int32)
    return (*t, n, seed_d)


# tile edges: a grid smaller than one tile (K5 and K6 take 32 x 64
# interiors), H and W one more than a tile multiple, W < 8, two regions
# with different graphs, three tiles each way
TILE_SHAPES = [(1, 23, 37), (1, 33, 65), (1, 40, 5), (2, 30, 70),
               (1, 97, 193)]


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_k6_tile_edges_match_plain(dev, shape, directed):
    """K6 at every depth 1-8, chained 3 times from a sparse sink seed (far
    from the fixpoint, so distances cross tile edges): identical to the
    plain version, the changed flag that of the plain result."""
    from phylo_hmrf_tpu_torch.ops.loops import new_loop
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (bfs_sweeps,
                                                         bfs_sweeps_plain)

    _, _, caps, n, d = _random_cut(dev, shape, sum(shape), directed)
    for _ in range(3):
        for n_inner in range(1, 9):
            got, loop = bfs_sweeps(d, caps, n, n_inner=n_inner,
                                   loop=new_loop(dev))
            want = bfs_sweeps_plain(d, caps, n, n_inner)
            assert torch.equal(got, want), (n_inner, int((got != want).sum()))
            assert bool(loop[0]) == bool(torch.any(want != d))
        d = want


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_k5_tile_edges_match_plain(dev, shape, directed):
    """K5 3 x 4 iterations, and once at each depth 1-4, from the
    BFS-relabelled state: bitwise equal to the plain version at tile
    edges, the grid border and ragged H, W; the active flag that of the
    plain result."""
    from phylo_hmrf_tpu_torch.ops.loops import new_loop
    from phylo_hmrf_tpu_torch.ops.maxflow import _bfs_fixpoint
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (
        EPS, pr_iterations, pr_iterations_plain)

    e, cap_t, caps, n, _ = _random_cut(dev, shape, 1 + sum(shape), directed)
    d0 = torch.where(cap_t > EPS, 1, n).to(torch.int32)
    h = _bfs_fixpoint(d0, caps, n, True, None)
    got = want = (e, h, cap_t, caps)
    for n_inner in [4, 4, 4, 1, 2, 3]:
        got, loop = pr_iterations(*got, n, n_inner=n_inner,
                                  loop=new_loop(dev))
        want = pr_iterations_plain(*want, n, n_inner)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (n_inner, i)
        active = bool(torch.any((want[0] > EPS) & (want[1] < n)))
        assert bool(loop[0]) == active


def _random_estep(dev, shape, K, seed):
    """Random K1/K2 operands (R, H, W) made with numpy: q a softmax, base
    in [0, 4), weights in [0, 1) with 10% zeros, 80% of the pixels
    valid, labels of the valid pixels in [0, K)."""
    rng = np.random.default_rng(seed)
    R, H, W = shape
    z = rng.normal(size=(R, K, H, W))
    q = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    w = rng.random((R, 4, H, W)) * (rng.random((R, 4, H, W)) >= 0.1)
    mask = rng.random(shape) < 0.8
    lab = np.where(mask, rng.integers(0, K, shape), 0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    return dict(q=f32(q), base=f32(rng.random((R, K, H, W)) * 4), w=f32(w),
                unary=f32(rng.random((R, K, H, W)) * 2),
                mask=torch.as_tensor(mask, dtype=torch.int32, device=dev),
                lab=torch.as_tensor(lab, dtype=torch.int32, device=dev))


# K1's tiles are 28 x 28 (K = 10, 8 sweeps) down to 15 x 20 (K = 30, 4
# sweeps) interiors, K2's 56 x 64: these shapes put pixels on every kind
# of their edges too
@pytest.mark.parametrize("K", [1, 10, 30])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_k1_tile_edges_match_chained(dev, shape, K):
    """K1 at every n_inner 1..8 on random operands: bitwise the chained
    one-sweep kernel."""
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (mf_sweeps,
                                                     mf_sweeps_chained)

    x = _random_estep(dev, shape, K, sum(shape) + K)
    for n_inner in range(1, 9):
        T = (1.0, 0.5, 0.25)[n_inner % 3]
        args = (x["q"], x["base"], x["w"], T, 0.5, 1.3)
        got = mf_sweeps(*args, n_inner=n_inner)
        want = mf_sweeps_chained(*args, n_inner=n_inner)
        assert torch.equal(got, want), (n_inner, _max_diff(got, want))


def _max_diff(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("K", [1, 10, 30])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_k2_tile_edges_match_chained(dev, shape, K):
    """K2, three sweep pairs in a row at row parities 0 and 1 (and an odd
    negative offset, as a slab above the first row gives) on random
    operands: labels identical to the chained phases, the changed flag
    that of the labels."""
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (
        icm_sweep_pair, icm_sweep_pair_chained)

    from phylo_hmrf_tpu_torch.ops.loops import new_loop

    x = _random_estep(dev, shape, K, 1 + sum(shape) + K)
    lab = x["lab"]
    for _ in range(3):
        for ro in (0, 1, -7):
            loop = new_loop(dev)
            args = (lab, x["unary"], x["w"], x["mask"], 1.0)
            got = icm_sweep_pair(*args, row_offset=ro, loop=loop)
            want = icm_sweep_pair_chained(*args, row_offset=ro)
            assert torch.equal(got, want), (ro, int((got != want).sum()))
            assert bool(loop[0]) == bool(torch.any(want != lab))
        lab = want


@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_grid_mincut_kernel_matches_plain(dev, shape):
    """The whole min cut on the kernels and on the plain versions, each
    on the graph route and on the host loop: with K5/K6 bitwise and the
    same schedule, the same cut and the same work (the host loops' host
    reads included; a graph route reads once, its counters); the cut's
    cost checked too; no run hits max_sweeps."""
    import dataclasses

    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, grid_mincut
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import _nb

    excess0, cap_t0, caps0, _ = _move_graph(_cut_inputs(dev, shape))

    def cost(side):
        c = torch.where(side, cap_t0, excess0).double().sum()
        for a in range(8):
            c = c + (caps0[:, a].double() * (side & ~_nb(side, a, True))).sum()
        return float(c)

    sk, sh, sp, sph = CutStats(), CutStats(), CutStats(), CutStats()
    got = grid_mincut(excess0, cap_t0, caps0, stats=sk)
    host = grid_mincut(excess0, cap_t0, caps0, host_loop=True, stats=sh)
    want = grid_mincut(excess0, cap_t0, caps0, plain=True, stats=sp)
    plain_host = grid_mincut(excess0, cap_t0, caps0, plain=True,
                             host_loop=True, stats=sph)
    assert sk.capped == sp.capped == 0 and sk.moves == 1
    assert torch.equal(got, want) and torch.equal(host, want)
    assert torch.equal(plain_host, want) and sh == sph
    assert sk.host_reads == sp.host_reads == 1 and sh.host_reads > 2
    assert dataclasses.replace(sk, host_reads=0) == dataclasses.replace(
        sp, host_reads=0)
    assert cost(got) == pytest.approx(cost(want), rel=1e-5)


@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_polish_kernel_matches_plain(dev, shape):
    """One cycle of exact expansion moves from the same K1-K3 start on the
    kernels (graph route) and on the plain versions: identical labels and
    work; the graph route reads the host twice (the start, the cycle)."""
    import dataclasses

    from phylo_hmrf_tpu_torch.ops import maxflow as mf

    x = _cut_inputs(dev, shape)
    K = x["unary_k"].shape[1]
    start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0,
                            60)
    stats = [mf.CutStats(), mf.CutStats()]
    got, want = (mf._optimize_batched(x["unary_k"], x["w"], x["mask"], start,
                                      1.0, K, "expansion", 1, plain=plain,
                                      stats=st)
                 for plain, st in zip((False, True), stats))
    assert torch.equal(got, want) and stats[0].moves > 0
    assert stats[0].host_reads == 2
    assert dataclasses.replace(stats[0], host_reads=0) == \
        dataclasses.replace(stats[1], host_reads=0)


def test_polish_is_deterministic(dev):
    """Two exact expansion polishes of the chr21 start on the kernels:
    bitwise equal labels."""
    from phylo_hmrf_tpu_torch.ops.maxflow import exact_labels_batched

    x = _inputs(dev, "chr21")
    outs = [exact_labels_batched(x["unary_k"], x["w"], x["mask"], x["warm"],
                                 1.0, 10, max_cycles=1, method="expansion")
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] != x["warm"])[x["mask"]].any()


def test_estep_kernels_are_deterministic(dev):
    """Two kernel E-steps on the same inputs: bitwise equal outputs."""
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket

    x = _inputs(dev, "chr21")
    from phylo_hmrf_tpu_torch.synth import chr21_problem
    _, region, means, covs, _, _ = chr21_problem(0)
    dmaps = torch.as_tensor(region.dmaps[None], device=dev)
    m = torch.as_tensor(means, dtype=torch.float32, device=dev)
    c = torch.as_tensor(covs, dtype=torch.float32, device=dev)
    outs = [_estep_bucket(x["img"], x["mask"], dmaps, x["warm"], m, c, 1.0,
                          0.5, weighted_pp=False, max_sweeps=60)
            for _ in range(2)]
    a, b = outs
    assert torch.equal(a[0], b[0])
    for s, t in zip(a[1], b[1]):
        assert torch.equal(s, t)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def test_wrappers_check_operands(dev):
    from phylo_hmrf_tpu_torch.ops.finish_kernels import potts_energy

    x = _inputs(dev, "ragged")
    with pytest.raises(TypeError):
        potts_energy(x["unary_k"], x["mask"], x["warm"], x["w"], 1.0)
    with pytest.raises(ValueError):
        potts_energy(x["unary_k"], x["mask_i"], x["warm"].cpu(), x["w"], 1.0)


def test_wrappers_refuse_float64(dev):
    """A kernel wrapper never picks its plain version because of a dtype:
    float64 CUDA operands raise (the kernels are float32-only), unless
    the caller asks for the plain version, which then keeps float64 (the
    model's float64 mode)."""
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (
        finish_stats, potts_energy, potts_energy_pair)
    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_sweep_pair
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mf_sweeps
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (bfs_sweeps,
                                                         pr_iterations)

    x = {k: (v.double() if v.is_floating_point() else v)
         for k, v in _inputs(dev, "ragged").items()}
    R, K, H, W = x["unary_k"].shape
    img_f = torch.rand(R, 4, H, W, dtype=torch.float64, device=dev)
    caps = torch.rand(R, 8, H, W, dtype=torch.float64, device=dev)
    e = torch.rand(R, H, W, dtype=torch.float64, device=dev)
    h = torch.zeros(R, H, W, dtype=torch.int32, device=dev)
    n = H * W + 2
    calls = [
        lambda **kw: mf_sweeps(x["q0"], x["base"], x["w"], 1.0, 0.5, 1.0,
                               n_inner=2, **kw),
        lambda **kw: icm_sweep_pair(x["warm"], x["unary_k"], x["w"],
                                    x["mask_i"], 1.0, **kw),
        lambda **kw: potts_energy(x["unary_k"], x["mask_i"], x["warm"],
                                  x["w"], 1.0, **kw),
        lambda **kw: potts_energy_pair(x["unary_k"], x["mask_i"], x["warm"],
                                       x["warm"], x["w"], 1.0, **kw),
        lambda **kw: finish_stats(x["unary_k"], img_f, x["mask_i"],
                                  x["warm"], x["w"], 1.0, SMALL_EPS,
                                  negate=True, **kw)[0],
        lambda **kw: bfs_sweeps(h + 1, caps, n, **kw)[0],
        lambda **kw: pr_iterations(e, h, e, caps, n, **kw)[0][0],
    ]
    for call in calls:
        with pytest.raises(TypeError, match="float"):
            call()
        out = call(plain=True)
        assert out.device.type == "cuda"
        if out.is_floating_point():
            assert out.dtype == torch.float64


def _halo_shards(x, n):
    """Each input of the halo kernels cut into n row shards (contiguous)."""
    def cut(t):
        return [c.contiguous() for c in torch.chunk(t, n, dim=-2)]
    lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32).contiguous()
    return {k: cut(v) for k, v in (("q0", x["q0"]), ("base", x["base"]),
                                   ("w", x["w"]), ("unary_k", x["unary_k"]),
                                   ("mask_i", x["mask_i"]), ("lab0", lab0))}


def _halo_args(sh):
    """The row-shard operands of K7/K8 from ``_halo_shards``: the weights
    with one exchanged row a side, the shards' first global rows and the
    row sources of one device (every neighbour read in place)."""
    from phylo_hmrf_tpu_torch.ops.halo_rows import row_sources
    from phylo_hmrf_tpu_torch.parallel.halo import extend_rows

    heights = [t.shape[-2] for t in sh["q0"]]
    row0 = [sum(heights[:i]) for i in range(len(heights))]
    return (extend_rows(sh["w"]), row0,
            row_sources(["one"] * len(heights), heights))


def _offdiag_inputs(dev):
    """The spatial fit's 20 x 653 off-diagonal block of seed 0, padded to
    24 x 768 (6-row shards over 4), as ``chip_smoke.py`` builds it."""
    from phylo_hmrf_tpu_torch.synth import kernel_inputs, synteny_problem

    _, region, means, covs, warm, _ = synteny_problem(0, 20, 653, False,
                                                      pad_h=8)
    return kernel_inputs(region, means, covs, warm, dev)


HALO_SHAPES = {
    # name: (inputs, shards): the spatial fit's 4 x 6 x 768 block; 4 shards
    # of 168 rows; 3 shards of 11 rows (not a multiple of K7's 8-row
    # tiles); 4 uneven shards of a ragged 23 x 37 grid
    "offdiag": ("offdiag", 4), "chr21": ("chr21", 4),
    "rows11": ("chr21_33", 3), "ragged": ("ragged", 4)}


def _halo_inputs(dev, name):
    kind, n = HALO_SHAPES[name]
    if kind == "offdiag":
        x = _offdiag_inputs(dev)
    elif kind == "chr21_33":
        x = {k: v[..., :33, :].contiguous() for k, v in
             _inputs(dev, "chr21").items()
             if k in ("q0", "base", "w", "unary_k", "mask_i", "mask",
                      "warm")}
    else:
        x = _inputs(dev, kind)
    return x, _halo_shards(x, n)


@pytest.mark.parametrize("name", list(HALO_SHAPES))
def test_k7_kernel_matches_plain(dev, name):
    """K7 over all the shards of the card at 1, 8 and 12 sweeps: bitwise
    the per-shard route it replaced (``mf_sweeps_halo_chained``), rtol
    2e-4, atol 1e-6 against its plain version; one launch a call."""
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        mf_sweeps_halo, mf_sweeps_halo_chained, mf_sweeps_halo_plain)

    _, sh = _halo_inputs(dev, name)
    w_ext, _, src = _halo_args(sh)
    k7 = (sh["q0"], sh["base"], w_ext, 0.5, 0.5, 1.0)
    for n in (1, 8, 12):
        n0 = mf_sweeps_halo.launches
        got = mf_sweeps_halo(*k7, n_sweeps=n, sources=src)
        torch.cuda.synchronize()
        assert mf_sweeps_halo.launches - n0 == 1
        want = mf_sweeps_halo_chained(*k7, n_sweeps=n)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (n, float((a - b).abs().max()))
        for a, b in zip(got, mf_sweeps_halo_plain(*k7, n)):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(HALO_SHAPES))
def test_k8_kernel_matches_plain(dev, name):
    """K8 over all the shards of the card, one sweep with the global
    parity: labels identical to the per-shard route it replaced
    (``icm_sweep_halo_chained``) and to its plain version, the changed
    count theirs; one launch a sweep."""
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (
        icm_sweep_halo_, icm_sweep_halo_chained, icm_sweep_halo_plain)

    _, sh = _halo_inputs(dev, name)
    w_ext, row0, src = _halo_args(sh)
    k8 = (sh["unary_k"], w_ext, sh["mask_i"], 1.0)
    want, count = icm_sweep_halo_chained(sh["lab0"], *k8, row0=row0)
    got = [t.clone() for t in sh["lab0"]]
    changed = {dev_: torch.zeros((), dtype=torch.int32, device=dev_)
               for dev_ in {t.device for t in got}}
    n0 = icm_sweep_halo_.launches
    icm_sweep_halo_(got, *k8, changed, row0=row0, sources=src)
    torch.cuda.synchronize()
    assert icm_sweep_halo_.launches - n0 == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(int(c) for c in changed.values()) == int(count) > 0
    plain = [t.cpu() for t in sh["lab0"]]
    cpu = torch.device("cpu")
    pc = {cpu: torch.zeros((), dtype=torch.int32)}
    icm_sweep_halo_plain(plain, *([t.cpu() for t in a] for a in k8[:3]),
                         1.0, pc, row0=row0)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, plain))
    assert int(pc[cpu]) == int(count)


@pytest.mark.parametrize("name", ["offdiag", "rows11"])
def test_halo_remote_route_bitwise(dev, name):
    """Every neighbour marked remote (a table dealt over two device
    labels): the 1-row copies and one launch a sweep or phase give
    bitwise the same-device route's q, labels and changed count."""
    from phylo_hmrf_tpu_torch.ops.halo_rows import row_sources
    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_sweep_halo_
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mf_sweeps_halo

    _, sh = _halo_inputs(dev, name)
    w_ext, row0, local = _halo_args(sh)
    heights = [t.shape[-2] for t in sh["q0"]]
    remote = row_sources((["a", "b"] * len(heights))[:len(heights)], heights)
    k7 = (sh["q0"], sh["base"], w_ext, 0.5, 0.5, 1.0)
    n0 = mf_sweeps_halo.launches
    a = mf_sweeps_halo(*k7, n_sweeps=8, sources=remote)
    assert mf_sweeps_halo.launches - n0 == 8
    b = mf_sweeps_halo(*k7, n_sweeps=8, sources=local)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    out = {}
    for tag, src in (("remote", remote), ("local", local)):
        lab = [t.clone() for t in sh["lab0"]]
        changed = {dev_: torch.zeros((), dtype=torch.int32, device=dev_)
                   for dev_ in {t.device for t in lab}}
        icm_sweep_halo_(lab, sh["unary_k"], w_ext, sh["mask_i"], 1.0,
                        changed, row0=row0, sources=src)
        out[tag] = (lab, sum(int(c) for c in changed.values()))
    assert all(torch.equal(x, y) for x, y in zip(out["remote"][0],
                                                 out["local"][0]))
    assert out["remote"][1] == out["local"][1]


@pytest.mark.parametrize("shape", ["ragged"])
def test_halo_split_identity(dev, shape):
    """On the card, bitwise: K7 over 4 row shards is one K1 sweep of the
    whole grid; K8 over the shards with the global parity is each K2
    phase of the whole grid; K1's 8 sweeps and K2's sweep pair on 8-row
    halos (2 shards) are the whole grid's. (`chip_smoke.py` checks the
    K7/K8 identities at the 10 kb scale.)"""
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (icm_phase_,
                                                      icm_sweep_halo_,
                                                      icm_sweep_pair)
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mf_sweeps, mf_sweeps_halo
    from phylo_hmrf_tpu_torch.parallel.halo import _center, extend_rows

    x = _inputs(dev, shape)
    sh = _halo_shards(x, 4)
    w_ext, row0, src = _halo_args(sh)
    full = mf_sweeps(x["q0"], x["base"], x["w"], 0.5, 0.5, 1.0, n_inner=1)
    split = mf_sweeps_halo(sh["q0"], sh["base"], w_ext, 0.5, 0.5, 1.0,
                           n_sweeps=1, sources=src)
    assert torch.equal(torch.cat(split, dim=-2), full)
    lab0 = torch.cat(sh["lab0"], dim=-2)
    for phase, (a, b) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        full = icm_phase_(lab0.clone(), x["unary_k"], x["w"], x["mask_i"],
                          1.0, a, b)
        lab = [t.clone() for t in sh["lab0"]]
        card = lab0.device
        changed = {card: torch.zeros((), dtype=torch.int32, device=card)}
        icm_sweep_halo_(lab, sh["unary_k"], w_ext, sh["mask_i"], 1.0,
                        changed, row0=row0, sources=src, phase0=phase,
                        n_phases=1)
        assert torch.equal(torch.cat(lab, dim=1), full)
        assert int(changed[card]) == int((full != lab0).sum())
    H = x["q0"].shape[-2]
    if H // 2 >= 8:
        two = _halo_shards(x, 2)
        full = mf_sweeps(x["q0"], x["base"], x["w"], 0.5, 0.5, 1.0,
                         n_inner=8)
        split = [_center(mf_sweeps(qe, be, we, 0.5, 0.5, 1.0, n_inner=8), 8)
                 for qe, be, we in zip(*(extend_rows(two[k], 8)
                                         for k in ("q0", "base", "w")))]
        assert torch.equal(torch.cat(split, dim=-2), full)
        full = icm_sweep_pair(lab0, x["unary_k"], x["w"], x["mask_i"], 1.0)
        row0 = [0, two["lab0"][0].shape[-2]]
        split = [_center(icm_sweep_pair(le, u, we, m, 1.0,
                                        row_offset=r0 - 8), 8)
                 for r0, le, u, we, m in zip(row0, *(
                     extend_rows(two[k], 8)
                     for k in ("lab0", "unary_k", "w", "mask_i")))]
        assert torch.equal(torch.cat(split, dim=-2), full)


def test_rowsharded_estep_on_the_card(dev):
    """The spatial E-step over 4 shards on the card against the
    single-device E-step on the chr21 inputs: labels agree >= 0.999 of the
    valid pixels, stats and costs within 1e-3 relative, a repeat bitwise;
    its energies launch K3's pair entry and its statistics K4, once a
    shard."""
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (finish_stats,
                                                         potts_energy)
    from phylo_hmrf_tpu_torch.parallel.halo import make_rowsharded_estep
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    x = _inputs(dev, "chr21")
    _, region, means, covs, _, _ = chr21_problem(0)
    dmaps = torch.as_tensor(region.dmaps, device=dev)
    m = torch.as_tensor(means, dtype=torch.float32, device=dev)
    c = torch.as_tensor(covs, dtype=torch.float32, device=dev)
    kw = dict(weighted_pp=False, max_sweeps=60)
    l1, s1, c1, _ = _estep_bucket(x["img"], x["mask"], dmaps[None],
                                  x["warm"], m, c, 1.0, 0.5, **kw)
    fn = make_rowsharded_estep(make_mesh((4,), devices=[dev]), **kw)
    args = (x["img"][0], x["mask"][0], dmaps, x["warm"][0], m, c, 1.0, 0.5)
    n3, n4 = potts_energy.launches, finish_stats.launches
    l2, s2, c2, _ = fn(*args)
    assert potts_energy.launches - n3 == 4     # one pair per shard
    assert finish_stats.launches - n4 == 4
    assert (l2 == l1[0])[x["mask"][0]].float().mean().item() >= 0.999
    for a, b in zip(s2, s1):
        torch.testing.assert_close(a, b[0], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(c2, c1[0], rtol=1e-3, atol=0)
    l3, s3, c3, _ = fn(*args)
    assert torch.equal(l3, l2) and torch.equal(c3, c2)
    assert all(torch.equal(a, b) for a, b in zip(s3, s2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_solve_matches_plain_driver(dev, dtype):
    """The M-step solve (K=10, chr21 tree) through its captured CUDA
    graphs (the route of a tree above the fused kernel's caps, driven
    here directly) equals the plain driver bitwise, on new inputs at
    every call and with device allocations between the calls (the graphs
    read only tensors that live as long as they do), and makes no host
    read."""
    import functools

    from phylo_hmrf_tpu_torch.models.hmrf import (
        _graph_solve, _mstep_finish, _mstep_solve_full)
    from phylo_hmrf_tpu_torch.models.ou import ou_nll_stats, tree_tensors
    from phylo_hmrf_tpu_torch.synth import bench_tree

    tree = bench_tree()
    tt = tree_tensors(tree, dev, dtype)
    rng = np.random.default_rng(3)
    K, F, n = 10, tree.n_leaves, 5000
    graphs = {}
    objective = functools.partial(ou_nll_stats, tt=tt, n_samples=float(n),
                                  lambda_0=1.0, min_covar=1e-3)
    finish = functools.partial(_mstep_finish, tt=tt, min_covar=1e-3)
    for call in range(3):
        X = np.abs(rng.normal(size=(n, F))) * 0.5 + 0.2
        g = rng.dirichlet(np.ones(K), size=n)
        p0 = rng.random((K, tree.n_params)) * 0.8 + 0.2
        args = [torch.as_tensor(a, dtype=dtype, device=dev) for a in (
            p0, g.sum(0), g.T @ X, np.einsum("nk,nf,ng->kfg", g, X, X))]
        kw = dict(tt=tt, lo=1e-16, hi=100.0, iters=40)
        plain = _mstep_solve_full(*args, float(n), 1.0, 1e-3, **kw)
        junk = [torch.randn(4096, device=dev) for _ in range(64)]
        graph = _graph_solve(graphs, "mstep", objective, args[0], args[1:],
                             1e-16, 100.0, 40, finish=finish)
        del junk
        for a, b in zip(plain, graph):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.uint8), b.view(torch.uint8))
    (solve,) = graphs.values()
    assert solve.replays == 3 * 4 and solve.host_reads == 0


# ------------------------------------------------------ the loop graphs --

@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_cut_graph_matches_host_loop(dev, shape):
    """The min cut as one CUDA graph launch (``ops/loops.py``) against
    ``grid_mincut_host`` on the kernels: bitwise the same side and the
    same counts (moves, iterations, sweeps, capped), twice with device
    allocations between the calls (the graph reads only buffers it
    keeps); a max_sweeps cap the cut hits gives the host loop's capped
    count and side too."""
    import dataclasses

    from phylo_hmrf_tpu_torch.ops import loops
    from phylo_hmrf_tpu_torch.ops.maxflow import (CutStats, grid_mincut,
                                                  grid_mincut_host)

    excess0, cap_t0, caps0, _ = _move_graph(_cut_inputs(dev, shape))
    for max_sweeps in (3000, 3000, 9):
        sg, sh = CutStats(), CutStats()
        launches = loops.run_cut.launches
        got = grid_mincut(excess0, cap_t0, caps0, max_sweeps, stats=sg)
        junk = [torch.randn(4096, device=dev) for _ in range(64)]
        want = grid_mincut_host(excess0, cap_t0, caps0, max_sweeps,
                                stats=sh)
        del junk
        assert loops.run_cut.launches - launches == 1
        assert torch.equal(got, want)
        assert sg.host_reads == 1
        assert dataclasses.replace(sg, host_reads=0) == \
            dataclasses.replace(sh, host_reads=0)
        assert (sg.capped == 1) == (max_sweeps == 9)


@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_bfs_graph_matches_host_loop(dev, shape):
    """The BFS fixpoint as a graph: the host loop's distances and sweeps."""
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, _bfs_fixpoint

    excess0, cap_t0, caps0, n = _move_graph(_cut_inputs(dev, shape))
    d0 = torch.where(cap_t0 > 1e-6, 1, n).to(torch.int32).contiguous()
    sg, sh = CutStats(), CutStats()
    got = _bfs_fixpoint(d0, caps0, n, False, sg)
    want = _bfs_fixpoint(d0.clone(), caps0, n, False, sh, host_loop=True)
    assert torch.equal(got, want) and sg.bfs_sweeps == sh.bfs_sweeps > 0
    assert sg.host_reads == 1


@pytest.mark.parametrize("max_sweeps", [60, 5, 1])
@pytest.mark.parametrize("shape", ["ragged", "ragged_x2", "chr21"])
def test_icm_graph_matches_host_loop(dev, shape, max_sweeps):
    """``icm_kmajor`` as a graph against its host loop on K2 (and the
    plain version): bitwise labels, also for an odd max_sweeps (both
    overshoot it by a sweep) and one the loop hits; no host read or
    synchronization on the graph route (``set_sync_debug_mode``), a second
    call after allocations agrees."""
    from phylo_hmrf_tpu_torch.ops import loops
    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_kmajor

    x = _cut_inputs(dev, shape)
    args = (x["unary_k"], x["w"], x["mask"], x["warm"], 1.0, max_sweeps)
    want = icm_kmajor(*args, host_loop=True)
    assert torch.equal(want, icm_kmajor(*args, plain=True))
    icm_kmajor(*args)     # builds the graph (a build may synchronize)
    torch.cuda.synchronize()
    launches = loops.run_icm.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = icm_kmajor(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    junk = [torch.randn(4096, device=dev) for _ in range(64)]
    again = icm_kmajor(*args)
    del junk
    assert loops.run_icm.launches - launches == 2
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.parametrize("method", ["expansion", "swap"])
@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_optimize_graph_route_matches_host_loop(dev, shape, method):
    """``_optimize_batched`` on the graph route against the host loop:
    the same labels, moves, iterations, sweeps and energies; the graph
    route reads the host once before the first cycle and once a cycle."""
    import dataclasses

    from phylo_hmrf_tpu_torch.ops import maxflow as mf

    x = _cut_inputs(dev, shape)
    K = x["unary_k"].shape[1]
    start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0,
                            60)
    sg, sh = mf.CutStats(), mf.CutStats()
    kw = dict(max_cycles=3)
    got = mf._optimize_batched(x["unary_k"], x["w"], x["mask"], start, 1.0,
                               K, method, stats=sg, **kw)
    want = mf._optimize_batched(x["unary_k"], x["w"], x["mask"], start, 1.0,
                                K, method, host_loop=True, stats=sh, **kw)
    assert torch.equal(got, want) and sg.moves > 0
    assert dataclasses.replace(sg, host_reads=0) == dataclasses.replace(
        sh, host_reads=0)
    # the cycles: 1 + cycles reads, the host loop's on top of its loops'
    loop_reads = (sh.moves + sh.pr_iterations // 4 + sh.bfs_sweeps // 8)
    cycles = sh.host_reads - loop_reads - 1
    assert 1 <= cycles <= 3 and sg.host_reads == 1 + cycles


def test_loop_graphs_per_shape(dev):
    """A new shape builds a new graph; the same shape reuses its graph."""
    from phylo_hmrf_tpu_torch.ops import loops
    from phylo_hmrf_tpu_torch.ops.maxflow import grid_mincut

    x = _inputs(dev, "ragged")
    excess0, cap_t0, caps0, _ = _move_graph(x)
    grid_mincut(excess0, cap_t0, caps0)
    builds = loops.stats["builds"]
    grid_mincut(excess0, cap_t0, caps0)
    assert loops.stats["builds"] == builds
    grid_mincut(excess0[:, :-1], cap_t0[:, :-1],
                caps0[:, :, :-1].contiguous())
    assert loops.stats["builds"] == builds + 1
    assert loops.driver_version() >= loops.MIN_DRIVER


# ------------------------------------- the plain (float64) loop graphs --

def _f64(x):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in x.items()}


@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_f64_cut_and_bfs_graphs_match_host_loop(dev, shape):
    """The float64 min cut and BFS fixpoint as graphs of captured plain
    units (``plain=True`` on the card) against their host-read plain
    routes: bitwise the same side, distances and counts, twice with
    device allocations between the calls (the graph reads only buffers
    and the pool it keeps), also capped at max_sweeps = 9; a cut without
    counters launched under ``set_sync_debug_mode("error")`` (no host
    read, no synchronization); they add to the plain counters, launch no
    kernel of this package and no kernel graph."""
    import dataclasses

    from phylo_hmrf_tpu_torch.ops import loops
    from phylo_hmrf_tpu_torch.ops.maxflow import (CutStats, _bfs_fixpoint,
                                                  grid_mincut,
                                                  grid_mincut_host)
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (bfs_sweeps,
                                                         pr_iterations)

    # the float32 move graph's capacities, in float64
    excess0, cap_t0, caps0, n = _move_graph(_cut_inputs(dev, shape))
    excess0, cap_t0, caps0 = (t.double() for t in (excess0, cap_t0, caps0))
    kernels = (pr_iterations.launches, bfs_sweeps.launches,
               loops.run_cut.launches, loops.run_bfs.launches)
    units = loops.plain_units()
    for max_sweeps in (3000, 3000, 9):
        sg, sh = CutStats(), CutStats()
        launches = loops.run_cut.plain_launches
        got = grid_mincut(excess0, cap_t0, caps0, max_sweeps, plain=True,
                          stats=sg)
        junk = [torch.randn(4096, device=dev) for _ in range(64)]
        want = grid_mincut_host(excess0, cap_t0, caps0, max_sweeps,
                                plain=True, stats=sh)
        del junk
        assert loops.run_cut.plain_launches - launches == 1
        assert torch.equal(got, want) and sg.host_reads == 1
        assert dataclasses.replace(sg, host_reads=0) == \
            dataclasses.replace(sh, host_reads=0)
        assert (sg.capped == 1) == (max_sweeps == 9)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = grid_mincut(excess0, cap_t0, caps0, 9, plain=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    d0 = torch.where(cap_t0 > 1e-6, 1, n).to(torch.int32).contiguous()
    for _ in range(2):
        sg, sh = CutStats(), CutStats()
        got = _bfs_fixpoint(d0, caps0, n, True, sg)
        junk = [torch.randn(4096, device=dev) for _ in range(64)]
        want = _bfs_fixpoint(d0.clone(), caps0, n, True, sh, host_loop=True)
        del junk
        assert torch.equal(got, want) and sg.bfs_sweeps == sh.bfs_sweeps > 0
    assert (pr_iterations.launches, bfs_sweeps.launches,
            loops.run_cut.launches, loops.run_bfs.launches) == kernels
    now = loops.plain_units()
    assert now["K5"] > units["K5"] and now["K6"] > units["K6"]


@pytest.mark.parametrize("max_sweeps", [60, 5])
@pytest.mark.parametrize("shape", ["ragged_x2", "chr21"])
def test_f64_icm_graph_matches_host_loop(dev, shape, max_sweeps):
    """``icm_kmajor(plain=True)`` in float64 as a graph of captured plain
    sweep pairs: bitwise its host-read plain route, launched under
    ``set_sync_debug_mode("error")`` (no host read, no synchronization),
    again after allocations; no K2 launch."""
    from phylo_hmrf_tpu_torch.ops import loops
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (icm_kmajor,
                                                      icm_sweep_pair)

    x = _f64(_cut_inputs(dev, shape))
    args = (x["unary_k"], x["w"], x["mask"], x["warm"], 1.0, max_sweeps)
    want = icm_kmajor(*args, plain=True, host_loop=True)
    icm_kmajor(*args, plain=True)     # builds the graph (it synchronizes)
    torch.cuda.synchronize()
    launches = loops.run_icm.plain_launches
    k2 = icm_sweep_pair.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = icm_kmajor(*args, plain=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    junk = [torch.randn(4096, device=dev) for _ in range(64)]
    again = icm_kmajor(*args, plain=True)
    del junk
    assert loops.run_icm.plain_launches - launches == 2
    assert icm_sweep_pair.launches == k2
    assert torch.equal(got, want) and torch.equal(again, want)


def test_f64_polish_launches_no_kernel(dev):
    """A float64 expansion polish pass (``_optimize_batched(plain=True)``)
    on the graph route: bitwise the host-read plain route's labels and
    counts, 1 + cycles host reads, none of K1-K8 launched and no kernel
    graph (what ``chip_smoke.py``'s ``[f64]`` checks), its cuts in plain
    graphs."""
    import dataclasses

    from phylo_hmrf_tpu_torch.ops import (finish_kernels, icm_kernels,
                                          loops, mf_kernels, mincut_kernels)
    from phylo_hmrf_tpu_torch.ops import maxflow as mf

    x = _f64(_cut_inputs(dev, "ragged_x2"))
    K = x["unary_k"].shape[1]
    start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0,
                            60, plain=True)
    counters = (mf_kernels.mf_sweeps, icm_kernels.icm_sweep_pair,
                finish_kernels.potts_energy, finish_kernels.finish_stats,
                mincut_kernels.pr_iterations, mincut_kernels.bfs_sweeps,
                mf_kernels.mf_sweeps_halo, icm_kernels.icm_sweep_halo_,
                loops.run_icm, loops.run_cut, loops.run_bfs,
                loops.run_unit_loop)
    before = [c.launches for c in counters]
    plain = loops.run_cut.plain_launches
    sg, sh = mf.CutStats(), mf.CutStats()
    got = mf._optimize_batched(x["unary_k"], x["w"], x["mask"], start, 1.0,
                               K, "expansion", 3, plain=True, stats=sg)
    want = mf._optimize_batched(x["unary_k"], x["w"], x["mask"], start, 1.0,
                                K, "expansion", 3, plain=True,
                                host_loop=True, stats=sh)
    assert torch.equal(got, want) and sg.moves > 0
    assert dataclasses.replace(sg, host_reads=0) == dataclasses.replace(
        sh, host_reads=0)
    loop_reads = sh.moves + sh.pr_iterations // 4 + sh.bfs_sweeps // 8
    assert sg.host_reads == sh.host_reads - loop_reads
    assert [c.launches for c in counters] == before
    assert loops.run_cut.plain_launches - plain == sg.moves


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["offdiag", "chr21"])
def test_halo_icm_graph_matches_host_loop(dev, name, dtype):
    """`_icm_halo_kernels` over 4 shards of the card as one graph launch
    (the K8 branch on the 6-row shards of "offdiag", the K2 branch on the
    168-row shards of "chr21"; kernels in float32, the captured plain
    versions in float64) against its host loop: bitwise labels, twice
    with allocations between the calls, the second call under
    ``set_sync_debug_mode("error")``; the float32 graph's K2 / K8
    launches counted on the card."""
    from phylo_hmrf_tpu_torch.ops import loops
    from phylo_hmrf_tpu_torch.parallel import halo

    x, sh = _halo_inputs(dev, name)
    w_ext, _, _ = _halo_args(sh)
    conv = (lambda t: t.to(dtype))
    unary = [conv(u) for u in sh["unary_k"]]
    w_ext = [conv(w) for w in w_ext]
    mask = [m != 0 for m in sh["mask_i"]]
    init = sh["lab0"]
    plain = dtype == torch.float64
    args = (unary, w_ext, mask, init, 1.0, 60, plain)
    want = halo._icm_halo_kernels(*args, host_loop=True)
    before = loops.kernel_launches()
    launches = (loops.run_unit_loop.launches,
                loops.run_unit_loop.plain_launches)
    got = halo._icm_halo_kernels(*args)
    torch.cuda.synchronize()
    junk = [torch.randn(4096, device=dev) for _ in range(64)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = halo._icm_halo_kernels(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del junk
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert (loops.run_unit_loop.launches - launches[0],
            loops.run_unit_loop.plain_launches - launches[1]) == (
        (0, 2) if plain else (2, 0))
    key = "K8" if name == "offdiag" else "K2"
    assert (loops.kernel_launches()[key] > before[key]) == (not plain)


def test_fit_trace_device_spans(dev, monkeypatch):
    """A fit traced on the card: its solves and E-steps carry device
    times inside the fit's window on the host clock; each solve is the
    fused kernel's one launch with no host read (no graph is captured),
    and each M-step's finalize carries its rows' largest and mean step
    counts; the same fit untraced makes no timing event and no profiler
    range, and gives the same labels."""
    from phylo_hmrf_tpu_torch import PhyloHMRF
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    tree, region, *_ = chr21_problem(0, h0=96, K=4)
    cfg = PhyloHMRFConfig(n_states=4, max_iter=3, seed=0, min_iter=0,
                          threshold=1e-12)
    model = PhyloHMRF(tree, [region], cfg, device=dev)
    res = model.fit(verbose=False, trace=True)
    tr = model.timer
    fit = tr.spans[0]
    slack = 1_000_000     # ns: the anchor's offset and the events' rounding
    timed = [s for s in tr.spans if s.name in ("solve", "estep")]
    assert {s.name for s in timed} == {"solve", "estep"}
    for s in timed:
        assert s.device_ns > 0 and s.events is None
        assert s.t0 - slack <= s.d0 <= s.d1 <= fit.t1 + slack
    mstep_solves = [s for s in tr.spans if s.name == "solve"
                    and tr.spans[s.parent].name == "mstep_dispatch"]
    assert len(mstep_solves) == res.n_iters     # no stop before max_iter
    solves = [s for s in tr.spans if s.name == "solve"]
    assert len(solves) > len(mstep_solves)      # the init's solve too
    assert all(s.counts["route"] == "fused" and s.counts["launches"] == 1
               and s.counts["host_reads"] == 0 for s in solves)
    assert not [s for s in tr.spans if s.name == "graph_capture"]
    assert model._graphs == {}
    fins = [s for s in tr.spans if s.name == "mstep_finalize"]
    assert len(fins) == res.n_iters
    assert all(1 <= s.counts["steps_mean"] <= s.counts["steps_max"] <= 150
               for s in fins)

    made = []
    event0 = torch.cuda.Event

    def event(*a, **k):
        made.append(bool(k.get("enable_timing")))
        return event0(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a profiler range with the trace off")

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    again = PhyloHMRF(tree, [region], cfg, device=dev)
    res2 = again.fit(verbose=False)
    assert made and not any(made)    # the read-backs' events only
    assert again.timer.spans == []
    np.testing.assert_array_equal(res.labels, res2.labels)

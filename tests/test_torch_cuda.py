"""The port's CUDA kernels against their plain PyTorch versions, on the
card (needs an NVIDIA GPU with sm_90a and nvcc; skipped without CUDA).

Run on a GPU machine: ``python -m pytest tests/test_torch_cuda.py -q``.
Shapes: a small ragged grid (H and W of no tile multiple) and the chr21
cell (R=1, K=10, H=672, W=768, F=4). K5/K6 run on the graph of a real
expansion move (the one with the most pixels in play) of the K1-K3 start.
"""

import numpy as np
import pytest
import torch

from phylo_hmrf_tpu.config import SMALL_EPS

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phylo_hmrf_tpu_torch import _build
    _build.load()
    return torch.device("cuda")


def _inputs(dev, shape):
    from phylo_hmrf_tpu.data.regions import region_from_samples
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    if shape == "chr21":
        _, region, means, covs, warm, _ = chr21_problem(0)
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
    assert mf_sweeps.launches - n0 == 8
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6)
    lab = mean_field_kmajor(x["unary_k"], x["w"], 1.0)
    lab_p = mean_field_kmajor(x["unary_k"], x["w"], 1.0, plain=True)
    assert (lab == lab_p).float().mean().item() > 0.999


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_kernel_matches_plain(dev, shape):
    """Sweep pair and the whole ICM loop: labels identical (the kernel
    adds and multiplies in the plain version's order, no FMA)."""
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (icm_kmajor,
                                                      icm_sweep_pair)

    x = _inputs(dev, shape)
    lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32).contiguous()
    got = icm_sweep_pair(lab0, x["unary_k"], x["w"], x["mask_i"], 1.0)
    want = icm_sweep_pair(lab0, x["unary_k"], x["w"], x["mask_i"], 1.0,
                          plain=True)
    assert torch.equal(got, want)
    got = icm_kmajor(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0, 60)
    want = icm_kmajor(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0, 60,
                      plain=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_k3_kernel_matches_plain(dev, shape):
    """Energy: both sum float32 terms in float64, rtol 1e-6."""
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (potts_energy,
                                                         potts_energy_plain)

    x = _inputs(dev, shape)
    args = (x["unary_k"], x["mask_i"], x["warm"], x["w"], 1.3)
    torch.testing.assert_close(potts_energy(*args),
                               potts_energy_plain(*args), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_k4_kernel_matches_plain(dev, shape):
    """Stats and cost sums: rtol 2e-5 (tests/test_finish_pallas.py)."""
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (finish_stats,
                                                         finish_stats_plain)

    x = _inputs(dev, shape)
    for w in (x["w"], torch.isfinite(x["w"]).float()):
        args = (x["unary_k"], x["img_f"], x["mask_i"], x["warm"], w, 1.0,
                SMALL_EPS)
        got = finish_stats(*args, negate=True)
        want = finish_stats_plain(*args, negate=True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)


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
    """8 sweeps: identical distances (Jacobi sweeps, integer min-plus);
    then the fixpoint of both paths: identical."""
    from phylo_hmrf_tpu_torch.ops.maxflow import _bfs_fixpoint
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (bfs_sweeps_,
                                                         bfs_sweeps_plain)

    excess0, cap_t0, caps0, n = _move_graph(_cut_inputs(dev, shape))
    d0 = torch.where(cap_t0 > 1e-6, 1, n).to(torch.int32).contiguous()
    d = d0.clone()
    n0 = bfs_sweeps_.launches
    changed = bfs_sweeps_(d, caps0, n, n_inner=8)
    want = bfs_sweeps_plain(d0, caps0, n, 8)
    assert bfs_sweeps_.launches - n0 == 8
    assert torch.equal(d, want)
    assert int(changed) == int(torch.any(want != d0))
    assert torch.equal(_bfs_fixpoint(d0.clone(), caps0, n, False, None),
                       _bfs_fixpoint(d0.clone(), caps0, n, True, None))


@pytest.mark.parametrize("shape", CUT_SHAPES)
@pytest.mark.parametrize("n_inner", [1, 4])
def test_k5_kernel_matches_plain(dev, shape, n_inner):
    """Push-relabel iterations from the BFS-relabelled state: heights
    identical; e, cap_t, caps within atol 1e-6 (same operations in the
    same order with round-to-nearest intrinsics: expected bitwise)."""
    from phylo_hmrf_tpu_torch.ops.maxflow import _bfs_fixpoint
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (
        pr_iterations_, pr_iterations_plain)

    excess0, cap_t0, caps0, n = _move_graph(_cut_inputs(dev, shape))
    d0 = torch.where(cap_t0 > 1e-6, 1, n).to(torch.int32).contiguous()
    h = _bfs_fixpoint(d0, caps0, n, True, None)
    got = [excess0.clone(), h.clone(), cap_t0.clone(), caps0.clone()]
    want = (excess0, h, cap_t0, caps0)
    for _ in range(3):
        n0 = pr_iterations_.launches
        pr_iterations_(*got, n, n_inner=n_inner)
        assert pr_iterations_.launches - n0 == 2 * n_inner
        want = pr_iterations_plain(*want, n, n_inner)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        for i in (0, 2, 3):
            torch.testing.assert_close(got[i], want[i], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", CUT_SHAPES)
def test_grid_mincut_kernel_matches_plain(dev, shape):
    """The whole min cut on the kernels and on the plain versions: the
    cut costs agree, rel 1e-5 (the cuts may differ where several minimum
    cuts exist); no run hits max_sweeps."""
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, grid_mincut
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import _nb

    excess0, cap_t0, caps0, _ = _move_graph(_cut_inputs(dev, shape))

    def cost(side):
        c = torch.where(side, cap_t0, excess0).double().sum()
        for a in range(8):
            c = c + (caps0[:, a].double() * (side & ~_nb(side, a, True))).sum()
        return float(c)

    sk, sp = CutStats(), CutStats()
    got = grid_mincut(excess0, cap_t0, caps0, stats=sk)
    want = grid_mincut(excess0, cap_t0, caps0, plain=True, stats=sp)
    assert sk.capped == sp.capped == 0 and sk.moves == 1
    assert cost(got) == pytest.approx(cost(want), rel=1e-5)


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

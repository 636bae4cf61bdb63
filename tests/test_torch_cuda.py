"""The port's CUDA kernels against their plain PyTorch versions, on the
card (needs an NVIDIA GPU with sm_90a and nvcc; skipped without CUDA).

Run on a GPU machine: ``python -m pytest tests/test_torch_cuda.py -q``.
Shapes: a small ragged grid (H and W of no tile multiple) and the chr21
cell (R=1, K=10, H=672, W=768, F=4).
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

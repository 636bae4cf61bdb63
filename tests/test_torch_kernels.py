"""The port's E-step modules against the JAX package, on CPU.

Each kernel's plain PyTorch version (what the port runs on CPU tensors) is
fed the same numpy inputs as the JAX function it replaces: the Pallas
kernel in interpret mode, or the jnp path. Tolerances are the JAX
package's own kernel gates (tests/test_mf_pallas.py, test_icm_pallas.py,
test_finish_pallas.py) unless a test says otherwise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from phylo_hmrf_tpu.config import SMALL_EPS  # noqa: E402
from phylo_hmrf_tpu.data.regions import (  # noqa: E402
    flat_index_order, region_from_samples)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _regions(rng, H0, W0, F=3, R=1, pad_w=128):
    out = []
    for _ in range(R):
        rows, _ = flat_index_order(H0, W0, True)
        vals = (rng.random((rows.shape[0], F)) + 0.1).astype(np.float32)
        out.append(region_from_samples(vals, H0, W0, True, pad_h=8,
                                       pad_w=pad_w))
    return out


def _wmaps(regions, beta1=0.5):
    return np.stack([np.exp(-beta1 * r.dmaps).astype(np.float32)
                     for r in regions])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- potts --

def test_potts_ops_match_jax(rng):
    """Per-region potts ops: same formulas, same add order -> float32
    agreement to a few ulps (rtol 1e-6; energy and stats sum a few hundred
    pixels in another order)."""
    from phylo_hmrf_tpu.ops import potts as jp
    from phylo_hmrf_tpu_torch.ops import potts as tp

    (region,) = _regions(rng, 20, 20, pad_w=24)
    H, W = region.shape
    K = 4
    wm = np.exp(-0.5 * region.dmaps).astype(np.float32)
    labels = rng.integers(0, K, (H, W)).astype(np.int32)
    q = rng.random((H, W, K)).astype(np.float32)
    logprob = (-rng.random((H, W, K)) * 4).astype(np.float32)

    # exp() of two libraries: 1 ulp apart on a few percent of the edges
    np.testing.assert_allclose(
        tp.weight_maps(_t(region.dmaps), 0.5).numpy(),
        np.asarray(jp.weight_maps(jnp.asarray(region.dmaps), 0.5)),
        rtol=2e-7, atol=0)
    np.testing.assert_array_equal(
        tp.valid_maps(_t(region.dmaps)).numpy(),
        np.asarray(jp.valid_maps(jnp.asarray(region.dmaps))))
    for a, b in zip(tp.neighbor_sums(_t(labels), _t(wm), K),
                    jp.neighbor_sums(jnp.asarray(labels), jnp.asarray(wm), K)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(tp.neighbor_sums_soft(_t(q), _t(wm)),
                    jp.neighbor_sums_soft(jnp.asarray(q), jnp.asarray(wm))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    pp_t = tp.pairwise_potential(_t(labels), _t(wm), K, 1.3)
    pp_j = jp.pairwise_potential(jnp.asarray(labels), jnp.asarray(wm), K, 1.3)
    np.testing.assert_allclose(pp_t.numpy(), np.asarray(pp_j), rtol=1e-6)
    e_t = tp.potts_energy(_t(labels), _t(-logprob), _t(wm),
                          _t(region.mask), 1.3)
    e_j = jp.potts_energy(jnp.asarray(labels), jnp.asarray(-logprob),
                          jnp.asarray(wm), jnp.asarray(region.mask), 1.3)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-6)
    post_t, cv_t, nv_t = tp.posteriors_and_costs(
        _t(logprob), _t(labels), pp_t, _t(region.mask), SMALL_EPS)
    post_j, cv_j, nv_j = jp.posteriors_and_costs(
        jnp.asarray(logprob), jnp.asarray(labels), pp_j,
        jnp.asarray(region.mask), SMALL_EPS)
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(cv_t.numpy(), np.asarray(cv_j), rtol=1e-6)
    assert float(nv_t) == float(nv_j)
    for a, b in zip(tp.sufficient_stats(post_t, _t(region.img),
                                        _t(region.mask)),
                    jp.sufficient_stats(post_j, jnp.asarray(region.img),
                                        jnp.asarray(region.mask))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_icm_and_mean_field_match_jax(rng):
    """The port's per-region ops/icm.py against the jnp labelers: ICM
    labels identical (same arithmetic, exact argmin); mean-field labels
    agree on > 0.999 of pixels (argmin near-ties may flip)."""
    from phylo_hmrf_tpu.ops import icm as ji
    from phylo_hmrf_tpu_torch.ops import icm as ti

    (region,) = _regions(rng, 20, 20, pad_w=24)
    H, W = region.shape
    K = 4
    wm = np.exp(-0.5 * region.dmaps).astype(np.float32)
    unary = (rng.random((H, W, K)) * 4).astype(np.float32)
    init = rng.integers(0, K, (H, W)).astype(np.int32)

    lab_t, e_t = ti.icm_with_energy(_t(unary), _t(wm), _t(region.mask),
                                    _t(init), 1.2, 40)
    lab_j, e_j = ji.icm_with_energy(
        jnp.asarray(unary), jnp.asarray(wm), jnp.asarray(region.mask),
        jnp.asarray(init), 1.2, 40)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-6)

    mf_t = ti.mean_field(_t(unary), _t(wm), 1.0)
    mf_j = ji.mean_field(jnp.asarray(unary), jnp.asarray(wm), 1.0)
    assert (mf_t.numpy() == np.asarray(mf_j)).mean() > 0.999


# ------------------------------------------------------------------ K1 --

def test_k1_plain_matches_mf_sweeps_pallas(rng):
    """K1's plain version vs mf_sweeps_pallas(interpret=True), 8 sweeps at
    one temperature on the same q/base: rtol 2e-4 (tests/test_mf_pallas.py)."""
    from phylo_hmrf_tpu.ops.mf_pallas import mf_sweeps_pallas
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mf_sweeps

    regions = _regions(rng, 20, 20, R=2)
    R, K = 2, 5
    H, W = regions[0].shape
    wm = _wmaps(regions)
    q = rng.random((R, K, H, W)).astype(np.float32)
    q /= q.sum(1, keepdims=True)
    base = (rng.random((R, K, H, W)) * 4).astype(np.float32)
    out_t = mf_sweeps(_t(q), _t(base), _t(wm), 0.5, 0.5, 1.0, n_inner=8)
    out_j = mf_sweeps_pallas(jnp.asarray(q), jnp.asarray(base),
                             jnp.asarray(wm), 0.5, 0.5, 1.0, n_inner=8,
                             interpret=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-4,
                               atol=1e-6)


def test_k1_mean_field_kmajor_matches_jax(rng):
    """mean_field_kmajor (K1 path, plain on CPU) against the jnp
    mean_field per region: label agreement > 0.999 (test_mf_pallas.py)."""
    from phylo_hmrf_tpu.ops.icm import mean_field
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mean_field_kmajor

    regions = _regions(rng, 20, 20, R=2)
    K = 5
    H, W = regions[0].shape
    wm = _wmaps(regions)
    unary = (rng.random((2, H, W, K)) * 4).astype(np.float32)
    lab_t = mean_field_kmajor(_t(unary.transpose(0, 3, 1, 2)), _t(wm), 1.0)
    for r in range(2):
        lab_j = mean_field(jnp.asarray(unary[r]), jnp.asarray(wm[r]), 1.0)
        assert (lab_t[r].numpy() == np.asarray(lab_j)).mean() > 0.999


# ------------------------------------------------------------------ K2 --

@pytest.mark.parametrize("H0,W0,K,R", [(16, 16, 4, 2), (24, 20, 3, 1)])
def test_k2_plain_matches_icm_pallas(rng, H0, W0, K, R):
    """icm_kmajor (K2 plain on CPU) vs icm_pallas(interpret=True): labels
    identical (tests/test_icm_pallas.py)."""
    from phylo_hmrf_tpu.ops.icm_pallas import icm_pallas
    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_kmajor

    regions = _regions(rng, H0, W0, R=R)
    H, W = regions[0].shape
    wm = _wmaps(regions)
    mask = np.stack([r.mask for r in regions])
    unary = (rng.random((R, H, W, K)) * 4).astype(np.float32)
    init = rng.integers(0, K, (R, H, W)).astype(np.int32)
    unary_k = np.ascontiguousarray(unary.transpose(0, 3, 1, 2))
    out_t = icm_kmajor(_t(unary_k), _t(wm), _t(mask), _t(init), 1.3, 40)
    out_j = icm_pallas(None, jnp.asarray(wm), jnp.asarray(mask),
                       jnp.asarray(init), 1.3, 40, interpret=True,
                       unary_k=jnp.asarray(unary_k))
    np.testing.assert_array_equal(out_t.numpy()[mask], np.asarray(out_j)[mask])


# --------------------------------------------------------------- K3/K4 --

def _finish_problem(rng, K=5, F=3, R=2):
    regions = _regions(rng, 20, 20, F=F, R=R)
    H, W = regions[0].shape
    wm = _wmaps(regions)
    mask = np.stack([r.mask for r in regions]).astype(np.int32)
    img_f = np.stack([r.img.transpose(2, 0, 1) for r in regions])
    logprob_k = (-rng.random((R, K, H, W)) * 4).astype(np.float32)
    labels = rng.integers(0, K, (R, H, W)).astype(np.int32)
    return wm, mask, np.ascontiguousarray(img_f), logprob_k, labels


def test_k3_plain_matches_potts_energy_pallas(rng):
    """K3's plain version vs potts_energy_pallas(interpret=True): energy
    rtol 2e-6 (tests/test_finish_pallas.py)."""
    from phylo_hmrf_tpu.ops.finish_pallas import potts_energy_pallas
    from phylo_hmrf_tpu_torch.ops.finish_kernels import potts_energy

    wm, mask, _, logprob_k, labels = _finish_problem(rng)
    unary_k = -logprob_k
    e_t = potts_energy(_t(unary_k), _t(mask), _t(labels), _t(wm), 1.3)
    e_j = potts_energy_pallas(jnp.asarray(unary_k), jnp.asarray(mask),
                              jnp.asarray(labels), jnp.asarray(wm), 1.3,
                              interpret=True)
    assert e_t.dtype == torch.float32 and e_t.shape == (2,)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2e-6)


def test_k3_pair_plain_matches_potts_energy_pallas(rng):
    """The K3 pair entry on CPU (its plain version: the single one on each
    labeling) vs potts_energy_pallas(interpret=True) once per labeling:
    rtol 2e-6 (tests/test_finish_pallas.py); each row bitwise
    `potts_energy` of its labeling."""
    from phylo_hmrf_tpu.ops.finish_pallas import potts_energy_pallas
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (potts_energy,
                                                         potts_energy_pair)

    wm, mask, _, logprob_k, labels = _finish_problem(rng)
    unary_k = -logprob_k
    other = rng.integers(0, unary_k.shape[1], labels.shape).astype(np.int32)
    e_t = potts_energy_pair(_t(unary_k), _t(mask), _t(labels), _t(other),
                            _t(wm), 1.3)
    assert e_t.dtype == torch.float32 and e_t.shape == (2, 2)
    for row, lab in zip(e_t, (labels, other)):
        e_j = potts_energy_pallas(jnp.asarray(unary_k), jnp.asarray(mask),
                                  jnp.asarray(lab), jnp.asarray(wm), 1.3,
                                  interpret=True)
        np.testing.assert_allclose(row.numpy(), np.asarray(e_j), rtol=2e-6)
        assert torch.equal(row, potts_energy(_t(unary_k), _t(mask), _t(lab),
                                             _t(wm), 1.3))


def test_start_batch_keeps_its_pick(rng):
    """`_start_batch` takes both ICM candidates' energies from K3's pair
    entry: on CPU its labels are those of the former route, two single
    energies and the pick e_a <= e_b per region."""
    from phylo_hmrf_tpu_torch.ops.finish_kernels import potts_energy_plain
    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_kmajor
    from phylo_hmrf_tpu_torch.ops.maxflow import _start_batch
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mean_field_kmajor

    wm, mask, _, logprob_k, labels = _finish_problem(rng, R=3)
    unary_k, w, m, warm = _t(-logprob_k), _t(wm), _t(mask != 0), _t(labels)
    got = _start_batch(unary_k, w, m, warm, 1.0, 60, plain=True)
    mf = mean_field_kmajor(unary_k, w, 1.0, plain=True)
    cand_a = icm_kmajor(unary_k, w, m, mf, 1.0, 60, plain=True)
    cand_b = icm_kmajor(unary_k, w, m, warm, 1.0, 60, plain=True)
    e_a, e_b = (potts_energy_plain(unary_k, _t(mask), c, w, 1.0)
                for c in (cand_a, cand_b))
    want = torch.where((e_a <= e_b)[:, None, None], cand_a, cand_b)
    assert torch.equal(got, want)
    assert not torch.equal(cand_a, cand_b)


@pytest.mark.parametrize("negate", [False, True])
def test_k4_plain_matches_finish_stats_pallas(rng, negate):
    """K4's plain version vs finish_stats_pallas(interpret=True): stats
    and cost sums rtol 2e-5 (tests/test_finish_pallas.py); with negate the
    unary goes in and the outputs are bitwise those of the logprob call
    (IEEE negation is exact)."""
    from phylo_hmrf_tpu.ops.finish_pallas import finish_stats_pallas
    from phylo_hmrf_tpu_torch.ops.finish_kernels import finish_stats

    wm, mask, img_f, logprob_k, labels = _finish_problem(rng)
    field = -logprob_k if negate else logprob_k
    got = finish_stats(_t(field), _t(img_f), _t(mask), _t(labels), _t(wm),
                       0.8, SMALL_EPS, negate=negate)
    want = finish_stats_pallas(
        jnp.asarray(field), jnp.asarray(img_f), jnp.asarray(mask),
        jnp.asarray(labels), jnp.asarray(wm), 0.8, SMALL_EPS,
        interpret=True, negate=negate)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)
    if negate:
        ref = finish_stats(_t(logprob_k), _t(img_f), _t(mask), _t(labels),
                           _t(wm), 0.8, SMALL_EPS)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------------- emission --

def test_gaussian_logpdf_matches_jax(rng):
    """Cholesky-based unaries, both layouts: rtol 1e-5 (float32 matmuls in
    another library; TF32 is off in the port)."""
    from phylo_hmrf_tpu.models import emission as je
    from phylo_hmrf_tpu_torch.models import emission as te

    K, F = 4, 3
    X = rng.random((2, 8, 16, F)).astype(np.float32)
    means = rng.random((K, F)).astype(np.float32)
    A = rng.random((K, F, F))
    covs = (A @ A.transpose(0, 2, 1) + 0.3 * np.eye(F)).astype(np.float32)
    np.testing.assert_allclose(
        te.gaussian_logpdf(_t(X), _t(means), _t(covs)).numpy(),
        np.asarray(je.gaussian_logpdf(jnp.asarray(X), jnp.asarray(means),
                                      jnp.asarray(covs))), rtol=1e-5)
    np.testing.assert_allclose(
        te.gaussian_logpdf_kmajor(_t(X), _t(means), _t(covs)).numpy(),
        np.asarray(je.gaussian_logpdf_kmajor(
            jnp.asarray(X), jnp.asarray(means), jnp.asarray(covs))),
        rtol=1e-5)


# ------------------------------------------------------------- E-step --

def test_estep_bucket_matches_jax(rng):
    """The port's `_estep_bucket` (kernel path; plain versions on CPU)
    against JAX `_estep_bucket(use_pallas=False)` on one bucket of two
    regions. The mean-field stages differ in float order (the JAX jnp path
    folds wsum into the field each sweep, the kernel path precomputes
    base), so labels may differ at near-ties: agreement > 0.995 of valid
    pixels, costs rtol 2e-3 and stats rtol 2e-3 (what a handful of changed
    labels moves in a 20 x 20 region)."""
    from phylo_hmrf_tpu.models.hmrf import _estep_bucket as jax_estep
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket

    K, F = 4, 3
    regions = _regions(rng, 20, 20, F=F, R=2)
    img = np.stack([r.img for r in regions])
    mask = np.stack([r.mask for r in regions])
    dmaps = np.stack([r.dmaps for r in regions])
    H, W = mask.shape[1:]
    warm = rng.integers(0, K, (2, H, W)).astype(np.int32)
    # well-separated states so the labeling is not all near-ties
    means = np.stack([np.full(F, 0.2 + 0.25 * c) for c in range(K)]).astype(
        np.float32)
    covs = np.stack([0.02 * np.eye(F) + 0.005] * K).astype(np.float32)
    for weighted_pp in (False, True):
        lab_j, st_j, cv_j, nv_j = jax_estep(
            jnp.asarray(img), jnp.asarray(mask), jnp.asarray(dmaps),
            jnp.asarray(warm), jnp.asarray(means), jnp.asarray(covs),
            jnp.float32(1.0), jnp.float32(0.5), weighted_pp=weighted_pp,
            labeler="mf_icm", max_sweeps=60, use_pallas=False)
        lab_t, st_t, cv_t, nv_t = _estep_bucket(
            _t(img), _t(mask), _t(dmaps), _t(warm), _t(means), _t(covs),
            1.0, 0.5, weighted_pp=weighted_pp, max_sweeps=60)
        agree = (lab_t.numpy() == np.asarray(lab_j))[mask].mean()
        assert agree > 0.995, agree
        np.testing.assert_allclose(cv_t.numpy(), np.asarray(cv_j), rtol=2e-3)
        np.testing.assert_array_equal(nv_t.numpy(), np.asarray(nv_j))
        for a, b in zip(st_t, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                       atol=1e-3)


def test_estep_plain_flag_is_the_cpu_path(rng):
    """On CPU the kernel wrappers run their plain versions, so the
    `plain=True` reference path and the default path are bitwise equal."""
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket

    K, F = 3, 3
    regions = _regions(rng, 16, 16, F=F, R=1, pad_w=16)
    img = _t(np.stack([r.img for r in regions]))
    mask = _t(np.stack([r.mask for r in regions]))
    dmaps = _t(np.stack([r.dmaps for r in regions]))
    warm = torch.zeros(mask.shape, dtype=torch.int32)
    means = _t(np.stack([np.full(F, 0.3 + 0.3 * c) for c in range(K)])
               .astype(np.float32))
    covs = _t(np.stack([0.05 * np.eye(F)] * K).astype(np.float32))
    a = _estep_bucket(img, mask, dmaps, warm, means, covs, 1.0, 0.5,
                      weighted_pp=False, max_sweeps=60)
    b = _estep_bucket(img, mask, dmaps, warm, means, covs, 1.0, 0.5,
                      weighted_pp=False, max_sweeps=60, plain=True)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())


# ---------------------------------------------------------- boundaries --

def test_cpu_wrappers_run_plain_and_count_no_launch(rng):
    """On CPU tensors the wrappers never touch the kernel library: the
    launch counters stay where they were."""
    from phylo_hmrf_tpu_torch.ops import finish_kernels, icm_kernels
    from phylo_hmrf_tpu_torch.ops import mf_kernels

    counters = (mf_kernels.mf_sweeps, icm_kernels.icm_phase_,
                icm_kernels.icm_sweep_pair,
                finish_kernels.potts_energy, finish_kernels.finish_stats,
                mf_kernels.mf_sweeps_halo, icm_kernels.icm_sweep_halo_)
    before = [f.launches for f in counters]
    wm, mask, img_f, logprob_k, labels = _finish_problem(rng, R=1)
    mf_kernels.mf_sweeps(_t(-logprob_k), _t(-logprob_k), _t(wm), 1.0, 0.5,
                         1.0, n_inner=2)
    icm_kernels.icm_phase_(_t(labels.copy()), _t(-logprob_k), _t(wm),
                           _t(mask), 1.0, 0, 1)
    # the sweep pair's changed flag on CPU: set iff some label changed
    flag = torch.zeros((), dtype=torch.int32)
    lab = _t(labels.copy())
    new = icm_kernels.icm_sweep_pair(lab, _t(-logprob_k), _t(wm), _t(mask),
                                     1.0, row_offset=1, flag=flag, tag=4)
    assert torch.equal(lab, _t(labels))
    assert (int(flag) == 4) == bool(torch.any(new != lab))
    finish_kernels.potts_energy(_t(-logprob_k), _t(mask), _t(labels),
                                _t(wm), 1.0)
    finish_kernels.finish_stats(_t(logprob_k), _t(img_f), _t(mask),
                                _t(labels), _t(wm), 1.0, SMALL_EPS)
    # one row shard: one zero halo row of weights on each side
    from phylo_hmrf_tpu_torch.ops.halo_rows import row_sources
    wm_ext = torch.nn.functional.pad(_t(wm), (0, 0, 1, 1))
    src = row_sources(["cpu"], [labels.shape[-2]])
    mf_kernels.mf_sweeps_halo([_t(-logprob_k)], [_t(-logprob_k)], [wm_ext],
                              1.0, 0.5, 1.0, n_sweeps=2, sources=src)
    changed = {torch.device("cpu"): torch.zeros((), dtype=torch.int32)}
    icm_kernels.icm_sweep_halo_([_t(labels.copy())], [_t(-logprob_k)],
                                [wm_ext], [_t(mask)], 1.0, changed, row0=[1],
                                sources=src)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("n_inner", range(1, 9))
@pytest.mark.parametrize("K", [1, 2, 10, 20, 30, 32])
def test_mf_tile_plan(K, n_inner):
    """K1's tile plan: its shared memory fits a block (232,448 B) and is
    the tile's pixels at 4 (2 K + max(K, 4)) B; its depth (<= 8) covers
    the sweeps of a launch, ceil(n_inner / depth) launches; at most two
    pixels a thread on <= 1024 threads (what csrc/mf.cu takes); one launch
    per temperature (8 sweeps) for K <= 10; the border at most 2.5x the
    interior unless the depth is 1."""
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        MF_MAX_HALO_RATIO, SMEM_MAX, mf_smem_per_pixel, mf_tile_plan)

    plan = mf_tile_plan(K, n_inner)
    lh, lw = plan.th + 2 * plan.depth, plan.tw + 2 * plan.depth
    assert plan.smem == lh * lw * mf_smem_per_pixel(K) <= SMEM_MAX
    assert 1 <= plan.depth <= 8 and plan.th >= 1 and plan.tw >= 1
    assert plan.launches == -(-n_inner // plan.depth)
    assert plan.depth * plan.launches >= n_inner
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert -(-lh * lw // plan.threads) <= 2
    if K <= 10:
        assert plan.launches == 1 and plan.depth == n_inner
    assert (lh * lw / (plan.th * plan.tw) <= MF_MAX_HALO_RATIO
            or plan.depth == 1)
    with pytest.raises(ValueError):
        mf_tile_plan(K + 32, n_inner)


@pytest.mark.parametrize("K", [1, 2, 10, 20, 30, 32])
def test_icm_tile_plan(K):
    """K2's tile plan: one launch runs the pair's 8 phases under its
    8-pixel border; even interiors (the tile starts on an even row), at
    most two 2 x 2 quads of the loaded tile a thread on <= 1024 threads
    (what csrc/icm.cu takes), its labels, 4 forward weight planes and
    label-free minimum (value and state) within a block's shared
    memory."""
    from phylo_hmrf_tpu_torch.ops.icm_kernels import ICM_HALO, icm_tile_plan
    from phylo_hmrf_tpu_torch.ops.mf_kernels import SMEM_MAX

    plan = icm_tile_plan(K)
    lh, lw = plan.th + 2 * ICM_HALO, plan.tw + 2 * ICM_HALO
    assert ICM_HALO >= 8     # the 8 phases of a pair, radius 1 each
    assert plan.th % 2 == 0 and plan.tw % 2 == 0 and plan.th >= 2
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert -(-(lh * lw // 4) // plan.threads) <= 2
    assert plan.smem == 7 * 4 * lh * lw <= SMEM_MAX
    with pytest.raises(ValueError):
        icm_tile_plan(K + 32)


def test_port_imports_no_jax():
    """In a fresh interpreter whose import system refuses jax and every
    module of the JAX package (``phylo_hmrf_tpu`` and
    ``phylo_hmrf_tpu.*``), as well as scikit-learn, pandas and matplotlib
    (absent on the GPU machine), every port module and ``chip_smoke``
    import; and no
    import statement in their sources, lazy ones inside functions
    included, names a refused module."""
    code = (
        "import ast, importlib, pathlib, pkgutil, sys\n"
        "REFUSED = ('jax', 'jaxlib', 'phylo_hmrf_tpu', 'sklearn', 'pandas',"
        " 'matplotlib')\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in REFUSED:\n"
        "            raise ImportError(f'refused: {name}')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import phylo_hmrf_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "mods = [importlib.import_module(n) for n in names]\n"
        "mods.append(importlib.import_module('chip_smoke'))\n"
        "assert len(names) >= 30, names\n"
        "assert {'phylo_hmrf_tpu_torch.parallel.halo', "
        "'phylo_hmrf_tpu_torch.parallel.sharding', "
        "'phylo_hmrf_tpu_torch.native', 'phylo_hmrf_tpu_torch.config', "
        "'phylo_hmrf_tpu_torch.tree', "
        "'phylo_hmrf_tpu_torch.data.regions', "
        "'phylo_hmrf_tpu_torch.cli', "
        "'phylo_hmrf_tpu_torch.data.pipeline', "
        "'phylo_hmrf_tpu_torch.data.contacts', "
        "'phylo_hmrf_tpu_torch.data.filters', "
        "'phylo_hmrf_tpu_torch.data.synteny', "
        "'phylo_hmrf_tpu_torch.utils.checkpoint', "
        "'phylo_hmrf_tpu_torch.compare', "
        "'phylo_hmrf_tpu_torch.postprocess.smooth', "
        "'phylo_hmrf_tpu_torch.utils.bedio', "
        "'phylo_hmrf_tpu_torch.utils.simulate', "
        "'phylo_hmrf_tpu_torch.utils.metrics', "
        "'phylo_hmrf_tpu_torch.data.reconstruct', "
        "'phylo_hmrf_tpu_torch.parallel.distributed', "
        "'phylo_hmrf_tpu_torch.parallel.multiproc'} <= set(names)\n"
        "for m in mods:\n"
        "    tree = ast.parse(pathlib.Path(m.__file__).read_text())\n"
        "    for node in ast.walk(tree):\n"
        "        if isinstance(node, ast.Import):\n"
        "            found = [a.name for a in node.names]\n"
        "        elif isinstance(node, ast.ImportFrom):\n"
        "            found = [node.module or '']\n"
        "        else:\n"
        "            continue\n"
        "        bad = [f for f in found if f.split('.')[0] in REFUSED]\n"
        "        assert not bad, (m.__name__, node.lineno, bad)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in REFUSED]\n"
        "assert not loaded, loaded\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_COPIED_FUNCTIONS = {
    "data.pipeline": ["write_matrix_image_v1_mask",
                      "load_region_with_positions"],
    "data.regions": ["save_edge_dump", "pack_regions"],
    "tree": ["save_debug_dumps", "base_matrices"],
    "utils.metrics": ["best_match_accuracy", "cnt_estimate",
                      "meanvalue_state"],
    "postprocess.smooth": ["states_to_grid", "grid_to_states",
                           "smooth_states", "smooth_state_vec",
                           "write_state_files", "default_palette",
                           "states_to_rgb", "load_color_vec",
                           "symmetric_idx", "symmetric_idx1",
                           "symmetric_state", "symmetric_state1",
                           "symmetric_state1_vec"],
    "compare": ["compare_results", "main"],
    "data.reconstruct": ["main"],
}


@pytest.mark.parametrize("part", ["dirs", "regions", "tree", "config",
                                  "mat_roundtrip", "oracle", "synteny",
                                  "checkpoint", "gridops", "simulate",
                                  *_COPIED_FUNCTIONS])
def test_port_copies_match_jax_package(tmp_path, part):
    """The port's own copies of the JAX package's jax-free modules give
    what the originals give on the same inputs: ``DIRS``; the
    ``region_from_samples`` arrays and ``flat_edge_list`` of a diagonal
    and an off-diagonal region; the ``build_tree`` / ``load_tree``
    matrices; ``PhyloHMRFConfig``'s field names and defaults (and
    ``SMALL_EPS``, ``THRESH1``); a ``.mat`` written by one package and
    read by the other; the C++ oracle (same source, same expansion labels
    and energy). The byte copies are byte for byte the originals:
    ``data/synteny.py`` (and its region pairs with a centromere split),
    ``utils/checkpoint.py`` (and a checkpoint written by one copy restores
    in the other) and ``native/gridops.cc`` (and the hole fills agree).
    ``utils/simulate.py`` is the original with the port's package name in
    its imports; the functions the port copies unchanged into its
    ``data/pipeline.py``, ``data/regions.py``, ``tree.py``,
    ``utils/metrics.py``, ``postprocess/smooth.py``, ``compare.py`` and
    ``data/reconstruct.py`` have the originals' source lines (the
    reconstruction's ``--reference`` has no default in the port); their
    outputs are compared in tests/test_torch_postprocess.py."""
    rng = np.random.default_rng(5)
    if part in _COPIED_FUNCTIONS:
        import importlib
        import inspect
        j = importlib.import_module(f"phylo_hmrf_tpu.{part}")
        t = importlib.import_module(f"phylo_hmrf_tpu_torch.{part}")
        for n in _COPIED_FUNCTIONS[part]:
            want = inspect.getsource(getattr(j, n))
            if part == "data.reconstruct":
                want = want.replace(
                    'ap.add_argument("--reference", default=REFERENCE_INPUT)',
                    'ap.add_argument("--reference", required=True,\n'
                    '                    help="the reference\'s example_input '
                    'directory")')
            assert inspect.getsource(getattr(t, n)) == want, (part, n)
    elif part == "simulate":
        from phylo_hmrf_tpu.utils import simulate as js
        from phylo_hmrf_tpu_torch.utils import simulate as ts
        with open(js.__file__) as a, open(ts.__file__) as b:
            assert (b.read().replace("phylo_hmrf_tpu_torch", "phylo_hmrf_tpu")
                    == a.read())
    elif part == "dirs":
        from phylo_hmrf_tpu.data import regions as jr
        from phylo_hmrf_tpu_torch.data import regions as tr
        assert tr.DIRS == jr.DIRS
    elif part == "regions":
        from phylo_hmrf_tpu.data import regions as jr
        from phylo_hmrf_tpu_torch.data import regions as tr
        for H0, W0, is_diag in ((20, 20, True), (12, 30, False)):
            rows, _ = jr.flat_index_order(H0, W0, is_diag)
            for a, b in zip(tr.flat_index_order(H0, W0, is_diag),
                            jr.flat_index_order(H0, W0, is_diag)):
                np.testing.assert_array_equal(a, b)
            vals = (rng.random((rows.shape[0], 3)) + 0.1).astype(np.float32)
            kw = dict(pad_h=8, pad_w=16, chrom=3, region_id=2, start1=5)
            a = tr.region_from_samples(vals, H0, W0, is_diag, **kw)
            b = jr.region_from_samples(vals, H0, W0, is_diag, **kw)
            for f in ("img", "mask", "dmaps", "flat_rows", "flat_cols"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.len_vec_row(0, 9) == b.len_vec_row(0, 9)
            np.testing.assert_array_equal(tr.flat_edge_list(a),
                                          jr.flat_edge_list(b))
            np.testing.assert_array_equal(
                tr.edge_distance_maps(a.img, a.mask, is_diag, 4),
                jr.edge_distance_maps(b.img, b.mask, is_diag, 4))
    elif part == "tree":
        from phylo_hmrf_tpu import tree as jt
        from phylo_hmrf_tpu_torch import tree as tt
        edges = [(0, 1), (1, 2), (1, 3), (3, 4), (4, 5), (4, 6), (3, 7)]
        (tmp_path / "edge.txt").write_text(
            "".join(f"{a}\t{b}\n" for a, b in edges))
        (tmp_path / "bl.txt").write_text("0\t32\t20\t6\t6\t6\t12\n")
        (tmp_path / "sp.txt").write_text("a\nb\nc\nd\n")
        files = [str(tmp_path / f) for f in ("edge.txt", "bl.txt", "sp.txt")]
        for a, b in ((tt.build_tree(edges), jt.build_tree(edges)),
                     (tt.load_tree(*files), jt.load_tree(*files))):
            for f in ("parent", "topo_order", "leaf_nodes", "A1", "A2",
                      "pair_mrca", "pair_rows", "pair_cols", "pair_list"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert (a.n_nodes, a.n_params, a.species) == (
                b.n_nodes, b.n_params, b.species)
            assert hash(a) == hash(tt.build_tree(edges))
    elif part == "config":
        import dataclasses

        from phylo_hmrf_tpu import config as jc
        from phylo_hmrf_tpu_torch import config as tc

        def defaults(cls):
            return {f.name: (f.default if f.default is not dataclasses.MISSING
                             else f.default_factory())
                    for f in dataclasses.fields(cls)}
        assert defaults(tc.PhyloHMRFConfig) == defaults(jc.PhyloHMRFConfig)
        assert list(defaults(tc.PhyloHMRFConfig)) == list(
            defaults(jc.PhyloHMRFConfig))
        assert tc.SMALL_EPS == jc.SMALL_EPS and tc.LABELERS == jc.LABELERS
        assert tc.THRESH1 == jc.THRESH1
        kw = dict(n_states=4, shard_mode="spatial", labeler="mf_icm+swap@3")
        assert (tc.PhyloHMRFConfig(**kw).to_dict()
                == jc.PhyloHMRFConfig(**kw).to_dict())
    elif part == "mat_roundtrip":
        import types

        from phylo_hmrf_tpu.utils import io as jio
        from phylo_hmrf_tpu_torch.utils import io as tio
        res = types.SimpleNamespace(
            labels=rng.integers(0, 5, 40), params_vec=rng.random((5, 16)),
            params_vec1=rng.random((5, 16)), iter_id1=3, iter_id2=4,
            cost_vec=rng.random((6, 4)), means=rng.random((5, 4)),
            covars=rng.random((5, 4, 4)), params_list=rng.random((6, 5, 16)))
        len_vec = rng.integers(0, 9, (2, 10))
        for save, load in ((tio.save_estimate, jio.load_estimate),
                           (jio.save_estimate, tio.load_estimate)):
            out = str(tmp_path / save.__module__.split(".")[0])
            path = save(res, len_vec, out, 0, 1.0, 5)
            got = load(path)
            want = jio.result_dict(res, len_vec)
            for k, v in want.items():
                np.testing.assert_array_equal(np.asarray(got[k]).squeeze(),
                                              np.asarray(v).squeeze())
            got_npz = load(path[:-3] + "npz")
            np.testing.assert_array_equal(got_npz["covars"], res.covars)
    elif part == "synteny":
        from phylo_hmrf_tpu.data import synteny as js
        from phylo_hmrf_tpu_torch.data import synteny as ts
        _same_source(js, ts)
        blocks = np.array([[0, 1000, 1000], [1200, 2000, 800]])
        for splits in (None, {3: (400, 600)}):
            assert (ts.split_regions(blocks, 3, 10, splits)[1]
                    == js.split_regions(blocks, 3, 10, splits)[1])
    elif part == "checkpoint":
        import types

        from phylo_hmrf_tpu.utils import checkpoint as jc
        from phylo_hmrf_tpu_torch.utils import checkpoint as tc
        _same_source(jc, tc)
        cfg = types.SimpleNamespace(to_dict=lambda: {"pad_h": 8})
        (region,) = _regions(rng, 12, 12, pad_w=16)
        grid = region.labels_to_grid(
            rng.integers(0, 3, region.n_samples).astype(np.int32))

        def model(seed):
            return types.SimpleNamespace(
                params_vec=rng.random((3, 16)), init_ou_params=rng.random(
                    (3, 16)), means_=rng.random((3, 4)),
                covars_=rng.random((3, 4, 4)), init_labels=np.zeros(3),
                labels_local=[grid], regions=[region], cfg=cfg,
                _rng=np.random.default_rng(seed))
        for save, load in ((jc, tc), (tc, jc)):
            src, dst = model(1), model(2)
            path = str(tmp_path / f"{save.__name__}.npz")
            save.save_checkpoint(path, src, {"iter": 4}, {"x": grid})
            book = load.restore_model(dst, *load.load_checkpoint(path))
            assert book == {"iter": 4}
            np.testing.assert_array_equal(dst.params_vec, src.params_vec)
            np.testing.assert_array_equal(dst.labels_local[0], grid)
            assert (dst._rng.bit_generator.state
                    == src._rng.bit_generator.state)
    elif part == "gridops":
        from phylo_hmrf_tpu import native as jn
        from phylo_hmrf_tpu.data.filters import hole_fill as j_fill
        from phylo_hmrf_tpu_torch import native as tn
        from phylo_hmrf_tpu_torch.data.filters import hole_fill as t_fill
        with open(os.path.join(os.path.dirname(jn.__file__),
                               "gridops.cc"), "rb") as f:
            assert open(tn.SOURCES[1], "rb").read() == f.read()
        m = rng.random((16, 16))
        m[m < 0.4] = 0.0
        for sym in (True, False):
            np.testing.assert_array_equal(t_fill(m.copy(), sym),
                                          j_fill(m.copy(), sym))
    else:
        from phylo_hmrf_tpu import native as jn
        from phylo_hmrf_tpu.data.regions import flat_edge_list
        from phylo_hmrf_tpu_torch import native as tn
        with open(os.path.join(os.path.dirname(jn.__file__),
                               "maxflow.cc"), "rb") as f:
            assert open(tn.SOURCE, "rb").read() == f.read()
        if not jn.available():
            pytest.skip("no g++")
        (region,) = _regions(rng, 12, 12, pad_w=16)
        edges = flat_edge_list(region)
        w = np.exp(-0.5 * edges[:, 2])
        unary = rng.random((region.n_samples, 4))
        start = rng.integers(0, 4, region.n_samples).astype(np.int32)
        a = tn.potts_expansion(edges, w, unary, 1.0, start, 50)
        b = jn.potts_expansion(edges, w, unary, 1.0, start, 50)
        np.testing.assert_array_equal(a, b)
        assert (tn.potts_energy(edges, w, unary, 1.0, a)
                == jn.potts_energy(edges, w, unary, 1.0, b))


def _same_source(jax_module, port_module):
    """A byte copy: the port's module file equals the JAX package's."""
    with open(jax_module.__file__, "rb") as a, \
            open(port_module.__file__, "rb") as b:
        assert a.read() == b.read(), port_module.__name__

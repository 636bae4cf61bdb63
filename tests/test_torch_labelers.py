"""The port's E-step labelers against the JAX package on the CPU: the exact
on-device labelers (``swap_tpu``, ``expansion_tpu``), the hybrids
``mf_icm+{swap,expansion}@N``, the host C++ ``swap`` / ``expansion``,
``icm`` and ``lbp``; their building blocks (``ops/icm.py::label_optimize``,
``ops/lbp.py``, ``ops/maxflow.py``'s one-region entry points, the
``native`` swap); the per-region exact route on a region mesh; the hybrid
schedule across a resume; the command line; and the rest of the model's
surface that runs through ``estep``.

Every lockstep fit starts both packages from one state (``convert.py``)
with 6-step M-step solves, where the two solvers move in lockstep
(tests/test_torch_fit.py). The kernels run as their plain versions here
(CPU tensors); JAX runs its jnp paths, which compute the same functions.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from phylo_hmrf_tpu.config import PhyloHMRFConfig  # noqa: E402
from phylo_hmrf_tpu.data.regions import (  # noqa: E402
    flat_edge_list, flat_index_order, region_from_samples)
from phylo_hmrf_tpu_torch import PhyloHMRF  # noqa: E402
from phylo_hmrf_tpu_torch.convert import export_state, import_state  # noqa
from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from phylo_hmrf_tpu_torch.synth import bench_tree, ou_moments_np  # noqa
from tests.test_torch_fit import _paired_fits, synth_problem  # noqa: E402

torch.set_num_threads(1)

TREE = bench_tree()
CPU8 = make_mesh((8,), devices=[torch.device("cpu")])
# the lockstep regime: 6-step M-step solves, no early stop
LOCK = dict(n_states=3, max_iter=3, seed=1, min_iter=0, threshold=1e-12,
            mstep_iters=6, pad_h=8, pad_w=8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid_inputs(rng, K=4, H=24, W=24):
    """unary (H, W, K), weights (4, H, W) with the edges leaving the grid
    at 0, a mask and random warm labels."""
    u = (rng.random((H, W, K)) * 3).astype(np.float32)
    w = rng.random((4, H, W)).astype(np.float32)
    w[1:, -1] = 0.0
    w[0, :, -1] = 0.0
    w[2, :, -1] = 0.0
    w[3, :, 0] = 0.0
    mask = rng.random((H, W)) > 0.1
    init = rng.integers(0, K, (H, W)).astype(np.int32)
    return u, w, mask, init


# ---------------------------------------------------------- the ops --

def test_lbp_matches_jax():
    """Min-sum LBP on a 24 x 24 grid, K=4, 30 iterations: labels
    identical, beliefs within rtol 1e-5 (measured: bitwise)."""
    from phylo_hmrf_tpu.ops.lbp import lbp_min_sum as jax_lbp
    from phylo_hmrf_tpu_torch.ops.lbp import lbp_labels, lbp_min_sum

    u, w, mask, _ = _grid_inputs(np.random.default_rng(0))
    lj, bj = jax_lbp(jnp.asarray(u), jnp.asarray(w), jnp.asarray(mask), 1.0,
                     n_iters=30)
    lt, bt = lbp_min_sum(_t(u), _t(w), _t(mask), 1.0, n_iters=30)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5)
    assert not lt.numpy()[~mask].any()
    np.testing.assert_array_equal(
        lbp_labels(_t(u), _t(w), _t(mask), 1.0).numpy(), lt.numpy())


@pytest.mark.parametrize("method,ramp", [("mf_icm", 0), ("icm", 0),
                                         ("lbp", 0), ("icm", 3)])
def test_label_optimize_matches_jax(method, ramp):
    """``ops/icm.py::label_optimize`` per method, and ``icm`` with a
    3-sweep beta ramp, from random warm labels: labels identical to the
    JAX function's."""
    from phylo_hmrf_tpu.ops.icm import label_optimize as jax_lo
    from phylo_hmrf_tpu_torch.ops.icm import label_optimize

    u, w, mask, init = _grid_inputs(np.random.default_rng(1))
    want = jax_lo(jnp.asarray(u), jnp.asarray(w), jnp.asarray(mask),
                  jnp.asarray(init), 1.0, method=method, beta_ramp=ramp)
    got = label_optimize(_t(u), _t(w), _t(mask), _t(init), 1.0,
                         method=method, beta_ramp=ramp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != init)[mask].any()


@pytest.mark.parametrize("entry", ["exact_labels", "swap_optimize",
                                   "expansion_optimize"])
def test_one_region_exact_entries_match_jax(entry):
    """``ops/maxflow.py``'s one-region entry points (state-minor unary,
    a batch of one) give the JAX functions' labels."""
    from phylo_hmrf_tpu.ops import maxflow_tpu as jm
    from phylo_hmrf_tpu_torch.ops import maxflow as tm

    u, w, mask, init = _grid_inputs(np.random.default_rng(2), K=3, H=20,
                                    W=20)
    ja = (jnp.asarray(u), jnp.asarray(w), jnp.asarray(mask),
          jnp.asarray(init), 1.0, 3)
    ta = (_t(u), _t(w), _t(mask), _t(init), 1.0, 3)
    if entry == "exact_labels":
        want = jm.exact_labels(*ja, max_cycles=4, method="expansion",
                               use_pallas=False)
        got = tm.exact_labels(*ta, max_cycles=4, method="expansion")
    else:
        want = getattr(jm, entry)(*ja, max_cycles=4, use_pallas=False)
        got = getattr(tm, entry)(*ta, max_cycles=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_potts_swap_binding_matches_jax():
    """The port's ``native.potts_swap`` and the JAX package's on the same
    region graph: bitwise the same labels (one C++ source), an energy no
    higher than the start's."""
    from phylo_hmrf_tpu import native as jn
    from phylo_hmrf_tpu_torch import native as tn

    regions, _ = synth_problem(np.random.default_rng(4), K=3, H0=16)
    r = regions[0]
    rng = np.random.default_rng(5)
    edges = flat_edge_list(r)
    w = np.exp(-0.5 * edges[:, 2])
    unary = rng.random((r.n_samples, 3)) * 2.0
    init = rng.integers(0, 3, r.n_samples).astype(np.int32)
    ei = edges[:, :2].astype(np.int64)
    got = tn.potts_swap(ei, w, unary, 1.0, init, 50)
    want = jn.potts_swap(ei, w, unary, 1.0, init, 50)
    np.testing.assert_array_equal(got, want)
    assert (tn.potts_energy(ei, w, unary, 1.0, got)
            <= tn.potts_energy(ei, w, unary, 1.0, init))
    assert (got != init).any()


@pytest.mark.parametrize("labeler", ["icm", "lbp"])
def test_estep_bucket_labeler_matches_jax(labeler):
    """``_estep_bucket`` with the ``icm`` and ``lbp`` labelers (the K2
    route, and the LBP proposal with K2 on it and on the warm labels, K3
    choosing) against the JAX ``_estep_bucket`` on a bucket of two
    regions: labels identical, statistics and costs within K4's gate
    (rtol 2e-5, tests/test_finish_pallas.py)."""
    from phylo_hmrf_tpu.models.hmrf import _estep_bucket as jax_estep
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket

    regions, _ = synth_problem(np.random.default_rng(6), K=3, H0=20)
    r = regions[0]
    rng = np.random.default_rng(7)
    img = np.stack([r.img, r.img[::-1].copy()]).astype(np.float32)
    mask = np.stack([r.mask, r.mask])
    dmaps = np.stack([r.dmaps, r.dmaps]).astype(np.float32)
    warm = rng.integers(0, 3, mask.shape).astype(np.int32)
    params = rng.random((3, TREE.n_params)) * 0.5 + 0.2
    for c in range(3):
        params[c, TREE.n_params - TREE.n_nodes:] = 0.6 * c + 0.3
    mom = [ou_moments_np(p, TREE) for p in params]
    means = np.stack([m for m, _ in mom]).astype(np.float32)
    covs = np.stack([v + 1e-3 * np.eye(4) for _, v in mom]).astype(
        np.float32)
    lj, sj, cj, nj = jax_estep(
        *(jnp.asarray(a) for a in (img, mask, dmaps, warm, means, covs)),
        jnp.float32(1.0), jnp.float32(0.5), weighted_pp=False,
        labeler=labeler, max_sweeps=60, use_pallas=False)
    lt, st, ct, nt = _estep_bucket(
        *(_t(a) for a in (img, mask, dmaps, warm, means, covs)), 1.0, 0.5,
        weighted_pp=False, max_sweeps=60, labeler=labeler)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


# ---------------------------------------------------------- the fits --

@pytest.mark.parametrize("labeler", [
    "swap_tpu", "expansion_tpu", "swap", "expansion", "icm", "lbp",
    "mf_icm+swap@2", "mf_icm+expansion@2"])
def test_labeler_fit_matches_jax_in_lockstep(labeler):
    """A fit with each labeler against the JAX fit from the same state,
    with the final polish on (the exact labelers skip it, as the JAX
    engine does): every iteration's labels and the final labels
    identical, every cost row within rtol 1e-5, and for the hybrids
    (``hybrid_exact_hi`` raised so that iteration 1 runs the fast
    labeler) the same exact-pass iterations, [0, 2]."""
    cfg = PhyloHMRFConfig(labeler=labeler, hybrid_exact_hi=1e9, **LOCK)
    out = _paired_fits(cfg, seed=0)
    (rj, lj, mj), (rt, lt, mt) = out["jax"], out["torch"]
    assert rt.cost_vec.shape == rj.cost_vec.shape == (3, 4)
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-5)
    assert len(lt) == len(lj) == 3
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    np.testing.assert_allclose(rt.cost_vec[:, 3],
                               rt.cost_vec[:, 1] + rt.cost_vec[:, 2],
                               rtol=1e-6)
    assert mt.hybrid_exact_iters_ == mj.hybrid_exact_iters_
    exact = labeler.endswith("_tpu") or "@" in labeler
    if "@" in labeler:
        assert mt.hybrid_exact_iters_ == [0, 2]
    if labeler in ("swap", "swap_tpu", "expansion", "expansion_tpu"):
        assert mt.polish_stats_ is None
        assert "final_polish" not in mt.timer.summary()
    else:
        assert mt.polish_stats_.moves > 0
    # one CutStats per exact E-step, each moving no label uphill
    assert len(mt.exact_stats_) == (len(mt.hybrid_exact_iters_) if "@" in
                                    labeler else 3 if exact else 0)
    for st in mt.exact_stats_:
        assert st.moves > 0 and st.capped == 0
        assert st.energy_end <= st.energy_start + 1e-6 * abs(
            st.energy_start)


def test_hybrid_resume_makes_the_uninterrupted_exact_passes(tmp_path):
    """tests/test_io_cli.py::test_hybrid_resume_matches_uninterrupted on
    the port: a resumed ``mf_icm+swap@3`` run recomputes the relative cost
    changes the schedule reads from the restored rows, so it makes the
    exact passes of the uninterrupted run's tail and its trajectory is
    bitwise that run's."""
    regions, _ = synth_problem(np.random.default_rng(0), K=3, H0=16)
    kw = dict(final_polish=False, n_states=3, seed=7, mstep_iters=30,
              pad_h=8, pad_w=8, min_iter=99, threshold=1e-4,
              labeler="mf_icm+swap@3")

    def model(max_iter):
        return PhyloHMRF(TREE, regions, PhyloHMRFConfig(max_iter=max_iter,
                                                        **kw), device="cpu")
    m_full = model(5)
    r_full = m_full.fit(verbose=False)
    ck = str(tmp_path / "ck.npz")
    model(2).fit(verbose=False, checkpoint_path=ck, checkpoint_every=1)
    m_res = model(5)
    r_res = m_res.fit(verbose=False, checkpoint_path=ck, resume=True)
    full_tail = [i for i in m_full.hybrid_exact_iters_ if i >= 2]
    assert m_res.hybrid_exact_iters_ == full_tail, (
        m_full.hybrid_exact_iters_, m_res.hybrid_exact_iters_)
    # the tail mixes exact and fast iterations, so a reset schedule shows
    assert 0 < len(full_tail) < 3, m_full.hybrid_exact_iters_
    np.testing.assert_array_equal(r_full.cost_vec, r_res.cost_vec)
    np.testing.assert_array_equal(r_full.labels, r_res.labels)
    np.testing.assert_array_equal(r_full.params_vec1, r_res.params_vec1)


# ---------------------------------------------------- the region mesh --

def _same_shape_regions(seed, H0=24, noise=0.35, offset=0.0):
    """Two diagonal H0 x H0 regions of one bucket: blocky labels with
    OU-Gaussian emissions, the second region's values shifted by
    ``offset``. Returns (regions, means, covars) of the generating
    states."""
    rng = np.random.default_rng(seed)
    K = 3
    params = rng.random((K, TREE.n_params)) * 0.5 + 0.2
    for c in range(K):
        params[c, TREE.n_params - TREE.n_nodes:] = 0.6 * c + 0.3
    mom = [ou_moments_np(p, TREE) for p in params]
    means = np.stack([m for m, _ in mom])
    covs = np.stack([v + 1e-3 * np.eye(4) for _, v in mom])
    regions = []
    for ridx in range(2):
        ii, jj = np.indices((H0, H0))
        lab = ((ii // 6 + jj // (6 + ridx)) % K).astype(np.int32)
        rows, cols = flat_index_order(H0, H0, True)
        x = np.stack([rng.multivariate_normal(means[c], covs[c] * noise)
                      for c in lab[rows, cols]]).astype(np.float32)
        regions.append(region_from_samples(
            np.abs(x) + 0.05 + offset * ridx, H0, H0, True, pad_h=8,
            pad_w=8, region_id=ridx))
    return regions, means, covs


@pytest.fixture(scope="module")
def mesh8():
    from phylo_hmrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh((8,))


def test_meshed_fit_with_one_bucket_matches_jax(mesh8):
    """A region-mode fit on 8 CPU shards whose one shape bucket holds two
    regions, with the final expansion polish, in lockstep with the JAX
    meshed fit: cost rows within rtol 1e-5, every iteration's labels and
    the polished labels identical."""
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF

    regions, _, _ = _same_shape_regions(1)
    assert regions[0].shape == regions[1].shape
    cfg = PhyloHMRFConfig(shard_mode="region", **LOCK)
    jm = JaxPhyloHMRF(TREE, regions, cfg, mesh=mesh8)
    jm.initialize()
    tm = PhyloHMRF(TREE, regions, cfg, mesh=CPU8)
    import_state(tm, export_state(jm))
    rj, rt = jm.fit(verbose=False), tm.fit(verbose=False)
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-5)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    assert tm.polish_stats_.moves > 0


def test_meshed_exact_labels_are_per_region(mesh8):
    """On a region mesh the exact moves label each region alone, as the
    JAX engine does. The bucket holds a region whose swap moves need a
    second cycle beside one whose values lie far from every state (an
    energy ~1e6 times larger): batched, the summed-energy stop ends both
    after the first cycle. The meshed port's `_exact_labels_all` and its
    exact E-step give the JAX meshed labels; the one-device batched route
    gives other labels on this bucket (35 of the first region's pixels
    differ)."""
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF

    regions, means, covs = _same_shape_regions(2, H0=32, noise=0.8,
                                               offset=300.0)
    cfg = PhyloHMRFConfig(labeler="swap_tpu", shard_mode="region", **LOCK)
    warm = [np.random.default_rng(2).integers(0, 3, r.shape).astype(
        np.int32) for r in regions]
    jm = JaxPhyloHMRF(TREE, regions, cfg, mesh=mesh8)
    tm = PhyloHMRF(TREE, regions, cfg, mesh=CPU8)
    one = PhyloHMRF(TREE, regions, cfg, device="cpu")
    want = jm._exact_labels_all(means, covs, warm, method="swap")
    got = tm._exact_labels_all(means, covs, warm, method="swap")
    batched = one._exact_labels_all(means, covs, warm, method="swap")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(batched[0].numpy(), np.asarray(want[0]))
    # the whole exact E-step: the same labels, statistics per region
    lab, stats, costs, _ = tm.estep(means, covs, warm)
    jlab, jstats, jcosts, _ = jm.estep(means, covs, warm)
    for g, w in zip(lab, jlab):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(costs, jcosts, rtol=2e-5)
    for a, b in zip(stats, jstats):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_spatial_estep_rejects_exact_method():
    """tests/test_spatial_fit.py: an exact E-step asked of a spatial mesh
    raises ValueError, not a silent mean-field pass."""
    regions, _ = synth_problem(np.random.default_rng(0), H0=32)
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3, pad_h=8, pad_w=8,
                          shard_mode="spatial")
    m = PhyloHMRF(TREE, regions, cfg, mesh=CPU8)
    m.initialize()
    with pytest.raises(ValueError, match="spatial"):
        m.estep(m.means_, m.covars_, m.labels_local, exact_method="swap")


# ------------------------------------------------ the model's surface --

def test_predict_and_scores_match_jax():
    """``predict`` (one E-step of the configured labeler), then
    ``predict_proba`` and ``score_samples`` at those labels, against the
    JAX model from the same state: labels identical, posteriors and the
    log-evidence within rtol 1e-5; ``fit_accumulate`` tracks the states
    and ``fit_v1`` restores the iteration-3-on best everywhere."""
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF

    regions, _ = synth_problem(np.random.default_rng(3), K=3, H0=16)
    cfg = PhyloHMRFConfig(labeler="lbp", **LOCK)
    jm = JaxPhyloHMRF(TREE, regions, cfg)
    jm.initialize()
    tm = PhyloHMRF(TREE, regions, cfg, device="cpu")
    import_state(tm, export_state(jm))
    lab = tm.predict()
    np.testing.assert_array_equal(lab, jm.predict())
    np.testing.assert_allclose(tm.predict_proba(lab), jm.predict_proba(lab),
                               rtol=1e-5, atol=1e-7)
    (st, pt), (sj, pj) = tm.score_samples(lab), jm.score_samples(lab)
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pt.sum(1), 1.0, rtol=1e-5)
    acc = tm.fit_accumulate(verbose=False)
    assert acc.state_list.shape == (acc.n_iters, tm.n_samples)
    v1 = PhyloHMRF(TREE, regions, cfg, device="cpu")
    import_state(v1, export_state(jm))
    r1 = v1.fit_v1(verbose=False)
    np.testing.assert_array_equal(v1.params_vec, r1.params_vec1)
    np.testing.assert_array_equal(r1.means, v1.means_)


def test_cli_exact_labeler_writes_mat(tmp_path):
    """``--labeler swap_tpu --device cpu`` on a 48-bin example writes the
    ``.mat`` with its keys, a state for every sample and
    cost1 == pairwise + unary."""
    import os

    import scipy.io

    from phylo_hmrf_tpu_torch.cli import main
    from phylo_hmrf_tpu_torch.synth import write_example

    data = str(tmp_path / "ex")
    write_example(data, n_bins=48, n_states=4, chroms=(21,))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        main(["--device", "cpu", "-n", "4", "-p", data, "--chromvec", "21",
              "--miter", "2", "--output", "out", "--labeler", "swap_tpu"])
    finally:
        os.chdir(cwd)
    mats = [f for f in os.listdir(tmp_path / "out") if f.endswith(".mat")]
    assert len(mats) == 1
    got = scipy.io.loadmat(str(tmp_path / "out" / mats[0]))
    assert {"state_vec", "len_vec", "cost_vec", "params_vec1"} <= set(got)
    cv = got["cost_vec"]
    assert np.isfinite(cv).all() and cv.shape[0] == 2
    np.testing.assert_allclose(cv[:, 3], cv[:, 1] + cv[:, 2], rtol=1e-6)
    assert got["state_vec"].size == int(got["len_vec"][:, 0].sum())

"""The port's whole EM fit against the JAX engine on CPU, without and
with the final exact polish, the state carried between them, and what the
port refuses.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from phylo_hmrf_tpu.config import PhyloHMRFConfig  # noqa: E402
from phylo_hmrf_tpu.data.regions import (  # noqa: E402
    flat_index_order, region_from_samples)
from phylo_hmrf_tpu_torch import PhyloHMRF  # noqa: E402
from phylo_hmrf_tpu_torch.convert import export_state, import_state  # noqa
from phylo_hmrf_tpu_torch.synth import bench_tree, ou_moments_np  # noqa

torch.set_num_threads(1)

TREE = bench_tree()


def synth_problem(rng, K=3, H0=20, noise=0.35):
    """Blocky true labels with OU-Gaussian emissions on one diagonal and
    one off-diagonal region (tests/test_em.py::synth_problem, numpy
    moments)."""
    tree = TREE
    params = rng.random((K, tree.n_params)) * 0.5 + 0.2
    for c in range(K):
        params[c, tree.n_params - tree.n_nodes:] = 0.6 * c + 0.3
    moments = [ou_moments_np(params[c], tree) for c in range(K)]
    regions, true = [], []
    for ridx, (h0, w0, is_diag) in enumerate(
            [(H0, H0, True), (H0 // 2, H0, False)]):
        ii, jj = np.indices((h0, w0))
        lab = ((ii // 6 + jj // 6) % K).astype(np.int32)
        rows, cols = flat_index_order(h0, w0, is_diag)
        lab_flat = lab[rows, cols]
        x = np.stack([rng.multivariate_normal(
            moments[c][0], (moments[c][1] + 1e-3 * np.eye(4)) * noise)
            for c in lab_flat]).astype(np.float32)
        regions.append(region_from_samples(
            np.abs(x) + 0.05, h0, w0, is_diag, pad_h=8, pad_w=8,
            region_id=ridx))
        true.append(lab_flat)
    return regions, np.concatenate(true)


def _paired_fits(cfg, seed):
    """A JAX and a port model fit from the SAME state: the port imports
    the JAX model's initialize(). Returns both results and the flat
    labels of every iteration's E-step."""
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF

    regions, _ = synth_problem(np.random.default_rng(seed))
    jm = JaxPhyloHMRF(TREE, regions, cfg)
    jm.initialize()
    tm = PhyloHMRF(TREE, regions, cfg, device="cpu")
    import_state(tm, export_state(jm))
    out = {}
    for name, m in (("jax", jm), ("torch", tm)):
        labels = []

        def cb(model, it, row, grids, labels=labels):
            labels.append(np.concatenate([
                r.labels_to_flat(np.asarray(g.cpu() if torch.is_tensor(g)
                                            else g))
                for r, g in zip(model.regions, grids)]))
        out[name] = (m.fit(verbose=False, callback=cb), labels, m)
    return out


def test_fit_matches_jax_in_lockstep():
    """Three EM iterations from the same init with short M-step solves
    (6 L-BFGS steps, where the two solvers still move in lockstep): every
    cost row within rtol 1e-5 (measured ~2e-6), the per-iteration params
    within rtol 1e-3, and the same labels at every iteration."""
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3, max_iter=3, seed=1,
                          min_iter=0, threshold=1e-12, mstep_iters=6,
                          pad_h=8, pad_w=8)
    out = _paired_fits(cfg, seed=0)
    (rj, lj, mj), (rt, lt, mt) = out["jax"], out["torch"]
    assert rt.cost_vec.shape == rj.cost_vec.shape == (3, 4)
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-5)
    np.testing.assert_allclose(rt.params_list, rj.params_list, rtol=1e-3,
                               atol=1e-4)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    assert (rt.iter_id1, rt.iter_id2) == (rj.iter_id1, rj.iter_id2)
    # the numpy RNG stream advanced draw for draw
    assert mt._rng.bit_generator.state == mj._rng.bit_generator.state


@pytest.mark.parametrize("method", ["expansion", "swap"])
def test_fit_with_polish_matches_jax_in_lockstep(method):
    """The lockstep fit above with the final exact polish on: the default
    config's expansion moves, and swap moves. The iterations agree as
    above, and the polished final labels are identical to the JAX
    package's (both polishes are exact move-making from the same start and
    the same moments)."""
    cfg = PhyloHMRFConfig(n_states=3, max_iter=3, seed=1, min_iter=0,
                          threshold=1e-12, mstep_iters=6, pad_h=8, pad_w=8,
                          polish_method=method)
    assert cfg.final_polish
    out = _paired_fits(cfg, seed=0)
    (rj, lj, _), (rt, lt, mt) = out["jax"], out["torch"]
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-5)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    st = mt.polish_stats_
    assert st.moves > 0 and st.pr_iterations > 0 and st.capped == 0
    assert "final_polish" in mt.timer.summary()
    # the polish relabeled pixels of the best iteration's E-step labels
    assert (rt.labels != lt[rt.iter_id2]).any()


def test_fit_matches_jax_default_solver():
    """The same with the default 150-step M-step. Iteration 0 runs before
    any M-step: rtol 1e-6. The OU objective is not convex and the two
    float32 solvers land in nearby but different minima, which moves the
    later cost rows by up to 1.4e-2 absolute (measured 5e-3 to 1.4e-2 on
    three seeds; 7.5e-3 on this one): atol 1.5e-2 there, and label
    agreement >= 0.97 at every iteration."""
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3, max_iter=3, seed=1,
                          min_iter=0, threshold=1e-12, pad_h=8, pad_w=8)
    out = _paired_fits(cfg, seed=1)
    (rj, lj, _), (rt, lt, _) = out["jax"], out["torch"]
    np.testing.assert_allclose(rt.cost_vec[0], rj.cost_vec[0], rtol=1e-6)
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=0, atol=1.5e-2)
    for a, b in zip(lt, lj):
        assert (a == b).mean() >= 0.97
    assert np.isfinite(rt.cost_vec).all()


def test_port_fit_from_its_own_init(tmp_path):
    """A whole port fit on CPU, k-means init included (test_em.py's
    fitted_synth config), states tracked per iteration: costs finite,
    cost1 == pairwise + unary per row,
    the states recovered (best-match accuracy > 0.9, the JAX test's gate),
    and the result written and read back in the reference .mat schema."""
    from phylo_hmrf_tpu_torch.utils import (best_match_accuracy,
                                            load_estimate, save_estimate)

    regions, true = synth_problem(np.random.default_rng(0), H0=24)
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3, max_iter=8, seed=1,
                          min_iter=2, mstep_iters=80, pad_h=8, pad_w=8)
    model = PhyloHMRF(TREE, regions, cfg, device="cpu")
    res = model.fit(verbose=False, track_states=True)
    assert res.n_iters >= 3
    assert res.state_list.shape == (res.n_iters, model.n_samples)
    assert np.isfinite(res.cost_vec).all()
    np.testing.assert_allclose(res.cost_vec[:, 3],
                               res.cost_vec[:, 1] + res.cost_vec[:, 2],
                               rtol=1e-6)
    assert res.cost_vec[-1, 3] <= res.cost_vec[0, 3] + 1e-6
    assert best_match_accuracy(res.labels, true) > 0.9
    assert res.labels.shape == (model.n_samples,)
    path = save_estimate(res, model.len_vec, str(tmp_path), 0,
                         cfg.lambda_0, cfg.n_states)
    got = load_estimate(path)
    for key in ("state_vec", "len_vec", "params_vec1", "params_vec2",
                "iter_id1", "iter_id2", "cost_vec"):
        assert key in got
    np.testing.assert_array_equal(got["state_vec"].ravel(), res.labels)


def test_state_roundtrip_between_port_models():
    """export_state / import_state carry the whole fit state: a second
    port model fed the first one's state runs the same next iteration."""
    regions, _ = synth_problem(np.random.default_rng(2), H0=16)
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3, max_iter=2, seed=4,
                          min_iter=0, threshold=1e-12, mstep_iters=10,
                          pad_h=8, pad_w=8)
    a = PhyloHMRF(TREE, regions, cfg, device="cpu")
    a.initialize()
    state = export_state(a)
    assert {"params_vec", "init_ou_params", "means", "covars",
            "init_labels", "rng_state", "labels_local_0",
            "labels_local_1"} <= set(state)
    b = PhyloHMRF(TREE, regions, cfg, device="cpu")
    import_state(b, state)
    ra, rb = a.fit(verbose=False), b.fit(verbose=False)
    np.testing.assert_array_equal(ra.cost_vec, rb.cost_vec)
    np.testing.assert_array_equal(ra.params_list, rb.params_list)
    bad = dict(state)
    del bad["labels_local_1"]
    with pytest.raises(ValueError):
        import_state(b, bad)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    regions, _ = synth_problem(np.random.default_rng(0), H0=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PhyloHMRF(TREE, regions, PhyloHMRFConfig(final_polish=False,
                                                 n_states=3), device="cuda")


@pytest.mark.parametrize("kw", [dict(kmeans_backend="sklearn")])
def test_unsupported_config_raises(kw):
    """What the port does not run raises: the scikit-learn k-means (every
    labeler runs: tests/test_torch_labelers.py; the float64 mode runs:
    tests/test_torch_f64.py)."""
    regions, _ = synth_problem(np.random.default_rng(0), H0=8)
    base = dict(n_states=3)
    base.update(kw)
    with pytest.raises(NotImplementedError):
        PhyloHMRF(TREE, regions, PhyloHMRFConfig(**base), device="cpu")


def test_unsupported_run_options_raise(tmp_path):
    """A mesh that is not the port's `Mesh` raises (meshes from
    `parallel.mesh.make_mesh` run: tests/test_torch_halo.py), and the
    command line refuses an incomplete multi-process run before it reads
    any input: a process count without a coordinator, a coordinator
    without a process count (multi-process runs:
    tests/test_torch_multiproc.py; checkpoint/resume runs:
    tests/test_torch_cli.py; every labeler runs:
    tests/test_torch_labelers.py)."""
    from phylo_hmrf_tpu_torch.cli import main

    regions, _ = synth_problem(np.random.default_rng(0), H0=8)
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3)
    with pytest.raises(TypeError, match="make_mesh"):
        PhyloHMRF(TREE, regions, cfg, mesh=object(), device="cpu")
    base = ["-p", str(tmp_path / "absent"), "--output", str(tmp_path),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="--coordinator"):
        main(base + ["--num_processes", "2"])
    with pytest.raises(ValueError, match="--num_processes"):
        main(base + ["--coordinator", "localhost:1234"])

"""The port's pipelined EM loop on the CPU: the L-BFGS step function run
in chunks with no host read against the plain driver, the pipelined fit
(``em_pipeline=True``) against the sequential one for several labelers,
a rolled-back speculation, the JAX package's pipelined fit, checkpoint
and resume, and two processes. All on the in-repo tree
(``synth.bench_tree``)."""

import math
import os

import numpy as np
import pytest
import torch

import phylo_hmrf_tpu_torch.models.hmrf as hmrf_mod
from phylo_hmrf_tpu_torch import PhyloHMRF
from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
from phylo_hmrf_tpu_torch.data.regions import (flat_index_order,
                                               region_from_samples)
from phylo_hmrf_tpu_torch.ops.lbfgs import (_LS_ETAS, box_decode, box_encode,
                                            lbfgs_init, lbfgs_step,
                                            minimize_lbfgs)
from phylo_hmrf_tpu_torch.synth import bench_tree, ou_moments_np

torch.set_num_threads(1)

TREE = bench_tree()


def synth_problem(seed, K=3, H0=16, noise=0.35):
    """Blocky labels with OU-Gaussian emissions on one diagonal and one
    off-diagonal region (tests/test_torch_fit.py's problem, built with the
    port's modules)."""
    rng = np.random.default_rng(seed)
    params = rng.random((K, TREE.n_params)) * 0.5 + 0.2
    for c in range(K):
        params[c, TREE.n_params - TREE.n_nodes:] = 0.6 * c + 0.3
    moments = [ou_moments_np(params[c], TREE) for c in range(K)]
    regions = []
    for ridx, (h0, w0, is_diag) in enumerate(
            [(H0, H0, True), (H0 // 2, H0, False)]):
        ii, jj = np.indices((h0, w0))
        lab = ((ii // 6 + jj // 6) % K).astype(np.int32)
        rows, cols = flat_index_order(h0, w0, is_diag)
        x = np.stack([rng.multivariate_normal(
            moments[c][0], (moments[c][1] + 1e-3 * np.eye(4)) * noise)
            for c in lab[rows, cols]]).astype(np.float32)
        regions.append(region_from_samples(
            np.abs(x) + 0.05, h0, w0, is_diag, pad_h=8, pad_w=8,
            region_id=ridx))
    return regions


# --------------------------------------------------------------- solver --

def _chunked(fn, x0, n_iters, chunk, tol, patience=5):
    """The graph driver's schedule on the CPU: ceil(n_iters / chunk)
    chunks of ``chunk`` steps, no read of the rows' flags. Returns (x, f,
    steps run)."""
    etas_t = torch.as_tensor(_LS_ETAS, dtype=x0.dtype)
    carry = lbfgs_init(fn, x0)
    for _ in range(math.ceil(n_iters / chunk)):
        for _ in range(chunk):
            carry = lbfgs_step(fn, carry, etas_t, tol, patience, n_iters)
    return carry.x, carry.f, int(carry.it)


def _rosenbrock():
    """Row-wise Rosenbrock of different stiffness
    (tests/test_torch_mstep.py::test_batched_lbfgs_freezes_stopped_rows):
    the rows stall at different steps."""
    scales = torch.tensor([1.0, 30.0, 0.01])

    def fn(x):
        return ((1 - x[..., 0]) ** 2
                + scales * 100 * (x[..., 1] - x[..., 0] ** 2) ** 2)
    return fn, torch.tensor([[0.1, 0.2], [-0.5, 0.3], [0.4, 0.1]]), 200


def _ou():
    """The M-step objective of 4 states on random statistics, boxed."""
    from phylo_hmrf_tpu_torch.models.ou import ou_nll_stats, tree_tensors

    rng = np.random.default_rng(7)
    K, F, n = 4, TREE.n_leaves, 3000
    X = np.abs(rng.normal(size=(n, F))) * 0.5 + 0.2
    g = rng.dirichlet(np.ones(K), size=n)
    post, obs = (torch.from_numpy(a.astype(np.float32))
                 for a in (g.sum(0), g.T @ X))
    obs2 = torch.from_numpy(
        np.einsum("nk,nf,ng->kfg", g, X, X).astype(np.float32))
    p0 = rng.random((K, TREE.n_params)) * 0.8 + 0.2
    p0[:, TREE.n_params - TREE.n_nodes:] = rng.random((K, TREE.n_nodes)) + .3
    tt = tree_tensors(TREE, "cpu")
    lo, hi = 1e-16, 100.0

    def fn(z):
        return ou_nll_stats(box_decode(z, lo, hi), post, obs, obs2, tt,
                            float(n), 1.0, 1e-3)
    return fn, box_encode(torch.from_numpy(p0.astype(np.float32)), lo,
                          hi), 150


@pytest.mark.parametrize("problem", ["rosenbrock", "ou"])
@pytest.mark.parametrize("chunk", [1, 7, "n_iters"])
def test_chunked_steps_match_plain_driver(problem, chunk):
    """Whole runs of `lbfgs_step` in chunks with no host read (1, 7 and
    n_iters steps a chunk) equal the plain driver's early-exit loop
    bitwise, though they run steps after rows (or all rows) stopped."""
    fn, x0, n_iters = _rosenbrock() if problem == "rosenbrock" else _ou()
    calls = {"n": 0}

    def counted(x):
        calls["n"] += 1
        return fn(x)
    x_plain, f_plain = minimize_lbfgs(counted, x0, n_iters, tol=1e-7)
    plain_steps = (calls["n"] - 1) // 2     # the init, then 2 calls a step
    n = n_iters if chunk == "n_iters" else chunk
    x, f, steps = _chunked(fn, x0, n_iters, n, tol=1e-7)
    assert steps == math.ceil(n_iters / n) * n
    assert plain_steps < steps     # frozen steps ran, and changed no bit
    np.testing.assert_array_equal(x.numpy(), x_plain.numpy())
    np.testing.assert_array_equal(f.numpy(), f_plain.numpy())


def test_step_counter_stops_rows_at_n_iters():
    """With tol 0 no row stalls: the counter alone stops every row at
    n_iters, so a chunk running past it changes nothing."""
    fn, x0, _ = _rosenbrock()
    x_plain, f_plain = minimize_lbfgs(fn, x0, 9, tol=0.0)
    x, f, steps = _chunked(fn, x0, 9, 4, tol=0.0)
    assert steps == 12
    np.testing.assert_array_equal(x.numpy(), x_plain.numpy())
    np.testing.assert_array_equal(f.numpy(), f_plain.numpy())


# ------------------------------------------------------------------ fit --

def _cfg(**kw):
    base = dict(n_states=3, max_iter=6, seed=1, mstep_iters=30, pad_h=8,
                pad_w=8, min_iter=0, final_polish=False)
    base.update(kw)
    return PhyloHMRFConfig(**base)


def _fit(cfg, regions, **fit_kw):
    """A port fit from its own init on the CPU, with the order of its
    E-step calls and M-step finalizations ("E" / "F")."""
    model = PhyloHMRF(TREE, regions, cfg, device="cpu")
    order = []
    estep, finalize = model.estep, model.mstep_finalize

    def logged_estep(*a, **k):
        order.append("E")
        return estep(*a, **k)

    def logged_finalize(h):
        order.append("F")
        return finalize(h)
    model.estep, model.mstep_finalize = logged_estep, logged_finalize
    return model.fit(verbose=False, **fit_kw), model, "".join(order)


def _assert_same_fit(a, b):
    (r1, m1), (r0, m0) = a, b
    np.testing.assert_array_equal(r1.cost_vec, r0.cost_vec)
    np.testing.assert_array_equal(r1.params_list, r0.params_list)
    np.testing.assert_array_equal(r1.labels, r0.labels)
    np.testing.assert_array_equal(r1.params_vec, r0.params_vec)
    np.testing.assert_array_equal(m1.params_vec, m0.params_vec)
    np.testing.assert_array_equal(m1.means_, m0.means_)
    np.testing.assert_array_equal(m1.covars_, m0.covars_)
    assert m1._rng.bit_generator.state == m0._rng.bit_generator.state


@pytest.mark.parametrize("labeler", ["mf_icm", "swap", "swap_tpu",
                                     "mf_icm+swap@2"])
def test_pipelined_fit_matches_sequential(labeler):
    """em_pipeline=True and False agree bitwise: cost rows, per-iteration
    params, labels, params_vec, the moments and the numpy RNG state. The
    pipelined loop enqueued the next E-step before finalizing the M-step
    ("EEF"), except for the host labeler, which reads the float64 host
    moments and cannot speculate."""
    regions = synth_problem(3)
    polish = labeler == "mf_icm"
    r1, m1, order1 = _fit(_cfg(labeler=labeler, final_polish=polish),
                          regions)
    r0, m0, order0 = _fit(_cfg(labeler=labeler, final_polish=polish,
                               em_pipeline=False), regions)
    assert r1.cost_vec.shape[0] > 2
    assert r1.cost_vec[0, 3] != r1.cost_vec[-1, 3]   # the run moved
    _assert_same_fit((r1, m1), (r0, m0))
    assert m1._mstep_rollbacks_ == m0._mstep_rollbacks_ == 0
    assert "EF" * (r0.n_iters - 1) in order0 and "EE" not in order0
    assert ("EE" in order1) == (labeler != "swap")
    if labeler == "mf_icm+swap@2":
        assert m1.hybrid_exact_iters_ == m0.hybrid_exact_iters_
        assert len(m1.exact_stats_) == len(m0.exact_stats_) > 0


def _failing_solve(fail_at):
    """`_mstep_solve_full` whose call number ``fail_at`` reports every
    state invalid (its solve and moments unchanged)."""
    real = hmrf_mod._mstep_solve_full
    calls = {"n": 0}

    def solve(*a, **k):
        solved, valid, means, covars = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == fail_at:
            valid = torch.zeros_like(valid)
        return solved, valid, means, covars
    return solve


def test_pipelined_rollback_matches_sequential(monkeypatch):
    """An invalid attempt-0 solve at iteration 1 rolls the speculative
    E-step back and it is enqueued again: the trajectory equals the
    sequential loop's under the same failure, one rollback in both."""
    regions = synth_problem(4)
    out = {}
    for pipe in (True, False):
        monkeypatch.setattr(hmrf_mod, "_mstep_solve_full", _failing_solve(2))
        r, m, order = _fit(_cfg(max_iter=5, em_pipeline=pipe), regions)
        out[pipe] = (r, m)
        if pipe:   # the dropped speculative E-step, then its redo
            assert "EEFE" in order
    monkeypatch.undo()
    _assert_same_fit(out[True], out[False])
    assert out[True][1]._mstep_rollbacks_ == 1
    assert out[False][1]._mstep_rollbacks_ == 1


def test_checkpointed_pipelined_run_resumes_bitwise(tmp_path):
    """A pipelined run with a checkpoint every 2 iterations, stopped at
    iteration 4 and resumed by a new model, equals the uninterrupted run
    bitwise."""
    regions = synth_problem(5)
    cfg = _cfg(max_iter=7, threshold=0.0, patience=99)
    ck = str(tmp_path / "ck.npz")
    full, mfull, _ = _fit(cfg, regions)

    def stop(m, it, row, grids):
        if it == 4:
            raise KeyboardInterrupt
    with pytest.raises(KeyboardInterrupt):
        _fit(cfg, regions, checkpoint_path=ck, checkpoint_every=2,
             callback=stop)
    resumed, mres, _ = _fit(cfg, regions, checkpoint_path=ck,
                            checkpoint_every=2, resume=True)
    assert full.n_iters == resumed.n_iters == 7
    _assert_same_fit((resumed, mres), (full, mfull))


def _paired(cfg_kw, monkeypatch=None, fail_at=None):
    """The JAX package's and the port's pipelined fits from the JAX
    model's initialize(); with ``fail_at`` both with that M-step solve
    reported invalid."""
    pytest.importorskip("jax")
    import phylo_hmrf_tpu.models.hmrf as jax_hmrf
    import jax.numpy as jnp
    from phylo_hmrf_tpu.config import PhyloHMRFConfig as JaxConfig
    from phylo_hmrf_tpu_torch.convert import export_state, import_state

    regions = synth_problem(6)
    jm = jax_hmrf.PhyloHMRF(TREE, regions, JaxConfig(**cfg_kw))
    jm.initialize()
    tm = PhyloHMRF(TREE, regions, PhyloHMRFConfig(**cfg_kw), device="cpu")
    import_state(tm, export_state(jm))
    if fail_at is not None:
        real_j = jax_hmrf._mstep_solve_full
        calls = {"n": 0}

        def solve_j(*a, **k):
            solved, valid, means, covars = real_j(*a, **k)
            calls["n"] += 1
            if calls["n"] == fail_at:
                valid = jnp.zeros_like(valid)
            return solved, valid, means, covars
        monkeypatch.setattr(jax_hmrf, "_mstep_solve_full", solve_j)
        monkeypatch.setattr(hmrf_mod, "_mstep_solve_full",
                            _failing_solve(fail_at))
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


LOCKSTEP = dict(final_polish=False, n_states=3, max_iter=3, seed=1,
                min_iter=0, threshold=1e-12, mstep_iters=6, pad_h=8,
                pad_w=8)


@pytest.mark.parametrize("fail_at", [None, 2])
def test_pipelined_fit_matches_jax(monkeypatch, fail_at):
    """The port's pipelined fit against the JAX package's pipelined fit
    from the same state, within the tolerances of
    tests/test_torch_fit.py::test_fit_matches_jax_in_lockstep (cost rows
    rtol 1e-5, params rtol 1e-3, identical labels); with the iteration-1
    solve reported invalid in both, both roll back once."""
    out = _paired(LOCKSTEP, monkeypatch, fail_at)
    (rj, lj, mj), (rt, lt, mt) = out["jax"], out["torch"]
    assert mj.cfg.em_pipeline and mt.cfg.em_pipeline
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-5)
    np.testing.assert_allclose(rt.params_list, rj.params_list, rtol=1e-3,
                               atol=1e-4)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    assert mt._mstep_rollbacks_ == mj._mstep_rollbacks_ == (
        0 if fail_at is None else 1)
    assert mt._rng.bit_generator.state == mj._rng.bit_generator.state


# -------------------------------------------------------- two processes --

def test_two_process_pipelined_fit_matches_single(tmp_path):
    """The pipelined fit as two processes of tests/test_torch_multiproc.py's
    fit worker (its 4-region problem, 3 iterations; each checkpointing
    every 2 iterations: the drain before a save runs between the
    collectives) equals the one-process pipelined fit and the two-process
    sequential fit bitwise."""
    from test_torch_multiproc import _run_workers

    single = _run_workers(1)[0]
    multi = _run_workers(2, lambda pid: [
        "--checkpoint", str(tmp_path / f"ck_{pid}.npz")])
    seq = _run_workers(2, lambda pid: ["--sequential"])
    assert os.path.exists(tmp_path / "ck_0.npz")
    for key in ("cost_vec", "params_vec", "params_vec1"):
        for pid in (0, 1):
            np.testing.assert_array_equal(np.asarray(multi[pid][key]),
                                          np.asarray(single[key]))
            np.testing.assert_array_equal(np.asarray(seq[pid][key]),
                                          np.asarray(single[key]))
    assert multi[0]["n_iters"] == single["n_iters"] == 3

"""The port's float64 strict-parity mode against the JAX engine's, on CPU.

JAX's float64 mode needs ``jax_enable_x64``, which is process-wide: every
test here that uses it turns it on and off again inside ``try/finally``
(as tests/test_em.py::test_f64_parity_mode does), and every such test is
in this one file, so one worker runs them all (``--dist loadfile``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from phylo_hmrf_tpu.config import PhyloHMRFConfig  # noqa: E402
from phylo_hmrf_tpu_torch import PhyloHMRF  # noqa: E402
from phylo_hmrf_tpu_torch.convert import export_state, import_state  # noqa
from phylo_hmrf_tpu_torch.models import hmrf as port_hmrf  # noqa: E402
from phylo_hmrf_tpu_torch.ops import loops  # noqa: E402
from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from phylo_hmrf_tpu_torch.synth import bench_tree  # noqa: E402
from tests.test_torch_fit import synth_problem  # noqa: E402

torch.set_num_threads(1)

TREE = bench_tree()
CPU = torch.device("cpu")


class x64:
    """``jax_enable_x64`` on inside the block, off after it."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _cfg(**kw):
    base = dict(dtype="float64", n_states=3, max_iter=3, seed=1, min_iter=0,
                threshold=1e-12, mstep_iters=10, pad_h=8, pad_w=8)
    base.update(kw)
    return PhyloHMRFConfig(**base)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _moments(rng, K=3, F=4):
    means = rng.random((K, F)) + 0.3
    a = rng.normal(size=(K, F, F)) * 0.2
    covars = a @ a.transpose(0, 2, 1) + 0.3 * np.eye(F)
    return means, covars


def test_f64_unary_matches_jax_and_host():
    """The port's float64 K-major unary (its fixed-order form) against the
    JAX engine's ``_UNARY_JIT`` under x64 and the float64 host
    ``_gauss_logpdf_np`` of the reference's semantics, rtol 1e-9 (the JAX
    gate of tests/test_em.py::test_f64_parity_mode)."""
    from phylo_hmrf_tpu.models.hmrf import _UNARY_JIT, _gauss_logpdf_np
    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf_kmajor

    rng = np.random.default_rng(0)
    regions, _ = synth_problem(rng, H0=16)
    r = regions[0]
    means, covars = _moments(rng)
    port = -gaussian_logpdf_kmajor(_t(r.img[None]).double(), _t(means),
                                   _t(covars))[0].permute(1, 2, 0).numpy()
    assert port.dtype == np.float64
    with x64():
        ref = np.asarray(_UNARY_JIT(jnp.asarray(r.img, jnp.float64),
                                    jnp.asarray(means), jnp.asarray(covars)))
    assert ref.dtype == np.float64
    host = np.stack([-_gauss_logpdf_np(r.flat_values().astype(np.float64),
                                       means[c], covars[c], 1e-3)
                     for c in range(3)], axis=1)
    at = (r.flat_rows, r.flat_cols)
    np.testing.assert_allclose(port[at], ref[at], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(port[at], host, rtol=1e-9, atol=1e-9)


def _labeled_problem(rng, K=3):
    regions, _ = synth_problem(rng, H0=16)
    r = regions[0]
    means, covars = _moments(rng, K)
    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf
    logprob = gaussian_logpdf(_t(r.img).double(), _t(means), _t(covars))
    labels = rng.integers(0, K, r.shape).astype(np.int32)
    w = np.exp(-0.5 * r.dmaps.astype(np.float64))
    return r, logprob.numpy(), labels, w


def test_pinned_stats_and_energy_match_jax():
    """The float64 statistics, costs and energy of the port's plain
    versions (the (H, W, K) references and K3/K4's K-major plain versions)
    against JAX's pinned ``_sufficient_stats_pinned``,
    ``posteriors_and_costs`` and ``potts_energy`` in float64, rtol 1e-12."""
    from phylo_hmrf_tpu.ops import potts as jp
    from phylo_hmrf_tpu_torch.ops import finish_kernels as fk
    from phylo_hmrf_tpu_torch.ops import potts as tp

    rng = np.random.default_rng(1)
    r, logprob, labels, w = _labeled_problem(rng)
    K, beta = 3, 1.3
    mask = r.mask
    tl, tw, tm = _t(labels), _t(w), _t(mask)
    pp = tp.pairwise_potential(tl, tw, K, beta)
    post_t, cost_t, _ = tp.posteriors_and_costs(_t(logprob), tl, pp, tm)
    stats_t = tp.sufficient_stats(post_t, _t(r.img).double(), tm)
    energy_t = tp.potts_energy(tl, -_t(logprob), tw, tm, beta)
    # K-major plain versions of K3 / K4
    lp_k = _t(logprob).permute(2, 0, 1)[None].contiguous()
    img_f = _t(r.img).double().permute(2, 0, 1)[None].contiguous()
    mask_i = tm.to(torch.int32)[None]
    post4, obs4, obs24, sums4 = fk.finish_stats_plain(
        lp_k, img_f, mask_i, tl[None], tw[None], beta, 1e-16)
    cost4, _ = fk.cost_vec_from_sums(sums4)
    energy3 = fk.potts_energy_plain(-lp_k, mask_i, tl[None], tw[None], beta)
    with x64():
        jl, jw, jm = jnp.asarray(labels), jnp.asarray(w), jnp.asarray(mask)
        jpp = jp.pairwise_potential(jl, jw, K, beta)
        post_j, cost_j, _ = jp.posteriors_and_costs(jnp.asarray(logprob), jl,
                                                    jpp, jm)
        stats_j = jp._sufficient_stats_pinned(
            post_j, jnp.asarray(r.img, jnp.float64), jm)
        energy_j = jp.potts_energy(jl, -jnp.asarray(logprob), jw, jm, beta)
        assert post_j.dtype == jnp.float64
        stats_j = [np.asarray(s) for s in stats_j]
        cost_j, energy_j = np.asarray(cost_j), float(energy_j)
    for a, b in zip(stats_t, stats_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12)
    for a, b in zip((post4[0], obs4[0], obs24[0]), stats_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12)
    np.testing.assert_allclose(cost_t.numpy(), cost_j, rtol=1e-12)
    np.testing.assert_allclose(cost4[0].numpy(), cost_j, rtol=1e-12)
    np.testing.assert_allclose(float(energy_t), energy_j, rtol=1e-12)
    np.testing.assert_allclose(float(energy3[0]), energy_j, rtol=1e-12)
    assert post4.dtype == energy3.dtype == torch.float64


def test_pinned_sums_fold_split_rows_bitwise():
    """The pinned order itself: a grid's row sums do not change with zero
    columns appended, and its rows split into 1, 2 or 4 blocks and folded
    block after block give bitwise the whole grid's fold."""
    from phylo_hmrf_tpu_torch.ops.potts import fold_rows, row_sums

    x = _t(np.random.default_rng(2).normal(size=(3, 24, 37)))
    whole = fold_rows(row_sums(x))
    padded = torch.cat([x, torch.zeros(3, 24, 91, dtype=x.dtype)], dim=-1)
    assert torch.equal(row_sums(padded), row_sums(x))
    for n in (1, 2, 4):
        rows = torch.cat([row_sums(b) for b in torch.chunk(x, n, dim=1)],
                         dim=-1)
        assert torch.equal(fold_rows(rows), whole)


def _estep_of(regions, cfg, mesh=None):
    """One float64 E-step of the port from a fixed state: (flat labels,
    post, obs, obs2, costs)."""
    m = PhyloHMRF(TREE, regions, cfg, mesh=mesh,
                  device=None if mesh else "cpu")
    rng = np.random.default_rng(7)
    means, covars = _moments(rng)
    warm = [r.labels_to_grid(rng.integers(0, 3, r.n_samples))
            for r in m.regions]
    grids, (p, o, o2), costs, _ = m.estep(means, covars, warm)
    return (m._flat_labels(grids), p, o, o2, costs)


def _two_regions(H0, pad_h, pad_w):
    """Two same-shape diagonal regions of the same samples at a padding."""
    from phylo_hmrf_tpu_torch.data.regions import region_from_samples
    src, _ = synth_problem(np.random.default_rng(3), H0=H0)
    vals = src[0].flat_values()
    return [region_from_samples(vals, H0, H0, True, pad_h=pad_h,
                                pad_w=pad_w, region_id=i) for i in range(2)]


@pytest.mark.parametrize("case", ["padded", "wide", "spatial1", "spatial2",
                                  "spatial4", "region3", "thin_spatial4"])
def test_f64_estep_bitwise_invariant(case):
    """The float64 E-step's labels, statistics and costs are bitwise the
    same for a region padded to a larger grid (rows and columns, or wider
    columns), over 1, 2 or 4 spatial shards (Hl = 8: K1/K2 on deep halos;
    ``thin``: Hl = 4, the K7/K8 route) and over a region mesh that deals a
    bucket of two regions over 3 shards (bucketing): the pinned order."""
    H0 = 16 if case.startswith("thin") else 32
    base = _estep_of(_two_regions(H0, 8, 8), _cfg())
    mesh, regions, cfg = None, _two_regions(H0, 8, 8), _cfg()
    if case == "padded":
        regions = _two_regions(H0, 16, 24)
    elif case == "wide":
        regions = _two_regions(H0, 8, 40)
    elif case[-8:-1] == "spatial":
        mesh = make_mesh((int(case[-1]),), devices=[CPU])
        cfg = _cfg(shard_mode="spatial")
    else:
        mesh = make_mesh((3,), devices=[CPU])
    got = _estep_of(regions, cfg, mesh)
    for a, b in zip(got, base):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _lockstep(cfg, jax_mesh=None, port_mesh=None):
    """A JAX float64 fit and the port's from the same state (convert.py);
    returns both results and their per-iteration flat labels."""
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF

    regions, _ = synth_problem(np.random.default_rng(0), H0=32)
    out = {}
    try:
        # the JAX model turns x64 on for the process itself, and warns
        with pytest.warns(UserWarning, match="x64"):
            jm = JaxPhyloHMRF(TREE, regions, cfg, mesh=jax_mesh)
        jm.initialize()
        tm = PhyloHMRF(TREE, regions, cfg, mesh=port_mesh,
                       device=None if port_mesh else "cpu")
        import_state(tm, export_state(jm))
        for name, m in (("jax", jm), ("torch", tm)):
            labels = []

            def cb(model, it, row, grids, labels=labels):
                labels.append(np.concatenate([
                    r.labels_to_flat(np.asarray(
                        g.cpu() if torch.is_tensor(g) else g))
                    for r, g in zip(model.regions, grids)]))
            out[name] = (m.fit(verbose=False, callback=cb), labels)
    finally:
        jax.config.update("jax_enable_x64", False)
    return out, tm


@pytest.mark.parametrize("labeler,mesh", [
    ("mf_icm", None), ("swap_tpu", None), ("icm", None),
    ("mf_icm", "region"), ("mf_icm", "spatial")])
def test_f64_fit_matches_jax_in_lockstep(labeler, mesh):
    """Three float64 EM iterations of the port against JAX's float64 fit
    from the same init, 10-step M-step solves: ``mf_icm`` with the default
    expansion polish, ``swap_tpu`` (exact swap moves every E-step),
    ``icm``; ``mf_icm`` over a region mesh of 8 shards (the JAX fit on its
    8 virtual CPU devices) and over a spatial mesh of 8 shards. JAX's
    float64 spatial mode raises (`test_jax_f64_spatial_raises`), so the
    port's spatial fit is held to JAX's single-device fit. The labels of
    every iteration and the final labels are identical; every cost row
    within rtol 1e-9 (measured on this problem: at most 6.0e-13, swap_tpu;
    1.2e-14 for the others)."""
    jax_mesh = port_mesh = None
    kw = {}
    if mesh:
        from phylo_hmrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        if mesh == "region":
            jax_mesh = jax_make_mesh((8,))
        port_mesh = make_mesh((8,), devices=[CPU])
        kw = dict(shard_mode=mesh)
    out, tm = _lockstep(_cfg(labeler=labeler, **kw), jax_mesh, port_mesh)
    (rj, lj), (rt, lt) = out["jax"], out["torch"]
    assert tm._dtype == torch.float64 and not tm._use_kernels
    assert tm._spatial == (mesh == "spatial")
    assert rt.cost_vec.shape == rj.cost_vec.shape == (3, 4)
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-9)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    if labeler == "mf_icm":
        assert tm.polish_stats_.moves > 0


def test_jax_f64_spatial_raises():
    """A reference-side fault, held here so a change shows: the JAX
    engine's float64 mode raises in its spatial E-step (the ICM loop's
    change count is int64 under x64, its carry int32: a ``TypeError`` from
    ``lax.while_loop``, ``phylo_hmrf_tpu/parallel/halo.py:243``). The
    port's float64 spatial E-step runs (`test_f64_estep_bitwise_invariant`,
    the spatial case of `test_f64_fit_matches_jax_in_lockstep`)."""
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF
    from phylo_hmrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    regions, _ = synth_problem(np.random.default_rng(0), H0=32)
    cfg = _cfg(shard_mode="spatial", max_iter=1, final_polish=False)
    try:
        with pytest.warns(UserWarning, match="x64"):
            jm = JaxPhyloHMRF(TREE, regions, cfg, mesh=jax_make_mesh((8,)))
        jm.initialize()
        with pytest.raises(TypeError, match="carry"):
            jm.fit(verbose=False)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_f32_model_after_f64_model_stays_f32():
    """Nothing of the float64 mode is process-wide: a float32 model built
    after a float64 one holds float32 tensors, keeps its kernel choice,
    and its E-step equals that of a float32 model built first; JAX's x64
    flag is not touched by the port."""
    regions, _ = synth_problem(np.random.default_rng(0), H0=16)
    f32 = _cfg(dtype="float32")
    before = _estep_of(regions, f32)
    m64 = PhyloHMRF(TREE, regions, _cfg(), device="cpu")
    assert m64._dtype == torch.float64
    assert not jax.config.jax_enable_x64
    m32 = PhyloHMRF(TREE, regions, f32, device="cpu")
    assert m32._dtype == torch.float32
    for _, img, _, dmaps in m32._bucket_arrays.values():
        assert img.dtype == dmaps.dtype == torch.float32
    assert m32._tt.A2T.dtype == torch.float32
    assert torch.get_default_dtype() == torch.float32
    after = _estep_of(regions, f32)
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device,dtype,kernels", [
    ("cpu", torch.float32, False), ("cpu", torch.float64, False),
    ("cuda", torch.float32, True), ("cuda", torch.float64, False),
    ("cuda:1", torch.float32, True), ("cuda:1", torch.float64, False)])
def test_kernel_choice_is_device_and_dtype(device, dtype, kernels):
    """The model's one kernel choice, `use_kernels`, as a table of the
    device and the dtype: the CUDA kernels run on a CUDA device in
    float32 only."""
    assert port_hmrf.use_kernels(device, dtype) is kernels
    assert port_hmrf.use_kernels(torch.device(device), dtype) is kernels


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_model_passes_its_choice_to_every_wrapper(monkeypatch, dtype):
    """The model decides once, `use_kernels` of its device and dtype, and
    passes the choice down: every kernel wrapper an E-step and a polish
    reach gets ``plain=not model._use_kernels`` (on the CPU, in either
    dtype, ``plain=True``; on a CUDA device in float64 too)."""
    from phylo_hmrf_tpu_torch.ops import (finish_kernels, icm_kernels,
                                          maxflow, mf_kernels)
    seen = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            seen.append((name, kw.get("plain", False)))
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    spy(mf_kernels, "mf_sweeps")
    spy(icm_kernels, "icm_sweep_pair")
    spy(finish_kernels, "potts_energy_pair")
    spy(finish_kernels, "finish_stats")
    monkeypatch.setattr(port_hmrf, "finish_stats", finish_kernels.finish_stats)
    monkeypatch.setattr(maxflow, "potts_energy_pair",
                        finish_kernels.potts_energy_pair)
    regions, _ = synth_problem(np.random.default_rng(0), H0=16)
    m = PhyloHMRF(TREE, regions, _cfg(dtype=dtype), device="cpu")
    assert m._use_kernels is False
    means, covars = _moments(np.random.default_rng(1))
    warm = [np.zeros(r.shape, np.int32) for r in m.regions]
    m.estep(means, covars, warm)
    m._exact_labels_all(means, covars, warm, method="expansion")
    names = {n for n, _ in seen}
    assert names == {"mf_sweeps", "icm_sweep_pair", "potts_energy_pair",
                     "finish_stats"}, names
    assert {p for _, p in seen} == {True}


@pytest.mark.parametrize("seed,max_sweeps", [(0, 3000), (1, 3000), (2, 3000),
                                             (3, 3000), (4, 10)])
def test_f64_cut_program_matches_jax(seed, max_sweeps):
    """The float64 cut graph's program (its captured units unrolled,
    ``tests/test_torch_f64loops.py``) against JAX's float64
    ``grid_mincut`` under x64, vmapped over the region batch as
    ``_cut_batch(use_pallas=False)`` runs it: the same source side,
    pixel for pixel (also where max_sweeps = 10 caps both loops)."""
    from phylo_hmrf_tpu.ops.maxflow_tpu import _cut_batch
    from tests.test_torch_f64loops import f64_cut, plain_cut_program

    excess0, cap_t0, caps0 = f64_cut(seed)
    R, H, W = excess0.shape
    # 40 periods of 32 iterations: more than these cuts need (the program
    # checks that its loops ended)
    got, _ = plain_cut_program(excess0, cap_t0, caps0, max_sweeps, 40,
                               (H * W + 2) // 16 + 1)
    with x64():
        want = np.asarray(_cut_batch(
            jnp.asarray(excess0.numpy()), jnp.asarray(cap_t0.numpy()),
            jnp.asarray(caps0.numpy()), max_sweeps, 32, False))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f64_icm_program_matches_jax(seed):
    """The float64 ICM graph's program (``icm_units`` unrolled) against
    JAX's float64 ``ops/icm.py::icm`` under x64, region by region: the
    same labels on every valid pixel (both run to their fixpoint)."""
    from phylo_hmrf_tpu.ops.icm import icm
    from tests.test_torch_f64loops import f64_icm, plain_icm_program

    unary, w, mask, init = f64_icm(seed)
    got, loop = plain_icm_program(unary, w, mask, init, 1.2, 60, 33)
    assert int(loop[loops.LOOP_LAST]) == 0      # converged, not capped
    with x64():
        want = np.stack([np.asarray(icm(
            jnp.asarray(unary[r].permute(1, 2, 0).numpy()),
            jnp.asarray(w[r].numpy()), jnp.asarray(mask[r].numpy()),
            jnp.asarray(init[r].numpy()), 1.2, 60))
            for r in range(unary.shape[0])])
    m = mask.numpy()
    np.testing.assert_array_equal(got.numpy()[m], want[m])

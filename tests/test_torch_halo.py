"""The port's multi-device E-steps (``parallel/halo.py``, ``sharding.py``)
and kernels K7/K8 against the JAX package, on CPU shards.

The port's meshes here are 8 shards on the CPU
(``make_mesh((8,), devices=[cpu])``); JAX runs on the 8 virtual CPU
devices of ``tests/conftest.py``. K7/K8 (``mf_sweeps_halo``,
``icm_sweep_halo_``) run as their plain versions (CPU tensors), held to the
Pallas kernels in interpret mode at the tiny shapes of
``tests/test_halo.py`` and to the per-shard route they replaced; their
row-source tables are checked without a card; the E-steps are held to the
JAX jnp halo path (``use_pallas=False``), which computes the same
functions.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from phylo_hmrf_tpu.config import PhyloHMRFConfig  # noqa: E402
from phylo_hmrf_tpu.data.regions import (  # noqa: E402
    flat_index_order, region_from_samples)
from phylo_hmrf_tpu_torch import PhyloHMRF  # noqa: E402
from phylo_hmrf_tpu_torch.convert import export_state, import_state  # noqa
from phylo_hmrf_tpu_torch.ops.halo_rows import (  # noqa: E402
    RowSource, device_groups, is_chained, row_sources)
from phylo_hmrf_tpu_torch.ops.icm_kernels import (  # noqa: E402
    icm_phase_halo_plain, icm_phase_plain, icm_sweep_halo_, icm_sweep_pair)
from phylo_hmrf_tpu_torch.ops.mf_kernels import (  # noqa: E402
    mf_sweep_halo_plain, mf_sweeps_halo, mf_sweeps_plain)
from phylo_hmrf_tpu_torch.parallel import halo  # noqa: E402
from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from phylo_hmrf_tpu_torch.synth import bench_tree  # noqa: E402
from tests.test_torch_fit import synth_problem  # noqa: E402

torch.set_num_threads(1)

TREE = bench_tree()
CPU8 = make_mesh((8,), devices=[torch.device("cpu")])


@pytest.fixture(scope="module")
def mesh8():
    from phylo_hmrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh((8,))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _halves(x, H1, fill_shape):
    """The two half-shards of x (rows on axis -2) with one exchanged row
    each, zeros at the grid ends (tests/test_halo.py's layout)."""
    z = np.zeros(fill_shape, x.dtype)
    top = np.concatenate([z, x[..., :H1 + 1, :]], axis=-2)
    bot = np.concatenate([x[..., H1 - 1:, :], z], axis=-2)
    return top, bot


def _stencil_inputs(rng, K=3, H=16, W=128):
    """q, base, unary, weights and labels on a 16 x 128 grid; weights of
    the edges leaving the grid are 0, as `edge_distance_maps` makes them
    (the zero end halos rely on it)."""
    q = rng.random((K, H, W)).astype(np.float32)
    q = (np.exp(q) / np.exp(q).sum(0)).astype(np.float32)
    base = rng.random((K, H, W)).astype(np.float32)
    w = rng.random((4, H, W)).astype(np.float32)
    w[1:, -1] = 0.0
    w[0, :, -1] = 0.0
    w[2, :, -1] = 0.0
    w[3, :, 0] = 0.0
    labels = rng.integers(0, K, (H, W)).astype(np.int32)
    return q, base, w, labels


# ------------------------------------------------------- K7 / K8 vs JAX --

def test_k7_plain_matches_jax_halo_kernel(rng):
    """The port's K7 plain version (``mf_sweeps_halo`` on CPU shards, one
    sweep) on two half-shards against `mf_sweep_pallas(halo_extended=True)`
    in interpret mode on each half with its exchanged rows: rtol 2e-4,
    atol 1e-6 (K1's gate)."""
    from phylo_hmrf_tpu.ops.mf_pallas import mf_sweep_pallas

    q, base, w, _ = _stencil_inputs(rng)
    K, H, W = q.shape
    H1 = H // 2
    T, damp, beta = 1.0, 0.5, 0.7
    w_h = _halves(w, H1, (4, 1, W))
    got = mf_sweeps_halo(
        [_t(q[None, :, :H1]), _t(q[None, :, H1:])],
        [_t(base[None, :, :H1]), _t(base[None, :, H1:])],
        [_t(we[None]) for we in w_h], T, damp, beta, n_sweeps=1,
        sources=row_sources(["cpu"] * 2, [H1] * 2))
    for part, (qe, we, b) in enumerate(zip(
            _halves(q, H1, (K, 1, W)), w_h, (base[:, :H1], base[:, H1:]))):
        want = mf_sweep_pallas(jnp.asarray(qe), jnp.asarray(b),
                               jnp.asarray(we), T, damp, beta,
                               halo_extended=True, interpret=True)
        np.testing.assert_allclose(got[part][0].numpy(), np.asarray(want),
                                   rtol=2e-4, atol=1e-6,
                                   err_msg=f"half {part}")


def test_k8_plain_matches_jax_halo_kernel(rng):
    """The port's K8 plain version (``icm_sweep_halo_`` on CPU shards, one
    sweep) on two half-shards against `icm_phase_pallas(halo_extended=True)`
    in interpret mode on each half, phase by phase with the label rows
    exchanged between phases and the phase parity offset by the shard's
    first row: identical labels after every phase (one phase a call), and
    after the whole sweep, with the changed count that of the labels."""
    from phylo_hmrf_tpu.ops.icm_pallas import icm_phase_pallas

    _, _, w, labels = _stencil_inputs(rng)
    K, H, W = 3, 16, 128
    unary_k = rng.random((1, K, H, W)).astype(np.float32)
    mask = (rng.random((1, H, W)) > 0.1).astype(np.int32)
    H1, beta = H // 2, 0.9
    w_h = [_t(we[None]) for we in _halves(w, H1, (4, 1, W))]
    halves = [slice(0, H1), slice(H1, H)]
    args = ([_t(unary_k[:, :, r]) for r in halves], w_h,
            [_t(mask[:, r]) for r in halves], beta)
    src = row_sources(["cpu"] * 2, [H1] * 2)
    cpu = torch.device("cpu")
    want = labels.copy()
    by_phase = [_t(labels[None, r].copy()) for r in halves]
    for phase, (a, b) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        lab_h = _halves(want, H1, (1, W))
        want = np.concatenate([np.asarray(icm_phase_pallas(
            jnp.asarray(lab_h[part][None]), jnp.asarray(unary_k[:, :, r]),
            jnp.asarray(w_h[part].numpy()), jnp.asarray(mask[:, r]), beta,
            (a + row0) % 2, b, halo_extended=True, interpret=True))[0]
            for part, (r, row0) in enumerate(zip(halves, (0, H1)))])
        icm_sweep_halo_(by_phase, *args, {cpu: torch.zeros(
            (), dtype=torch.int32)}, row0=[0, H1], sources=src,
            phase0=phase, n_phases=1)
        np.testing.assert_array_equal(
            torch.cat(by_phase, dim=1)[0].numpy(), want,
            err_msg=f"phase {(a, b)}")
    changed = {cpu: torch.zeros((), dtype=torch.int32)}
    sweep = [_t(labels[None, r].copy()) for r in halves]
    icm_sweep_halo_(sweep, *args, changed, row0=[0, H1], sources=src)
    np.testing.assert_array_equal(torch.cat(sweep, dim=1)[0].numpy(), want)
    assert int(changed[cpu]) == int((want != labels).sum())


# ----------------------------------------------------- split identities --

def _shards(x, n):
    return [c.contiguous() for c in torch.chunk(x, n, dim=-2)]


@pytest.mark.parametrize("case", ["k7", "k8", "k1_deep", "k2_deep"])
def test_split_identity_bitwise(rng, case):
    """Row shards with exchanged halos give bitwise the full-grid result:
    K7 on 4 shards of 4 rows against one K1 sweep; K8 on 4 shards (global
    parity) against a K2 phase, with its changed count; K1's 8 sweeps on 2 shards of 8 rows with
    8-row halos; K2's sweep pair likewise, parity offset by the slab's
    first global row. (Plain versions here; the card tests run the
    kernels.)"""
    q, base, w, labels = _stencil_inputs(rng)
    q, base, w, labels = (_t(x[None]) for x in (q, base, w, labels))
    unary = _t(rng.random(tuple(base.shape)).astype(np.float32))
    mask = _t((rng.random(tuple(labels.shape)) > 0.1).astype(np.int32))
    T, damp, beta = 0.5, 0.5, 0.8
    src4 = row_sources(["cpu"] * 4, [4] * 4)
    if case == "k7":
        want = mf_sweeps_plain(q, base, w, T, damp, beta, 1)
        got = mf_sweeps_halo(_shards(q, 4), _shards(base, 4),
                             halo.extend_rows(_shards(w, 4)), T, damp, beta,
                             n_sweeps=1, sources=src4)
    elif case == "k8":
        # the phase (a, b) = (1, 0), the third of a sweep
        want = icm_phase_plain(labels, unary, w, mask, beta, 1, 0)
        got = [x.clone() for x in _shards(labels, 4)]
        changed = {torch.device("cpu"): torch.zeros((), dtype=torch.int32)}
        icm_sweep_halo_(got, _shards(unary, 4),
                        halo.extend_rows(_shards(w, 4)), _shards(mask, 4),
                        beta, changed, row0=[0, 4, 8, 12], sources=src4,
                        phase0=2, n_phases=1)
        assert int(changed[torch.device("cpu")]) == int(
            (want != labels).sum())
    elif case == "k1_deep":
        want = mf_sweeps_plain(q, base, w, T, damp, beta, 8)
        got = [halo._center(mf_sweeps_plain(qe, be, we, T, damp, beta, 8), 8)
               for qe, be, we in zip(*(halo.extend_rows(_shards(x, 2), 8)
                                       for x in (q, base, w)))]
    else:
        want = icm_sweep_pair(labels, unary, w, mask, beta, plain=True)
        got = [halo._center(icm_sweep_pair(le, u, we, m, beta, plain=True,
                                           row_offset=8 * i - 8), 8)
               for i, (le, u, we, m) in enumerate(zip(
                   *(halo.extend_rows(_shards(x, 2), 8)
                     for x in (labels, unary, w, mask))))]
    assert torch.equal(torch.cat(got, dim=-2), want)


# ------------------------------------- K7 / K8 against the per-shard route --

# (shards, rows a shard, sweeps): 1-8 shards, heights 1-7, the K7 sweeps
# of one temperature at iters_per_temp 1, 8 and 12
HALO_ROUTE_CASES = [(1, 7, 1), (2, 1, 8), (2, 5, 12), (4, 3, 8), (4, 6, 1),
                    (4, 7, 12), (8, 2, 12), (8, 4, 8)]


@pytest.mark.parametrize("n_shards,rows,n_sweeps", HALO_ROUTE_CASES)
def test_halo_entries_match_per_shard_route(n_shards, rows, n_sweeps):
    """The new entries' plain route against the per-shard route they
    replaced (each sweep or phase `extend_rows` by one row, then the
    one-shard plain step on every shard, then `count_nonzero`), bitwise:
    K7's ``n_sweeps`` sweeps, and as many K8 sweeps, each with its changed
    count; on a ragged width (37 columns), K=3."""
    rng = np.random.default_rng(100 * n_shards + rows)
    K, H, W = 3, n_shards * rows, 37
    q, base, w, labels = _stencil_inputs(rng, K=K, H=H, W=W)
    unary = _t(rng.random((1, K, H, W)).astype(np.float32))
    mask = _t((rng.random((1, H, W)) > 0.1).astype(np.int32))
    q, base, w, labels = (_t(x[None]) for x in (q, base, w, labels))
    T, damp, beta = 0.5, 0.5, 0.8
    src = row_sources(["cpu"] * n_shards, [rows] * n_shards)
    w_ext = halo.extend_rows(_shards(w, n_shards))
    row0 = [i * rows for i in range(n_shards)]

    got = mf_sweeps_halo(_shards(q, n_shards), _shards(base, n_shards),
                         w_ext, T, damp, beta, n_sweeps=n_sweeps,
                         sources=src)
    want = _shards(q, n_shards)
    for _ in range(n_sweeps):
        want = [mf_sweep_halo_plain(qe, b, we, T, damp, beta)
                for qe, b, we in zip(halo.extend_rows(want),
                                     _shards(base, n_shards), w_ext)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    got = [x.clone() for x in _shards(labels, n_shards)]
    want = _shards(labels, n_shards)
    args = (_shards(unary, n_shards), w_ext, _shards(mask, n_shards), beta)
    for sweep in range(n_sweeps):
        changed = {torch.device("cpu"): torch.zeros((), dtype=torch.int32)}
        icm_sweep_halo_(got, *args, changed, row0=row0, sources=src)
        count = 0
        for a in (0, 1):
            for b in (0, 1):
                ext = halo.extend_rows(want)
                new = [icm_phase_halo_plain(le, u, we, m, beta,
                                            (a + r0) % 2, b)[:, 1:-1]
                       for le, u, we, m, r0 in zip(ext, *args[:3], row0)]
                count += sum(int(torch.count_nonzero(x != y))
                             for x, y in zip(new, want))
                want = new
        assert all(torch.equal(a, b) for a, b in zip(got, want)), sweep
        assert int(changed[torch.device("cpu")]) == count, sweep


def test_row_source_tables():
    """The row-source table without a card: a mesh dealt round-robin over
    two device labels reads every neighbour row remotely, over one label
    in place (one launch a device then chains the sweeps); the ends have no
    source; the rows are the neighbour's last (above) and first (below).
    The shards group by device, and a source read in place on another
    device is refused."""
    heights = [3, 5, 2, 4]
    one = row_sources(["d0"] * 4, heights)
    two = row_sources(["d0", "d1"] * 2, heights)
    assert one[0][0] is None and one[-1][1] is None
    assert two[0][0] is None and two[-1][1] is None
    for i in range(1, 4):
        assert one[i][0] == RowSource(i - 1, heights[i - 1] - 1, False)
        assert two[i][0] == RowSource(i - 1, heights[i - 1] - 1, True)
    for i in range(3):
        assert one[i][1] == RowSource(i + 1, 0, False)
        assert two[i][1] == RowSource(i + 1, 0, True)
    mixed = row_sources(["d0", "d0", "d1", "d1"], heights)
    assert [(u is not None and u.remote, d is not None and d.remote)
            for u, d in mixed] == [(False, False), (False, True),
                                   (True, False), (False, False)]
    with pytest.raises(ValueError):
        row_sources(["d0"] * 3, heights)

    assert is_chained(one) and not is_chained(two)
    assert not is_chained(mixed)
    # a source read in place must lie on its shard's device
    xs = [torch.zeros(1, h, 4, device=d) for h, d in
          zip(heights, ["cpu", "cpu", "meta", "meta"])]
    with pytest.raises(ValueError, match="remote"):
        device_groups(xs, one)
    groups = device_groups(xs, mixed)
    assert groups == {torch.device("cpu"): [0, 1],
                      torch.device("meta"): [2, 3]}


# ----------------------------------------------------- the spatial E-step --

def _problem(rng, H0=64, W0=64, K=4, F=3, is_diag=True):
    """tests/test_halo.py's problem: 64 x 64 padded to 64 x 128."""
    rows, _ = flat_index_order(H0, W0, is_diag)
    vals = (rng.random((rows.shape[0], F)) + 0.1).astype(np.float32)
    region = region_from_samples(vals, H0, W0, is_diag, pad_h=8, pad_w=128)
    means = rng.random((K, F)).astype(np.float32) * 1.2
    covs = np.stack([np.eye(F) * (0.3 + 0.1 * c) for c in range(K)]
                    ).astype(np.float32)
    warm = rng.integers(0, K, region.shape).astype(np.int32)
    return region, means, covs, warm


def _jax_rowsharded(mesh, iters_per_temp, **kw):
    """JAX `make_rowsharded_estep(use_pallas=False)` with an
    ``iters_per_temp`` of choice."""
    from jax.sharding import PartitionSpec as P

    from phylo_hmrf_tpu.parallel.halo import estep_region_rowsharded
    body = functools.partial(estep_region_rowsharded, axis="data",
                             iters_per_temp=iters_per_temp, **kw)
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("data"), P("data"), P(None, "data"), P("data"), P(), P(),
                  P(), P()),
        out_specs=(P("data"), (P(), P(), P()), P(), P()), check_vma=False))


SPATIAL_CASES = {
    # H0, is_diag, iters_per_temp: the branch the port takes on 8 shards
    "deep_diag": (64, True, 8),        # Hl = 8: K1 and K2 on 8-row halos
    "deep_offdiag": (64, False, 8),
    "k7_iters10": (64, True, 10),      # K7 per sweep, K2 deep
    "k7_k8_hl4": (32, True, 8),        # Hl = 4: K7 and K8
}


@pytest.mark.parametrize("case", list(SPATIAL_CASES))
def test_rowsharded_estep_matches_jax(mesh8, case):
    """The port's `make_rowsharded_estep` on 8 CPU shards against JAX's on
    the 8-device mesh (jnp halo path). The mean-field stages differ in
    float order (JAX folds wsum into the field every sweep, the kernel
    branch precomputes base), so labels may differ at near-ties: agreement
    > 0.995 of valid pixels, costs and stats rtol 2e-3 (the gates of
    test_torch_kernels.py::test_estep_bucket_matches_jax)."""
    H0, is_diag, ipt = SPATIAL_CASES[case]
    region, means, covs, warm = _problem(np.random.default_rng(0), H0=H0,
                                         is_diag=is_diag)
    kw = dict(weighted_pp=False, max_sweeps=40)
    lj, sj, cj, nj = _jax_rowsharded(mesh8, ipt, **kw)(
        jnp.asarray(region.img), jnp.asarray(region.mask),
        jnp.asarray(region.dmaps), jnp.asarray(warm), jnp.asarray(means),
        jnp.asarray(covs), jnp.float32(1.0), jnp.float32(0.5))
    lt, st, ct, nt = halo.make_rowsharded_estep(
        CPU8, iters_per_temp=ipt, **kw)(
        _t(region.img), _t(region.mask), _t(region.dmaps), _t(warm),
        _t(means), _t(covs), 1.0, 0.5)
    agree = (lt.numpy() == np.asarray(lj))[region.mask].mean()
    assert agree > 0.995, agree
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2e-3)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=1e-3)
    assert float(nt) == float(nj)


@pytest.mark.parametrize("case", ["deep_diag", "k7_k8_hl4"])
def test_rowsharded_estep_matches_single_device(case):
    """Without a JAX reference in the loop: the port's spatial E-step on 8
    CPU shards against its single-device `_estep_bucket` on the same
    inputs (same schedule, 8 sweeps per temperature): the halo exchange
    is exact, so labels, stats and costs are equal (measured bitwise on
    these shapes; gate rtol 1e-6), and a repeat is bitwise equal."""
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket

    H0, is_diag, _ = SPATIAL_CASES[case]
    region, means, covs, warm = _problem(np.random.default_rng(1), H0=H0,
                                         is_diag=is_diag)
    args = (_t(means), _t(covs), 1.0, 0.5)
    kw = dict(weighted_pp=True, max_sweeps=40)
    l1, s1, c1, n1 = _estep_bucket(
        _t(region.img[None]), _t(region.mask[None]), _t(region.dmaps[None]),
        _t(warm[None]), *args, **kw)
    fn = halo.make_rowsharded_estep(CPU8, **kw)
    inputs = (_t(region.img), _t(region.mask), _t(region.dmaps), _t(warm))
    l2, s2, c2, n2 = fn(*inputs, *args)
    np.testing.assert_array_equal(l2.numpy(), l1[0].numpy())
    for a, b in zip(s2, s1):
        np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(c2.numpy(), c1[0].numpy(), rtol=1e-6)
    assert float(n2) == float(n1[0])
    l3, s3, c3, _ = fn(*inputs, *args)
    assert torch.equal(l3, l2) and torch.equal(c3, c2)
    assert all(torch.equal(a, b) for a, b in zip(s3, s2))


@pytest.mark.parametrize("case", ["deep_offdiag", "k7_k8_hl4"])
def test_halo_energy_matches_whole_grid(rng, case):
    """`_energy_halo_pair` (K3's pair entry on each shard's slab, halo rows
    zero-weighted and masked; what the spatial E-step runs) on 8 CPU
    shards: each row equals the plain K3 of its labeling on the whole grid
    for random labels: each edge crossing a shard boundary is counted once.
    rtol 1e-6 (float64 sums in another order)."""
    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf_kmajor
    from phylo_hmrf_tpu_torch.ops.finish_kernels import potts_energy_plain
    from phylo_hmrf_tpu_torch.ops.potts import weight_maps

    H0, is_diag, _ = SPATIAL_CASES[case]
    region, means, covs, _ = _problem(rng, H0=H0, is_diag=is_diag)
    labs = [_t(rng.integers(0, 4, region.shape).astype(np.int32))[None]
            for _ in range(2)]
    unary = -gaussian_logpdf_kmajor(_t(region.img[None]), _t(means),
                                    _t(covs))
    w = weight_maps(_t(region.dmaps[None]), 0.5)
    mask = _t(region.mask[None]).to(torch.int32)
    pair = halo._energy_halo_pair(
        *(_shards(lab, 8) for lab in labs),
        [halo._zero_rows(u) for u in _shards(unary, 8)],
        [halo._zero_rows(x) for x in _shards(w, 8)],
        [halo._zero_rows(m) for m in _shards(mask, 8)], 0.9)
    assert pair.shape == (2, 1) and pair.dtype == torch.float64
    for row, lab in zip(pair, labs):
        want = float(potts_energy_plain(unary, mask, lab, w, 0.9)[0])
        assert abs(float(row[0]) - want) <= 1e-6 * abs(want)


def test_halo_energy_parity():
    """tests/test_halo.py::test_halo_energy_parity for the port: the MRF
    energy of the port's spatial labels on 8 CPU shards is within 0.1% of
    that of the JAX single-device labels."""
    from phylo_hmrf_tpu.models.hmrf import _estep_bucket as jax_estep
    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf
    from phylo_hmrf_tpu_torch.ops.potts import potts_energy, weight_maps

    region, means, covs, warm = _problem(np.random.default_rng(0))
    kw = dict(weighted_pp=False, max_sweeps=40)
    lj, _, _, _ = jax_estep(
        jnp.asarray(region.img[None]), jnp.asarray(region.mask[None]),
        jnp.asarray(region.dmaps[None]), jnp.asarray(warm[None]),
        jnp.asarray(means), jnp.asarray(covs), jnp.float32(1.0),
        jnp.float32(0.5), labeler="mf_icm", use_pallas=False, **kw)
    lt, _, _, _ = halo.make_rowsharded_estep(CPU8, **kw)(
        _t(region.img), _t(region.mask), _t(region.dmaps), _t(warm),
        _t(means), _t(covs), 1.0, 0.5)
    unary = -gaussian_logpdf(_t(region.img), _t(means), _t(covs))
    wm = weight_maps(_t(region.dmaps), 0.5)
    mask = _t(region.mask)
    e_j = float(potts_energy(_t(np.array(lj[0])), unary, wm, mask, 1.0))
    e_t = float(potts_energy(lt, unary, wm, mask, 1.0))
    assert abs(e_j - e_t) <= 0.001 * abs(e_j) + 1e-6


# ------------------------------------------------------ region sharding --

def _bucket(rng, n, K=3, F=3):
    """n same-shape 20 x 20 diagonal regions as one bucket."""
    regions = []
    for _ in range(n):
        rows, _ = flat_index_order(20, 20, True)
        vals = (rng.random((rows.shape[0], F)) + 0.1).astype(np.float32)
        regions.append(region_from_samples(vals, 20, 20, True, pad_h=8,
                                           pad_w=8))
    img = np.stack([r.img for r in regions])
    mask = np.stack([r.mask for r in regions])
    dmaps = np.stack([r.dmaps for r in regions])
    warm = rng.integers(0, K, mask.shape).astype(np.int32)
    means = np.stack([np.full(F, 0.2 + 0.25 * c) for c in range(K)]).astype(
        np.float32)
    covs = np.stack([0.02 * np.eye(F) + 0.005] * K).astype(np.float32)
    return img, mask, dmaps, warm, means, covs


def test_region_sharded_estep(mesh8):
    """5 regions padded to 8 and dealt over 8 CPU shards: against the
    port's single-device bucket the labels are identical and the stats
    and costs equal (rtol 1e-6; measured bitwise), the padding regions
    are empty; against JAX `make_sharded_estep` on the 8-device mesh the
    gates of test_estep_bucket_matches_jax (agreement > 0.995, rtol
    2e-3)."""
    from phylo_hmrf_tpu.parallel.sharding import make_sharded_estep as jmse
    from phylo_hmrf_tpu.parallel.sharding import pad_bucket_to_devices as jpad
    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket
    from phylo_hmrf_tpu_torch.parallel import sharding

    img, mask, dmaps, warm, means, covs = _bucket(np.random.default_rng(2), 5)
    kw = dict(weighted_pp=False, max_sweeps=60)
    args = (_t(means), _t(covs), 1.0, 0.5)
    l1, s1, c1, n1 = _estep_bucket(_t(img), _t(mask), _t(dmaps), _t(warm),
                                   *args, **kw)
    pimg, pmask, pdmaps, R = sharding.pad_bucket_to_devices(img, mask, dmaps,
                                                            8)
    for a, b in zip((pimg, pmask, pdmaps), jpad(img, mask, dmaps, 8)[:3]):
        np.testing.assert_array_equal(a, b)
    pwarm = np.concatenate([warm, np.zeros((3,) + warm.shape[1:], np.int32)])
    l2, s2, c2, n2 = sharding.make_sharded_estep(CPU8, **kw)(
        *sharding.device_put_bucket(CPU8, pimg, pmask, pdmaps), _t(pwarm),
        *args)
    assert R == 5 and l2.shape[0] == 8
    np.testing.assert_array_equal(l2[:R].numpy(), l1.numpy())
    for a, b in zip(s2, s1):
        np.testing.assert_allclose(a[:R].numpy(), b.numpy(), rtol=1e-6)
        assert not a[R:].any()
    np.testing.assert_allclose(c2[:R].numpy(), c1.numpy(), rtol=1e-6)
    assert not n2[R:].any()

    lj, sj, cj, _ = jmse(mesh8, labeler="mf_icm", use_pallas=False, **kw)(
        jnp.asarray(pimg), jnp.asarray(pmask), jnp.asarray(pdmaps),
        jnp.asarray(pwarm), *(jnp.asarray(a) for a in (means, covs)),
        jnp.float32(1.0), jnp.float32(0.5))
    agree = (l2[:R].numpy() == np.asarray(lj)[:R])[mask].mean()
    assert agree > 0.995, agree
    np.testing.assert_allclose(c2[:R].numpy(), np.asarray(cj)[:R],
                               rtol=2e-3)
    for a, b in zip(s2, sj):
        np.testing.assert_allclose(a[:R].numpy(), np.asarray(b)[:R],
                                   rtol=2e-3, atol=1e-3)


# ------------------------------------------------------------ whole fits --

def _spatial_cfg(mode, **kw):
    base = dict(n_states=3, max_iter=3, seed=1, min_iter=0, threshold=1e-12,
                mstep_iters=6, pad_h=8, pad_w=8, shard_mode=mode)
    base.update(kw)
    return PhyloHMRFConfig(**base)


@pytest.mark.parametrize("mode", ["spatial", "region"])
def test_meshed_fit_matches_jax_in_lockstep(mesh8, mode):
    """A meshed fit of the port on 8 CPU shards against the JAX meshed fit
    on the 8-device mesh, from the same state (convert.py), with 6-step
    M-step solves and the final expansion polish, on a 64 x 64 diagonal
    region (spatial: Hl = 8, the deep-halo K1/K2 branch) and a 32 x 64
    off-diagonal one (Hl = 4, the K7/K8 branch). Every cost row within
    rtol 1e-5 (measured: spatial 8.6e-7, region 1.6e-6), the labels of
    every iteration and the polished labels identical."""
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF

    regions, _ = synth_problem(np.random.default_rng(0), H0=64)
    cfg = _spatial_cfg(mode)
    jm = JaxPhyloHMRF(TREE, regions, cfg, mesh=mesh8)
    jm.initialize()
    tm = PhyloHMRF(TREE, regions, cfg, mesh=CPU8)
    import_state(tm, export_state(jm))
    out = {}
    for name, m in (("jax", jm), ("torch", tm)):
        labels = []

        def cb(model, it, row, grids, labels=labels):
            labels.append(np.concatenate([
                r.labels_to_flat(np.asarray(g.cpu() if torch.is_tensor(g)
                                            else g))
                for r, g in zip(model.regions, grids)]))
        out[name] = (m.fit(verbose=False, callback=cb), labels)
    (rj, lj), (rt, lt) = out["jax"], out["torch"]
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-5)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    assert tm.polish_stats_.moves > 0


def test_state_carries_into_meshed_models():
    """convert.py's state moves into a meshed model unchanged: a
    single-device port model's state, imported into spatial and region
    models on 8 CPU shards, gives the same E-step (labels identical,
    stats and costs rtol 1e-6) and the same next M-step."""
    regions, _ = synth_problem(np.random.default_rng(3), H0=16)
    single = PhyloHMRF(TREE, regions, _spatial_cfg("region"), device="cpu")
    single.initialize()
    state = export_state(single)
    want = single.estep(single.means_, single.covars_, single.labels_local)
    for mode in ("spatial", "region"):
        m = PhyloHMRF(TREE, regions, _spatial_cfg(mode), mesh=CPU8)
        import_state(m, state)
        got = m.estep(m.means_, m.covars_, m.labels_local)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
        np.testing.assert_array_equal(m.mstep(got[1]), single.mstep(want[1]))
        import_state(single, state)


# ------------------------------------------------------------- refusals --

def test_spatial_rejects_indivisible_rows():
    """tests/test_spatial_fit.py:44-52: a region whose H does not split
    over the mesh raises ValueError."""
    regions, _ = synth_problem(np.random.default_rng(0), H0=24)
    bad = region_from_samples(regions[1].flat_values(), regions[1].H0,
                              regions[1].W0, False, pad_h=4, pad_w=8)
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3, pad_h=4, pad_w=8,
                          shard_mode="spatial")
    with pytest.raises(ValueError, match="divisible"):
        PhyloHMRF(TREE, [bad], cfg, mesh=CPU8)


def test_spatial_rejects_hybrid_labeler():
    """tests/test_spatial_fit.py:55-60: spatial mode with another labeler
    than mf_icm raises ValueError (the row-sharded E-step is the mean
    field + ICM pipeline; region mode runs every labeler)."""
    regions, _ = synth_problem(np.random.default_rng(0), H0=32)
    cfg = PhyloHMRFConfig(final_polish=False, n_states=3, pad_h=8, pad_w=8,
                          shard_mode="spatial", labeler="mf_icm+swap@2")
    with pytest.raises(ValueError, match="spatial"):
        PhyloHMRF(TREE, regions, cfg, mesh=CPU8)

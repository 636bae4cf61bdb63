"""The loop graphs' programs of the float64 mode and of the one-card
row-sharded ICM (``ops/loops.py``, ``csrc/loops.cu``, ``parallel/halo.py``)
on CPU.

The card's graphs cannot run on the CPU, so these tests run the very units
the graphs capture (``loops.cut_units``, ``bfs_units``, ``icm_units``,
``halo.icm_pair_unit``, ``halo.icm_sweep_unit``) unrolled: a fixed number
of bodies with no word tested between them, the one-thread begin / cond
nodes written out in tensor code. They must give bitwise the labels and
the counts of the host-read loops (``grid_mincut_host(plain=True)``,
``_bfs_fixpoint``'s and ``icm_kmajor``'s host loops, the host loop of
``_icm_halo_kernels``) and the labels of the JAX package's loops
(``_icm_halo_pallas`` / ``_icm_halo`` here; JAX's float64
``grid_mincut`` and ``icm`` in ``tests/test_torch_f64.py``, which holds
every x64 toggle). Every comparison is bitwise or label-exact. Inputs are
made with numpy from seeds.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from phylo_hmrf_tpu_torch.ops import loops  # noqa: E402
from phylo_hmrf_tpu_torch.ops import mincut_kernels as mk  # noqa: E402
from phylo_hmrf_tpu_torch.ops.halo_rows import extend_rows  # noqa: E402
from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_kmajor  # noqa: E402
from phylo_hmrf_tpu_torch.ops.maxflow import (  # noqa: E402
    CutStats, _bfs_fixpoint, grid_mincut_host)
from phylo_hmrf_tpu_torch.parallel import halo  # noqa: E402
from tests.test_torch_cutloop import (  # noqa: E402
    _bfs_begin, _cut_instance, _icm_instance)

GO, COUNT, LIMIT, LAST = (loops.LOOP_GO, loops.LOOP_COUNT, loops.LOOP_LIMIT,
                          loops.LOOP_LAST)
CPU = torch.device("cpu")
F64 = torch.float64


# ------------------------------------------------------- the route --

@pytest.mark.parametrize("host_loop", [False, True])
@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:0"])
def test_route_choice(device, dtype, plain, host_loop):
    """``loops.route``: the host loop on the CPU or where asked; on a CUDA
    device a graph, of captured plain units with ``plain`` (any dtype),
    of the kernels otherwise (float32; another dtype raises, as the
    kernel wrappers do). Needs no card: a ``torch.device`` is a name."""
    dev = torch.device(device)
    if dev.type == "cpu" or host_loop:
        assert loops.route(dev, dtype, plain, host_loop) == "host"
    elif plain:
        assert loops.route(dev, dtype, plain, host_loop) == "plain"
    elif dtype == torch.float32:
        assert loops.route(dev, dtype, plain, host_loop) == "kernels"
    else:
        with pytest.raises(TypeError, match="float32"):
            loops.route(dev, dtype, plain, host_loop)


# ------------------------------------- the float64 programs unrolled --

def plain_cut_program(excess0, cap_t0, caps0, max_sweeps, periods, bodies):
    """The plain cut graph of ``csrc/loops.cu::build_cut`` on its captured
    units, every WHILE unrolled to a fixed count (``periods`` cut bodies,
    ``bodies`` BFS bodies a fixpoint). Returns (side, CutStats from the
    words read at the end of each loop)."""
    R, H, W = excess0.shape
    n = H * W + 2
    a = (excess0.clone(), torch.zeros((R, H, W), dtype=torch.int32),
         cap_t0.clone(), caps0.clone())
    b = tuple(torch.zeros_like(t) for t in a)
    d = (torch.zeros((R, H, W), dtype=torch.int32),
         torch.zeros((R, H, W), dtype=torch.int32))
    pr, bfs = loops.new_loop(CPU, max_sweeps), loops.new_loop(CPU, n)
    seed, bfs01, bfs10, hmax, pr_ab, pr_ba = loops.cut_units(a, b, d, pr,
                                                             bfs, n)
    pr[GO] = int(torch.any(excess0 > mk.EPS))     # the host's staging
    # cut_begin_kernel
    pr[LAST] = pr[GO]
    pr[GO] = int(pr[GO] != 0 and 0 < max_sweeps)
    sweeps = 0
    for _ in range(periods):
        seed()
        _bfs_begin(bfs, pr, n)
        for _ in range(bodies):
            bfs01()
            bfs10()
        sweeps += int(bfs[COUNT])
        hmax()
        for _ in range(4):
            pr_ab()
            pr_ba()
    seed()
    _bfs_begin(bfs, None, n)
    for _ in range(bodies):
        bfs01()
        bfs10()
    sweeps += int(bfs[COUNT])
    assert int(pr[GO]) == 0 and int(bfs[GO]) == 0   # both loops ended
    return d[0] >= n, CutStats(
        moves=1, pr_iterations=int(pr[COUNT]), bfs_sweeps=sweeps,
        capped=int(pr[GO] == 0 and pr[LAST] != 0))


def f64_cut(seed):
    return tuple(t.to(F64) for t in _cut_instance(seed))


CUT_CASES = [(0, 3000), (1, 3000), (2, 3000), (3, 3000), (4, 10)]


@pytest.mark.parametrize("seed,max_sweeps", CUT_CASES)
def test_plain_cut_program_matches_host_loop(seed, max_sweeps):
    """The float64 cut program (its units run a fixed number of times,
    more than the loops need: a unit after its loop stopped passes its
    carry through, a relabel on a stopped cut changes nothing): bitwise
    the side and the CutStats counts of ``grid_mincut_host(plain=True)``
    (host reads aside), on 4 seeds and one run capped by max_sweeps =
    10."""
    excess0, cap_t0, caps0 = f64_cut(seed)
    R, H, W = excess0.shape
    want_stats = CutStats()
    want = grid_mincut_host(excess0, cap_t0, caps0, max_sweeps, plain=True,
                            stats=want_stats)
    assert (want_stats.capped == 1) == (max_sweeps == 10)
    got, got_stats = plain_cut_program(
        excess0, cap_t0, caps0, max_sweeps,
        want_stats.pr_iterations // 32 + 2, (H * W + 2) // 16 + 1)
    assert torch.equal(got, want)
    assert got_stats == dataclasses.replace(want_stats, host_reads=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bfs_program_matches_host_loop(seed):
    """The float64 BFS-fixpoint program (``bfs_units`` unrolled): bitwise
    the distances and the sweep count of ``_bfs_fixpoint``'s host loop."""
    _, cap_t0, caps0 = f64_cut(seed)
    R, H, W = cap_t0.shape
    n = H * W + 2
    d_seed = torch.where(cap_t0 > mk.EPS, 1, n).to(torch.int32)
    st = CutStats()
    want = _bfs_fixpoint(d_seed.clone(), caps0, n, True, st, host_loop=True)
    d = (d_seed.clone(), torch.zeros_like(d_seed))
    bfs = loops.new_loop(CPU, n)
    u01, u10 = loops.bfs_units(d, caps0, n, bfs)
    _bfs_begin(bfs, None, n)
    for _ in range(n // 16 + 1):
        u01()
        u10()
    assert int(bfs[GO]) == 0
    assert torch.equal(d[0], want)
    assert int(bfs[COUNT]) == st.bfs_sweeps > 0


def plain_icm_program(unary, w, mask, init, beta, max_sweeps, pairs):
    """The plain ICM graph (``icm_units``) with its WHILE unrolled to
    ``pairs`` bodies; returns (labels, the loop word)."""
    lab = (torch.where(mask, init, 0).to(torch.int32),
           torch.zeros(mask.shape, dtype=torch.int32))
    loop = loops.new_loop(CPU, max_sweeps)
    u01, u10 = loops.icm_units(lab, unary, w, mask.to(torch.int32), beta,
                               loop)
    loop[GO] = int(0 < max_sweeps)      # icm_begin_kernel
    for _ in range(pairs):
        u01()
        u10()
    return lab[0], loop


def f64_icm(seed):
    unary, w, mask, init = _icm_instance(seed)
    return unary.to(F64), w.to(F64), mask, init


@pytest.mark.parametrize("seed,max_sweeps", [(0, 60), (1, 60), (2, 5),
                                             (3, 1)])
def test_plain_icm_program_matches_host_loop(seed, max_sweeps):
    """The float64 ICM program: bitwise the labels of ``icm_kmajor``'s
    host loop (plain, float64), an odd max_sweeps overshot by one sweep
    as both loops do."""
    unary, w, mask, init = f64_icm(seed)
    want = icm_kmajor(unary, w, mask, init, 1.2, max_sweeps, plain=True)
    got, loop = plain_icm_program(unary, w, mask, init, 1.2, max_sweeps,
                                  max_sweeps // 2 + 3)
    assert torch.equal(got, want)
    assert int(loop[GO]) == 0 and int(loop[COUNT]) <= max_sweeps + 1


# ------------------------------------ the row-sharded ICM, one card --

SHARDS = 4
W_COLS = 128
HALO_CASES = {"k2_branch": 32, "k8_branch": 24}   # H: Hl = 8 and 6


def _halo_instance(seed, H, K=4, dtype=torch.float32):
    """Per-shard operands of `_icm_halo_kernels` on 4 CPU shards: unary
    (1, K, Hl, W), the 1-row-extended weights (edges leaving the grid
    weigh 0), mask, init labels; and the global arrays for JAX."""
    rng = np.random.default_rng(seed)
    unary = rng.random((K, H, W_COLS)) * 3
    w = rng.random((4, H, W_COLS))
    w[1:, -1] = 0.0
    w[0, :, -1] = 0.0
    w[2, :, -1] = 0.0
    w[3, :, 0] = 0.0
    mask = rng.random((H, W_COLS)) < 0.85
    init = rng.integers(0, K, (H, W_COLS)).astype(np.int32)

    def shards(a, axis):
        return [torch.from_numpy(np.ascontiguousarray(c))
                for c in np.split(a, SHARDS, axis=axis)]
    unary_s = [u[None].to(dtype) for u in shards(unary, 1)]
    w_ext = extend_rows([x[None].to(dtype) for x in shards(w, 1)], 1)
    mask_s = [m[None] for m in shards(mask, 0)]
    init_s = [x[None] for x in shards(init, 0)]
    return (unary_s, w_ext, mask_s, init_s), (unary.astype(np.float32),
                                               w.astype(np.float32), mask,
                                               init)


def halo_icm_program(unary_k, w_ext, mask, init, beta, max_sweeps, bodies):
    """The one-card row-sharded ICM graph (``loops.UnitLoop`` on
    ``halo.icm_pair_unit`` or ``halo.icm_sweep_unit``, the operands as
    `_icm_halo_kernels` hands them to it) with its WHILE unrolled to
    ``bodies`` bodies; returns (labels per shard, the loop word)."""
    Hl = unary_k[0].shape[-2]
    row0 = [i * Hl for i in range(len(unary_k))]
    mask_i = [m.to(torch.int32) for m in mask]
    labels = [torch.where(m, x, 0).to(torch.int32) for m, x in zip(mask,
                                                                     init)]
    loop = loops.new_loop(CPU, max_sweeps)
    if Hl >= halo.HALO:
        unit = halo.icm_pair_unit(
            labels, extend_rows(unary_k, halo.HALO),
            extend_rows([halo._center(w, 1) for w in w_ext], halo.HALO),
            extend_rows(mask_i, halo.HALO), row0, beta, True, loop)
    else:
        unit = halo.icm_sweep_unit(
            labels, unary_k, w_ext, mask_i,
            torch.zeros(1, dtype=torch.int32), row0,
            halo._row_sources(labels), beta, True, loop)
    loop[GO] = int(0 < max_sweeps)      # icm_begin_kernel
    for _ in range(bodies):
        unit()
    return labels, loop


def _jax_icm_halo(H, beta, max_sweeps):
    """JAX's row-sharded ICM over 4 virtual devices on global arrays, as
    its spatial E-step calls it: ``_icm_halo_pallas`` (interpret mode) on
    8-row shards, ``_icm_halo`` on thinner ones (the Pallas kernels take
    multiples of 8 rows only; the port's K8 branch stands for it)."""
    from jax.sharding import Mesh, PartitionSpec as P

    from phylo_hmrf_tpu.parallel.halo import (_icm_halo, _icm_halo_pallas,
                                              extend_rows as jax_extend_rows)
    if len(jax.devices()) < SHARDS:
        pytest.skip(f"needs {SHARDS} virtual devices")
    mesh = Mesh(np.array(jax.devices()[:SHARDS]), ("data",))
    icm = _icm_halo_pallas if (H // SHARDS) % 8 == 0 else _icm_halo

    def body(unary, w, mask, init):
        return icm(unary, jax_extend_rows(w, "data", row_axis=1), mask, init,
                   beta, max_sweeps, "data")
    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P(None, "data"), P("data"),
                                   P("data")),
        out_specs=P("data"), check_vma=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_icm_program_matches_host_loop(case, dtype):
    """The one-card row-sharded ICM program over 4 CPU shards, on the K2
    branch (8-row shards) and the K8 branch (6-row shards), float32 and
    float64: bitwise the labels of `_icm_halo_kernels`' host loop, with
    the sweeps it ran (a body after the loop stopped changes nothing)."""
    (unary, w_ext, mask, init), _ = _halo_instance(0, HALO_CASES[case],
                                                   dtype=dtype)
    for max_sweeps in (40, 3):
        want = halo._icm_halo_kernels(unary, w_ext, mask, init, 1.1,
                                      max_sweeps, plain=True,
                                      host_loop=True)
        got, loop = halo_icm_program(unary, w_ext, mask, init, 1.1,
                                     max_sweeps, max_sweeps + 3)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(loop[GO]) == 0
        assert 0 < int(loop[COUNT]) <= max_sweeps + 1


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_icm_program_matches_jax(case):
    """The same program (float32) against JAX's row-sharded ICM on 4
    virtual devices (``_icm_halo_pallas`` on the K2 branch's shards,
    ``_icm_halo`` on the K8 branch's): the same labels on every valid
    pixel."""
    H = HALO_CASES[case]
    (unary, w_ext, mask, init), (u, w, m, x) = _halo_instance(1, H)
    got, _ = halo_icm_program(unary, w_ext, mask, init, 1.1, 20, 23)
    want = np.asarray(_jax_icm_halo(H, 1.1, 20)(
        jnp.asarray(np.transpose(u, (1, 2, 0))), jnp.asarray(w),
        jnp.asarray(m), jnp.asarray(x)))
    got = torch.cat([g[0] for g in got]).numpy()
    np.testing.assert_array_equal(got[m], want[m])
    assert (got[m] != x[m]).any()

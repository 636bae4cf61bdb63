"""M1 and M2 of the exact moves (``csrc/moves.cu``,
``ops/move_kernels.py``) against the tensor code they replace on the card
(``ops/maxflow.py::_swap_graph``, ``_expansion_graph`` and the label
update).

The route choice and the ``moves`` span of the CPU's plain route run on
the CPU; the kernel tests are marked ``cuda`` and skip without a card. On
a GPU machine: ``python -m pytest tests/test_torch_moves_kernel.py -q
--noconftest``. Cases: the chr21 cell's region (653 bins in 672 x 768,
K=10, R=1) and a canon-like batch (K=20, R=2: regions of 653 and 645 bins
padded to 672 x 768), each from its K1-K3 start with two states emptied.
"""

import functools
import itertools

import pytest
import torch

from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
from phylo_hmrf_tpu_torch.ops import loops
from phylo_hmrf_tpu_torch.ops import maxflow as mf
from phylo_hmrf_tpu_torch.ops import move_kernels
from phylo_hmrf_tpu_torch.ops.finish_kernels import _f32
from phylo_hmrf_tpu_torch.synth import (chr21_problem, kernel_inputs,
                                        synteny_problem)
from phylo_hmrf_tpu_torch.utils.profiling import Trace, active

CYCLES = PhyloHMRFConfig().swap_tpu_cycles


# ------------------------------------------------------------ on the CPU --

@pytest.mark.parametrize("device, dtype, plain, host_loop", list(
    itertools.product(["cuda", "cpu"], [torch.float32, torch.float64],
                      [False, True], [False, True])))
def test_build_route(device, dtype, plain, host_loop):
    """M1 / M2 exactly where the cut graph runs K5 / K6: CUDA, float32,
    neither ``plain`` nor ``host_loop``; float64 CUDA operands without
    ``plain`` raise, as the loop graphs' kernels do; the tensor code
    everywhere else."""
    on_card = device == "cuda" and not plain and not host_loop
    if on_card and dtype == torch.float64:
        with pytest.raises(TypeError):
            mf.build_route(torch.device(device), dtype, plain, host_loop)
        return
    want = "kernel" if on_card else "plain"
    assert mf.build_route(torch.device(device), dtype, plain,
                          host_loop) == want


@pytest.mark.parametrize("method", ["swap", "expansion"])
def test_moves_span_names_the_plain_build_on_the_cpu(method):
    """A traced pass on the CPU says it built its graphs with the tensor
    code (``build`` "plain") and that M1 built none."""
    _, region, means, covs, warm, _ = chr21_problem(0, h0=24, K=4)
    x = kernel_inputs(region, means, covs, warm, "cpu")
    start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"],
                            1.0, 20)
    tr = Trace(on=True)
    with active(tr):
        mf._optimize_batched(x["unary_k"], x["w"], x["mask"], start, 1.0, 4,
                             method, 2, stats=mf.CutStats())
    (sp,) = [s for s in tr.spans if s.name == "moves"]
    assert sp.counts["build"] == "plain" and sp.counts["builds"] == 0
    assert sp.counts["moves_run"] >= 1 and sp.counts["method"] == method


# ------------------------------------------------------------ on the card --

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phylo_hmrf_tpu_torch import _build
    _build.load()
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _case(name, device):
    """(unary_k, w, mask, labels) of a case: the K1-K3 start with the
    states K-1 and 2 emptied (their pixels moved to 0 and 1)."""
    if name == "chr21":
        parts = [chr21_problem(0)]
    else:
        parts = [synteny_problem(0, 653, 653, True, 20),
                 synteny_problem(1, 645, 645, True, 20)]
    xs = [kernel_inputs(region, means, covs, warm, device)
          for _, region, means, covs, warm, _ in parts]

    def cat(key):
        return torch.cat([x[key] for x in xs]).contiguous()
    unary, w, mask = cat("unary_k"), cat("w"), cat("mask")
    K = unary.shape[1]
    lab = mf._start_batch(unary, w, mask, cat("warm"), 1.0, 60)
    lab = torch.where(lab == K - 1, 0, lab)
    lab = torch.where(lab == 2, 1, lab).to(torch.int32)
    return unary, w, mask, lab


def _moves(K):
    """Every swap pair (a, b), then every expansion (alpha, -1)."""
    return ([(a, b) for a in range(K) for b in range(a + 1, K)]
            + [(a, -1) for a in range(K)])


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [1.0, 0.5])
@pytest.mark.parametrize("name", ["chr21", "canon"])
def test_build_is_bitwise_the_tensor_graphs(dev, name, beta):
    """M1 writes every move's excess0, cap_t0, eight arc planes and
    in_play bit for bit as `_swap_graph` / `_expansion_graph` give them
    (raw bits: signs of zero too), h = 0, and the pr word's first test
    (some excess0 > eps) and limit, its SEEN and TICKET back at 0. The
    carry starts as garbage."""
    unary, w, mask, lab = _case(name, dev)
    R, K, H, W = unary.shape
    beta = _f32(beta)
    wsum = mf._incident_wsum(w, beta)
    graph = loops.cut_graph(dev, R, H, W)
    mp = move_kernels.MovePass(graph, lab, unary, w, mask, wsum, beta, 1)
    bad = []
    for a, b in _moves(K):
        for t in graph.a:
            t.fill_(7 if t.dtype == torch.int32 else float("nan"))
        mp.in_play.fill_(True)
        graph.pr[loops.LOOP_GO:loops.LOOP_GO + 1].fill_(5)
        n0 = move_kernels.build_move.launches
        move_kernels.build_move(mp, a, b, 321)
        assert move_kernels.build_move.launches == n0 + 1
        want = (mf._swap_graph(lab, unary, w, mask, a, b, beta, wsum)
                if b >= 0 else
                mf._expansion_graph(lab, unary, w, mask, a, beta, wsum))
        e, h, cap_t, caps = graph.a
        for plane, got, ref in zip(("excess0", "cap_t0", "caps0", "in_play"),
                                   (e, cap_t, caps, mp.in_play), want):
            if not torch.equal(_bits(got), _bits(ref)):
                bad.append((a, b, plane, int((_bits(got)
                                              != _bits(ref)).sum())))
        if int(h.abs().max()) != 0:
            bad.append((a, b, "h", int((h != 0).sum())))
        word = graph.pr.tolist()
        go = int(torch.any(want[0] > loops.CUT_EPS))
        if (word[loops.LOOP_GO], word[loops.LOOP_LIMIT], word[loops.LOOP_SEEN],
                word[loops.LOOP_TICKET]) != (go, 321, 0, 0):
            bad.append((a, b, "pr word", word))
    assert not bad, f"{len(bad)} differences, first {bad[:8]}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chr21", "canon"])
def test_apply_matches_the_tensor_update(dev, name):
    """Every move in turn, each on the labels the last left: M1, the cut
    graph, M2. M2's labels are the tensor update's (source side: a, or
    the label kept; sink side: b, or alpha; out of play unchanged) and its
    row of counts is each region's number of changed pixels."""
    unary, w, mask, lab0 = _case(name, dev)
    R, K, H, W = unary.shape
    beta = _f32(1.0)
    wsum = mf._incident_wsum(w, beta)
    graph = loops.cut_graph(dev, R, H, W)
    moves = _moves(K)
    lab = lab0.clone()
    mp = move_kernels.MovePass(graph, lab, unary, w, mask, wsum, beta,
                               len(moves))
    changed = 0
    for t, (a, b) in enumerate(moves):
        before = lab.clone()
        move_kernels.build_move(mp, a, b, 3000)
        graph.launch_filled()
        side = graph.d[0] >= graph.n
        new = torch.where(side, a, b) if b >= 0 else torch.where(side,
                                                                 before, a)
        new = torch.where(mp.in_play, new.to(torch.int32), before)
        move_kernels.apply_move(mp, a, b, t)
        assert torch.equal(lab, new), (a, b)
        n = torch.sum(new != before, dim=(1, 2))
        assert torch.equal(mp.counts[t].long(), n), (a, b)
        changed += int(n.sum())
    assert changed > 0


def _pass(case, method, stats=None, cycles=CYCLES):
    unary, w, mask, lab = case
    return mf._optimize_batched(unary, w, mask, lab, 1.0, unary.shape[1],
                                method, cycles, stats=stats)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["swap", "expansion"])
@pytest.mark.parametrize("name", ["chr21", "canon"])
def test_pass_matches_the_plain_build(dev, name, method, monkeypatch):
    """A whole `_optimize_batched` pass (the fit's cycles) on the kernel
    route and on the tensor build forced on the card: the same labels bit
    for bit and the same `CutStats` (moves, iterations, sweeps, reads,
    energies); M1 built every move of the first and none of the second."""
    case = _case(name, dev)
    runs = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(mf, "build_route", lambda *a: "plain")
        stats = mf.CutStats()
        n0 = move_kernels.build_move.launches
        out = _pass(case, method, stats)
        runs[route] = (out, stats, move_kernels.build_move.launches - n0)
    assert torch.equal(runs["kernel"][0], runs["plain"][0])
    assert runs["kernel"][1] == runs["plain"][1]
    assert runs["kernel"][2] == runs["kernel"][1].moves > 0
    assert runs["plain"][2] == 0
    assert not torch.equal(runs["kernel"][0], case[3])


def _cycle_reads(monkeypatch, enter, leave):
    """Wrap each cycle read of `_optimize_batched` (from `_energy_hist` to
    the end of `_read`) in ``enter()`` / ``leave()``."""
    energy0, read0 = mf._energy_hist, mf._read

    def energy(*a, **kw):
        enter()
        return energy0(*a, **kw)

    def read(*a, **kw):
        try:
            return read0(*a, **kw)
        finally:
            leave()
    monkeypatch.setattr(mf, "_energy_hist", energy)
    monkeypatch.setattr(mf, "_read", read)


@pytest.mark.cuda
def test_moves_read_the_host_only_at_cycle_reads(dev, monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` outside the cycle
    reads, a swap and an expansion pass on the kernel route run without
    a synchronizing call."""
    case = _case("chr21", dev)
    _pass(case, "swap", cycles=1)      # the cut graph is built
    torch.cuda.synchronize()
    _cycle_reads(monkeypatch, lambda: torch.cuda.set_sync_debug_mode(0),
                 lambda: torch.cuda.set_sync_debug_mode("error"))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for method in ("swap", "expansion"):
            stats = mf.CutStats()
            _pass(case, method, stats, cycles=2)
            assert stats.moves > 0
    finally:
        torch.cuda.set_sync_debug_mode(0)


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch", "cudaMemsetAsync",
            "cudaMemcpyAsync", "cuMemsetD8Async", "cuMemsetD32Async",
            "cuMemcpyAsync")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["swap", "expansion"])
def test_at_most_four_host_launches_a_move(dev, monkeypatch, method):
    """The host's launches between the cycle reads of a pass on the kernel
    route (``torch.profiler``'s runtime events: kernels, graphs, memsets
    and copies), over the moves the pass ran: at most 4 a move, one of
    them the cut graph's launch."""
    case = _case("chr21", dev)
    _pass(case, method, cycles=1)
    torch.cuda.synchronize()
    marks = []
    _cycle_reads(monkeypatch, lambda: marks.append(
        [torch.profiler.record_function("cycle_read").__enter__()]),
        lambda: marks[-1][0].__exit__(None, None, None))
    stats = mf.CutStats()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _pass(case, method, stats, cycles=2)
        torch.cuda.synchronize()
    events = prof.events()
    reads = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "cycle_read")
    assert len(reads) >= 2
    launches = [e for e in events if e.name in LAUNCHES
                and e.time_range.start > reads[0][1]
                and not any(s <= e.time_range.start <= t for s, t in reads)]
    graphs = sum(e.name in ("cudaGraphLaunch", "cuGraphLaunch")
                 for e in launches)
    names = sorted({e.name for e in launches})
    assert graphs == stats.moves > 0, (graphs, stats.moves, names)
    assert len(launches) <= 4 * stats.moves, (len(launches), stats.moves,
                                              names)


@pytest.mark.cuda
def test_traced_swap_fit_builds_every_move_with_m1(dev):
    """In a traced ``swap_tpu`` fit on the card every ``moves`` span reads
    ``build`` "kernel" and ``builds`` equal to its ``moves_run``."""
    from phylo_hmrf_tpu_torch import PhyloHMRF

    tree, region, *_ = chr21_problem(0, h0=160, K=6)
    model = PhyloHMRF(tree, [region], PhyloHMRFConfig(
        n_states=6, max_iter=2, seed=0, labeler="swap_tpu"), device=dev)
    model.fit(verbose=False, trace=True)
    spans = [s for s in model.timer.spans if s.name == "moves"]
    assert len(spans) >= 2
    for sp in spans:
        assert sp.counts["build"] == "kernel"
        assert sp.counts["builds"] == sp.counts["moves_run"] > 0

"""The fit's trace (``phylo_hmrf_tpu_torch/utils/profiling.py``): spans,
their parents and ids, self time and the host's time outside its waits,
the phase totals of a trace that is off, and the spans of CPU fits with
the trace on and off.
"""

import numpy as np
import pytest
import torch

from phylo_hmrf_tpu_torch import PhyloHMRF
from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
from phylo_hmrf_tpu_torch.synth import chr21_problem
from phylo_hmrf_tpu_torch.utils import profiling
from phylo_hmrf_tpu_torch.utils.profiling import NULL, Trace, active, span

torch.set_num_threads(1)

PHASE_KEYS = {"init", "estep", "mstep", "final_polish", "wait"}


class _Clock:
    """A host clock that reads what the test sets."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(profiling, "time", c)
    return c


def _fit(labeler="mf_icm", trace=False, **cfg):
    tree, region, *_ = chr21_problem(0, h0=20, K=3)
    kw = dict(n_states=3, max_iter=3, seed=1, min_iter=0, threshold=1e-12,
              mstep_iters=6, labeler=labeler)
    kw.update(cfg)
    model = PhyloHMRF(tree, [region], PhyloHMRFConfig(**kw), device="cpu")
    return model, model.fit(verbose=False, trace=trace)


def test_spans_nest_with_parents_fit_and_iteration():
    """A span's parent is the span open around it; each carries the
    trace's fit id and the iteration set when it opened."""
    tr = Trace(on=True)
    with active(tr):
        with span("fit"):
            tr.iteration = 0
            with span("em_iter", iteration=0):
                with span("estep", device=True) as sp:
                    sp.add(buckets=2)
                    with span("wait", what="estep"):
                        pass
                with span("mstep_dispatch"):
                    with span("solve", device=True):
                        pass
            tr.iteration = 1
            with span("em_iter", iteration=1):
                pass
    names = [s.name for s in tr.spans]
    assert names == ["fit", "em_iter", "estep", "wait", "mstep_dispatch",
                     "solve", "em_iter"]
    parents = [s.parent for s in tr.spans]
    assert parents == [-1, 0, 1, 2, 1, 4, 0]
    assert [s.iteration for s in tr.spans] == [None, 0, 0, 0, 0, 0, 1]
    assert {s.fit for s in tr.spans} == {tr.fit_id}
    assert tr.spans[2].counts == {"buckets": 2}
    assert tr.spans[3].counts == {"what": "estep"}
    # no CUDA here: device spans hold no events and no device times
    assert all(s.events is None and s.device_ns is None for s in tr.spans)
    # another trace is another fit
    assert Trace(on=True).fit_id != tr.fit_id
    # outside `active` a span is the shared no-op
    assert span("solve") is NULL


def test_self_time_and_host_outside_waits(clock):
    """Self time: duration less the child spans; host time: duration less
    the ``wait`` spans anywhere inside; the phase totals take the host
    time of each phase span and every wait."""
    tr = Trace(on=True)
    with active(tr):
        clock.now = 0
        with span("em_iter"):
            clock.now = 10
            with span("wait"):               # 10 .. 30
                clock.now = 30
            clock.now = 40
            with span("estep"):              # 40 .. 90
                clock.now = 50
                with span("moves"):          # 50 .. 80
                    clock.now = 55
                    with span("wait"):       # 55 .. 60
                        clock.now = 60
                    clock.now = 80
                clock.now = 90
            clock.now = 100
    it, w1, estep, moves, w2 = tr.spans
    assert (it.ns, it.self_ns, it.host_ns) == (100, 30, 75)
    assert (estep.ns, estep.self_ns, estep.host_ns) == (50, 20, 45)
    assert (moves.ns, moves.self_ns, moves.host_ns) == (30, 25, 25)
    assert (w1.ns, w1.self_ns, w1.host_ns) == (20, 20, 20)
    assert tr.totals["estep"] == 45 and tr.totals["wait"] == 25
    assert tr.counts["estep"] == 1 and tr.counts["wait"] == 2
    assert "em_iter" not in tr.totals and "moves" not in tr.totals
    assert tr.last_ms("estep") == pytest.approx(45e-6)
    assert tr.last_ms("estep", host=False) == pytest.approx(50e-6)


def test_off_mode_keeps_phase_totals_only(clock, monkeypatch):
    """Off: no span is kept, no CUDA event or profiler range is made,
    spans outside the phases are the shared no-op, and the phase totals
    are those the trace that is on keeps."""
    def refuse(*a, **k):
        raise AssertionError("made by a trace that is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tr = Trace(on=False)
    with active(tr):
        clock.now = 0
        with span("mstep_dispatch"):
            assert span("solve", device=True) is NULL
            assert span("graph_capture") is NULL
            clock.now = 7
        with span("mstep_finalize"):             # 7 .. 13, a wait of 4
            clock.now = 8
            with span("wait") as w:
                w.add(bytes=4)               # dropped
                clock.now = 12
            clock.now = 13
    assert tr.spans == [] and tr.anchor is None
    assert dict(tr.totals) == {"mstep": 7 + 2, "wait": 4}
    assert dict(tr.counts) == {"mstep": 2, "wait": 1}
    summ = tr.summary()
    assert set(summ) == {"mstep", "wait"}
    assert set(summ["mstep"]) == {"total_s", "count", "mean_s"}


def test_traced_cpu_fit_has_the_fit_spans():
    """A CPU fit with the trace on: the spans of the fit, the init, each
    EM iteration, E-step, M-step half, wait and the polish; an em_iter a
    pass of the loop, in order; no device time on the CPU; and the same
    fit as with the trace off."""
    model, res = _fit(trace=True)
    tr = model.timer
    names = {s.name for s in tr.spans}
    assert {"fit", "init", "kmeans", "init_solve", "em_iter", "estep",
            "mstep_dispatch", "mstep_finalize", "wait",
            "polish", "moves"} <= names
    assert tr.spans[0].name == "fit" and tr.spans[0].parent == -1
    iters = [s for s in tr.spans if s.name == "em_iter"]
    assert [s.iteration for s in iters] == list(range(res.n_iters))
    assert all(s.counts["rollbacks"] == 0 for s in iters)
    assert all(tr.spans[s.parent].name == "em_iter" for s in tr.spans
               if s.name in ("estep", "mstep_dispatch", "mstep_finalize"))
    polish = next(i for i, s in enumerate(tr.spans) if s.name == "polish")
    assert tr.spans[polish].iteration is None
    assert any(s.parent == polish and s.name == "moves" for s in tr.spans)
    assert {s.fit for s in tr.spans} == {tr.fit_id}
    assert all(s.device_ns is None for s in tr.spans)
    assert all(0 <= s.self_ns <= s.ns and 0 <= s.host_ns <= s.ns
               for s in tr.spans)
    assert set(tr.summary()) == PHASE_KEYS
    assert tr.summary()["estep"]["count"] == sum(
        s.name == "estep" for s in tr.spans)

    off, res_off = _fit(trace=False)
    assert off.timer.spans == [] and set(off.timer.summary()) == PHASE_KEYS
    np.testing.assert_array_equal(res.labels, res_off.labels)
    np.testing.assert_array_equal(res.cost_vec, res_off.cost_vec)


def test_kmeans_span_has_its_route_and_launches():
    """The traced fit's ``kmeans`` span, inside ``init``, names its route
    (the plain version on the CPU) and counts its launches of the k-means
    kernels: none on the plain route, and ``kmeans.kernel_launches`` does
    not move."""
    from phylo_hmrf_tpu_torch.ops.kmeans import kmeans

    n0 = kmeans.kernel_launches
    model, _ = _fit(trace=True)
    tr = model.timer
    (sp,) = [s for s in tr.spans if s.name == "kmeans"]
    assert tr.spans[sp.parent].name == "init"
    assert sp.counts["route"] == "plain"
    assert sp.counts["launches"] == 0
    assert kmeans.kernel_launches == n0


def test_exact_labeler_fit_has_moves_with_waits():
    """``swap_tpu``: every E-step holds a ``moves`` pass whose host reads
    are its ``wait`` children, counted with the pass's cycles and cut
    statistics; no polish."""
    model, res = _fit(labeler="swap_tpu", trace=True)
    tr = model.timer
    moves = [i for i, s in enumerate(tr.spans) if s.name == "moves"]
    assert len(moves) == res.n_iters
    for i in moves:
        sp = tr.spans[i]
        assert tr.spans[sp.parent].name == "estep"
        waits = [s for s in tr.spans if s.parent == i and s.name == "wait"]
        assert len(waits) == sp.counts["host_reads"] >= 2
        assert sp.counts["cycles"] >= 1 and sp.counts["moves"] >= 1
        assert sp.counts["method"] == "swap"
        assert sp.host_ns == sp.ns - sum(w.ns for w in waits)
    assert "final_polish" not in tr.summary()


def _count_reads(monkeypatch):
    """Counts of the tensor methods that read a tensor's values into the
    host."""
    got = {}
    for name in ("item", "tolist", "numpy", "cpu"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            got[_name] = got.get(_name, 0) + 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return got


def test_untraced_fit_adds_no_event_range_or_read(monkeypatch):
    """Tracing off, a fit makes no CUDA event and no profiler range, and
    reads the device exactly as often as a fit whose spans are all the
    no-op: the same reads, the same fit."""
    def refuse(*a, **k):
        raise AssertionError("made by a fit with the trace off")

    with monkeypatch.context() as mp:
        reads = _count_reads(mp)
        mp.setattr(torch.cuda, "Event", refuse)
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.cuda, "synchronize", refuse)
        _, res = _fit(labeler="swap_tpu")
    with monkeypatch.context() as mp:
        bare = _count_reads(mp)
        mp.setattr(Trace, "span", lambda self, *a, **k: NULL)
        _, res_bare = _fit(labeler="swap_tpu")
    assert reads == bare and reads
    np.testing.assert_array_equal(res.labels, res_bare.labels)

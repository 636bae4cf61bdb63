"""The traced run's device view of one fit, reduced in memory.

`profile_fit` runs one fit under ``torch.profiler`` with the device's
activity only (recording every host op would slow the host-bound parts
of a fit) and times every launch of the program's loop graphs
(``ops/loops.py``'s ``_Graph.launch``) with CUDA events around it,
because the profiler misses kernels that run inside conditional WHILE
bodies. Each replay of an L-BFGS solve's graphs
(``ops/lbfgs.py::GraphSolve.__call__``, ~185k small kernels a solve) is
timed the same way with the profiler's collection paused while it is
enqueued, without a wait for the card (the fit stays pipelined): a fit's
solves would otherwise give the profiler millions of records. A spin
kernel launched right after a reference event and a host clock reading
puts the events and the host ranges (`Marks`) on the profiler's clock.
Nothing is written to disk: the records are reduced to busy time, idle
gaps and sums by kernel name before the profile is dropped.

Busy is the union of the kernel, copy and fill intervals and the graph
spans, inside the fit's window; each idle gap is named by the innermost
host range (``record.Recorder``'s, and ``kmeans`` / ``graph_capture`` of
the init and M-step solves) covering its middle.
"""

from __future__ import annotations

import contextlib
import time

import torch

MARKER = "spin_kernel"


class Marks:
    """Named host ranges of the profiled fit, on the host clock (ns)."""

    def __init__(self):
        self.ranges = []

    @contextlib.contextmanager
    def range(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.ranges.append((name, t0, time.perf_counter_ns()))


@contextlib.contextmanager
def graph_spans(spans: list):
    """CUDA events around every loop-graph launch, appended to ``spans``
    as (start event, end event)."""
    from phylo_hmrf_tpu_torch.ops import loops

    launch0 = loops._Graph.launch

    def launch(self, like):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch0(self, like)
        b.record()
        spans.append((a, b))

    loops._Graph.launch = launch
    try:
        yield
    finally:
        loops._Graph.launch = launch0


@contextlib.contextmanager
def solve_spans(spans: list, prof):
    """CUDA events around every replay of a captured L-BFGS solve,
    appended to ``spans``, with the profiler's collection off while the
    replay is enqueued. Nothing waits for the card: the M-step stays
    queued behind the E-step as in an unprofiled fit (kernels enqueued
    before the pause are recorded when they run)."""
    from phylo_hmrf_tpu_torch.ops import lbfgs

    call0 = lbfgs.GraphSolve.__call__
    cuda = [torch.profiler.ProfilerActivity.CUDA]

    def call(self, *a, **kw):
        prof.toggle_collection_dynamic(False, cuda)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        try:
            return call0(self, *a, **kw)
        finally:
            e.record()
            prof.toggle_collection_dynamic(True, cuda)
            spans.append((s, e))

    lbfgs.GraphSolve.__call__ = call
    try:
        yield
    finally:
        lbfgs.GraphSolve.__call__ = call0


@contextlib.contextmanager
def init_spans(marks: Marks):
    """Host ranges around the k-means and each solve's graph capture (the
    model module's own names, restored after)."""
    from phylo_hmrf_tpu_torch.models import hmrf

    kmeans0, solve0 = hmrf.kmeans, hmrf.GraphSolve

    def kmeans(*a, **kw):
        with marks.range("kmeans"):
            return kmeans0(*a, **kw)

    class GraphSolve(solve0):
        def __init__(self, *a, **kw):
            with marks.range("graph_capture"):
                super().__init__(*a, **kw)

    hmrf.kmeans, hmrf.GraphSolve = kmeans, GraphSolve
    try:
        yield
    finally:
        hmrf.kmeans, hmrf.GraphSolve = kmeans0, solve0


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_fit(run_fit, marks: Marks):
    """Run ``run_fit()`` profiled, its host ranges in ``marks``; returns
    (its result, the reduced profile: ``window_s``, ``busy_s``,
    ``kernels`` {name: [seconds, count]}, ``graph_s``, ``graph_launches``,
    ``solve_s``, ``solves``, ``gaps`` [(name, s)], ``records``: the
    device records kept)."""
    gspans, sspans = [], []
    ref = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with graph_spans(gspans), solve_spans(sspans, prof), \
                init_spans(marks):
            torch.cuda.synchronize()
            ref.record()
            t_host = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            with marks.range("fit"):
                out = run_fit()
                torch.cuda.synchronize()
    kern, marker = [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name, s = e.name(), e.start_ns()
        if MARKER in name and marker is None:
            marker = s
            continue
        kern.append((s, s + e.duration_ns(), name))
    del prof
    if marker is None:
        return out, None
    # host ranges on the device's clock: the spin kernel started as the
    # host read ``t_host`` (the card was idle)
    host = [(marker + t0 - t_host, marker + t1 - t_host, n)
            for n, t0, t1 in marks.ranges]
    w0, w1 = next((a, b) for a, b, n in host if n == "fit")

    def on_clock(pairs):
        return [(marker + ref.elapsed_time(a) * 1e6,
                 marker + ref.elapsed_time(b) * 1e6) for a, b in pairs]

    graph_iv, solve_iv = on_clock(gspans), on_clock(sspans)
    by_name = {}
    for s, e, n in kern:
        v = by_name.setdefault(n, [0.0, 0])
        v[0] += (e - s) * 1e-9
        v[1] += 1
    busy_iv = _merge([(max(s, w0), min(e, w1))
                      for s, e, _ in kern + [(a, b, "")
                                             for a, b in graph_iv + solve_iv]
                      if e > w0 and s < w1])
    busy = sum(e - s for s, e in busy_iv)
    gaps, t = [], w0
    for s, e in busy_iv + [[w1, w1]]:
        if s > t:
            mid = 0.5 * (s + t)
            inner = [h for h in host if h[0] <= mid <= h[1]]
            name = (max(inner, key=lambda h: h[0])[2] if inner else "host")
            gaps.append((name, (s - t) * 1e-9))
        t = max(t, e)
    gaps.sort(key=lambda g: -g[1])
    return out, dict(
        window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, kernels=by_name,
        graph_s=sum(b - a for a, b in graph_iv) * 1e-9,
        graph_launches=len(graph_iv),
        solve_s=sum(b - a for a, b in solve_iv) * 1e-9,
        solves=len(solve_iv), gaps=gaps, records=len(kern))


def breakdown(profile: dict) -> dict:
    """The result line's ``breakdown``: the 10 device operations of most
    time (the loop graphs' launches and the solves' replays each as one
    entry) and the 10 longest idle gaps."""
    ops = [[n[:160], v[0]] for n, v in profile["kernels"].items()]
    ops.append(["loop graph launches (CUDA events)", profile["graph_s"]])
    ops.append(["L-BFGS solve graph replays (CUDA events)",
                profile["solve_s"]])
    ops.sort(key=lambda o: -o[1])
    return {"device_ops": ops[:10],
            "idle_gaps": [[n, s] for n, s in profile["gaps"][:10]]}

"""The fit's trace, the EM convergence monitor — the port's own copy of
``ConvergenceMonitor`` from ``phylo_hmrf_tpu/utils/profiling.py`` — and
`torch_trace`, the counterpart of its ``jax_trace``.

`Trace` (grown from that module's ``PhaseTimer``) is what ``fit`` keeps
in ``model.timer``. Off (the default) it keeps the phase totals of
`Trace.summary` only: the host clock at the boundaries of the phase spans
and of the host's waits for the device, nothing else (no CUDA event, no
profiler range, no device read). On (``fit(trace=True)``) every span is
kept in memory as a `Span`: its name, host start and end
(``time.perf_counter_ns``), its parent, the fit's id and the EM
iteration, a few counts taken at its boundaries and, for a device span,
a pair of CUDA events on the current stream, resolved after the fit to
device start and end on the host clock (against a reference event the
trace records on an idle card as it starts). Each span is then also a
``torch.profiler.record_function`` range, so a profiler's trace shows the
program's spans beside the device's work.

Code below the model reaches the fit's trace through `span`, which opens
a span of the trace `active` made current, and is a shared no-op context
when there is none.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import time
from collections import defaultdict

import torch

# span name -> the phase total of `Trace.summary` it adds to
PHASES = {"init": "init", "estep": "estep", "mstep_dispatch": "mstep",
          "mstep_finalize": "mstep", "polish": "final_polish",
          "wait": "wait"}

_FIT_IDS = itertools.count(1)
_CURRENT = contextvars.ContextVar("phylo_hmrf_torch_trace", default=None)


@dataclasses.dataclass(slots=True)
class Span:
    """One span of a trace that is on. Times are host ``perf_counter_ns``;
    ``d0``/``d1`` (device spans on CUDA, after `Trace.resolve`) are the
    device's start and end on the same clock."""
    name: str
    parent: int              # index in ``Trace.spans``; -1 at the top
    fit: int
    iteration: int | None    # the EM iteration it ran in
    t0: int
    t1: int = 0
    counts: dict = dataclasses.field(default_factory=dict)
    child_ns: int = 0        # host time of its child spans
    wait_ns: int = 0         # host time of the ``wait`` spans inside it
    d0: int | None = None
    d1: int | None = None
    events: tuple | None = None

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    @property
    def self_ns(self) -> int:
        """Duration less the part its child spans cover."""
        return self.ns - self.child_ns

    @property
    def host_ns(self) -> int:
        """Duration less its ``wait`` spans: the host's own time."""
        return self.ns - self.wait_ns

    @property
    def device_ns(self) -> int | None:
        return None if self.d0 is None else self.d1 - self.d0


class _Null:
    """The shared no-op span."""
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


NULL = _Null()


class _Timed:
    """A phase span of a trace that is off: its host time only."""
    on = False
    __slots__ = ("_trace", "_name", "_t0", "_w0")

    def __init__(self, trace, name):
        self._trace, self._name = trace, name

    def __enter__(self):
        self._w0 = self._trace._wait_ns
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        tr = self._trace
        tr._close(self._name, time.perf_counter_ns() - self._t0,
                  tr._wait_ns - self._w0)
        return False

    def add(self, **counts) -> None:
        pass


class _Live:
    """A span of a trace that is on."""
    on = True
    __slots__ = ("_trace", "_name", "_device", "_counts", "span", "_rf",
                 "_w0")

    def __init__(self, trace, name, device, counts):
        self._trace, self._name = trace, name
        self._device, self._counts = device, counts

    def __enter__(self):
        tr = self._trace
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        sp = self.span = Span(self._name, tr._stack[-1] if tr._stack else -1,
                              tr.fit_id, tr.iteration, 0,
                              counts=self._counts)
        if self._device and tr.anchor is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            sp.events = (start, None)
        tr._stack.append(len(tr.spans))
        tr.spans.append(sp)
        self._w0 = tr._wait_ns
        sp.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        tr, sp = self._trace, self.span
        sp.t1 = time.perf_counter_ns()
        if sp.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            sp.events = (sp.events[0], end)
        tr._stack.pop()
        sp.wait_ns = tr._wait_ns - self._w0
        tr._close(sp.name, sp.ns, sp.wait_ns, sp)
        if sp.parent >= 0:
            tr.spans[sp.parent].child_ns += sp.ns
        self._rf.__exit__(*exc)
        return False

    def add(self, **counts) -> None:
        self.span.counts.update(counts)


class Trace:
    """A fit's spans (on) or its phase totals alone (off); one per fit,
    thread-unsafe by design.

    `summary` / `report` give the phases ``init``, ``estep``, ``mstep``
    (``mstep_dispatch`` and ``mstep_finalize``), ``final_polish`` (the
    ``polish`` span) as the host's own time in them, their ``wait``
    spans left out, and ``wait``: every host wait for the device in the
    fit. Under the pipelined loop an E-step's phase is its enqueue, and
    the wait for its statistics is in ``wait``."""

    def __init__(self, on: bool = False, device=None):
        self.on = bool(on)
        self.fit_id = next(_FIT_IDS)
        self.iteration = None
        self.totals = defaultdict(int)     # phase -> host ns
        self.counts = defaultdict(int)
        self.spans = []                    # on: every span, as opened
        self._stack = []
        self._wait_ns = 0
        self._last = {}                    # name -> (ns, host ns, Span)
        # (reference event, host ns as it was recorded): device spans
        self.anchor = None
        self._device = device
        if self.on and device is not None and \
                torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
            self.anchor = (ref, time.perf_counter_ns())

    def span(self, name: str, device: bool = False, **counts):
        """A context for the span ``name`` (``device``: also time the
        current stream from its start to its end); ``as s`` gives an
        object whose ``add(**counts)`` adds counts and whose ``on``
        says whether they are kept."""
        if self.on:
            return _Live(self, name, device, counts)
        if name in PHASES:
            return _Timed(self, name)
        return NULL

    def _close(self, name, ns, inner_wait, sp=None):
        if name == "wait":
            self._wait_ns += ns
        key = PHASES.get(name)
        if key is not None:
            self.totals[key] += ns - inner_wait
            self.counts[key] += 1
        self._last[name] = (ns, ns - inner_wait, sp)

    def last_ms(self, name: str, host: bool = True) -> float | None:
        """The last closed span ``name``'s host time outside its waits
        (``host=False``: its whole duration), ms; None before one."""
        got = self._last.get(name)
        return None if got is None else got[1 if host else 0] * 1e-6

    def last_device_ms(self, name: str) -> float | None:
        """The last closed device span ``name``'s device ms, where the
        card has finished it (no wait); None otherwise."""
        got = self._last.get(name)
        sp = got[2] if got else None
        if sp is None:
            return None
        if sp.d0 is not None:
            return sp.device_ns * 1e-6
        if sp.events is None or not sp.events[1].query():
            return None
        return sp.events[0].elapsed_time(sp.events[1])

    def resolve(self) -> None:
        """Device spans' events -> ``d0``/``d1`` on the host clock (waits
        for the card once); the events are dropped."""
        if self.anchor is None:
            return
        ref, t_ref = self.anchor
        torch.cuda.synchronize(self._device)
        for sp in self.spans:
            if sp.events is not None and sp.events[1] is not None:
                a, b = sp.events
                sp.d0 = t_ref + round(ref.elapsed_time(a) * 1e6)
                sp.d1 = t_ref + round(ref.elapsed_time(b) * 1e6)
            sp.events = None
        self.anchor = None

    def summary(self) -> dict:
        return {k: {"total_s": round(self.totals[k] * 1e-9, 4),
                    "count": self.counts[k],
                    "mean_s": round(self.totals[k] * 1e-9
                                    / max(self.counts[k], 1), 4)}
                for k in sorted(self.totals)}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=1)


@contextlib.contextmanager
def active(trace: Trace):
    """Make ``trace`` the one `span` opens spans in, for the block."""
    token = _CURRENT.set(trace)
    try:
        yield trace
    finally:
        _CURRENT.reset(token)


def span(name: str, device: bool = False, **counts):
    """`Trace.span` of the active trace; the shared no-op without one."""
    trace = _CURRENT.get()
    if trace is None:
        return NULL
    return trace.span(name, device, **counts)


class ConvergenceMonitor:
    """EM convergence record (upgrades the reference's ConvergenceMonitor,
    base.py:22-94, which printed to stderr and whose `converged` flag was
    never consulted). Tracks the cost rows the graph path actually uses and
    can persist them as JSON-lines."""

    def __init__(self, tol: float, patience: int, log_file: str | None = None,
                 verbose: bool = False):
        self.tol = tol
        self.patience = patience
        self.verbose = verbose
        self.log_file = log_file
        self.history = []   # rows [iter, pairwise, unary, cost1]
        self.best = (0, float("inf"))

    def report(self, it: int, pairwise: float, unary: float, cost1: float):
        row = [it, pairwise, unary, cost1]
        self.history.append(row)
        if cost1 < self.best[1]:
            self.best = (it, cost1)
        if self.verbose:
            print(f"[monitor] iter={it} pairwise={pairwise:.6f} "
                  f"unary={unary:.6f} cost1={cost1:.6f}")
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps({"iter": it, "pairwise": pairwise,
                                    "unary": unary, "cost1": cost1}) + "\n")

    @property
    def converged(self) -> bool:
        if len(self.history) < 2:
            return False
        prev, cur = self.history[-2][3], self.history[-1][3]
        rel = abs((cur - prev) / prev) if prev != 0 else float("inf")
        return rel < self.tol

    @property
    def exhausted_patience(self) -> bool:
        if not self.history:
            return False
        return self.history[-1][0] - self.best[0] > self.patience


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """``torch.profiler`` scope over the host and, where CUDA is present,
    the device; writes a Chrome trace (``trace_<pid>.json``) into
    ``log_dir`` on exit. No-op when log_dir is empty. A fit run with
    ``trace=True`` inside it adds its spans as ranges."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"trace -> {path}")

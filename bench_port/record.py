"""What a fit's timed path produced, kept for the judge, and the synced
spans of a traced run.

``Recorder`` wraps a model instance's methods (``initialize``, ``estep``
and the ``collect`` it returns, ``mstep_dispatch`` / ``mstep_finalize``,
``_exact_labels_all`` with the start labels that its exact moves
(``ops/maxflow.py::_optimize_batched``) are handed, and
``_fit_init_params`` / ``_blend_guess`` for the OU solves' start points)
and keeps references to their inputs and outputs,
without reading the device: the program's own read-backs are its only
synchronizations. After the fit, `Recorder.host` copies what the judge
reads to host arrays.

With ``spans="sync"`` (the timed fits of a traced run) every wrapped
call synchronizes the card before and after and adds its host-clock
duration to ``spans``;
with ``spans="mark"`` (the profiled fit) it only notes the call's host
range in ``marks`` (``devtrace.Marks``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from synth import flat_order


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


class Recorder:
    """One fit's stage outputs and (traced) spans."""

    def __init__(self, model, regions, spans: str | None = None,
                 marks=None):
        self.model = model
        self.order = [flat_order(r["h0"], r["w0"], r["is_diag"])
                      for r in regions]
        self.mode = spans
        self.marks = marks
        self.spans = {} if spans == "sync" else None
        self.init = None
        self.estep_rec = None    # the last collected E-step
        self.mstep_rec = None    # the last finalized M-step
        self.exact_calls = 0
        self.estep_calls = 0
        self.last_exact = None
        self.in_estep = 0
        self.iter_times = []
        self.init_start = None   # the init solve's start (its guesses)
        self.guess = None        # the last M-step solve's start
        self._wrap()

    @contextlib.contextmanager
    def span(self, name):
        if self.mode is None:
            yield
            return
        if self.mode == "mark":
            with self.marks.range(name):
                yield
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def _wrap(self):
        m = self.model
        init0, estep0 = m.initialize, m.estep
        disp0, fin0, exact0 = (m.mstep_dispatch, m.mstep_finalize,
                               m._exact_labels_all)
        fitinit0, blend0 = m._fit_init_params, m._blend_guess

        def initialize():
            with self.span("initialize"):
                init0()
            self.init = dict(centers=np.array(m.means_, np.float64),
                             labels=np.array(m.init_labels, np.int64),
                             params=np.array(m.init_ou_params, np.float64),
                             start=self.init_start)

        def fit_init_params(centers, pre):
            self.init_start = np.array(pre["guesses"], np.float64)
            return fitinit0(centers, pre)

        def blend_guess():
            self.guess = np.array(blend0(), np.float64)
            return self.guess

        def estep(means, covars, warm_grids, exact_method=None, defer=False):
            self.estep_calls += 1
            self.in_estep += 1
            before = self.exact_calls
            try:
                with self.span("estep"):
                    out = estep0(means, covars, warm_grids,
                                 exact_method=exact_method, defer=True)
            finally:
                self.in_estep -= 1
            grids, collect = out
            entry = dict(means=means, covars=covars, warm=list(warm_grids),
                         grids=list(grids),
                         exact=(self.last_exact
                                if self.exact_calls > before else None))

            def collected():
                with self.span("estep_collect"):
                    res = collect()
                entry["stats"] = res
                self.estep_rec = entry
                return res

            if defer:
                return grids, collected
            return (grids, *collected())

        def mstep_dispatch(stats):
            with self.span("mstep_dispatch"):
                h = disp0(stats)
            h["_rec"] = dict(stats=h["stats"], start=self.guess)
            return h

        def mstep_finalize(handle):
            with self.span("mstep_finalize"):
                rolled = fin0(handle)
            e = handle["_rec"]
            e.update(params=np.array(m.params_vec, np.float64),
                     means=np.array(m.means_, np.float64),
                     covars=np.array(m.covars_, np.float64))
            self.mstep_rec = e
            return rolled

        def exact_labels_all(means, covars, warm_grids, method="swap",
                             stats=None):
            from phylo_hmrf_tpu_torch.ops import maxflow

            self.exact_calls += 1
            name = "exact_estep" if self.in_estep else "polish"
            starts = []     # the moves' start labels, a batch a bucket
            opt0 = maxflow._optimize_batched

            def optimize(unary_k, wmaps, mask, init_labels, *a, **kw):
                starts.append(init_labels)
                return opt0(unary_k, wmaps, mask, init_labels, *a, **kw)

            maxflow._optimize_batched = optimize
            try:
                with self.span(name):
                    out = exact0(means, covars, warm_grids, method=method,
                                 stats=stats)
            finally:
                maxflow._optimize_batched = opt0
            self.last_exact = dict(means=means, covars=covars,
                                   warm=list(warm_grids), grids=list(out),
                                   starts=self._by_region(starts),
                                   stats=stats, polish=not self.in_estep)
            return out

        m.initialize = initialize
        m.estep = estep
        m.mstep_dispatch = mstep_dispatch
        m.mstep_finalize = mstep_finalize
        m._exact_labels_all = exact_labels_all
        m._fit_init_params = fit_init_params
        m._blend_guess = blend_guess

    def detach(self) -> None:
        """Take the wrappers off the model (they and the model hold each
        other), so the model is freed as soon as its caller drops it."""
        for name in ("initialize", "estep", "mstep_dispatch",
                     "mstep_finalize", "_exact_labels_all",
                     "_fit_init_params", "_blend_guess"):
            self.model.__dict__.pop(name, None)
        self.model = None

    def _by_region(self, batches) -> list | None:
        """Batches of a pass over the model's shape buckets (one a bucket,
        in the model's bucket order) -> one grid a region; None when the
        pass did not run one batch a bucket."""
        buckets = list(self.model._bucket_arrays.values())
        if len(batches) != len(buckets):
            return None
        out = [None] * len(self.model.regions)
        for (idxs, *_), batch in zip(buckets, batches):
            for bi, ri in enumerate(idxs):
                out[ri] = batch[bi]
        return out

    def callback(self, model, it, cost_row, label_grids):
        """The fit's per-iteration hook: the time of each call."""
        self.iter_times.append(time.perf_counter())

    def _flat(self, grids) -> list:
        out = []
        for g, (rows, cols) in zip(grids, self.order):
            a = g.to("cpu").numpy() if isinstance(g, torch.Tensor) else g
            out.append(np.asarray(a)[rows, cols].astype(np.int64))
        return out

    def _starts(self, exact) -> list | None:
        st = exact["starts"]
        return None if st is None else self._flat(st)

    def host(self, result) -> dict:
        """The judge's record of the finished fit, as host arrays; then
        `detach`."""
        m = self.model
        e = self.estep_rec
        post, obs, obs2 = e["stats"][0]
        estep = dict(means=_np(e["means"]), covars=_np(e["covars"]),
                     warm=self._flat(e["warm"]), labels=self._flat(e["grids"]),
                     post=np.asarray(post), obs=np.asarray(obs),
                     obs2=np.asarray(obs2), costs=np.asarray(e["stats"][1]),
                     energy=(e["exact"]["stats"].energy_end
                             if e["exact"] is not None else None),
                     start=(self._starts(e["exact"])
                            if e["exact"] is not None else None))
        mstep = None
        if self.mstep_rec is not None:
            ms = self.mstep_rec
            post, obs, obs2 = ms["stats"]
            mstep = dict(post=np.asarray(post), obs=np.asarray(obs),
                         obs2=np.asarray(obs2), start=ms["start"],
                         params=ms["params"], means=ms["means"],
                         covars=ms["covars"],
                         init_params=np.array(m.init_ou_params, np.float64))
        polish = None
        px = self.last_exact
        if px is not None and px["polish"]:
            polish = dict(means=_np(px["means"]), covars=_np(px["covars"]),
                          warm=self._flat(px["warm"]),
                          labels=self._flat(px["grids"]),
                          start=self._starts(px),
                          energy=px["stats"].energy_end)
        self.estep_rec = self.mstep_rec = self.last_exact = None
        self.detach()
        return dict(n_iters=int(result.n_iters), init=self.init, estep=estep,
                    mstep=mstep, polish=polish)

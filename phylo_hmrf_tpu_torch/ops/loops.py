"""The loops of the exact cut and of ICM as CUDA graphs the card runs to
their end (``csrc/loops.cu``), and the loop word their kernels share.

Counterpart of the ``lax.while_loop``s of
``phylo_hmrf_tpu/ops/maxflow_tpu.py::grid_mincut_fused`` (the min cut and
its BFS fixpoint) and ``phylo_hmrf_tpu/ops/icm_pallas.py::icm_pallas``.
A graph is built once per (card, shape; for ICM also beta), with the
static buffers it reads, and kept in a small cache: a graph reads by
address, and nothing tells the allocator that a graph still reads a
tensor, so the cache holds every tensor its graph reads. A call copies
its inputs into those buffers, writes the loop's limits with ``fill_``,
launches the graph on PyTorch's current stream and returns a new tensor:
no host read and no synchronization. A graph that cannot be built or
launched raises; nothing falls back.

The loop word (``csrc/loops.cuh``): int32 words GO, SEEN, TICKET, COUNT,
LIMIT, LAST (8 a loop). A K2, K5 or K6 launch given a word runs only
where GO is set (else it passes its input through), and its last block
sets COUNT += step, LAST = what it saw, GO = LAST and COUNT < LIMIT.
``loop_step`` is that protocol in tensor code, for the plain versions.

Counters: ``run_cut.launches``, ``run_bfs.launches``,
``run_icm.launches`` (graph launches, host side); ``stats`` (graphs
built, their seconds); each graph's int64 ``totals`` on the card (what
its loops did: iterations, sweeps, kernel launches, runs stopped at their
limit), read only where a caller asks (`kernel_launches`, a cut's
``CutStats`` at ``_optimize_batched``'s cycle read).
"""

from __future__ import annotations

import collections
import ctypes
import time

import torch

from phylo_hmrf_tpu_torch import _build

LOOP_GO, LOOP_SEEN, LOOP_TICKET, LOOP_COUNT, LOOP_LIMIT, LOOP_LAST = range(6)
LOOP_WORDS = 8
NO_LIMIT = 2**31 - 1
CUT_EPS = 1e-6   # the cut's residual-arc test (mincut_kernels.EPS)

# the graph counters (csrc/loops.cu's T_*)
(T_RUNS, T_PR_ITERS, T_BFS_SWEEPS, T_CAPPED, T_K5, T_K6, T_K2, T_ICM_SWEEPS,
 T_ICM_CAPPED) = range(9)
T_WORDS = 16

MAX_GRAPHS = 8   # graphs kept; the oldest goes first
MIN_DRIVER = 12030   # CUDA 12.3: conditional nodes

stats = dict(builds=0, build_s=0.0)


def _fill(word: torch.Tensor, i: int, value: int) -> None:
    """word[i] = value by a fill kernel (an item assignment copies the
    value from the host, which synchronizes)."""
    word[i:i + 1].fill_(int(value))


def new_loop(device, limit: int = NO_LIMIT) -> torch.Tensor:
    """A fresh loop word: GO set, COUNT 0, LIMIT ``limit``."""
    w = torch.zeros(LOOP_WORDS, dtype=torch.int32, device=device)
    _fill(w, LOOP_GO, 1)
    _fill(w, LOOP_LIMIT, limit)
    return w


def loop_step(loop: torch.Tensor, new, old, seen, step: int):
    """The kernels' loop protocol in tensor code (the plain versions): the
    step's result ``new`` where the loop runs, else ``old`` passed
    through (tuples of tensors, returned as a tuple); ``seen``, a 0-d
    bool, is what keeps the loop going (a change, an active node) in
    ``new``. Updates ``loop`` in place with no host read."""
    run = loop[LOOP_GO] != 0
    out = tuple(torch.where(run, a, b) for a, b in zip(new, old))
    seen = (seen & run).to(torch.int32)
    count = loop[LOOP_COUNT] + run.to(torch.int32) * step
    go = seen * (count < loop[LOOP_LIMIT]).to(torch.int32)
    loop[LOOP_COUNT:LOOP_COUNT + 1].copy_(count.view(1))
    loop[LOOP_LAST:LOOP_LAST + 1].copy_(
        torch.where(run, seen, loop[LOOP_LAST]).view(1))
    loop[LOOP_GO:LOOP_GO + 1].copy_(torch.where(run, go, 0).view(1))
    return out


def driver_version() -> int:
    """The CUDA driver's version (e.g. 12080 for 12.8)."""
    v = ctypes.c_int(0)
    _build.check(_build.load().phmrf_driver_version(ctypes.byref(v)),
                 "cudaDriverGetVersion")
    return v.value


class _Graph:
    """An executable loop graph with the tensors it reads."""

    def __init__(self, device, build, *buffers):
        if driver_version() < MIN_DRIVER:
            raise RuntimeError(
                f"the loop graphs need conditional nodes (CUDA driver "
                f"12.3 or later); this CUDA driver is {driver_version()}")
        self.device = device
        self.totals = torch.zeros(T_WORDS, dtype=torch.int64, device=device)
        self._keep = buffers
        exec_ = ctypes.c_void_p()
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            _build.check(build(self.totals.data_ptr(),
                               ctypes.byref(exec_)), "loop graph build")
        stats["builds"] += 1
        stats["build_s"] += time.perf_counter() - t0
        self._exec = exec_.value
        self._lib = _build.load()

    def launch(self, like: torch.Tensor) -> None:
        with _build.on_device(like):
            _build.check(self._lib.phmrf_graph_launch(
                self._exec, _build.stream_of(like)), "loop graph launch")

    def close(self) -> None:
        if self._exec:
            # a launch still running finishes first
            _build.check(self._lib.phmrf_graph_destroy(self._exec),
                         "loop graph destroy")
            self._exec = None


_cache: collections.OrderedDict = collections.OrderedDict()
_retired: list = []     # the counters of graphs that left the cache


def _cached(key, make):
    g = _cache.get(key)
    if g is None:
        g = _cache[key] = make()
        while len(_cache) > MAX_GRAPHS:
            _, old = _cache.popitem(last=False)
            old.close()
            _retired.append(old.totals)
    _cache.move_to_end(key)
    return g


def kernel_launches() -> dict:
    """K2, K5 and K6 launches made inside the loop graphs of this process
    so far, from every graph's counters on the card (one read each)."""
    out = dict(K2=0, K5=0, K6=0)
    for t in [g.totals for g in _cache.values()] + _retired:
        t = t.cpu()
        out["K2"] += int(t[T_K2])
        out["K5"] += int(t[T_K5])
        out["K6"] += int(t[T_K6])
    return out


def _plane(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


class CutGraph(_Graph):
    """The min cut of an (R, H, W) region batch (``grid_mincut``'s
    graph route): the carry e, h, cap_t, caps and a second set for the
    ping-pong, two distance planes, the pr and bfs words."""

    def __init__(self, device, R: int, H: int, W: int):
        self.shape, self.n = (R, H, W), H * W + 2
        f, i = torch.float32, torch.int32
        self.a = (_plane((R, H, W), f, device), _plane((R, H, W), i, device),
                  _plane((R, H, W), f, device),
                  _plane((R, 8, H, W), f, device))
        self.b = tuple(torch.zeros_like(t) for t in self.a)
        self.d = (_plane((R, H, W), i, device), _plane((R, H, W), i, device))
        self.pr = new_loop(device)
        self.bfs = new_loop(device)
        super().__init__(
            device, lambda tot, ex: _build.load().phmrf_graph_cut(
                *(t.data_ptr() for t in self.a + self.b + self.d),
                R, H, W, self.n, self.pr.data_ptr(), self.bfs.data_ptr(),
                tot, ex), self.a, self.b, self.d, self.pr, self.bfs)

    def run(self, excess0, cap_t0, caps0, max_sweeps: int) -> torch.Tensor:
        """The source side (R, H, W) bool of the cut."""
        e, h, ct, caps = self.a
        e.copy_(excess0)
        h.zero_()
        ct.copy_(cap_t0)
        caps.copy_(caps0)
        # the first loop test (h = 0 < n: a node is active iff e > eps)
        # and the limit, written on the stream
        self.pr[LOOP_GO:LOOP_GO + 1].copy_(
            torch.any(excess0 > CUT_EPS).view(1))
        _fill(self.pr, LOOP_LIMIT, max_sweeps)
        self.launch(e)
        run_cut.launches += 1
        return self.d[0] >= self.n


class BfsGraph(_Graph):
    """The BFS fixpoint of an (R, H, W) batch from a seed
    (``_bfs_fixpoint``'s graph route)."""

    def __init__(self, device, R: int, H: int, W: int, n: int):
        self.shape, self.n = (R, H, W), n
        i = torch.int32
        self.d = (_plane((R, H, W), i, device), _plane((R, H, W), i, device))
        self.caps = _plane((R, 8, H, W), torch.float32, device)
        self.bfs = new_loop(device)
        super().__init__(
            device, lambda tot, ex: _build.load().phmrf_graph_bfs(
                self.d[0].data_ptr(), self.d[1].data_ptr(),
                self.caps.data_ptr(), R, H, W, n, self.bfs.data_ptr(), tot,
                ex), self.d, self.caps, self.bfs)

    def run(self, d, caps) -> torch.Tensor:
        self.d[0].copy_(d)
        self.caps.copy_(caps)
        self.launch(d)
        run_bfs.launches += 1
        return self.d[0].clone()


class IcmGraph(_Graph):
    """Checkerboard ICM of an (R, K, H, W) batch at one beta
    (``icm_kmajor``'s graph route) on the K2 tile plan ``plan``."""

    def __init__(self, device, R: int, K: int, H: int, W: int, beta: float,
                 plan):
        self.shape = (R, K, H, W)
        f, i = torch.float32, torch.int32
        self.unary = _plane((R, K, H, W), f, device)
        self.w = _plane((R, 4, H, W), f, device)
        self.mask = _plane((R, H, W), i, device)
        self.lab = (_plane((R, H, W), i, device),
                    _plane((R, H, W), i, device))
        self.loop = new_loop(device)
        super().__init__(
            device, lambda tot, ex: _build.load().phmrf_graph_icm(
                self.lab[0].data_ptr(), self.lab[1].data_ptr(),
                self.unary.data_ptr(), self.w.data_ptr(),
                self.mask.data_ptr(), R, K, H, W, float(beta), plan.th,
                plan.tw, plan.threads, self.loop.data_ptr(), tot, ex),
            self.unary, self.w, self.mask, self.lab, self.loop)

    def run(self, unary_k, wmaps, mask, init_labels,
            max_sweeps: int) -> torch.Tensor:
        self.unary.copy_(unary_k)
        self.w.copy_(wmaps)
        self.mask.copy_(mask)
        self.lab[0].copy_(torch.where(mask, init_labels, 0))
        _fill(self.loop, LOOP_LIMIT, max_sweeps)
        self.launch(unary_k)
        run_icm.launches += 1
        return self.lab[0].clone()


def _check_f32(what, *ts):
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the loop graphs take float32 "
                            f"operands, got {t.dtype} (plain=True runs "
                            f"the plain versions)")


def run_cut(excess0, cap_t0, caps0, max_sweeps: int) -> torch.Tensor:
    """The min cut on the card's loop (see ``maxflow.grid_mincut``)."""
    _check_f32("grid_mincut", excess0, cap_t0, caps0)
    R, H, W = excess0.shape
    if R * H * W == 0:
        return torch.zeros((R, H, W), dtype=torch.bool, device=excess0.device)
    g = cut_graph(excess0.device, R, H, W)
    return g.run(excess0, cap_t0, caps0, max_sweeps)


def cut_graph(device, R: int, H: int, W: int) -> CutGraph:
    """The cached min-cut graph of that shape on ``device``."""
    return _cached(("cut", device, R, H, W),
                   lambda: CutGraph(device, R, H, W))


def bfs_graph(device, R: int, H: int, W: int, n: int) -> BfsGraph:
    """The cached BFS-fixpoint graph of that shape on ``device``."""
    return _cached(("bfs", device, R, H, W, int(n)),
                   lambda: BfsGraph(device, R, H, W, int(n)))


def run_bfs(d, caps, n: int) -> torch.Tensor:
    """The BFS fixpoint from ``d`` on the card's loop (see
    ``maxflow._bfs_fixpoint``)."""
    _check_f32("_bfs_fixpoint", caps)
    if d.dtype != torch.int32:
        raise TypeError(f"_bfs_fixpoint: d is {d.dtype}, needs int32")
    return bfs_graph(d.device, *d.shape, n).run(d, caps)


def run_icm(unary_k, wmaps, mask, init_labels, beta: float,
            max_sweeps: int, plan) -> torch.Tensor:
    """ICM on the card's loop (see ``icm_kernels.icm_kmajor``)."""
    _check_f32("icm_kmajor", unary_k, wmaps)
    R, K, H, W = unary_k.shape
    if R * H * W == 0:
        return torch.where(mask, init_labels, 0).to(torch.int32)
    g = _cached(("icm", unary_k.device, R, K, H, W, float(beta), plan),
                lambda: IcmGraph(unary_k.device, R, K, H, W, beta, plan))
    return g.run(unary_k, wmaps, mask, init_labels, max_sweeps)


run_cut.launches = run_bfs.launches = run_icm.launches = 0

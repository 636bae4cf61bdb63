"""The loops of the exact cut and of ICM as CUDA graphs the card runs to
their end (``csrc/loops.cu``), and the loop word their kernels share.

Counterpart of the ``lax.while_loop``s of
``phylo_hmrf_tpu/ops/maxflow_tpu.py`` (``grid_mincut_fused`` and, in
float64, ``grid_mincut``: the min cut and its BFS fixpoint),
``phylo_hmrf_tpu/ops/icm_pallas.py::icm_pallas``,
``phylo_hmrf_tpu/ops/icm.py::icm`` (float64) and
``phylo_hmrf_tpu/parallel/halo.py::_icm_halo_pallas`` (the row-sharded
ICM, `UnitLoop`). `route` picks the loop: on a CUDA tensor a graph (its
bodies the kernels K2/K5/K6 in float32, or with ``plain`` units of the
plain versions' tensor code captured with ``torch.cuda.CUDAGraph`` and
taken in as child graph nodes, float64 in the model's strict-parity
mode), the host loop where the caller asks (``host_loop``) and on the
CPU. Both kinds of graph run the same program, node for node, on the
same words.

A graph is built once per (card, shape, dtype, kind; for ICM also beta),
with the static buffers it reads, and kept in a small cache: a graph reads
by address, and nothing tells the allocator that a graph still reads a
tensor, so the cache holds every tensor its graph reads (and a plain
graph its captured units, whose private memory pool the graph reads). A
call copies its inputs into those buffers, writes the loop's limits with
``fill_``, launches the graph on PyTorch's current stream and returns a
new tensor: no host read and no synchronization. A graph that cannot be
built or launched raises; nothing falls back.

The loop word (``csrc/loops.cuh``): int32 words GO, SEEN, TICKET, COUNT,
LIMIT, LAST (8 a loop). A K2, K5 or K6 launch given a word runs only
where GO is set (else it passes its input through), and its last block
sets COUNT += step, LAST = what it saw, GO = LAST and COUNT < LIMIT.
``loop_step`` is that protocol in tensor code, for the plain versions.

Counters: ``run_cut.launches``, ``run_bfs.launches``,
``run_icm.launches``, ``run_unit_loop.launches`` (launches of graphs
whose bodies launch kernels, host side) and ``.plain_launches`` (those of
the plain graphs); ``stats`` (graphs built, their seconds, the bytes
their captured units' pools hold); each graph's int64 ``totals`` on the
card (what its loops did: iterations, sweeps, kernel launches or plain
units, runs stopped at their limit), read only where a caller asks
(`kernel_launches`, `plain_units`, a cut's ``CutStats`` at
``_optimize_batched``'s cycle read).
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

# the graph counters (csrc/loops.cu's T_*): T_K* kernel launches, T_U*
# captured plain units
(T_RUNS, T_PR_ITERS, T_BFS_SWEEPS, T_CAPPED, T_K5, T_K6, T_K2, T_ICM_SWEEPS,
 T_ICM_CAPPED, T_U5, T_U6, T_U2, T_K8, T_U8) = range(14)
T_WORDS = 16

MAX_GRAPHS = 8   # graphs kept; the oldest goes first
MIN_DRIVER = 12030   # CUDA 12.3: conditional nodes

stats = dict(builds=0, build_s=0.0, captures=0, capture_s=0.0,
             pool_bytes=0)


def route(device, dtype, plain: bool, host_loop: bool) -> str:
    """The loop a cut, a BFS fixpoint or an ICM run on ``device`` with
    ``dtype`` operands takes: "host" (a host read a test: the CPU, or
    ``host_loop``), "plain" (a graph of captured plain units: ``plain``
    on a CUDA device, in any dtype) or "kernels" (a graph of K2/K5/K6
    nodes). The kernels take float32 only: another dtype without
    ``plain`` on a CUDA device raises, as the kernel wrappers do."""
    if host_loop or torch.device(device).type != "cuda":
        return "host"
    if plain:
        return "plain"
    if dtype != torch.float32:
        raise TypeError(f"the loop graphs' kernels take float32 operands, "
                        f"got {dtype} (plain=True runs the plain versions)")
    return "kernels"


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


class Units:
    """Units of tensor code captured for the bodies of one loop graph.

    Each callable of ``fns`` takes no argument and reads and writes only
    the graph's buffers and words and the tensors it makes itself (no
    host read, no synchronization). Each runs once on a side stream (so
    PyTorch loads its kernels and K8 makes its barrier word outside the
    capture), then is captured there with ``torch.cuda.CUDAGraph(
    keep_graph=True)``, all in one private memory pool: a unit's
    temporaries die with it and the units run one after the other, so
    they may share the pool. Each is instantiated right away: PyTorch
    keeps its CUDA generator in capture mode until a kept graph is
    instantiated, and a random draw outside a capture would raise. The
    raw graphs go to ``csrc/loops.cu`` as child nodes; this object (the
    ``CUDAGraph``s, so the pool) lives as long as that graph. A capture
    launches nothing: the launch counters of the wrappers in ``counters``
    are put back as they were after the warm-up. ``pool_bytes``: the
    device memory the pool holds."""

    def __init__(self, device, fns, counters=()):
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        side.synchronize()
        counts = [(c, c.launches) for c in counters]
        self.graphs, pool = [], None
        try:
            for fn in fns:
                g = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(g, pool=pool, stream=side):
                    fn()
                g.instantiate()
                pool = g.pool() if pool is None else pool
                self.graphs.append(g)
        finally:
            for c, n in counts:
                c.launches = n
        torch.cuda.current_stream(device).wait_stream(side)
        self._fns = fns
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        stats["captures"] += len(fns)
        stats["capture_s"] += time.perf_counter() - t0
        stats["pool_bytes"] += self.pool_bytes
        self.raw = (ctypes.c_void_p * len(fns))(
            *[g.raw_cuda_graph() for g in self.graphs])

    def pointer(self) -> int:
        """The address of the array of raw graphs (``void* const*``)."""
        return ctypes.addressof(self.raw)


_cache: collections.OrderedDict = collections.OrderedDict()
_retired: list = []     # the counters of graphs that left the cache


def cached(key, make):
    """The graph of ``key`` from the cache, made by ``make()`` on a miss;
    the oldest graph beyond ``MAX_GRAPHS`` is destroyed."""
    g = _cache.get(key)
    if g is None:
        g = _cache[key] = make()
        while len(_cache) > MAX_GRAPHS:
            _, old = _cache.popitem(last=False)
            old.close()
            _retired.append(old.totals)
    _cache.move_to_end(key)
    return g


def _counted(slots) -> dict:
    out = {name: 0 for name in slots}
    for t in [g.totals for g in _cache.values()] + _retired:
        t = t.cpu()
        for name, slot in slots.items():
            out[name] += int(t[slot])
    return out


def kernel_launches() -> dict:
    """K2, K5, K6 and K8 launches made inside the loop graphs of this
    process so far, from every graph's counters on the card (one read
    each)."""
    return _counted(dict(K2=T_K2, K5=T_K5, K6=T_K6, K8=T_K8))


def plain_units() -> dict:
    """The captured plain units of K2, K5, K6 and K8 that the plain loop
    graphs of this process ran so far (launched kernels of PyTorch's, not
    of this package)."""
    return _counted(dict(K2=T_U2, K5=T_U5, K6=T_U6, K8=T_U8))


def _plane(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _units_arg(units) -> int | None:
    return None if units is None else units.pointer()


def bfs_units(d, caps, n: int, bfs):
    """The two captured units of a plain BFS fixpoint: K6's plain version
    (8 sweeps, a step of the word ``bfs``) d0 -> d1 and d1 -> d0 over
    ``caps``."""
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import bfs_sweeps

    def sweeps(src, dst):
        def unit():
            bfs_sweeps(src, caps, n, n_inner=8, out=dst, loop=bfs,
                       plain=True)
        return unit
    return sweeps(d[0], d[1]), sweeps(d[1], d[0])


def cut_units(a, b, d, pr, bfs, n: int):
    """The six captured units of a plain cut graph, in the order
    ``csrc/loops.cu::build_cut`` takes them, as callables on its buffers:
    the carry ``a`` = (e, h, cap_t, caps) and the ping-pong's set ``b``,
    the distance planes ``d``, the words ``pr`` and ``bfs``. The seed of
    a relabel (1 where the sink arc is residual, else n) into d0; the two
    `bfs_units`; the relabel's height max (where the pr word runs); K5's
    plain version (4 iterations, a step of the pr word) a -> b and b ->
    a. Tensor code only: the CPU tests run them unrolled."""
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import pr_iterations

    def seed():
        d[0].copy_(torch.where(a[2] > CUT_EPS, 1, n))

    def hmax():
        a[1].copy_(torch.where(pr[LOOP_GO] != 0, torch.maximum(a[1], d[0]),
                               a[1]))

    def pr_ab():
        pr_iterations(*a, n, n_inner=4, out=b, loop=pr, plain=True)

    def pr_ba():
        pr_iterations(*b, n, n_inner=4, out=a, loop=pr, plain=True)
    return (seed, *bfs_units(d, a[3], n, bfs), hmax, pr_ab, pr_ba)


def icm_units(lab, unary, w, mask_i, beta: float, loop):
    """The two captured units of a plain ICM graph: K2's plain version (a
    sweep pair, a step of ``loop``) lab[0] -> lab[1] and back."""
    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_sweep_pair

    def pair(src, dst):
        def unit():
            dst.copy_(icm_sweep_pair(src, unary, w, mask_i, beta,
                                     plain=True, loop=loop))
        return unit
    return pair(lab[0], lab[1]), pair(lab[1], lab[0])


class CutGraph(_Graph):
    """The min cut of an (R, H, W) region batch (``grid_mincut``'s
    graph route): the carry e, h, cap_t, caps and a second set for the
    ping-pong, two distance planes, the pr and bfs words; with ``plain``
    the bodies are `cut_units` captured, in ``dtype``."""

    def __init__(self, device, R: int, H: int, W: int,
                 dtype=torch.float32, plain: bool = False):
        self.shape, self.n, self.plain = (R, H, W), H * W + 2, plain
        f, i = dtype, torch.int32
        self.a = (_plane((R, H, W), f, device), _plane((R, H, W), i, device),
                  _plane((R, H, W), f, device),
                  _plane((R, 8, H, W), f, device))
        self.b = tuple(torch.zeros_like(t) for t in self.a)
        self.d = (_plane((R, H, W), i, device), _plane((R, H, W), i, device))
        self.pr = new_loop(device)
        self.bfs = new_loop(device)
        self.units = Units(device, cut_units(self.a, self.b, self.d, self.pr,
                                             self.bfs, self.n)) \
            if plain else None
        super().__init__(
            device, lambda tot, ex: _build.load().phmrf_graph_cut(
                *(t.data_ptr() for t in self.a + self.b + self.d),
                R, H, W, self.n, self.pr.data_ptr(), self.bfs.data_ptr(),
                tot, _units_arg(self.units), ex),
            self.a, self.b, self.d, self.pr, self.bfs, self.units)

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
        _count(run_cut, self.plain)
        return self.d[0] >= self.n


class BfsGraph(_Graph):
    """The BFS fixpoint of an (R, H, W) batch from a seed
    (``_bfs_fixpoint``'s graph route); with ``plain`` the bodies are
    `bfs_units` captured, the capacities in ``dtype``."""

    def __init__(self, device, R: int, H: int, W: int, n: int,
                 dtype=torch.float32, plain: bool = False):
        self.shape, self.n, self.plain = (R, H, W), n, plain
        i = torch.int32
        self.d = (_plane((R, H, W), i, device), _plane((R, H, W), i, device))
        self.caps = _plane((R, 8, H, W), dtype, device)
        self.bfs = new_loop(device)
        self.units = Units(device, bfs_units(self.d, self.caps, n,
                                             self.bfs)) if plain else None
        super().__init__(
            device, lambda tot, ex: _build.load().phmrf_graph_bfs(
                self.d[0].data_ptr(), self.d[1].data_ptr(),
                self.caps.data_ptr(), R, H, W, n, self.bfs.data_ptr(), tot,
                _units_arg(self.units), ex),
            self.d, self.caps, self.bfs, self.units)

    def run(self, d, caps) -> torch.Tensor:
        self.d[0].copy_(d)
        self.caps.copy_(caps)
        self.launch(d)
        _count(run_bfs, self.plain)
        return self.d[0].clone()


class IcmGraph(_Graph):
    """Checkerboard ICM of an (R, K, H, W) batch at one beta
    (``icm_kmajor``'s graph route) on the K2 tile plan ``plan``, or with
    ``plain`` on `icm_units` captured, in ``dtype``."""

    def __init__(self, device, R: int, K: int, H: int, W: int, beta: float,
                 plan, dtype=torch.float32, plain: bool = False):
        self.shape, self.plain = (R, K, H, W), plain
        f, i = dtype, torch.int32
        self.unary = _plane((R, K, H, W), f, device)
        self.w = _plane((R, 4, H, W), f, device)
        self.mask = _plane((R, H, W), i, device)
        self.lab = (_plane((R, H, W), i, device),
                    _plane((R, H, W), i, device))
        self.loop = new_loop(device)
        self.units = Units(device, icm_units(
            self.lab, self.unary, self.w, self.mask, beta, self.loop)) \
            if plain else None
        th, tw, threads = (0, 0, 0) if plain else plan[:3]
        super().__init__(
            device, lambda tot, ex: _build.load().phmrf_graph_icm(
                self.lab[0].data_ptr(), self.lab[1].data_ptr(),
                self.unary.data_ptr(), self.w.data_ptr(),
                self.mask.data_ptr(), R, K, H, W, float(beta), th, tw,
                threads, self.loop.data_ptr(), tot, _units_arg(self.units),
                ex),
            self.unary, self.w, self.mask, self.lab, self.loop, self.units)

    def run(self, unary_k, wmaps, mask, init_labels,
            max_sweeps: int) -> torch.Tensor:
        self.unary.copy_(unary_k)
        self.w.copy_(wmaps)
        self.mask.copy_(mask)
        self.lab[0].copy_(torch.where(mask, init_labels, 0))
        _fill(self.loop, LOOP_LIMIT, max_sweeps)
        self.launch(unary_k)
        _count(run_icm, self.plain)
        return self.lab[0].clone()


class UnitLoop(_Graph):
    """A loop graph whose body is one captured unit: begin (GO = 0 <
    LIMIT), then WHILE {unit, cond} (``csrc/loops.cu``'s unit loop), the
    row-sharded ICM of ``parallel/halo.py`` on one card.

    ``make_unit(loop)`` returns the unit (see `Units`) for the word
    ``loop``: it runs one step and ends with `loop_step` on the word.
    ``buffers``: what it reads and writes, kept with the graph. Its
    launches count ``per_body`` a body at counter ``slot`` (``T_K2`` /
    ``T_K8`` when it launches kernels, ``T_U2`` / ``T_U8`` for plain
    units); ``counters``: the wrappers its kernels count on (put back
    after the capture)."""

    def __init__(self, device, make_unit, slot: int, per_body: int,
                 buffers, counters=()):
        self.plain = slot in (T_U2, T_U5, T_U6, T_U8)
        self.loop = new_loop(device)
        self.units = Units(device, [make_unit(self.loop)], counters)
        super().__init__(
            device, lambda tot, ex: _build.load().phmrf_graph_unit_loop(
                self.units.raw[0], self.loop.data_ptr(), tot, slot,
                per_body, ex), buffers, self.loop, self.units)


def _count(fn, plain: bool) -> None:
    if plain:
        fn.plain_launches += 1
    else:
        fn.launches += 1


def run_cut(excess0, cap_t0, caps0, max_sweeps: int, *,
            plain: bool = False) -> torch.Tensor:
    """The min cut on the card's loop (see ``maxflow.grid_mincut``)."""
    route(excess0.device, excess0.dtype, plain, False)
    R, H, W = excess0.shape
    if R * H * W == 0:
        return torch.zeros((R, H, W), dtype=torch.bool, device=excess0.device)
    g = cut_graph(excess0.device, R, H, W, excess0.dtype, plain)
    return g.run(excess0, cap_t0, caps0, max_sweeps)


def cut_graph(device, R: int, H: int, W: int, dtype=torch.float32,
              plain: bool = False) -> CutGraph:
    """The cached min-cut graph of that shape, dtype and kind on
    ``device``."""
    return cached(("cut", device, R, H, W, dtype, plain),
                  lambda: CutGraph(device, R, H, W, dtype, plain))


def bfs_graph(device, R: int, H: int, W: int, n: int, dtype=torch.float32,
              plain: bool = False) -> BfsGraph:
    """The cached BFS-fixpoint graph of that shape, capacity dtype and
    kind on ``device``."""
    return cached(("bfs", device, R, H, W, int(n), dtype, plain),
                  lambda: BfsGraph(device, R, H, W, int(n), dtype, plain))


def run_bfs(d, caps, n: int, *, plain: bool = False) -> torch.Tensor:
    """The BFS fixpoint from ``d`` on the card's loop (see
    ``maxflow._bfs_fixpoint``)."""
    route(caps.device, caps.dtype, plain, False)
    if d.dtype != torch.int32:
        raise TypeError(f"_bfs_fixpoint: d is {d.dtype}, needs int32")
    return bfs_graph(d.device, *d.shape, n, caps.dtype, plain).run(d, caps)


def run_icm(unary_k, wmaps, mask, init_labels, beta: float,
            max_sweeps: int, plan, *, plain: bool = False) -> torch.Tensor:
    """ICM on the card's loop (see ``icm_kernels.icm_kmajor``)."""
    route(unary_k.device, unary_k.dtype, plain, False)
    R, K, H, W = unary_k.shape
    if R * H * W == 0:
        return torch.where(mask, init_labels, 0).to(torch.int32)
    g = cached(("icm", unary_k.device, R, K, H, W, float(beta),
                None if plain else plan, unary_k.dtype, plain),
               lambda: IcmGraph(unary_k.device, R, K, H, W, beta, plan,
                                unary_k.dtype, plain))
    return g.run(unary_k, wmaps, mask, init_labels, max_sweeps)


def run_unit_loop(g: UnitLoop, max_sweeps: int) -> None:
    """Launch the unit loop ``g`` (a graph of `cached`'s) whose buffers
    its caller has filled: its loop runs while its unit's steps say so
    and fewer than ``max_sweeps`` sweeps ran."""
    _fill(g.loop, LOOP_LIMIT, max_sweeps)
    g.launch(g.loop)
    _count(run_unit_loop, g.plain)


for _fn in (run_cut, run_bfs, run_icm, run_unit_loop):
    _fn.launches = _fn.plain_launches = 0

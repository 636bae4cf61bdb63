"""K5 (push-relabel iterations) and K6 (BFS min-plus sweeps) of the grid
min-cut, with their CUDA kernels (``csrc/mincut.cu``).

Counterpart of ``phylo_hmrf_tpu/ops/mincut_pallas.py``: ``pr_iterations``
replaces ``pr_iterations_pallas`` and ``bfs_sweeps`` replaces
``bfs_sweeps_pallas``. Layout: e, cap_t (R, H, W) float32; h, d (R, H, W)
int32; caps (R, 8, H, W) float32 with the arc directions of ``ALL_DIRS``.
Arcs leaving the grid must carry capacity exactly 0 (the move graphs of
``ops/maxflow.py`` are built so).

Both wrappers are functional, as the JAX entries are: they read their
state and write the new state to ``out`` (buffers the caller owns; new
tensors when it gives none). With a loop word ``loop`` (``ops/loops.py``)
a call is a step of that loop: it runs only where the word's GO is set
(else it passes its state through) and updates the word; the host loop
of ``maxflow.grid_mincut_host`` reads GO after each call, the graphs of
``csrc/loops.cu`` launch the same kernels with no read. On a CPU tensor,
or with ``plain=True``, they run the plain version (in the operands'
dtype: float64 capacities in the model's strict-parity mode) under the
same word protocol in tensor code; on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops import loops
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2

ALL_DIRS = tuple(DIRS) + tuple((-di, -dj) for (di, dj) in DIRS)
EPS = loops.CUT_EPS
BFS_MAX_INNER = 8    # sweeps one K6 launch can run (its halo is 8 pixels)
PR_MAX_INNER = 4     # iterations one K5 launch can run (radius 2 each)


def _rev(d: int) -> int:
    return (d + 4) % 8


def _nb(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """Value at the direction-d neighbour of each pixel (``fill`` outside)."""
    di, dj = ALL_DIRS[d]
    return _shift2(x, di, dj, fill)


def bfs_sweeps_plain(d, caps, n: int, n_inner: int):
    """Plain version of K6: ``n_inner`` Jacobi min-plus sweeps toward the
    sink, d <- min(d, min over residual arcs of d_nb + 1, n)."""
    for _ in range(n_inner):
        best = d
        for a in range(8):
            cand = torch.where(caps[:, a] > EPS, _nb(d, a, n) + 1, n)
            best = torch.minimum(best, cand)
        d = torch.clamp_max(best, n)
    return d


def bfs_sweeps(d, caps, n: int, *, n_inner: int = 8, out=None, loop=None,
               plain: bool = False):
    """``n_inner`` (<= 8) BFS sweeps from ``d`` (not written) into ``out``,
    in one K6 launch, a step of the loop ``loop`` (an int32 word, or None:
    no loop): it goes on while some distance changed. Returns (new d,
    loop)."""
    if not 1 <= n_inner <= BFS_MAX_INNER:
        raise ValueError(f"bfs_sweeps: n_inner {n_inner} not in 1..8")
    out = torch.empty_like(d) if out is None else out
    if plain or d.device.type == "cpu":
        new = bfs_sweeps_plain(d, caps, n, n_inner)
        if loop is not None:
            new, = loops.loop_step(loop, (new,), (d,), torch.any(new != d),
                                   n_inner)
        return out.copy_(new), loop
    R, H, W = d.shape
    specs = dict(d=(d, torch.int32, (R, H, W)),
                 out=(out, torch.int32, (R, H, W)),
                 caps=(caps, torch.float32, (R, 8, H, W)))
    if loop is not None:
        specs["loop"] = (loop, torch.int32, (loops.LOOP_WORDS,))
    _build.check_tensors("bfs_sweeps", **specs)
    if out.data_ptr() == d.data_ptr():
        raise ValueError("bfs_sweeps: out must be another buffer than d")
    with _build.on_device(d):
        _build.check(_build.load().phmrf_bfs_sweeps(
            d.data_ptr(), out.data_ptr(), caps.data_ptr(), R, H, W, int(n),
            int(n_inner), 0 if loop is None else loop.data_ptr(),
            _build.stream_of(d)),
            "K6 bfs_sweeps")
    bfs_sweeps.launches += 1
    return out, loop


bfs_sweeps.launches = 0


def pr_iterations_plain(e, h, cap_t, caps, n: int, n_inner: int):
    """Plain version of K5: ``n_inner`` Jacobi push-relabel iterations
    (the arithmetic of ``_pr_kernel``, in its order). Returns new
    (e, h, cap_t, caps)."""
    for _ in range(n_inner):
        # push to the sink (height 0): admissible where h == 1
        delta = torch.where(h == 1, torch.minimum(e, cap_t), 0.0)
        e = e - delta
        cap_t = cap_t - delta
        # outgoing pushes against the local budget, in direction order
        outs = []
        for a in range(8):
            admissible = (h == _nb(h, a, -1) + 1) & (h < n)
            d_out = torch.where(admissible, torch.minimum(e, caps[:, a]), 0.0)
            e = e - d_out
            outs.append(d_out)
        # incoming flow after all pushes
        inc = [_nb(outs[_rev(a)], a, 0.0) for a in range(8)]
        caps = torch.stack([caps[:, a] - outs[a] + inc[a] for a in range(8)],
                           dim=1)
        for a in range(8):
            e = e + inc[a]
        # relabel active nodes over the pre-iteration neighbour heights
        active = (e > EPS) & (h < n)
        min_h = torch.where(cap_t > EPS, 0, n).to(torch.int32)
        for a in range(8):
            min_h = torch.minimum(
                min_h, torch.where(caps[:, a] > EPS, _nb(h, a, n), n))
        new_h = torch.clamp_max(min_h + 1, n)
        h = torch.where(active, torch.maximum(h, new_h), h)
    return e, h, cap_t, caps


def pr_iterations(e, h, cap_t, caps, n: int, *, n_inner: int = 4, out=None,
                  loop=None, plain: bool = False):
    """``n_inner`` (<= 4) push-relabel iterations in one K5 launch, from
    (e, h, cap_t, caps) (not written) into ``out``, a 4-tuple of buffers
    of the same shapes, a step of the loop ``loop`` (an int32 word, or
    None: no loop): it goes on while some node is active (e > EPS, h < n)
    after them. Returns (new (e, h, cap_t, caps), loop)."""
    if not 1 <= n_inner <= PR_MAX_INNER:
        raise ValueError(f"pr_iterations: n_inner {n_inner} not in 1..4")
    state = (e, h, cap_t, caps)
    out = tuple(torch.empty_like(t) for t in state) if out is None else out
    if plain or e.device.type == "cpu":
        new = pr_iterations_plain(e, h, cap_t, caps, n, n_inner)
        if loop is not None:
            new = loops.loop_step(loop, new, state,
                                  torch.any((new[0] > EPS) & (new[1] < n)),
                                  n_inner)
        return tuple(o.copy_(t) for o, t in zip(out, new)), loop
    R, H, W = e.shape
    plane = (R, H, W)
    specs = dict(
        e=(e, torch.float32, plane), h=(h, torch.int32, plane),
        cap_t=(cap_t, torch.float32, plane),
        caps=(caps, torch.float32, (R, 8, H, W)),
        e_out=(out[0], torch.float32, plane),
        h_out=(out[1], torch.int32, plane),
        cap_t_out=(out[2], torch.float32, plane),
        caps_out=(out[3], torch.float32, (R, 8, H, W)))
    if loop is not None:
        specs["loop"] = (loop, torch.int32, (loops.LOOP_WORDS,))
    _build.check_tensors("pr_iterations", **specs)
    if any(o.data_ptr() == t.data_ptr() for o, t in zip(out, state)):
        raise ValueError("pr_iterations: out must be other buffers than the "
                         "state")
    with _build.on_device(e):
        _build.check(_build.load().phmrf_pr_iterations(
            *(t.data_ptr() for t in state), *(t.data_ptr() for t in out),
            R, H, W, int(n), int(n_inner),
            0 if loop is None else loop.data_ptr(),
            _build.stream_of(e)), "K5 pr_iterations")
    pr_iterations.launches += 1
    return out, loop


pr_iterations.launches = 0

"""K5 (push-relabel iterations) and K6 (BFS min-plus sweeps) of the grid
min-cut, with their CUDA kernels (``csrc/mincut.cu``).

Counterpart of ``phylo_hmrf_tpu/ops/mincut_pallas.py``: ``pr_iterations_``
replaces ``pr_iterations_pallas`` and ``bfs_sweeps_`` replaces
``bfs_sweeps_pallas``. Layout: e, cap_t (R, H, W) float32; h, d (R, H, W)
int32; caps (R, 8, H, W) float32 with the arc directions of ``ALL_DIRS``.
Arcs leaving the grid must carry capacity exactly 0 (the move graphs of
``ops/maxflow.py`` are built so).

Both wrappers update their state tensors in place (the loop in
``maxflow.grid_mincut`` owns them). On a CPU tensor they run the plain
version; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch import _build
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2

ALL_DIRS = tuple(DIRS) + tuple((-di, -dj) for (di, dj) in DIRS)
EPS = 1e-6


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


def bfs_sweeps_(d, caps, n: int, *, n_inner: int = 8) -> torch.Tensor:
    """``n_inner`` BFS sweeps on ``d`` in place. Returns a 0-d int32 tensor
    on d's device, nonzero iff some distance changed (read by the caller
    once per call)."""
    if d.device.type == "cpu":
        new = bfs_sweeps_plain(d, caps, n, n_inner)
        changed = torch.any(new != d).to(torch.int32)
        d.copy_(new)
        return changed
    R, H, W = d.shape
    _build.check_tensors("bfs_sweeps_", d=(d, torch.int32, (R, H, W)),
                         caps=(caps, torch.float32, (R, 8, H, W)))
    lib = _build.load()
    scratch = torch.empty_like(d)
    changed = torch.empty((), dtype=torch.int32, device=d.device)
    with _build.on_device(d):
        _build.check(lib.phmrf_bfs_sweeps(
            d.data_ptr(), scratch.data_ptr(), caps.data_ptr(), R, H, W, int(n),
            int(n_inner), changed.data_ptr(), _build.stream_of(d)),
            "K6 bfs_sweeps")
    bfs_sweeps_.launches += n_inner      # one kernel launch per sweep
    return changed


bfs_sweeps_.launches = 0


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


def pr_iterations_(e, h, cap_t, caps, n: int, *, n_inner: int = 4) -> None:
    """``n_inner`` push-relabel iterations, updating e, h, cap_t and caps
    in place."""
    if e.device.type == "cpu":
        for t, new in zip((e, h, cap_t, caps),
                          pr_iterations_plain(e, h, cap_t, caps, n, n_inner)):
            t.copy_(new)
        return
    R, H, W = e.shape
    _build.check_tensors(
        "pr_iterations_", e=(e, torch.float32, (R, H, W)),
        h=(h, torch.int32, (R, H, W)), cap_t=(cap_t, torch.float32, (R, H, W)),
        caps=(caps, torch.float32, (R, 8, H, W)))
    lib = _build.load()
    h_scratch = torch.empty_like(h)
    out = torch.empty_like(caps)
    with _build.on_device(e):
        _build.check(lib.phmrf_pr_iterations(
            e.data_ptr(), h.data_ptr(), h_scratch.data_ptr(), cap_t.data_ptr(),
            caps.data_ptr(), out.data_ptr(), R, H, W, int(n), int(n_inner),
            _build.stream_of(e)), "K5 pr_iterations")
    pr_iterations_.launches += 2 * n_inner   # push + relabel per iteration


pr_iterations_.launches = 0

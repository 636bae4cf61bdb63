"""M1 and M2 (``csrc/moves.cu``): an exact move's cut graph built in one
launch, straight into the min-cut graph's carry, and the move's labels
written from the cut in a second one.

No TPU kernel: the JAX package builds a move's graph in XLA, inside its
move loop. The plain versions are the tensor code of
``ops/maxflow.py::_swap_graph`` / ``_expansion_graph`` and of the label
update of ``_swap_move_batch`` / ``_expansion_move_batch``; M1 is bitwise
the former (every term added in its order). ``_optimize_batched`` takes
these kernels exactly where the moves' cut graph runs kernels
(``maxflow.build_route`` "kernel": CUDA, float32, not ``plain``, not
``host_loop``); there a move is three host launches: M1, the cut graph
(`loops.CutGraph.launch_filled`), M2.

Counters: ``build_move.launches`` and ``apply_move.launches``, host side.
"""

from __future__ import annotations

import torch

from phylo_hmrf_tpu_torch import _build


class MovePass:
    """The operands and buffers of one ``_optimize_batched`` pass on the
    kernel route, checked once: ``graph`` (a float32 `loops.CutGraph` of
    the labels' shape) takes each move's graph in its carry and pr word;
    ``in_play`` (R, H, W) bool is the last built move's cut; ``counts``
    (rows, R) int32, zeroed here, takes move ``t``'s changed pixels a
    region in row ``t``. The labels are updated in place by `apply_move`.
    """

    def __init__(self, graph, labels, unary_k, wmaps, mask, wsum,
                 beta: float, rows: int):
        R, K, H, W = unary_k.shape
        dev = unary_k.device
        self.graph, self.labels, self.beta = graph, labels, float(beta)
        self.shape = (R, K, H, W)
        self.unary = unary_k.contiguous()
        self.w = wmaps.contiguous()
        self.mask = mask.contiguous()
        self.wsum = wsum.contiguous()
        self.in_play = torch.empty((R, H, W), dtype=torch.bool, device=dev)
        self.counts = torch.zeros((rows, R), dtype=torch.int32, device=dev)
        e, h, cap_t, caps = graph.a
        f, i, b = torch.float32, torch.int32, torch.bool
        plane = (R, H, W)
        _build.check_tensors(
            "move kernels", labels=(labels, i, plane),
            unary=(self.unary, f, (R, K, H, W)), w=(self.w, f, (R, 4, H, W)),
            mask=(self.mask, b, plane), wsum=(self.wsum, f, plane),
            e=(e, f, plane), h=(h, i, plane), cap_t=(cap_t, f, plane),
            caps=(caps, f, (R, 8, H, W)), in_play=(self.in_play, b, plane),
            counts=(self.counts, i, (rows, R)), d=(graph.d[0], i, plane))
        self.build_ptrs = (labels.data_ptr(), self.unary.data_ptr(),
                           self.w.data_ptr(), self.mask.data_ptr(),
                           self.wsum.data_ptr(),
                           *(t.data_ptr() for t in graph.a),
                           self.in_play.data_ptr(), graph.pr.data_ptr())
        self.stream = _build.stream_of(unary_k)


def build_move(mp: MovePass, a: int, b: int, max_sweeps: int) -> None:
    """M1: the cut graph of the swap (a, b), or with ``b`` = -1 of the
    expansion of ``a``, into ``mp.graph``'s carry (e, h = 0, cap_t, caps)
    and ``mp.in_play``, and the pr word's first test (some excess > eps)
    and limit ``max_sweeps``: the graph is ready to launch."""
    R, K, H, W = mp.shape
    with _build.on_device(mp.unary):
        _build.check(_build.load().phmrf_move_build(
            *mp.build_ptrs, R, K, H, W, int(a), int(b), mp.beta,
            int(max_sweeps), mp.stream), "M1 move_build")
    build_move.launches += 1


def apply_move(mp: MovePass, a: int, b: int, row: int) -> None:
    """M2: the labels of the move that `build_move` built, from the cut
    in ``mp.graph`` (source side: distance >= n), written in place, and
    each region's count of changed pixels added into ``mp.counts[row]``."""
    R, _, H, W = mp.shape
    if not 0 <= row < mp.counts.shape[0]:
        raise IndexError(f"apply_move: row {row} of {mp.counts.shape[0]}")
    with _build.on_device(mp.unary):
        _build.check(_build.load().phmrf_move_apply(
            mp.labels.data_ptr(), mp.graph.d[0].data_ptr(),
            mp.in_play.data_ptr(),
            mp.counts.data_ptr() + row * R * mp.counts.element_size(),
            R, H, W, mp.graph.n, int(a), int(b), mp.stream), "M2 move_apply")
    apply_move.launches += 1


build_move.launches = apply_move.launches = 0

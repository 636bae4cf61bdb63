"""Bounded L-BFGS for the OU M-step, batched over independent problems.

Counterpart of ``phylo_hmrf_tpu/ops/lbfgs.py``, where one solver runs per
state under ``vmap`` of a ``while_loop``. Here the B problems (the K
states) run as one batch: every tensor carries a leading batch axis, each
problem stops on its own (after ``n_iters`` steps, or after ``patience``
steps without relative improvement above ``tol``), and a stopped problem's
carry stays frozen while the others go on — what the vmapped while_loop
does. The box is a sigmoid reparameterization; the line search evaluates a
fixed geometric grid of step sizes in one batched call.

``fn`` maps x (..., B, P) to values (..., B), one independent problem per
row; gradients come from autograd on the sum over problems.

The solver is a carry (`lbfgs_init`) and a step (`lbfgs_step`, pure
tensor work, no host read) under one of two drivers:

* `minimize_lbfgs`, the plain driver: a Python loop that reads one flag a
  step from the device (the exit check). The CPU route, and the reference
  the graph route is held to.
* `GraphSolve`, the CUDA driver: the carry's initialisation, a chunk of
  ``GRAPH_CHUNK`` steps and the decode of the result, each captured once
  as a ``torch.cuda.CUDAGraph`` and replayed. A stopped row keeps its
  carry (every field passes through ``torch.where(active, new, old)``,
  and the step counter stops every row at ``n_iters``), so steps
  replayed after every row stopped change no bit: ``ceil(n_iters /
  GRAPH_CHUNK)`` replays with no host read equal the plain driver's
  early-exit loop, bitwise.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

_LS_ETAS = (4.0, 2.0, 1.0, 0.5, 0.25, 0.1, 0.04, 0.015, 0.005, 0.001)
_BOXED_TOL = 1e-7     # the boxed solve's early-exit threshold
_PATIENCE = 5         # steps without gain before a row stops
GRAPH_CHUNK = 10      # L-BFGS steps a captured graph replays


def box_encode(p: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Box coordinates -> unconstrained space (logit)."""
    t = torch.clamp((p - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
    return torch.log(t) - torch.log1p(-t)


def box_decode(z: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.sigmoid(z)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _two_loop(g, S, Y, rho, valid):
    """L-BFGS two-loop recursion over a ring buffer, batched.

    g (B, P); S, Y (B, M, P) oldest..newest; rho (B, M) = 1/(s.y);
    valid (B, M) marks filled slots."""
    M = S.shape[1]
    v = valid.to(g.dtype)
    q = g
    alphas = [None] * M
    for i in range(M - 1, -1, -1):           # newest to oldest
        a = rho[:, i] * _dot(S[:, i], q) * v[:, i]
        q = q - a[:, None] * Y[:, i]
        alphas[i] = a
    sy = _dot(S[:, M - 1], Y[:, M - 1])
    yy = _dot(Y[:, M - 1], Y[:, M - 1])
    gamma = torch.where(valid[:, M - 1], sy / torch.clamp(yy, min=1e-20), 1.0)
    r = gamma[:, None] * q
    for i in range(M):                       # oldest to newest
        b = rho[:, i] * _dot(Y[:, i], r) * v[:, i]
        r = r + (alphas[i] - b)[:, None] * S[:, i]
    return r


def _value_and_grad(fn, x):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fn(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


def _ring_push(buf, new, keep):
    """Drop the oldest slot and append ``new`` where ``keep`` (per row)."""
    shifted = torch.cat([buf[:, 1:], new[:, None]], dim=1)
    k = keep.view((-1,) + (1,) * (buf.dim() - 1))
    return torch.where(k, shifted, buf)


class LbfgsCarry(NamedTuple):
    """The solver's state: x (B, P), f (B,), g (B, P), the ring buffers S,
    Y (B, M, P), rho (B, M), valid (B, M), the stall count (B,), the rows
    still running (B,) and the steps taken (a 0-d int32 tensor)."""
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    rho: torch.Tensor
    valid: torch.Tensor
    stall: torch.Tensor
    active: torch.Tensor
    it: torch.Tensor


def lbfgs_init(fn, x0: torch.Tensor, memory_size: int = 10) -> LbfgsCarry:
    """The carry at x0 (B, P): f and g there, empty ring buffers."""
    B, P = x0.shape
    M = memory_size
    dev = x0.device
    x = x0.detach().clone()
    f, g = _value_and_grad(fn, x)
    return LbfgsCarry(
        x=x, f=f, g=g, S=x0.new_zeros(B, M, P), Y=x0.new_zeros(B, M, P),
        rho=x0.new_zeros(B, M),
        valid=torch.zeros(B, M, dtype=torch.bool, device=dev),
        stall=torch.zeros(B, dtype=torch.int32, device=dev),
        active=torch.ones(B, dtype=torch.bool, device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev))


def lbfgs_step(fn, carry: LbfgsCarry, etas_t: torch.Tensor, tol: float,
               patience: int, n_iters: int) -> LbfgsCarry:
    """One L-BFGS step of every running row; a stopped row keeps its
    carry. A row stops after ``patience`` steps without relative gain
    above ``tol`` (``tol`` 0: never) or once ``n_iters`` steps ran. Tensor
    work only: no host read, so a chunk of steps can be captured."""
    x, f, g, S, Y, rho, valid, stall, active, it = carry
    B, P = x.shape
    d = -_two_loop(g, S, Y, rho, valid)
    # steepest descent where d is not a finite descent direction
    ok = (_dot(d, g) < 0) & torch.isfinite(d).all(dim=-1)
    d = torch.where(ok[:, None], d, -g)

    cand = x[None] + etas_t[:, None, None] * d[None]          # (E, B, P)
    with torch.no_grad():
        fs = fn(cand)                                         # (E, B)
    fs = torch.where(torch.isfinite(fs), fs, torch.inf)
    best = torch.argmin(fs, dim=0)                            # (B,)
    f_try = fs.gather(0, best[None])[0]
    improved = f_try < f
    x_try = cand.gather(0, best.view(1, B, 1).expand(1, B, P))[0]
    x_new = torch.where(improved[:, None], x_try, x)
    f_new = torch.where(improved, f_try, f)
    _, g_new = _value_and_grad(fn, x_new)
    g_new = torch.where(torch.isfinite(g_new), g_new, g)

    s = x_new - x
    y = g_new - g
    sy = _dot(s, y)
    keep = improved & (sy > 1e-12)
    S2 = _ring_push(S, s, keep)
    Y2 = _ring_push(Y, y, keep)
    rho2 = _ring_push(rho, 1.0 / torch.clamp(sy, min=1e-20), keep)
    valid2 = _ring_push(valid, torch.ones_like(keep), keep)

    if tol > 0:
        gain = (f - f_new) > tol * torch.clamp(torch.abs(f_new), min=1.0)
        stall2 = torch.where(gain, 0, stall + 1)
    else:
        stall2 = stall
    # a stopped problem keeps its carry, as in the vmapped while_loop
    a = active
    stall = torch.where(a, stall2, stall)
    it = it + 1
    return LbfgsCarry(
        x=torch.where(a[:, None], x_new, x), f=torch.where(a, f_new, f),
        g=torch.where(a[:, None], g_new, g),
        S=torch.where(a[:, None, None], S2, S),
        Y=torch.where(a[:, None, None], Y2, Y),
        rho=torch.where(a[:, None], rho2, rho),
        valid=torch.where(a[:, None], valid2, valid), stall=stall,
        active=(stall < patience) & (it < n_iters), it=it)


def minimize_lbfgs(fn, x0: torch.Tensor, n_iters: int, memory_size: int = 10,
                   etas=_LS_ETAS, tol: float = 0.0,
                   patience: int = _PATIENCE):
    """Minimize each row of ``fn`` from x0 (B, P); returns (x, f). The
    plain driver: one host read a step, the loop ends when no row runs."""
    etas_t = torch.as_tensor(etas, dtype=x0.dtype, device=x0.device)
    carry = lbfgs_init(fn, x0, memory_size)
    for _ in range(n_iters):
        carry = lbfgs_step(fn, carry, etas_t, tol, patience, n_iters)
        if not bool(carry.active.any()):
            break
    return carry.x, carry.f


def minimize_boxed(fn, p0: torch.Tensor, lo: float, hi: float, n_iters: int,
                   tol: float = _BOXED_TOL):
    """Box-constrained minimize of fn(box_decode(z)) over z, batched over
    the rows of p0 (B, P). Returns (p (B, P), f (B,))."""
    z0 = box_encode(p0, lo, hi)
    z, f = minimize_lbfgs(lambda z: fn(box_decode(z, lo, hi)), z0, n_iters,
                          tol=tol)
    return box_decode(z, lo, hi), f


class GraphSolve:
    """`minimize_boxed` of one objective on a CUDA device (its default
    ``tol``), as CUDA graphs.

    ``objective(p, *args)`` is the loss of params p (..., B, P) given the
    tensors ``args``; ``finish(p, f, *args)`` maps the solved params and
    values to the tensors a solve returns (default: ``(p, f)``). The
    graphs bake in the objective, every host scalar it closes over, the
    shapes, the dtype and the device: the caller keeps one ``GraphSolve``
    per such key. Built from example tensors of the solve's shapes: the
    steps are warmed up on a side stream (autograd allocates on its first
    run), then three graphs are captured, each in its own memory pool:
    the carry from ``p0``, ``GRAPH_CHUNK`` steps that write the carry
    back in place, and ``finish``. Building synchronizes the device.

    A call copies its inputs into the static buffers and replays the
    graphs: ``ceil(n_iters / GRAPH_CHUNK)`` step replays and no host read, or
    with ``early_exit`` one read of the rows' flags after each replay
    (the plain driver's exit test, once a chunk). It returns clones of
    ``finish``'s outputs, so a later replay leaves them alone. Counters:
    ``replays`` (step graphs), ``host_reads``, ``capture_s``,
    ``pool_bytes`` (device memory the graphs and their buffers hold). A
    failed capture or replay raises."""

    def __init__(self, objective, p0: torch.Tensor, args, lo: float,
                 hi: float, n_iters: int, finish=None):
        if p0.device.type != "cuda":
            raise ValueError(f"GraphSolve needs CUDA tensors, got "
                             f"{p0.device}")
        t0 = time.perf_counter()
        dev = p0.device
        # each capture empties the allocator's cache: empty it first, so
        # the change of the reserved bytes is what the graphs hold
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.n_iters, self.chunk = int(n_iters), GRAPH_CHUNK
        self.n_chunks = max(1, math.ceil(self.n_iters / self.chunk))
        self.replays = self.host_reads = 0
        self.p0 = p0.detach().clone()
        self.args = tuple(a.detach().clone() for a in args)
        etas_t = torch.as_tensor(_LS_ETAS, dtype=p0.dtype, device=dev)

        def fn(z):
            return objective(box_decode(z, lo, hi), *self.args)

        def init():
            return lbfgs_init(fn, box_encode(self.p0, lo, hi))

        def steps(carry):
            for _ in range(self.chunk):
                carry = lbfgs_step(fn, carry, etas_t, _BOXED_TOL,
                                   _PATIENCE, self.n_iters)
            return carry

        def decode(carry):
            p = box_decode(carry.x, lo, hi)
            return (tuple(finish(p, carry.f, *self.args)) if finish
                    else (p, carry.f))

        # every tensor the graphs read (the grid of step sizes, what the
        # objective closes over) lives as long as they do
        self._keep = (init, steps, decode)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                decode(steps(init()))
        torch.cuda.current_stream(dev).wait_stream(side)
        self._g_init = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._g_init):
            self.carry = init()
        self._g_step = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._g_step):
            for dst, src in zip(self.carry, steps(self.carry)):
                dst.copy_(src)
        self._g_finish = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._g_finish):
            self.out = decode(self.carry)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def __call__(self, p0: torch.Tensor, *args, early_exit: bool = False):
        self.p0.copy_(p0)
        for dst, src in zip(self.args, args):
            dst.copy_(src)
        self._g_init.replay()
        for _ in range(self.n_chunks):
            self._g_step.replay()
            self.replays += 1
            if early_exit:
                self.host_reads += 1
                if not bool(self.carry.active.any()):
                    break
        self._g_finish.replay()
        return tuple(t.clone() for t in self.out)

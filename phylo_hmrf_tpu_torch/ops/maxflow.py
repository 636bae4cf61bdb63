"""Exact s-t min-cut on masked 2D grids and the graph-cut move-making
behind the exact polish, PyTorch port.

Counterpart of ``phylo_hmrf_tpu/ops/maxflow_tpu.py``, same names. The min
cut is the data-parallel push-relabel of ``grid_mincut_fused`` with the JAX
schedule: a global relabel (BFS toward the sink, kernel K6) whenever
``it % 32 == 0``, push-relabel iterations (kernel K5) four at a time, the
convergence test once per four iterations, at most ``max_sweeps``
iterations. On a CUDA tensor the whole cut, as each BFS fixpoint, is a
CUDA graph whose loops the card decides (``ops/loops.py``,
``csrc/loops.cu``): no host read inside a move, as the JAX loop is one
device program. Its bodies are K5/K6 in float32, or with ``plain=True``
(the float64 mode: the JAX ``grid_mincut``) the plain versions' tensor
code captured into the same program. ``grid_mincut_host`` keeps the loop
on the host, with a read of the kernels' loop word (or of ``torch.any``
on the plain path) per test: the route of CPU tensors and of
``host_loop=True`` (`loops.route`). Everything else here is plain tensor
code, as it is XLA code in the JAX package: the move graphs (alpha-beta
swap and alpha-expansion, with dominance freezing), the move loop with
GCO-style pruning, and the energies.

Layouts carry a leading region-batch axis, as the JAX batched entry points
do: labels, mask (R, H, W); unary_k (R, K, H, W) K-major; wmaps
(R, 4, H, W); caps (R, 8, H, W) with the directions of ``ALL_DIRS``.
``plain=True`` runs the kernels' plain versions on any device (the
reference the kernel path is checked against on the card, and the model's
float64 mode); otherwise the kernels run exactly when the tensors are on a
CUDA device. Everything keeps the unary's dtype: in float64 the cut
capacities and beta stay float64 (the JAX ``maxflow_tpu`` is
dtype-preserving too), and the energies reduce in the pinned order of
``ops/potts.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from phylo_hmrf_tpu_torch.data.regions import DIRS
from phylo_hmrf_tpu_torch.ops import loops
from phylo_hmrf_tpu_torch.ops.finish_kernels import (
    _f32, energy_from_rows, energy_rows, potts_energy_pair)
from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_kmajor
from phylo_hmrf_tpu_torch.ops.mf_kernels import _shift2, mean_field_kmajor
from phylo_hmrf_tpu_torch.ops.mincut_kernels import (
    ALL_DIRS, EPS, _nb, _rev, bfs_sweeps, bfs_sweeps_plain, pr_iterations,
    pr_iterations_plain)

RELABEL_EVERY = 32     # iterations between global relabels (BFS)


@dataclasses.dataclass
class CutStats:
    """What the min cuts of one labeling pass did; filled when a caller
    passes one in. On the graph route the counts come from the graph's
    counters on the card, read with the pass's cycle reads."""
    moves: int = 0           # grid_mincut calls (one per move, whole batch)
    pr_iterations: int = 0   # push-relabel iterations over all moves
    bfs_sweeps: int = 0      # BFS sweeps (global relabels + source-side BFS)
    capped: int = 0          # moves stopped by max_sweeps with nodes active
    host_reads: int = 0      # reads of device values by the host
    energy_start: float = 0.0   # MRF energy of the start labels and of the
    energy_end: float = 0.0     # labels returned (float64, summed)

    def add_totals(self, t) -> None:
        """Add a graph's counters (``loops.T_*``, host numbers)."""
        self.moves += int(t[loops.T_RUNS])
        self.pr_iterations += int(t[loops.T_PR_ITERS])
        self.bfs_sweeps += int(t[loops.T_BFS_SWEEPS])
        self.capped += int(t[loops.T_CAPPED])


def _read(x, stats):
    """One host read of a device value: a 0-d tensor's item, or a 1-d
    tensor as a list."""
    if stats is not None:
        stats.host_reads += 1
    return x.item() if x.dim() == 0 else x.tolist()


def _on_card(t, plain: bool, host_loop: bool) -> bool:
    """Whether a loop on ``t`` takes a graph route (`loops.route`)."""
    return loops.route(t.device, t.dtype, plain, host_loop) != "host"


def _bfs_fixpoint(d, caps, n: int, plain: bool, stats, spare=None,
                  host_loop: bool = False):
    """Min-plus sweeps from the seed ``d`` until no distance changes, 8 per
    test. On a CUDA tensor (not ``host_loop``) the loop is a CUDA graph
    (K6, or the plain version captured with ``plain``; no host read
    inside it; with ``stats``, one read of its sweep count at the end).
    On the host loop the kernel path runs K6 launches that ping-pong ``d``
    with ``spare`` (a second distance plane, made here when the caller has
    none) and reads their loop word after each. Returns the distances (on
    the host kernel path, in ``d`` or ``spare``)."""
    if _on_card(caps, plain, host_loop):
        if stats is None:
            return loops.run_bfs(d, caps, n, plain=plain)
        g = loops.bfs_graph(d.device, *d.shape, n, caps.dtype, plain)
        base = g.totals.clone()
        out = loops.run_bfs(d, caps, n, plain=plain)
        stats.bfs_sweeps += _read((g.totals - base)[loops.T_BFS_SWEEPS],
                                  stats)
        return out
    if not plain:
        spare = torch.empty_like(d) if spare is None else spare
        loop = loops.new_loop(d.device, n)
    k = 0
    changed = True
    while changed and k < n:
        if plain:
            new = bfs_sweeps_plain(d, caps, n, 8)
            changed = bool(_read(torch.any(new != d), stats))
            d = new
        else:
            new, _ = bfs_sweeps(d, caps, n, n_inner=8, out=spare, loop=loop)
            d, spare = new, d
            changed = bool(_read(loop[loops.LOOP_GO], stats))
        k += 8
    if stats is not None:
        stats.bfs_sweeps += k
    return d


def grid_mincut(excess0, cap_t0, caps0, max_sweeps: int = 3000, *,
                plain: bool = False, host_loop: bool = False,
                stats: CutStats | None = None) -> torch.Tensor:
    """Phase-1 push-relabel min cut of a region batch (the schedule of the
    JAX ``grid_mincut_fused``; regions share the loop until the last one
    converges).

    excess0 (R, H, W): source-arc capacities (pre-saturated); cap_t0
    (R, H, W): sink-arc capacities; caps0 (R, 8, H, W): neighbour-arc
    capacities, 0 on arcs leaving the grid. Returns source_side (R, H, W)
    bool: the pixels that cannot reach the sink in the final residual
    graph (distance >= n = H*W + 2).

    On a CUDA tensor (not ``host_loop``) the cut is one launch of a CUDA
    graph (``ops/loops.py``; K5/K6 in float32, their plain versions
    captured with ``plain``, in the operands' dtype): no host read inside
    it; with ``stats``, one read of the graph's counters at the end (a
    pass of ``_optimize_batched`` reads them with its cycle reads
    instead). Otherwise `grid_mincut_host`."""
    if not _on_card(excess0, plain, host_loop):
        return grid_mincut_host(excess0, cap_t0, caps0, max_sweeps,
                                plain=plain, stats=stats)
    if stats is None:
        return loops.run_cut(excess0, cap_t0, caps0, max_sweeps, plain=plain)
    R, H, W = excess0.shape
    g = loops.cut_graph(excess0.device, R, H, W, excess0.dtype, plain)
    base = g.totals.clone()
    side = loops.run_cut(excess0, cap_t0, caps0, max_sweeps, plain=plain)
    stats.add_totals(_read(g.totals - base, stats))
    return side


def grid_mincut_host(excess0, cap_t0, caps0, max_sweeps: int = 3000, *,
                     plain: bool = False,
                     stats: CutStats | None = None) -> torch.Tensor:
    """`grid_mincut` with its loops on the host: a read per test.

    The kernel path owns two sets of state buffers and a spare distance
    plane for the whole cut: each K5 call reads one set and writes the
    other, each K6 call one plane into the other, and the loop tests read
    the kernels' loop word. The plain path tests with ``torch.any``."""
    R, H, W = excess0.shape
    n = H * W + 2
    dt = excess0.dtype if excess0.is_floating_point() else torch.float32
    state = (excess0.to(dt).clone().contiguous(),
             torch.zeros((R, H, W), dtype=torch.int32, device=excess0.device),
             cap_t0.to(dt).clone().contiguous(),
             caps0.to(dt).clone().contiguous())
    spare = pr_loop = spare_d = None
    if not plain:
        spare = tuple(torch.empty_like(t) for t in state)
        spare_d = torch.empty_like(state[1])
        pr_loop = loops.new_loop(excess0.device)

    def distances(cap_t, caps):
        # the BFS from the sink seed: 1 where the sink arc is residual (a
        # new plane per global relabel, made with kernels the move graphs
        # have loaded already: a first masked_fill_ would load another
        # module of PyTorch's kernels in the middle of the cut)
        seed = torch.where(cap_t > EPS, 1, n).to(torch.int32)
        return _bfs_fixpoint(seed, caps, n, plain, stats, spare=spare_d,
                             host_loop=True)

    e, h = state[:2]
    active = bool(_read(torch.any((e > EPS) & (h < n)), stats))
    it = 0
    while active:
        if it >= max_sweeps:
            if stats is not None:
                stats.capped += 1
            break
        e, h, cap_t, caps = state
        if it % RELABEL_EVERY == 0:
            # heights are lower bounds on the residual distance: the exact
            # BFS distance can only lift them
            torch.maximum(h, distances(cap_t, caps), out=h)
        if plain:
            state = pr_iterations_plain(e, h, cap_t, caps, n, 4)
            active = bool(_read(torch.any((state[0] > EPS)
                                          & (state[1] < n)), stats))
        else:
            state, _ = pr_iterations(e, h, cap_t, caps, n, n_inner=4,
                                     out=spare, loop=pr_loop)
            spare = (e, h, cap_t, caps)
            active = bool(_read(pr_loop[loops.LOOP_GO], stats))
        it += 4
    if stats is not None:
        stats.moves += 1
        stats.pr_iterations += it
    return distances(state[2], state[3]) >= n


def _incident_wsum(wmaps, beta: float) -> torch.Tensor:
    """beta * (sum of the edge weights incident to each pixel): the largest
    pairwise-energy decrease from relabeling that pixel alone. (R, H, W)."""
    s = torch.zeros_like(wmaps[:, 0])
    for d in range(4):
        di, dj = ALL_DIRS[d]
        s = s + wmaps[:, d] + _shift2(wmaps[:, d], -di, -dj, 0.0)
    return beta * s


def _swap_graph(labels, unary_k, wmaps, mask, a: int, b: int, beta: float,
                wsum):
    """Binary min-cut graph of one alpha-beta swap move (source side =
    label a): (excess0, cap_t0, caps0, in_play), each with the batch axis.

    Dominance (persistency) freezing: a pixel whose unary margin for its
    current label strictly beats its total incident pairwise weight keeps
    that label in every optimal move, so it leaves the cut and acts as a
    frozen neighbour. ``wsum`` is `_incident_wsum(wmaps, beta)`, the same
    for every move of a pass."""
    in_play = ((labels == a) | (labels == b)) & mask
    u_a = unary_k[:, a]
    u_b = unary_k[:, b]
    keep_a = (labels == a) & ((u_b - u_a) > wsum)
    keep_b = (labels == b) & ((u_a - u_b) > wsum)
    in_play = in_play & ~keep_a & ~keep_b

    # t-links: c0 = cost(label a), c1 = cost(label b), frozen neighbours
    # (labels not in {a, b}, or dominance-frozen) folded in as unary shifts
    c0 = torch.where(in_play, u_a, 0.0)
    c1 = torch.where(in_play, u_b, 0.0)
    for d in range(4):
        di, dj = ALL_DIRS[d]
        w = wmaps[:, d]
        for s in (1, -1):
            nb_lab = _shift2(labels, s * di, s * dj, -1)
            nb_play = _shift2(in_play, s * di, s * dj, False)
            w_e = w if s == 1 else _shift2(w, -di, -dj, 0.0)
            frozen = (~nb_play) & (nb_lab >= 0)
            add = torch.where(frozen, w_e, 0.0) * beta
            c0 = c0 + torch.where(nb_lab != a, add, 0.0)
            c1 = c1 + torch.where(nb_lab != b, add, 0.0)

    diff = torch.where(in_play, c1 - c0, 0.0)
    excess0 = torch.clamp_min(diff, 0.0)        # S -> p (cut => label b)
    cap_t0 = torch.clamp_min(-diff, 0.0)        # p -> T (cut => label a)

    # pairwise Potts arcs between in-play neighbours: undirected beta * w
    fwd, bwd = [], []
    for d in range(4):
        di, dj = ALL_DIRS[d]
        nb_play = _shift2(in_play, di, dj, False)
        lam = torch.where(in_play & nb_play, wmaps[:, d] * beta, 0.0)
        fwd.append(lam)
        bwd.append(_nb(lam, _rev(d), 0.0))
    caps0 = torch.stack(fwd + bwd, dim=1)
    return excess0, cap_t0, caps0, in_play


def _expansion_graph(labels, unary_k, wmaps, mask, alpha: int, beta: float,
                     wsum):
    """Binary min-cut graph of one alpha-expansion move (source side =
    keep the current label; Kolmogorov-Zabih reduction of the weighted
    Potts move energy, see the JAX ``expansion_move``): (excess0, cap_t0,
    caps0, in_play). Dominance freezing as in `_swap_graph`."""
    is_alpha = mask & (labels == alpha)
    in_play = mask & (labels != alpha)
    u_alpha = unary_k[:, alpha]
    u_cur = torch.gather(unary_k, 1, labels[:, None].long())[:, 0]
    in_play = in_play & ~((u_alpha - u_cur) > wsum)
    # valid pixels out of the cut but not at alpha: their edges become
    # constant shifts
    frozen_cur = mask & (labels != alpha) & ~in_play

    c0 = torch.where(in_play, u_cur, 0.0)     # keep the current label
    c1 = torch.where(in_play, u_alpha, 0.0)   # take alpha
    fwd = []
    for d in range(4):
        di, dj = ALL_DIRS[d]
        lam = wmaps[:, d] * beta                       # edge p -> q
        nb_lab = _shift2(labels, di, dj, -1)
        nb_play = _shift2(in_play, di, dj, False)
        nb_alpha = _shift2(is_alpha, di, dj, False)
        nb_froz = _shift2(frozen_cur, di, dj, False)
        both = in_play & nb_play
        same = nb_lab == labels
        c1 = c1 + torch.where(both & same, lam, 0.0)
        # the q-side unary shift (D - C = -lam) lives at the neighbour
        c1 = c1 - _nb(torch.where(both, lam, 0.0), _rev(d), 0.0)
        fwd.append(torch.where(both, torch.where(same, 2.0 * lam, lam), 0.0))
        # neighbour frozen at alpha: p pays lam iff it keeps
        c0 = c0 + torch.where(in_play & nb_alpha, lam, 0.0)
        # p frozen at alpha with a movable q: q pays lam iff it keeps
        c0 = c0 + _nb(torch.where(is_alpha & nb_play, lam, 0.0), _rev(d), 0.0)
        # neighbour frozen at its own label l_q != alpha: p pays lam if it
        # takes alpha, and lam * [l_p != l_q] if it keeps
        c1 = c1 + torch.where(in_play & nb_froz, lam, 0.0)
        c0 = c0 + torch.where(in_play & nb_froz & ~same, lam, 0.0)
        # p frozen at its label with a movable q (the mirror, at q)
        c1 = c1 + _nb(torch.where(frozen_cur & nb_play, lam, 0.0), _rev(d),
                      0.0)
        c0 = c0 + _nb(torch.where(frozen_cur & nb_play & ~same, lam, 0.0),
                      _rev(d), 0.0)

    diff = torch.where(in_play, c1 - c0, 0.0)
    excess0 = torch.clamp_min(diff, 0.0)        # S -> p (cut => take alpha)
    cap_t0 = torch.clamp_min(-diff, 0.0)        # p -> T (cut => keep)
    # directed arcs p -> q only: the reverse residual arcs start empty
    caps0 = torch.stack(fwd + [torch.zeros_like(fwd[0])] * 4, dim=1)
    return excess0, cap_t0, caps0, in_play


def _swap_move_batch(labels, unary_k, wmaps, mask, a: int, b: int,
                     beta: float, wsum, *, max_sweeps: int,
                     plain: bool = False, host_loop: bool = False,
                     stats: CutStats | None = None):
    """One exact swap move over the region batch (regions share the pair).
    Returns (labels (R, H, W), n_changed (R,) on the device)."""
    excess0, cap_t0, caps0, in_play = _swap_graph(labels, unary_k, wmaps,
                                                  mask, a, b, beta, wsum)
    side = grid_mincut(excess0, cap_t0, caps0, max_sweeps, plain=plain,
                       host_loop=host_loop, stats=stats)
    new = torch.where(side, a, b).to(labels.dtype)
    new = torch.where(in_play, new, labels)
    return new, torch.sum(new != labels, dim=(1, 2))


def _expansion_move_batch(labels, unary_k, wmaps, mask, alpha: int,
                          beta: float, wsum, *, max_sweeps: int,
                          plain: bool = False, host_loop: bool = False,
                          stats: CutStats | None = None):
    """One exact alpha-expansion move over the region batch. Returns
    (labels (R, H, W), n_changed (R,) on the device)."""
    excess0, cap_t0, caps0, in_play = _expansion_graph(
        labels, unary_k, wmaps, mask, alpha, beta, wsum)
    side = grid_mincut(excess0, cap_t0, caps0, max_sweeps, plain=plain,
                       host_loop=host_loop, stats=stats)
    new = torch.where(side, labels, alpha).to(labels.dtype)
    new = torch.where(in_play, new, labels)
    return new, torch.sum(new != labels, dim=(1, 2))


def _energy_hist(labels, unary_k, wmaps, mask, beta: float, n_states: int):
    """Per-region MRF energy (R,) float64 and the label histogram
    (n_states,) over the batch's valid pixels. Float32 terms, summed in
    float64 (float64 terms in the pinned order); invalid edges weigh 0, so
    border fills never contribute."""
    hist = torch.bincount(labels[mask].long(), minlength=n_states)
    if unary_k.dtype == torch.float64:
        return energy_from_rows(energy_rows(unary_k, mask, labels, wmaps),
                                beta), hist
    u_cur = torch.gather(unary_k, 1, labels[:, None].long())[:, 0]
    e = torch.where(mask, u_cur, 0.0).double().sum(dim=(1, 2))
    for d, (di, dj) in enumerate(DIRS):
        diff = (labels != _shift2(labels, di, dj, -1)).to(wmaps.dtype)
        e = e + beta * (wmaps[:, d] * diff).double().sum(dim=(1, 2))
    return e, hist


def _optimize_batched(unary_k, wmaps, mask, init_labels, beta: float,
                      n_states: int, method: str, max_cycles: int,
                      max_sweeps: int = 3000, tol: float = 1e-6, *,
                      plain: bool = False, host_loop: bool = False,
                      stats: CutStats | None = None) -> torch.Tensor:
    """Exact move-making over a batch of same-shape regions (the JAX
    ``_optimize_batched``): cycles of expansion moves (one per label) or
    swap moves (one per pair), with GCO's pruning — a move is skipped when
    none of the labels it depends on changed since it last ran. The host
    reads the device once before the first cycle (the start energy and
    histogram) and once at the end of each cycle (change counts, energy,
    histogram and, on the graph route, the cut counters), as JAX's does:
    on the graph route a move's cut reads nothing. A cycle with no change,
    or an energy drop within ``tol`` (relative), ends the pass."""
    # beta at the unary's precision: the cut capacities see it at float32,
    # or unrounded in float64
    beta = _f32(beta) if unary_k.dtype == torch.float32 else float(beta)
    wsum = _incident_wsum(wmaps, beta)
    labels = torch.where(mask, init_labels, 0).to(torch.int32)
    graph = base = None
    if _on_card(unary_k, plain, host_loop):
        # the moves' cuts add to this graph's counters; the cycle reads
        # take them with the labels' numbers
        graph = loops.cut_graph(unary_k.device, *labels.shape,
                                unary_k.dtype, plain)
        base = graph.totals.clone()
    e, hist_t = _energy_hist(labels, unary_k, wmaps, mask, beta, n_states)
    got = _read(torch.cat([e.sum().view(1), hist_t.double()]), stats)
    e_start = prev_e = e_now = got[0]
    hist = [int(v) for v in got[1:]]

    if method == "expansion":
        moves = [(a,) for a in range(n_states)]
    else:
        moves = [(a, b) for a in range(n_states)
                 for b in range(a + 1, n_states)]
    kw = dict(max_sweeps=max_sweeps, plain=plain, host_loop=host_loop,
              stats=None if graph is not None else stats)

    last_run = {}        # move -> move counter at its last run
    changed_actual = {}  # label (or "any") -> counter of its last change
    totals = None        # the graph's counters at the last cycle read
    t = 0
    for _ in range(max_cycles):
        maybe = [v > 0 for v in hist]
        changed_opt = dict(changed_actual)
        pending = []     # (move, counter, n_changed (R,) on the device)
        for mv in moves:
            lr = last_run.get(mv)
            if method == "expansion":
                if lr is not None and changed_opt.get("any", -1) <= lr:
                    continue
                labels, nch = _expansion_move_batch(
                    labels, unary_k, wmaps, mask, mv[0], beta, wsum, **kw)
                changed_opt["any"] = t
            else:
                a, b = mv
                # skippable while both labels are provably empty; a run
                # may repopulate either, so both are marked
                if not (maybe[a] or maybe[b]):
                    continue
                if lr is not None and changed_opt.get(a, -1) <= lr \
                        and changed_opt.get(b, -1) <= lr:
                    continue
                labels, nch = _swap_move_batch(
                    labels, unary_k, wmaps, mask, a, b, beta, wsum, **kw)
                changed_opt[a] = changed_opt[b] = t
                maybe[a] = maybe[b] = True
            last_run[mv] = t
            pending.append((mv, t, nch))
            t += 1
        if not pending:
            break

        # one host read per cycle: energy, histogram, change counts (and
        # the cut counters), as one float64 vector (every count is exact)
        e, hist_t = _energy_hist(labels, unary_k, wmaps, mask, beta,
                                 n_states)
        parts = [e.sum().view(1), hist_t.double(),
                 torch.stack([p[2] for p in pending]).double().flatten()]
        if graph is not None:
            parts.append((graph.totals - base).double())
        got = _read(torch.cat(parts), stats)
        e_now = got[0]
        hist = [int(v) for v in got[1:1 + n_states]]
        R = labels.shape[0]
        nch_all = got[1 + n_states:1 + n_states + R * len(pending)]
        if graph is not None:
            totals = got[1 + n_states + R * len(pending):]
        total_changed = 0
        for i, (mv, tt, _) in enumerate(pending):
            n_tot = int(sum(nch_all[i * R:(i + 1) * R]))
            total_changed += n_tot
            if n_tot > 0:
                for lab in (mv if method != "expansion" else ("any",)):
                    changed_actual[lab] = max(changed_actual.get(lab, -1), tt)
        if total_changed == 0:
            break
        if prev_e - e_now <= tol * max(1.0, abs(prev_e)):
            break
        prev_e = e_now
    if stats is not None:
        if totals is not None:
            stats.add_totals(totals)
        stats.energy_start += e_start
        stats.energy_end += e_now
    return labels


def _icm_pick(unary_k, wmaps, mask, proposal, warm, beta: float,
              icm_max_sweeps: int, *, plain: bool = False) -> torch.Tensor:
    """Checkerboard ICM (K2) from ``proposal`` and from ``warm``; the
    lower Potts energy (K3, both labelings in one call) wins per region."""
    cand_a = icm_kmajor(unary_k, wmaps, mask, proposal, beta, icm_max_sweeps,
                        plain=plain)
    cand_b = icm_kmajor(unary_k, wmaps, mask, warm, beta, icm_max_sweeps,
                        plain=plain)
    e_a, e_b = potts_energy_pair(unary_k, mask.to(torch.int32), cand_a,
                                 cand_b, wmaps, beta, plain=plain)
    return torch.where((e_a <= e_b)[:, None, None], cand_a, cand_b)


def _start_batch(unary_k, wmaps, mask, warm, beta: float,
                 icm_max_sweeps: int, *, plain: bool = False) -> torch.Tensor:
    """Labeling start (the JAX ``_start_batch_pallas``): annealed mean
    field (K1) proposes, checkerboard ICM (K2) polishes both the proposal
    and the warm labels, the lower Potts energy (K3) wins per region."""
    mf = mean_field_kmajor(unary_k, wmaps, beta, plain=plain)
    return _icm_pick(unary_k, wmaps, mask, mf, warm, beta, icm_max_sweeps,
                     plain=plain)


def exact_labels_batched(unary_k, wmaps, mask, warm, beta: float,
                         n_states: int, max_cycles: int = 2,
                         icm_max_sweeps: int = 60, method: str = "swap",
                         max_sweeps: int = 3000, tol: float = 1e-6, *,
                         plain: bool = False,
                         stats: CutStats | None = None) -> torch.Tensor:
    """Full-quality labeling of a batch of same-shape regions: mean field
    + ICM proposes, exact graph-cut move-making finishes (``method``
    "swap", the reference E-step's move family, or "expansion"). unary_k
    is K-major (R, K, H, W). Returns labels (R, H, W) int32."""
    start = _start_batch(unary_k, wmaps, mask, warm, beta, icm_max_sweeps,
                         plain=plain)
    return _optimize_batched(unary_k, wmaps, mask, start, beta, n_states,
                             method, max_cycles, max_sweeps, tol,
                             plain=plain, stats=stats)


def exact_labels(unary, wmaps, mask, warm, beta: float, n_states: int,
                 max_cycles: int = 2, icm_max_sweeps: int = 60,
                 method: str = "swap", *, plain: bool = False,
                 stats: CutStats | None = None) -> torch.Tensor:
    """`exact_labels_batched` of one region with a state-minor (H, W, K)
    unary, run as a batch of one: the region gets its own move schedule
    and stopping test. Returns labels (H, W) int32."""
    return exact_labels_batched(
        unary.permute(2, 0, 1)[None].contiguous(), wmaps[None], mask[None],
        warm[None], beta, n_states, max_cycles, icm_max_sweeps, method,
        plain=plain, stats=stats)[0]


def swap_optimize(unary, wmaps, mask, init_labels, beta: float,
                  n_states: int, max_cycles: int = 10,
                  max_sweeps: int = 3000, tol: float = 1e-6, *,
                  plain: bool = False,
                  stats: CutStats | None = None) -> torch.Tensor:
    """Exact alpha-beta swap moves from ``init_labels`` on one region with
    a state-minor (H, W, K) unary (see `_optimize_batched`)."""
    return _optimize_batched(
        unary.permute(2, 0, 1)[None].contiguous(), wmaps[None], mask[None],
        init_labels[None], beta, n_states, "swap", max_cycles, max_sweeps,
        tol, plain=plain, stats=stats)[0]


def expansion_optimize(unary, wmaps, mask, init_labels, beta: float,
                       n_states: int, max_cycles: int = 10,
                       max_sweeps: int = 3000, tol: float = 1e-6, *,
                       plain: bool = False,
                       stats: CutStats | None = None) -> torch.Tensor:
    """Exact alpha-expansion moves from ``init_labels`` on one region with
    a state-minor (H, W, K) unary (see `_optimize_batched`)."""
    return _optimize_batched(
        unary.permute(2, 0, 1)[None].contiguous(), wmaps[None], mask[None],
        init_labels[None], beta, n_states, "expansion", max_cycles,
        max_sweeps, tol, plain=plain, stats=stats)[0]

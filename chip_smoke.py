#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

The kernels' unit tests are ``tests/test_torch_cuda.py``,
``tests/test_torch_lbfgs_kernel.py`` and ``tests/test_torch_moves_kernel.py``
(``python -m pytest <files> -q --noconftest`` on the GPU machine), and
the benchmark (``BENCHMARK.json``, ``bench_port/``) profiles whole fits.
This script holds what neither does, in this order, one line a phase:

- ``[build]``, ``[ptxas]``: the nvcc build of ``phylo_hmrf_tpu_torch/csrc``
  and each kernel's registers, shared memory and spills.
- The kernel table: K1-K8, L, M1, M2 and KM each timed alone at the
  shapes of the fits (K1-K4 at chr21: R=1, K=10, H=672, W=768, F=4, and
  at K=30;
  K5/K6 on the chr21 expansion move with the most pixels in play; K7/K8
  on the spatial fit's 4 x 6 x 768 off-diagonal shards and on 4 816-row
  shards of a 10 kb region; K3/K4 at 10 kb; L on the ``[pipeline]`` fit's
  first M-step solve; M1/M2 on the first swap move of a ``swap_tpu``
  fit; KM on the chr21 samples, 213,531 x 4): device ms of one unit
  (launches queued behind a sleep), call ms, the plain version's ms, max
  abs error against it, the least time of the unit's bytes and
  operations (``bench_port/roofline.py``), launches per unit and units
  per fit. K5/K6 also hold their loop word against
  the plain result and a stopped launch passing its input through; L
  holds 5 float64 steps of the M-step and init solves within 1e-9 of the
  plain driver and their whole float32 and float64 solves by loss
  against its one-ulp twins; M1 is bitwise ``_swap_graph`` /
  ``_expansion_graph`` for every pair and expansion of that move set.
- ``[kmeans]``: KM1's k-means++ picks bitwise the plain seeding's from
  the same draws, and a whole ``kmeans`` call on the kernel route with
  the plain version's centers and labels.
- ``[mincut]``, ``[estep]``: the whole min cut and the chr21 E-step on
  the kernel route against the plain route, on the kernel table's
  operands: the same cut and work; labels, statistics and costs within
  the E-step's gates.
- ``[bucket]``: a kernel E-step of two chr21 regions bitwise each
  region's own, what the multi-process parity rests on.
- ``[oracle]`` (K=10 on chr21, K=20 on a 223 x 223 region),
  ``[host_swap]``, ``[f64_oracle]``: the card's expansion polish and
  ``swap_tpu`` E-step against the C++ expansion and swap of
  ``phylo_hmrf_tpu_torch.native``, energy within 0.1%.
- ``[fit]``: the default-config chr21 fit (5 iterations): K1-K6 and L
  launched, its init's k-means one KM1 and one KM2/KM3 launch, ``cost1
  == pairwise + unary``, the ``.mat`` round trip, the polish lowering the
  energy; its SHA-256 digests.
- ``[postprocess]``: smoothing, state files, the PNG and the comparisons
  on the ``[fit]`` output.
- ``[pipeline]``: the same fit with ``em_pipeline`` True and False, both
  bitwise ``[fit]``'s digests; ``mstep_dispatch`` and ``estep(...,
  defer=True)`` under ``torch.cuda.set_sync_debug_mode("error")``.
- ``[labelers]``: a chr21 fit with every other labeler from the
  ``[fit]`` init state: cost rows, E-step walls, launches, exact moves.
- ``[f64]``: the float64 fit: no K1-K8 launch, the unary at the JAX gate,
  one E-step bitwise repeatable and bitwise over 4 spatial shards.
- ``[cli]``/``[resume]``: the command line at chr21 scale and its resumed
  rerun, bitwise. ``[multiproc]``: the chr21+chr22 command line as one
  process and as two sharing the card, the merged ``.mat`` equal.
- ``[mesh]``, ``[split]``, ``[spatial_estep]``, ``[region_estep]``,
  ``[mesh_exact]``, ``[spatial_fit]``, ``[xmesh]``: 4 shards on the card.
  The split identities of K7/K8 and K1/K2 on the 10 kb grid; the 10 kb
  spatial E-step against the single-device one and its device busy time;
  the region-sharded E-step of 4 chr21 regions; a region-mode
  ``swap_tpu`` E-step equal to each region's own; a 3-iteration spatial
  fit launching all eight kernels; that E-step and fit again over a mesh
  whose shards live in two processes (``--xmesh-rank``), every digest
  the one-process mesh's.
- ``[launch_counts]``: K3 (both entries), K4, K7 and K8 are one kernel
  launch a call, counted by ``torch.profiler`` in a fresh process
  (``--count-launches``).

Every phase that fails raises. The second-to-last line of stdout is the
kernel table as JSON (``{"kernels": [...]}``); the last is ``{"ok": true,
"device": {...}}``. Without CUDA it exits 1 before any of that.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "K1_mf_sweep": ("phylo_hmrf_tpu_torch/csrc/mf.cu",
                    "phylo_hmrf_tpu/ops/mf_pallas.py:118"),
    "K2_icm_phase": ("phylo_hmrf_tpu_torch/csrc/icm.cu",
                     "phylo_hmrf_tpu/ops/icm_pallas.py:79"),
    "K3_potts_energy": ("phylo_hmrf_tpu_torch/csrc/finish.cu",
                        "phylo_hmrf_tpu/ops/finish_pallas.py:152"),
    "K4_finish_stats": ("phylo_hmrf_tpu_torch/csrc/finish.cu",
                        "phylo_hmrf_tpu/ops/finish_pallas.py:45"),
    "K5_pr_iterations": ("phylo_hmrf_tpu_torch/csrc/mincut.cu",
                         "phylo_hmrf_tpu/ops/mincut_pallas.py:89"),
    "K6_bfs_sweeps": ("phylo_hmrf_tpu_torch/csrc/mincut.cu",
                      "phylo_hmrf_tpu/ops/mincut_pallas.py:46"),
    "K7_mf_sweeps_halo": ("phylo_hmrf_tpu_torch/csrc/mf.cu",
                         "phylo_hmrf_tpu/ops/mf_pallas.py:67"),
    "K8_icm_sweep_halo": ("phylo_hmrf_tpu_torch/csrc/icm.cu",
                          "phylo_hmrf_tpu/ops/icm_pallas.py:26"),
    # the M-step's and the init's L-BFGS solve; no TPU kernel: the JAX
    # package's solve is a vmapped while_loop that XLA compiles
    "L_lbfgs_ou": ("phylo_hmrf_tpu_torch/csrc/lbfgs.cu",
                   "none (phylo_hmrf_tpu/ops/lbfgs.py:141)"),
    # an exact move's cut graph and its labels; no TPU kernel: the JAX
    # package's move graphs are XLA code inside its move loop
    "M1_move_build": ("phylo_hmrf_tpu_torch/csrc/moves.cu",
                      "none (phylo_hmrf_tpu/ops/maxflow_tpu.py:273, :357)"),
    "M2_move_apply": ("phylo_hmrf_tpu_torch/csrc/moves.cu",
                      "none (phylo_hmrf_tpu/ops/maxflow_tpu.py:471, :495)"),
    # the init's k-means: KM1 and KM2/KM3, a launch each; no TPU kernel:
    # the JAX package's k-means is a vmapped program that XLA compiles
    "KM_kmeans": ("phylo_hmrf_tpu_torch/csrc/kmeans.cu",
                  "none (phylo_hmrf_tpu/ops/kmeans.py:73)"),
}

SHARDS = 4   # shards of the multi-device phases


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _time_ms(fn, reps=5, queued=False):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up.
    ``queued``: the card first sleeps ~1 ms, so the host has queued the
    start event, ``fn``'s launches and the end event before the start
    event runs: the window holds the device time of the launches alone,
    not the wrapper's host work before them."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _timed(fn, plain_fn, chained_fn=None):
    """The timings of a kernel row: ``ms`` the device time of one unit
    (queued launches), ``call_ms`` one call with its host work in the
    window, ``plain_ms`` the plain version's call; with ``chained_fn``,
    ``chained_ms`` the device time of the same unit on the per-shard
    route (K7, K8's route before their one-launch kernels), queued like
    ``ms``."""
    out = dict(ms=_time_ms(fn, queued=True), call_ms=_time_ms(fn),
               plain_ms=_time_ms(plain_fn))
    if chained_fn is not None:
        out["chained_ms"] = _time_ms(chained_fn, queued=True)
    return out


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes, ops):
    """(bound_ms, bound_by): the least time of ``nbytes`` and ``ops`` on
    the card (``bench_port/roofline.py``'s peaks) and which of the two
    sets it."""
    from bench_port import roofline

    by_bytes = nbytes / roofline.PEAK_BYTES_S >= ops / roofline.PEAK_F32_OPS_S
    return (roofline.least_s(nbytes, ops) * 1e3,
            "bytes" if by_bytes else "operations")


def _point_line(tag, k):
    """One kernel row as a line: error, device / call / chained / K3's
    pair / plain ms, the bound and the share of it."""
    chained = (f"chained={k['chained_ms']:.4f}ms " if "chained_ms" in k
               else "")
    pair = (f"pair={k['pair_ms']:.4f}ms (bound "
            f"{k['pair_bound_ms'] * 1e3:.1f}us, "
            f"{100 * k['pair_share_of_bound']:.1f}% of it) "
            if "pair_ms" in k else "")
    return (f"[{tag}] max_abs_err={k['max_abs_err']:.3g} "
            f"kernel={k['ms']:.4f}ms call={k['call_ms']:.4f}ms {chained}"
            f"{pair}"
            f"plain={k['plain_ms']:.3f}ms "
            f"bound={k['bound_ms'] * 1e3:.1f}us ({k['bound_by']}, "
            f"{100 * k['share_of_bound']:.1f}% of it) ({k['unit']})")


def _with_bound(k):
    """A kernel record with its bound and the kernel's share of it."""
    bound_ms, bound_by = _bound(k["nbytes"], k["ops"])
    return dict(k, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / k["ms"])


# operations per unit of work, counted from the kernels' arithmetic: one
# mean-field sweep per state and pixel (8 products and adds of the
# agreement, the field, the tempered softmax, the damping); one ICM phase
# per state and active pixel (8 selects and adds, the score, the compare);
# the energy per pixel; K4 per state and pixel (the pairwise agreement,
# two softmaxes, the F + F^2 statistics products and adds); one
# push-relabel iteration and one BFS sweep per pixel (8 arcs each)
OPS_MF, OPS_ICM, OPS_ENERGY, OPS_PR, OPS_BFS = 27, 19, 24, 48, 24


def _ops_finish(K, F):
    return K * (16 + 10 + 2 * (F + F * F))


def check_k1(x, beta=1.0):
    """K1 (the tile kernel) on the operands ``x``: one temperature's 8
    sweeps within rtol 2e-4, atol 1e-6 of the plain version; the row of
    that unit, timed beside the plain version."""
    import torch

    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        mf_sweeps, mf_sweeps_plain, mf_tile_plan)

    R, K, H, W = x["q0"].shape
    k1 = (x["q0"], x["base"], x["w"], 1.0, 0.5, beta)
    got = mf_sweeps(*k1, n_inner=8)
    want = mf_sweeps_plain(*k1, 8)
    torch.cuda.synchronize()
    _check(torch.allclose(got, want, rtol=2e-4, atol=1e-6),
           f"K1 disagrees: max abs err {_max_abs(got, want)}")
    plan = mf_tile_plan(K, 8)
    return dict(
        max_abs_err=_max_abs(got, want),
        **_timed(lambda: mf_sweeps(*k1, n_inner=8),
                 lambda: mf_sweeps_plain(*k1, 8)),
        unit="8 sweeps at one temperature",
        launches_per_unit=plan.launches, plan=plan._asdict(),
        tolerance="rtol 2e-4, atol 1e-6 against plain",
        nbytes=_nbytes(x["q0"], x["base"], x["w"], x["q0"]),
        ops=8 * OPS_MF * K * R * H * W)


def check_k2(x, beta=1.0):
    """K2 (the tile kernel) on the operands ``x``: one sweep pair, labels
    identical to the plain version's; the row of that pair, timed beside
    the plain version."""
    import torch

    from phylo_hmrf_tpu_torch.ops.icm_kernels import (icm_sweep_pair,
                                                      icm_tile_plan)

    R, K, H, W = x["unary_k"].shape
    lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32).contiguous()
    k2 = (lab0, x["unary_k"], x["w"], x["mask_i"], beta)
    got = icm_sweep_pair(*k2)
    ref = icm_sweep_pair(*k2, plain=True)
    _check(torch.equal(got, ref),
           f"K2 sweep pair: {int((got != ref).sum())} labels differ from "
           "the plain version")
    return dict(max_abs_err=_max_abs(got, ref),
                **_timed(lambda: icm_sweep_pair(*k2),
                         lambda: icm_sweep_pair(*k2, plain=True)),
                unit="one sweep pair (8 phases)", launches_per_unit=1,
                plan=icm_tile_plan(K)._asdict(),
                tolerance="identical labels (plain)",
                nbytes=_nbytes(lab0, x["unary_k"], x["w"], x["mask_i"],
                               lab0),
                ops=2 * OPS_ICM * K * R * H * W)


def k30_inputs(dev):
    """The K1/K2 operands of the chr21 region at K = 30 (seed 0), the top
    of the K users run."""
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    _, region, means, covs, warm, _ = chr21_problem(0, K=30)
    return kernel_inputs(region, means, covs, warm, dev)


def check_kernels(x, beta=1.0):
    """The rows of K1-K4 on the same device tensors: {kernel: row}. K3
    scores the warm labels and K1's mean-field labels."""
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mean_field_kmajor

    lab = mean_field_kmajor(x["unary_k"], x["w"], beta)
    return {"K1_mf_sweep": check_k1(x, beta),
            "K2_icm_phase": check_k2(x, beta),
            "K3_potts_energy": check_k3(x, lab, beta),
            "K4_finish_stats": check_k4(x, beta)}


def launch_counts(attempts=3):
    """K3's and K4's kernel launches in one call (one labeling, the pair,
    K4) on the chr21, K=30 and 10 kb operands, and K7's and K8's in one
    unit on the spatial fit's off-diagonal block (8 sweeps, a sweep) and
    the 10 kb shards (a sweep, a phase), counted by
    ``torch.profiler`` in a fresh process (this script with
    ``--count-launches``). In this run's process they cannot be: once a
    process has launched many kernels outside a profiler session, a
    session of one short kernel mostly records no device event
    (``tools/profiler_probe.py``). A fresh process can go blind too: a
    run whose profiler recorded no device event is repeated in another
    fresh process, at most ``attempts`` runs in all; any other failure,
    or a blind last run, fails. {point: {entry: [launches, names]},
    "blind_runs": n}."""
    for attempt in range(attempts):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--count-launches"], capture_output=True,
                             text=True, cwd=REPO)
        blind = "recorded no device event" in res.stderr
        if res.returncode == 0 or not blind or attempt == attempts - 1:
            break
        print(f"[launch_counts] run {attempt + 1}: the profiler recorded "
              f"no device event; again in a fresh process")
    _check(res.returncode == 0, "the launch count failed:\n"
           f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["blind_runs"] = attempt
    return out


def count_launches_main() -> int:
    """The body of ``--count-launches``: prints `launch_counts`' JSON."""
    import torch

    from phylo_hmrf_tpu_torch.config import SMALL_EPS
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (
        finish_stats, potts_energy, potts_energy_pair)
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mean_field_kmajor
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    if not torch.cuda.is_available():
        return 1
    dev = torch.device("cuda")
    out = {}
    for point, kw in (("chr21", {}), ("k30", dict(K=30)),
                      ("10kb", dict(h0=3264))):
        _, region, means, covs, warm, _ = chr21_problem(0, **kw)
        x = kernel_inputs(region, means, covs, warm, dev)
        other = mean_field_kmajor(x["unary_k"], x["w"], 1.0)
        k3 = (x["unary_k"], x["mask_i"], x["warm"], x["w"], 1.0)
        k4 = (x["unary_k"], x["img_f"], x["mask_i"], x["warm"], x["w"], 1.0,
              SMALL_EPS)
        fns = {"K3": lambda: potts_energy(*k3),
               "K3_pair": lambda: potts_energy_pair(
                   x["unary_k"], x["mask_i"], x["warm"], other, x["w"],
                   1.0),
               "K4": lambda: finish_stats(*k4, negate=True)}
        if point == "10kb":
            fns.update(_halo_units(x, n_sweeps=1, n_phases=1))
        for fn in fns.values():     # the tickets and the allocator warm
            fn()
        out[point] = {name: list(_kernel_launches(fn))
                      for name, fn in fns.items()}
        del x, other
    _, off, mo, co, wo, _ = offdiag_block()
    fns = _halo_units(kernel_inputs(off, mo, co, wo, dev), n_sweeps=8,
                      n_phases=4)
    for fn in fns.values():
        fn()
    out["offdiag"] = {name: list(_kernel_launches(fn))
                      for name, fn in fns.items()}
    print(json.dumps(out))
    return 0


def _halo_units(x, n_sweeps, n_phases, n_shards=4):
    """One unit of K7 and of K8 over ``n_shards`` shards of ``x`` on one
    device, as calls: {"K7": fn, "K8": fn}."""
    import torch

    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_sweep_halo_
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mf_sweeps_halo

    sh = _halo_shards(x, n_shards)
    dev = x["q0"].device
    lab = [t.clone() for t in sh["lab0"]]
    changed = {dev: torch.zeros((), dtype=torch.int32, device=dev)}
    return {"K7": lambda: mf_sweeps_halo(
                sh["q0"], sh["base"], sh["w_ext"], 1.0, 0.5, 1.0,
                n_sweeps=n_sweeps, sources=sh["local"]),
            "K8": lambda: icm_sweep_halo_(
                lab, sh["unary_k"], sh["w_ext"], sh["mask_i"], 1.0, changed,
                row0=sh["row0"], sources=sh["local"], n_phases=n_phases)}


def _kernel_launches(fn):
    """Kernel launches of one run of ``fn`` as ``torch.profiler`` sees
    them (device events that are not memory copies or sets), and their
    names."""
    _, _, by_name = _device_busy_s(fn)
    kernels = {k: v[1] for k, v in by_name.items()
               if not k.startswith(("Memcpy", "Memset"))}
    return sum(kernels.values()), sorted(kernels)


def _k3_nbytes(x, *labelings):
    """The bytes K3 must move on ``x`` for the given labelings: the mask
    and the weights once, each labeling once, one unary value a valid
    pixel and labeling (at its state: the kernel reads no other), the
    energies."""
    R, K = x["unary_k"].shape[:2]
    valid = x["mask_i"] != 0
    unary = sum(int((valid & (lab >= 0) & (lab < K)).sum())
                for lab in labelings)
    return (_nbytes(x["mask_i"], x["w"], *labelings)
            + x["unary_k"].element_size() * unary + 4 * R * len(labelings))


def check_k3(x, other, beta=1.0):
    """K3 on the operands ``x``: the warm labels within rtol 1e-6 of the
    plain version (both sum float32 terms in float64). The row of one
    call, with the times and bound of the pair entry (the warm labels and
    ``other``) beside it; its launches a call are counted by
    `launch_counts`."""
    import torch

    from phylo_hmrf_tpu_torch.ops.finish_kernels import (
        potts_energy, potts_energy_pair, potts_energy_pair_plain,
        potts_energy_plain)

    R, K, H, W = x["unary_k"].shape
    k3 = (x["unary_k"], x["mask_i"], x["warm"], x["w"], beta)
    pair = (x["unary_k"], x["mask_i"], x["warm"], other, x["w"], beta)
    got = potts_energy(*k3)
    want = potts_energy_plain(*k3)
    _check(torch.allclose(got, want, rtol=1e-6, atol=0),
           f"K3 disagrees: {got.tolist()} vs {want.tolist()}")
    t_pair = _timed(lambda: potts_energy_pair(*pair),
                    lambda: potts_energy_pair_plain(*pair))
    pair_bound, _ = _bound(_k3_nbytes(x, x["warm"], other),
                           2 * OPS_ENERGY * R * H * W)
    return dict(
        max_abs_err=_max_abs(got, want),
        **_timed(lambda: potts_energy(*k3), lambda: potts_energy_plain(*k3)),
        pair_ms=t_pair["ms"], pair_call_ms=t_pair["call_ms"],
        pair_plain_ms=t_pair["plain_ms"], pair_bound_ms=pair_bound,
        pair_share_of_bound=pair_bound / t_pair["ms"],
        unit="one call", tolerance="rtol 1e-6",
        nbytes=_k3_nbytes(x, x["warm"]), ops=OPS_ENERGY * R * H * W)


def check_k4(x, beta=1.0):
    """K4 on the operands ``x`` (the unary in, ``negate``): within rtol
    2e-5, atol 1e-6 of the plain version on every output. The row of one
    call (its launches a call are counted by `launch_counts`); its bound
    counts what the valid pixels need (the kernel skips 32-pixel batches
    with none): the mask, then a valid pixel's K fields, F features,
    label and 4 weights, and the outputs."""
    import torch

    from phylo_hmrf_tpu_torch.config import SMALL_EPS
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (finish_stats,
                                                         finish_stats_plain)

    R, K, H, W = x["unary_k"].shape
    k4 = (x["unary_k"], x["img_f"], x["mask_i"], x["warm"], x["w"], beta,
          SMALL_EPS)
    got = finish_stats(*k4, negate=True)
    want = finish_stats_plain(*k4, negate=True)
    for a, b in zip(got, want):
        _check(torch.allclose(a, b, rtol=2e-5, atol=1e-6),
               f"K4 disagrees: max abs err {_max_abs(a, b)}")
    F = x["img_f"].shape[1]
    valid = int((x["mask_i"] != 0).sum())
    return dict(
        max_abs_err=max(_max_abs(a, b) for a, b in zip(got, want)),
        **_timed(lambda: finish_stats(*k4, negate=True),
                 lambda: finish_stats_plain(*k4, negate=True)),
        unit="one call", tolerance="rtol 2e-5, atol 1e-6",
        valid_pixels=valid,
        nbytes=(_nbytes(x["mask_i"], *got) + 4 * valid * (K + F + 1 + 4)),
        ops=_ops_finish(K, F) * valid)


def _loop_ms(fn, device):
    """The device time of one unit launched as a step of a loop (its loop
    word updated by the last block), queued as ``ms`` is; the word must
    still say the loop goes on after the timing (no launch passed its
    input through)."""
    from phylo_hmrf_tpu_torch.ops.loops import LOOP_GO, new_loop

    word = new_loop(device)
    ms = _time_ms(lambda: fn(word), queued=True)
    _check(bool(word[LOOP_GO]), "a timed loop step found its loop stopped")
    return ms


def check_mincut(x, n_states, beta=1.0):
    """The rows of K5 and K6 on the graph of the chr21 expansion move with
    the most pixels in play (from the K1-K3 start), each against its
    plain version: bitwise, the loop word's GO that of the plain result,
    a launch of a stopped loop passing its input through; then the whole
    min cut on the kernel route against the plain one: the same cut and
    the same work. Returns ({kernel: row}, cut record, start labels)."""
    import dataclasses

    import torch

    from phylo_hmrf_tpu_torch.ops import maxflow as mf
    from phylo_hmrf_tpu_torch.ops.loops import LOOP_GO, new_loop
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (
        EPS, bfs_sweeps, bfs_sweeps_plain, pr_iterations,
        pr_iterations_plain)

    start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"], beta,
                            60)
    wsum = mf._incident_wsum(x["w"], beta)
    in_play = [int(mf._expansion_graph(start, x["unary_k"], x["w"],
                                       x["mask"], a, beta, wsum)[3].sum())
               for a in range(n_states)]
    alpha = max(range(n_states), key=in_play.__getitem__)
    excess0, cap_t0, caps0, _ = mf._expansion_graph(
        start, x["unary_k"], x["w"], x["mask"], alpha, beta, wsum)
    R, H, W = excess0.shape
    n = H * W + 2
    d0 = torch.where(cap_t0 > EPS, 1, n).to(torch.int32).contiguous()
    move = f"expansion move {alpha}, {in_play[alpha]} pixels in play"
    out = {}

    # K6: 8 Jacobi sweeps in one launch from the sink seed
    loop = new_loop(d0.device)
    d8, _ = bfs_sweeps(d0, caps0, n, n_inner=8, loop=loop)
    want = bfs_sweeps_plain(d0, caps0, n, 8)
    _check(torch.equal(d8, want), "K6: 8 sweeps differ from the plain version")
    _check(bool(loop[LOOP_GO]) == bool(torch.any(want != d0)),
           "K6: the loop word differs from the plain result's")
    loop[LOOP_GO] = 0
    _check(torch.equal(bfs_sweeps(d0, caps0, n, n_inner=8, loop=loop)[0], d0),
           "K6: a stopped launch changed the distances")
    fix = mf._bfs_fixpoint(d0.clone(), caps0, n, False, None)
    out["K6_bfs_sweeps"] = dict(
        max_abs_err=float((d8 - want).abs().max()),
        **_timed(lambda: bfs_sweeps(d0, caps0, n, n_inner=8, out=d8),
                 lambda: bfs_sweeps_plain(d0, caps0, n, 8)),
        loop_ms=_loop_ms(lambda w: bfs_sweeps(d0, caps0, n, n_inner=8,
                                              out=d8, loop=w), d0.device),
        unit=f"8 BFS sweeps ({move})", launches_per_unit=1,
        tolerance="identical int32 distances",
        reachable=int((fix < n).sum()),
        nbytes=_nbytes(d0, caps0, d0), ops=8 * OPS_BFS * R * H * W)

    # K5: 4 iterations in one launch, three calls in a row from the
    # relabelled state (h = BFS distance), each with the plain result's
    # active flag; timed from where they end
    st = want = (excess0, fix, cap_t0, caps0)
    for call in (1, 2, 3):
        loop = new_loop(d0.device)
        st, _ = pr_iterations(*st, n, n_inner=4, loop=loop)
        want = pr_iterations_plain(*want, n, 4)
        _check(all(torch.equal(a, b) for a, b in zip(st, want)),
               f"K5 call {call}: 4 iterations differ from the plain version")
        _check(bool(loop[LOOP_GO]) == bool(torch.any((want[0] > EPS)
                                                     & (want[1] < n))),
               "K5: the loop word differs from the plain result's")
    loop[LOOP_GO] = 0
    _check(all(torch.equal(a, b) for a, b in zip(
        pr_iterations(*st, n, n_inner=4, loop=loop)[0], st)),
           "K5: a stopped launch changed the state")
    spare = tuple(torch.empty_like(t) for t in st)
    out["K5_pr_iterations"] = dict(
        max_abs_err=max(_max_abs(a, b) for a, b in zip(st, want)),
        **_timed(lambda: pr_iterations(*st, n, n_inner=4, out=spare),
                 lambda: pr_iterations_plain(excess0, fix, cap_t0, caps0, n,
                                             4)),
        loop_ms=_loop_ms(lambda w: pr_iterations(*st, n, n_inner=4,
                                                 out=spare, loop=w),
                         d0.device),
        unit=f"4 push-relabel iterations ({move})", launches_per_unit=1,
        tolerance="bitwise e, h, cap_t, caps",
        nbytes=2 * _nbytes(excess0, fix, cap_t0, caps0),
        ops=4 * OPS_PR * R * H * W)

    # the whole min cut: the loop graphs of the kernels against the plain
    # units (K5/K6 bitwise, the same schedule), each reading the host once
    runs = {}
    for name, plain in (("kernel", False), ("plain", True)):
        stats = mf.CutStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side = mf.grid_mincut(excess0, cap_t0, caps0, stats=stats,
                              plain=plain)
        torch.cuda.synchronize()
        runs[name] = (side, time.perf_counter() - t0, stats)
    (side, kernel_s, stats), (side_p, plain_s, stats_p) = runs.values()
    _check(torch.equal(side, side_p),
           "min cut: the kernel route's cut differs from the plain one")
    _check(dataclasses.replace(stats, host_reads=0)
           == dataclasses.replace(stats_p, host_reads=0)
           and stats.host_reads == stats_p.host_reads == 1,
           f"min cut: the routes did different work: {stats} vs {stats_p}")
    cut = dict(alpha=alpha, in_play=in_play[alpha], kernel_s=kernel_s,
               plain_s=plain_s, stats=dataclasses.asdict(stats))
    return out, cut, start


def check_estep(x, dmaps, means, covs):
    """``[estep]``: the chr21 kernel E-step (the ICM graph of K2 and its
    loop, K1, K3, K4) against the plain path on the same device: labels
    agreeing on at least 99.9% of the pixels, statistics and costs within
    1e-3 relative. (``test_estep_kernels_are_deterministic`` holds its
    bitwise repeat.)"""
    import torch

    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket

    def run(plain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _estep_bucket(x["img"], x["mask"], dmaps, x["warm"], means,
                            covs, 1.0, 0.5, weighted_pp=False, max_sweeps=60,
                            plain=plain)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (lab_k, st_k, cv_k, _), t_k = run(False)
    (lab_p, st_p, cv_p, _), t_p = run(True)
    m = x["mask"]
    agree = float((lab_k == lab_p)[m].float().mean())
    # near-tie labels may flip between the paths (K1's exp differs by an
    # ulp); a flipped label moves the stats and costs by ~1/N
    _check(agree >= 0.999, f"E-step labels agree on only {agree}")
    stats_rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-3)).max())
                    for a, b in zip(st_k, st_p))
    cost_rel = float(((cv_k - cv_p).abs() / cv_p.abs()).max())
    _check(stats_rel < 1e-3, f"E-step stats rel err {stats_rel}")
    _check(cost_rel < 1e-3, f"E-step cost rel err {cost_rel}")
    return dict(label_agreement=agree, stats_max_rel=stats_rel,
                cost_max_rel=cost_rel, kernel_s=t_k, plain_s=t_p)


def estep_queues(model):
    """Whether ``estep(..., defer=True)`` of the [fit] model (``mf_icm``)
    enqueues its work with no synchronization (it runs under
    ``set_sync_debug_mode("error")``), and the host seconds of the enqueue
    beside those of the collect."""
    import torch

    means, covs = model._dev(model.means_), model._dev(model.covars_)
    warm = [torch.as_tensor(g, device=model.device).clone()
            for g in model.labels_local]
    model.estep(means, covs, warm, defer=True)[1]()    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, collect = model.estep(means, covs, warm, defer=True)
        queued, err = True, None
    except RuntimeError:    # a synchronizing call inside the E-step
        import traceback

        queued, collect = False, None
        err = traceback.format_exc().splitlines()[-9:]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    enqueue_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if collect is not None:
        collect()
    torch.cuda.synchronize()
    return dict(queued_without_sync=queued, error=err, enqueue_s=enqueue_s,
                collect_s=time.perf_counter() - t0)


def check_oracle(x, region, start, n_states, max_cycles, beta=1.0,
                 beta1=0.5):
    """The exact expansion polish of the port against the C++
    alpha-expansion (``phylo_hmrf_tpu_torch.native``, ctypes) from the
    same start on the same unary and weights. Gate, the reference's own:
    port energy <= oracle energy + 0.1% of its magnitude."""
    import dataclasses

    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch import native
    from phylo_hmrf_tpu_torch.data.regions import flat_edge_list
    from phylo_hmrf_tpu_torch.ops.maxflow import CutStats, _optimize_batched

    stats = CutStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _optimize_batched(x["unary_k"], x["w"], x["mask"], start, beta,
                            n_states, "expansion", max_cycles, stats=stats)
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0

    edges = flat_edge_list(region)
    w = np.exp(-beta1 * edges[:, 2])
    ei = edges[:, :2].astype(np.int64)
    rows, cols = region.flat_rows, region.flat_cols
    unary = x["unary_k"][0][:, rows, cols].T.double().cpu().numpy()
    start_f = region.labels_to_flat(start[0].cpu().numpy()).astype(np.int32)
    port_f = region.labels_to_flat(out[0].cpu().numpy()).astype(np.int32)
    t0 = time.perf_counter()
    cpp = native.potts_expansion(ei, w, unary, beta, start_f, 5000)
    cpp_s = time.perf_counter() - t0
    e_start, e_port, e_cpp = (native.potts_energy(ei, w, unary, beta, lab)
                              for lab in (start_f, port_f, cpp))
    gap = (e_port - e_cpp) / abs(e_cpp)
    _check(e_port <= e_cpp + 1e-3 * abs(e_cpp),
           f"polish energy {e_port} above the oracle's {e_cpp} by {gap}")
    return dict(energy_start=e_start, energy_port=e_port, energy_cpp=e_cpp,
                rel_gap=gap, agreement=float((port_f == cpp).mean()),
                changed_from_start=int((port_f != start_f).sum()),
                port_s=port_s, cpp_s=cpp_s, max_cycles=max_cycles,
                stats=dataclasses.asdict(stats))


def _counters():
    """The launch counter of every kernel wrapper, by kernel name, and of
    every loop graph (its launches, host side: the K2, K5 and K6 launches
    inside a graph are counted on the card, `_graph_kernels`)."""
    from phylo_hmrf_tpu_torch.ops import finish_kernels, icm_kernels, lbfgs
    from phylo_hmrf_tpu_torch.ops import loops, mf_kernels, mincut_kernels
    from phylo_hmrf_tpu_torch.ops import move_kernels

    return {"K1_mf_sweep": mf_kernels.mf_sweeps,
            "K2_icm_phase": icm_kernels.icm_sweep_pair,
            "K3_potts_energy": finish_kernels.potts_energy,
            "K4_finish_stats": finish_kernels.finish_stats,
            "K5_pr_iterations": mincut_kernels.pr_iterations,
            "K6_bfs_sweeps": mincut_kernels.bfs_sweeps,
            "K7_mf_sweeps_halo": mf_kernels.mf_sweeps_halo,
            "K8_icm_sweep_halo": icm_kernels.icm_sweep_halo_,
            "L_lbfgs_ou": lbfgs.fused_ou_solve,
            "M1_move_build": move_kernels.build_move,
            "M2_move_apply": move_kernels.apply_move,
            "G_icm_loop": loops.run_icm, "G_cut_loop": loops.run_cut,
            "G_bfs_loop": loops.run_bfs,
            "G_halo_icm_loop": loops.run_unit_loop}


def _plain_graph_launches():
    """Launches of the loop graphs of captured plain units (the float64
    mode's), by graph; they launch none of K1-K8."""
    from phylo_hmrf_tpu_torch.ops import loops

    return {name: fn.plain_launches for name, fn in (
        ("G_icm_loop", loops.run_icm), ("G_cut_loop", loops.run_cut),
        ("G_bfs_loop", loops.run_bfs),
        ("G_halo_icm_loop", loops.run_unit_loop))}


# the loop graphs that launch a kernel on the card, and the kernel's
# name in loops.kernel_launches()
GRAPH_OF = {"K2_icm_phase": (("G_icm_loop", "G_halo_icm_loop"), "K2"),
            "K5_pr_iterations": (("G_cut_loop",), "K5"),
            "K6_bfs_sweeps": (("G_cut_loop",), "K6"),
            "K8_icm_sweep_halo": (("G_halo_icm_loop",), "K8")}


def _ran(launches, name):
    """Whether kernel ``name`` ran: launched by its wrapper, or by a
    launch of a loop graph that holds it."""
    graphs = GRAPH_OF.get(name, ((),))[0]
    return launches.get(name, 0) + sum(launches.get(g, 0)
                                       for g in graphs) > 0


def _graph_kernels():
    """The K2, K5, K6 and K8 launches made inside loop graphs so far, read
    from the graphs' counters on the card (a read per graph)."""
    from phylo_hmrf_tpu_torch.ops import loops

    return loops.kernel_launches()


def _add_graph_kernels(launches, before):
    """``launches`` (by kernel) with the K2 / K5 / K6 / K8 launches made
    inside loop graphs since ``before`` (`_graph_kernels`) added."""
    now = _graph_kernels()
    out = dict(launches)
    for name, (_, key) in GRAPH_OF.items():
        out[name] = out.get(name, 0) + now[key] - before[key]
        out[f"in_graphs:{name}"] = now[key] - before[key]
    return out


def _sha(a):
    """SHA-256 of the bytes of a tensor (any device) or array."""
    import hashlib

    import numpy as np

    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _estep_digests(out):
    """Digests of a row-sharded E-step's labels, statistics and costs."""
    labels, (post, obs, obs2), cost_vec, n_valid = out
    return {k: _sha(v) for k, v in (
        ("labels", labels), ("post", post), ("obs", obs), ("obs2", obs2),
        ("cost_vec", cost_vec), ("n_valid", n_valid))}


def _fit_digests(res, grids):
    """Digests of a fit's cost rows, every iteration's label grids, the
    polished labels and the params."""
    import numpy as np

    return dict(cost_vec=_sha(res.cost_vec), labels=_sha(res.labels),
                iter_labels=_sha(np.concatenate([
                    g.cpu().numpy().ravel() for it in grids for g in it])),
                params_vec=_sha(res.params_vec),
                params_list=_sha(res.params_list))


def _traffic():
    """The cross-process calls of ``parallel/distributed.py`` so far:
    point-to-point exchanges and all-gathers, their calls, bytes sent and
    seconds."""
    from phylo_hmrf_tpu_torch.parallel import distributed

    return {name: dict(calls=fn.calls, bytes=fn.bytes, seconds=fn.seconds)
            for name, fn in (("exchange", distributed.exchange_tensors),
                             ("gather", distributed.all_gather_tensors))}


def _traffic_since(before):
    now = _traffic()
    return {name: {k: now[name][k] - before[name][k] for k in now[name]}
            for name in now}


def fit_model(tree, regions, cfg, device=None, mesh=None, state=None,
              count_init=False):
    """``PhyloHMRF.fit`` from ``state`` (``convert.export_state``'s), or
    from the model's own ``initialize()``, run (and timed) before the fit
    and its state kept, with the launch counters set to 0 just before the
    fit (``count_init``: just before the init) and read just after. Each
    E-step's wall (it ends in the read-back of its statistics) and the
    kernel launches inside it are logged. Returns a namespace: res,
    model, launches (per kernel), grids (each iteration's label grids),
    state, init_s, esteps."""
    import types

    from phylo_hmrf_tpu_torch import PhyloHMRF
    from phylo_hmrf_tpu_torch.convert import export_state, import_state

    model = PhyloHMRF(tree, regions, cfg, mesh=mesh, device=device)
    counters = _counters()
    in_graphs = _graph_kernels()
    if count_init:
        for fn in counters.values():
            fn.launches = 0
    init_s = None
    if state is None:
        t0 = time.perf_counter()
        model.initialize()
        init_s = time.perf_counter() - t0
        state = export_state(model)
    else:
        import_state(model, state)
    grids, esteps = [], []
    estep = model.estep

    def logged(*args, **kw):
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        out = estep(*args, **kw)
        rec = dict(wall_s=time.perf_counter() - t0, launches={
            k: fn.launches - before[k] for k, fn in counters.items()
            if fn.launches > before[k]})
        esteps.append(rec)
        if not kw.get("defer"):
            return out
        grids, collect = out

        def timed_collect():   # the wall: the enqueue and the read-back
            t1 = time.perf_counter()
            got = collect()
            rec["wall_s"] += time.perf_counter() - t1
            return got
        return grids, timed_collect
    model.estep = logged
    if not count_init:
        for fn in counters.values():
            fn.launches = 0
    res = model.fit(verbose=True, callback=lambda m, it, row, g: grids.append(
        [x.clone() for x in g]))
    launches = _add_graph_kernels(
        {k: fn.launches for k, fn in counters.items()}, in_graphs)
    return types.SimpleNamespace(res=res, model=model, launches=launches,
                                 grids=grids, state=state, init_s=init_s,
                                 esteps=esteps)


def check_fit(res, model, true, grids):
    """Costs, the .mat round trip, and the polish: it ran, no move hit
    max_sweeps, and its labels have no higher MRF energy than the best
    iteration's E-step labels it started from (both under the restored
    moments; summed over the regions). Returns (best-match accuracy,
    polish record)."""
    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf_kmajor
    from phylo_hmrf_tpu_torch.ops.finish_kernels import potts_energy
    from phylo_hmrf_tpu_torch.ops.potts import weight_maps
    from phylo_hmrf_tpu_torch.utils import (best_match_accuracy,
                                            load_estimate, save_estimate)

    cv = res.cost_vec
    _check(res.n_iters >= 3, f"fit ran only {res.n_iters} iterations")
    _check(np.isfinite(cv).all(), "non-finite costs")
    # cost1 == pairwise + unary: float32 per region, summed in float64
    _check(np.allclose(cv[:, 3], cv[:, 1] + cv[:, 2], rtol=1e-6, atol=0),
           "cost1 != pairwise + unary")
    _check(res.labels.shape == (model.n_samples,), "labels shape")
    with tempfile.TemporaryDirectory() as d:
        path = save_estimate(res, model.len_vec, d, 0, model.cfg.lambda_0,
                             model.cfg.n_states)
        got = load_estimate(path)
        for key in ("state_vec", "len_vec", "params_vec1", "params_vec2",
                    "iter_id1", "iter_id2", "cost_vec"):
            _check(key in got, f".mat lacks {key}")
        _check(np.array_equal(got["state_vec"].ravel(), res.labels),
               ".mat state_vec differs")

    st = model.polish_stats_
    _check(st is not None and st.moves > 0, "the final polish did not run")
    _check(st.capped == 0, f"{st.capped} polish moves hit max_sweeps")
    e_before = e_after = 0.0
    relabeled = 0
    flat = np.split(res.labels, model.offsets[1:-1])
    for idxs, img, mask, dmaps in model._bucket_arrays.values():
        dev = img.device
        unary_k = -gaussian_logpdf_kmajor(
            img, torch.as_tensor(res.means, dtype=torch.float32, device=dev),
            torch.as_tensor(res.covars, dtype=torch.float32, device=dev))
        w = weight_maps(dmaps, model.cfg.beta1)
        mask_i = mask.to(torch.int32)
        before = torch.stack([grids[res.iter_id2][ri].to(dev)
                              for ri in idxs]).to(torch.int32)
        after = torch.stack([torch.as_tensor(
            model.regions[ri].labels_to_grid(flat[ri]), device=dev)
            for ri in idxs]).to(torch.int32)
        e_before += float(potts_energy(unary_k, mask_i, before, w,
                                       model.cfg.beta).double().sum())
        e_after += float(potts_energy(unary_k, mask_i, after, w,
                                      model.cfg.beta).double().sum())
        relabeled += int((before != after)[mask].sum())
    _check(e_after <= e_before + 1e-6 * abs(e_before),
           f"polish raised the energy: {e_before} -> {e_after}")
    polish = dict(
        energy_before=e_before, energy_after=e_after, relabeled=relabeled,
        moves=st.moves, pr_iterations_per_move=st.pr_iterations / st.moves,
        bfs_sweeps_per_move=st.bfs_sweeps / st.moves,
        moves_at_max_sweeps=st.capped)
    return float(best_match_accuracy(res.labels, true)), polish


def _spy_first_calls(module, names):
    """Wrap ``module``'s functions ``names`` to keep the arguments of each
    one's first call (tensors cloned). Returns (the record, undo)."""
    import torch

    seen, real = {}, {n: getattr(module, n) for n in names}

    def wrap(name):
        def spy(*args, **kw):
            if name not in seen:
                seen[name] = ([a.clone() if torch.is_tensor(a) else a
                               for a in args], dict(kw))
            return real[name](*args, **kw)
        return spy
    for n in names:
        setattr(module, n, wrap(n))
    return seen, lambda: [setattr(module, n, f) for n, f in real.items()]


def _ops_ou_eval(n_nodes, n_leaves):
    """Operations of one value and gradient of the OU objective (a
    line-search point of ``csrc/lbfgs.cuh``), counted from its forward
    arithmetic: the recursion (12 a node), each leaf pair's covariance (2
    a node and 2), the Cholesky (F^3 / 3 + 2 F^2), the log-determinant
    (2 F + 2), Sn (6 F^2), the two triangular solves and the trace (2 F^3
    + 2 F^2 + F), the ridge (2 P) and f (5); the reverse pass at twice
    the forward one."""
    n, F = n_nodes, n_leaves
    Q, P = F * (F - 1) // 2, 3 * n - 1
    fwd = (12 * (n - 1) + Q * (2 * (n - 1) + 2) + F ** 3 // 3 + 2 * F * F
           + 2 * F + 2 + 6 * F * F + 2 * F ** 3 + 2 * F * F + F + 2 * P + 5)
    return 3 * fwd


def _ops_lbfgs(n_nodes, n_leaves, steps, rows, memory=10, etas=10):
    """Operations of a fused solve of ``rows`` rows that took ``steps``
    steps in all: the objective at each start, then per step and row the
    ``etas`` line-search points (6 a coordinate for the point and its
    sigmoid, and the objective), the two-loop recursion (8 a coordinate
    and memory slot), gamma, the accepted step and s.y (12 a
    coordinate)."""
    P = 3 * n_nodes - 1
    ev = _ops_ou_eval(n_nodes, n_leaves)
    step = etas * (ev + 6 * P) + 8 * memory * P + 12 * P
    return rows * ev + steps * step


def lbfgs_row(tree, seen, reps=20):
    """L on the first M-step and init solves of the ``[pipeline]`` fits
    (``seen``: their arguments) against the plain driver on the same
    inputs: 5 steps in float64, every output within 1e-9 relative and
    every M-step row taking the 5 steps; whole solves (the configured
    cap) in float32 and float64, compared by loss in float64 at each
    one's params: the fused loss no higher than the plain driver's by
    more than twice the largest gap of the plain driver's own twins (its
    solves from the start moved by one ulp: up, down, and by a random
    sign a coordinate), relative to the plain driver's loss, or 1e-4 /
    1e-9 where that is larger. Returns the record and L's kernel row on
    the float32 M-step solve: the device time of one launch (CUDA events
    around ``reps`` queued launches), one call with its host work, the
    plain driver's solve; max_abs_err that of the float64 5-step
    solves."""
    import functools

    import torch

    import phylo_hmrf_tpu_torch.models.hmrf as hm
    from phylo_hmrf_tpu_torch.models.ou import (ou_nll_init, ou_nll_stats,
                                                ridge_coef, tree_tensors)
    from phylo_hmrf_tpu_torch.ops import lbfgs

    rec, err = {}, 0.0
    for name in ("_mstep_solve_full", "_init_solve"):
        fn, (args0, kw0) = getattr(hm, name), seen[name]
        kind = "mstep" if name == "_mstep_solve_full" else "init"
        tt64 = tree_tensors(tree, args0[0].device, torch.float64)

        def loss(p, args):
            a = [t.double() if torch.is_tensor(t) else t for t in args]
            if kind == "mstep":
                return ou_nll_stats(p.double(), *a[1:4], tt64, *a[4:7])
            return ou_nll_init(p.double(), *a[1:3], tt64, a[3])

        for dtype in (torch.float64, torch.float32):
            args = [a.to(dtype) if torch.is_tensor(a) else a for a in args0]
            kw = dict(kw0, tt=tree_tensors(tree, args0[0].device, dtype))

            def solve(p0, fused, iters=kw["iters"]):
                return fn(p0, *args[1:], **dict(kw, iters=iters,
                                                 graphs={} if fused else None))

            r = rec[f"{kind}_{str(dtype)[6:]}"] = {}
            if dtype == torch.float64:
                fused, plain = solve(args[0], True, 5), solve(args[0], False, 5)
                worst = 0.0
                for a, b in zip(fused, plain):
                    if b is not None and b.is_floating_point():
                        d = _max_abs(a, b)
                        err = max(err, d)
                        worst = max(worst, d / max(float(b.abs().max()),
                                                   1e-300))
                _check(worst <= 1e-9, f"L {kind}: 5 steps in float64 {worst} "
                                      f"from the plain driver (rel)")
                _check(kind == "init" or bool((fused[4] == 5).all()),
                       f"L {kind}: rows took {fused[-1]} of 5 steps")
                r["short_max_rel"] = worst
            f_plain = loss(solve(args[0], False)[0], args)
            out = solve(args[0], True)
            ulp = float(torch.finfo(dtype).eps)
            g = torch.Generator().manual_seed(0)
            twin = 0.0
            for sg in (1.0, -1.0, torch.randint(
                    0, 2, tuple(args[0].shape), generator=g).to(
                        args[0].device, dtype) * 2 - 1):
                f_twin = loss(solve(args[0] * (1 + sg * ulp), False)[0], args)
                twin = max(twin, float(((f_twin - f_plain).abs()
                                        / f_plain.abs()).max()))
            excess = float(((loss(out[0], args) - f_plain)
                            / f_plain.abs()).max())
            floor = 1e-9 if dtype == torch.float64 else 1e-4
            r.update(loss_excess=excess, twin_gap=twin,
                     bound=max(floor, 2 * twin))
            _check(excess <= r["bound"],
                   f"L {kind} in {dtype}: its loss is {excess} above the "
                   f"plain driver's (rel), its twins land {twin} from it")

    args, kw = seen["_mstep_solve_full"]
    (p0, post, obs, obs2, n_samples, lambda_0, min_covar) = args
    tt = tree_tensors(tree, p0.device, torch.float32)

    def launch():
        return lbfgs.fused_ou_solve(
            p0, tt.index, tt.A2T, obs, obs2, post, n_samples=n_samples,
            coef=ridge_coef(torch.float32, n_samples, lambda_0),
            min_covar=min_covar, lo=kw["lo"], hi=kw["hi"],
            n_iters=kw["iters"])

    before = lbfgs.fused_ou_solve.launches
    solved, _, steps = launch()
    per_call = lbfgs.fused_ou_solve.launches - before
    _check(per_call == 1, f"L: {per_call} launches a fused solve")
    objective = functools.partial(ou_nll_stats, tt=tt, n_samples=n_samples,
                                  lambda_0=lambda_0, min_covar=min_covar)
    K = p0.shape[0]
    return rec, dict(
        max_abs_err=err,
        ms=_time_ms(launch, reps=reps, queued=True),
        call_ms=_time_ms(launch, reps=reps),
        plain_ms=_time_ms(lambda: lbfgs.minimize_boxed(
            lambda p: objective(p, post, obs, obs2), p0, kw["lo"],
            kw["hi"], kw["iters"]), reps=1),
        launches_per_unit=per_call,
        nbytes=_nbytes(p0, post, obs, obs2, tt.index, tt.A2T, solved, steps,
                       solved[:, 0]),
        ops=_ops_lbfgs(tree.n_nodes, tree.n_leaves, int(steps.sum()), K),
        unit=(f"one M-step solve: the [pipeline] fit's first, K={K}, "
              f"float32, at most {kw['iters']} steps; max_abs_err: 5 "
              f"steps in float64"))


def check_pipeline(tree, region, run, fit_digests, device):
    """``[pipeline]``: the chr21 default fit from the ``[fit]`` init state
    with ``em_pipeline=True`` and ``False``, in this process, digests
    equal to each other and to ``[fit]``'s; ``mstep_dispatch`` under
    ``torch.cuda.set_sync_debug_mode("error")``; the fused L-BFGS kernel
    on the first M-step solve of those fits and on a fresh model's init
    solve (`lbfgs_row`). Returns the record and L's kernel row."""
    import torch

    import phylo_hmrf_tpu_torch.models.hmrf as hm
    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig

    seen, undo = _spy_first_calls(hm, ("_mstep_solve_full", "_init_solve"))
    try:
        fits = {}
        for pipe in (True, False):
            cfg = PhyloHMRFConfig(n_states=10, max_iter=5, seed=0,
                                  em_pipeline=pipe)
            t0 = time.perf_counter()
            f = fit_model(tree, [region], cfg, device=device,
                          state=run.state)
            fit_s = time.perf_counter() - t0
            summ = f.model.timer.summary()
            n = f.res.n_iters
            fits[pipe] = f
            f.rec = dict(
                fit_s=fit_s, n_iters=n,
                mstep_s_per_iter=summ["mstep"]["total_s"] / n,
                estep_s_per_iter=summ["estep"]["total_s"] / n,
                final_polish_s=summ["final_polish"]["total_s"],
                phases=summ, rollbacks=f.model._mstep_rollbacks_,
                launches=f.launches, digests=_fit_digests(f.res, f.grids))
        PhyloHMRF(tree, [region], PhyloHMRFConfig(n_states=10, seed=0),
                  device=device).initialize()
    finally:
        undo()
    for pipe, f in fits.items():
        _check(f.rec["digests"] == fit_digests,
               f"[pipeline] em_pipeline={pipe}: digests differ from "
               f"[fit]'s: {f.rec['digests']} vs {fit_digests}")
        for name in list(KERNELS)[:6]:
            _check(f.launches[name] > 0,
                   f"[pipeline] {name} never launched (em_pipeline={pipe})")
    rec = dict(fits={str(p): f.rec for p, f in fits.items()})

    # no host sync in mstep_dispatch (the fused kernel's launch)
    m = fits[True].model
    _, stats, _, _ = m.estep(m.means_, m.covars_, m.labels_local)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = m.mstep_dispatch(stats)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    m.mstep_finalize(handle)
    rec["dispatch_without_sync"] = True
    rec["fused"], row = lbfgs_row(tree, seen)
    return rec, row


# labeler -> EM iterations of its [labelers] fit
LABELER_FITS = (("swap_tpu", 3), ("expansion_tpu", 3), ("mf_icm+swap@2", 5),
                ("mf_icm+expansion@2", 5), ("icm", 3), ("lbp", 3))
HOST_SWAP_H0 = 223   # the host swap's region: 24,976 samples


def check_labelers(tree, region, state, device):
    """``[labelers]``: a chr21 fit with each labeler of ``LABELER_FITS``
    from ``state`` (the [fit] phase's init). Per fit: the cost rows
    (finite, cost1 == pairwise + unary), each E-step's wall and launches,
    each exact E-step's moves (``CutStats``, its energy no higher than its
    K1-K3 start's), the hybrid's exact iterations, the launches per kernel
    and the peak device memory. The exact labelers launch K1-K6 and skip
    the final polish; ``icm`` launches K2 and K4."""
    import dataclasses

    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.models.hmrf import EXACT_LABELERS

    recs = {}
    for labeler, max_iter in LABELER_FITS:
        cfg = PhyloHMRFConfig(n_states=10, max_iter=max_iter, seed=0,
                              labeler=labeler)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = fit_model(tree, [region], cfg, device=device, state=state)
        fit_s = time.perf_counter() - t0
        res, model = run.res, run.model
        cv = res.cost_vec
        _check(res.n_iters == max_iter, f"{labeler}: {res.n_iters} iterations")
        _check(np.isfinite(cv).all(), f"{labeler}: non-finite costs")
        _check(np.allclose(cv[:, 3], cv[:, 1] + cv[:, 2], rtol=1e-6, atol=0),
               f"{labeler}: cost1 != pairwise + unary")
        must = {"swap_tpu": list(KERNELS)[:6], "expansion_tpu":
                list(KERNELS)[:6], "icm": ["K2_icm_phase", "K4_finish_stats"]}
        for name in must.get(labeler, []):
            _check(run.launches[name] > 0,
                   f"{name} never launched by the {labeler} fit")
        summ = model.timer.summary()
        if labeler in EXACT_LABELERS:
            _check(model.polish_stats_ is None and "final_polish" not in summ,
                   f"the final polish ran after the {labeler} labeler")
        exact = []
        for st in model.exact_stats_:
            _check(st.energy_end <= st.energy_start
                   + 1e-6 * abs(st.energy_start),
                   f"{labeler}: an exact E-step raised the energy of its "
                   f"start, {st.energy_start} -> {st.energy_end}")
            _check(st.capped == 0, f"{labeler}: a move hit max_sweeps")
            exact.append(dataclasses.asdict(st))
        n_exact = (len(model.hybrid_exact_iters_) if model._hybrid
                   else res.n_iters if labeler.endswith("_tpu") else 0)
        _check(len(exact) == n_exact, f"{labeler}: {len(exact)} exact "
                                      f"E-steps, expected {n_exact}")
        rec = dict(
            n_iters=res.n_iters, fit_s=fit_s, cost_vec=cv.tolist(),
            estep_s=[e["wall_s"] for e in run.esteps],
            estep_launches=[e["launches"] for e in run.esteps],
            exact_esteps=exact,
            hybrid_exact_iters=list(model.hybrid_exact_iters_),
            final_polish=model.polish_stats_ is not None,
            launches=run.launches, phases=summ,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[labelers] {labeler} {json.dumps(rec)}")
        recs[labeler] = rec
    return recs


# operations a pixel: M1 (the in-play tests of the pixel and its 8
# neighbours, 16 t-link terms, the 8 arcs, the clamps), M2 (the side test
# and the update)
OPS_BUILD, OPS_APPLY = 64, 4
def moves_rows(tree, region, state, device):
    """The kernel rows of M1 and M2 on the operands of the first exact
    moves of a chr21 ``swap_tpu`` fit from ``state`` (the [fit] phase's
    init), kept at its first ``_optimize_batched`` call. From its start
    labels M1 builds every swap pair's graph and every expansion's bit
    for bit as ``_swap_graph`` / ``_expansion_graph`` (raw bits of
    excess0, cap_t0, the 8 arc planes and in_play; h = 0; the pr word's
    first test and limit). M1's row times the swap move with the most
    pixels in play, M2's writes its labels after its cut, equal to the
    tensor update; each is timed beside the tensor code it replaces."""
    import torch

    from phylo_hmrf_tpu_torch import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.ops import loops, maxflow as mf, move_kernels
    from phylo_hmrf_tpu_torch.ops.finish_kernels import _f32

    seen, undo = _spy_first_calls(mf, ["_optimize_batched"])
    try:
        fit_model(tree, [region], PhyloHMRFConfig(
            n_states=10, max_iter=1, seed=0, labeler="swap_tpu"),
            device=device, state=state)
    finally:
        undo()
    unary, w, mask, init, beta, K, method = seen["_optimize_batched"][0][:7]
    _check(method == "swap", f"the first exact moves are {method}")
    beta = _f32(beta)
    lab = torch.where(mask, init, 0).to(torch.int32)
    wsum = mf._incident_wsum(w, beta)
    R, _, H, W = unary.shape
    N = R * H * W
    graph = loops.cut_graph(unary.device, R, H, W)
    mp = move_kernels.MovePass(graph, lab, unary, w, mask, wsum, beta, 1)

    pairs = [(a, b) for a in range(K) for b in range(a + 1, K)]

    def tensor_graph(a, b):
        if b >= 0:
            return mf._swap_graph(lab, unary, w, mask, a, b, beta, wsum)
        return mf._expansion_graph(lab, unary, w, mask, a, beta, wsum)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    # every swap pair and every expansion (b = -1), bit for bit
    bad, in_play = [], {}
    for a, b in pairs + [(a, -1) for a in range(K)]:
        move_kernels.build_move(mp, a, b, 3000)
        want = tensor_graph(a, b)
        e, h, cap_t, caps = graph.a
        for name, got, ref in zip(("excess0", "cap_t0", "caps0", "in_play"),
                                  (e, cap_t, caps, mp.in_play), want):
            if not torch.equal(bits(got), bits(ref)):
                bad.append((a, b, name))
        word = graph.pr.tolist()
        if int(h.abs().max()) != 0 or word[loops.LOOP_GO] != int(
                torch.any(want[0] > loops.CUT_EPS)) \
                or word[loops.LOOP_LIMIT] != 3000:
            bad.append((a, b, "h or pr word"))
        in_play[(a, b)] = int(want[3].sum())
    _check(not bad, f"M1 differs from the tensor build: {bad[:8]}")
    a, b = max(pairs, key=in_play.get)
    rows = {"M1_move_build": _with_bound(dict(
        max_abs_err=0.0,
        **_timed(lambda: move_kernels.build_move(mp, a, b, 3000),
                 lambda: tensor_graph(a, b)),
        unit=f"one swap move's graph ({a}, {b}), {in_play[(a, b)]} pixels "
             f"in play", launches_per_unit=1, nbytes=78 * N,
        ops=OPS_BUILD * N))}
    # M2 on a copy of the labels, after the cut of that move
    move_kernels.build_move(mp, a, b, 3000)
    graph.launch_filled()
    side = graph.d[0] >= graph.n
    mp2 = move_kernels.MovePass(graph, lab.clone(), unary, w, mask, wsum,
                                beta, 1)
    mp2.in_play.copy_(mp.in_play)

    def plain_apply():
        new = torch.where(mp.in_play, torch.where(side, a, b).to(
            torch.int32), lab)
        return new, torch.sum(new != lab, dim=(1, 2))
    want_lab, want_n = plain_apply()
    move_kernels.apply_move(mp2, a, b, 0)
    _check(torch.equal(mp2.labels, want_lab)
           and torch.equal(mp2.counts[0].long(), want_n),
           "M2 differs from the tensor update")
    rows["M2_move_apply"] = _with_bound(dict(
        max_abs_err=_max_abs(mp2.labels, want_lab),
        **_timed(lambda: move_kernels.apply_move(mp2, a, b, 0), plain_apply),
        unit=f"one swap move's labels ({a}, {b}), {int(want_n.sum())} "
             f"changed", launches_per_unit=1,
        nbytes=9 * N + 4 * int(want_n.sum()), ops=OPS_APPLY * N))
    return rows


def kmeans_row(X, K, n_init=10, n_iters=100, pp_subsample=65536,
               seeds=(0, 2718281911)):
    """``[kmeans]`` and KM's kernel row on the samples ``X`` (N, F) with a
    fit's defaults. For each seed, KM1's picks are bitwise `_seed_plain`'s
    from the same draws, every trial; the whole ``kmeans`` call has
    `kmeans_plain`'s centers and labels, bitwise, and its inertia within
    1e-6 relative. The row's unit is KM1 and KM2/KM3 from one call's
    draws; call_ms the whole call, the draws included. Its bound: the
    distance operations (3 F a sample, center and trial in each of the
    ``n_iters`` steps and KM3's inertia pass, and in the best trial's
    labels; 3 F a subsample point and k-means++ draw) and the bytes of X
    read once a pass, each trial's subsample once, the labels written."""
    import torch

    from phylo_hmrf_tpu_torch.ops import kmeans as km

    dev = X.device
    n, F = X.shape
    m = min(n, pp_subsample)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    rec = dict(N=n, F=F, K=K, n_init=n_init, n_iters=n_iters)
    err = 0.0
    for seed in seeds:
        draws = km._draws(gen(seed), n, m, K, n_init, dev)
        got = km._seed_kernel(X, *draws, K)
        perm, first, u = draws
        for t in range(n_init):
            want = km._seed_plain(X, None if perm is None else perm[t],
                                  first[t], u[t], K)
            _check(torch.equal(got[t], want),
                   f"KM1: seed {seed} trial {t} picks differ from the plain "
                   f"seeding's")
        route = km.kmeans_route(dev, X.dtype, F, K, n_init)
        c, lab, inertia = km.kmeans(gen(seed), X, K, n_iters, n_init,
                                    pp_subsample)
        pc, plab, pin = km.kmeans_plain(gen(seed), X, K, n_iters, n_init,
                                        pp_subsample)
        rel = abs(float(inertia) - float(pin)) / abs(float(pin))
        _check(route == "kernel", f"k-means on the {route} route")
        _check(torch.equal(c, pc) and torch.equal(lab, plab),
               f"KM2/KM3 at seed {seed}: centers {_max_abs(c, pc)} from "
               f"the plain ones, {int((lab != plab).sum())} labels differ")
        _check(rel <= 1e-6, f"KM3's inertia {rel} (rel) from the plain one")
        err = max(err, _max_abs(inertia, pin))
        rec[f"seed_{seed}"] = dict(inertia=float(inertia),
                                   inertia_rel_err=rel)
    draws = km._draws(gen(seeds[0]), n, m, K, n_init, dev)
    before = km.kmeans.kernel_launches
    km.kmeans(gen(seeds[0]), X, K, n_iters, n_init, pp_subsample)
    per_call = km.kmeans.kernel_launches - before
    _check(per_call == 2, f"KM: {per_call} launches a call")
    passes = n_init * (n_iters + 1) + 1
    row = _with_bound(dict(
        max_abs_err=err,
        ms=_time_ms(lambda: km._lloyd_kernel(
            X, km._seed_kernel(X, *draws, K), n_iters), queued=True),
        call_ms=_time_ms(lambda: km.kmeans(gen(seeds[0]), X, K, n_iters,
                                           n_init, pp_subsample)),
        plain_ms=_time_ms(lambda: km.kmeans_plain(
            gen(seeds[0]), X, K, n_iters, n_init, pp_subsample), reps=1),
        launches_per_unit=per_call,
        nbytes=4 * F * (n * (n_iters + 2) + n_init * m) + 4 * n,
        ops=3 * F * (passes * n * K + n_init * m * (K - 1)),
        unit=f"one k-means call, N={n}, F={F}, K={K}, {n_init} trials of "
             f"{n_iters} steps, from its draws; max_abs_err: the inertia"))
    return rec, row


def check_host_swap(device, h0=HOST_SWAP_H0, beta=1.0, beta1=0.5,
                    min_covar=1e-3):
    """``[host_swap]``: one E-step of the host ``swap`` labeler (the C++
    alpha-beta swap of ``native/``, from the warm labels, on the float64
    unary) and one of ``swap_tpu`` (the K1-K3 start, then swap moves on
    K5/K6) on an h0 x h0 chr21-like region, the same moments and warm
    labels. Gate, the reference's own: the device labels' energy (both
    scored by the C++ energy on the float64 unary) <= the C++ swap's +
    0.1%."""
    import numpy as np

    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig, native
    from phylo_hmrf_tpu_torch.data.regions import flat_edge_list
    from phylo_hmrf_tpu_torch.models.hmrf import _gauss_logpdf_np
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    tree, region, means, covs, warm, _ = chr21_problem(0, h0=h0)
    grid = region.labels_to_grid(warm)
    K = means.shape[0]
    got = {}
    for labeler in ("swap", "swap_tpu"):
        model = PhyloHMRF(tree, [region], PhyloHMRFConfig(
            n_states=K, seed=0, labeler=labeler), device=device)
        t0 = time.perf_counter()
        lab, _, costs, _ = model.estep(means, covs, [grid])
        wall = time.perf_counter() - t0
        got[labeler] = (region.labels_to_flat(
            lab[0].cpu().numpy()).astype(np.int32), wall, costs[0].tolist())
    X = region.flat_values().astype(np.float64)
    unary = -np.stack([_gauss_logpdf_np(X, means[c], covs[c], min_covar)
                       for c in range(K)], axis=1)
    edges = flat_edge_list(region)
    w = np.exp(-beta1 * edges[:, 2])
    ei = edges[:, :2].astype(np.int64)
    e_cpp, e_dev, e_start = (native.potts_energy(ei, w, unary, beta, lab)
                             for lab in (got["swap"][0], got["swap_tpu"][0],
                                         warm.astype(np.int32)))
    gap = (e_dev - e_cpp) / abs(e_cpp)
    _check(e_dev <= e_cpp + 1e-3 * abs(e_cpp),
           f"device swap energy {e_dev} above the C++ swap's {e_cpp} by "
           f"{gap}")
    return dict(samples=region.n_samples, shape=list(region.shape),
                energy_start=e_start, energy_cpp=e_cpp, energy_device=e_dev,
                rel_gap=gap,
                agreement=float((got["swap"][0] == got["swap_tpu"][0]).mean()),
                cpp_estep_s=got["swap"][1], device_estep_s=got["swap_tpu"][1],
                costs_cpp=got["swap"][2], costs_device=got["swap_tpu"][2])


F64_ITERS = 3   # EM iterations of the [f64] fit


def check_f64(tree, region, state, fit_launches, device):
    """``[f64]``: the default config at ``dtype="float64"`` on the chr21
    cell, ``F64_ITERS`` iterations from its own init (depth cut only):
    the walls of its phases, its peak device memory and the launches of
    K1-K8 from its init to its polish (all 0: the float64 mode runs the
    plain versions, as the JAX engine runs its jnp paths in float64),
    beside the ``[fit]`` phase's (non-zero), and of L (its OU solves, the
    init's and one an M-step at least, in double). Checks: the float64 unary of
    the ``[fit]`` init moments against the float64 host
    ``_gauss_logpdf_np`` (rtol 1e-9, atol 1e-9, the JAX gate);
    ``cost1 == pairwise + unary`` on every iteration; one float64 E-step
    from the ``[fit]`` init state run twice, bitwise equal; its labels
    against the float32 E-step's from that state (agreement >= 0.99); the
    float64 E-step over 4 spatial shards of the card, bitwise the
    single-device one (the pinned order)."""
    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.convert import import_state
    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf_kmajor
    from phylo_hmrf_tpu_torch.models.hmrf import _gauss_logpdf_np
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh

    K = int(state["means"].shape[0])
    cfg = PhyloHMRFConfig(n_states=K, max_iter=F64_ITERS, seed=0,
                          dtype="float64")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain0 = _plain_graph_launches()
    t0 = time.perf_counter()
    run = fit_model(tree, [region], cfg, device=device, count_init=True)
    fit_s = time.perf_counter() - t0
    plain_graphs = {k: v - plain0[k]
                    for k, v in _plain_graph_launches().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res, model = run.res, run.model
    _check(model._dtype == torch.float64 and not model._use_kernels,
           "the float64 model chose the kernels")
    # its OU solves take the fused L-BFGS kernel in double; no other
    _check(run.launches["L_lbfgs_ou"] > res.n_iters,
           f"the float64 fit's solves did not all take the fused kernel: "
           f"{run.launches}")
    _check(not any(v for k, v in run.launches.items() if k != "L_lbfgs_ou"),
           f"the float64 fit launched kernels: {run.launches}")
    _check(all(fit_launches[k] > 0 for k in list(KERNELS)[:6]),
           "the [fit] phase did not launch K1-K6")
    cv = res.cost_vec
    _check(res.n_iters == F64_ITERS and np.isfinite(cv).all(),
           f"float64 fit: {res.n_iters} iterations, costs {cv.tolist()}")
    _check(np.allclose(cv[:, 3], cv[:, 1] + cv[:, 2], rtol=1e-12, atol=0),
           "float64 fit: cost1 != pairwise + unary")
    st = model.polish_stats_
    _check(st is not None and st.moves > 0 and st.capped == 0,
           "float64 fit: the final polish did not run, or a move capped")
    _check(st.energy_end <= st.energy_start + 1e-9 * abs(st.energy_start),
           "float64 fit: the polish raised the energy")
    summ = model.timer.summary()
    walls = {p: summ[p]["total_s"] for p in ("estep", "mstep",
                                             "final_polish")}
    walls["init"] = run.init_s

    # the float64 unary at the JAX gate, from the [fit] init moments
    means, covars = state["means"], state["covars"]
    img = torch.as_tensor(region.img[None], dtype=torch.float64,
                          device=device)
    unary = -gaussian_logpdf_kmajor(
        img, torch.as_tensor(means, device=device),
        torch.as_tensor(covars, device=device))[0]
    got = unary[:, region.flat_rows, region.flat_cols].T.cpu().numpy()
    X = region.flat_values().astype(np.float64)
    want = -np.stack([_gauss_logpdf_np(X, means[c], covars[c], cfg.min_covar)
                      for c in range(K)], axis=1)
    unary_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    _check(np.allclose(got, want, rtol=1e-9, atol=1e-9),
           f"float64 unary off the host's by {unary_rel} (rel)")

    def estep(dtype, mesh=None):
        m = PhyloHMRF(tree, [region], PhyloHMRFConfig(
            n_states=K, seed=0, dtype=dtype,
            shard_mode="spatial" if mesh else "region"), mesh=mesh,
            device=None if mesh else device)
        import_state(m, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids, (p, o, o2), costs, _ = m.estep(m.means_, m.covars_,
                                              m.labels_local)
        return (m._flat_labels(grids), p, o, o2, costs,
                time.perf_counter() - t0)

    for fn in _counters().values():
        fn.launches = 0
    one, two = estep("float64"), estep("float64")
    _check(all(np.array_equal(a, b) for a, b in zip(one[:5], two[:5])),
           "the float64 E-step is not bitwise repeatable")
    mesh = make_mesh((SHARDS,))
    shards = estep("float64", mesh)
    _check(all(np.array_equal(a, b) for a, b in zip(shards[:5], one[:5])),
           f"the float64 E-step over {SHARDS} spatial shards is not "
           f"bitwise the single-device one")
    _check(not any(fn.launches for fn in _counters().values()),
           "a float64 E-step launched a kernel")
    f32 = estep("float32")
    agree = float((f32[0] == one[0]).mean())
    _check(agree >= 0.99, f"float64 E-step labels agree {agree} with the "
                          f"float32 E-step's")
    return dict(
        n_iters=res.n_iters, fit_s=fit_s, walls_s=walls,
        estep_s=[e["wall_s"] for e in run.esteps], peak_mem_gib=peak,
        launches=run.launches,
        fit_launches={k: fit_launches[k] for k in KERNELS},
        cost_vec=cv.tolist(), unary_max_rel=unary_rel,
        polish=dict(moves=st.moves, pr_iterations=st.pr_iterations,
                    bfs_sweeps=st.bfs_sweeps, host_reads=st.host_reads,
                    energy_start=st.energy_start, energy_end=st.energy_end),
        plain_graph_launches=plain_graphs,
        estep_bitwise_repeat=True, spatial_shards=SHARDS,
        spatial_bitwise_single=True, f32_label_agreement=agree,
        f32_cost_rel=float(np.max(np.abs(f32[4] - one[4])
                                  / np.abs(one[4]))),
        estep_f64_s=[one[5], two[5]], estep_f64_spatial_s=shards[5],
        estep_f32_s=f32[5])


def check_f64_oracle(device, h0=HOST_SWAP_H0, beta=1.0, beta1=0.5,
                     min_covar=1e-3):
    """``[f64_oracle]``: one float64 exact expansion polish on the card
    (the K1-K3 start and the expansion moves, plain versions in float64,
    no kernel launched) on the ``[host_swap]`` problem, against the C++
    alpha-expansion of ``native/`` from the same start on the same
    float64 unary and weights. Gate, the one the float32 polish meets:
    the card's energy <= the C++ one's + 0.1%."""
    import dataclasses

    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch import PhyloHMRFConfig, native
    from phylo_hmrf_tpu_torch.data.regions import flat_edge_list
    from phylo_hmrf_tpu_torch.models.emission import gaussian_logpdf_kmajor
    from phylo_hmrf_tpu_torch.models.hmrf import _gauss_logpdf_np
    from phylo_hmrf_tpu_torch.ops.maxflow import (CutStats, _optimize_batched,
                                                  _start_batch)
    from phylo_hmrf_tpu_torch.ops.potts import weight_maps
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    _, region, means, covs, warm, _ = chr21_problem(0, h0=h0)
    K = means.shape[0]
    cfg = PhyloHMRFConfig()

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    unary_k = -gaussian_logpdf_kmajor(dev(region.img[None]), dev(means),
                                      dev(covs)).contiguous()
    w = weight_maps(dev(region.dmaps[None]), beta1).contiguous()
    mask = dev(region.mask[None], torch.bool)
    warm_g = dev(region.labels_to_grid(warm)[None], torch.int32)
    for fn in _counters().values():
        fn.launches = 0
    stats = CutStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = _start_batch(unary_k, w, mask, warm_g, beta,
                         cfg.icm_max_sweeps, plain=True)
    out = _optimize_batched(unary_k, w, mask, start, beta, K, "expansion",
                            cfg.swap_tpu_cycles, plain=True, stats=stats)
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    _check(not any(fn.launches for fn in _counters().values()),
           "the float64 polish launched a kernel")
    X = region.flat_values().astype(np.float64)
    unary = -np.stack([_gauss_logpdf_np(X, means[c], covs[c], min_covar)
                       for c in range(K)], axis=1)
    dev_unary = unary_k[0][:, region.flat_rows, region.flat_cols].T
    unary_rel = float(np.max(np.abs(dev_unary.cpu().numpy() - unary)
                             / np.abs(unary)))
    edges = flat_edge_list(region)
    wf = np.exp(-beta1 * edges[:, 2])
    ei = edges[:, :2].astype(np.int64)
    start_f = region.labels_to_flat(start[0].cpu().numpy()).astype(np.int32)
    port_f = region.labels_to_flat(out[0].cpu().numpy()).astype(np.int32)
    t0 = time.perf_counter()
    cpp = native.potts_expansion(ei, wf, unary, beta, start_f, 5000)
    cpp_s = time.perf_counter() - t0
    e_start, e_port, e_cpp = (native.potts_energy(ei, wf, unary, beta, lab)
                              for lab in (start_f, port_f, cpp))
    gap = (e_port - e_cpp) / abs(e_cpp)
    _check(e_port <= e_cpp + 1e-3 * abs(e_cpp),
           f"float64 polish energy {e_port} above the C++ expansion's "
           f"{e_cpp} by {gap}")
    return dict(samples=region.n_samples, shape=list(region.shape),
                energy_start=e_start, energy_port=e_port, energy_cpp=e_cpp,
                rel_gap=gap, agreement=float((port_f == cpp).mean()),
                unary_max_rel_host=unary_rel, port_s=port_s, cpp_s=cpp_s,
                stats=dataclasses.asdict(stats))


def check_postprocess(res, model, true):
    """``[postprocess]`` on the ``[fit]`` output, none of it needing
    pandas, scikit-learn or matplotlib: ``smooth_state_vec``,
    ``write_state_files`` (a row a sample), ``save_state_image`` to a PNG
    read back equal to ``states_to_rgb``; ``compare_results`` of the
    fit's ``.mat`` against itself (NMI, ARI and the matched accuracy 1.0,
    to 1e-12) and ``compare_labeling`` of the fit against the truth."""
    import numpy as np

    from phylo_hmrf_tpu_torch.compare import compare_results
    from phylo_hmrf_tpu_torch.postprocess.smooth import (
        read_state_image, save_state_image, smooth_state_vec, states_to_grid,
        states_to_rgb, write_state_files)
    from phylo_hmrf_tpu_torch.utils import save_estimate
    from phylo_hmrf_tpu_torch.utils.metrics import compare_labeling

    K = model.cfg.n_states
    lv = model.len_vec
    walls = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        sm = smooth_state_vec(res.labels, lv, K)
        walls["smooth_s"] = time.perf_counter() - t0
        _check(sm.shape == res.labels.shape and 0 <= sm.min()
               and sm.max() < K, "smoothed states out of range")
        t0 = time.perf_counter()
        path = write_state_files(sm, lv, int(lv[0, 9]), 50000, d, "smooth")
        walls["write_s"] = time.perf_counter() - t0
        with open(path) as f:
            n_rows = sum(1 for _ in f)
        _check(n_rows == res.labels.size, f"{n_rows} state rows written")
        n, start, stop, H0, W0 = (int(v) for v in lv[0, :5])
        grid = states_to_grid(sm[start:stop], H0, W0, bool(lv[0, 8]))
        png = os.path.join(d, "states.png")
        t0 = time.perf_counter()
        save_state_image(grid, png, n_components=K, title="chr21 smoothed")
        walls["png_s"] = time.perf_counter() - t0
        rgb, title = read_state_image(png)
        _check(np.array_equal(rgb, states_to_rgb(grid, n_components=K))
               and title == "chr21 smoothed", "the PNG read back differs")
        png_bytes = os.path.getsize(png)
        mat = save_estimate(res, lv, d, 0, model.cfg.lambda_0, K)
        t0 = time.perf_counter()
        same = compare_results(mat, mat)
        walls["compare_s"] = time.perf_counter() - t0
    for key in ("nmi", "ari", "agreement_best_match"):
        _check(abs(same[key] - 1.0) <= 1e-12,
               f"compare_results of the fit against itself: {key} "
               f"{same[key]}")
    t0 = time.perf_counter()
    nmi, ami, ari, ri, prec, rec, f1 = compare_labeling(res.labels, true)
    walls["compare_labeling_s"] = time.perf_counter() - t0
    return dict(samples=int(res.labels.size),
                smoothed_changed=int((sm != res.labels).sum()),
                state_rows=n_rows, png=[*rgb.shape], png_bytes=png_bytes,
                self_compare={k: same[k] for k in
                              ("nmi", "ami", "ari", "agreement_best_match")},
                vs_truth=dict(nmi=nmi, ami=ami, ari=ari, ri=ri,
                              precision=prec, recall=rec, f1=f1),
                walls_s=walls)


def check_mesh_exact(mesh, device, seeds=(0, 1)):
    """``[mesh_exact]``: one region-mode ``swap_tpu`` E-step over the mesh
    on a bucket of two chr21 regions (seeds 0 and 1, the moments of seed
    0): its labels equal each region's own on one device (a one-region
    model), the route the JAX engine takes on a mesh. Also says how far
    the one-device batched route over the bucket (regions sharing one move
    schedule and stopping test) agrees with them."""
    import torch

    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    probs = [chr21_problem(s) for s in seeds]
    tree, _, means, covs, _, _ = probs[0]
    regions = [p[1] for p in probs]
    warm = [p[1].labels_to_grid(p[4]) for p in probs]
    cfg = PhyloHMRFConfig(n_states=means.shape[0], seed=0,
                          labeler="swap_tpu")
    meshed = PhyloHMRF(tree, regions, cfg, mesh=mesh)
    _check(not meshed._spatial and len(meshed._bucket_arrays) == 1,
           "the meshed model is not one region-mode bucket")
    t0 = time.perf_counter()
    got = meshed.estep(means, covs, warm)[0]
    mesh_s = time.perf_counter() - t0
    alone = [PhyloHMRF(tree, [r], cfg, device=device).estep(
        means, covs, [w])[0][0] for r, w in zip(regions, warm)]
    t0 = time.perf_counter()
    batched = PhyloHMRF(tree, regions, cfg, device=device).estep(
        means, covs, warm)[0]
    batched_s = time.perf_counter() - t0
    for i, (g, a) in enumerate(zip(got, alone)):
        _check(torch.equal(g.to(a.device), a),
               f"meshed exact labels of region {i} differ from its own "
               f"labels on one device in {int((g.to(a.device) != a).sum())} "
               f"pixels")
    masks = [torch.as_tensor(r.mask, device=device) for r in regions]
    return dict(regions=len(regions), shards=mesh.size, mesh_estep_s=mesh_s,
                batched_estep_s=batched_s, per_region_equal=True,
                batched_agreement=[
                    float((b == a)[m].double().mean())
                    for b, a, m in zip(batched, alone, masks)])


def _compare_estep(got, want, masks, what):
    """Gates of one E-step against another on the same inputs, region by
    region: label agreement over the region's valid pixels >= 0.999, its
    stats and costs relative error < 1e-3 (a label flipped at a near-tie
    between float orders moves them by ~1/N). got/want: (label grids,
    per-region (post, obs, obs2), per-region costs); arrays or tensors.
    Returns {"regions": [per-region record]}."""
    import numpy as np

    def host(a):
        return a.detach().cpu().numpy() if hasattr(a, "detach") else \
            np.asarray(a)

    per = []
    for r, (a, b, m) in enumerate(zip(got[0], want[0], masks)):
        m = host(m)
        agree = float((host(a) == host(b))[m].mean())
        stats_rel = max(float((np.abs(host(s)[r] - host(t)[r])
                               / np.maximum(np.abs(host(t)[r]), 1e-3)).max())
                        for s, t in zip(got[1], want[1]))
        c, d = host(got[2])[r], host(want[2])[r]
        cost_rel = float((np.abs(c - d) / np.abs(d)).max())
        _check(agree >= 0.999,
               f"{what}, region {r}: labels agree on only {agree}")
        _check(stats_rel < 1e-3, f"{what}, region {r}: stats rel err "
                                 f"{stats_rel}")
        _check(cost_rel < 1e-3, f"{what}, region {r}: cost rel err "
                                f"{cost_rel}")
        per.append(dict(valid_pixels=int(m.sum()), label_agreement=agree,
                        stats_max_rel=stats_rel, cost_max_rel=cost_rel))
    return {"regions": per}


def _halo_shards(x, n_shards):
    """One device's row shards of ``x`` (rows split evenly, contiguous):
    the K7/K8 operands with the weights extended by one exchanged row a
    side, the start labels, the shards' first global rows and the row
    sources of one device."""
    import torch

    from phylo_hmrf_tpu_torch.ops.halo_rows import row_sources
    from phylo_hmrf_tpu_torch.parallel.halo import extend_rows

    def cut(t):
        return [c.contiguous() for c in torch.chunk(t, n_shards, dim=-2)]
    lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32).contiguous()
    sh = {k: cut(v) for k, v in (("q0", x["q0"]), ("base", x["base"]),
                                 ("w", x["w"]), ("unary_k", x["unary_k"]),
                                 ("mask_i", x["mask_i"]), ("lab0", lab0))}
    heights = [t.shape[-2] for t in sh["q0"]]
    sh["w_ext"] = extend_rows(sh["w"])
    sh["row0"] = [sum(heights[:i]) for i in range(n_shards)]
    sh["local"] = row_sources([x["q0"].device] * n_shards, heights)
    # every neighbour marked remote: the route between devices, on one card
    sh["remote"] = row_sources(["a", "b"] * (n_shards // 2)
                               + ["a"] * (n_shards % 2), heights)
    return sh


def check_halo_kernels(x, n_shards, n_sweeps, n_phases, beta=1.0):
    """K7 and K8 over ``n_shards`` row shards of one region's operands on
    one device (the unit: ``n_sweeps`` sweeps at one temperature; a sweep
    (``n_phases`` = 4) or one phase). Bitwise the per-shard route they
    replaced (``*_chained``, timed beside as ``chained_ms``), and the
    route with every neighbour remote bitwise the same-device route; K7
    within K1's gate of its plain version (rtol 2e-4, atol 1e-6), K8
    identical labels and changed count. Returns {kernel: row}."""
    import torch

    from phylo_hmrf_tpu_torch.ops.icm_kernels import (
        icm_sweep_halo_, icm_sweep_halo_chained, icm_sweep_halo_plain)
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        mf_halo_rows, mf_sweeps_halo, mf_sweeps_halo_chained,
        mf_sweeps_halo_plain)
    from phylo_hmrf_tpu_torch import _build

    sh = _halo_shards(x, n_shards)
    K = x["q0"].shape[1]
    W = x["q0"].shape[-1]
    heights = [t.shape[-2] for t in sh["q0"]]
    px = sum(heights) * W
    out = {}
    k7 = (sh["q0"], sh["base"], sh["w_ext"], 1.0, 0.5, beta)
    got = mf_sweeps_halo(*k7, n_sweeps=n_sweeps, sources=sh["local"])
    want = mf_sweeps_halo_chained(*k7, n_sweeps=n_sweeps)
    _check(all(torch.equal(a, b) for a, b in zip(got, want)),
           f"K7 ({n_sweeps} sweeps, {heights} rows): not bitwise the "
           "per-shard route")
    rem = mf_sweeps_halo(*k7, n_sweeps=n_sweeps, sources=sh["remote"])
    _check(all(torch.equal(a, b) for a, b in zip(rem, got)),
           "K7: the remote route differs from the same-device route")
    plain = mf_sweeps_halo_plain(*k7, n_sweeps)
    torch.cuda.synchronize()
    err = max(_max_abs(a, b) for a, b in zip(got, plain))
    _check(all(torch.allclose(a, b, rtol=2e-4, atol=1e-6)
               for a, b in zip(got, plain)), f"K7 disagrees: {err}")
    th = mf_halo_rows(heights)
    with _build.on_device(x["q0"]):
        grid7 = _build.load().phmrf_mf_halo_grid(K, th)
        grid8 = _build.load().phmrf_icm_halo_grid()
    sweeps = "one temperature's sweeps" if n_sweeps > 1 else "one sweep"
    out["K7_mf_sweeps_halo"] = dict(
        max_abs_err=err, bitwise_chained=True, bitwise_remote=True,
        **_timed(lambda: mf_sweeps_halo(*k7, n_sweeps=n_sweeps,
                                        sources=sh["local"]),
                 lambda: mf_sweeps_halo_plain(*k7, n_sweeps),
                 lambda: mf_sweeps_halo_chained(*k7, n_sweeps=n_sweeps)),
        unit=f"{n_sweeps} sweep(s) ({sweeps}) of {n_shards} shards of "
             f"{heights[0]} x {W}, one launch",
        launches_per_unit=1, tile_rows=th, cooperative_grid=grid7,
        tolerance="bitwise the per-shard route and the remote route; rtol "
                  "2e-4, atol 1e-6 against plain",
        # the bytes once (a launch could keep them on chip across its
        # sweeps, as K1 does): q and base read, q written, the weights
        # read, one row a side of q per shard
        nbytes=(3 * _nbytes(*sh["q0"]) + _nbytes(*sh["w_ext"])
                + 2 * n_shards * 4 * K * W),
        ops=n_sweeps * OPS_MF * K * px, shards=[n_shards, heights[0], W])

    # K8: the phases from the start labels, global parity; identical
    k8 = (sh["unary_k"], sh["w_ext"], sh["mask_i"], beta)
    kw = dict(row0=sh["row0"], phase0=0, n_phases=n_phases)
    want, count = icm_sweep_halo_chained(sh["lab0"], *k8, **kw)
    dev = x["q0"].device
    runs = {}
    for tag, src in (("local", sh["local"]), ("remote", sh["remote"])):
        lab = [t.clone() for t in sh["lab0"]]
        changed = {dev: torch.zeros((), dtype=torch.int32, device=dev)}
        icm_sweep_halo_(lab, *k8, changed, sources=src, **kw)
        runs[tag] = (lab, int(changed[dev]))
    got, n_changed = runs["local"]
    _check(all(torch.equal(a, b) for a, b in zip(got, want))
           and n_changed == int(count),
           f"K8 ({n_phases} phases): labels or count ({n_changed} vs "
           f"{int(count)}) differ from the per-shard route")
    _check(all(torch.equal(a, b) for a, b in zip(runs["remote"][0], got))
           and runs["remote"][1] == n_changed,
           "K8: the remote route differs from the same-device route")
    plain = [t.clone() for t in sh["lab0"]]
    pc = {dev: torch.zeros((), dtype=torch.int32, device=dev)}
    icm_sweep_halo_plain(plain, *k8, pc, **kw)
    _check(all(torch.equal(a, b) for a, b in zip(got, plain))
           and int(pc[dev]) == n_changed,
           "K8: labels or count differ from the plain version")
    work = [t.clone() for t in sh["lab0"]]
    scratch = {dev: torch.zeros((), dtype=torch.int32, device=dev)}
    nbytes, active, valid = _k8_nbytes(sh, n_phases, K)
    out["K8_icm_sweep_halo"] = dict(
        max_abs_err=0.0, bitwise_chained=True, bitwise_remote=True,
        changed=n_changed,
        **_timed(lambda: icm_sweep_halo_(work, *k8, scratch,
                                         sources=sh["local"], **kw),
                 lambda: icm_sweep_halo_plain(
                     [t.clone() for t in sh["lab0"]], *k8, scratch, **kw),
                 lambda: icm_sweep_halo_chained(sh["lab0"], *k8, **kw)),
        unit=f"{n_phases} phase(s) of {n_shards} shards of {heights[0]} x "
             f"{W}, one launch",
        launches_per_unit=1, cooperative_grid=grid8,
        tolerance="identical labels and changed count (per-shard route, "
                  "remote route, plain)",
        active_pixels=active, valid_active_pixels=valid, nbytes=nbytes,
        ops=OPS_ICM * K * valid, shards=[n_shards, heights[0], W])
    return out


def _k8_nbytes(sh, n_phases, K):
    """(bytes, pixels, valid pixels) of K8's unit from phase 0 on the
    shards ``sh``: what the run's data needs. Every label of the slabs is
    read once, the mask of the pixels the phases update; each valid one
    reads its K unary values and its 8 edge weights (an edge weight is read
    by one pixel of a phase: its own or its neighbour's, never both) and
    writes its label."""
    import torch

    px = active = valid = 0
    for lab, m, r0 in zip(sh["lab0"], sh["mask_i"], sh["row0"]):
        H, W = lab.shape[-2:]
        rows = (torch.arange(H, device=lab.device) + r0) % 2
        cols = torch.arange(W, device=lab.device) % 2
        sel = (2 * rows[:, None] + cols[None, :]) < n_phases
        px += H * W
        active += int(sel.sum())
        valid += int(((m[0] != 0) & sel).sum())
    return 4 * px + 4 * active + valid * (4 * K + 32 + 4), active, valid


def check_split(x, mesh, beta=1.0):
    """The split identities over the mesh's shards, bitwise: K7 over the
    shards equals one K1 sweep of the whole grid, K8 with the global
    parity each phase of the phase kernel (its changed count that of the
    labels), K1's 8 sweeps and K2's sweep pair on 8-row halos (the spatial
    E-step's slabs) those of the whole grid; and K1 on shard 1's slab
    bitwise the chained kernel for every n_inner."""
    import torch

    from phylo_hmrf_tpu_torch.ops.halo_rows import row_sources
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (
        icm_phase_, icm_sweep_halo_, icm_sweep_pair)
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        mf_sweeps, mf_sweeps_chained, mf_sweeps_halo)
    from phylo_hmrf_tpu_torch.parallel.halo import HALO, _center, extend_rows

    Hl = x["unary_k"].shape[-2] // mesh.size
    lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32).contiguous()

    def shards(t):
        return [c.contiguous() for c in torch.chunk(t, mesh.size, dim=-2)]
    src = row_sources(list(mesh.devices), [Hl] * mesh.size)
    row0 = [i * Hl for i in range(mesh.size)]
    w_ext = extend_rows(shards(x["w"]))
    full = mf_sweeps(x["q0"], x["base"], x["w"], 1.0, 0.5, beta, n_inner=1)
    split = torch.cat(mf_sweeps_halo(shards(x["q0"]), shards(x["base"]),
                                     w_ext, 1.0, 0.5, beta, n_sweeps=1,
                                     sources=src), dim=-2)
    _check(torch.equal(split, full), "K7 on the shards != one K1 sweep")
    phases_equal = 0
    dev = lab0.device
    for phase, (a, b) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        full = icm_phase_(lab0.clone(), x["unary_k"], x["w"], x["mask_i"],
                          beta, a, b)
        lab = [t.clone() for t in shards(lab0)]
        changed = {dev: torch.zeros((), dtype=torch.int32, device=dev)}
        icm_sweep_halo_(lab, shards(x["unary_k"]), w_ext,
                        shards(x["mask_i"]), beta, changed, row0=row0,
                        sources=src, phase0=phase, n_phases=1)
        _check(torch.equal(torch.cat(lab, dim=1), full)
               and int(changed[dev]) == int((full != lab0).sum()),
               f"K8 phase ({a}, {b}) on the shards != the K2 phase")
        phases_equal += 1

    mf = (1.0, 0.5, beta)
    full = mf_sweeps(x["q0"], x["base"], x["w"], *mf, n_inner=8)
    slabs = list(zip(*(extend_rows(shards(x[k]), HALO)
                       for k in ("q0", "base", "w"))))
    split = torch.cat([_center(mf_sweeps(*sl, *mf, n_inner=8), HALO)
                       for sl in slabs], dim=-2)
    _check(torch.equal(split, full), "K1 on 8-row halos != the whole grid")
    for n_inner in range(1, 9):
        _check(torch.equal(mf_sweeps(*slabs[1], *mf, n_inner=n_inner),
                           mf_sweeps_chained(*slabs[1], *mf,
                                             n_inner=n_inner)),
               f"K1 on a 10 kb slab, {n_inner} sweeps: not bitwise the "
               "chained kernel")
    full = icm_sweep_pair(lab0, x["unary_k"], x["w"], x["mask_i"], beta)
    split = torch.cat([
        _center(icm_sweep_pair(*sl, beta, row_offset=i * Hl - HALO), HALO)
        for i, sl in enumerate(zip(*(extend_rows(shards(t), HALO) for t in (
            lab0, x["unary_k"], x["w"], x["mask_i"]))))], dim=-2)
    _check(torch.equal(split, full), "K2 on 8-row halos != the whole grid")
    torch.cuda.synchronize()
    return dict(k7_split_equals_k1=True,
                k8_split_equals_k2_phases=phases_equal,
                k1_8row_halos_equal_whole=True,
                k2_8row_halos_equal_whole=True,
                k1_slab_bitwise_chained="n_inner 1..8",
                slab=list(slabs[1][0].shape[-2:]),
                grid=list(x["unary_k"].shape[-2:]))


def _device_busy_s(fn):
    """Seconds of device kernel time in one run of ``fn`` under
    ``torch.profiler`` (the kernels of one stream do not overlap), the
    kernel count, and {kernel name: [device us, count]}. Fails when the
    profiler records no device event, so no profiled number goes missing
    silently (``launch_counts`` says when it does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us, n, by_name = 0.0, 0, {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            busy_us += e.self_device_time_total
            n += 1
            v = by_name.setdefault(e.name, [0.0, 0])
            v[0] += e.self_device_time_total
            v[1] += 1
    _check(n > 0 and busy_us > 0, "torch.profiler recorded no device event")
    return busy_us * 1e-6, n, by_name


def check_spatial_estep(x, img, dmaps, means, covs, mesh):
    """The row-sharded E-step of the 10 kb region over the mesh against the
    single-device `_estep_bucket` on the same inputs (the gates of
    `_compare_estep`), then repeated: bitwise equal."""
    import torch

    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket
    from phylo_hmrf_tpu_torch.parallel.halo import make_rowsharded_estep

    fn = make_rowsharded_estep(mesh, weighted_pp=False, max_sweeps=60)

    def timed(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    single, t_single = timed(lambda: _estep_bucket(
        img[None], x["mask"], dmaps[None], x["warm"], means, covs, 1.0, 0.5,
        weighted_pp=False, max_sweeps=60))
    args = (img, x["mask"][0], dmaps, x["warm"][0], means, covs, 1.0, 0.5)
    spatial, t_spatial = timed(lambda: fn(*args))
    rec = _compare_estep(
        ([spatial[0]], [s[None] for s in spatial[1]], spatial[2][None]),
        ([single[0][0]], single[1], single[2]), [x["mask"][0]],
        "spatial E-step")
    again, t_again = timed(lambda: fn(*args))
    _check(torch.equal(again[0], spatial[0])
           and torch.equal(again[2], spatial[2])
           and all(torch.equal(a, b) for a, b in zip(again[1], spatial[1])),
           "the spatial E-step is not bitwise repeatable")
    rec.update(single_s=t_single, spatial_s=min(t_spatial, t_again),
               spatial_first_s=t_spatial, bitwise_repeat=True,
               shape=list(img.shape), digests=_estep_digests(spatial))
    # device busy time under the profiler; the idle share is taken
    # against the unprofiled wall (the profiler inflates host time)
    for name, f, wall in (
            ("single", lambda: _estep_bucket(
                img[None], x["mask"], dmaps[None], x["warm"], means, covs,
                1.0, 0.5, weighted_pp=False, max_sweeps=60), t_single),
            ("spatial", lambda: fn(*args), rec["spatial_s"])):
        busy, n, _ = _device_busy_s(f)
        rec[f"{name}_device_busy_s"] = busy
        rec[f"{name}_device_kernels"] = n
        rec[f"{name}_idle_share"] = max(0.0, 1.0 - busy / wall)
    return rec


def check_region_estep(mesh, device, seeds=(0, 1, 2, 3)):
    """The region-sharded E-step of a bucket of chr21 regions (seeds 0-3,
    the moments of seed 0) over the mesh against the single-device bucket:
    identical labels, stats and costs rtol 1e-6; says whether bitwise."""
    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket
    from phylo_hmrf_tpu_torch.parallel import sharding
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    probs = [chr21_problem(s) for s in seeds]
    _, _, means, covs, _, _ = probs[0]
    img = np.stack([p[1].img for p in probs])
    mask = np.stack([p[1].mask for p in probs])
    dmaps = np.stack([p[1].dmaps for p in probs])
    warm = np.stack([p[1].labels_to_grid(p[4]) for p in probs])
    mt, ct = (torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in (means, covs))
    kw = dict(weighted_pp=False, max_sweeps=60)

    def dev(a):
        return torch.as_tensor(a, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = _estep_bucket(dev(img), dev(mask), dev(dmaps), dev(warm), mt,
                           ct, 1.0, 0.5, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pimg, pmask, pdmaps, R = sharding.pad_bucket_to_devices(
        img, mask, dmaps, mesh.size)
    pwarm = np.concatenate([warm, np.zeros((pimg.shape[0] - R,)
                                           + warm.shape[1:], np.int32)])
    placed = sharding.device_put_bucket(mesh, pimg, pmask, pdmaps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sharded = sharding.make_sharded_estep(mesh, **kw)(
        *placed, dev(pwarm), mt, ct, 1.0, 0.5)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    _check(torch.equal(sharded[0][:R], single[0]),
           "region-sharded labels differ from the single-device bucket")
    for a, b in zip(sharded[1], single[1]):
        _check(torch.allclose(a[:R], b, rtol=1e-6, atol=0),
               f"region-sharded stats differ: {_max_abs(a[:R], b)}")
    _check(torch.allclose(sharded[2][:R], single[2], rtol=1e-6, atol=0),
           "region-sharded costs differ")
    bitwise = (all(torch.equal(a[:R], b) for a, b in zip(sharded[1],
                                                         single[1]))
               and torch.equal(sharded[2][:R], single[2]))
    return dict(regions=R, single_s=t1 - t0, sharded_s=t3 - t2,
                bitwise=bitwise, shape=list(img.shape))


def offdiag_block():
    """The spatial fit's 20 x 653 off-diagonal block of seed 0, padded to
    24 x 768: 6-row shards over 4, the K7/K8 branch."""
    from phylo_hmrf_tpu_torch.synth import synteny_problem

    return synteny_problem(0, 20, 653, False, pad_h=8)


def spatial_problem(max_iter=3):
    """The spatial fit's problem: the chr21 region (672 rows: 168-row
    shards over 4, the deep-halo K1/K2 branch) and a 20 x 653 off-diagonal
    block of the same seed (24 rows: 6-row shards, the K7/K8 branch), the
    default config in ``shard_mode="spatial"``. Returns (tree, regions,
    config, truth)."""
    import numpy as np

    from phylo_hmrf_tpu_torch import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    tree, diag, _, _, _, true_d = chr21_problem(0)
    _, off, _, _, _, true_o = offdiag_block()
    cfg = PhyloHMRFConfig(n_states=10, max_iter=max_iter, seed=0,
                          shard_mode="spatial")
    _check(cfg.final_polish and cfg.polish_method == "expansion",
           "the default config no longer polishes with expansion moves")
    return tree, [diag, off], cfg, np.concatenate([true_d, true_o])


def spatial_fit(mesh, device, max_iter=3):
    """The default config over the mesh in ``shard_mode="spatial"`` on
    `spatial_problem`. Its first E-step is held against the single-device
    E-step from the same state, then it fits. Returns (result, model,
    launches (the fit's, and KM's in the probe's init), grids, E-step
    record, truth, the state it started from)."""
    from phylo_hmrf_tpu_torch import PhyloHMRF
    from phylo_hmrf_tpu_torch.convert import export_state, import_state
    from phylo_hmrf_tpu_torch.ops.kmeans import kmeans

    tree, regions, cfg, truth = spatial_problem(max_iter)
    probe = PhyloHMRF(tree, regions, cfg, mesh=mesh)
    _check(probe._spatial, "the meshed model is not in spatial mode")
    km0 = kmeans.kernel_launches
    probe.initialize()
    km_launches = kmeans.kernel_launches - km0
    state = export_state(probe)
    single = PhyloHMRF(tree, regions, cfg, device=device)
    import_state(single, state)
    got = probe.estep(probe.means_, probe.covars_, probe.labels_local)
    want = single.estep(single.means_, single.covars_, single.labels_local)
    rec = _compare_estep(got, want, [r.mask for r in regions],
                         "spatial fit's first E-step")
    rec["shard_rows"] = [r.shape[0] // mesh.size for r in regions]
    run = fit_model(tree, regions, cfg, mesh=mesh, state=state)
    return (run.res, run.model, dict(run.launches, KM_kmeans=km_launches),
            run.grids, rec, truth, state)


CLI_FLAGS = ["-n", "10", "-p", "input", "--chromvec", "21", "--miter", "5",
             "--seed", "0", "--output", "out", "--checkpoint", "ck.npz",
             "--checkpoint_every", "2", "--run_json", "run.json"]


def check_cli():
    """``[cli]`` and ``[resume]``: the command line at chr21 scale in a
    fresh temporary working directory, with the launch counters set to 0
    just before ``cli.main`` and read just after, then the resumed rerun
    in a subprocess. Returns the launches of the command line's fit."""
    import numpy as np
    import scipy.io
    import torch

    from phylo_hmrf_tpu_torch import cli, native
    from phylo_hmrf_tpu_torch.data import filters
    from phylo_hmrf_tpu_torch.ops.kmeans import kmeans
    from phylo_hmrf_tpu_torch.synth import CHR21_H0, write_example

    n_samples = CHR21_H0 * (CHR21_H0 + 1) // 2
    work = tempfile.mkdtemp(prefix="phmrf_cli_")
    cwd = os.getcwd()
    os.chdir(work)   # chrom_quantile_test.txt lands here
    try:
        t0 = time.perf_counter()
        write_example("input", n_bins=CHR21_H0 + 4, n_states=10,
                      chroms=(21,), seed=0)
        write_s = time.perf_counter() - t0
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        in_graphs = _graph_kernels()
        fills = filters.hole_fill.calls
        km0 = kmeans.kernel_launches
        t0 = time.perf_counter()
        out_file = cli.main(CLI_FLAGS)
        wall = time.perf_counter() - t0
        launches = _add_graph_kernels(
            {k: fn.launches for k, fn in counters.items()}, in_graphs)
        launches["KM_kmeans"] = kmeans.kernel_launches - km0
        fills = filters.hole_fill.calls - fills
        for name in list(KERNELS)[:6]:
            _check(launches[name] > 0,
                   f"{name} never launched on the command line's path")
        _check(fills == 4, f"{fills} C++ hole fills, expected one a species")
        mat = scipy.io.loadmat(out_file)
        for key in ("state_vec", "len_vec", "params_vec1", "params_vec2",
                    "iter_id1", "iter_id2", "cost_vec"):
            _check(key in mat, f".mat lacks {key}")
        cv = mat["cost_vec"]
        _check(int(mat["len_vec"][0, 0]) == n_samples,
               f"len_vec {mat['len_vec'][0, 0]} samples, not {n_samples}")
        _check(mat["state_vec"].size == n_samples, "state_vec size")
        _check(cv.shape == (5, 4) and np.isfinite(cv).all(),
               f"cost_vec {cv.shape} not 5 finite rows")
        _check(np.allclose(cv[:, 3], cv[:, 1] + cv[:, 2], rtol=1e-6, atol=0),
               "cost1 != pairwise + unary")
        with open("run.json") as f:
            doc = json.load(f)
        env = doc["environment"]
        _check(env["backend"] == "cuda", f"run.json backend {env}")
        _check(env["device_kind"] == torch.cuda.get_device_name(0),
               f"run.json device_kind {env}")
        _check(os.path.exists("ck.npz") and os.path.exists("ck.npz.hist"),
               "no checkpoint written")
        rec = dict(wall_s=wall, write_input_s=write_s,
                   walls_s=doc["walls_s"], phases=doc["phase_timings"],
                   launches=launches,
                   hole_fill=dict(route="C++ (native/gridops.cc)",
                                  calls=fills,
                                  library=os.path.basename(native.build())),
                   n_samples=doc["n_samples"], x_max=doc["x_max"],
                   hbm_peak_bytes=doc["hbm_peak_bytes"], environment=env,
                   cost_vec=cv.tolist())
        print(f"[cli] {json.dumps(rec)}")

        with open("ck.npz.hist", "ab") as f:
            f.write(b"garbage: the tail of a save that never finished")
        env_vars = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "phylo_hmrf_tpu_torch.cli", *CLI_FLAGS,
             "--reload", "1"], cwd=work, env=env_vars, capture_output=True,
            text=True, timeout=600)
        resume_s = time.perf_counter() - t0
        _check(proc.returncode == 0, f"the resumed run exited {proc.returncode}"
                                     f":\n{proc.stderr[-3000:]}")
        _check("[resume] from iter 4" in proc.stdout,
               f"no '[resume] from iter 4':\n{proc.stdout[-3000:]}")
        _check("cache missing" not in proc.stdout, "the cache was not read")
        mat2 = scipy.io.loadmat(out_file)
        for key in ("cost_vec", "state_vec"):
            _check(np.array_equal(mat2[key], mat[key]),
                   f"resumed {key} differs from the uninterrupted run's")
        with open("run.json") as f:
            doc2 = json.load(f)
        rec = dict(wall_s=resume_s, walls_s=doc2["walls_s"],
                   phases=doc2["phase_timings"],
                   stdout=[ln for ln in proc.stdout.splitlines()
                           if ln.startswith(("[resume]", "[iter", "x_max"))],
                   bitwise=["cost_vec", "state_vec"])
        print(f"[resume] {json.dumps(rec)}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return launches


def check_bucket(dev, seeds=(0, 1)):
    """``[bucket]``: on the kernel route, one E-step of a bucket of two
    chr21 regions (seeds 0 and 1 of ``chr21_problem``, seed 0's moments)
    against each region's own one-region E-step: labels, per-region
    statistics, cost rows and valid counts bitwise — what the
    multi-process fit's parity with one process rests on."""
    import numpy as np
    import torch

    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    probs = [chr21_problem(s) for s in seeds]
    means, covs = probs[0][2], probs[0][3]
    regions = [p[1] for p in probs]

    def stack(arrays, dtype):
        return torch.as_tensor(np.stack(arrays), dtype=dtype, device=dev)

    img = stack([r.img for r in regions], torch.float32)
    mask = stack([r.mask for r in regions], torch.bool)
    dmaps = stack([r.dmaps for r in regions], torch.float32)
    warm = stack([r.labels_to_grid(p[4]) for r, p in zip(regions, probs)],
                 torch.int32)
    mt, ct = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (means, covs))
    counters = _counters()

    def run(sl):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _estep_bucket(img[sl], mask[sl], dmaps[sl], warm[sl], mt, ct,
                            1.0, 0.5, weighted_pp=False, max_sweeps=60)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            k: fn.launches - before[k] for k, fn in counters.items()
            if fn.launches > before[k]}

    (lab2, st2, c2, n2), bucket_s, launches = run(slice(None))
    for name in list(KERNELS)[:4]:
        _check(_ran(launches, name),
               f"[bucket]: {name} not launched by the bucket's E-step")
    single_s = []
    for i in range(len(seeds)):
        (lab1, st1, c1, n1), t, _ = run(slice(i, i + 1))
        single_s.append(t)
        _check(torch.equal(lab2[i], lab1[0]),
               f"[bucket]: region {i}'s labels differ in the bucket")
        _check(all(torch.equal(a[i], b[0]) for a, b in zip(st2, st1)),
               f"[bucket]: region {i}'s statistics differ in the bucket")
        _check(torch.equal(c2[i], c1[0]) and torch.equal(n2[i], n1[0]),
               f"[bucket]: region {i}'s cost row differs in the bucket")
    return dict(regions=len(seeds), shape=list(regions[0].shape),
                samples=[r.n_samples for r in regions], bitwise=True,
                bucket_s=bucket_s, single_s=single_s, launches=launches)


# the [multiproc] command line: the chr21+chr22 input, 5 iterations
MULTIPROC_FLAGS = ["-n", "10", "--chromvec", "21,22", "--miter", "5",
                   "--seed", "0", "--output", "out", "--run_json",
                   "run.json"]
MULTIPROC_NAME = "estimate_ou_0_1.00_10.mat"


def cli_rank_main(argv) -> int:
    """The body of ``--cli-rank ARGS``: one process of ``[multiproc]``.
    Sets the launch counters to 0, runs ``cli.main(ARGS)`` and prints one
    ``[rank]`` JSON line: the launches, the wall, the fit's wall and phase
    timings (its ``PhyloHMRF.fit`` wrapped here), the collective calls of
    ``parallel/multiproc.py`` and their seconds (its ``_collective``
    wrapped here), the regions and samples and the peak device memory."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch import cli
    from phylo_hmrf_tpu_torch.models.hmrf import PhyloHMRF
    from phylo_hmrf_tpu_torch.parallel import multiproc

    calls = []
    collective = multiproc._collective

    def counted(fn, *args):
        t0 = time.perf_counter()
        try:
            return collective(fn, *args)
        finally:
            calls.append(time.perf_counter() - t0)
    multiproc._collective = counted
    rec = {}
    fit = PhyloHMRF.fit

    def timed_fit(self, *args, **kw):
        t0 = time.perf_counter()
        res = fit(self, *args, **kw)
        rec.update(fit_s=time.perf_counter() - t0,
                   phases=self.timer.summary(),
                   n_regions=len(self.regions), n_samples=self.n_samples)
        return res
    PhyloHMRF.fit = timed_fit
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    in_graphs = _graph_kernels()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_file = cli.main(argv)
    wall = time.perf_counter() - t0
    rec.update(wall_s=wall, out_file=out_file,
               launches=_add_graph_kernels(
                   {k: fn.launches for k, fn in counters.items()}, in_graphs),
               collective_calls=len(calls), collective_s=sum(calls),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"[rank] {json.dumps(rec)}")
    return 0


def _rank_record(what, proc_out, tag="[rank]"):
    """The ``tag`` JSON line of a rank process (``--cli-rank``:
    ``[rank]``, ``--xmesh-rank``: ``[xrank]``), or a failure."""
    rc, out, err = proc_out
    _check(rc == 0, f"{what} exited {rc}:\n{out[-2000:]}{err[-3000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    _check(len(lines) == 1, f"{what} printed no {tag} line:\n{out[-2000:]}")
    return json.loads(lines[0][len(tag) + 1:])


def check_multiproc(timeout=600):
    """``[multiproc]``: the command line on the chr21+chr22 input (two
    653 x 653 regions, 427,062 samples) once as one process, then as two
    processes sharing the card (gloo on localhost,
    PHMRF_COLLECTIVE_TIMEOUT_S=300), each a fresh ``--cli-rank``
    process. Checks: every process exits 0, each rank launches K1-K6,
    one merged .mat at the top level, len_vec and state_vec equal to the
    single run's, cost_vec within rtol 1e-7 / atol 1e-9, params_vec1
    within rtol 1e-6, cost1 == pairwise + unary in each row; bitwise
    equality is reported."""
    import socket

    import numpy as np
    import scipy.io

    from phylo_hmrf_tpu_torch.synth import CHR21_H0, write_example

    work = tempfile.mkdtemp(prefix="phmrf_mp_")
    procs = []
    try:
        t0 = time.perf_counter()
        write_example(os.path.join(work, "input"), n_bins=CHR21_H0 + 4,
                      n_states=10, chroms=(21, 22), seed=0)
        write_s = time.perf_counter() - t0
        base = [sys.executable, os.path.abspath(__file__), "--cli-rank",
                "-p", os.path.join(work, "input"), *MULTIPROC_FLAGS]
        env = dict(os.environ, PHMRF_COLLECTIVE_TIMEOUT_S="300")
        runs = {}
        for name, n in (("single", 1), ("multi", 2)):
            cwd = os.path.join(work, name)
            os.makedirs(cwd)
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            extra = [] if n == 1 else [
                "--coordinator", f"127.0.0.1:{port}", "--num_processes",
                str(n)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                base + extra + ([] if n == 1 else ["--process_id", str(i)]),
                cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for i in range(n)]
            outs = []
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                outs.append((p.returncode, out, err))
            wall = time.perf_counter() - t0
            ranks = [_rank_record(f"{name} process {i}", o)
                     for i, o in enumerate(outs)]
            runs[name] = dict(wall_s=wall, ranks=ranks)
        for i, rank in enumerate(runs["multi"]["ranks"]):
            for k in list(KERNELS)[:6]:
                _check(rank["launches"][k] > 0,
                       f"[multiproc]: rank {i} never launched {k}")
            _check(rank["collective_calls"] > 0,
                   f"[multiproc]: rank {i} made no collective call")
        _check(runs["multi"]["ranks"][1]["out_file"] == "",
               "[multiproc]: rank 1 wrote a result")
        mats = sorted(os.path.relpath(os.path.join(d, f), work)
                      for d, _, fs in os.walk(os.path.join(work, "multi"))
                      for f in fs if f.endswith(".mat"))
        _check(mats == [os.path.join("multi", "out", MULTIPROC_NAME)],
               f"[multiproc]: merged .mat files {mats}")
        s, m = (scipy.io.loadmat(os.path.join(work, name, "out",
                                              MULTIPROC_NAME))
                for name in ("single", "multi"))
        _check(np.array_equal(m["len_vec"], s["len_vec"]),
               "[multiproc]: len_vec differs from the single run's")
        n_samples = int(s["len_vec"][:, 0].sum())
        _check(n_samples == 2 * CHR21_H0 * (CHR21_H0 + 1) // 2,
               f"[multiproc]: {n_samples} samples")
        _check(np.array_equal(m["state_vec"], s["state_vec"]),
               f"[multiproc]: state_vec differs from the single run's in "
               f"{int((m['state_vec'] != s['state_vec']).sum())} samples")
        _check(np.allclose(m["cost_vec"], s["cost_vec"], rtol=1e-7,
                           atol=1e-9),
               f"[multiproc]: cost_vec {m['cost_vec']} vs {s['cost_vec']}")
        _check(np.allclose(m["params_vec1"], s["params_vec1"], rtol=1e-6,
                           atol=0),
               "[multiproc]: params_vec1 differs beyond rtol 1e-6")
        for mat in (s, m):
            cv = mat["cost_vec"]
            _check(cv.shape == (5, 4) and np.isfinite(cv).all(),
                   f"[multiproc]: cost_vec {cv.shape}")
            _check(np.allclose(cv[:, 3], cv[:, 1] + cv[:, 2], rtol=1e-6,
                               atol=0), "[multiproc]: cost1 != pairwise + "
                                        "unary")
        with open(os.path.join(work, "multi", "run.json")) as f:
            doc = json.load(f)
        _check(doc["config"]["num_processes"] == 2,
               f"[multiproc]: run.json {doc['config']}")
        for name in ("single", "multi"):
            with open(os.path.join(work, name, "run.json")) as f:
                runs[name]["walls_s"] = json.load(f)["walls_s"]
        rel = {k: float(np.max(np.abs(m[k] - s[k])
                               / np.maximum(np.abs(s[k]), 1e-300)))
               for k in ("cost_vec", "params_vec1")}
        rec = dict(write_input_s=write_s, samples=n_samples,
                   bitwise={k: bool(np.array_equal(m[k], s[k])) for k in (
                       "cost_vec", "params_vec1", "params_vec2",
                       "state_vec", "len_vec")},
                   max_rel=rel, cost_vec=m["cost_vec"].tolist(), **runs)
        print(f"[multiproc] {json.dumps(rec)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    return rec


def xmesh_rank_main(argv) -> int:
    """The body of ``--xmesh-rank PORT PID STATE``: one of the two
    processes of ``[xmesh]``. Joins the gloo group on localhost, meshes
    SHARDS shards over both processes (``make_mesh(..., processes=True)``,
    2 a process, all on the card), then runs the 10 kb spatial E-step of
    ``[spatial_estep]`` three times (the launches and the exchanges of the
    first) and the spatial fit of ``[spatial_fit]`` from its state (the
    pickle STATE), with the launch counters set to 0 just before it and
    read just after. Prints one ``[xrank]`` JSON line: the digests of
    both, walls, phase walls, exchanges and all-gathers per E-step (calls,
    bytes, seconds), launches and peak device memory."""
    import pickle

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch.models.hmrf import PhyloHMRF
    from phylo_hmrf_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from phylo_hmrf_tpu_torch.parallel.halo import make_rowsharded_estep
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    port, pid, state_path = argv
    t_start = time.perf_counter()
    initialize_distributed(f"127.0.0.1:{port}", 2, int(pid))
    try:
        mesh = make_mesh((SHARDS,), processes=True)
        dev = mesh.first_device
        counters = _counters()
        torch.cuda.reset_peak_memory_stats()
        rec = dict(rank=mesh.rank, mesh=mesh.describe(),
                   join_s=time.perf_counter() - t_start)

        # the 10 kb spatial E-step on the inputs of [spatial_estep]
        t0 = time.perf_counter()
        _, r10, m10, c10, w10, _ = chr21_problem(0, h0=3264)
        x10 = kernel_inputs(r10, m10, c10, w10, dev)
        img10 = torch.as_tensor(r10.img, device=dev)
        dmaps10 = torch.as_tensor(r10.dmaps, device=dev)
        m10t, c10t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (m10, c10))
        args = (img10, x10["mask"][0], dmaps10, x10["warm"][0], m10t, c10t,
                1.0, 0.5)
        inputs_s = time.perf_counter() - t0
        fn = make_rowsharded_estep(mesh, weighted_pp=False, max_sweeps=60)
        walls, digests = [], []
        for rep in range(3):
            for c in counters.values():
                c.launches = 0
            before = _traffic()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            digests.append(_estep_digests(out))
            if rep == 0:
                traffic = _traffic_since(before)
                launches = {k: c.launches for k, c in counters.items()}
        _check(all(d == digests[0] for d in digests),
               f"[xmesh] rank {mesh.rank}: the 10 kb E-step is not bitwise "
               f"repeatable")
        rec["estep"] = dict(inputs_s=inputs_s, walls_s=walls,
                            launches=launches, traffic=traffic,
                            digests=digests[0], shape=list(img10.shape))
        del x10, img10, dmaps10, args, out
        torch.cuda.empty_cache()

        # the spatial fit of [spatial_fit], from its state
        with open(state_path, "rb") as f:
            state = pickle.load(f)
        tree, regions, cfg, _ = spatial_problem()
        estep = PhyloHMRF.estep
        per_estep = []

        def counted(self, *a, **kw):
            before = _traffic()
            try:
                return estep(self, *a, **kw)
            finally:
                per_estep.append(_traffic_since(before))
        PhyloHMRF.estep = counted
        t0 = time.perf_counter()
        run = fit_model(tree, regions, cfg, mesh=mesh, state=state)
        fit_s = time.perf_counter() - t0
        PhyloHMRF.estep = estep
        for e, t in zip(run.esteps, per_estep):
            e["traffic"] = t
        rec["fit"] = dict(fit_s=fit_s, n_iters=run.res.n_iters,
                          phases=run.model.timer.summary(),
                          launches=run.launches, esteps=run.esteps,
                          digests=_fit_digests(run.res, run.grids))
        total = _traffic()
        rec.update(traffic=total, collective_s=sum(
            t["seconds"] for t in total.values()),
            wall_s=time.perf_counter() - t_start,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[xrank] {json.dumps(rec)}")
    finally:
        dist.destroy_process_group()
    return 0


def check_xmesh(estep_rec, fit_res, fit_grids, state, one_process,
                timeout=600):
    """``[xmesh]``: the mesh that spans processes. Two fresh
    ``--xmesh-rank`` processes share the card (gloo on localhost,
    PHMRF_COLLECTIVE_TIMEOUT_S=300), SHARDS / 2 shards each, and run the
    10 kb spatial E-step and the spatial fit of this process's
    ``[spatial_estep]`` and ``[spatial_fit]`` (the one-process mesh of
    SHARDS shards). Checks: both exit 0; each one's E-step labels,
    statistics and costs and its fit's cost rows, iteration labels,
    polished labels and params have the SHA-256 of the one-process run's
    (``estep_rec["digests"]``, ``fit_res`` / ``fit_grids``), so both
    ranks are identical too; each rank's E-step launched K1-K4 and its
    fit K1-K8, and both exchanged rows. Prints the ranks' records beside
    ``one_process`` (its walls)."""
    import pickle
    import socket

    work = tempfile.mkdtemp(prefix="phmrf_xmesh_")
    procs = []
    try:
        state_path = os.path.join(work, "state.pkl")
        with open(state_path, "wb") as f:
            pickle.dump(state, f)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PHMRF_COLLECTIVE_TIMEOUT_S="300")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--xmesh-rank",
             str(port), str(i), state_path], cwd=work, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        outs = [p.communicate(timeout=timeout) for p in procs]
        wall = time.perf_counter() - t0
        ranks = [_rank_record(f"[xmesh] process {i}",
                              (p.returncode, *o), tag="[xrank]")
                 for i, (p, o) in enumerate(zip(procs, outs))]
        want_fit = _fit_digests(fit_res, fit_grids)
        for i, r in enumerate(ranks):
            for what, got, want in (
                    ("10 kb E-step", r["estep"]["digests"],
                     estep_rec["digests"]),
                    ("spatial fit", r["fit"]["digests"], want_fit)):
                bad = sorted(k for k in want if got.get(k) != want[k])
                _check(not bad, f"[xmesh] rank {i}: {what} differs from "
                                f"the one-process mesh's in {bad}")
            for k in list(KERNELS)[:4]:
                _check(r["estep"]["launches"][k] > 0,
                       f"[xmesh] rank {i}: the 10 kb E-step never "
                       f"launched {k}")
            # KM is the init's, which a fit from a state skips
            for k in list(KERNELS)[:-1]:
                _check(r["fit"]["launches"][k] > 0,
                       f"[xmesh] rank {i}: the spatial fit never launched "
                       f"{k}")
            _check(r["estep"]["traffic"]["exchange"]["calls"] > 0
                   and r["traffic"]["exchange"]["calls"]
                   > r["estep"]["traffic"]["exchange"]["calls"],
                   f"[xmesh] rank {i}: no rows exchanged")
        rec = dict(wall_s=wall, bitwise=True, ranks=ranks,
                   one_process=one_process)
        print(f"[xmesh] {json.dumps(rec)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch import PhyloHMRFConfig, _build
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.ops.kmeans import kmeans
    from phylo_hmrf_tpu_torch.ops.maxflow import _start_batch
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mean_field_kmajor
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{nvcc[-1] if nvcc else ''}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.1f}s "
          f"(nvcc {_build.build_seconds}) -> {os.path.relpath(path, REPO)}")
    entry = None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"entry function\W+(\w+)", line)
            entry = m.group(1) if m else line.strip()
        elif ("Used" in line or "spill" in line) and entry:
            print(f"[ptxas] {entry}: {line.split(':', 1)[-1].strip()}")

    tree, region, means, covs, warm, true = chr21_problem(0)
    x = kernel_inputs(region, means, covs, warm, dev)
    print(f"[shapes] unary_k {tuple(x['unary_k'].shape)} "
          f"img_f {tuple(x['img_f'].shape)} samples {region.n_samples}")
    K = means.shape[0]
    kernels = check_kernels(x)
    # K1-K4 at K = 30: a scale point, no path of this run reaches it
    x30 = k30_inputs(dev)
    lab30 = mean_field_kmajor(x30["unary_k"], x30["w"], 1.0)
    for name, k in (("K1_mf_sweep", check_k1(x30)),
                    ("K2_icm_phase", check_k2(x30)),
                    ("K3_potts_energy", check_k3(x30, lab30)),
                    ("K4_finish_stats", check_k4(x30))):
        k = kernels[name]["at_k30"] = _with_bound(k)
        print(_point_line(f"{name} at K=30", k))
    del x30, lab30
    mincut, cut, start = check_mincut(x, K)
    kernels.update(mincut)
    print(f"[mincut] {json.dumps(cut)}")
    dmaps = torch.as_tensor(region.dmaps[None], device=dev)
    mt, ct = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (means, covs))
    print(f"[estep] {json.dumps(check_estep(x, dmaps, mt, ct))}")
    print(f"[bucket] {json.dumps(check_bucket(dev))}")

    cycles = PhyloHMRFConfig().swap_tpu_cycles     # the fit's polish
    oracle = check_oracle(x, region, start, K, cycles)
    print(f"[oracle] {json.dumps(oracle)}")
    # K = 20 on the [host_swap] region (the C++ side stays at seconds)
    _, r20, m20, c20, w20, _ = chr21_problem(0, K=20, h0=HOST_SWAP_H0)
    x20 = kernel_inputs(r20, m20, c20, w20, dev)
    start20 = _start_batch(x20["unary_k"], x20["w"], x20["mask"],
                           x20["warm"], 1.0, 60)
    oracle20 = check_oracle(x20, r20, start20, 20, cycles)
    print(f"[oracle] K=20 {json.dumps(oracle20)}")
    del x20, start20

    km_rec, kernels["KM_kmeans"] = kmeans_row(torch.as_tensor(
        region.flat_values(), dtype=torch.float32, device=dev), K)
    print(f"[kmeans] {json.dumps(km_rec)}")
    print(_point_line("KM_kmeans", kernels["KM_kmeans"]))

    # the main path: the default single-device fit
    kmeans.kernel_launches = 0
    t0 = time.perf_counter()
    run = fit_model(tree, [region],
                    PhyloHMRFConfig(n_states=10, max_iter=5, seed=0),
                    device=dev)
    fit_s = time.perf_counter() - t0
    run.launches["KM_kmeans"] = kmeans.kernel_launches
    _check(run.launches["KM_kmeans"] == 2,
           f"the fit's init launched KM {kmeans.kernel_launches} times")
    res, model = run.res, run.model
    for name in list(KERNELS)[:6]:
        _check(run.launches[name] > 0,
               f"{name} never launched on the fit's path")
    acc, polish = check_fit(res, model, true, run.grids)
    summ = model.timer.summary()
    em_s = sum(summ[p]["total_s"] for p in ("estep", "mstep") if p in summ)
    fit = dict(n_iters=res.n_iters, fit_s=fit_s, init_s=run.init_s,
               s_per_em_iter=em_s / res.n_iters,
               final_polish_s=summ["final_polish"]["total_s"],
               polish=polish, phases=summ, launches=run.launches,
               best_match_accuracy=acc, cost_vec=res.cost_vec.tolist())
    _check(run.launches["L_lbfgs_ou"] >= res.n_iters,
           f"{run.launches['L_lbfgs_ou']} fused L-BFGS solves in "
           f"{res.n_iters} M-steps")
    fit["rollbacks"] = model._mstep_rollbacks_
    fit_digests = _fit_digests(res, run.grids)
    fit["digests"] = fit_digests
    print(f"[fit] {json.dumps(fit)}")
    print(f"[postprocess] {json.dumps(check_postprocess(res, model, true))}")
    # the pipelined and the sequential EM loop
    pipe, kernels["L_lbfgs_ou"] = check_pipeline(tree, region, run,
                                                 fit_digests, dev)
    pipe["estep_defer"] = estep_queues(model)
    print(f"[pipeline] {json.dumps(pipe)}")
    # every labeler of the port from the [fit] phase's init state, and
    # the host C++ swap against the device swap on a reduced region
    check_labelers(tree, region, run.state, dev)
    for name, k in moves_rows(tree, region, run.state, dev).items():
        kernels[name] = k
        print(_point_line(name, k))
    print(f"[host_swap] {json.dumps(check_host_swap(dev))}")
    # the float64 mode: its fit on the chr21 cell, then its polish against
    # the C++ expansion on the [host_swap] problem
    f64 = check_f64(tree, region, run.state, run.launches, dev)
    print(f"[f64] {json.dumps(f64)}")
    print(f"[f64_oracle] {json.dumps(check_f64_oracle(dev))}")
    # the command line's path: the same fit from files, then its resume
    cli_launches = check_cli()
    # the same command line as one process and as two sharing the card
    check_multiproc()

    # the multi-device paths, over SHARDS shards of the visible cards
    mesh = make_mesh((SHARDS,))
    print(f"[mesh] shards -> devices: {mesh.describe()}")
    # K7/K8 at the shapes the spatial fit gives them: the 4 6-row shards
    # of its off-diagonal block on the card, a temperature's 8 sweeps and
    # a sweep's 4 phases
    _, off, mo, co, wo, _ = offdiag_block()
    kernels.update(check_halo_kernels(kernel_inputs(off, mo, co, wo, dev),
                                      SHARDS, n_sweeps=8, n_phases=4))
    t0 = time.perf_counter()
    _, r10, m10, c10, w10, _ = chr21_problem(0, h0=3264)
    x10 = kernel_inputs(r10, m10, c10, w10, dev)
    print(f"[10kb] region {r10.shape} samples {r10.n_samples} "
          f"made in {time.perf_counter() - t0:.1f}s")
    # the same kernels on the 4 816-row shards of the 10 kb region, one
    # sweep and one phase (the route between devices launches that unit):
    # a scale point, no path of this run launches them at that shape
    for name, k in check_halo_kernels(x10, SHARDS, n_sweeps=1,
                                      n_phases=1).items():
        k = kernels[name]["at_10kb"] = _with_bound(k)
        print(_point_line(f"{name} at 10kb", k))
    # K3 and K4 on the single-device 10 kb E-step's operands: a scale
    # point (the spatial E-step runs them on 818-row slabs)
    lab10 = mean_field_kmajor(x10["unary_k"], x10["w"], 1.0)
    for name, k in (("K3_potts_energy", check_k3(x10, lab10)),
                    ("K4_finish_stats", check_k4(x10))):
        k = kernels[name]["at_10kb"] = _with_bound(k)
        print(_point_line(f"{name} at 10kb", k))
    del lab10
    split = check_split(x10, mesh)
    print(f"[split] {json.dumps(split)}")
    img10 = torch.as_tensor(r10.img, device=dev)
    dmaps10 = torch.as_tensor(r10.dmaps, device=dev)
    m10t, c10t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (m10, c10))
    sp = check_spatial_estep(x10, img10, dmaps10, m10t, c10t, mesh)
    print(f"[spatial_estep] {json.dumps(sp)}")
    del x10, img10, dmaps10
    # the plain versions at 10 kb leave tens of GB in the allocator's
    # cache; give it back before the fits that follow
    torch.cuda.empty_cache()
    reg = check_region_estep(mesh, dev)
    print(f"[region_estep] {json.dumps(reg)}")
    print(f"[mesh_exact] {json.dumps(check_mesh_exact(mesh, dev))}")

    t0 = time.perf_counter()
    sres, smodel, slaunches, sgrids, sest, strue, sstate = spatial_fit(
        mesh, dev)
    sfit_s = time.perf_counter() - t0
    for name in KERNELS:
        _check(slaunches[name] > 0,
               f"{name} never launched on the spatial fit's path")
    sacc, spolish = check_fit(sres, smodel, strue, sgrids)
    ssumm = smodel.timer.summary()
    sfit = dict(n_iters=sres.n_iters, fit_s=sfit_s, first_estep=sest,
                estep_s=ssumm["estep"]["total_s"] / ssumm["estep"]["count"],
                final_polish_s=ssumm["final_polish"]["total_s"],
                polish=spolish, phases=ssumm, launches=slaunches,
                best_match_accuracy=sacc, cost_vec=sres.cost_vec.tolist())
    print(f"[spatial_fit] {json.dumps(sfit)}")
    # the same 10 kb E-step and spatial fit over a mesh whose shards live
    # in two processes sharing the card
    check_xmesh(sp, sres, sgrids, sstate, dict(
        estep_s=sp["spatial_s"], estep_first_s=sp["spatial_first_s"],
        fit_s=sfit_s, phases=ssumm))

    # one kernel launch a call for K3 (both entries) and K4, by the
    # profiler in a fresh process
    counts = launch_counts()
    for point, key, names in (
            ("chr21", None, ("K3_potts_energy", "K4_finish_stats")),
            ("k30", "at_k30", ("K3_potts_energy", "K4_finish_stats")),
            ("10kb", "at_10kb", ("K3_potts_energy", "K4_finish_stats",
                                 "K7_mf_sweeps_halo", "K8_icm_sweep_halo")),
            ("offdiag", None, ("K7_mf_sweeps_halo", "K8_icm_sweep_halo"))):
        for name, entries in (("K3_potts_energy", ("K3", "K3_pair")),
                              ("K4_finish_stats", ("K4",)),
                              ("K7_mf_sweeps_halo", ("K7",)),
                              ("K8_icm_sweep_halo", ("K8",))):
            if name not in names:
                continue
            rec = kernels[name] if key is None else kernels[name][key]
            for entry, field in zip(entries, ("launches_per_unit",
                                              "pair_launches_per_call")):
                n, kernel_names = counts[point][entry]
                _check(n == 1, f"{entry} at {point}: {n} kernel launches a "
                               f"call ({kernel_names})")
                rec[field] = n
                rec.setdefault("kernel_names", kernel_names)
    print(f"[launch_counts] {json.dumps(counts)}")
    rows = []
    for name, (src, replaces) in KERNELS.items():
        k = kernels[name] = _with_bound(kernels[name])
        bound_ms, bound_by = k["bound_ms"], k["bound_by"]
        path_launches = slaunches if name.startswith(("K7", "K8")) else \
            cli_launches
        # units of the timed work per fit, and the ms they lose to the
        # bound: the ranking of the kernels to redesign
        units = path_launches[name] / k["launches_per_unit"]
        lost = units * (k["ms"] - bound_ms)
        print(f"{_point_line(name, k)}; {units:g} units per fit, "
              f"{lost:.1f} ms lost per fit")
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=path_launches[name],
                         graph_loop=("phylo_hmrf_tpu_torch/csrc/loops.cu"
                                     if name in GRAPH_OF else None),
                         in_graph_launches=path_launches.get(
                             f"in_graphs:{name}", 0),
                         max_abs_err=k["max_abs_err"], ms=k["ms"],
                         plain_ms=k["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         unit=k["unit"], call_ms=k["call_ms"],
                         chained_ms=k.get("chained_ms"),
                         launches_per_unit=k["launches_per_unit"],
                         units_per_fit=units, ms_lost_per_fit=lost))
    print(f"[kernels] {json.dumps(kernels)}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--xmesh-rank"]:
        sys.exit(xmesh_rank_main(sys.argv[2:]))
    sys.exit(count_launches_main() if "--count-launches" in sys.argv[1:]
             else main())

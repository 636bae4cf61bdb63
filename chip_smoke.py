#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the six kernels from ``phylo_hmrf_tpu_torch/csrc`` with nvcc (one
process per source, in parallel), holds each against its plain PyTorch
version at the chr21 shapes (R=1, K=10, H=672, W=768, F=4) and times both:
the four E-step kernels on the E-step's operands, the two min-cut kernels
(K5 push-relabel, K6 BFS relabel) on a real expansion-move graph of the
chr21 start labels, and the whole min cut on both paths. Then it checks
one whole E-step on the kernel path against the plain path and for bitwise
determinism, holds the exact expansion polish against the C++ expansion
oracle on the same unary, weights and start, and fits the chr21 problem
(653 x 653 bins, 4 species, K=10, seed 0) for five EM iterations with the
default config (``final_polish=True``, ``polish_method="expansion"``)
through ``PhyloHMRF.fit`` and checks the result. Every phase that fails
raises; the script exits 0 only if all passed.

The second-to-last line of stdout is a JSON object with one entry per
kernel (launches on the fit's main path, max abs error against the plain
version, kernel and plain times in ms); the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 before any
of that.
"""

import json
import os
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
}


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _time_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def check_kernels(x, beta=1.0):
    """Each kernel against its plain version on the same device tensors.
    Returns {kernel: {"max_abs_err", "ms", "plain_ms", "unit"}}."""
    import torch

    from phylo_hmrf_tpu.config import SMALL_EPS
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (
        finish_stats, finish_stats_plain, potts_energy, potts_energy_plain)
    from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_kmajor, icm_sweep_pair
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        mean_field_kmajor, mf_sweeps, mf_sweeps_plain)

    out = {}
    # K1: one temperature's 8 sweeps; tolerance rtol 2e-4, atol 1e-6
    k1 = (x["q0"], x["base"], x["w"], 1.0, 0.5, beta)
    got = mf_sweeps(*k1, n_inner=8)
    want = mf_sweeps_plain(*k1, 8)
    torch.cuda.synchronize()
    _check(torch.allclose(got, want, rtol=2e-4, atol=1e-6),
           f"K1 disagrees: max abs err {_max_abs(got, want)}")
    lab = mean_field_kmajor(x["unary_k"], x["w"], beta)
    lab_p = mean_field_kmajor(x["unary_k"], x["w"], beta, plain=True)
    agree = float((lab == lab_p).float().mean())
    _check(agree > 0.999, f"K1 mean-field labels agree on only {agree}")
    out["K1_mf_sweep"] = dict(
        max_abs_err=_max_abs(got, want), label_agreement=agree,
        ms=_time_ms(lambda: mf_sweeps(*k1, n_inner=8)),
        plain_ms=_time_ms(lambda: mf_sweeps_plain(*k1, 8)),
        unit="8 sweeps at one temperature", tolerance="rtol 2e-4, atol 1e-6")

    # K2: one sweep pair (8 phases) and the whole ICM loop; identical labels
    lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32).contiguous()
    k2 = (lab0, x["unary_k"], x["w"], x["mask_i"], beta)
    got = icm_sweep_pair(*k2)
    want = icm_sweep_pair(*k2, plain=True)
    _check(torch.equal(got, want),
           f"K2 sweep pair: {int((got != want).sum())} labels differ")
    full = icm_kmajor(x["unary_k"], x["w"], x["mask"], x["warm"], beta, 60)
    full_p = icm_kmajor(x["unary_k"], x["w"], x["mask"], x["warm"], beta, 60,
                        plain=True)
    _check(torch.equal(full, full_p),
           f"K2 ICM loop: {int((full != full_p).sum())} labels differ")
    out["K2_icm_phase"] = dict(
        max_abs_err=float((got != want).sum()),
        ms=_time_ms(lambda: icm_sweep_pair(*k2)),
        plain_ms=_time_ms(lambda: icm_sweep_pair(*k2, plain=True)),
        unit="one sweep pair = 8 phase launches",
        tolerance="identical labels")

    # K3: rtol 1e-6 (both sum float32 terms in float64)
    k3 = (x["unary_k"], x["mask_i"], x["warm"], x["w"], beta)
    got, want = potts_energy(*k3), potts_energy_plain(*k3)
    _check(torch.allclose(got, want, rtol=1e-6, atol=0),
           f"K3 disagrees: {got.tolist()} vs {want.tolist()}")
    out["K3_potts_energy"] = dict(
        max_abs_err=_max_abs(got, want),
        ms=_time_ms(lambda: potts_energy(*k3)),
        plain_ms=_time_ms(lambda: potts_energy_plain(*k3)),
        unit="one call (tile pass + reduce pass)", tolerance="rtol 1e-6")

    # K4: rtol 2e-5, atol 1e-6 on every output
    k4 = (x["unary_k"], x["img_f"], x["mask_i"], x["warm"], x["w"], beta,
          SMALL_EPS)
    got = finish_stats(*k4, negate=True)
    want = finish_stats_plain(*k4, negate=True)
    for a, b in zip(got, want):
        _check(torch.allclose(a, b, rtol=2e-5, atol=1e-6),
               f"K4 disagrees: max abs err {_max_abs(a, b)}")
    out["K4_finish_stats"] = dict(
        max_abs_err=max(_max_abs(a, b) for a, b in zip(got, want)),
        ms=_time_ms(lambda: finish_stats(*k4, negate=True)),
        plain_ms=_time_ms(lambda: finish_stats_plain(*k4, negate=True)),
        unit="one call (tile pass + reduce pass)",
        tolerance="rtol 2e-5, atol 1e-6")
    return out


def _cut_cost(side, excess, cap_t, caps):
    """Cost of a cut (float64): source-side pixels pay their sink arcs,
    sink-side ones their source arcs, arcs leaving the source side pay
    their capacity."""
    import torch

    from phylo_hmrf_tpu_torch.ops.mincut_kernels import _nb

    c = torch.where(side, cap_t, excess).double().sum()
    for a in range(8):
        c = c + (caps[:, a].double() * (side & ~_nb(side, a, True))).sum()
    return float(c)


def check_mincut(x, n_states, beta=1.0):
    """K5 and K6 against their plain versions on the graph of the chr21
    expansion move with the most pixels in play (from the K1-K3 start),
    then the whole min cut on both paths. Returns ({kernel: row}, cut
    record, start labels)."""
    import dataclasses

    import torch

    from phylo_hmrf_tpu_torch.ops import maxflow as mf
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (
        EPS, bfs_sweeps_, bfs_sweeps_plain, pr_iterations_,
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
    out = {}

    # K6: 8 Jacobi sweeps bitwise, then the fixpoint: identical distances
    d8 = d0.clone()
    bfs_sweeps_(d8, caps0, n, n_inner=8)
    _check(torch.equal(d8, bfs_sweeps_plain(d0, caps0, n, 8)),
           "K6: 8 sweeps differ from the plain version")
    fix = mf._bfs_fixpoint(d0.clone(), caps0, n, False, None)
    fix_p = mf._bfs_fixpoint(d0.clone(), caps0, n, True, None)
    _check(torch.equal(fix, fix_p),
           f"K6 fixpoint: {int((fix != fix_p).sum())} distances differ")
    out["K6_bfs_sweeps"] = dict(
        max_abs_err=float((fix - fix_p).abs().max()),
        ms=_time_ms(lambda: bfs_sweeps_(d8, caps0, n, n_inner=8)),
        plain_ms=_time_ms(lambda: bfs_sweeps_plain(d0, caps0, n, 8)),
        unit="8 BFS sweeps", tolerance="identical int32 distances",
        reachable=int((fix < n).sum()))

    # K5: 4 iterations from the relabelled state (h = BFS distance).
    # Same operations in the same order with round-to-nearest intrinsics:
    # expected bitwise; the gate allows atol 1e-6 on the floats
    st = [excess0.clone(), fix.clone(), cap_t0.clone(), caps0.clone()]
    pr_iterations_(*st, n, n_inner=4)
    want = pr_iterations_plain(excess0, fix, cap_t0, caps0, n, 4)
    _check(torch.equal(st[1], want[1]),
           f"K5: {int((st[1] != want[1]).sum())} heights differ")
    err = max(_max_abs(st[i], want[i]) for i in (0, 2, 3))
    _check(err <= 1e-6, f"K5 disagrees: max abs err {err}")
    work = [t.clone() for t in st]
    out["K5_pr_iterations"] = dict(
        max_abs_err=err,
        bitwise=all(torch.equal(a, b) for a, b in zip(st, want)),
        ms=_time_ms(lambda: pr_iterations_(*work, n, n_inner=4)),
        plain_ms=_time_ms(lambda: pr_iterations_plain(
            excess0, fix, cap_t0, caps0, n, 4)),
        unit="4 push-relabel iterations",
        tolerance="identical h; e, cap_t, caps atol 1e-6")

    # the whole min cut: the cut costs agree (the cuts may differ where
    # several minimum cuts exist)
    runs = {}
    for name, plain in (("kernel", False), ("plain", True)):
        stats = mf.CutStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side = mf.grid_mincut(excess0, cap_t0, caps0, plain=plain,
                              stats=stats)
        torch.cuda.synchronize()
        runs[name] = (side, time.perf_counter() - t0, stats)
    costs = {k: _cut_cost(v[0], excess0, cap_t0, caps0)
             for k, v in runs.items()}
    rel = abs(costs["kernel"] - costs["plain"]) / max(1.0,
                                                       abs(costs["plain"]))
    _check(rel <= 1e-5, f"min cut costs differ: {costs}")
    cut = dict(alpha=alpha, in_play=in_play[alpha], cost=costs,
               cost_rel_err=rel,
               differing_pixels=int((runs["kernel"][0]
                                     != runs["plain"][0]).sum()),
               kernel_s=runs["kernel"][1], plain_s=runs["plain"][1],
               stats={k: dataclasses.asdict(v[2]) for k, v in runs.items()})
    return out, cut, start


def check_oracle(x, region, start, n_states, max_cycles, beta=1.0,
                 beta1=0.5):
    """The exact expansion polish of the port against the C++
    alpha-expansion (``phylo_hmrf_tpu.native``, numpy + ctypes) from the
    same start on the same unary and weights. Gate, the reference's own:
    port energy <= oracle energy + 0.1% of its magnitude."""
    import dataclasses

    import numpy as np
    import torch

    from phylo_hmrf_tpu import native
    from phylo_hmrf_tpu.data.regions import flat_edge_list
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


def check_estep(x, dmaps, means, covs):
    """Kernel E-step vs the plain path on the same device, then the kernel
    E-step twice: bitwise equal labels, stats and costs."""
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
    (lab2, st2, cv2, nv2), t_k2 = run(False)
    _check(torch.equal(lab_k, lab2) and torch.equal(cv_k, cv2)
           and all(torch.equal(a, b) for a, b in zip(st_k, st2)),
           "kernel E-step is not bitwise deterministic")
    return dict(label_agreement=agree, stats_max_rel=stats_rel,
                cost_max_rel=cost_rel, kernel_s=min(t_k, t_k2),
                plain_s=t_p, bitwise_repeat=True)


def fit_chr21(tree, region, device, max_iter=5):
    """The port's main path: PhyloHMRF.fit with the default config (final
    exact expansion polish) on the chr21 problem. Returns (result, model,
    launches per kernel during the fit, each iteration's label grid)."""
    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.ops import finish_kernels, icm_kernels
    from phylo_hmrf_tpu_torch.ops import mf_kernels, mincut_kernels

    counters = {"K1_mf_sweep": mf_kernels.mf_sweeps,
                "K2_icm_phase": icm_kernels.icm_phase_,
                "K3_potts_energy": finish_kernels.potts_energy,
                "K4_finish_stats": finish_kernels.finish_stats,
                "K5_pr_iterations": mincut_kernels.pr_iterations_,
                "K6_bfs_sweeps": mincut_kernels.bfs_sweeps_}
    cfg = PhyloHMRFConfig(n_states=10, max_iter=max_iter, seed=0)
    _check(cfg.final_polish and cfg.polish_method == "expansion",
           "the default config no longer polishes with expansion moves")
    model = PhyloHMRF(tree, [region], cfg, device=device)
    grids = []
    for fn in counters.values():
        fn.launches = 0
    res = model.fit(verbose=True,
                    callback=lambda m, it, row, g: grids.append(g[0].clone()))
    launches = {k: fn.launches for k, fn in counters.items()}
    return res, model, launches, grids


def check_fit(res, model, true, grids):
    """Costs, the .mat round trip, and the polish: it ran, no move hit
    max_sweeps, and its labels have no higher MRF energy than the best
    iteration's E-step labels it started from (both under the restored
    moments). Returns (best-match accuracy, polish record)."""
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
    (region,) = model.regions
    (_, img, mask, dmaps), = model._bucket_arrays.values()
    dev = img.device
    unary_k = -gaussian_logpdf_kmajor(
        img, torch.as_tensor(res.means, dtype=torch.float32, device=dev),
        torch.as_tensor(res.covars, dtype=torch.float32, device=dev))
    w = weight_maps(dmaps, model.cfg.beta1)
    before = grids[res.iter_id2][None].to(torch.int32)
    after = torch.as_tensor(region.labels_to_grid(res.labels), device=dev,
                            dtype=torch.int32)[None]
    mask_i = mask.to(torch.int32)
    e_before, e_after = (float(potts_energy(unary_k, mask_i, lab, w,
                                            model.cfg.beta)[0])
                         for lab in (before, after))
    _check(e_after <= e_before + 1e-6 * abs(e_before),
           f"polish raised the energy: {e_before} -> {e_after}")
    polish = dict(
        energy_before=e_before, energy_after=e_after,
        relabeled=int((before != after)[mask].sum()), moves=st.moves,
        pr_iterations_per_move=st.pr_iterations / st.moves,
        bfs_sweeps_per_move=st.bfs_sweeps / st.moves,
        moves_at_max_sweeps=st.capped)
    return float(best_match_accuracy(res.labels, true)), polish


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch import PhyloHMRFConfig, _build
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
            entry = line.split("'")[1]
        elif "Used" in line and entry:
            print(f"[ptxas] {entry}: {line.split(':', 1)[1].strip()}")

    tree, region, means, covs, warm, true = chr21_problem(0)
    x = kernel_inputs(region, means, covs, warm, dev)
    print(f"[shapes] unary_k {tuple(x['unary_k'].shape)} "
          f"img_f {tuple(x['img_f'].shape)} samples {region.n_samples}")
    K = means.shape[0]
    kernels = check_kernels(x)
    mincut, cut, start = check_mincut(x, K)
    kernels.update(mincut)
    for name, k in kernels.items():
        print(f"[{name}] max_abs_err={k['max_abs_err']:.3g} "
              f"kernel={k['ms']:.3f}ms plain={k['plain_ms']:.3f}ms "
              f"({k['unit']})")
    print(f"[mincut] {json.dumps(cut)}")

    dmaps = torch.as_tensor(region.dmaps[None], device=dev)
    est = check_estep(x, dmaps,
                      torch.as_tensor(means, dtype=torch.float32, device=dev),
                      torch.as_tensor(covs, dtype=torch.float32, device=dev))
    print(f"[estep] {json.dumps(est)}")

    oracle = check_oracle(x, region, start, K,
                          PhyloHMRFConfig().swap_tpu_cycles)
    print(f"[oracle] {json.dumps(oracle)}")

    t0 = time.perf_counter()
    res, model, launches, grids = fit_chr21(tree, region, dev)
    fit_s = time.perf_counter() - t0
    for name, n in launches.items():
        _check(n > 0, f"{name} never launched on the fit's path")
    acc, polish = check_fit(res, model, true, grids)
    summ = model.timer.summary()
    em_s = sum(summ[p]["total_s"] for p in ("estep", "mstep") if p in summ)
    fit = dict(n_iters=res.n_iters, fit_s=fit_s,
               init_s=summ.get("init", {}).get("total_s"),
               s_per_em_iter=em_s / res.n_iters,
               final_polish_s=summ["final_polish"]["total_s"],
               polish=polish, phases=summ, launches=launches,
               best_match_accuracy=acc, cost_vec=res.cost_vec.tolist())
    print(f"[fit] {json.dumps(fit)}")

    rows = []
    for name, (src, replaces) in KERNELS.items():
        k = kernels[name]
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=k["max_abs_err"], ms=k["ms"],
                         plain_ms=k["plain_ms"]))
    print(f"[kernels] {json.dumps(kernels)}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the four E-step kernels from ``phylo_hmrf_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version at the chr21 shapes
(R=1, K=10, H=672, W=768, F=4) and times both, checks one whole E-step on
the kernel path against the plain path and for bitwise determinism, then
fits the chr21 problem (653 x 653 bins, 4 species, K=10, seed 0) for five
EM iterations with ``final_polish=False`` through ``PhyloHMRF.fit`` and
checks the result. Every phase that fails raises; the script exits 0 only
if all passed.

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
    """The port's main path: PhyloHMRF.fit on the chr21 problem. Returns
    (result, model, launches per kernel during the fit)."""
    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.ops import finish_kernels, icm_kernels
    from phylo_hmrf_tpu_torch.ops import mf_kernels

    counters = {"K1_mf_sweep": mf_kernels.mf_sweeps,
                "K2_icm_phase": icm_kernels.icm_phase_,
                "K3_potts_energy": finish_kernels.potts_energy,
                "K4_finish_stats": finish_kernels.finish_stats}
    cfg = PhyloHMRFConfig(n_states=10, final_polish=False,
                          max_iter=max_iter, seed=0)
    model = PhyloHMRF(tree, [region], cfg, device=device)
    for fn in counters.values():
        fn.launches = 0
    res = model.fit(verbose=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    return res, model, launches


def check_fit(res, model, true):
    from phylo_hmrf_tpu_torch.utils import (best_match_accuracy,
                                            load_estimate, save_estimate)
    import numpy as np

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
    return float(best_match_accuracy(res.labels, true))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch import _build
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

    tree, region, means, covs, warm, true = chr21_problem(0)
    x = kernel_inputs(region, means, covs, warm, dev)
    print(f"[shapes] unary_k {tuple(x['unary_k'].shape)} "
          f"img_f {tuple(x['img_f'].shape)} samples {region.n_samples}")
    kernels = check_kernels(x)
    for name, k in kernels.items():
        print(f"[{name}] max_abs_err={k['max_abs_err']:.3g} "
              f"kernel={k['ms']:.3f}ms plain={k['plain_ms']:.3f}ms "
              f"({k['unit']})")

    dmaps = torch.as_tensor(region.dmaps[None], device=dev)
    est = check_estep(x, dmaps,
                      torch.as_tensor(means, dtype=torch.float32, device=dev),
                      torch.as_tensor(covs, dtype=torch.float32, device=dev))
    print(f"[estep] {json.dumps(est)}")

    t0 = time.perf_counter()
    res, model, launches = fit_chr21(tree, region, dev)
    fit_s = time.perf_counter() - t0
    for name, n in launches.items():
        _check(n > 0, f"{name} never launched on the fit's path")
    acc = check_fit(res, model, true)
    summ = model.timer.summary()
    em_s = sum(summ[p]["total_s"] for p in ("estep", "mstep") if p in summ)
    fit = dict(n_iters=res.n_iters, fit_s=fit_s,
               init_s=summ.get("init", {}).get("total_s"),
               s_per_em_iter=em_s / res.n_iters, phases=summ,
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

#!/usr/bin/env python3
"""Time variants of the K3/K4 source against each other on one NVIDIA GPU.

    python3 tools/finish_ab.py [NAME=PATH ...]

Each variant is a copy of ``phylo_hmrf_tpu_torch/csrc/finish.cu`` (PATH,
relative to the repo root; ``committed`` is the package's own source) with
one change, built by nvcc with the package's flags into ``tools/build/``
(git-ignored) and called through its C entry points as the wrappers call
them. On the chr21 region (seed 0, K=10) and the 10 kb
region (3264 x 3328) it checks every variant's K4 (rtol 2e-5, atol 1e-6 on
every output) and K3 (rtol 1e-6, one labeling and the pair) against the
plain versions, then prints each variant's device ms of one call (median
of 7, launches queued behind a sleep), in turns: variant 1, 2, ..., then
the same in reverse order. With no argument it times the committed source
alone. A variant whose name starts with ``ablate_`` leaves out a stage of
the kernel: its K4 outputs are not checked. Prints the card's name and
power limit and each variant's ptxas report.
"""

import ctypes
import hashlib
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tools", "build")


def build(name, path):
    """nvcc the variant into a shared library; (ctypes lib, ptxas lines)."""
    from phylo_hmrf_tpu_torch import _build

    src = os.path.join(_build.CSRC, "finish.cu") if path == "committed" \
        else os.path.join(REPO, path)
    tag = hashlib.sha256(open(src).read().encode())
    lib = os.path.join(OUT, f"finish_{name}_{tag.hexdigest()[:12]}.so")
    os.makedirs(OUT, exist_ok=True)
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         _build.CSRC, "-o", lib, src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    cdll = ctypes.CDLL(lib)
    for fn in ("phmrf_potts_energy", "phmrf_finish_stats",
               "phmrf_energy_slots", "phmrf_finish_slots"):
        getattr(cdll, fn).argtypes = _build._SIGNATURES[fn]
        getattr(cdll, fn).restype = ctypes.c_int
    report = [line.strip() for line in (res.stdout + res.stderr).splitlines()
              if "Used" in line or "spill" in line]
    return cdll, report


def calls(lib, x, other):
    """(K4 call, K3 call, K3 pair call) of one variant on the operands x;
    each returns its outputs."""
    import torch

    from phylo_hmrf_tpu_torch import _build
    from phylo_hmrf_tpu_torch.config import SMALL_EPS

    R, K, H, W = x["unary_k"].shape
    F = x["img_f"].shape[1]
    dev = x["unary_k"].device
    nstat = K * (1 + F + F * F)
    tickets = torch.zeros(max(R, 64), dtype=torch.int32, device=dev)
    p4 = torch.empty(lib.phmrf_finish_slots(R, K, F, H, W),
                     dtype=torch.float64, device=dev)
    p3 = torch.empty(lib.phmrf_energy_slots(R, H, W), dtype=torch.float64,
                     device=dev)
    stream = _build.stream_of(x["unary_k"])

    def k4():
        out = torch.empty(R, nstat + 8, dtype=torch.float32, device=dev)
        _build.check(lib.phmrf_finish_stats(
            x["unary_k"].data_ptr(), x["img_f"].data_ptr(),
            x["mask_i"].data_ptr(), x["warm"].data_ptr(), x["w"].data_ptr(),
            p4.data_ptr(), tickets.data_ptr(), out.data_ptr(), R, K, F, H, W,
            1.0, SMALL_EPS, 1, 0, stream), "K4")
        return (out[:, :K], out[:, K:K + K * F].reshape(R, K, F),
                out[:, K + K * F:nstat].reshape(R, K, F, F), out[:, nstat:])

    def k3(pair):
        out = torch.empty(2 if pair else 1, R, dtype=torch.float32,
                          device=dev)
        _build.check(lib.phmrf_potts_energy(
            x["unary_k"].data_ptr(), x["mask_i"].data_ptr(),
            x["warm"].data_ptr(), other.data_ptr() if pair else None,
            x["w"].data_ptr(), p3.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), R, K, H, W, 1.0, stream), "K3")
        return out
    return k4, lambda: k3(False), lambda: k3(True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("finish_ab: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import _time_ms
    from phylo_hmrf_tpu_torch.config import SMALL_EPS
    from phylo_hmrf_tpu_torch.ops.finish_kernels import (
        finish_stats_plain, potts_energy_pair_plain)
    from phylo_hmrf_tpu_torch.ops.mf_kernels import mean_field_kmajor
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    specs = sys.argv[1:] or ["committed=committed"]
    variants = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        variants[name] = build(name, path)
        for line in variants[name][1]:
            print(f"[ptxas {name}] {line}")
    dev = torch.device("cuda")
    for point, kw in (("chr21", {}), ("10kb", dict(h0=3264))):
        _, region, means, covs, warm, _ = chr21_problem(0, **kw)
        x = kernel_inputs(region, means, covs, warm, dev)
        other = mean_field_kmajor(x["unary_k"], x["w"], 1.0)
        k4_args = (x["unary_k"], x["img_f"], x["mask_i"], x["warm"], x["w"],
                   1.0, SMALL_EPS)
        want4 = finish_stats_plain(*k4_args, negate=True)
        want3 = potts_energy_pair_plain(x["unary_k"], x["mask_i"], x["warm"],
                                        other, x["w"], 1.0)
        fns = {}
        for name, (lib, _) in variants.items():
            k4, k3, k3_pair = fns[name] = calls(lib, x, other)
            got = k4()
            for a, b in zip(got, want4):
                if not torch.allclose(a, b, rtol=2e-5, atol=1e-6):
                    msg = (f"{name} K4 at {point}: max abs err "
                           f"{float((a - b).abs().max())}")
                    # an ablation (a variant that leaves out a stage) is
                    # timed, not checked
                    if not name.startswith("ablate_"):
                        raise AssertionError(msg)
                    print(f"[{point}] ({msg}: an ablation)")
                    break
            if not (torch.allclose(k3_pair(), want3, rtol=1e-6, atol=0)
                    and torch.equal(k3()[0], k3_pair()[0])):
                raise AssertionError(f"{name} K3 at {point} disagrees")
        times = {name: {"K4": [], "K3": [], "K3 pair": []} for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            for what, fn in zip(("K4", "K3", "K3 pair"), fns[name]):
                times[name][what].append(_time_ms(fn, reps=7, queued=True))
        for name, t in times.items():
            print(f"[{point}] {name}: " + ", ".join(
                f"{what} {statistics.mean(v):.4f} ms ({min(v):.4f}-"
                f"{max(v):.4f})" for what, v in t.items()), flush=True)
        del x, other, want4, want3, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

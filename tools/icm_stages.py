#!/usr/bin/env python3
"""Where the time of one K2 launch (the ICM sweep-pair tile kernel) goes,
on one NVIDIA GPU.

    python3 tools/icm_stages.py

Compiles a copy of ``phylo_hmrf_tpu_torch/csrc/icm.cu`` into
``tools/build/`` (git-ignored) with a ``%globaltimer`` stamp at each stage
of the block at tile (0, 0): start, loads done, label-free pass done,
each of the 8 phases done, interior written. Runs it on the chr21 region
(seed 0) from its warm labels at K = 1, 10 and 30, checks the labels
against the 8 chained phase launches, and prints the microseconds from
the start to each stage (median of 5 launches), with the whole launch's
device time beside them. The stamps add a few instructions to one thread.
"""

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STAMP = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {{ "
         "unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
         ": \"=l\"(t_)); g_stamps[{}] = t_; }}")
# (text of the kernel, the same text with a stamp): start, loads done,
# label-free pass done (a barrier added), each phase, interior written
MARKS = [
    ("  const bool beta_pos = beta > 0.0f && beta <= 3.402823466e38f;\n",
     "  const bool beta_pos = beta > 0.0f && beta <= 3.402823466e38f;\n"
     + STAMP.format(0) + "\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n",
     "  cp_async_wait_all();\n  __syncthreads();\n" + STAMP.format(1) + "\n"),
    ("#pragma unroll 1\n  for (int ph = 0; ph < 8; ++ph) {",
     "__syncthreads();\n" + STAMP.format(2)
     + "\n#pragma unroll 1\n  for (int ph = 0; ph < 8; ++ph) {"),
    ("      lab[i] = best;\n    }\n    __syncthreads();\n  }",
     "      lab[i] = best;\n    }\n    __syncthreads();\n"
     + STAMP.format("3 + ph") + "\n  }"),
    ("  // every thread reaches the vote;",
     STAMP.format(11) + "\n  // every thread reaches the vote;"),
]
STAGES = ["loads", "label-free"] + [f"phase {i}" for i in range(1, 9)] + [
    "written"]


def stamped_source():
    from phylo_hmrf_tpu_torch import _build

    src = open(os.path.join(_build.CSRC, "icm.cu")).read()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise RuntimeError(f"icm.cu no longer has one {old!r}")
        src = src.replace(old, new)
    return src.replace('#include "common.cuh"', (
        '#include "common.cuh"\n'
        "__device__ unsigned long long g_stamps[16];\n"
        'extern "C" int phmrf_stamps(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n"
        "}"), 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("icm_stages: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch import _build
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (
        icm_sweep_pair, icm_sweep_pair_chained, icm_tile_plan)
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out_dir = os.path.join(REPO, "tools", "build")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, f) for f in
                     ("icm_stages.cu", "icm_stages.so"))
    with open(src, "w") as f:
        f.write(stamped_source())
    subprocess.run([_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-I", _build.CSRC,
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    pair = lib.phmrf_icm_pair
    pair.argtypes = _build._SIGNATURES["phmrf_icm_pair"]
    pair.restype = ctypes.c_int
    stamps = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda")
    ok = True
    for K in (1, 10, 30):
        _, region, means, covs, warm, _ = chr21_problem(0, K=K)
        x = kernel_inputs(region, means, covs, warm, dev)
        lab = torch.where(x["mask"], x["warm"], 0).to(torch.int32)
        lab = lab.contiguous()
        R, H, W = lab.shape
        plan = icm_tile_plan(K)
        out = torch.empty_like(lab)
        rows = []
        for _ in range(5):
            torch.cuda._sleep(2_000_000)
            _build.check(pair(
                lab.data_ptr(), out.data_ptr(), x["unary_k"].data_ptr(),
                x["w"].data_ptr(), x["mask_i"].data_ptr(), R, K, H, W, 1.0,
                0, plan.th, plan.tw, plan.threads, None, 0,
                torch.cuda.current_stream().cuda_stream), "stamped K2")
            torch.cuda.synchronize()
            _build.check(lib.phmrf_stamps(stamps), "stamps")
            rows.append([(stamps[i] - stamps[0]) / 1e3
                         for i in (1, 2, *range(3, 11), 11)])
        args = (lab, x["unary_k"], x["w"], x["mask_i"], 1.0)
        same = torch.equal(out, icm_sweep_pair_chained(*args))
        ok = ok and same
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        icm_sweep_pair(*args)
        b.record()
        b.synchronize()
        med = [statistics.median(col) for col in zip(*rows)]
        print(f"K={K} tile {plan.th}x{plan.tw} bitwise={same} "
              f"launch={a.elapsed_time(b) * 1e3:.1f}us block (0,0), us from "
              "its start: " + " ".join(f"{n}={v:.1f}"
                                       for n, v in zip(STAGES, med)),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Tile shapes of the E-step tile kernels K1 (mean field) and K2
(checkerboard ICM) on one NVIDIA GPU.

    python3 tools/estep_tiles.py

The tile is an argument of the C entry points, so one build of
``phylo_hmrf_tpu_torch/csrc`` serves every shape. On the chr21 region
(seed 0) at K = 10 and K = 30, each candidate plan is checked bitwise
against the chained route (8 one-sweep launches for K1, 8 one-phase
launches for K2) and timed: the device time of one unit (8 sweeps at one
temperature; one sweep pair), its launches queued behind a sleep, median
of 7. Each line gives the plan, its launches, the device time, the
shared memory of a block and the blocks an SM can hold by that and by the
kernel's ptxas registers; the ptxas report of each kernel instance is
printed first. The chained route's time closes each K's list.
"""

import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# K1 at K = 10 (<= 1937 tile pixels at 120 B each): (rows, cols, depth)
K1_SHAPES_10 = [(24, 32, 8), (20, 36, 8), (14, 48, 8),
                (14, 14, 8), (10, 20, 8), (36, 36, 4), (28, 44, 4)]
# K1 at K = 30 (<= 645 tile pixels at 360 B each)
K1_SHAPES_30 = [(17, 17, 4), (9, 9, 8), (19, 19, 3),
                (21, 21, 2), (11, 13, 4)]
# K2: (rows, cols, 2 x 2 quads a thread)
K2_SHAPES = [(56, 64, 2), (64, 64, 2), (48, 48, 1), (48, 48, 2), (32, 64, 1),
             (64, 96, 2), (32, 48, 1), (40, 80, 2), (24, 48, 1),
             (96, 64, 2)]
SMEM_SM = 233_472   # shared memory of one SM (228 KB)


def ptxas_report(log):
    """{kernel instance: "registers, spills, shared"} from nvcc -v."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " +
                         line.split(":", 1)[-1].strip()).strip()
    return out


def registers(report, key):
    for name, text in report.items():
        if key in name and "registers" in text:
            return int(text.split("Used")[1].split("registers")[0])
    return None


def per_sm(threads, smem, regs):
    """Blocks one SM holds, by threads, shared memory and registers."""
    by = [2048 // threads, SMEM_SM // (smem + 1024)]
    if regs:
        by.append(65536 // (-(-regs // 8) * 8 * threads))
    return min(by)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("estep_tiles: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch import _build
    from phylo_hmrf_tpu_torch.ops.icm_kernels import (
        icm_sweep_pair, icm_sweep_pair_chained, icm_tile, icm_tile_plan)
    from phylo_hmrf_tpu_torch.ops.mf_kernels import (
        SMEM_MAX, MFTilePlan, mf_smem_per_pixel, mf_sweeps, mf_sweeps_chained,
        mf_tile_plan)
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.load()
    report = ptxas_report(_build.build_log)
    for name, text in report.items():
        if "tile_kernel" in name or "pair_kernel" in name:
            print(f"[ptxas] {name}: {text}")
    dev = torch.device("cuda")

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(3_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    ok = True
    for K, shapes in ((10, K1_SHAPES_10), (30, K1_SHAPES_30)):
        _, region, means, covs, warm, _ = chr21_problem(0, K=K)
        x = kernel_inputs(region, means, covs, warm, dev)
        k1 = (x["q0"], x["base"], x["w"], 1.0, 0.5, 1.0)
        want = mf_sweeps_chained(*k1, n_inner=8)
        default = mf_tile_plan(K, 8)
        for th, tw, depth in [default[:3]] + [v for v in shapes
                                              if v != default[:3]]:
            npx = (th + 2 * depth) * (tw + 2 * depth)
            per = -(-npx // 1024)
            threads = -(-(-(-npx // per)) // 32) * 32
            plan = MFTilePlan(th, tw, depth, threads,
                              npx * mf_smem_per_pixel(K), -(-8 // depth))
            same = torch.equal(mf_sweeps(*k1, n_inner=8, plan=plan), want)
            ok = ok and same
            regs = registers(report, f"mf_tile_kernelILi{per}E")
            print(f"K1 K={K} {th}x{tw} depth {depth} threads {threads} "
                  f"launches {plan.launches} bitwise={same} "
                  f"ms={time_ms(lambda: mf_sweeps(*k1, n_inner=8, plan=plan)):.4f} "
                  f"smem={plan.smem} blocks/SM={per_sm(threads, plan.smem, regs)}"
                  f"{' (the plan)' if (th, tw, depth) == default[:3] else ''}",
                  flush=True)
        print(f"K1 K={K} chained 8 launches "
              f"ms={time_ms(lambda: mf_sweeps_chained(*k1, n_inner=8)):.4f}")

        lab0 = torch.where(x["mask"], x["warm"], 0).to(torch.int32)
        k2 = (lab0.contiguous(), x["unary_k"], x["w"], x["mask_i"], 1.0)
        want = icm_sweep_pair_chained(*k2)
        default = icm_tile_plan(K)
        for th, tw, qpt in K2_SHAPES:
            plan = icm_tile(th, tw, qpt)
            if plan.smem > SMEM_MAX or plan.threads > 1024:
                continue
            same = torch.equal(icm_sweep_pair(*k2, plan=plan), want)
            ok = ok and same
            regs = registers(report, "icm_pair_kernel")
            print(f"K2 K={K} {th}x{tw} threads {plan.threads} "
                  f"bitwise={same} "
                  f"ms={time_ms(lambda: icm_sweep_pair(*k2, plan=plan)):.4f} "
                  f"smem={plan.smem} "
                  f"blocks/SM={per_sm(plan.threads, plan.smem, regs)}"
                  f"{' (the plan)' if plan == default else ''}",
                  flush=True)
        print(f"K2 K={K} chained 8 launches "
              f"ms={time_ms(lambda: icm_sweep_pair_chained(*k2)):.4f}")
        del x
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

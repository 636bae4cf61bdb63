#!/usr/bin/env python3
"""Tile shapes of the min-cut kernels K5 and K6 on one NVIDIA GPU.

    python3 tools/mincut_tiles.py

Builds ``phylo_hmrf_tpu_torch/csrc/mincut.cu`` once per tile shape (the
``PR_*`` / ``BFS_*`` macros, one nvcc per shape, all in parallel, into
``tools/build/``, git-ignored), and on the graph of the chr21 expansion
move with the most pixels in play (seed 0, the ``chip_smoke.py`` graph)
checks each shape bitwise against the plain version and times it: the
device time of one unit (4 push-relabel iterations, 8 BFS sweeps), its
launches queued behind a sleep, median of 7; and the mean of 20 launches
back to back. Prints one line per shape with its ptxas report
(registers, spills).
"""

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (interior rows, columns, threads) of K5; and of K6, with blocks per SM
PR_SHAPES = [(32, 64, 640), (32, 64, 768), (32, 64, 960), (24, 64, 640),
             (48, 64, 640), (32, 96, 768), (40, 64, 640), (16, 64, 640),
             (32, 32, 576), (32, 32, 768)]
BFS_SHAPES = [(32, 64, 640, 2), (32, 64, 384, 2), (32, 64, 960, 1),
              (32, 64, 640, 1), (64, 64, 640, 2), (64, 64, 800, 1),
              (32, 128, 768, 2), (16, 64, 640, 3), (64, 128, 960, 1),
              (16, 128, 768, 2)]


def build_all(out_dir):
    """One library per shape: [(kind, shape, path, ptxas report)]."""
    from phylo_hmrf_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    jobs = [("pr", v, [f"-DPR_TH={v[0]}", f"-DPR_TW={v[1]}",
                       f"-DPR_THREADS={v[2]}"]) for v in PR_SHAPES]
    jobs += [("bfs", v, [f"-DBFS_TH={v[0]}", f"-DBFS_TW={v[1]}",
                         f"-DBFS_THREADS={v[2]}",
                         f"-DBFS_BLOCKS_PER_SM={v[3]}"]) for v in BFS_SHAPES]
    procs = []
    for i, (_, _, defs) in enumerate(jobs):
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-Xptxas=-v", *defs, "-I", _build.CSRC,
             "-o", os.path.join(out_dir, f"tiles{i}.so"),
             os.path.join(_build.CSRC, "mincut.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = []
    for i, ((kind, v, _), p) in enumerate(zip(jobs, procs)):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind} {v}:\n{log}")
        # the report of this shape's kernel (the other kernel is the default)
        name = "pr_tile_kernel" if kind == "pr" else "bfs_tile_kernel"
        lines = log.splitlines()
        at = next(j for j, ln in enumerate(lines)
                  if "Compiling entry" in ln and name in ln)
        rest = lines[at + 1:]
        end = next((j for j, ln in enumerate(rest) if "Compiling entry" in ln),
                   len(rest))
        report = "; ".join(ln.split(":", 1)[-1].strip() if "Used" in ln
                           else ln.strip() for ln in rest[:end]
                           if "Used" in ln or "spill" in ln)
        built.append((kind, v, os.path.join(out_dir, f"tiles{i}.so"),
                      report))
    return built


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mincut_tiles: CUDA is not available", file=sys.stderr)
        return 1
    from phylo_hmrf_tpu_torch import _build
    from phylo_hmrf_tpu_torch.ops import maxflow as mf
    from phylo_hmrf_tpu_torch.ops.mincut_kernels import (
        EPS, bfs_sweeps_plain, pr_iterations_plain)
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    built = build_all(os.path.join(REPO, "tools", "build"))
    dev = torch.device("cuda")
    _, region, means, covs, warm, _ = chr21_problem(0)
    x = kernel_inputs(region, means, covs, warm, dev)
    start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"], 1.0,
                            60)
    wsum = mf._incident_wsum(x["w"], 1.0)
    graphs = [mf._expansion_graph(start, x["unary_k"], x["w"], x["mask"], a,
                                  1.0, wsum) for a in range(means.shape[0])]
    e0, ct0, caps0, _ = max(graphs, key=lambda g: int(g[3].sum()))
    R, H, W = e0.shape
    n = H * W + 2
    d0 = torch.where(ct0 > EPS, 1, n).to(torch.int32).contiguous()
    h = mf._bfs_fixpoint(d0.clone(), caps0, n, True, None)
    st = [t.contiguous() for t in pr_iterations_plain(e0, h, ct0, caps0, n,
                                                      4)]
    want5 = pr_iterations_plain(*st, n, 4)
    want6 = bfs_sweeps_plain(d0, caps0, n, 8)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def time_us(fn, reps, batch):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(3_000_000)
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / batch * 1e3)
        return statistics.median(ts)

    for kind, v, path, report in built:
        lib = ctypes.CDLL(path)
        name = "phmrf_pr_iterations" if kind == "pr" else "phmrf_bfs_sweeps"
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        if kind == "pr":
            o = [torch.empty_like(t) for t in st]

            def call():
                return fn(*(t.data_ptr() for t in st),
                          *(t.data_ptr() for t in o), R, H, W, n, 4,
                          flag.data_ptr(), 1, stream)
            err = call()
            torch.cuda.synchronize()
            same = err == 0 and all(torch.equal(a, b)
                                    for a, b in zip(o, want5))
        else:
            o = torch.empty_like(d0)

            def call():
                return fn(d0.data_ptr(), o.data_ptr(), caps0.data_ptr(), R,
                          H, W, n, 8, flag.data_ptr(), 1, stream)
            err = call()
            torch.cuda.synchronize()
            same = err == 0 and torch.equal(o, want6)
        print(f"{'K5' if kind == 'pr' else 'K6'} {v} bitwise={same} "
              f"one={time_us(call, 7, 1):.1f}us "
              f"batch20={time_us(call, 5, 20):.1f}us | {report}",
              flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``phylo_hmrf_tpu_torch``)
beside ``BENCHMARK.json`` and this folder. The last line of standard
output is one JSON object: ``correct``, ``attempted`` and ``failed`` (whole
fits), ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics), ``device`` and, traced,
``breakdown``; last, ``checks``: each number the judge compared, with its
limit (also the last lines of standard error).

Exits non-zero with no result line when no CUDA card is present, when the
card count is below the cell's, when a file it needs is missing, or when a
module of the JAX stack or of the JAX package was loaded. Caches go to
``.bench_cache/`` in the checkout; the kernel library is built by the
program into its own directory there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)

    import torch

    sys.path.insert(0, HERE)
    import harness

    try:
        spec = harness.load_json(ROOT, "BENCHMARK.json")
        cell = harness.cell_from_spec(spec, ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_port: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {torch.cuda.device_count()} CUDA devices, the "
              f"cell needs {cell.chips}", file=sys.stderr)
        return 3
    # TF32 off for the reference's float32 matmuls (the port turns it off
    # for its own at import)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=t_start)
    bad = harness.banned_modules()
    if bad:
        print(f"bench_port: loaded modules of the JAX stack or package: "
              f"{bad}", file=sys.stderr)
        return 4
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

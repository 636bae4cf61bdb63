#!/usr/bin/env python3
"""K7's and K8's units of work timed on one NVIDIA GPU for several source
trees, in turns, each in a fresh process.

    python3 tools/halo_units_ab.py TREE [TREE ...] [--turns 2]

Each TREE is a checkout with the row-shard entries ``mf_sweeps_halo`` and
``icm_sweep_halo_`` (a variant of this tree unpacked in a git-ignored
directory of the repo; ``.`` is this tree). Each turn runs every tree as
``python3 tools/halo_units_ab.py --one TREE`` in its own process and
prints one JSON line: the device ms (launches queued behind a sleep,
median of 5; ``chip_smoke.py::_time_ms``) of K7's 8 sweeps and K8's sweep
on the 4 6-row shards of the spatial fit's off-diagonal block, and of one
K7 sweep and one K8 phase on the 4 816-row shards of the 10 kb region
(3264 x 3328), each checked as ``chip_smoke.py::check_halo_kernels`` checks
it (bitwise the tree's per-shard route and remote route), with the
per-shard route's time and the cooperative grid.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from phylo_hmrf_tpu_torch import _build
    from phylo_hmrf_tpu_torch.synth import chr21_problem, kernel_inputs

    _build.load()
    dev = torch.device("cuda")
    rec = {"tree": tree}
    _, off, mo, co, wo, _ = smoke.offdiag_block()
    _, r10, m10, c10, w10, _ = chr21_problem(0, h0=3264)
    for point, args, n_sweeps, n_phases in (
            ("offdiag", (off, mo, co, wo), 8, 4),
            ("10kb", (r10, m10, c10, w10), 1, 1)):
        x = kernel_inputs(*args, dev)
        rows = smoke.check_halo_kernels(x, 4, n_sweeps=n_sweeps,
                                        n_phases=n_phases)
        rec[point] = {name: dict(ms=k["ms"], call_ms=k["call_ms"],
                                 chained_ms=k["chained_ms"],
                                 grid=k["cooperative_grid"])
                      for name, k in rows.items()}
        del x
        torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--one":
        one(args[1])
        return 0
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 2
    trees = [a for i, a in enumerate(args)
             if not a.startswith("--") and (i == 0 or args[i - 1] != "--turns")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for t in range(turns):
        order = trees if t % 2 == 0 else trees[::-1]
        for tree in order:
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--one", tree], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
                return res.returncode
            print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

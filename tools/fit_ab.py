#!/usr/bin/env python3
"""The default chr21 fit of two source trees, in turns, each in a fresh
process, on one NVIDIA GPU.

    python3 tools/fit_ab.py OTHER_TREE [--turns 3] [--labeler swap_tpu]

OTHER_TREE is a checkout of another commit (``git archive`` unpacked in a
git-ignored directory of this repo). Each turn runs OTHER_TREE's fit, then
this tree's, each as ``python3 tools/fit_ab.py --one TREE`` in its own
process: ``PhyloHMRF(tree, [chr21 region], PhyloHMRFConfig(n_states=10,
max_iter=5, seed=0)).fit()``, the ``chip_smoke.py`` fit without the phases
that run before it there; ``--labeler`` sets the config's labeler (e.g.
``swap_tpu``: exact swap moves every E-step, no final polish). Prints one
JSON line per fit: fit seconds, init, seconds per EM iteration (E-step +
M-step), the final polish (0 without one), the SHA-256 of the cost rows
(float64) and of the final labels (int32), so two trees' fits compare
bitwise; with
``--cuts`` (the first turn of this tree) also the wall of the first three
whole min cuts of the chr21 move graph in the process, before the fit.
"""

import hashlib
import json
import os
import subprocess
import sys
import time


def one(tree: str, cuts: bool, labeler: str | None) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig, _build
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    _build.load()
    dev = torch.device("cuda")
    tree_, region, means, covs, warm, _ = chr21_problem(0)
    rec = dict(tree=tree, labeler=labeler or PhyloHMRFConfig().labeler)
    if cuts:
        from phylo_hmrf_tpu_torch.ops import maxflow as mf
        from phylo_hmrf_tpu_torch.synth import kernel_inputs

        x = kernel_inputs(region, means, covs, warm, dev)
        start = mf._start_batch(x["unary_k"], x["w"], x["mask"], x["warm"],
                                1.0, 60)
        wsum = mf._incident_wsum(x["w"], 1.0)
        graphs = [mf._expansion_graph(start, x["unary_k"], x["w"], x["mask"],
                                      a, 1.0, wsum)
                  for a in range(means.shape[0])]
        graph = max(graphs, key=lambda g: int(g[3].sum()))[:3]
        rec["first_cuts_ms"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mf.grid_mincut(*graph)
            torch.cuda.synchronize()
            rec["first_cuts_ms"].append((time.perf_counter() - t0) * 1e3)
    cfg = dict(labeler=labeler) if labeler else {}
    model = PhyloHMRF(tree_, [region], PhyloHMRFConfig(
        n_states=10, max_iter=5, seed=0, **cfg), device=dev)
    t0 = time.perf_counter()
    res = model.fit(verbose=False)
    rec["fit_s"] = time.perf_counter() - t0
    s = model.timer.summary()
    rec.update(init_s=s["init"]["total_s"],
               s_per_em_iter=(s["estep"]["total_s"] + s["mstep"]["total_s"])
               / res.n_iters,
               final_polish_s=s.get("final_polish", {}).get("total_s", 0.0),
               cost_vec_sha256=hashlib.sha256(
                   res.cost_vec.astype("<f8").tobytes()).hexdigest(),
               labels_sha256=hashlib.sha256(
                   res.labels.astype("<i4").tobytes()).hexdigest())
    print(json.dumps(rec), flush=True)


def main() -> int:
    args = sys.argv[1:]
    labeler = (args[args.index("--labeler") + 1] if "--labeler" in args
               else None)
    if args and args[0] == "--one":
        one(args[1], "--cuts" in args, labeler)
        return 0
    other = args[0]
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 3
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for t in range(turns):
        for tree, extra in ((other, []), (here, ["--cuts"] if t == 0 else [])):
            if labeler:
                extra = [*extra, "--labeler", labeler]
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 *extra], capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr[-2000:], file=sys.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

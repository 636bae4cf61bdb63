#!/usr/bin/env python3
"""The spatial and default-config workloads of two source trees, in
turns, each in a fresh process, on one NVIDIA GPU; their outputs compared.

    python3 tools/halo_ab.py OTHER_TREE [--turns 2] [--out DIR]

OTHER_TREE is a checkout of another commit (``git archive`` unpacked in a
git-ignored directory of this repo). Each turn runs OTHER_TREE, then this
tree, each as ``python3 tools/halo_ab.py --one TREE NPZ`` in its own
process, over a mesh of 4 shards of the card: the spatial fit's 24 x 768
off-diagonal block's spatial E-step alone (``chip_smoke.py::thin_estep``,
first, while the process is young: walls, device busy, idle share, kernel
launches and host ops per E-step), the 10 kb spatial E-step (3264 x 3328),
the region-sharded E-step of 4 chr21 regions, the default chr21 fit (5
iterations) and the default spatial fit of chr21 with that block (3
iterations). Prints one JSON line per run (walls, phase times), then which
outputs (labels, statistics, costs) are bitwise equal between the trees
and, as a control, between two runs of one tree. The npz files go to
``--out`` (default ``tools/build/halo_ab``, git-ignored).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def one(tree: str, npz: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig, _build
    from phylo_hmrf_tpu_torch.parallel import sharding
    from phylo_hmrf_tpu_torch.parallel.halo import make_rowsharded_estep
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    _build.load()
    dev = torch.device("cuda")
    mesh = make_mesh((4,))
    keep = {}
    rec = dict(tree=tree, thin_estep=smoke.thin_estep(mesh, dev, keep=keep))
    arrays = {f"thin_{k}": v for k, v in keep.items()}

    def host(d, prefix):
        for k, v in d.items():
            arrays[f"{prefix}_{k}"] = v

    kw = dict(weighted_pp=False, max_sweeps=60)
    _, r10, m10, c10, w10, _ = chr21_problem(0, h0=3264)
    args = [torch.as_tensor(a, device=dev) for a in (
        r10.img, r10.mask, r10.dmaps, r10.labels_to_grid(w10))]
    args += [torch.as_tensor(a, dtype=torch.float32, device=dev)
             for a in (m10, c10)]
    fn = make_rowsharded_estep(mesh, **kw)
    out, _ = _timed(lambda: fn(*args, 1.0, 0.5))
    out, t = _timed(lambda: fn(*args, 1.0, 0.5))
    rec["spatial_10kb_estep_s"] = t
    host(dict(labels=out[0], post=out[1][0], obs=out[1][1], obs2=out[1][2],
              cost_vec=out[2]), "s10")
    del args, out

    probs = [chr21_problem(s) for s in (0, 1, 2, 3)]
    img = np.stack([p[1].img for p in probs])
    mask = np.stack([p[1].mask for p in probs])
    dmaps = np.stack([p[1].dmaps for p in probs])
    warm = np.stack([p[1].labels_to_grid(p[4]) for p in probs])
    mt, ct = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in probs[0][2:4])
    placed = sharding.device_put_bucket(mesh, img, mask, dmaps)
    fn = sharding.make_sharded_estep(mesh, **kw)
    out, _ = _timed(lambda: fn(*placed, torch.as_tensor(warm, device=dev),
                               mt, ct, 1.0, 0.5))
    out, t = _timed(lambda: fn(*placed, torch.as_tensor(warm, device=dev),
                               mt, ct, 1.0, 0.5))
    rec["region_estep_s"] = t
    host(dict(labels=out[0], post=out[1][0], obs=out[1][1], obs2=out[1][2],
              cost_vec=out[2]), "reg")

    tree_, region, _, _, _, _ = probs[0]
    model = PhyloHMRF(tree_, [region], PhyloHMRFConfig(
        n_states=10, max_iter=5, seed=0), device=dev)
    res, t = _timed(lambda: model.fit(verbose=False))
    s = model.timer.summary()
    rec.update(fit_s=t, s_per_em_iter=(s["estep"]["total_s"]
                                       + s["mstep"]["total_s"]) / res.n_iters,
               fit_estep_s=s["estep"]["total_s"] / s["estep"]["count"])
    arrays.update(fit_labels=res.labels, fit_cost_vec=res.cost_vec)

    _, off, _, _, _, _ = smoke.offdiag_block()
    model = PhyloHMRF(tree_, [region, off], PhyloHMRFConfig(
        n_states=10, max_iter=3, seed=0, shard_mode="spatial"), mesh=mesh)
    res, t = _timed(lambda: model.fit(verbose=False))
    s = model.timer.summary()
    rec.update(spatial_fit_s=t, spatial_fit_estep_s=s["estep"]["total_s"]
               / s["estep"]["count"], spatial_fit_phases=s)
    arrays.update(sfit_labels=res.labels, sfit_cost_vec=res.cost_vec)
    np.savez(npz, **{k: v.detach().cpu().numpy() if torch.is_tensor(v)
                     else np.asarray(v) for k, v in arrays.items()})
    print(json.dumps(rec), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--one":
        one(args[1], args[2])
        return 0
    import numpy as np

    other = args[0]
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 2
    out_dir = (args[args.index("--out") + 1] if "--out" in args
               else os.path.join(HERE, "tools", "build", "halo_ab"))
    os.makedirs(out_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    files = {"other": [], "here": []}
    for t in range(turns):
        for name, tree in (("other", other), ("here", HERE)):
            npz = os.path.join(out_dir, f"{name}_{t}.npz")
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 npz], capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
                return res.returncode
            print(res.stdout.strip().splitlines()[-1], flush=True)
            files[name].append(npz)

    def equal(a, b):
        x, y = np.load(a), np.load(b)
        return {k: bool(np.array_equal(x[k], y[k])) for k in x.files}
    verdict = {"other_vs_here": equal(files["other"][0], files["here"][0])}
    if turns > 1:
        verdict["here_repeat"] = equal(files["here"][0], files["here"][1])
        verdict["other_repeat"] = equal(files["other"][0],
                                        files["other"][1])
    print(json.dumps(verdict), flush=True)
    return 0 if all(verdict["other_vs_here"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Command-line driver of the port — flag-compatible with
``phylo_hmrf_tpu/cli.py`` (and so with the reference's ``python
phylo_hmrf.py [opts]``, reference phylo_hmrf.py:1531-1761).

    python -m phylo_hmrf_tpu_torch.cli -n 10 --chromvec 21 --miter 5 \\
        -p example_input --output out/ --checkpoint ck.npz

It reads the reference's input layout (tree files, ``path_list.txt``,
``<ref>.chrom.sizes``, per-species ``chrN.<res/1000>K.txt`` contact lists
and ``chrN.synteny.txt``), loads the regions with the port's numpy loader
(``data/pipeline.py``), fits ``PhyloHMRF`` on the card and writes the
reference's ``.mat`` (and its ``.npz`` twin). ``--checkpoint`` saves the EM
state every ``--checkpoint_every`` iterations and a rerun with the same
path resumes from it; ``--reload 1`` reads the preprocessing cache.

One flag is the port's own: ``--device`` (default ``cuda``; ``cpu`` runs
every kernel's plain PyTorch version). ``--device cuda`` without CUDA
raises. Multi-process runs (``--num_processes > 1``, ``--coordinator``)
are not ported and raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from phylo_hmrf_tpu_torch.config import LABELERS


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Phylo-HMRF state estimation (PyTorch/CUDA)")
    a = p.add_argument
    a("-n", "--num_states", default="10")
    a("-f", "--chromosome", default="1")
    a("-p", "--root_path", default=".")
    # accepted-for-compatibility flags (no effect on the main estimation
    # path in the reference either: phylo_hmrf.py:1535-1548)
    a("-l", "--length", default="one")
    a("-m", "--multiple", default="true")
    a("-a", "--species_name", default="human")
    a("-o", "--sort_states", default="false")
    a("-s", "--simu_version", default="1")
    a("-u", "--position1", default="0")
    a("-v", "--position2", default="50000")
    a("-r", "--run_id", default="0")
    a("-c", "--cons_param", default="1")
    a("-t", "--method_mode", default="1")
    a("-d", "--initial_mode", default="0")
    a("-i", "--initial_weight", default="0.3")
    a("-k", "--initial_weight1", default="0.1")
    a("-j", "--initial_magnitude", default="1")
    a("-w", "--filter_sigma", default="0.25")
    a("-b", "--beta", default="1")
    a("--beta1", default="0.5")
    a("--num_neighbor", default="8")
    a("--filter_mode", default="0")
    a("-e", "--threshold", default="0.001")
    a("-g", "--estimate_type", default="0")
    a("-q", "--annotation", default="test")
    a("--dtype", default="0", help="diagonal type")
    a("--reload", dest="reload_mode", default="0")
    a("--quantile", default="1")
    a("--miter", default="60")
    a("--resolution", default="50000")
    a("--ref_species", default="hg38")
    a("--chromvec", default="1")
    a("--output", default=".")
    a("--labeler", default="mf_icm",
      help=f"one of {', '.join(LABELERS)}, or a budgeted hybrid "
           f"'mf_icm+swap@N' / 'mf_icm+expansion@N' (exact moves every "
           f"N-th iteration and when the cost stalls)")
    a("--final_polish", default="1",
      help="1: polish the final state map with one exact on-device pass")
    a("--polish_method", default="expansion", choices=["swap", "expansion"])
    a("--shard_mode", default="region", choices=["region", "spatial"])
    a("--mask_mode", default="structural", choices=["structural", "observed"])
    a("--seed", default="0")
    a("--n_devices", default="0",
      help="shards of the mesh; 0 = every visible CUDA device (1 with "
           "--device cpu)")
    a("--coordinator", default="",
      help="multi-host coordinator address (not ported: raises)")
    a("--num_processes", default="0",
      help="multi-host: total process count (> 1 is not ported: raises)")
    a("--process_id", default="-1", help="multi-host: this process's id")
    a("--checkpoint", default="", help="EM checkpoint file; enables resume")
    a("--checkpoint_every", default="5",
      help="save the EM checkpoint every N iterations")
    a("--n_workers", default="0", help="data-loading process pool size")
    a("--profile_dir", default="",
      help="write a torch.profiler Chrome trace here")
    a("--cost_log", default="", help="JSONL per-iteration cost log file")
    a("--run_json", default="",
      help="write a machine-readable run artifact (config, walls, phase "
           "timings, cost trajectory, final metrics) to this path")
    a("--device", default="cuda",
      help="torch device of the fit: cuda (the default; raises without "
           "CUDA) or cpu")
    return p.parse_args(argv)


def _write_run_json(path, *, opts, cfg, x_max, walls, model, result,
                    out_file):
    """The run artifact, in the JAX command line's schema
    (``phylo_hmrf_tpu.run/1``), with the environment read from torch."""
    import torch

    on_cuda = model.device.type == "cuda"
    used = np.unique(result.labels).size if result.labels is not None else 0
    cost = np.asarray(result.cost_vec, dtype=float)
    doc = {
        "schema": "phylo_hmrf_tpu.run/1",
        "config": {
            "n_states": cfg.n_states, "beta": cfg.beta, "beta1": cfg.beta1,
            "estimate_type": cfg.estimate_type, "max_iter": cfg.max_iter,
            "threshold": cfg.threshold, "resolution": cfg.resolution,
            "labeler": cfg.labeler, "final_polish": cfg.final_polish,
            "polish_method": cfg.polish_method, "seed": cfg.seed,
            "dtype": cfg.dtype, "chromvec": opts.chromvec,
            "num_processes": 1,
        },
        "environment": {
            "backend": "cuda" if on_cuda else "cpu",
            "device_kind": (torch.cuda.get_device_name(model.device)
                            if on_cuda else "cpu"),
            "n_devices": torch.cuda.device_count() if on_cuda else 1,
        },
        # peak device memory of the torch allocator (bytes); null on the CPU
        "hbm_peak_bytes": (int(torch.cuda.max_memory_allocated(model.device))
                           if on_cuda else None),
        "x_max": x_max,
        "n_samples": int(model.n_samples),
        "n_regions": len(model.regions),
        "walls_s": {k: round(v, 3) for k, v in walls.items()},
        "phase_timings": model.timer.summary(),
        "cost_trajectory": cost.tolist(),
        "final": {
            "n_iters": int(result.n_iters),
            "iter_id1": int(result.iter_id1),
            "iter_id2": int(result.iter_id2),
            "final_cost1": float(cost[-1, 3]) if cost.size else None,
            "best_cost1": float(cost[:, 3].min()) if cost.size else None,
            "states_used": int(used),
            "output_file": out_file,
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"run artifact -> {path}")


def _config(opts):
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig

    return PhyloHMRFConfig(
        n_states=int(opts.num_states),
        beta=float(opts.beta), beta1=float(opts.beta1),
        cons_param=float(opts.cons_param),
        estimate_type=int(opts.estimate_type),
        initial_mode=int(opts.initial_mode),
        initial_weight=float(opts.initial_weight),
        initial_weight1=float(opts.initial_weight1),
        initial_magnitude=float(opts.initial_magnitude),
        max_iter=int(opts.miter), threshold=float(opts.threshold),
        resolution=int(opts.resolution),
        num_neighbor=int(opts.num_neighbor),
        filter_mode=int(opts.filter_mode),
        filter_sigma=float(opts.filter_sigma),
        diagonal_type=int(opts.dtype),
        labeler=opts.labeler, seed=int(opts.seed),
        final_polish=bool(int(opts.final_polish)),
        polish_method=opts.polish_method,
        shard_mode=opts.shard_mode, mask_mode=opts.mask_mode,
        run_id=int(opts.run_id), output_path=opts.output,
        annotation=opts.annotation)


def _resolve_paths(data_path: str) -> list:
    """The species directories of ``path_list.txt``. Relative entries are
    tried against the CWD, the data dir's parent (the reference layout:
    example_input/test_data/...), then the data dir itself."""
    with open(os.path.join(data_path, "path_list.txt")) as f:
        paths = [line.strip() for line in f if line.strip()]

    def _resolve(p):
        if os.path.isabs(p) or os.path.exists(p):
            return p
        parent = os.path.dirname(data_path.rstrip("/")) or "."
        cand = os.path.join(parent, p)
        if os.path.exists(cand):
            return cand
        return os.path.join(data_path, p)
    return [_resolve(p) for p in paths]


def run(opts) -> str:
    import torch

    from phylo_hmrf_tpu_torch.data.contacts import (quantile_contact_vec,
                                                    x_max_from_quantiles)
    from phylo_hmrf_tpu_torch.data.pipeline import (load_cache, load_dataset,
                                                    save_cache)
    from phylo_hmrf_tpu_torch.models.hmrf import PhyloHMRF, _check_config
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.tree import load_tree
    from phylo_hmrf_tpu_torch.utils.io import save_estimate
    from phylo_hmrf_tpu_torch.utils.profiling import torch_trace

    t_start = time.perf_counter()
    walls = {}
    # refuse what the port does not run before any data is read
    if int(opts.num_processes) > 1 or opts.coordinator:
        raise NotImplementedError(
            "multi-process runs (--num_processes > 1, --coordinator) are "
            "not ported yet")
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {opts.device} requested but CUDA is "
                           f"not available (pass --device cpu)")
    cfg = _config(opts)
    _check_config(cfg, None)

    data_path = opts.root_path
    tree = load_tree(os.path.join(data_path, "edge.1.txt"),
                     os.path.join(data_path, "branch_length.1.txt"),
                     os.path.join(data_path, "species_name.1.txt"))
    paths = _resolve_paths(data_path)
    species = list(tree.species)
    if opts.chromvec == "-1":
        chrom_vec = list(range(1, 23))
    else:
        chrom_vec = [int(c) for c in opts.chromvec.split(",")]
    ref_filename = os.path.join(data_path, f"{opts.ref_species}.chrom.sizes")

    # quantile normalization constant (reference phylo_hmrf.py:1648-1664);
    # the per-chromosome rows are kept in the working directory
    qfile = "chrom_quantile_test.txt"
    if int(opts.quantile) == 0 and os.path.exists(qfile):
        m_vec = np.loadtxt(qfile, delimiter="\t")
        x_max = float(np.median(np.atleast_2d(m_vec)[:, 6]))
    else:
        m_vec = quantile_contact_vec(chrom_vec, cfg.resolution,
                                     ref_filename, paths, species,
                                     cfg.legacy_bin_count)
        np.savetxt(qfile, m_vec, fmt="%.4f", delimiter="\t")
        x_max = x_max_from_quantiles(m_vec)
    print(f"x_max = {x_max}")
    walls["quantile_s"] = time.perf_counter() - t_start

    t_load = time.perf_counter()
    regions = None
    if int(opts.reload_mode) == 1:
        regions = load_cache(opts.output, cfg)
        if regions is None:
            print("cache missing, recomputing")
    if regions is None:
        regions, _ = load_dataset(chrom_vec, cfg, ref_filename, paths,
                                  species, data_path, x_max,
                                  n_workers=int(opts.n_workers))
        if regions:
            save_cache(regions, opts.output, cfg)
    walls["load_s"] = time.perf_counter() - t_load

    n_dev = int(opts.n_devices) or (
        torch.cuda.device_count() if device.type == "cuda" else 1)
    mesh = None
    if n_dev > 1:
        # N shards dealt over the visible cards (all on one card when it
        # is the only one), or over the CPU
        mesh = make_mesh((n_dev,), devices=(
            None if device.type == "cuda" else [device]))
    model = PhyloHMRF(tree, regions, cfg, mesh=mesh,
                      device=None if mesh is not None else device)
    ckpt_path = opts.checkpoint or None
    t_fit = time.perf_counter()
    with torch_trace(opts.profile_dir):
        result = model.fit(checkpoint_path=ckpt_path,
                           checkpoint_every=int(opts.checkpoint_every),
                           resume=bool(ckpt_path),
                           cost_log=opts.cost_log or None)
    walls["fit_s"] = time.perf_counter() - t_fit
    print("phase timings:", model.timer.report())

    out_file = save_estimate(result, model.len_vec, opts.output,
                             cfg.run_id, cfg.lambda_0, cfg.n_states)
    print(f"saved {out_file}")
    if opts.run_json:
        walls["total_s"] = time.perf_counter() - t_start
        _write_run_json(opts.run_json, opts=opts, cfg=cfg, x_max=x_max,
                        walls=walls, model=model, result=result,
                        out_file=out_file)
    return out_file


def main(argv=None) -> str:
    """Parse ``argv`` (default: the process's arguments) and run; returns
    the ``.mat`` path."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()

"""The port's multi-process EM (``parallel/distributed.py``,
``parallel/multiproc.py`` and the command line's multi-process branches)
on the CPU, in real OS processes joined by ``torch.distributed`` (gloo):
the partitioners and the collectives against the JAX package's, 2 and 5
processes bitwise against one, the first iteration against the JAX
package's 2-process fit, the command line's merged ``.mat`` against a
single run's, and the per-region E-step bitwise over bucketings.

This file is also its own worker: ``python tests/test_torch_multiproc.py
fit ...`` runs one process of a port fit of the 4-region problem of
tests/multiproc_worker.py (built with the port's modules) and prints its
result as JSON; ``... collectives --pkg torch|jax ...`` runs one process
of the collectives on fixed numpy inputs and saves what it gathered.
Every process a test starts has its own timeout and is killed if it
outlives it.
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_WORKER = os.path.join(REPO, "tests", "multiproc_worker.py")
K = 3


# ------------------------------------------------------------ workers --

def build_problem(tree):
    """The 4-region problem of tests/multiproc_worker.py::build_problem
    with the port's modules (numpy OU moments)."""
    from phylo_hmrf_tpu_torch.data.regions import (flat_index_order,
                                                   region_from_samples)
    from phylo_hmrf_tpu_torch.synth import ou_moments_np

    rng = np.random.default_rng(11)
    params = rng.random((K, tree.n_params)) * 0.5 + 0.2
    n = tree.n_nodes
    for c in range(K):
        params[c, tree.n_params - n:] = 0.6 * c + 0.3
    moments = [ou_moments_np(params[c], tree) for c in range(K)]
    means = np.stack([m for m, _ in moments])
    covs = np.stack([V + 1e-3 * np.eye(tree.n_leaves) for _, V in moments])
    regions = []
    for ridx, h0 in enumerate((16, 12, 20, 14)):
        ii, jj = np.indices((h0, h0))
        lab = ((ii // 5 + jj // 5 + ridx) % K).astype(np.int32)
        rows, cols = flat_index_order(h0, h0, True)
        lab_flat = lab[rows, cols]
        x = np.stack([rng.multivariate_normal(means[c], covs[c] * 0.3)
                      for c in lab_flat]).astype(np.float32)
        regions.append(region_from_samples(
            np.abs(x) + 0.05, h0, h0, True, pad_h=8, pad_w=8,
            region_id=ridx))
    return regions


def fit_worker(args):
    """One process of the port's fit of `build_problem`."""
    import torch

    torch.set_num_threads(1)
    if args.collective_timeout:
        os.environ["PHMRF_COLLECTIVE_TIMEOUT_S"] = str(
            args.collective_timeout)
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.parallel.multiproc import (
        MultiProcessPhyloHMRF, partition_regions)
    from phylo_hmrf_tpu_torch.synth import ou_moments_np
    from phylo_hmrf_tpu_torch.tree import build_tree

    initialize_distributed(f"127.0.0.1:{args.port}", args.nproc, args.pid)
    tree = build_tree([(0, 1), (0, 2), (2, 3), (2, 4)],
                      species=["a", "b", "c"])
    local, total = partition_regions(build_problem(tree), args.nproc,
                                     args.pid)
    cfg = PhyloHMRFConfig(n_states=K, seed=1, max_iter=args.miter,
                          min_iter=99, threshold=0, patience=99,
                          mstep_iters=25, pad_h=8, pad_w=8,
                          final_polish=False,
                          shard_mode="spatial" if args.spatial else "region")
    # with --spatial each process row-shards its own regions over its own
    # mesh: per-process halo sharding x cross-process data parallelism
    mesh = (make_mesh((args.devices,), devices=[torch.device("cpu")])
            if args.spatial else None)
    model = MultiProcessPhyloHMRF(tree, local, cfg, n_samples_total=total,
                                  mesh=mesh,
                                  device=None if mesh else "cpu")
    if args.init == "kmeans":
        model.initialize()   # global-X k-means, process 0's broadcast
    else:
        # the same fixed init on every process and in the comparator
        rng3 = np.random.default_rng(5)
        model.params_vec = rng3.random((K, tree.n_params)) * 0.5 + 0.2
        model.init_ou_params = model.params_vec.copy()
        moments = [ou_moments_np(p, tree) for p in model.params_vec]
        model.means_ = np.stack([m for m, _ in moments])
        model.covars_ = np.stack([V + cfg.min_covar * np.eye(3)
                                  for _, V in moments])
        model.labels_local = [np.zeros(r.shape, np.int32)
                              for r in model.regions]
        model.init_labels = np.zeros(model.n_samples, np.int32)

    def cb(m, it, cost_row, grids):
        if args.kill_after and args.pid == 0 and it + 1 >= args.kill_after:
            os.kill(os.getpid(), signal.SIGKILL)
        if args.stall_after and it + 1 >= args.stall_after:
            import time
            time.sleep(3600)

    result = model.fit(verbose=False, checkpoint_path=args.checkpoint or None,
                       resume=bool(args.checkpoint), checkpoint_every=2,
                       callback=cb)
    print("WORKER_JSON " + json.dumps({
        "pid": args.pid, "n_regions": len(local),
        "cost_vec": np.asarray(result.cost_vec).tolist(),
        "params_vec": np.asarray(result.params_vec).tolist(),
        "params_vec1": np.asarray(result.params_vec1).tolist(),
        "params_sum": float(np.sum(result.params_vec)),
        "n_iters": int(result.n_iters)}))


def collective_inputs(rank):
    """This rank's inputs of every collective (2 ranks)."""
    rng = np.random.default_rng(100 + rank)
    S = 4
    q21 = np.round(rng.random((S, 10)) * 100, 4)
    q22 = q21 + 1000.0
    return {
        # float64 sums with counts above 2^24 (whole-genome 10 kb runs)
        "sum": rng.random((3, 5)) * 1e8 + 2.0 ** 24 + rank,
        # leading dimensions that differ: rank 0's wins
        "bcast_f64": rng.random((3 + 2 * rank, 4)),
        "bcast_i32": rng.integers(-5, 5, (2 + rank, 3)).astype(np.int32),
        # rank 1 holds zero rows
        "ragged_f64": rng.random((3 * (1 - rank), 2, 2)),
        "ragged_i32": rng.integers(0, 9, (4 * (1 - rank), 1)).astype(
            np.int32),
        # keyed quantile rows: rank 0 scanned chr22, rank 1 chr21
        "quant": q22 if rank == 0 else q21,
        "scan": [22] if rank == 0 else [21],
    }


def collective_regions(rank):
    """A region partition over two chromosomes for gather_global_result:
    rank 0 holds chr22's region 1 and chr21's region 0, rank 1 chr21's
    region 1."""
    specs = ([(22, 1, 6), (21, 0, 5)] if rank == 0 else [(21, 1, 4)])
    regions = [types.SimpleNamespace(
        chrom=c, region_id=rid, n_samples=n * (n + 1) // 2, H0=n, W0=n,
        start1=10 * rid, start2=10 * rid, is_diag=True)
        for c, rid, n in specs]
    n_all = sum(r.n_samples for r in regions)
    labels = (np.arange(n_all) * (rank + 3)) % 7
    return (types.SimpleNamespace(regions=regions),
            types.SimpleNamespace(labels=labels.astype(np.int32)))


def collectives_worker(args):
    """One process of the collectives of ``--pkg`` on
    `collective_inputs`; saves the results to OUT/<pkg>_<rank>.npz."""
    if args.pkg == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from phylo_hmrf_tpu.parallel import multiproc as mp
        from phylo_hmrf_tpu.parallel.distributed import (
            initialize_distributed)
    else:
        from phylo_hmrf_tpu_torch.parallel import multiproc as mp
        from phylo_hmrf_tpu_torch.parallel.distributed import (
            initialize_distributed)
    initialize_distributed(f"127.0.0.1:{args.port}", 2, args.pid)
    x = collective_inputs(args.pid)
    out = {"sum": mp._allreduce_sum(x["sum"]),
           "bcast_f64": mp._broadcast_from_zero(x["bcast_f64"]),
           "bcast_i32": mp._broadcast_from_zero(x["bcast_i32"])}
    for key in ("ragged_f64", "ragged_i32"):
        for p, rows in enumerate(mp._allgather_ragged(x[key])):
            out[f"{key}_{p}"] = rows
    out["quant"] = mp.gather_quantile_rows(x["quant"], x["scan"], [21, 22])
    out["quant_unkeyed"] = mp.gather_quantile_rows(x["quant"])
    model, result = collective_regions(args.pid)
    out["state_vec"], out["len_vec"] = mp.gather_global_result(
        model, result, [21, 22])
    np.savez(os.path.join(args.out, f"{args.pkg}_{args.pid}.npz"), **out)
    print("WORKER_JSON {}")


def worker_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["fit", "collectives"])
    ap.add_argument("--port", required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--miter", type=int, default=3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="SIGKILL self after this many iterations (pid 0)")
    ap.add_argument("--stall-after", type=int, default=0,
                    help="sleep forever after this many iterations")
    ap.add_argument("--collective-timeout", type=float, default=0,
                    help="PHMRF_COLLECTIVE_TIMEOUT_S for this worker")
    ap.add_argument("--init", choices=["fixed", "kmeans"], default="fixed")
    ap.add_argument("--spatial", action="store_true")
    ap.add_argument("--devices", type=int, default=1,
                    help="CPU shards of this process's mesh (--spatial)")
    ap.add_argument("--pkg", choices=["torch", "jax"], default="torch")
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    try:
        (fit_worker if args.mode == "fit" else collectives_worker)(args)
    finally:
        if args.mode == "fit" or args.pkg == "torch":
            # a gloo group left to the interpreter's teardown can abort
            # the process at exit
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    worker_main()
    sys.exit(0)


# -------------------------------------------------------------- tests --

import pytest  # noqa: E402

ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=1")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _communicate(procs, timeout):
    """(returncode, stdout, stderr) of every process, each waited for at
    most ``timeout`` seconds; survivors are killed."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _worker_json(out, err):
    line = [ln for ln in out.splitlines() if ln.startswith("WORKER_JSON ")]
    assert line, out[-2000:] + err[-2000:]
    return json.loads(line[0][len("WORKER_JSON "):])


def _start(cmds, cwd=None, env=ENV):
    return [subprocess.Popen(c, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=cwd,
                             env=env) for c in cmds]


def _run_workers(nproc, extra_per_pid=lambda pid: [], mode="fit",
                 timeout=240, script=__file__):
    """Run ``nproc`` workers of this file (or of ``script``, the JAX
    package's tests/multiproc_worker.py) on one free port; their JSON by
    process id."""
    port = _free_port()
    head = [sys.executable, script] + ([mode] if script == __file__ else [])
    procs = _start([head + ["--port", str(port), "--pid", str(pid),
                            "--nproc", str(nproc)] + extra_per_pid(pid)
                    for pid in range(nproc)])
    outs = {}
    for pid, (rc, out, err) in enumerate(_communicate(procs, timeout)):
        assert rc == 0, f"pid {pid} exited {rc}: {err[-3000:]}"
        outs[pid] = _worker_json(out, err)
    return outs


@pytest.fixture(scope="module")
def fits():
    """fits(nproc, init="fixed", miter=3): the workers' JSON of a port
    fit, each configuration run once for the module."""
    done = {}

    def fit(nproc, init="fixed", miter=3):
        key = (nproc, init, miter)
        if key not in done:
            done[key] = _run_workers(nproc, lambda pid: [
                "--miter", str(miter), "--init", init])
        return done[key]
    return fit


# ------------------------------------------------------- partitioners --

def _write_synteny(root, layout, res=50000):
    """chrN.synteny.txt files: {chrom: [(start_bin, stop_bin), ...]}."""
    for c, blocks in layout.items():
        with open(os.path.join(root, f"chr{c}.synteny.txt"), "w") as f:
            for a, b in blocks:
                f.write(f"{a * res}\t{b * res}\t{(b - a) * res}\n")


# 3 blocks on chr21 and 1 on chr22 (tests/test_multiproc_fit.py:261-299),
# plus a 2-block chr3 and a 1-block chr7 of other sizes
LAYOUT = {21: [(0, 10), (10, 20), (20, 30)], 22: [(0, 12)],
          3: [(0, 7), (9, 25)], 7: [(0, 40)]}
CHROM_VEC = [21, 22, 3, 7]


def _partitioner_outputs(pkg, root, nproc):
    """Every partitioner of ``pkg`` for every process id of ``nproc``,
    on LAYOUT and on a diagonal-only config."""
    if pkg == "jax":
        from phylo_hmrf_tpu.config import PhyloHMRFConfig
        from phylo_hmrf_tpu.parallel import multiproc as mp
    else:
        from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
        from phylo_hmrf_tpu_torch.parallel import multiproc as mp
    regions = [types.SimpleNamespace(n_samples=n)
               for n in (5, 9, 9, 1, 40, 7, 9, 3, 12, 12, 2)]
    out = {}
    for dt in (0, 1):
        cfg = PhyloHMRFConfig(n_states=3, resolution=50000, diagonal_type=dt)
        out[dt] = o = {}
        o["estimate_chrom_samples"] = [
            mp.estimate_chrom_samples(c, root, cfg) for c in CHROM_VEC]
        o["estimate_region_samples"] = [
            mp.estimate_region_samples(c, root, cfg) for c in CHROM_VEC]
        for pid in range(nproc):
            local, total = mp.partition_regions(regions, nproc, pid)
            o.setdefault("partition_regions", []).append(
                ([regions.index(r) for r in local], total))
            o.setdefault("partition_chromosomes", []).append(
                mp.partition_chromosomes(CHROM_VEC, root, cfg, nproc, pid))
            chroms, filters = mp.partition_chromosome_regions(
                CHROM_VEC, root, cfg, nproc, pid)
            o.setdefault("partition_chromosome_regions", []).append(
                (chroms, filters))
            o.setdefault("quantile_scan_chromosomes", []).append(
                mp.quantile_scan_chromosomes(CHROM_VEC, root, cfg, filters))
    return out


PARTITIONERS = ("partition_regions", "estimate_chrom_samples",
                "partition_chromosomes", "estimate_region_samples",
                "partition_chromosome_regions", "quantile_scan_chromosomes")


@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("fn", PARTITIONERS)
def test_partitioners_match_jax(tmp_path, fn, nproc):
    """Each partitioner (host-only, no collective) gives the JAX
    package's output for every process id, exactly."""
    _write_synteny(str(tmp_path), LAYOUT)
    got = _partitioner_outputs("torch", str(tmp_path), nproc)
    want = _partitioner_outputs("jax", str(tmp_path), nproc)
    for dt in (0, 1):
        assert got[dt][fn] == want[dt][fn], (dt, fn)


def test_quantile_scan_owner_unique_per_chromosome(tmp_path):
    """Twin of tests/test_multiproc_fit.py::
    test_quantile_scan_owner_unique_per_chromosome on the port: under a
    region partition of the non-uniform 3+1 layout, exactly one process
    (the owner of the chromosome's lowest region_id) scans each
    chromosome, for every process count."""
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.parallel.multiproc import (
        estimate_region_samples, partition_chromosome_regions,
        quantile_scan_chromosomes)

    res = 50000
    _write_synteny(str(tmp_path), {21: LAYOUT[21], 22: LAYOUT[22]}, res)
    cfg = PhyloHMRFConfig(n_states=3, resolution=res)
    chrom_vec = [21, 22]
    min_rid = {c: min(r for r, _ in
                      estimate_region_samples(c, str(tmp_path), cfg))
               for c in chrom_vec}
    for nproc in (3, 4, 6, 8):
        owners = {c: [] for c in chrom_vec}
        for pid in range(nproc):
            local, filters = partition_chromosome_regions(
                chrom_vec, str(tmp_path), cfg, nproc, pid)
            scan = quantile_scan_chromosomes(chrom_vec, str(tmp_path), cfg,
                                             filters)
            for c in scan:
                owners[c].append(pid)
                assert min_rid[c] in filters[c]
            assert set(scan) <= set(local)
        for c in chrom_vec:
            assert len(owners[c]) == 1, (nproc, c, owners)


def test_gather_quantile_rows_keyed_single_process_order():
    """Twin of tests/test_multiproc_fit.py::
    test_gather_quantile_rows_keyed_single_process_order: with one
    process the gather is an identity, so the keyed sort restores the
    chrom_vec order directly; the unkeyed path returns its input."""
    from phylo_hmrf_tpu_torch.parallel.multiproc import gather_quantile_rows

    S = 4
    rows21 = np.arange(S * 10, dtype=np.float64).reshape(S, 10)
    rows22 = rows21 + 100.0
    local = np.concatenate([rows22, rows21], axis=0)
    merged = gather_quantile_rows(local, scan_chroms=[22, 21],
                                  chrom_vec=[21, 22])
    np.testing.assert_array_equal(
        merged, np.concatenate([rows21, rows22], axis=0))
    np.testing.assert_array_equal(gather_quantile_rows(local), local)


# -------------------------------------------------------- collectives --

@pytest.fixture(scope="module")
def collective_results(tmp_path_factory):
    """The saved results of a 2-process gloo world of the port and a
    2-process jax.distributed world of the JAX package, same inputs."""
    out = str(tmp_path_factory.mktemp("collectives"))
    for pkg in ("torch", "jax"):
        _run_workers(2, lambda pid: ["--pkg", pkg, "--out", out],
                     mode="collectives")
    return {(pkg, pid): dict(np.load(os.path.join(out, f"{pkg}_{pid}.npz")))
            for pkg in ("torch", "jax") for pid in range(2)}


COLLECTIVES = {
    "allreduce_sum": ("sum",),
    "broadcast_from_zero": ("bcast_f64", "bcast_i32"),
    "allgather_ragged": ("ragged_f64_0", "ragged_f64_1", "ragged_i32_0",
                         "ragged_i32_1"),
    "gather_quantile_rows": ("quant", "quant_unkeyed"),
    "gather_global_result": ("state_vec", "len_vec"),
}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collectives_match_jax(collective_results, name):
    """Each collective of the port (gloo) gives, on every process,
    bitwise the JAX package's result (jax.distributed) on the same
    inputs: same dtype, shape and bytes."""
    for pid in range(2):
        got, want = collective_results["torch", pid], \
            collective_results["jax", pid]
        for key in COLLECTIVES[name]:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
            assert got[key].tobytes() == want[key].tobytes(), key
    r = collective_results["torch", 0]
    if name == "allgather_ragged":
        assert r["ragged_f64_1"].shape == (0, 2, 2)
    if name == "allreduce_sum":
        want = collective_inputs(0)["sum"] + collective_inputs(1)["sum"]
        assert r["sum"].tobytes() == want.tobytes()
        assert r["sum"].min() > 2.0 ** 24


# ------------------------------------------------------------- fits --

@pytest.mark.parametrize("nproc,init", [(2, "fixed"), (2, "kmeans"),
                                        (5, "fixed")])
def test_multiprocess_fit_matches_single(fits, nproc, init):
    """Twin of tests/test_multiproc_fit.py::
    test_two_process_fit_matches_single: the 4-region problem over
    ``nproc`` processes (5: one process holds no region and still joins
    every collective) reproduces the 1-process fit BITWISE — cost rows
    and parameters — with every process in lockstep. ``kmeans``: the
    k-means of the gathered global X and process 0's broadcast."""
    single = fits(1, init)[0]
    multi = fits(nproc, init)
    assert sorted(m["n_regions"] for m in multi.values()) == (
        [2, 2] if nproc == 2 else [0, 1, 1, 1, 1])
    for pid in range(1, nproc):
        assert multi[pid]["cost_vec"] == multi[0]["cost_vec"]   # lockstep
        assert multi[pid]["params_vec"] == multi[0]["params_vec"]
    assert multi[0]["n_iters"] == single["n_iters"] == 3
    np.testing.assert_array_equal(np.asarray(multi[0]["cost_vec"]),
                                  np.asarray(single["cost_vec"]))
    np.testing.assert_array_equal(np.asarray(multi[0]["params_vec"]),
                                  np.asarray(single["params_vec"]))
    np.testing.assert_array_equal(np.asarray(multi[0]["params_vec1"]),
                                  np.asarray(single["params_vec1"]))


def test_two_process_fit_first_iteration_matches_jax(fits):
    """The port's 2-process fit against the JAX package's
    (tests/multiproc_worker.py), both from the fixed init: the first
    iteration's cost row within rtol 1e-5 (the problems are built from
    the same seeds with float64 / float32 OU moments). Whole trajectories
    part after the first M-step (ROADMAP §3), so nothing later is
    compared."""
    port = fits(2, "fixed")
    ref = _run_workers(2, lambda pid: ["--miter", "3"],
                       script=JAX_WORKER)
    assert ref[0]["cost_vec"] == ref[1]["cost_vec"]
    np.testing.assert_allclose(np.asarray(port[0]["cost_vec"])[0],
                               np.asarray(ref[0]["cost_vec"])[0],
                               rtol=1e-5)


def test_two_process_spatial_fit_matches_single():
    """Twin of tests/test_multiproc_fit.py::
    test_two_process_spatial_fit_matches_single: each process row-shards
    its regions over its own mesh of 4 CPU shards (K7/K8's plain
    versions on the 4- and 6-row shards); the 2-process fit is lockstep
    and bitwise the 1-process spatial fit."""
    sp = ["--miter", "3", "--spatial", "--devices", "4"]
    single = _run_workers(1, lambda pid: list(sp))
    multi = _run_workers(2, lambda pid: list(sp))
    assert multi[0]["cost_vec"] == multi[1]["cost_vec"]
    np.testing.assert_array_equal(np.asarray(multi[0]["cost_vec"]),
                                  np.asarray(single[0]["cost_vec"]))
    assert multi[0]["params_vec"] == single[0]["params_vec"]


def test_elastic_recovery_sigkill_restart(tmp_path, fits):
    """Twin of tests/test_multiproc_fit.py::
    test_elastic_recovery_sigkill_restart: process 0 SIGKILLs itself at
    iteration 3 (after the checkpoint of iteration 1), process 1 is
    killed by the test; both restart from their checkpoints and finish
    on the uninterrupted run's trajectory (rtol 1e-9, the JAX test's;
    compared bitwise too)."""
    cks = [str(tmp_path / f"ck{pid}.npz") for pid in range(2)]
    ref = fits(2, "fixed", miter=5)
    port = _free_port()
    procs = _start([[sys.executable, __file__, "fit", "--port", str(port),
                     "--pid", str(pid), "--nproc", "2", "--miter", "5",
                     "--checkpoint", cks[pid], "--kill-after", "3"]
                    for pid in range(2)])
    try:
        procs[0].wait(timeout=240)
        assert procs[0].returncode == -signal.SIGKILL
        try:
            procs[1].wait(timeout=20)
        except subprocess.TimeoutExpired:
            pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)
    assert os.path.exists(cks[0]) and os.path.exists(cks[1])
    resumed = _run_workers(2, lambda pid: ["--miter", "5", "--checkpoint",
                                           cks[pid]])
    assert resumed[0]["cost_vec"] == resumed[1]["cost_vec"]
    cv_ref = np.asarray(ref[0]["cost_vec"])
    cv_res = np.asarray(resumed[0]["cost_vec"])
    tail = cv_ref[-cv_res.shape[0]:]
    np.testing.assert_allclose(cv_res, tail, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(cv_res, tail)
    assert resumed[0]["params_sum"] == pytest.approx(ref[0]["params_sum"],
                                                     rel=1e-6)


def test_collective_timeout_detects_hung_peer():
    """Twin of tests/test_multiproc_fit.py::
    test_collective_timeout_detects_hung_peer: with
    PHMRF_COLLECTIVE_TIMEOUT_S set, a process whose peer hangs exits 17
    with a restart hint instead of waiting on the gather."""
    port = _free_port()
    args = {0: ["--miter", "4", "--collective-timeout", "8"],
            1: ["--miter", "4", "--stall-after", "2"]}
    procs = _start([[sys.executable, __file__, "fit", "--port", str(port),
                     "--pid", str(pid), "--nproc", "2"] + args[pid]
                    for pid in range(2)])
    try:
        _, err0 = procs[0].communicate(timeout=240)
        assert procs[0].returncode == 17, (procs[0].returncode,
                                           err0[-2000:])
        assert "timed out" in err0 and "checkpoint" in err0, err0[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)


# ------------------------------------------------------- bucketing --

def test_bucket_invariance_bitwise():
    """Twin of tests/test_em.py::test_bucket_batching_bitwise_stable on
    the port's plain route: an R=2 `_estep_bucket` equals two R=1 calls
    BITWISE in labels, per-region stats, costs and valid counts — what
    the multi-process parity rests on."""
    import torch

    from phylo_hmrf_tpu_torch.models.hmrf import _estep_bucket
    from phylo_hmrf_tpu_torch.synth import chr21_problem

    torch.set_num_threads(1)
    _, region, means, covs, _, _ = chr21_problem(0, h0=40, K=3)
    img = np.stack([region.img, region.img])
    rng2 = np.random.default_rng(7)
    img[1] = img[1][..., ::-1] * 0.7 + 0.1 * rng2.random(img[1].shape)
    mask = np.stack([region.mask] * 2)
    dmaps = np.stack([region.dmaps] * 2)
    warm = np.zeros(mask.shape, np.int32)

    def est(sl):
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa
        return _estep_bucket(f32(img[sl]), torch.as_tensor(mask[sl]),
                             f32(dmaps[sl]), torch.as_tensor(warm[sl]),
                             f32(means), f32(covs), 1.0, 0.5,
                             weighted_pp=False, max_sweeps=60, plain=True)

    lab2, st2, c2, n2 = est(slice(None))
    for i in range(2):
        lab1, st1, c1, n1 = est(slice(i, i + 1))
        assert torch.equal(lab2[i], lab1[0])
        for a, b in zip(st2, st1):
            assert torch.equal(a[i], b[0])
        assert torch.equal(c2[i], c1[0]) and torch.equal(n2[i], n1[0])


# -------------------------------------------------- initialization --

@pytest.mark.parametrize("env,args,error", [
    ({}, (), None),
    ({"JAX_NUM_PROCESSES": "1"}, (), None),
    ({}, ("127.0.0.1:1", None, 0), "--num_processes"),
    ({}, ("127.0.0.1:1", 2, None), "--process_id"),
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2"},
     (), "--process_id"),
    ({}, (None, 2, 0), "--coordinator"),
    ({}, ("127.0.0.1:1", 2, 2), "outside"),
])
def test_initialize_distributed_single_process_and_missing_flags(
        monkeypatch, env, args, error):
    """No coordinator and at most one process: a no-op with the summary
    dict; a coordinator without a process count or id (the JAX package
    would discover a TPU pod) raises, naming the missing flag, before
    any process group is made."""
    import torch.distributed as dist

    from phylo_hmrf_tpu_torch.parallel.distributed import (
        initialize_distributed)

    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if error is None:
        assert initialize_distributed(*args) == {
            "distributed": False, "process_index": 0, "process_count": 1,
            "n_devices": 1, "n_local_devices": 1}
    else:
        with pytest.raises(ValueError, match=error):
            initialize_distributed(*args)
    assert not dist.is_initialized()


# -------------------------------------------------- command line --

def _cli_runs(tmp_path, ex, nproc, n_states, timeout=600):
    """The port's command line on the dataset ``ex``, once as one process
    and once as ``nproc`` processes on a free port, all at once; returns
    the two working directories."""
    base = [sys.executable, "-m", "phylo_hmrf_tpu_torch.cli", "-n",
            str(n_states), "-p", str(ex), "--chromvec", "21,22", "--miter",
            "2", "--seed", "1", "--device", "cpu", "--output", "out",
            "--run_json", "run.json"]
    single, multi = tmp_path / "single", tmp_path / "multi"
    single.mkdir()
    multi.mkdir()
    port = _free_port()
    procs = _start([base], cwd=str(single)) + _start(
        [base + ["--coordinator", f"127.0.0.1:{port}", "--num_processes",
                 str(nproc), "--process_id", str(pid)]
         for pid in range(nproc)], cwd=str(multi))
    for i, (rc, out, err) in enumerate(_communicate(procs, timeout)):
        assert rc == 0, f"run {i} exited {rc}: {err[-3000:]}"
    return single, multi


def _assert_merged_matches(single, multi, n_states, nproc):
    """One merged .mat at the top level equal to the single run's:
    len_vec and state_vec exactly, cost_vec within rtol 1e-7 / atol 1e-9
    and params_vec1 within rtol 1e-6 (the JAX test's tolerances);
    returns whether all of it is bitwise."""
    import scipy.io

    name = f"estimate_ou_0_1.00_{n_states}.mat"
    mats = [p.relative_to(multi) for p in multi.rglob("*.mat")]
    assert [str(p) for p in mats] == [f"out/{name}"], mats
    s = scipy.io.loadmat(str(single / "out" / name))
    m = scipy.io.loadmat(str(multi / "out" / name))
    np.testing.assert_array_equal(m["len_vec"], s["len_vec"])
    np.testing.assert_array_equal(m["state_vec"], s["state_vec"])
    np.testing.assert_allclose(m["cost_vec"], s["cost_vec"], rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(m["params_vec1"], s["params_vec1"],
                               rtol=1e-6)
    with open(multi / "run.json") as f:
        assert json.load(f)["config"]["num_processes"] == nproc
    with open(single / "run.json") as f:
        assert json.load(f)["config"]["num_processes"] == 1
    return all(np.array_equal(m[k], s[k]) for k in (
        "cost_vec", "params_vec1", "params_vec2", "state_vec"))


def test_cli_two_process_matches_single(tmp_path, record_property):
    """Twin of tests/test_multiproc_fit.py::
    test_cli_two_process_end_to_end: the chromosomes are dealt before any
    data is read, the init is global, process 0 alone writes the one
    merged .mat (the default pipeline, final polish on) and run.json
    counts 2 processes. The match is also bitwise on this input."""
    from phylo_hmrf_tpu_torch.synth import write_example

    write_example(str(tmp_path / "ex"), n_bins=30, n_states=3,
                  chroms=(21, 22))
    single, multi = _cli_runs(tmp_path, tmp_path / "ex", 2, 3)
    bitwise = _assert_merged_matches(single, multi, 3, 2)
    record_property("bitwise", bitwise)
    assert bitwise
    assert (multi / "chrom_quantile_test.txt").read_text() == \
        (single / "chrom_quantile_test.txt").read_text()


@pytest.mark.parametrize("nproc,blocks", [(8, (2, 2)), (4, (3, 1))])
def test_cli_region_partition_matches_single(tmp_path, nproc, blocks):
    """Twins of tests/test_multiproc_fit.py::test_cli_pod_scale_8_processes
    (8 processes, 2 blocks a chromosome: more processes than regions, the
    ones without a region join every collective) and
    ::test_cli_pod_scale_nonuniform_regions (4 processes, 3 blocks on
    chr21 and 1 on chr22: unequal owner counts): REGIONS are dealt, one
    process scans each chromosome's quantiles, and the merged .mat and
    the quantile file equal the single run's."""
    from phylo_hmrf_tpu_torch.synth import write_example

    n_bins = 36
    ex = tmp_path / "ex"
    write_example(str(ex), n_bins=n_bins, n_states=3, chroms=(21, 22))
    res = 50000
    for c, nb in zip((21, 22), blocks):
        edges = np.linspace(2, n_bins - 2, nb + 1).astype(int)
        _write_synteny(str(ex), {c: list(zip(edges[:-1], edges[1:]))}, res)
    single, multi = _cli_runs(tmp_path, ex, nproc, 3)
    _assert_merged_matches(single, multi, 3, nproc)
    assert (multi / "chrom_quantile_test.txt").read_text() == \
        (single / "chrom_quantile_test.txt").read_text()

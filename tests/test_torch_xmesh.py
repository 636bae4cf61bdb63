"""A mesh that spans processes (``make_mesh(..., processes=True)``) on the
CPU, in real OS processes joined by ``torch.distributed`` (gloo): the psum
and halo pattern of tests/distributed_worker.py, the row-sharded (spatial)
fit over 2 processes x 4 CPU shards bitwise against the one-process
8-shard fit and within rtol 1e-5 of the JAX package's fit over 2 processes
x 4 virtual devices, and region sharding across processes refused by
both packages.

This file is also its own worker: ``python tests/test_torch_xmesh.py
pattern|fit|ref --port P --pid I --out DIR [--pkg torch|jax]`` runs one
process and saves what it got under DIR. Every process a test starts has
its own timeout and is killed if it outlives it.
"""

import argparse
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150      # each worker process
FIT_KW = dict(n_states=3, max_iter=3, seed=1, min_iter=0, threshold=1e-12,
              mstep_iters=6, pad_h=8, pad_w=8)


# ------------------------------------------------------------ workers --

def _problem():
    """The regions of tests/test_torch_halo.py's meshed fit: a 64 x 64
    diagonal region (8-row shards over 8: the deep-halo K1/K2 branch) and
    a 32 x 64 off-diagonal one (4-row shards: K7/K8)."""
    from tests.test_torch_fit import synth_problem
    regions, _ = synth_problem(np.random.default_rng(0), H0=64)
    return regions


def _fit_record(model, res, labels):
    return dict(cost_vec=res.cost_vec, labels=res.labels,
                params_vec=res.params_vec, params_list=res.params_list,
                iter_labels=np.stack(labels))


def _run_fit(PhyloHMRF, cfg, mesh, state, import_state, to_host):
    """The meshed fit from ``state`` with every iteration's flat labels
    (``to_host`` reads a label grid)."""
    from phylo_hmrf_tpu_torch.synth import bench_tree

    model = PhyloHMRF(bench_tree(), _problem(), cfg, mesh=mesh)
    import_state(model, state)
    labels = []

    def cb(m, it, row, grids):
        labels.append(np.concatenate([
            r.labels_to_flat(to_host(g)) for r, g in zip(m.regions, grids)]))
    res = model.fit(verbose=False, callback=cb)
    return _fit_record(model, res, labels)


def torch_worker(args):
    import torch

    torch.set_num_threads(1)
    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.convert import import_state
    from phylo_hmrf_tpu_torch.parallel.distributed import (
        exchange_tensors, initialize_distributed)
    from phylo_hmrf_tpu_torch.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.synth import bench_tree

    cpu = torch.device("cpu")

    def to_host(g):
        return g.cpu().numpy()
    if args.mode == "ref":     # the one-process 8-shard mesh
        with open(args.state, "rb") as f:
            state = pickle.load(f)
        rec = _run_fit(PhyloHMRF, PhyloHMRFConfig(shard_mode="spatial",
                                                  **FIT_KW),
                       make_mesh((8,), devices=[cpu]), state, import_state,
                       to_host)
        np.savez(os.path.join(args.out, "ref.npz"), **rec)
        return {}
    info = initialize_distributed(f"127.0.0.1:{args.port}", args.nproc,
                                  args.pid)
    out = {"process_count": info["process_count"]}
    if args.mode == "pattern":
        from phylo_hmrf_tpu_torch.ops.halo_rows import extend_rows
        from phylo_hmrf_tpu_torch.parallel.halo import (gather_rows, psum,
                                                        shard_rows)
        # 4 shards over 2 processes: tests/distributed_worker.py's mesh
        mesh = make_mesh((4,), devices=[cpu], processes=True)
        n = mesh.size
        glob = torch.arange(n * 4, dtype=torch.float32).reshape(n, 4)
        parts = [None if x is None else x.sum()
                 for x in shard_rows(mesh, glob)]
        rows = torch.arange(n * 8, dtype=torch.float32).reshape(n, 8)
        ext = extend_rows(shard_rows(mesh, rows), 1, mesh.owners)
        labels = torch.arange(n * 3 * 5, dtype=torch.int32).reshape(n * 3, 5)
        out.update(
            owners=list(mesh.owners), rank=mesh.rank,
            local=[i for i in range(n) if mesh.is_local(i)],
            psum=float(psum(parts, mesh.owners)),
            halo={i: x.sum(dim=1).tolist() for i, x in enumerate(ext)
                  if x is not None},
            gathered=bool(torch.equal(gather_rows(
                shard_rows(mesh, labels), cpu, mesh.owners), labels)),
            exchanges=exchange_tensors.calls)
        return out
    if args.pkg == "torch":
        with open(args.state, "rb") as f:
            state = pickle.load(f)
        mesh = make_mesh((8,), devices=[cpu], processes=True)
        out["owners"] = list(mesh.owners)
        rec = _run_fit(PhyloHMRF, PhyloHMRFConfig(shard_mode="spatial",
                                                  **FIT_KW),
                       mesh, state, import_state, to_host)
        np.savez(os.path.join(args.out, f"torch_{args.pid}.npz"), **rec)
        try:
            PhyloHMRF(bench_tree(), _problem(),
                      PhyloHMRFConfig(shard_mode="region", **FIT_KW),
                      mesh=mesh)
            out["region"] = "built"
        except ValueError as e:
            out["region"] = f"ValueError: {e}"
        out["exchanges"] = exchange_tensors.calls
    return out


def jax_worker(args):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from jax.experimental import multihost_utils
    jax.config.update("jax_platforms", "cpu")
    from phylo_hmrf_tpu.config import PhyloHMRFConfig
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF
    from phylo_hmrf_tpu.parallel.distributed import initialize_distributed
    from phylo_hmrf_tpu.parallel.mesh import make_mesh
    from phylo_hmrf_tpu_torch.convert import import_state

    def to_host(g):
        # a grid of the spatial fit spans both processes' devices
        return np.asarray(g if g.is_fully_addressable
                          else multihost_utils.process_allgather(g,
                                                                tiled=True))
    info = initialize_distributed(f"127.0.0.1:{args.port}", args.nproc,
                                  args.pid)
    with open(args.state, "rb") as f:
        state = pickle.load(f)
    mesh = make_mesh((8,))
    out = {"process_count": info["process_count"],
           "n_devices": info["n_devices"]}
    if args.mode == "region":
        try:
            _run_fit(PhyloHMRF, PhyloHMRFConfig(shard_mode="region",
                                                **FIT_KW),
                     mesh, state, import_state, to_host)
            out["region"] = "fit"
        except RuntimeError as e:
            out["region"] = f"RuntimeError: {e}"
        return out
    rec = _run_fit(PhyloHMRF, PhyloHMRFConfig(shard_mode="spatial",
                                              **FIT_KW),
                   mesh, state, import_state, to_host)
    np.savez(os.path.join(args.out, f"jax_{args.pid}.npz"), **rec)
    return out


def worker_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["pattern", "fit", "ref", "region"])
    ap.add_argument("--port", default="0")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--pkg", choices=["torch", "jax"], default="torch")
    ap.add_argument("--state", default="")
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    try:
        out = (jax_worker if args.pkg == "jax" else torch_worker)(args)
        print("WORKER_JSON " + json.dumps(out), flush=True)
    finally:
        if args.pkg == "torch":
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

jax = pytest.importorskip("jax")
import torch  # noqa: E402

ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=1",
           PHMRF_COLLECTIVE_TIMEOUT_S="120")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(mode, out, nproc=2, extra=()):
    """``nproc`` workers of this file on one free port (``ref``: one
    process, no group)."""
    port = _free_port()
    n = 1 if mode == "ref" else nproc
    return [subprocess.Popen(
        [sys.executable, __file__, mode, "--port", str(port), "--pid",
         str(pid), "--nproc", str(nproc), "--out", str(out), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
        for pid in range(n)]


def _finish(procs, what, exit_zero=True):
    """The workers' JSON, each waited for at most TIMEOUT_S seconds;
    survivors are killed. Each must exit 0 and print its JSON; without
    ``exit_zero``, a worker that exits non-zero without it gives
    ``{"exit": code, "stderr": its tail}``."""
    done = []
    try:
        for p in procs:
            done.append((p, *p.communicate(timeout=TIMEOUT_S)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    bad = [f"{what} pid {pid} exited {p.returncode}:\n{err[-3000:]}"
           for pid, (p, _, err) in enumerate(done) if p.returncode != 0]
    assert not (bad and exit_zero), "\n".join(bad)
    outs = []
    for p, out, err in done:
        line = [ln for ln in out.splitlines()
                if ln.startswith("WORKER_JSON ")]
        if not line and not exit_zero and p.returncode != 0:
            outs.append({"exit": p.returncode, "stderr": err[-2000:]})
            continue
        assert line, out[-2000:] + err[-2000:]
        outs.append(json.loads(line[0][len("WORKER_JSON "):]))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pattern pair, then, from one JAX initialize() (the 8-device
    mesh of tests/conftest.py), at the same time: the port's fit over 2
    processes x 4 CPU shards, its one-process 8-shard fit and the JAX
    package's fit over 2 processes x 4 virtual devices."""
    from phylo_hmrf_tpu.config import PhyloHMRFConfig
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF
    from phylo_hmrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from phylo_hmrf_tpu_torch.convert import export_state
    from phylo_hmrf_tpu_torch.synth import bench_tree

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    out = tmp_path_factory.mktemp("xmesh")
    pattern = _start("pattern", out)
    jm = JaxPhyloHMRF(bench_tree(), _problem(),
                      PhyloHMRFConfig(shard_mode="spatial", **FIT_KW),
                      mesh=jax_make_mesh((8,)))
    jm.initialize()
    state = os.path.join(out, "state.pkl")
    with open(state, "wb") as f:
        pickle.dump(export_state(jm), f)
    fits = {name: _start(mode, out, extra=["--state", state, "--pkg", pkg])
            for name, mode, pkg in (("torch", "fit", "torch"),
                                    ("ref", "ref", "torch"),
                                    ("jax", "fit", "jax"))}
    got = {"pattern": _finish(pattern, "pattern")}
    for name, procs in fits.items():
        got[name] = _finish(procs, name)
    got.update(out=out, state=state)

    def load(name):
        with np.load(os.path.join(out, f"{name}.npz")) as z:
            return dict(z)
    got["fits"] = {name: load(name) for name in (
        "ref", "torch_0", "torch_1", "jax_0", "jax_1")}
    return got


def test_pattern_gate_two_processes(runs):
    """tests/distributed_worker.py's pattern over the port's mesh of 4
    shards in 2 processes: the psum of the shards' sums is 120.0 on both,
    each shard's halo-extended row sums are [above, own, below] with
    64 * i + 28 a row and zeros at the ends of the mesh; the label rows
    all-gathered are the whole grid on both processes."""
    row_sum = [64 * i + 28 for i in range(4)]
    for pid, res in enumerate(runs["pattern"]):
        assert res["process_count"] == 2
        assert res["owners"] == [0, 0, 1, 1] and res["rank"] == pid
        assert res["local"] == [2 * pid, 2 * pid + 1]
        assert res["psum"] == 120.0
        for i in res["local"]:
            top = row_sum[i - 1] if i > 0 else 0.0
            bot = row_sum[i + 1] if i < 3 else 0.0
            assert res["halo"][str(i)] == [top, row_sum[i], bot]
        assert res["gathered"]
        assert res["exchanges"] == 1


FIT_PARTS = ["cost_vec", "iter_labels", "labels", "params_vec",
             "params_list"]


@pytest.mark.parametrize("part", FIT_PARTS)
def test_xmesh_fit_bitwise_one_process(runs, part):
    """The spatial fit over 2 processes x 4 CPU shards against the
    one-process 8-shard fit from the same state: cost rows, every
    iteration's labels, the polished labels and the params bitwise, on
    both ranks (the deep-halo region and the K7/K8 region are both in
    every label row and every cost)."""
    fits = runs["fits"]
    for rank in (0, 1):
        np.testing.assert_array_equal(fits[f"torch_{rank}"][part],
                                      fits["ref"][part])
    assert [r["owners"] for r in runs["torch"]] == [[0] * 4 + [1] * 4] * 2


def test_xmesh_fit_matches_jax_across_processes(runs):
    """The port's fit over 2 processes against the JAX package's over 2
    processes x 4 virtual devices, from the same state: every cost row
    within rtol 1e-5, the labels of every iteration and the polished
    labels identical; each package's two ranks agree bitwise."""
    fits = runs["fits"]
    for name in ("torch", "jax"):
        for part in FIT_PARTS:
            np.testing.assert_array_equal(fits[f"{name}_0"][part],
                                          fits[f"{name}_1"][part])
    t, j = fits["torch_0"], fits["jax_0"]
    np.testing.assert_allclose(t["cost_vec"], j["cost_vec"], rtol=1e-5)
    np.testing.assert_array_equal(t["iter_labels"], j["iter_labels"])
    np.testing.assert_array_equal(t["labels"], j["labels"])
    assert [r["n_devices"] for r in runs["jax"]] == [8, 8]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_region_mode_across_processes_raises(runs, pkg):
    """shard_mode="region" over a mesh that spans processes: the port
    refuses it when the model is built (ValueError); no process of the
    JAX package's fit completes it: each raises a RuntimeError or dies.
    Alone, both processes raised fetching a value that spans devices of
    another process (``phylo_hmrf_tpu/models/hmrf.py::_scatter_pending``);
    beside other tests, a process may instead raise in a gloo all-gather
    whose peer has gone, or die in a gloo collective out of step."""
    if pkg == "jax":
        results = _finish(_start("region", runs["out"], extra=[
            "--state", runs["state"], "--pkg", "jax"]), "jax region",
            exit_zero=False)
    else:
        results = runs["torch"]
    for res in results:
        if pkg == "torch":
            assert res["region"].startswith("ValueError: a mesh that spans "
                                            "processes"), res["region"]
            assert res["exchanges"] > 0
        elif "exit" in res:
            assert res["exit"] != 0, res
        else:
            assert res["region"].startswith("RuntimeError:"), res["region"]


def test_processes_mesh_of_one_process_is_the_mesh(monkeypatch):
    """``make_mesh(..., processes=True)`` in one process is the default
    mesh (every owner 0) and gives bitwise its row-sharded E-step; over a
    (pretended) group of 2 it deals the shards in blocks, process 0
    first, and refuses a shard count that does not divide."""
    from phylo_hmrf_tpu_torch.parallel import mesh as mesh_mod
    from phylo_hmrf_tpu_torch.parallel.halo import make_rowsharded_estep
    from tests.test_torch_halo import _problem as halo_problem

    cpu = torch.device("cpu")
    one = mesh_mod.make_mesh((8,), devices=[cpu], processes=True)
    base = mesh_mod.make_mesh((8,), devices=[cpu])
    assert one == base and one.owners == (0,) * 8
    assert not one.spans_processes and one.first_device == cpu
    region, means, covs, warm = halo_problem(np.random.default_rng(2),
                                             H0=32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        region.img, region.mask, region.dmaps, warm, means, covs)]
    outs = [make_rowsharded_estep(m, weighted_pp=False, max_sweeps=20)(
        *args, 1.0, 0.5) for m in (one, base)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][2], outs[1][2])

    monkeypatch.setattr(mesh_mod, "process_count", lambda: 2)
    monkeypatch.setattr(mesh_mod, "process_index", lambda: 1)
    two = mesh_mod.make_mesh((4,), devices=["cpu", "meta"], processes=True)
    assert two.owners == (0, 0, 1, 1) and two.rank == 1
    assert two.devices == (cpu, torch.device("meta")) * 2
    assert two.spans_processes and two.first_device == cpu
    assert [two.is_local(i) for i in range(4)] == [False, False, True, True]
    assert "2:cpu@p1" in two.describe()
    with pytest.raises(ValueError, match="processes"):
        mesh_mod.make_mesh((5,), devices=[cpu], processes=True)


def test_row_sources_across_processes():
    """Row sources over owners: a neighbour in another process is remote
    and names its process, whatever its device; `source_peers` lists
    them; the shards of another process (``None``) form no device group
    and get no buffer."""
    from phylo_hmrf_tpu_torch.ops.halo_rows import (
        RowSource, device_groups, is_chained, remote_row_buffers,
        row_sources, source_peers)

    cpu = torch.device("cpu")
    src = row_sources([cpu] * 4, [3, 3, 3, 3], owners=[0, 0, 1, 1])
    assert src[1] == (RowSource(0, 2, False), RowSource(2, 0, True, 1))
    assert src[2] == (RowSource(1, 2, True, 0), RowSource(3, 0, False))
    assert not is_chained(src)
    assert source_peers(src) == {2: 1, 1: 0}
    xs = [torch.zeros(1, 3, 4), torch.zeros(1, 3, 4), None, None]
    assert device_groups(xs, src) == {cpu: [0, 1]}
    bufs = remote_row_buffers(xs, src)
    assert bufs[0] == [None, None] and bufs[2] == [None, None]
    assert bufs[1][0] is None and bufs[1][1].shape == (1, 1, 4)

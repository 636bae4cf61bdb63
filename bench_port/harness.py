"""One run of one cell: set-up, the window of whole fits, the judge, the
metrics. ``run.py`` is the command line around it; the CPU tests call
`run_cell` directly with ``device="cpu"`` at small sizes.

Set-up: the kernel library loaded (built by the program on its first use,
into its own directory of the checkout), the configuration's samples made
from the seed (``synth.make_data``), the program's region grids built
from them (``data/regions.py::region_from_samples``), the tree, and one
warm-up fit of 2 iterations at fit seed ``seed``: every shape a fit runs,
the loop graphs (a process-wide cache) built, a first capture of each
solve.

Window: a closed loop of whole fits, back to back. Fit i is a fresh
``PhyloHMRF(tree, regions, cfg).fit(verbose=False, callback=...)`` with
``cfg.seed = seed + i + 1``: the data stay, the init changes, as in a
user's sweep over seeds. Fits start until ``seconds`` have passed; the
one under way then is finished and counted.

Judge: the fit with the most EM iterations and others drawn from the
seed, each held to the reference stage by stage (``judge.py``) after the
window, once the card's peak memory is read and the models are freed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import synth  # noqa: E402
from judge import Judge, verdict  # noqa: E402
from record import Recorder  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "phylo_hmrf_tpu")
JUDGE_FITS = 2     # fits judged a run: the longest and one drawn from the seed


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with the files it names."""
    name: str
    config: dict          # configs/<file>: regions, model settings
    traffic: dict         # traffic/<name>.json: the fit's mode
    limits: dict          # limits/<workload>.json: the judge's limits
    per_layer: list       # BENCHMARK.json per_layer entries of this cell
    end_to_end: list      # BENCHMARK.json end_to_end entries of this cell
    chips: int = 1

    @property
    def model(self) -> dict:
        return {**self.config["model"], **self.traffic["model"]}


def cell_from_spec(spec: dict, root: str, name: str) -> Cell:
    """The cell ``name`` of the benchmark spec, its files read."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, config=load_json(root, conf["file"]),
        traffic=load_json(HERE, "traffic", w["traffic"] + ".json"),
        limits=load_json(HERE, "limits", name + ".json"),
        per_layer=[m for m in spec["per_layer"] if here(m)],
        end_to_end=[m for m in spec["end_to_end"] if here(m)],
        chips=int(w["chips"]))


def banned_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (whole names: the port's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _inputs(cell: Cell, seed: int):
    """(data, the program's regions, the program's tree, config kwargs)."""
    from phylo_hmrf_tpu_torch.data.regions import region_from_samples
    from phylo_hmrf_tpu_torch.tree import build_tree

    mc = cell.model
    data, _, _ = synth.make_data(seed, cell.config["regions"],
                                 int(mc["n_states"]))
    regions = [region_from_samples(
        d["x"], d["h0"], d["w0"], d["is_diag"],
        num_neighbor=int(mc.get("num_neighbor", 8)),
        pad_h=int(mc["pad_h"]), pad_w=int(mc["pad_w"]), chrom=d["chrom"],
        region_id=i) for i, d in enumerate(data)]
    tree = build_tree(synth.TREE_EDGES, branch_lengths=synth.BRANCH_LENGTHS)
    return data, regions, tree


def _config(cell: Cell, seed: int, **over):
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig

    names = {f.name for f in dataclasses.fields(PhyloHMRFConfig)}
    kw = {k: v for k, v in cell.model.items() if k in names}
    kw.update(over)
    return PhyloHMRFConfig(**kw, seed=int(seed))


def _load_metric(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    mdir = os.path.join(HERE, "metrics")
    if mdir not in sys.path:
        sys.path.insert(0, mdir)
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}",
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Fits:
    """The fits of a run: a fresh model a fit, its record and its
    numbers."""

    def __init__(self, cell: Cell, data, regions, tree, device):
        self.cell, self.data, self.regions, self.tree = (cell, data, regions,
                                                         tree)
        self.device = device

    def fit(self, seed: int, spans: str | None = None, profile=None,
            **over):
        from phylo_hmrf_tpu_torch.models.hmrf import PhyloHMRF

        model = PhyloHMRF(self.tree, self.regions,
                          _config(self.cell, seed, **over),
                          device=self.device)
        marks = None
        if profile is not None:
            from devtrace import Marks
            marks = Marks()
        rec = Recorder(model, self.data, spans=spans, marks=marks)

        def go():
            return model.fit(verbose=False, callback=rec.callback)

        if profile is not None:
            res, prof = profile(go, marks)
        else:
            res, prof = go(), None
        graphs = getattr(model, "_graphs", None) or {}
        info = dict(seed=seed, n_iters=int(res.n_iters), spans=rec.spans,
                    capture_s=sum(g.capture_s for g in graphs.values()),
                    iter_s=list(np.diff(rec.iter_times)),
                    estep_calls=rec.estep_calls, exact_calls=rec.exact_calls,
                    profile=prof)
        host = rec.host(res)
        # the model and its captured graphs (which hold themselves in
        # cycles) go now, not at a later fit's garbage collection
        del model, graphs, res, go
        gc.collect()
        return host, info


def buckets(regions, K: int) -> list:
    """(R, K, H, W) of each shape bucket of the program's padded grids."""
    shapes = {}
    for r in regions:
        shapes[r.img.shape[:2]] = shapes.get(r.img.shape[:2], 0) + 1
    return [(n, K, h, w) for (h, w), n in shapes.items()]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             log=None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr))
    t_start = time.time() if t_start is None else t_start
    cuda = device != "cpu"
    if cuda:
        from phylo_hmrf_tpu_torch import _build
        _build.load()
    data, regions, tree = _inputs(cell, seed)
    fits = Fits(cell, data, regions, tree, device)
    # the warm-up: a fit of 2 iterations runs every shape a fit uses
    # (init, E-step, M-step, polish or exact moves)
    fits.fit(seed, max_iter=2)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start

    profile = None
    if trace and cuda:
        from devtrace import profile_fit
        profile = profile_fit
    records, infos, failed = [], [], 0
    t0 = time.perf_counter()
    i = 0
    while True:
        t_fit = time.perf_counter()
        try:
            # traced: the first fit profiled (host ranges only), the
            # others with synchronized spans
            mode = (("mark" if i == 0 else "sync") if trace and cuda
                    else None)
            host, info = fits.fit(seed + i + 1, spans=mode,
                                  profile=profile if i == 0 else None)
            records.append(host)
            infos.append(info)
        except Exception:   # a fit that raises is a failed fit; go on
            traceback.print_exc()
            failed += 1
        log(f"fit {i} seed {seed + i + 1}: {time.perf_counter() - t_fit:.4f} s")
        i += 1
        # a traced window holds a timed fit beside the profiled one
        if time.perf_counter() - t0 >= seconds and (i >= 2 or not trace):
            break
    window_s = time.perf_counter() - t0
    attempted = i
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del fits
    if cuda:
        torch.cuda.empty_cache()

    # the judge: the longest fit and others drawn from the seed
    numbers, refused = {}, 0
    if records:
        order = sorted(range(len(records)),
                       key=lambda j: -records[j]["n_iters"])
        n_judge = min(len(records), JUDGE_FITS)
        rng = np.random.default_rng(seed)
        rest = list(rng.permutation(order[1:]))
        pick = [order[0]] + rest[:n_judge - 1]
        judge = Judge(data, cell.model)
        for j in pick:
            got = judge.numbers(records[j])
            ok, _ = verdict(got, cell.limits)
            refused += 0 if ok else 1
            for k, v in got.items():
                numbers[k] = max(numbers.get(k, v), v)
    correct, checks = verdict(numbers, cell.limits)
    correct = correct and failed == 0 and bool(records)

    iters = [s for f in infos for s in f["iter_s"]]
    metrics = {}
    if not trace:
        values = {"fit_s": window_s / max(attempted, 1),
                  "em_iter_s": (sum(iters) / len(iters)) if iters else None,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        prof = infos[0]["profile"] if infos else None
        ctx = dict(fits=infos, timed=infos[1:] or infos, profile=prof,
                   buckets=buckets(regions, int(cell.model["n_states"])),
                   peak_bytes=peak, model=cell.model)
        for m in cell.per_layer:
            v = _load_metric(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = dict(correct=bool(correct), attempted=attempted,
               failed=failed + refused, metrics=metrics,
               device=_device(cell, peak, cuda))
    if trace and infos and infos[0]["profile"] is not None:
        from devtrace import breakdown
        p = infos[0]["profile"]
        out["device"].update(busy_s=p["busy_s"], window_s=p["window_s"])
        log(f"profiled fit: {p['records']} device records, "
            f"{p['solves']} solve replays, {p['graph_launches']} loop-graph "
            f"launches")
        out["breakdown"] = breakdown(p)
    out["checks"] = checks
    for name, (v, lim) in checks.items():
        log(f"check {name} = {v!r} limit {lim!r}")
    return out


def _device(cell: Cell, peak: int, cuda: bool) -> dict:
    import torch

    if not cuda:
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=cell.chips, memory_peak_bytes=int(peak),
                power_limit=_power_limit(), torch=torch.__version__,
                cuda=torch.version.cuda)


def _power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None

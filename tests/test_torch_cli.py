"""The port's command line and the modules behind it against the JAX
package, on the CPU: the numpy contact reader against ``pandas``, the
data loader and its cache, the C++ hole fill against its plain version,
the command line itself, a fit of the loaded regions in lockstep with the
JAX engine, and EM checkpoint/resume (bitwise against the uninterrupted
fit, and across packages).

Inputs come from ``examples/make_synthetic_example.py`` (run as a
subprocess, as tests/test_io_cli.py does) at 32-48 bins.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from phylo_hmrf_tpu_torch import native  # noqa: E402
from phylo_hmrf_tpu_torch.synth import bench_tree  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = os.path.join(REPO, "examples", "make_synthetic_example.py")
SPECIES = ["speciesA", "speciesB", "speciesC", "speciesD"]
TREE = bench_tree(SPECIES)
# the lockstep regime of tests/test_torch_fit.py: 6-step M-step solves
FIT_KW = dict(n_states=4, seed=1, min_iter=0, threshold=1e-12,
              mstep_iters=6, pad_h=8, pad_w=8)


def _make(root, name, *args):
    """A dataset of ``examples/make_synthetic_example.py`` in root/name."""
    out = str(root / name)
    subprocess.run([sys.executable, GEN, "--out", out, *args], check=True,
                   capture_output=True, timeout=300)
    return out


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    return {
        "two_chroms": _make(root, "two", "--n-bins", "40", "--n-states",
                            "4", "--chroms", "21,22"),
        "blocks2": _make(root, "blocks", "--n-bins", "48", "--n-states", "4",
                         "--chroms", "21", "--blocks-per-chrom", "2"),
        "res10k": _make(root, "res10k", "--n-bins", "40", "--n-states", "3",
                        "--chroms", "22", "--resolution", "10000"),
        "small": _make(root, "small", "--n-bins", "32", "--n-states", "4",
                       "--chroms", "21"),
    }


def _inputs(data):
    with open(os.path.join(data, "path_list.txt")) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    return os.path.join(data, "hg38.chrom.sizes"), paths


def _chroms(data):
    return sorted(int(n[3:-12]) for n in os.listdir(data)
                  if n.endswith(".synteny.txt"))


def _load(pkg, data, resolution=50000, n_workers=0, **cfg_kw):
    """(regions, x_max) of one package's `load_dataset` on ``data``."""
    if pkg == "jax":
        from phylo_hmrf_tpu.config import PhyloHMRFConfig
        from phylo_hmrf_tpu.data.pipeline import load_dataset
    else:
        from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
        from phylo_hmrf_tpu_torch.data.pipeline import load_dataset
    cfg = PhyloHMRFConfig(resolution=resolution, **cfg_kw)
    sizes, paths = _inputs(data)
    return load_dataset(_chroms(data), cfg, sizes, paths, SPECIES, data,
                        n_workers=n_workers)


def _assert_regions_equal(got, want):
    assert len(got) == len(want) > 0
    off = 0
    for a, b in zip(got, want):
        for f in ("img", "mask", "dmaps", "flat_rows", "flat_cols"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert (a.len_vec_row(off, off + a.n_samples)
                == b.len_vec_row(off, off + b.n_samples))
        off += a.n_samples


# ------------------------------------------------------------- reader --

def _write_contacts(path, rng, fmt, n=400):
    """A contact file the repo's writers could produce: integer bp
    coordinates, values in ``fmt``, with NaN rows and integer values."""
    import pandas as pd

    x1 = rng.integers(0, 60, n) * 50000
    x2 = x1 + rng.integers(0, 20, n) * 50000
    v = rng.random(n) * rng.choice([1e-3, 1.0, 80.0, 4e4], n)
    v[::37] = np.nan
    v[5::41] = np.round(v[5::41] * 100)   # integer values
    if fmt == "pandas_%.4f":    # NaN written as an empty field
        pd.DataFrame({0: x1, 1: x2, 2: v}).to_csv(
            path, sep="\t", header=False, index=False, float_format="%.4f")
        return
    if fmt == "all_integers":
        v = np.floor(np.nan_to_num(v) * 7)
        fmt = "%d"
    with open(path, "w") as f:
        for a, b, c in zip(x1, x2, v):
            f.write(f"{a}\t{b}\t{fmt % c}\n")


@pytest.mark.parametrize("fmt", ["%.4f", "pandas_%.4f", "%.6g",
                                 "all_integers"])
def test_contact_reader_matches_pandas(tmp_path, fmt):
    """`load_contact_list` without pandas gives what ``pd.read_table(path,
    header=None)`` gives on the repo's file formats: int64 coordinates,
    float64 values, NaN where the field is empty or "nan"; bitwise."""
    pd = pytest.importorskip("pandas")
    from phylo_hmrf_tpu_torch.data.contacts import load_contact_list

    path = str(tmp_path / "chr1.50K.txt")
    _write_contacts(path, np.random.default_rng(3), fmt)
    want = pd.read_table(path, header=None)
    x1, x2, v = load_contact_list(path)
    assert (x1.dtype, x2.dtype, v.dtype) == (np.int64, np.int64, np.float64)
    np.testing.assert_array_equal(x1, np.asarray(want[0], np.int64))
    np.testing.assert_array_equal(x2, np.asarray(want[1], np.int64))
    np.testing.assert_array_equal(v, np.asarray(want[2], np.float64))
    if fmt != "all_integers":
        assert np.isnan(v).sum() == np.isnan(want[2]).sum() > 0


def test_loader_full_precision_within_one_f32_ulp(tmp_path, datasets):
    """On 17-digit values pandas' parser is not correctly rounded and the
    port's reader is, so the float64 values may differ by a few ulps; the
    regions' float32 samples stay within one float32 ulp of the JAX
    loader's, and the rest of each region is bitwise."""
    src = datasets["small"]
    data = str(tmp_path / "repr")
    subprocess.run(["cp", "-r", src, data], check=True)
    sizes, paths = _inputs(data)
    rng = np.random.default_rng(0)
    new_paths = []
    for p in paths:
        d = os.path.join(data, os.path.basename(p))
        new_paths.append(d)
        f = os.path.join(d, "chr21.50K.txt")
        rows = np.loadtxt(f, delimiter="\t")
        with open(f, "w") as out:
            for a, b, c in rows:
                c = c * (1 + 1e-9 * rng.standard_normal())
                out.write(f"{int(a)}\t{int(b)}\t{float(c)!r}\n")
    with open(os.path.join(data, "path_list.txt"), "w") as f:
        f.write("\n".join(new_paths) + "\n")
    (ja, _), (ta, _) = (_load(p, data, pad_h=8, pad_w=8)
                        for p in ("jax", "torch"))
    assert len(ja) == len(ta) == 1
    a, b = ta[0], ja[0]
    np.testing.assert_array_max_ulp(a.img, b.img, maxulp=1)
    np.testing.assert_array_equal(a.mask, b.mask)
    np.testing.assert_array_equal(a.flat_rows, b.flat_rows)


# ------------------------------------------------------------- loader --

LOADER_CASES = {
    "two_chroms": ("two_chroms", 50000, {}),
    "blocks2": ("blocks2", 50000, {}),
    # a split point inside the second block: its two halves pair up into
    # an off-diagonal region (synteny.split_regions)
    "centromere_offdiag": ("blocks2", 50000,
                           {"centromere_splits": {21: (1500000, 1800000)}}),
    "mask_observed": ("two_chroms", 50000, {"mask_mode": "observed"}),
    # the default spatial sigma (filter_param2=50) makes a 301 x 301 window
    "filter1_bilateral": ("two_chroms", 50000,
                          {"filter_mode": 1, "filter_param2": 2.0}),
    "filter2_gaussian": ("two_chroms", 50000, {"filter_mode": 2}),
    "resolution_10kb": ("res10k", 10000, {}),
    # the port's chromosomes in a spawn pool of 2 workers
    "spawn_pool": ("two_chroms", 50000, {"n_workers": 2}),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches_jax(datasets, case):
    """The port's `load_dataset` against the JAX package's on the same
    files: every region's ``img``, ``mask``, ``dmaps``, ``flat_rows``,
    ``flat_cols`` and ``len_vec`` row, and ``x_max``; bitwise. The cases:
    two chromosomes, two synteny blocks a chromosome, a centromere split
    (an off-diagonal region), the observed-support mask, filter modes 0,
    1 and 2, 10 kb bins, and the port's chromosomes loaded in a spawn
    pool."""
    name, res, kw = LOADER_CASES[case]
    data = datasets[name]
    kw = dict(kw)
    n_workers = kw.pop("n_workers", 0)
    ja, jx = _load("jax", data, resolution=res, **kw)
    ta, tx = _load("torch", data, resolution=res, n_workers=n_workers, **kw)
    assert tx == jx
    _assert_regions_equal(ta, ja)
    if name == "blocks2":
        assert len(ta) == 4 if "centromere_splits" in kw else len(ta) == 2
        assert any(not r.is_diag for r in ta) == ("centromere_splits" in kw)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cache_read_across_packages(tmp_path, datasets, direction):
    """A preprocessing cache written by one package (the reference's file
    names, observed-support masks included) is read by the other into
    bitwise the regions it was written from."""
    from phylo_hmrf_tpu.config import PhyloHMRFConfig as JCfg
    from phylo_hmrf_tpu.data import pipeline as jp
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig as TCfg
    from phylo_hmrf_tpu_torch.data import pipeline as tp

    kw = dict(mask_mode="observed")
    src, dst = ((jp, JCfg, "jax"), (tp, TCfg, "torch"))
    if direction == "torch_to_jax":
        src, dst = dst, src
    regions, _ = _load(src[2], datasets["two_chroms"], **kw)
    out = str(tmp_path / "cache")
    src[0].save_cache(regions, out, src[1](**kw))
    got = dst[0].load_cache(out, dst[1](**kw))
    _assert_regions_equal(got, regions)
    assert tp.cache_paths(out, 50000, 0) == jp.cache_paths(out, 50000, 0)


# ---------------------------------------------------------- hole fill --

@pytest.mark.parametrize("variant", ["sym", "rect", "sym2"])
def test_hole_fill_cpp_matches_plain(variant):
    """The C++ fill (``native/gridops.cc``) against ``_hole_fill_python``,
    at tests/test_data_pipeline.py's tolerance (assert_allclose defaults),
    on a matrix whose holes chain (sequential in-place semantics)."""
    from phylo_hmrf_tpu.config import THRESH1 as JT
    from phylo_hmrf_tpu_torch.config import THRESH1
    from phylo_hmrf_tpu_torch.data.filters import (_hole_fill_python,
                                                   hole_fill)

    assert THRESH1 == JT
    rng = np.random.default_rng(11)
    m = rng.random((14, 14) if variant != "rect" else (12, 9))
    m[m < 0.35] = 0.0
    if variant != "rect":
        m = np.triu(m) + np.triu(m, 1).T
    sym = variant != "rect"
    calls = hole_fill.calls
    out_c = hole_fill(m.copy(), symmetric=sym,
                      include_center=variant == "sym2")
    assert hole_fill.calls == calls + 1
    out_py = _hole_fill_python(m.copy(), sym, THRESH1,
                               include_center=variant == "sym2")
    np.testing.assert_allclose(out_c, out_py)
    assert (out_c != m).any()


def test_hole_fill_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: when the C++ library does not build, the hole
    fill raises `NativeBuildError` (the JAX package falls back to numpy)."""
    from phylo_hmrf_tpu_torch.data.filters import hole_fill

    bad = tmp_path / "gridops.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", [native.SOURCE, str(bad)])
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        hole_fill(np.zeros((6, 6)), symmetric=True)


# ------------------------------------------------------- command line --

def _run_cli(main, workdir, args):
    cwd = os.getcwd()
    os.chdir(workdir)   # chrom_quantile_test.txt lands here
    try:
        main(args)
    finally:
        os.chdir(cwd)


def test_cli_matches_jax_cli(tmp_path, datasets):
    """The port's command line (``--device cpu``) and the JAX one on the
    same input and flags (the default pipeline of
    tests/test_io_cli.py::test_cli_default_pipeline_polish_on): the
    ``.mat`` files have the same keys and shapes and the same
    ``len_vec``; the run artifacts the same top-level keys."""
    from phylo_hmrf_tpu.cli import main as jax_main
    from phylo_hmrf_tpu_torch.cli import main as torch_main

    data = datasets["two_chroms"]
    mats, docs = {}, {}
    for name, main, extra in (("jax", jax_main, ["--n_devices", "1"]),
                              ("torch", torch_main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        _run_cli(main, work, [
            "-n", "4", "-p", data, "--chromvec", "21,22", "-g", "3",
            "--miter", "2", "--output", "out", "--seed", "3",
            "--run_json", "run.json", *extra])
        mats[name] = scipy.io.loadmat(str(work / "out" /
                                          "estimate_ou_0_1.00_4.mat"))
        with open(work / "run.json") as f:
            docs[name] = json.load(f)
        assert (work / "chrom_quantile_test.txt").exists()
        assert (work / "out" / "data.50Kb.observed.0.npy").exists()
    j, t = mats["jax"], mats["torch"]
    keys = {k for k in j if not k.startswith("__")}
    assert keys == {k for k in t if not k.startswith("__")} == {
        "state_vec", "len_vec", "params_vec1", "params_vec2", "iter_id1",
        "iter_id2", "cost_vec"}
    for k in keys:
        assert j[k].shape == t[k].shape, k
    np.testing.assert_array_equal(t["len_vec"], j["len_vec"])
    assert np.isfinite(t["cost_vec"]).all()
    dj, dt = docs["jax"], docs["torch"]
    assert set(dt) == set(dj)
    assert dt["schema"] == "phylo_hmrf_tpu.run/1"
    assert set(dt["config"]) == set(dj["config"])
    assert dt["environment"] == {"backend": "cpu", "device_kind": "cpu",
                                 "n_devices": 1}
    assert dt["hbm_peak_bytes"] is None
    assert dt["x_max"] == dj["x_max"] and dt["n_samples"] == dj["n_samples"]
    assert any("polish" in k for k in dt["phase_timings"])


def test_torch_trace_writes_chrome_trace(tmp_path):
    """``--profile_dir``'s scope: a Chrome trace of the work inside it,
    with the spans of a fit traced inside it as ranges; nothing when the
    directory is empty."""
    from phylo_hmrf_tpu_torch import PhyloHMRF
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig as TorchConfig
    from phylo_hmrf_tpu_torch.synth import chr21_problem
    from phylo_hmrf_tpu_torch.utils.profiling import torch_trace

    with torch_trace(""):
        torch.ones(4).sum()
    tree, region, *_ = chr21_problem(0, h0=16, K=2)
    model = PhyloHMRF(tree, [region], TorchConfig(
        n_states=2, max_iter=2, seed=0, mstep_iters=4), device="cpu")
    out = tmp_path / "trace"
    with torch_trace(str(out)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
        model.fit(verbose=False, trace=True)
    (path,) = list(out.iterdir())
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events
    names = {e.get("name") for e in events}
    assert {s.name for s in model.timer.spans} <= names
    assert {"fit", "em_iter", "estep", "mstep_dispatch", "wait",
            "polish"} <= names


def test_cli_device_cuda_without_cuda_raises(tmp_path):
    """``--device cuda`` (the default) raises where CUDA is absent; it
    does not carry on on the CPU."""
    from phylo_hmrf_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-p", str(tmp_path), "--output", str(tmp_path)])


# ---------------------------------------------------- the whole slice --

def test_loaded_regions_fit_in_lockstep(datasets):
    """Each package's loader reads the same files; the port's fit of its
    regions, from the JAX model's ``initialize()`` state, follows the JAX
    fit of the JAX regions for 3 iterations with the final expansion
    polish: identical labels at every iteration and after the polish,
    costs within tests/test_torch_fit.py's rtol 1e-5."""
    from phylo_hmrf_tpu.config import PhyloHMRFConfig
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF
    from phylo_hmrf_tpu_torch import PhyloHMRF
    from phylo_hmrf_tpu_torch.convert import export_state, import_state

    cfg = PhyloHMRFConfig(max_iter=3, **FIT_KW)
    jr, _ = _load("jax", datasets["two_chroms"], pad_h=8, pad_w=8)
    tr, _ = _load("torch", datasets["two_chroms"], pad_h=8, pad_w=8)
    jm = JaxPhyloHMRF(TREE, jr, cfg)
    jm.initialize()
    tm = PhyloHMRF(TREE, tr, cfg, device="cpu")
    import_state(tm, export_state(jm))
    out = {}
    for name, m in (("jax", jm), ("torch", tm)):
        labels = []

        def cb(model, it, row, grids, labels=labels):
            labels.append(np.concatenate([
                r.labels_to_flat(np.asarray(g.cpu() if torch.is_tensor(g)
                                            else g))
                for r, g in zip(model.regions, grids)]))
        out[name] = (m.fit(verbose=False, callback=cb), labels)
    (rj, lj), (rt, lt) = out["jax"], out["torch"]
    assert rt.cost_vec.shape == rj.cost_vec.shape == (3, 4)
    np.testing.assert_allclose(rt.cost_vec, rj.cost_vec, rtol=1e-5)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    np.testing.assert_array_equal(tm.len_vec, jm.len_vec)


# ---------------------------------------------------------- checkpoint --

def _port_model(regions, **kw):
    from phylo_hmrf_tpu_torch import PhyloHMRF, PhyloHMRFConfig

    return PhyloHMRF(TREE, regions, PhyloHMRFConfig(**{**FIT_KW, **kw}),
                     device="cpu")


@pytest.fixture(scope="module")
def small_regions(datasets):
    return _load("torch", datasets["small"], pad_h=8, pad_w=8)[0]


@pytest.mark.parametrize("garbage", [False, True])
def test_resume_matches_uninterrupted(tmp_path, small_regions, garbage):
    """A fit checkpointed after iterations 0 and 1 and resumed to 4
    iterations (with the final polish) equals the uninterrupted fit bit
    for bit: ``cost_vec``, labels, ``params_vec1``, ``params_list``. With
    garbage appended to the ``.hist`` sidecar, the resumed run's first
    save cuts it at the offset the npz recorded."""
    from phylo_hmrf_tpu_torch.utils import checkpoint as ckpt

    full = _port_model(small_regions, max_iter=4).fit(verbose=False)
    ck = str(tmp_path / "ck.npz")
    _port_model(small_regions, max_iter=2).fit(
        verbose=False, checkpoint_path=ck, checkpoint_every=1)
    size = os.path.getsize(ck + ".hist")
    if garbage:
        with open(ck + ".hist", "ab") as f:
            f.write(b"partial write from a crashed save")
    res = _port_model(small_regions, max_iter=4).fit(
        verbose=False, checkpoint_path=ck, resume=True, checkpoint_every=1)
    np.testing.assert_array_equal(res.cost_vec, full.cost_vec)
    np.testing.assert_array_equal(res.labels, full.labels)
    np.testing.assert_array_equal(res.params_vec1, full.params_vec1)
    np.testing.assert_array_equal(res.params_list, full.params_list)
    _, meta = ckpt.load_checkpoint(ck)
    book = meta["bookkeeping"]
    assert book["iter"] == 3 and book["hist_count"] == 4
    assert os.path.getsize(ck + ".hist") == book["hist_offset"] > size
    rows = ckpt.read_history(ck, 4, 1)
    np.testing.assert_array_equal(np.stack([r[0] for r in rows]),
                                  full.params_list)


def test_checkpoint_pad_mismatch_regrids(tmp_path, small_regions):
    """Resuming under other padding re-grids the saved labels through the
    padding-invariant flat samples (the JAX package's
    tests/test_io_cli.py::test_checkpoint_pad_mismatch_regrids), and the
    resumed fit, with its polish, runs on."""
    from phylo_hmrf_tpu_torch.data.regions import region_from_samples
    from phylo_hmrf_tpu_torch.utils import checkpoint as ckpt

    ck = str(tmp_path / "ck.npz")
    m1 = _port_model(small_regions, max_iter=2)
    m1.fit(verbose=False, checkpoint_path=ck, checkpoint_every=1)
    saved = [r.labels_to_flat(g.cpu().numpy() if torch.is_tensor(g) else g)
             for r, g in zip(m1.regions, m1.labels_local)]
    regions2 = [region_from_samples(
        r.flat_values(), r.H0, r.W0, r.is_diag, pad_h=24, pad_w=24)
        for r in small_regions]
    m2 = _port_model(regions2, max_iter=2, pad_h=24, pad_w=24)
    arrays, meta = ckpt.load_checkpoint(ck)
    ckpt.restore_model(m2, arrays, meta)
    for r, g, flat in zip(m2.regions, m2.labels_local, saved):
        assert g.shape == r.shape != small_regions[0].shape
        np.testing.assert_array_equal(r.labels_to_flat(g), flat)
    m3 = _port_model(regions2, max_iter=3, pad_h=24, pad_w=24)
    r3 = m3.fit(verbose=False, checkpoint_path=ck, resume=True)
    assert r3.n_iters == 3 and np.isfinite(r3.cost_vec).all()
    assert r3.labels.shape == (m3.n_samples,)


def test_jax_checkpoint_resumes_in_port(tmp_path, datasets):
    """A checkpoint the JAX fit wrote after iteration 1 resumes in the
    port, which then follows the JAX package's uninterrupted 3-iteration
    fit: its saved rows exactly, the resumed iteration's costs within
    tests/test_torch_fit.py's rtol 1e-5, the same labels after the
    polish."""
    from phylo_hmrf_tpu.config import PhyloHMRFConfig
    from phylo_hmrf_tpu.models.hmrf import PhyloHMRF as JaxPhyloHMRF

    jr, _ = _load("jax", datasets["small"], pad_h=8, pad_w=8)
    full = JaxPhyloHMRF(TREE, jr, PhyloHMRFConfig(max_iter=3, **FIT_KW)).fit(
        verbose=False)
    ck = str(tmp_path / "ck.npz")
    JaxPhyloHMRF(TREE, jr, PhyloHMRFConfig(max_iter=2, **FIT_KW)).fit(
        verbose=False, checkpoint_path=ck, checkpoint_every=2)
    tm = _port_model(_load("torch", datasets["small"], pad_h=8,
                           pad_w=8)[0], max_iter=3)
    res = tm.fit(verbose=False, checkpoint_path=ck, resume=True)
    assert res.n_iters == 3
    np.testing.assert_array_equal(res.cost_vec[:2], full.cost_vec[:2])
    np.testing.assert_allclose(res.cost_vec, full.cost_vec, rtol=1e-5)
    np.testing.assert_array_equal(res.labels, full.labels)
    assert (res.iter_id1, res.iter_id2) == (full.iter_id1, full.iter_id2)

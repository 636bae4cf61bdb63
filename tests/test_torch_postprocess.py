"""The port's post-processing, metrics, comparison, simulation, BED I/O,
reconstruction and debug-dump modules against the JAX package's, on CPU:
the same seeded inputs through both, compared exactly (arrays equal,
files byte for byte) unless a test says otherwise. None of the port's
modules needs pandas, scikit-learn or matplotlib
(tests/test_torch_kernels.py::test_port_imports_no_jax refuses them).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from phylo_hmrf_tpu.data import pipeline as j_pipe
from phylo_hmrf_tpu.data import regions as j_reg
from phylo_hmrf_tpu.postprocess import smooth as j_sm
from phylo_hmrf_tpu.utils import bedio as j_bed
from phylo_hmrf_tpu.utils import metrics as j_met
from phylo_hmrf_tpu.utils import simulate as j_sim
from phylo_hmrf_tpu_torch.data import pipeline as t_pipe
from phylo_hmrf_tpu_torch.data import regions as t_reg
from phylo_hmrf_tpu_torch.postprocess import smooth as t_sm
from phylo_hmrf_tpu_torch.utils import bedio as t_bed
from phylo_hmrf_tpu_torch.utils import metrics as t_met
from phylo_hmrf_tpu_torch.utils import simulate as t_sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _states(rng, n_regions=3, K=4):
    """A flat state vector and its len_vec over a diagonal and two
    off-diagonal regions of chromosome 21, blocky with noise."""
    rows, start, flat = [], 0, []
    for rid, (h0, w0, diag) in enumerate(((30, 30, True), (12, 20, False),
                                          (25, 25, True))[:n_regions]):
        ii, jj = np.indices((h0, w0))
        g = (ii // 7 + jj // 9) % K
        g = np.where(rng.random(g.shape) < 0.08, rng.integers(0, K, g.shape),
                     g)
        s = j_sm.grid_to_states(np.triu(g) + np.triu(g, 1).T if diag else g,
                                diag)
        flat.append(s)
        rows.append([s.size, start, start + s.size, h0, w0, 5 * rid,
                     7 * rid, rid, int(diag), 21])
        start += s.size
    return np.concatenate(flat), np.asarray(rows, np.int64)


# ---------------------------------------------------------- smoothing --

@pytest.mark.parametrize("diag", [True, False])
def test_grid_states_roundtrip_equal(diag):
    rng = np.random.default_rng(0)
    n = 15 * 16 // 2 if diag else 15 * 16
    flat = rng.integers(0, 5, n)
    W0 = 15 if diag else 16
    a = t_sm.states_to_grid(flat, 15, W0, diag)
    np.testing.assert_array_equal(a, j_sm.states_to_grid(flat, 15, W0, diag))
    np.testing.assert_array_equal(t_sm.grid_to_states(a, diag),
                                  j_sm.grid_to_states(a, diag))


@pytest.mark.parametrize("kw", [{}, dict(threshold=6, n_iter=2),
                                dict(window=3, ratio_threshold=0.3)])
def test_smoothing_equal(kw):
    rng = np.random.default_rng(1)
    sv, lv = _states(rng)
    np.testing.assert_array_equal(t_sm.smooth_state_vec(sv, lv, 4, **kw),
                                  j_sm.smooth_state_vec(sv, lv, 4, **kw))
    g = j_sm.states_to_grid(sv[:lv[0, 2]], 30, 30, True)
    np.testing.assert_array_equal(t_sm.smooth_states(g, 4, **kw),
                                  j_sm.smooth_states(g, 4, **kw))


def test_symmetric_helpers_equal():
    rng = np.random.default_rng(2)
    for d1, d2 in ((6, 6), (5, 8)):
        np.testing.assert_array_equal(t_sm.symmetric_idx(d1, d2),
                                      j_sm.symmetric_idx(d1, d2))
        for a, b in zip(t_sm.symmetric_idx1(d1, d2),
                        j_sm.symmetric_idx1(d1, d2)):
            np.testing.assert_array_equal(a, b)
    st = rng.integers(0, 4, (7, 7))
    np.testing.assert_array_equal(t_sm.symmetric_state(st.copy()),
                                  j_sm.symmetric_state(st.copy()))
    flat = rng.integers(0, 4, 21)
    np.testing.assert_array_equal(t_sm.symmetric_state1(flat, 6),
                                  j_sm.symmetric_state1(flat, 6))
    lv = np.array([[21, 0, 21, 6], [10, 21, 31, 4]])
    vecs = [flat, rng.integers(0, 4, 10)]
    got = t_sm.symmetric_state1_vec(vecs, lv)
    want = j_sm.symmetric_state1_vec(vecs, lv)
    assert len(got) == len(want) == 6 + 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_write_state_files_byte_identical(tmp_path):
    sv, lv = _states(np.random.default_rng(3))
    for ann in ("ori", "smooth"):
        a = t_sm.write_state_files(sv, lv, 21, 50000, str(tmp_path / "t"),
                                   ann)
        b = j_sm.write_state_files(sv, lv, 21, 50000, str(tmp_path / "j"),
                                   ann)
        _same_files(a, b)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 8
    for n in names:
        _same_files(tmp_path / "t" / n, tmp_path / "j" / n)


def test_rgb_and_png_equal(tmp_path):
    """`states_to_rgb` equals the JAX package's; the PNG the port writes
    decodes (zlib) to exactly that array, with the title kept."""
    rng = np.random.default_rng(4)
    g = rng.integers(0, 6, (23, 31))
    for pal in (None, j_sm.default_palette(9)):
        np.testing.assert_array_equal(t_sm.states_to_rgb(g, pal),
                                      j_sm.states_to_rgb(g, pal))
    np.testing.assert_array_equal(t_sm.default_palette(7),
                                  j_sm.default_palette(7))
    path = str(tmp_path / "map.png")
    t_sm.save_state_image(g, path, n_components=6, title="chr21 states")
    rgb, title = t_sm.read_state_image(path)
    np.testing.assert_array_equal(rgb, j_sm.states_to_rgb(g,
                                                          n_components=6))
    assert title == "chr21 states"
    t_sm.save_state_image(g, path)
    rgb, title = t_sm.read_state_image(path)
    np.testing.assert_array_equal(rgb, j_sm.states_to_rgb(g))
    assert title is None
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


# ------------------------------------------------------------ metrics --

def _labelings():
    rng = np.random.default_rng(5)
    out = [(rng.integers(0, k1, n), rng.integers(0, k2, n))
           for n, k1, k2 in ((60, 3, 3), (300, 5, 2), (2000, 10, 10),
                             (40, 2, 7))]
    a = rng.integers(0, 5, 120)
    out += [
        (a, a),                                  # identical
        (a, (a + 2) % 5),                        # a relabeling
        (np.zeros(30, int), rng.integers(0, 4, 30)),   # one cluster
        (rng.integers(0, 4, 30), np.zeros(30, int)),
        (np.zeros(25, int), np.zeros(25, int)),  # one cluster both
        (np.arange(25), np.arange(25)),          # every point its own
        (np.arange(25), rng.integers(0, 3, 25)),
    ]
    return out


@pytest.mark.parametrize("case", range(11))
def test_compare_labeling_matches_sklearn(case):
    """NMI, AMI, ARI (scikit-learn's formulas, written out) and RI,
    precision, recall, F1 against the JAX package's, which calls
    scikit-learn: to 1e-12, random labelings and the degenerate cases."""
    x, y = _labelings()[case]
    np.testing.assert_allclose(np.array(t_met.compare_labeling(x, y)),
                               np.array(j_met.compare_labeling(x, y)),
                               rtol=1e-12, atol=1e-12)


def test_count_and_percentile_helpers_equal():
    rng = np.random.default_rng(6)
    state = rng.integers(0, 5, 400)
    x = rng.random((400, 4))
    for a, b in zip(t_met.cnt_estimate(state, 6),
                    j_met.cnt_estimate(state, 6)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_met.meanvalue_state(x, state),
                    j_met.meanvalue_state(x, state)):
        np.testing.assert_array_equal(a, b)
    assert (t_met.best_match_accuracy(state, (state + 1) % 5)
            == j_met.best_match_accuracy(state, (state + 1) % 5) == 1.0)


def _mats(tmp_path):
    """Two estimate files written by the port's writer."""
    import types

    from phylo_hmrf_tpu_torch.utils.io import save_estimate
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 4, 300)
    other = np.where(rng.random(300) < 0.85, labels, rng.integers(0, 4, 300))
    paths = []
    for i, lab in enumerate((labels, other)):
        res = types.SimpleNamespace(
            labels=lab, params_vec=rng.random((4, 16)),
            params_vec1=rng.random((4, 16)), iter_id1=2, iter_id2=3,
            cost_vec=rng.random((5, 4)), means=rng.random((4, 4)),
            covars=rng.random((4, 4, 4)), params_list=rng.random((5, 4, 16)))
        paths.append(save_estimate(res, np.array([[300, 0, 300] + [0] * 7]),
                                   str(tmp_path / f"run{i}"), 0, 1.0, 4))
    return paths


def test_compare_results_equal(tmp_path):
    """``compare_results`` on two ``.mat`` files equals the JAX tool's
    dict; against itself NMI, ARI and the matched accuracy are 1.0; the
    command line prints the same JSON."""
    from phylo_hmrf_tpu.compare import compare_results as j_cmp
    from phylo_hmrf_tpu_torch.compare import compare_results as t_cmp
    a, b = _mats(tmp_path)
    got, want = t_cmp(a, b), j_cmp(a, b)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)
    same = t_cmp(a, a)
    assert same["nmi"] == same["ari"] == same["agreement_best_match"] == 1.0
    out = subprocess.run([sys.executable, "-m", "phylo_hmrf_tpu_torch.compare",
                          a, b], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    import json
    printed = json.loads(out.stdout)
    for k in want:
        np.testing.assert_allclose(printed[k], want[k], rtol=1e-12,
                                   atol=1e-12)


# --------------------------------------------------------- simulation --

@pytest.mark.parametrize("mode,diag", [("potts", True), ("blocks", False)])
def test_simulation_equal(mode, diag):
    """``simulate_region`` (Potts Gibbs or blocky labels, OU emissions)
    and ``generate_sample_from_state`` give the same arrays from the same
    ``np.random.Generator``."""
    from phylo_hmrf_tpu import tree as jt
    from phylo_hmrf_tpu_torch import tree as tt
    edges = [(0, 1), (1, 2), (1, 3), (3, 4), (4, 5), (4, 6), (3, 7)]
    jtree, ttree = jt.build_tree(edges), tt.build_tree(edges)
    params = np.random.default_rng(8).random((3, ttree.n_params)) * 0.5 + 0.2
    out = []
    for sim, tree in ((t_sim, ttree), (j_sim, jtree)):
        rng = np.random.default_rng(9)
        region, labels = sim.simulate_region(rng, tree, params, 14, 14, diag,
                                             label_mode=mode, pad_w=16)
        x = sim.generate_sample_from_state(rng, tree, params[1], 50)
        out.append((region, labels, x, sim.ou_moments_np(params[2], tree)))
    (ra, la, xa, ma), (rb, lb, xb, mb) = out
    for f in ("img", "mask", "dmaps", "flat_rows", "flat_cols"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(xa, xb)
    for a, b in zip(ma, mb):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------- pipeline, regions, tree --

def test_matrix_image_mask_and_positions_equal():
    """``write_matrix_image_v1_mask`` and ``load_region_with_positions``:
    equal arrays (and the same source lines as the JAX package's)."""
    from phylo_hmrf_tpu.config import PhyloHMRFConfig as JCfg
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig as TCfg
    rng = np.random.default_rng(10)
    ii, jj = np.triu_indices(30)
    keep = rng.random(ii.size) < 0.8
    pos = np.stack([ii[keep] + 40, jj[keep] + 40], axis=1)
    value = rng.random((pos.shape[0], 4)) * (rng.random((pos.shape[0], 4))
                                             > 0.1)
    for a, b in zip(t_pipe.write_matrix_image_v1_mask(value, pos),
                    j_pipe.write_matrix_image_v1_mask(value, pos)):
        np.testing.assert_array_equal(a, b)
    res = 50000
    position = pos.copy()           # bins
    x = np.log1p(value * 100).astype(np.float32)
    pair = [40 * res, 70 * res, 40 * res, 70 * res, 0, 0, 0, 3]
    kw = dict(pad_h=8, pad_w=16)
    ra, pa = t_pipe.load_region_with_positions(x, position, pair,
                                               TCfg(**kw), 21)
    rb, pb = j_pipe.load_region_with_positions(x, position, pair,
                                               JCfg(**kw), 21)
    np.testing.assert_array_equal(pa, pb)
    for f in ("img", "mask", "dmaps", "flat_rows", "flat_cols"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    assert ra.len_vec_row(0, 1) == rb.len_vec_row(0, 1)


def _regions(rng):
    out = []
    for h0, w0, diag in ((12, 12, True), (10, 17, False), (12, 12, True)):
        rows, _ = t_reg.flat_index_order(h0, w0, diag)
        vals = (rng.random((rows.shape[0], 3)) + 0.1).astype(np.float32)
        out.append(t_reg.region_from_samples(vals, h0, w0, diag, pad_h=8,
                                             pad_w=16))
    return out


def test_pack_regions_and_edge_dump_equal(tmp_path):
    """``pack_regions``: equal buckets; ``save_edge_dump`` (raw distances
    and weights): byte-identical files."""
    regions = _regions(np.random.default_rng(11))
    a, b = t_reg.pack_regions(regions), j_reg.pack_regions(regions)
    assert list(a) == list(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
    for beta1 in (None, 0.7):
        for i, r in enumerate(regions[:2]):
            pa, pb = tmp_path / f"t{i}{beta1}", tmp_path / f"j{i}{beta1}"
            t_reg.save_edge_dump(r, str(pa), beta1)
            j_reg.save_edge_dump(r, str(pb), beta1)
            _same_files(pa, pb)


def test_tree_debug_dumps_byte_identical(tmp_path):
    """``save_debug_dumps`` (ou_A1, ou_A2, base_mtx_*): byte-identical
    files; ``base_matrices`` equal."""
    from phylo_hmrf_tpu import tree as jt
    from phylo_hmrf_tpu_torch import tree as tt
    edges = [(0, 1), (1, 2), (1, 3), (3, 4), (4, 5), (4, 6), (3, 7)]
    for a, b in zip(tt.base_matrices(tt.build_tree(edges)),
                    jt.base_matrices(jt.build_tree(edges))):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tt.save_debug_dumps(tt.build_tree(edges), str(tmp_path / "t"))
    jt.save_debug_dumps(jt.build_tree(edges), str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 10
    for n in names:
        _same_files(tmp_path / "t" / n, tmp_path / "j" / n)


# ------------------------------------------------------------ BED I/O --

def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _contact_dir(tmp_path, rng, chroms=(21, 22)):
    d = tmp_path / "contacts"
    d.mkdir()
    for c in chroms:
        n = 30
        p1 = rng.integers(0, 50, n) * 50000
        p2 = p1 + rng.integers(0, 10, n) * 50000
        v = [f"{x:.4f}" if i % 7 else "nan" for i, x in
             enumerate(rng.random(n) * 40)]
        _write(d / f"chr{c}.50K.txt", "".join(
            f"{a}\t{b}\t{x}\n" for a, b, x in zip(p1, p2, v)))
    return str(d)


def test_bed_writers_byte_identical(tmp_path):
    """``write_tobed``, ``merge_contact_file``, ``merge_estimate_file``
    and ``chrom_contactMtx`` write the bytes the JAX package's pandas
    writers write, on int, ``%.4f``, mixed and missing values."""
    rng = np.random.default_rng(12)
    iv = _write(tmp_path / "iv.txt", "".join(
        f"chr{c}\t{s}\t{s + 500}\n" for c, s in
        zip(rng.integers(1, 3, 20), rng.integers(0, 10 ** 6, 20))))
    t_bed.write_tobed(iv, str(tmp_path / "t.bed"))
    j_bed.write_tobed(iv, str(tmp_path / "j.bed"))
    _same_files(tmp_path / "t.bed", tmp_path / "j.bed")

    cdir = _contact_dir(tmp_path, rng)
    t_bed.merge_contact_file(cdir, str(tmp_path / "tm.txt"), [21, 22])
    j_bed.merge_contact_file(cdir, str(tmp_path / "jm.txt"), [21, 22])
    _same_files(tmp_path / "tm.txt", tmp_path / "jm.txt")

    edir = tmp_path / "est"
    edir.mkdir()
    for c in (21, 22):
        rows = []
        for i in range(15):
            s1, s2 = rng.integers(0, 100, 2)
            feats = [f"{x:.6f}" for x in rng.random(4)]
            if c == 22 and i == 3:
                feats[1] = "7"           # an int among floats
            rows.append([s1 * 50000, s1, s1 * 50000 + 50000, s2 * 50000, s2,
                         s2 * 50000 + 50000, rng.integers(0, 5), *feats])
        _write(edir / f"test{c}.txt", "".join(
            "\t".join(str(v) for v in r) + "\n" for r in rows))
    sp = ["a", "b", "c", "d"]
    for mod, tag in ((t_bed, "t"), (j_bed, "j")):
        (tmp_path / tag).mkdir()
        mod.merge_estimate_file(str(edir), sp, str(tmp_path / tag / "m.txt"),
                                [21, 22], str(tmp_path / tag))
    for n in ["m.txt"] + [f"estimate_{s}.txt" for s in sp]:
        _same_files(tmp_path / "t" / n, tmp_path / "j" / n)

    raw = _write(tmp_path / "x.50Kb.chr21.txt", "".join(
        f"{a * 50000}\t{b * 50000}\t{v}\n" for a, b, v in
        zip(rng.integers(0, 99, 25), rng.integers(0, 99, 25),
            ["NaN" if i % 5 == 0 else f"{x:.3f}"
             for i, x in enumerate(rng.random(25))])))
    out_t = t_bed.chrom_contactMtx(raw, 21)
    with open(out_t, "rb") as f:
        got = f.read()
    out_j = j_bed.chrom_contactMtx(raw, 21)
    assert out_t == out_j
    with open(out_j, "rb") as f:
        assert got == f.read()


def test_bed_readers_equal(tmp_path):
    """``intersect_region``, ``state_enrichment``,
    ``parse_alignment_blocks`` and ``overlap_openChromatin``: the JAX
    package's results."""
    rng = np.random.default_rng(13)
    s1 = rng.integers(0, 10 ** 5, 30)
    f1 = _write(tmp_path / "a.txt", "".join(
        f"chr{1 + i % 2}\t{s}\t{s + 1000}\n" for i, s in enumerate(s1)))
    f2 = _write(tmp_path / "b.txt", "".join(
        f"chr{1 + (i * 3) % 2}\t{s + rng.integers(-1500, 1500)}\t"
        f"{s + 2000}\t{i}\n" for i, s in enumerate(s1)))
    for a, b in zip(t_bed.intersect_region(f1, f2),
                    j_bed.intersect_region(f1, f2)):
        np.testing.assert_array_equal(a, b)
    chroms = rng.integers(1, 4, 200)
    states = rng.integers(0, 5, 200)
    for a, b in zip(t_bed.state_enrichment(chroms, states),
                    j_bed.state_enrichment(chroms, states)):
        np.testing.assert_array_equal(a, b)
    blocks = _write(tmp_path / "blocks.txt", "".join(
        f">{i}\n" + "".join(f"sp{k}.chr{2 if i % 3 else 5}"
                            f"{'A' if (k == 1 and i % 3) else ''}:"
                            f"{100 * i}-{100 * i + 50 + 40 * k} +\n"
                            for k in range(4)) for i in range(12)))
    assert (t_bed.parse_alignment_blocks(blocks, 60)
            == j_bed.parse_alignment_blocks(blocks, 60))
    loc1 = {"chr": np.array(["chr1", "chr2", "chr1"]),
            "start": np.array([0, 100, 500]), "stop": np.array([50, 300, 900])}
    loc2 = [np.array(["chr1", "chr2"]), np.array([40, 0]),
            np.array([600, 120])]
    assert (t_bed.overlap_openChromatin(loc1, loc2)
            == j_bed.overlap_openChromatin(loc1, loc2) == [0, 1, 2])


def test_bed_full_precision_floats_round_trip(tmp_path):
    """The one case where the bytes differ, by design: a float written
    with all 17 significant digits. pandas' parser is not correctly
    rounded, and re-writes such a value one digit apart (here
    912.7555772777217 becomes ...216); the port's reader is Python's
    ``float``, so the port writes the value it read."""
    vals = ["912.7555772777217", "175.65562060255903", "0.25"]
    src = _write(tmp_path / "iv.txt", "".join(
        f"chr1\t{i}\t{v}\n" for i, v in enumerate(vals)))
    t_bed.write_tobed(src, str(tmp_path / "t.bed"))
    j_bed.write_tobed(src, str(tmp_path / "j.bed"))
    with open(tmp_path / "t.bed") as f:
        got = [line.split("\t")[2] for line in f]
    with open(tmp_path / "j.bed") as f:
        pandas = [line.split("\t")[2] for line in f]
    assert got == vals
    assert pandas[0] == "912.7555772777216" and pandas[2] == "0.25"


# ------------------------------------------------------ reconstruction --

def _donor(tmp_path):
    """A reference-layout donor directory built from the files
    ``synth.write_example`` writes: panPan2 has both chromosomes, gorGor4
    and panTro5 chr22 only, hg38 none (the layout of the stripped
    mirror)."""
    import shutil

    from phylo_hmrf_tpu_torch.synth import SPECIES, write_example
    ex = tmp_path / "ex"
    write_example(str(ex), n_bins=40, n_states=3, chroms=(21, 22))
    ref = tmp_path / "example_input"
    ref.mkdir()
    for n in ("edge.1.txt", "branch_length.1.txt", "species_name.1.txt",
              "hg38.chrom.sizes", "chr21.synteny.txt", "chr22.synteny.txt"):
        shutil.copy(ex / n, ref / n)
    have = {"panPan2": (21, 22), "gorGor4": (22,), "panTro5": (22,)}
    for (sp, chroms), src in zip(have.items(), SPECIES):
        d = ref / "test_data" / f"hic_{sp}"
        d.mkdir(parents=True)
        for c in chroms:
            shutil.copy(ex / f"hic_{src}" / f"chr{c}.50K.txt",
                        d / f"chr{c}.50K.txt")
    return ref


def test_reconstruct_is_deterministic(tmp_path):
    """``python -m phylo_hmrf_tpu_torch.data.reconstruct`` on a synthetic
    donor directory writes the same bytes from two fresh interpreters
    with different ``PYTHONHASHSEED``s (the JAX copy seeds with the salted
    ``hash``), and each synthesized file is the JAX ``synth_from_donor``'s
    under the port's seed."""
    from phylo_hmrf_tpu.data import reconstruct as jr
    from phylo_hmrf_tpu_torch.data import reconstruct as tr
    ref = _donor(tmp_path)
    outs = []
    for seed in ("1", "2"):
        out = tmp_path / f"run{seed}" / "canonical"
        run = subprocess.run(
            [sys.executable, "-m", "phylo_hmrf_tpu_torch.data.reconstruct",
             "--reference", str(ref), "--out", str(out)], cwd=REPO,
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=seed))
        assert run.returncode == 0, run.stderr
        assert "4 synthesized contact files" in run.stdout
        outs.append(out)
    files = sorted(str(p.relative_to(outs[0])) for p in outs[0].rglob("*")
                   if p.is_file())
    assert len(files) == 7 + 8
    for f in files:
        _same_files(outs[0] / f, outs[1] / f)
    donor = str(ref / "test_data" / "hic_panPan2" / "chr21.50K.txt")
    jr.hash = lambda key: tr.synth_seed(*key)    # the module's own name
    try:
        jr.synth_from_donor(donor, "hg38", 21, str(tmp_path / "j.txt"))
    finally:
        del jr.hash
    _same_files(tmp_path / "j.txt",
                outs[0] / "test_data" / "hic_hg38" / "chr21.50K.txt")

"""The benchmark's generator: the same seed gives the same inputs, and
the configurations' sample counts are the reference's."""

import numpy as np

import synth


def test_same_seed_same_data_other_seed_other_data():
    regs = [dict(h0=30, w0=30, is_diag=True), dict(h0=20, w0=25,
                                                   is_diag=False)]
    a, ma, ca = synth.make_data(2 ** 31 + 77, regs, 5)
    b, mb, cb = synth.make_data(2 ** 31 + 77, regs, 5)
    c, _, _ = synth.make_data(2 ** 31 + 78, regs, 5)
    for x, y in zip(a, b):
        assert np.array_equal(x["x"], y["x"])
        assert np.array_equal(x["true"], y["true"])
    assert np.array_equal(ma, mb) and np.array_equal(ca, cb)
    assert not np.array_equal(a[0]["x"], c[0]["x"])
    # the states are the configuration's; the seed orders and samples them
    _, mc, cc = synth.make_data(5, regs, 5)
    assert np.array_equal(ma, mc) and np.array_equal(ca, cc)
    big = [dict(h0=130, w0=130, is_diag=True)]
    d1, _, _ = synth.make_data(1, big, 5)
    d2, _, _ = synth.make_data(2, big, 5)
    assert sorted(set(d1[0]["true"])) == list(range(5))
    assert not np.array_equal(d1[0]["true"], d2[0]["true"])
    assert a[0]["x"].shape == (465, 4) and a[1]["x"].shape == (500, 4)
    assert a[0]["x"].dtype == np.float32 and (a[0]["x"] > 0).all()


def test_sample_counts_of_the_configurations():
    rows, _ = synth.flat_order(653, 653, True)
    assert rows.shape[0] == 213531
    rows22, _ = synth.flat_order(685, 685, True)
    assert rows.shape[0] + rows22.shape[0] == 448486


def test_tree_is_the_example_tree():
    t = synth.Tree()
    assert (t.n_nodes, t.n_leaves, t.n_params) == (8, 4, 23)
    assert t.leaves == [2, 5, 6, 7]

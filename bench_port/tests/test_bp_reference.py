"""The plain reference on problems worked by hand."""

import math

import numpy as np
import pytest
import torch

import reference as ref
import synth

C = 0.5 * math.log(2 * math.pi)
W = math.exp(-1.0)      # beta1 = 2, distance (1 - 2)^2 / (1 * 2) = 0.5


@pytest.fixture
def pair():
    """Two pixels side by side (a 1 x 2 off-diagonal block), one feature,
    values 1 and 2; two states N(1, 1) and N(2, 1)."""
    region = ref.Region(dict(h0=1, w0=2, is_diag=False,
                             x=np.array([[1.0], [2.0]], np.float32)))
    un = ref.unary(region, np.array([[1.0], [2.0]]), np.ones((2, 1, 1)))
    return region, un


def test_geometry_unary_energy(pair):
    region, un = pair
    assert np.isclose(region.dist[0, 0, 0], 0.5)
    assert np.isinf(region.dist[1:]).all()
    assert torch.allclose(un[:, 0], torch.tensor(
        [[C, C + 0.5], [C + 0.5, C]], dtype=torch.float64))
    w = region.weights(2.0)
    assert float(w[0, 0, 0]) == pytest.approx(W)
    mask = region.mask
    assert ref.energy(np.array([[0, 0]]), un, w, mask, 1.0) == \
        pytest.approx(2 * C + 0.5)
    assert ref.energy(np.array([[0, 1]]), un, w, mask, 1.0) == \
        pytest.approx(2 * C + W)


def test_local_gains(pair):
    region, un = pair
    w = region.weights(2.0)
    # at [0, 0] the second pixel gains 0.5 - w by moving to state 1
    g = ref.local_gains(np.array([[0, 0]]), un, w, region.mask, 1.0)
    assert g == pytest.approx([0.0, 0.5 - W])
    g = ref.local_gains(np.array([[0, 1]]), un, w, region.mask, 1.0)
    assert g == pytest.approx([0.0, 0.0])
    lab = ref.icm(un, w, region.mask, np.array([[0, 0]]), 1.0)
    assert lab.tolist() == [[0, 1]]


def test_estep_outputs_by_hand(pair):
    region, un = pair
    post, obs, obs2, costs = ref.estep_outputs(
        region, un, np.array([[0, 1]]), region.weights(2.0, False), 1.0)
    a = 1.0 / (1.0 + math.exp(0.5))           # 0.3775
    assert post == pytest.approx([1.0, 1.0])
    assert obs[:, 0] == pytest.approx([a + 2 * (1 - a), (1 - a) + 2 * a])
    assert obs2[:, 0, 0] == pytest.approx([a + 4 * (1 - a),
                                           (1 - a) + 4 * a])
    nrm = -math.log(math.exp(-1) / (math.exp(-1) + 1))
    assert costs == pytest.approx([1.0, nrm, C, C + nrm])


def _params(s, a, lam, theta):
    t = synth.Tree()
    B = t.n_nodes - 1
    return np.concatenate([[s], [a] * B, [lam] * B, [theta] * (B + 1)])


def test_ou_moments_limits():
    tree = synth.Tree()
    # alpha -> 0: every node keeps the root's optimum and variance
    m, c = ref.ou_moments(torch.as_tensor(_params(0.7, 1e-9, 0.4, 1.5)),
                          tree)
    assert m.numpy() == pytest.approx([1.5] * 4)
    assert c.numpy() == pytest.approx(np.full((4, 4), 0.7))
    # large alpha: each leaf at its optimum, variance lambda / (2 alpha),
    # no covariance
    m, c = ref.ou_moments(torch.as_tensor(_params(0.7, 50.0, 0.4, 1.5)),
                          tree)
    assert m.numpy() == pytest.approx([1.5] * 4)
    assert c.numpy() == pytest.approx(np.eye(4) * 0.004, abs=1e-12)


def test_ou_moments_match_the_generators():
    tree = synth.Tree()
    p = np.random.default_rng(3).random((5, tree.n_params))
    m, c = ref.ou_moments(torch.as_tensor(p), tree)
    for k in range(5):
        mk, ck = synth.ou_moments(p[k], tree)
        assert np.allclose(m[k].numpy(), mk) and np.allclose(c[k].numpy(),
                                                             ck)


def test_refine_finds_the_boxed_minimum():
    def fun(p, c):
        return torch.sum((p - c) ** 2)

    p0 = np.array([[0.5, 0.5, 0.5], [2.0, 0.1, 0.3]])
    c = np.array([[0.2, 1.5, -1.0], [0.9, 0.4, 0.6]])
    f0, f, p = ref.refine(fun, p0, (c,), 0.0, 1.0)
    assert p == pytest.approx(np.clip(c, 0.0, 1.0))
    assert f == pytest.approx([0.25 + 1.0, 0.0])
    assert f0 == pytest.approx(((np.clip(p0, 0, 1) - c) ** 2).sum(1))

"""The init's k-means: the plain version's draws and picks on the CPU, and
KM1-KM3 (``csrc/kmeans.cu``) against it on the card.

The CPU cases hold the plain version (``ops/kmeans.py::kmeans_plain``):
k-means++'s inverse-CDF pick, the order of the generator's draws, the
route choice and determinism. The kernel cases are marked ``cuda`` and
skip without a card. On a GPU machine: ``python -m pytest
tests/test_torch_kmeans_kernel.py -q --noconftest``. Their samples: the
chr21 cell's (653 x 653 bins, 213,531 samples, F=4, K=10), the canonical
run's (chr21 and chr22, 448,486 samples, K=20), both from
``phylo_hmrf_tpu_torch.synth``, and 213,531 samples of 30 blobs in 8
features (K=30, F=8). The kernel route and the plain version run from the
same draws of a CUDA generator seeded alike.
"""

import functools

import numpy as np
import pytest
import torch

from phylo_hmrf_tpu_torch.ops import kmeans as km
from phylo_hmrf_tpu_torch.synth import synteny_problem
from phylo_hmrf_tpu_torch.utils.profiling import Trace, active


# ------------------------------------------------------------ on the CPU --

def test_pick_is_the_inverse_cdf_of_the_weights():
    """The pick is the first index whose prefix sum of max(d2, 0) + 1e-12
    exceeds u times the total: a zero (or rounded-negative) distance
    weighs 1e-12 and is picked only where the target falls in its sliver;
    a target at the total picks the last index."""
    d2 = torch.tensor([0.0, 1.0, -1e-7, 2.0], dtype=torch.float32)
    w = np.array([0.0, 1.0, 0.0, 2.0]) + 1e-12
    cum = np.cumsum(w)
    total = cum[-1]
    cases = [(0.0, 0), (0.2, 1), (0.5, 3), (0.999, 3),
             # inside the zero-distance points' slivers
             (0.5e-12 / total, 0), ((cum[1] + 0.5e-12) / total, 2),
             (1.0, 3)]
    for u, want in cases:
        got = km._pick(d2, torch.tensor(u, dtype=torch.float64))
        assert got.tolist() == [want], (u, got)


@pytest.mark.parametrize("n, m", [(50, 20), (20, 20)])
def test_draws_follow_the_trials_in_order(n, m):
    """Each trial draws its subsample permutation (only when m < n), then
    its first pick, then K - 1 float64 uniforms, trial after trial, from
    the one generator."""
    k, n_init = 4, 3
    perm, first, u = km._draws(torch.Generator().manual_seed(7), n, m, k,
                               n_init, "cpu")
    g = torch.Generator().manual_seed(7)
    for t in range(n_init):
        if m < n:
            assert torch.equal(perm[t], torch.randperm(n, generator=g)[:m])
        assert first[t] == torch.randint(0, m, (1,), generator=g)[0]
        assert torch.equal(u[t], torch.rand(k - 1, generator=g,
                                            dtype=torch.float64))
    assert (perm is None) == (m == n)
    assert first.dtype == torch.int64 and u.shape == (n_init, k - 1)


def test_seeds_are_picks_of_the_subsample():
    """The plain seeding's first center is the draw's first point and
    every center a point of the trial's subsample, no point taken twice
    on distinct blobs."""
    X = _blobs(2000, 6, 3, seed=1, cpu=True)
    perm, first, u = km._draws(torch.Generator().manual_seed(3), 2000, 500,
                               6, 1, "cpu")
    sub = X[perm[0]]
    c = km._seed_plain(X, perm[0], first[0], u[0], 6)
    assert torch.equal(c[0], sub[first[0]])
    hits = [(sub == c[i]).all(1).nonzero().flatten() for i in range(6)]
    assert all(len(h) >= 1 for h in hits)
    assert len({int(h[0]) for h in hits}) == 6


def test_plain_kmeans_is_deterministic():
    """The same seed gives bitwise the same centers, labels and inertia;
    `kmeans` on the CPU is the plain version, every label the nearest
    center."""
    X = _blobs(3000, 5, 4, seed=2, cpu=True)

    def run(fn):
        return fn(torch.Generator().manual_seed(11), X, 5, n_iters=20,
                  n_init=4, pp_subsample=1000)
    a, b, c = run(km.kmeans), run(km.kmeans), run(km.kmeans_plain)
    for x, y in ((a, b), (a, c)):
        for s, t in zip(x, y):
            assert torch.equal(s, t)
    assert _gap(X, a[0], a[1]) <= 1e-4


@pytest.mark.parametrize("device, dtype, F, k, n_init, want", [
    ("cuda", torch.float32, 4, 10, 10, "kernel"),
    ("cuda", torch.float32, 8, 32, 32, "kernel"),
    ("cuda", torch.float32, 4, 33, 10, "plain"),
    ("cuda", torch.float32, 9, 10, 10, "plain"),
    ("cuda", torch.float32, 4, 30, 40, "plain"),
    ("cuda", torch.float64, 4, 10, 10, "plain"),
    ("cpu", torch.float32, 4, 10, 10, "plain")])
def test_route(device, dtype, F, k, n_init, want):
    """The kernels take float32 CUDA samples within their caps (K <= 32,
    F <= 8, n_init <= 32, n_init K <= 1024); the plain version the rest."""
    assert km.kmeans_route(torch.device(device), dtype, F, k,
                           n_init) == want


def _blobs(n, K, F, seed, cpu=False, spread=0.3):
    rng = np.random.default_rng(seed)
    c = rng.random((K, F)) * 10
    x = (c[rng.integers(0, K, n)]
         + rng.normal(size=(n, F)) * spread).astype(np.float32)
    return torch.from_numpy(x) if cpu else x


def _gap(X, centers, labels) -> float:
    """The judge's ``kmeans_gap``: the most by which a sample's squared
    distance to its center exceeds its least one, in float64."""
    X = np.asarray(X.cpu(), np.float64)
    c = np.asarray(centers.cpu(), np.float64)
    lab = np.asarray(labels.cpu(), np.int64)
    d2 = ((X[:, None, :] - c[None]) ** 2).sum(-1)
    return float((d2[np.arange(len(lab)), lab] - d2.min(1)).max())


# ------------------------------------------------------------ on the card --

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phylo_hmrf_tpu_torch import _build
    _build.load()
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _samples(name):
    """(X on the host, K) of a case."""
    if name == "chr21":
        return synteny_problem(0, 653, 653, True, 10)[1].flat_values(), 10
    if name == "canon":
        parts = [synteny_problem(0, 653, 653, True, 20),
                 synteny_problem(1, 685, 685, True, 20)]
        return np.concatenate([p[1].flat_values() for p in parts]), 20
    return _blobs(213531, 30, 8, seed=5, spread=0.6), 30


def _case(name, device):
    X, K = _samples(name)
    return torch.as_tensor(np.ascontiguousarray(X), device=device), K


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


CASES = ["chr21", "canon", "k30f8"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_seeds_are_the_plain_picks(dev, name):
    """KM1 makes the plain seeding's k-means++ picks, bitwise, for every
    trial of the same draws."""
    X, K = _case(name, dev)
    n = X.shape[0]
    for seed in (0, 2718281911):
        perm, first, u = km._draws(_gen(seed, dev), n, min(n, 65536), K, 10,
                                   dev)
        got = km._seed_kernel(X, perm, first, u, K)
        torch.cuda.synchronize()
        for t in range(10):
            want = km._seed_plain(X, perm[t], first[t], u[t], K)
            assert torch.equal(got[t], want), (seed, t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(dev, name):
    """At one seed the kernel route ends where the plain version does:
    its centers within 4 float32 ulps of the plain ones, its labels the
    plain labels on all but 8 samples, its inertia within 1e-5 relative;
    every label is its sample's nearest center by the judge's rule (gap
    <= 1e-4), and the outputs have the plain shapes and types."""
    X, K = _case(name, dev)
    c, lab, inertia = km.kmeans(_gen(3141592751, dev), X, K)
    pc, plab, pin = km.kmeans_plain(_gen(3141592751, dev), X, K)
    assert c.shape == pc.shape and c.dtype == torch.float32
    assert lab.shape == plab.shape and lab.dtype == torch.int32
    assert inertia.shape == () and inertia.dtype == torch.float32
    ulp = torch.finfo(torch.float32).eps * pc.abs().clamp(min=1e-30)
    assert bool(((c - pc).abs() <= 4 * ulp).all()), (c - pc).abs().max()
    assert int((lab != plab).sum()) <= 8
    assert abs(float(inertia) - float(pin)) <= 1e-5 * abs(float(pin))
    assert _gap(X, c, lab) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_is_bitwise_repeatable(dev, name):
    """The same seed gives bitwise the same centers, labels and inertia,
    run after run (fixed-order sums, no float atomics)."""
    X, K = _case(name, dev)
    a = km.kmeans(_gen(1618033999, dev), X, K)
    b = km.kmeans(_gen(1618033999, dev), X, K)
    for s, t in zip(a, b):
        assert torch.equal(s, t)


@pytest.mark.cuda
def test_empty_cluster_keeps_its_center(dev):
    """Two distinct points, each repeated, and K=3: the third k-means++
    center repeats one of them, its cluster stays empty (ties go to the
    lower index) and it keeps its center; the kernel route is the plain
    version's, bitwise."""
    pts = np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 2.0, 3.0, 4.0]], np.float32)
    X = torch.as_tensor(np.repeat(pts, [700, 500], axis=0), device=dev)
    got = km.kmeans(_gen(5, dev), X, 3, n_iters=10, n_init=3)
    want = km.kmeans_plain(_gen(5, dev), X, 3, n_iters=10, n_init=3)
    for s, t in zip(got, want):
        assert torch.equal(s, t)
    c, lab = got[0].cpu(), got[1].cpu()
    counts = torch.bincount(lab.long(), minlength=3)
    (empty,) = (counts == 0).nonzero().flatten().tolist()
    assert any(torch.equal(c[empty], torch.from_numpy(p)) for p in pts)
    assert float(got[2]) == 0.0


@pytest.mark.cuda
def test_tie_between_trials_keeps_the_earlier(dev):
    """Four corners of a square, K=2: a left/right and a top/bottom split
    have exactly the same inertia. At a seed whose best trials end in
    both, the kernel route returns the earliest of them, as the plain
    version does."""
    corners = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
    X = torch.as_tensor(np.repeat(corners, 25, axis=0), device=dev)
    n, T = X.shape[0], 10
    for seed in range(64):
        perm, first, u = km._draws(_gen(seed, dev), n, n, 2, T, dev)
        trials = []
        for t in range(T):
            c = km._lloyd_plain(X, km._seed_plain(X, None, first[t], u[t], 2),
                                100)
            trials.append((float(torch.min(km._sq_dists(X, c), 1).values
                                 .double().sum()), c))
        best = min(i for i, _ in trials)
        tied = [c for i, c in trials if i == best]
        if any(not torch.equal(tied[0], c) for c in tied[1:]):
            break
    else:
        pytest.fail("no seed ties two different splits")
    got = km.kmeans(_gen(seed, dev), X, 2, n_init=T)
    assert torch.equal(got[0], tied[0])
    assert torch.equal(got[0], km.kmeans_plain(_gen(seed, dev), X, 2,
                                               n_init=T)[0])


# the host's runtime calls that put work on the card, as the profiler
# names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                 "cudaGraphLaunch", "cuGraphLaunch", "cudaMemsetAsync",
                 "cudaMemcpyAsync", "cuMemsetD8Async", "cuMemsetD32Async",
                 "cuMemcpyAsync")


@pytest.mark.cuda
def test_kmeans_span_has_the_kernel_route_and_few_launches(dev):
    """A traced call on the card: the ``kmeans`` span says "kernel" and
    counts the two launches of KM1 and KM2/KM3, as
    ``kmeans.kernel_launches`` does; the host puts at most 300 launches,
    copies and sets on the card for the whole call, the generator's
    draws included (``torch.profiler``'s runtime events)."""
    X, K = _case("chr21", dev)
    km.kmeans(_gen(0, dev), X, K)
    tr = Trace(on=True, device=dev)
    n0 = km.kmeans.kernel_launches
    with active(tr):
        km.kmeans(_gen(0, dev), X, K)
    (sp,) = [s for s in tr.spans if s.name == "kmeans"]
    assert sp.counts["route"] == "kernel"
    assert sp.counts["launches"] == 2
    assert km.kmeans.kernel_launches == n0 + 2
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        km.kmeans(_gen(0, dev), X, K)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.name in HOST_LAUNCHES]
    assert 2 <= len(names) <= 300, (len(names), sorted(set(names)))

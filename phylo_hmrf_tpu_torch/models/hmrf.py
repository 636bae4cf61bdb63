"""PhyloHMRF — the model class and EM engine, PyTorch port.

Counterpart of ``phylo_hmrf_tpu/models/hmrf.py``: every labeler of
``config.LABELERS`` and the hybrids ``mf_icm+{swap,expansion}@N``, then the
exact final polish, on one device or over a mesh of shards
(``mesh=make_mesh(...)``), in float32 or (``dtype="float64"``, the
strict-parity mode) in float64. Per EM iteration:

* E-step (`_estep_bucket`, per shape bucket of regions): the K-major unary
  from `gaussian_logpdf_kmajor`, then the labeler. ``mf_icm`` (the
  default): annealed mean field (kernel K1), two checkerboard-ICM runs,
  from the mean-field labels and from the warm labels (K2), the lower
  Potts energy of the two (K3). ``icm``: K2 from the warm labels. ``lbp``:
  a min-sum loopy BP proposal (``ops/lbp.py``, plain tensor code as in the
  JAX package) in place of the mean field. Then the fused posterior / cost
  / statistics pass (K4). Statistics come back per region and the host
  sums them in float64 in region order. With a mesh,
  ``shard_mode="region"`` (the default) deals each bucket's regions over
  the shards (``parallel/sharding.py``) and ``shard_mode="spatial"`` splits
  each region's rows over them with halo exchange (``parallel/halo.py``,
  kernels K1/K2 on deep halos, K7/K8 over all the shards of a device).
* Exact E-steps (``swap_tpu`` / ``expansion_tpu`` every iteration, a
  hybrid's exact passes on its schedule): `_exact_labels_all` (the K1-K3
  start, then swap or expansion moves on kernels K5 and K6), then K4 on
  those labels. The host ``swap`` / ``expansion`` labelers run the C++
  moves of ``native/`` on the float64 unary of the float64 moments, then
  K4.
* M-step (`mstep`): one batched boxed L-BFGS solve of the OU parameters of
  all K states on the device, the validity check and the OU moments, with
  the reference's retry ladder and the fallback to the init params.

After the loop, ``final_polish`` (the default) relabels the best
iteration's labels once under the restored best moments with exact
graph-cut moves (`_exact_labels_all` -> ``ops/maxflow.py``: the K1-K3
start, then expansion or swap moves, each a push-relabel min cut on
kernels K5 and K6); the exact labelers skip it, as the JAX engine does.

The host-side control flow (convergence, patience, best-iteration
bookkeeping, the numpy RNG draw order) follows the JAX engine line for
line, so a fit started from the same state follows the same trajectory up
to float rounding.

With a mesh, the init, the M-step, the exact labelings and K4 after them
run on the mesh's first device, which also keeps each whole region bucket.
There the exact moves label each region alone, as the JAX engine does on
a mesh (batched regions share one move schedule and one stopping test).

A spatial mesh may span processes (``make_mesh(..., processes=True)``
after ``initialize_distributed``): every process builds the same model on
the same regions and runs the same fit (SPMD). It places only its own row
blocks; the row-sharded E-step exchanges the rows at a process boundary
and all-gathers the shard sums and the label rows
(``parallel/halo.py``). What the paragraph above puts on the mesh's
first device runs on this process's first device, replicated on every
process from identical inputs, so every process holds the same fit: that
of the one-process mesh with the same shard count, bitwise. Region
sharding across processes raises (the JAX engine fails there too); its
counterpart is ``parallel/multiproc.py``.

``dtype="float64"`` runs every step above in float64 on the plain
PyTorch versions of the kernels, as the JAX engine runs its jnp paths
there (its fused kernels are float32-only): the kernels are chosen once,
by `use_kernels` of the model's device and dtype, and the choice goes down
to every kernel wrapper as ``plain=``. Its grid reductions take the
pinned order of ``ops/potts.py``, so its statistics do not depend on the
bucketing, the padding or the number of row shards. A float32 model built
after a float64 one in the same process stays float32 and runs its
kernels: nothing here is process-global.

``fit(checkpoint_path=..., resume=True)`` saves and resumes the EM state
in the JAX engine's checkpoint format (``utils/checkpoint.py``), so a
checkpoint of either package resumes in the other.

What raises rather than running: ``kmeans_backend="sklearn"`` (the GPU
machine has no scikit-learn); with ``shard_mode="spatial"``, any labeler
but ``mf_icm`` (``ValueError``, as in the JAX engine). Config fields read
by the JAX engine only to work around XLA or a remote TPU have no
counterpart here; each is noted where the JAX engine reads it (see
`_check_config`).
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Sequence

import numpy as np
import torch

from phylo_hmrf_tpu_torch.config import (PhyloHMRFConfig, SMALL_EPS,
                                         parse_hybrid_labeler)
from phylo_hmrf_tpu_torch.convert import to_numpy as _to_numpy
from phylo_hmrf_tpu_torch.data.regions import RegionGrid, flat_edge_list
from phylo_hmrf_tpu_torch.models.emission import (gaussian_logpdf,
                                                  gaussian_logpdf_kmajor)
from phylo_hmrf_tpu_torch.models.ou import (
    TreeTensors, check_params, ou_moments_batch, ou_nll_init, ou_nll_stats,
    propagate_mean_guess, tree_tensors)
from phylo_hmrf_tpu_torch.ops.finish_kernels import (
    cost_vec_from_sums, finish_stats)
from phylo_hmrf_tpu_torch.ops.icm_kernels import icm_kmajor
from phylo_hmrf_tpu_torch.ops.kmeans import kmeans
from phylo_hmrf_tpu_torch.ops.lbfgs import minimize_boxed
from phylo_hmrf_tpu_torch.ops.lbp import lbp_labels
from phylo_hmrf_tpu_torch.ops.maxflow import (
    CutStats, _icm_pick, _start_batch, exact_labels_batched)
from phylo_hmrf_tpu_torch.ops.potts import (pairwise_potential, valid_maps,
                                            weight_maps)
from phylo_hmrf_tpu_torch.parallel.halo import (
    estep_region_rowsharded, gather_rows, shard_rows)
from phylo_hmrf_tpu_torch.parallel.mesh import Mesh
from phylo_hmrf_tpu_torch.parallel.sharding import (
    device_put_bucket, make_sharded_estep, pad_bucket_to_devices)
from phylo_hmrf_tpu_torch.tree import PhyloTree
from phylo_hmrf_tpu_torch.utils import checkpoint as ckpt
from phylo_hmrf_tpu_torch.utils.profiling import ConvergenceMonitor, PhaseTimer

# the labelers whose every E-step is an exact move-making pass: after them
# the final polish would repeat what the last E-step did
EXACT_LABELERS = ("swap", "swap_tpu", "expansion", "expansion_tpu")


def _gauss_logpdf_np(X, mean, cov, min_covar):
    """Float64 Gaussian log-density of the host labelers, with the
    reference's robustness: symmetrise, Cholesky with escalating
    ``min_covar`` jitter, an eigen pseudo-inverse as the last resort."""
    c = 0.5 * (np.asarray(cov, np.float64) + np.asarray(cov, np.float64).T)
    F = c.shape[0]
    d = X - np.asarray(mean, np.float64)
    for mult in (0.0, 1.0, 10.0):
        try:
            L = np.linalg.cholesky(c + mult * min_covar * np.eye(F))
            sol = np.linalg.solve(L, d.T)
            logdet = 2.0 * np.log(np.diag(L)).sum()
            return -0.5 * (np.sum(sol * sol, axis=0) + logdet
                           + F * np.log(2.0 * np.pi))
        except np.linalg.LinAlgError:
            continue
    w, v = np.linalg.eigh(c)
    w_inv = np.where(w > 1e-12, 1.0 / np.maximum(w, 1e-12), 0.0)
    sol = (d @ v) * np.sqrt(w_inv)
    logdet = np.log(np.maximum(w, 1e-12)).sum()
    return -0.5 * (np.sum(sol * sol, axis=1) + logdet
                   + F * np.log(2.0 * np.pi))


@dataclasses.dataclass
class FitResult:
    """Same fields as the JAX engine's FitResult (the reference's
    fit_accumulate_test return tuple plus the restored moments)."""
    params_vec: np.ndarray     # best-cost OU params (K, n_params)
    params_vec1: np.ndarray    # best-cost-from-iter-3 OU params
    params_list: np.ndarray    # (n_iters, K, n_params)
    iter_id1: int              # iteration of the overall best cost
    iter_id2: int              # iteration of the best cost from iter >= 3
    cost_vec: np.ndarray       # (n_iters, 4): [iter, pairwise, unary, cost1]
    labels: np.ndarray         # (N,) flat states at iter_id2
    means: np.ndarray          # (K, F) restored from params_vec
    covars: np.ndarray         # (K, F, F) restored from params_vec
    n_iters: int = 0
    state_list: np.ndarray | None = None   # (n_iters, N) when track_states


def use_kernels(device, dtype) -> bool:
    """Whether a model on ``device`` in ``dtype`` runs the CUDA kernels:
    on a CUDA device in float32. The kernels are float32-only, as the JAX
    engine's fused kernels are (it turns them off in float64); elsewhere
    their plain versions run."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


def _estep_bucket(img, mask, dmaps, warm, means, covars, beta, beta1, *,
                  weighted_pp: bool, max_sweeps: int, labeler: str = "mf_icm",
                  plain: bool = False):
    """One E-step over a stacked region bucket (the JAX ``_estep_bucket``)
    with the ``labeler`` "mf_icm", "icm" or "lbp".

    img (R, H, W, F), mask (R, H, W) bool, dmaps (R, 4, H, W), warm
    (R, H, W) labels. Returns (labels (R, H, W) int32, per-region
    (post (R, K), obs (R, K, F), obs2 (R, K, F, F)), cost_vec (R, 4),
    n_valid (R,)). ``plain`` runs the kernels' plain versions on any
    device: the reference the kernel path is checked against on the card.
    """
    w_cut = weight_maps(dmaps, beta1)
    unary_k = -gaussian_logpdf_kmajor(img, means, covars)     # (R, K, H, W)
    if labeler == "mf_icm":
        labels = _start_batch(unary_k, w_cut, mask, warm, beta, max_sweeps,
                              plain=plain)
    elif labeler == "icm":
        labels = icm_kmajor(unary_k, w_cut, mask, warm, beta, max_sweeps,
                            plain=plain)
    elif labeler == "lbp":
        # the BP proposal runs per region in the (H, W, K) layout
        prop = torch.stack([lbp_labels(u.permute(1, 2, 0), w, m, beta)
                            for u, w, m in zip(unary_k, w_cut, mask)])
        labels = _icm_pick(unary_k, w_cut, mask, prop, warm, beta,
                           max_sweeps, plain=plain)
    else:
        raise ValueError(f"unknown E-step labeler {labeler!r}")
    stats, cost_vec, n_valid = _finish_fused(
        unary_k, img, mask, dmaps, labels, beta, beta1, weighted_pp,
        from_unary=True, plain=plain)
    return labels, stats, cost_vec, n_valid


def _finish_bucket(img, mask, dmaps, labels, means, covars, beta, beta1, *,
                   weighted_pp: bool, plain: bool = False):
    """K4 over a bucket's labels from elsewhere (the exact and the host
    labelers), on the K-major log-density."""
    lp_k = gaussian_logpdf_kmajor(img, means, covars)
    return _finish_fused(lp_k, img, mask, dmaps, labels, beta, beta1,
                         weighted_pp, plain=plain)


def _finish_fused(lp_k, img, mask, dmaps, labels, beta, beta1,
                  weighted_pp: bool, from_unary: bool = False,
                  plain: bool = False):
    """K4 over a bucket plus the per-region cost vector
    [pairwise, pairwise_nrm, unary, cost1] (`posteriors_and_costs`
    semantics). With ``from_unary`` lp_k is the unary (-logprob)."""
    w_pp = weight_maps(dmaps, beta1) if weighted_pp else valid_maps(dmaps)
    img_f = img.permute(0, 3, 1, 2).contiguous()
    post, obs, obs2, sums = finish_stats(
        lp_k, img_f, mask.to(torch.int32), labels.to(torch.int32), w_pp,
        beta, SMALL_EPS, negate=from_unary, plain=plain)
    cost_vec, n_valid = cost_vec_from_sums(sums)
    return (post, obs, obs2), cost_vec, n_valid


def _check_params_device(solved: torch.Tensor, n_nodes: int, lo=0.0,
                         hi=100.0) -> torch.Tensor:
    """Per-state validity of the (K, P) solved params on the device, the
    twin of `check_params` (the bounds are exact in float32)."""
    B = n_nodes - 1
    p1 = solved[:, 1:]
    alpha, lam, theta = p1[:, :B], p1[:, B:2 * B], p1[:, 2 * B:]
    finite = ~torch.isnan(p1).any(dim=1)
    in_box = (((alpha >= lo) & (alpha <= hi)).all(1)
              & ((lam >= lo) & (lam <= hi)).all(1)
              & ((theta >= -hi) & (theta <= hi)).all(1))
    return finite & in_box


def _mstep_solve_full(p0, post, obs, obs2, n_samples, lambda_0, min_covar, *,
                      tt: TreeTensors, lo, hi, iters):
    """M-step solve for all K states, validity and OU moments, on the
    device. The returned covariances carry the ``min_covar`` jitter, added
    in the model dtype like the host mirror (`_moments_np`), so both are
    equal."""
    def fn(p):
        return ou_nll_stats(p, post, obs, obs2, tt, n_samples, lambda_0,
                            min_covar)
    solved, _ = minimize_boxed(fn, p0, lo, hi, iters)
    valid = _check_params_device(solved, tt.tree.n_nodes)
    means, covars = ou_moments_batch(solved, tt)
    eye = torch.eye(covars.shape[-1], dtype=covars.dtype, device=covars.device)
    return solved, valid, means, covars + min_covar * eye


def _init_solve(p0, xbar, xxT, min_covar, *, tt: TreeTensors, lo, hi, iters):
    """Per-cluster OU init fits, all clusters in one batched solve."""
    def fn(p):
        return ou_nll_init(p, xbar, xxT, tt, min_covar)
    return minimize_boxed(fn, p0, lo, hi, iters)


def _init_cluster_stats(X: torch.Tensor, labels: torch.Tensor, k: int):
    """Per-cluster count, mean and second moment as one-hot matmuls."""
    onehot = torch.nn.functional.one_hot(labels.long(), k).to(X.dtype)
    cnt = onehot.sum(0)
    denom = torch.clamp(cnt, min=1.0)
    xbar = (onehot.T @ X) / denom[:, None]
    n, f = X.shape
    xpair = (X[:, :, None] * X[:, None, :]).reshape(n, f * f)
    xxT = ((onehot.T @ xpair) / denom[:, None]).reshape(k, f, f)
    return xbar, xxT, cnt


def _init_guess(centers: torch.Tensor, rand_part: torch.Tensor,
                tree: PhyloTree, n_params: int) -> torch.Tensor:
    """`propagate_mean_guess` for all clusters on the device: the leaf
    centers averaged up the tree (the same 0.5-weighted adds), after the
    host RNG draws in ``rand_part``."""
    n = tree.n_nodes
    vals = [None] * n
    for li, leaf in enumerate(tree.leaf_nodes):
        vals[int(leaf)] = centers[:, li]
    flags = [0 if v is None else 2 for v in vals]
    for j in range(n - 1, 0, -1):
        p = int(tree.parent[j])
        if flags[p] == 0:
            vals[p] = vals[j]
            flags[p] = 1
        elif flags[p] == 1:
            vals[p] = 0.5 * vals[p] + 0.5 * vals[j]
            flags[p] = 2
    zero = torch.zeros_like(centers[:, 0])
    mean_full = torch.stack([v if v is not None else zero for v in vals],
                            dim=1)
    return torch.cat([rand_part[:, :n_params - n], mean_full], dim=1)


def _check_config(cfg: PhyloHMRFConfig, mesh) -> None:
    """Raise on what the port does not run yet.

    Fields of the JAX engine with no counterpart here, on purpose:
    ``em_pipeline`` (its pipelined loop is bitwise the sequential loop, so
    the port runs the sequential one); ``prewarm_compiles`` (warms XLA
    compiles; the port has no compile step); ``use_pallas`` (the kernels
    run on a CUDA device in float32, `use_kernels`). The JAX engine's
    VMEM tile pickers and its ``_map_buckets`` compile-overlap threads and
    ``_dev_warm`` warm-label cache served XLA and the remote TPU link: the
    port's warm labels stay on the device anyway (the previous E-step's
    label tensors are passed straight back in)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a phylo_hmrf_tpu_torch.parallel.mesh."
                        f"Mesh (make_mesh), got {type(mesh).__name__}")
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32/float64, got {cfg.dtype!r}")
    if cfg.kmeans_backend != "jax":
        raise NotImplementedError(
            f"kmeans_backend={cfg.kmeans_backend!r} is not ported; the port "
            f"runs its own device k-means (kmeans_backend='jax')")


class PhyloHMRF:
    """Phylo-HMRF model over a set of region grids, on one torch device or
    over the shards of a ``mesh`` (`parallel.mesh.make_mesh`).

    ``device="cuda"`` (the default without a mesh) runs the CUDA kernels
    (in float32) and raises when CUDA is absent; ``device="cpu"``, and
    ``dtype="float64"`` anywhere, run every kernel's plain PyTorch
    version. With a mesh, each shard runs on its own device and the
    model's ``device`` is the mesh's first (this process's first, when
    the mesh spans processes)."""

    def __init__(self, tree: PhyloTree, regions: Sequence[RegionGrid],
                 config: PhyloHMRFConfig | None = None, mesh=None, *,
                 device=None):
        self.tree = tree
        self.regions = list(regions)
        self.cfg = config or PhyloHMRFConfig()
        self.mesh = mesh
        cfg = self.cfg
        # the spatial checks first, with the JAX engine's errors
        self._n_shards = mesh.size if isinstance(mesh, Mesh) else 1
        self._spatial = (self._n_shards > 1 and cfg.shard_mode == "spatial")
        if self._spatial:
            if cfg.labeler != "mf_icm":
                raise ValueError(
                    f"shard_mode='spatial' only supports labeler='mf_icm' "
                    f"(the row-sharded E-step is the MF+ICM pipeline); got "
                    f"labeler={cfg.labeler!r} — use shard_mode='region' "
                    f"for the other labelers")
            for r in self.regions:
                if r.shape[0] % self._n_shards:
                    raise ValueError(
                        f"spatial sharding needs region H divisible by the "
                        f"mesh size ({self._n_shards}); region "
                        f"{r.region_id} has H={r.shape[0]} — raise pad_h")
        _check_config(cfg, mesh)
        if mesh is not None:
            if mesh.spans_processes and not self._spatial:
                raise ValueError(
                    f"a mesh that spans processes ({mesh.describe()}) "
                    f"needs shard_mode='spatial'; region sharding across "
                    f"processes is MultiProcessPhyloHMRF "
                    f"(parallel/multiproc.py), got shard_mode="
                    f"{cfg.shard_mode!r}")
            if device is not None \
                    and torch.device(device) != mesh.first_device:
                raise ValueError(f"device={device!r} is not the mesh's first "
                                 f"device {mesh.first_device}")
            device = mesh.first_device
        self.device = torch.device("cuda" if device is None else device)
        for dev in (mesh.devices if mesh is not None else [self.device]):
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {dev} requested but CUDA is not "
                                   f"available")

        self._dtype = getattr(torch, cfg.dtype)
        self._np_dtype = np.dtype(cfg.dtype)
        # the one kernel choice of the model, passed down as ``plain``
        self._use_kernels = use_kernels(self.device, self._dtype)
        self.n_states = cfg.n_states
        self.n_features = tree.n_leaves
        self.n_params = tree.n_params

        self.offsets = np.zeros(len(self.regions) + 1, dtype=np.int64)
        for i, r in enumerate(self.regions):
            if r.img.shape[-1] != self.n_features:
                raise ValueError(
                    f"region {i} has {r.img.shape[-1]} features, tree has "
                    f"{self.n_features} leaves")
            self.offsets[i + 1] = self.offsets[i] + r.n_samples
        self.n_samples = int(self.offsets[-1])
        self.n_samples_total = self.n_samples
        self.len_vec = np.asarray([
            r.len_vec_row(int(self.offsets[i]), int(self.offsets[i + 1]))
            for i, r in enumerate(self.regions)],
            dtype=np.int64).reshape(-1, 10)

        # shape buckets, held on the (first) device for the whole fit; with
        # a mesh they serve the final polish, and the E-step reads the
        # sharded copies: padded region blocks per shard (region mode) or
        # row blocks of every region (spatial mode)
        buckets = {}
        for idx, r in enumerate(self.regions):
            buckets.setdefault(r.shape, []).append(idx)
        self._bucket_arrays = {}
        self._sharded_buckets = {}
        for shape, idxs in buckets.items():
            img = np.stack([self.regions[i].img
                            for i in idxs]).astype(self._np_dtype)
            mask = np.stack([self.regions[i].mask for i in idxs])
            dmaps = np.stack([self.regions[i].dmaps
                              for i in idxs]).astype(self._np_dtype)
            self._bucket_arrays[shape] = (
                idxs, self._dev(img), torch.as_tensor(mask,
                                                      device=self.device),
                self._dev(dmaps))
            if self._n_shards > 1 and not self._spatial:
                self._sharded_buckets[shape] = (idxs, *device_put_bucket(
                    mesh, *pad_bucket_to_devices(img, mask, dmaps,
                                                 self._n_shards)[:3]))
        if self._spatial:
            self._spatial_arrays = [
                (shard_rows(mesh, torch.as_tensor(r.img, dtype=self._dtype)),
                 shard_rows(mesh, torch.as_tensor(r.mask)),
                 shard_rows(mesh, torch.as_tensor(r.dmaps,
                                                  dtype=self._dtype), 1))
                for r in self.regions]
        # the labeler of the fast E-steps: a hybrid runs mf_icm between its
        # exact passes (`estep` routes the exact labelers itself)
        self._hybrid = parse_hybrid_labeler(cfg.labeler)
        self._labeler_static = (
            "mf_icm" if (self._hybrid is not None
                         or cfg.labeler in EXACT_LABELERS) else cfg.labeler)
        if self._n_shards > 1 and not self._spatial:
            self._sharded_estep = make_sharded_estep(
                mesh, weighted_pp=(cfg.estimate_type == 3),
                labeler=self._labeler_static, max_sweeps=cfg.icm_max_sweeps,
                plain=not self._use_kernels)
        self._tt = tree_tensors(tree, self.device, self._dtype)

        # mutable fit state
        self._rng = np.random.default_rng(cfg.seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self.params_vec = None       # (K, P) current OU params
        self.init_ou_params = None   # (K, P) k-means-fit OU params
        self.means_ = None           # (K, F)
        self.covars_ = None          # (K, F, F)
        self.labels_local = None     # warm-start label grids per region
        self.init_labels = None
        self.polish_stats_ = None    # CutStats of the last fit's polish
        self.exact_stats_ = []       # CutStats of each exact E-step
        self.hybrid_exact_iters_ = []

    def _dev(self, a, dtype=None) -> torch.Tensor:
        """``a`` on the model's device, in the model dtype unless given."""
        return torch.as_tensor(a, dtype=dtype or self._dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # initialization (reference `_init`)
    # ------------------------------------------------------------------

    def flat_values(self) -> np.ndarray:
        if not self.regions:
            # a multi-process run can deal this process an EMPTY region
            # share; the (0, F) shape keeps the init gather and the
            # reductions well-formed
            return np.zeros((0, self.n_features), np.float32)
        return np.concatenate([r.flat_values() for r in self.regions], axis=0)

    def _init_arrays(self):
        """(X, per-region [start, stop) slices into X) consumed by
        `initialize`. ``parallel/multiproc.py`` returns the GLOBAL sample
        matrix here, so k-means and the per-cluster OU fits are a
        single-process run's."""
        slices = [(int(self.offsets[i]), int(self.offsets[i + 1]))
                  for i in range(len(self.regions))]
        return self.flat_values(), slices

    def _sync_init(self, centers, labels):
        """Identity hook; ``parallel/multiproc.py`` broadcasts process 0's
        k-means result so every process warm-starts identically."""
        return centers, labels

    def initialize(self):
        """k-means, per-cluster stats, tree-propagated guesses and the
        attempt-0 OU init solve run on the device, then one read-back.
        k-means runs on the float32 samples, as the JAX engine's does in
        both modes; the stats, guesses and solve in the model dtype."""
        cfg = self.cfg
        X, init_slices = self._init_arrays()
        K, P = self.n_states, self.n_params
        X_dev = self._dev(X, torch.float32)
        centers_d, labels_d, _ = kmeans(self._gen, X_dev, K)
        xbar_d, xxT_d, cnt_d = _init_cluster_stats(X_dev.to(self._dtype),
                                                   labels_d, K)
        # host RNG draws in the reference order: params first, then one
        # guess per cluster
        params_draw = self._rng.random((K, P))
        rand_part = np.stack([cfg.initial_magnitude * self._rng.random(P)
                              for _ in range(K)])
        guesses_d = _init_guess(centers_d.to(self._dtype),
                                self._dev(rand_part), self.tree, P)
        solved_d, _ = _init_solve(
            guesses_d, xbar_d, xxT_d, cfg.min_covar, tt=self._tt,
            lo=cfg.param_lo, hi=cfg.param_hi, iters=cfg.mstep_iters)
        centers, labels, xbar, xxT, cnt, guesses, solved0 = (
            _to_numpy(t) for t in (centers_d, labels_d, xbar_d, xxT_d, cnt_d,
                                   guesses_d, solved_d))
        centers = np.asarray(centers, np.float64)
        # the k-means labels seed the warm-start grids; the multi-process
        # hook makes them process 0's on every process (the OU init params
        # from the pre-sync stats are broadcast after `initialize`)
        centers, labels = self._sync_init(centers, labels)
        pre = dict(xbar=np.asarray(xbar, np.float64),
                   xxT=np.asarray(xxT, np.float64), occupied=cnt > 0,
                   params=np.asarray(params_draw, np.float64),
                   guesses=np.asarray(guesses, np.float64),
                   solved0=np.asarray(solved0, np.float64))

        self.means_ = centers.copy()
        cv = np.cov(X.T) + cfg.min_covar * np.eye(self.n_features)
        self.covars_ = np.tile(cv, (K, 1, 1))
        self.init_ou_params = self._fit_init_params(centers, pre)
        self.params_vec = self.init_ou_params.copy()
        self.labels_local = [r.labels_to_grid(labels[s0:s1])
                             for r, (s0, s1) in zip(self.regions,
                                                    init_slices)]
        self.init_labels = labels.copy()

    def _fit_init_params(self, centers, pre) -> np.ndarray:
        """Per-cluster OU fits with the reference retry ladder; attempt 0 is
        the solve `initialize` already ran."""
        cfg = self.cfg
        K, P = self.n_states, self.n_params
        xbar, xxT, occupied = pre["xbar"], pre["xxT"], pre["occupied"]
        params, guesses = pre["params"].copy(), pre["guesses"].copy()
        for attempt in range(cfg.mstep_retries):
            if attempt == 0:
                solved = pre["solved0"]
            else:
                solved, _ = _init_solve(
                    self._dev(guesses), self._dev(xbar), self._dev(xxT),
                    cfg.min_covar, tt=self._tt, lo=cfg.param_lo,
                    hi=cfg.param_hi, iters=cfg.mstep_iters)
                solved = np.asarray(_to_numpy(solved), np.float64)
            bad = []
            for c in range(K):
                if not occupied[c]:
                    continue
                if check_params(solved[c], self.tree.n_nodes) > 0:
                    params[c] = solved[c]
                else:
                    bad.append(c)
            if not bad:
                break
            for c in bad:
                guesses[c] = propagate_mean_guess(
                    centers[c], self.tree, self._rng, cfg.initial_magnitude, P)
        else:
            for c in bad:
                # reference fallback: tree-propagated random guess
                params[c] = propagate_mean_guess(
                    centers[c], self.tree, self._rng, cfg.initial_magnitude, P)
        return params

    # ------------------------------------------------------------------
    # E-step
    # ------------------------------------------------------------------

    def estep(self, means, covars, warm_grids, exact_method=None):
        """E-step over all buckets (on a mesh: over the shards, in the
        config's ``shard_mode``). Returns (label grids per region, as
        device tensors; per-region stats (post (R, K), obs (R, K, F),
        obs2 (R, K, F, F)); costs (R, 4); n_valid (R,)), the numbers in
        float64 numpy after one read-back for the whole E-step.

        ``exact_method`` ("swap" / "expansion") labels this call with exact
        graph-cut moves (a hybrid labeler's exact pass); the ``swap_tpu`` /
        ``expansion_tpu`` labelers always do. The host ``swap`` /
        ``expansion`` labelers label with the C++ moves from the float64
        ``means`` / ``covars``; K4 reads their cast to the model dtype, as
        every other route does."""
        cfg = self.cfg
        if self._spatial and exact_method is not None:
            # fit cannot get here (the constructor refuses those labelers
            # in spatial mode); a direct caller must not get a mean-field
            # pass when it asked for an exact one
            raise ValueError("exact_method is not supported with "
                             "shard_mode='spatial'; use shard_mode='region'")
        K, F = self.n_states, self.n_features
        R = len(self.regions)
        post = np.zeros((R, K))
        obs = np.zeros((R, K, F))
        obs2 = np.zeros((R, K, F, F))
        costs = np.zeros((R, 4))
        nvalid = np.zeros(R)
        label_grids = [None] * R
        means_t = self._dev(means)
        covars_t = self._dev(covars)

        kw = dict(weighted_pp=(cfg.estimate_type == 3),
                  max_sweeps=cfg.icm_max_sweeps)

        def warm_of(idxs, pad=0):
            warm = torch.stack([
                torch.as_tensor(warm_grids[i], device=self.device)
                for i in idxs]).to(torch.int32)
            if pad:   # the empty regions padding a bucket to the mesh
                warm = torch.cat([warm, warm.new_zeros(
                    (pad,) + warm.shape[1:])])
            return warm

        if cfg.labeler in ("swap_tpu", "expansion_tpu"):
            exact_method = ("expansion" if cfg.labeler == "expansion_tpu"
                            else "swap")
        done = []   # (region indices, post, obs, obs2, costs, n_valid)
        if self._spatial:
            owners = self.mesh.owners
            for ri, (img, mask, dmaps) in enumerate(self._spatial_arrays):
                labels, (p, o, o2), cv, nv = estep_region_rowsharded(
                    img, mask, dmaps, shard_rows(self.mesh, warm_of([ri])[0]),
                    means_t, covars_t, cfg.beta, cfg.beta1,
                    plain=not self._use_kernels, owners=owners, **kw)
                label_grids[ri] = gather_rows(labels, self.device, owners)
                done.append(([ri], p[None], o[None], o2[None], cv[None],
                             nv[None]))
        elif exact_method is not None or cfg.labeler in ("swap", "expansion"):
            # labels from the exact moves, then K4 on them per bucket, on
            # the (first) device; the labels stay there
            if exact_method is not None:
                self.exact_stats_.append(CutStats())
                grids = self._exact_labels_all(
                    means, covars, warm_grids, method=exact_method,
                    stats=self.exact_stats_[-1])
            else:
                grids = [self._dev(g, torch.int32) for g in self._swap_labels(
                    means, covars, warm_grids, method=cfg.labeler)]
            for idxs, img, mask, dmaps in self._bucket_arrays.values():
                labels = torch.stack([grids[i] for i in idxs])
                (p, o, o2), cv, nv = _finish_bucket(
                    img, mask, dmaps, labels, means_t, covars_t, cfg.beta,
                    cfg.beta1, weighted_pp=kw["weighted_pp"],
                    plain=not self._use_kernels)
                done.append((idxs, p, o, o2, cv, nv))
                for bi, ri in enumerate(idxs):
                    label_grids[ri] = labels[bi]
        elif self._n_shards > 1:
            for idxs, img, mask, dmaps in self._sharded_buckets.values():
                r_pad = sum(x.shape[0] for x in img)
                labels, (p, o, o2), cv, nv = self._sharded_estep(
                    img, mask, dmaps, warm_of(idxs, r_pad - len(idxs)),
                    means_t, covars_t, cfg.beta, cfg.beta1)
                done.append((idxs, p, o, o2, cv, nv))
                for bi, ri in enumerate(idxs):
                    label_grids[ri] = labels[bi]
        else:
            for idxs, img, mask, dmaps in self._bucket_arrays.values():
                labels, (p, o, o2), cv, nv = _estep_bucket(
                    img, mask, dmaps, warm_of(idxs), means_t, covars_t,
                    cfg.beta, cfg.beta1, labeler=self._labeler_static,
                    plain=not self._use_kernels, **kw)
                done.append((idxs, p, o, o2, cv, nv))
                for bi, ri in enumerate(idxs):
                    label_grids[ri] = labels[bi]
        packed = []
        for idxs, p, o, o2, cv, nv in done:
            Rb = len(idxs)   # padding regions of a sharded bucket dropped
            packed.append(torch.cat([p[:Rb].reshape(Rb, -1),
                                     o[:Rb].reshape(Rb, -1),
                                     o2[:Rb].reshape(Rb, -1),
                                     cv[:Rb].reshape(Rb, -1),
                                     nv[:Rb].reshape(Rb, 1)],
                                    dim=1).flatten())
        host = (_to_numpy(torch.cat(packed)).astype(np.float64) if packed
                else np.zeros(0))   # no regions: an empty share
        cols = [K, K * F, K * F * F, 4, 1]
        at = 0
        for idxs, *_ in done:
            block = host[at:at + len(idxs) * sum(cols)].reshape(len(idxs), -1)
            at += block.size
            p, o, o2, cv, nv = np.split(block, np.cumsum(cols)[:-1], axis=1)
            for bi, ri in enumerate(idxs):
                post[ri] = p[bi]
                obs[ri] = o[bi].reshape(K, F)
                obs2[ri] = o2[bi].reshape(K, F, F)
                costs[ri] = cv[bi]
                nvalid[ri] = nv[bi, 0]
        return label_grids, (post, obs, obs2), costs, nvalid

    def _exact_labels_all(self, means, covars, warm_grids,
                          method: str = "swap",
                          stats: CutStats | None = None):
        """Exact labeling (mean field + ICM start, then graph-cut swap or
        expansion moves) of every region on the (first) device; returns
        the label grids as device tensors. One device labels each shape
        bucket as one batch. A mesh labels each region alone, a batch of
        one, as the JAX engine does: batched regions share one move
        schedule and one stopping test, so a bucket's labels can differ
        from its regions' own. (The unary is the K-major one of that
        region alone, as a one-region model computes it.)"""
        cfg = self.cfg
        out = [None] * len(self.regions)
        means_t = self._dev(means)
        covars_t = self._dev(covars)
        kw = dict(max_cycles=cfg.swap_tpu_cycles,
                  icm_max_sweeps=cfg.icm_max_sweeps, method=method,
                  stats=stats, plain=not self._use_kernels)
        for idxs, img, mask, dmaps in self._bucket_arrays.values():
            wm = weight_maps(dmaps, cfg.beta1)
            warm = torch.stack([
                torch.as_tensor(warm_grids[i], device=self.device)
                for i in idxs]).to(torch.int32)
            if self._n_shards > 1:
                for bi, ri in enumerate(idxs):
                    one = slice(bi, bi + 1)
                    unary_k = -gaussian_logpdf_kmajor(img[one], means_t,
                                                      covars_t)
                    out[ri] = exact_labels_batched(
                        unary_k, wm[one], mask[one], warm[one], cfg.beta,
                        self.n_states, **kw)[0]
                continue
            unary_k = -gaussian_logpdf_kmajor(img, means_t, covars_t)
            labels = exact_labels_batched(unary_k, wm, mask, warm, cfg.beta,
                                          self.n_states, **kw)
            for bi, ri in enumerate(idxs):
                out[ri] = labels[bi]
        return out

    def _swap_labels(self, means, covars, warm_grids, method: str = "swap"):
        """Exact graph-cut labeling on the host: the C++ alpha-beta swap
        (the reference's optimizer) or alpha-expansion of ``native/``, on
        the float64 unary of the float64 moments. Returns a host label
        grid per region."""
        from phylo_hmrf_tpu_torch import native

        solver = (native.potts_expansion if method == "expansion"
                  else native.potts_swap)
        means = np.asarray(_to_numpy(means), np.float64)
        covars = np.asarray(_to_numpy(covars), np.float64)
        out = []
        for r, warm in zip(self.regions, warm_grids):
            X = r.flat_values().astype(np.float64)
            logprob = np.stack([
                _gauss_logpdf_np(X, means[c], covars[c], self.cfg.min_covar)
                for c in range(self.n_states)], axis=1)
            edges = flat_edge_list(r, self.cfg.num_neighbor)
            w = np.exp(-self.cfg.beta1 * edges[:, 2])
            warm_flat = r.labels_to_flat(_to_numpy(warm)).astype(np.int32)
            labels = solver(edges[:, :2].astype(np.int64), w, -logprob,
                            self.cfg.beta, warm_flat,
                            self.cfg.swap_max_cycles)
            out.append(r.labels_to_grid(labels))
        return out

    # ------------------------------------------------------------------
    # M-step (reference `_do_mstep` + `_ou_optimize2`)
    # ------------------------------------------------------------------

    def _blend_guess(self) -> np.ndarray:
        """Reference initial-guess blend (one host RNG draw per attempt)."""
        cfg = self.cfg
        K, P, n1 = self.n_states, self.n_params, self.tree.n_nodes
        if cfg.initial_mode == 1:
            rand = 2.0 * self._rng.random((K, P)) - 1.0
            rand[:, :P - n1] = self._rng.random((K, P - n1))
            rand = cfg.initial_magnitude * rand
        else:
            rand = cfg.initial_magnitude * self._rng.random((K, P))
        a1, a2 = cfg.initial_weight, cfg.initial_weight1
        return (a1 * self.init_ou_params + a2 * self.params_vec
                + (1.0 - a1 - a2) * rand)

    def _global_stats(self, stats):
        """Per-region stats -> global sums, in region order (float64);
        ``parallel/multiproc.py`` sums every process's rows here."""
        post_r, obs_r, obs2_r = stats
        return post_r.sum(0), obs_r.sum(0), obs2_r.sum(0)

    def _global_costs(self, costs: np.ndarray,
                      ratio_vec: np.ndarray) -> np.ndarray:
        """Per-region cost rows -> sample-weighted global costs (over
        every process's rows in ``parallel/multiproc.py``)."""
        return costs.T @ ratio_vec

    def _solve_full_dev(self, guess, post, obs, obs2):
        cfg = self.cfg
        return _mstep_solve_full(
            self._dev(guess), self._dev(post), self._dev(obs),
            self._dev(obs2), float(self.n_samples_total), cfg.lambda_0,
            cfg.min_covar, tt=self._tt, lo=cfg.param_lo, hi=cfg.param_hi,
            iters=cfg.mstep_iters)

    def _moments_np(self, params):
        """OU moments of ``params`` with the jitter added in the model
        dtype, as float64."""
        means, covars = ou_moments_batch(self._dev(params), self._tt)
        eye = torch.eye(self.n_features, dtype=self._dtype,
                        device=self.device)
        covars = covars + self.cfg.min_covar * eye
        return (np.asarray(_to_numpy(means), np.float64),
                np.asarray(_to_numpy(covars), np.float64))

    def mstep(self, stats) -> np.ndarray:
        """Solve all states, accept the valid ones, retry the others with a
        fresh blended guess, and fall back to the init params."""
        cfg = self.cfg
        post, obs, obs2 = self._global_stats(stats)
        params = self.params_vec.copy()
        pending = np.ones(self.n_states, dtype=bool)
        fused_moments = None
        for attempt in range(cfg.mstep_retries):
            out = self._solve_full_dev(self._blend_guess(), post, obs, obs2)
            solved, valid, means_d, covars_d = (_to_numpy(t) for t in out)
            solved = np.asarray(solved, np.float64)
            valid = np.asarray(valid, bool)
            take = pending & valid
            params[take] = solved[take]
            if attempt == 0 and valid.all():
                # every state accepted this very solve: its moments stand
                fused_moments = (np.asarray(means_d, np.float64),
                                 np.asarray(covars_d, np.float64))
            pending = pending & ~valid
            if not pending.any():
                break
        if pending.any():
            # reference fallback: keep the k-means-fit init params
            params[pending] = self.init_ou_params[pending]
        self.params_vec = params
        if fused_moments is not None:
            self.means_, self.covars_ = fused_moments
        else:
            self.means_, self.covars_ = self._moments_np(params)
        return self.params_vec

    # ------------------------------------------------------------------
    # EM loop (reference `fit_accumulate_test`)
    # ------------------------------------------------------------------

    def fit(self, verbose: bool = True, callback=None,
            checkpoint_path: str | None = None, checkpoint_every: int = 5,
            resume: bool = False, patience: int | None = None,
            track_states: bool = False, monitor=None,
            cost_log: str | None = None) -> FitResult:
        """The sequential EM loop of the JAX engine's ``fit``.

        With ``checkpoint_path``, the EM state is saved after the M-step of
        every ``checkpoint_every``-th iteration: the per-iteration rows go
        to the append-only ``.hist`` sidecar, then the npz is replaced
        atomically. ``resume=True`` continues from that file when it
        exists (the numpy RNG included; the torch generator feeds only
        ``initialize``, which a resume skips)."""
        cfg = self.cfg
        patience = cfg.patience if patience is None else patience
        state_list = [] if track_states else None
        if monitor is None:
            monitor = ConvergenceMonitor(cfg.threshold, patience,
                                         log_file=cost_log)
        self.monitor_ = monitor
        self.timer = PhaseTimer()
        self.polish_stats_ = None
        it_start = 0
        restored = None
        if resume and checkpoint_path is not None:
            restored = ckpt.load_checkpoint(checkpoint_path)
        if restored is not None:
            arrays, meta = restored
            book = ckpt.restore_model(self, arrays, meta)
            it_start = int(book["iter"]) + 1
            prev = np.asarray(book["prev"])
            cost_rows = [list(r) for r in book["cost_rows"]]
            min_cost = list(book["min_cost"])
            min_cost1 = list(book["min_cost1"])
            params_best = arrays["params_best"].copy()
            params_best1 = arrays["params_best1"].copy()
            # the per-iteration rows live in the sidecar; the npz's offset
            # is authoritative (a partial tail is cut at the next save)
            hist_offset = int(book["hist_offset"])
            hist_states = bool(book["hist_states"])
            recs = ckpt.read_history(checkpoint_path, int(book["hist_count"]),
                                     2 if hist_states else 1)
            params_list = [r[0] for r in recs]
            if track_states and hist_states:
                state_list = [r[1] for r in recs]
            t_label_grids = [_regrid(r, arrays[f"t_labels_{i}"])
                             for i, r in enumerate(self.regions)]
            n_iters = it_start
            if verbose:
                print(f"[resume] from iter {it_start}")
        else:
            if self.params_vec is None:
                t0 = time.time()
                with self.timer.phase("init"):
                    self.initialize()
                if verbose:
                    print(f"[init] k-means + OU init in "
                          f"{time.time() - t0:.2f}s")
            prev = np.array([1e-3, 1e-3, 1e-3])  # pairwise/unary/cost1 "pre"
            cost_rows = []
            params_list = []
            min_cost = [0, 1000.0]
            min_cost1 = [0, 1000.0]
            params_best = self.params_vec.copy()
            params_best1 = self.params_vec.copy()
            t_label_grids = list(self.labels_local)
            n_iters = 0
            hist_offset = 0   # fresh run: the first save truncates a stale log
        hist_pending = []
        ratio_vec = (self.len_vec[:, 0].astype(np.float64)
                     / self.n_samples_total)

        # the relative cost changes the hybrid schedule reads; a resume
        # recomputes them from the restored rows, so it makes the exact or
        # fast choice the uninterrupted run made
        d3_prev = d12_prev = np.inf
        if it_start > 0 and len(cost_rows) >= 2:
            last, before = cost_rows[-1], cost_rows[-2]
            d3_prev = abs((last[3] - before[3]) / before[3])
            d12_prev = max(abs((last[1] - before[1]) / before[1]),
                           abs((last[2] - before[2]) / before[2]))
        self.hybrid_exact_iters_ = []
        self.exact_stats_ = []

        def _exact_for(it_n):
            """A hybrid labeler's exact pass at iteration ``it_n``: when the
            period comes up, when either stop rule is within 3x of its
            threshold (so the run cannot converge on the fast labeler's
            fixed point), or while cost1 still moves by more than
            ``hybrid_exact_hi``. None: the fast labeler."""
            if self._hybrid is None:
                return None
            method, period = self._hybrid
            if (it_n % period == 0 or d3_prev < 3 * cfg.threshold
                    or d12_prev < 3 * cfg.threshold
                    or d3_prev > cfg.hybrid_exact_hi):
                return method
            return None

        for it in range(it_start, cfg.max_iter):
            exact_method = _exact_for(it)
            if exact_method is not None:
                self.hybrid_exact_iters_.append(it)
            t0 = time.time()
            with self.timer.phase("estep"):
                label_grids, stats, costs, _ = self.estep(
                    self.means_, self.covars_, self.labels_local,
                    exact_method=exact_method)
            t1 = time.time()

            # the accumulated "pairwise_cost" that drives convergence and
            # is exported is the NORMALIZED one (reference base.py:388-389)
            reduced = self._global_costs(costs, ratio_vec)
            pairwise_cost_raw = float(reduced[0])
            pairwise_cost = float(reduced[1])
            unary_cost = float(reduced[2])
            cost1 = float(reduced[3])

            d1 = abs((pairwise_cost - prev[0]) / prev[0])
            d2 = abs((unary_cost - prev[1]) / prev[1])
            d3 = abs((cost1 - prev[2]) / prev[2])
            prev = np.array([pairwise_cost, unary_cost, cost1])
            d3_prev = d3
            d12_prev = max(d1, d2)

            monitor.report(it, pairwise_cost, unary_cost, cost1)
            cost_rows.append([it, pairwise_cost, unary_cost, cost1])
            params_list.append(self.params_vec.copy())
            hist_rec = [params_list[-1]]
            n_iters = it + 1
            if track_states:
                state_list.append(self._flat_labels(label_grids))
                hist_rec.append(state_list[-1])
            hist_pending.append(hist_rec)

            if verbose:
                print(f"[iter {it:3d}] pairwise={pairwise_cost:.6f} "
                      f"(raw={pairwise_cost_raw:.6f}) "
                      f"unary={unary_cost:.6f} cost1={cost1:.6f} "
                      f"estep={t1 - t0:.2f}s")

            if cost1 < min_cost[1]:
                min_cost = [it, cost1]
                params_best = self.params_vec.copy()
                self.labels_local = label_grids   # warm start from best
            if cost1 < min_cost1[1] and it >= cfg.best_from_iter:
                min_cost1 = [it, cost1]
                params_best1 = self.params_vec.copy()
                t_label_grids = label_grids

            if callback is not None:
                callback(self, it, cost_rows[-1], label_grids)

            if (((d1 < cfg.threshold and d2 < cfg.threshold)
                 or d3 < cfg.threshold) and it > cfg.min_iter):
                break
            if it - min_cost1[0] > patience:
                break

            t2 = time.time()
            with self.timer.phase("mstep"):
                self.mstep(stats)
            if verbose:
                print(f"[iter {it:3d}] mstep={time.time() - t2:.2f}s")

            if (checkpoint_path is not None
                    and (it + 1) % checkpoint_every == 0):
                # the post-M-step state; only the rows added since the last
                # save go to the sidecar, then the npz points at them
                hist_offset = ckpt.append_history(
                    checkpoint_path, hist_pending, truncate_to=hist_offset)
                hist_pending = []
                extra = {"params_best": params_best,
                         "params_best1": params_best1}
                for ri, g in enumerate(t_label_grids):
                    extra[f"t_labels_{ri}"] = _host_labels(g)
                ckpt.save_checkpoint(
                    checkpoint_path, self._host_state(),
                    {"iter": it, "prev": prev, "cost_rows": cost_rows,
                     "min_cost": min_cost, "min_cost1": min_cost1,
                     "hist_count": len(params_list),
                     "hist_offset": hist_offset,
                     "hist_states": bool(track_states)},
                    extra)

        # restore: params_vec1 = best-from-3; moments from the overall best
        self.params_vec = params_best1.copy()
        self.means_, self.covars_ = self._moments_np(params_best)

        if cfg.final_polish and cfg.labeler not in EXACT_LABELERS:
            # one exact graph-cut pass over the best-iteration labels under
            # the restored best-iteration moments
            self.polish_stats_ = CutStats()
            with self.timer.phase("final_polish"):
                t_label_grids = self._exact_labels_all(
                    self.means_, self.covars_, t_label_grids,
                    method=cfg.polish_method, stats=self.polish_stats_)

        return FitResult(
            params_vec=params_best, params_vec1=params_best1,
            params_list=np.asarray(params_list),
            iter_id1=min_cost[0], iter_id2=min_cost1[0],
            cost_vec=np.asarray(cost_rows),
            labels=self._flat_labels(t_label_grids),
            means=self.means_.copy(), covars=self.covars_.copy(),
            n_iters=n_iters,
            state_list=(np.asarray(state_list) if track_states else None))

    def fit_accumulate(self, **kw) -> FitResult:
        """The reference's ``fit_accumulate``: `fit` with a patience of 20
        iterations past the best cost and the states of every iteration
        tracked."""
        kw.setdefault("patience", 20)
        kw.setdefault("track_states", True)
        return self.fit(**kw)

    def fit_v1(self, **kw) -> FitResult:
        """The reference's v1 ``fit()``: patience 20, no minimum-iteration
        guard on the threshold stop, and the best cost from iteration 3 on
        restored for the params and the moments alike."""
        cfg0 = self.cfg
        self.cfg = dataclasses.replace(cfg0, min_iter=-1)
        try:
            kw.setdefault("patience", 20)
            result = self.fit(**kw)
        finally:
            self.cfg = cfg0
        self.params_vec = result.params_vec1.copy()
        self.means_, self.covars_ = self._moments_np(result.params_vec1)
        return dataclasses.replace(result, means=self.means_.copy(),
                                   covars=self.covars_.copy())

    # ------------------------------------------------------------------
    # inference under the current parameters
    # ------------------------------------------------------------------

    def predict(self) -> np.ndarray:
        """MAP state labels (N,) of all samples: one E-step of the
        configured labeler (a hybrid's fast one) from the warm labels."""
        if self.means_ is None:
            raise RuntimeError("model not initialized/fit")
        warm = self.labels_local or [
            np.zeros(r.shape, np.int32) for r in self.regions]
        label_grids, _, _, _ = self.estep(self.means_, self.covars_, warm)
        return self._flat_labels(label_grids)

    def predict_proba(self, labels_flat: np.ndarray | None = None
                      ) -> np.ndarray:
        """Per-sample state posteriors (N, K): softmax(logprob - pairwise
        potential) at the given labeling, or at `predict`'s."""
        cfg = self.cfg
        if self.means_ is None:
            raise RuntimeError("model not initialized/fit")
        if labels_flat is None:
            labels_flat = self.predict()
        means_t, covars_t = self._dev(self.means_), self._dev(self.covars_)
        out = np.zeros((self.n_samples, self.n_states), np.float64)
        for i, r in enumerate(self.regions):
            grid = self._dev(r.labels_to_grid(
                labels_flat[self.offsets[i]:self.offsets[i + 1]]),
                torch.int32)
            logprob = gaussian_logpdf(self._dev(r.img), means_t, covars_t)
            dmaps = self._dev(r.dmaps)
            w_pp = (weight_maps(dmaps, cfg.beta1) if cfg.estimate_type == 3
                    else valid_maps(dmaps))
            pp = pairwise_potential(grid, w_pp, self.n_states, cfg.beta)
            post = _to_numpy(torch.softmax(logprob - pp, dim=-1))
            out[self.offsets[i]:self.offsets[i + 1]] = \
                post[r.flat_rows, r.flat_cols]
        return out

    def score_samples(self, labels_flat: np.ndarray | None = None):
        """(total log probability, per-sample posteriors): the posteriors
        of `predict_proba` and the emission log-evidence
        sum_n logsumexp_k logprob(n, k) under a uniform state prior, summed
        in float64."""
        from scipy.special import logsumexp

        if self.means_ is None:
            raise RuntimeError("model not initialized/fit")
        posteriors = self.predict_proba(labels_flat)
        means_t, covars_t = self._dev(self.means_), self._dev(self.covars_)
        total = 0.0
        for r in self.regions:
            logprob = _to_numpy(gaussian_logpdf(self._dev(r.img), means_t,
                                                covars_t))
            lse = logsumexp(
                logprob[r.flat_rows, r.flat_cols].astype(np.float64), axis=-1)
            total += float(lse.sum()) - lse.shape[0] * np.log(self.n_states)
        return total, posteriors

    def _host_state(self):
        """What ``utils/checkpoint.py::save_checkpoint`` reads of the model,
        with the label grids (device tensors after an E-step) as host
        int32 arrays."""
        return types.SimpleNamespace(
            params_vec=self.params_vec, init_ou_params=self.init_ou_params,
            means_=self.means_, covars_=self.covars_,
            init_labels=self.init_labels,
            labels_local=[_host_labels(g) for g in self.labels_local],
            _rng=self._rng, cfg=self.cfg)

    def _flat_labels(self, grids) -> np.ndarray:
        if not self.regions:
            return np.zeros(0, np.int32)
        return np.concatenate([r.labels_to_flat(_to_numpy(g))
                               for r, g in zip(self.regions, grids)])


def _host_labels(grid) -> np.ndarray:
    """A label grid (device tensor or array) as a host int32 array."""
    return _to_numpy(grid).astype(np.int32)


def _regrid(region: RegionGrid, grid: np.ndarray) -> np.ndarray:
    """A saved label grid on ``region``'s padded shape: a grid saved under
    other padding goes through the padding-invariant flat samples, as
    ``utils/checkpoint.py::restore_model`` does for the warm labels."""
    if tuple(grid.shape) == tuple(region.shape):
        return grid.copy()
    return region.labels_to_grid(grid[region.flat_rows, region.flat_cols])

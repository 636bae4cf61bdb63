"""Configuration of a Phylo-HMRF run — the port's own copy.

A copy of ``phylo_hmrf_tpu/config.py`` with the same fields and defaults,
so one keyword set configures either package (the port imports nothing of
the JAX package). Fields the port reads no value from are listed in
``models/hmrf.py::_check_config``.

Defaults follow the reference CLI (`phylo_hmrf.py:1531-1568` in the reference
repo); where the reference README and code disagree (SURVEY.md section 5) the
*code* defaults win, since that is what a reference run produces.
"""

from __future__ import annotations

import dataclasses


LABELERS = ("mf_icm", "icm", "lbp", "swap_tpu", "swap",
            "expansion_tpu", "expansion")

# budgeted hybrid labelers: "mf_icm+swap@N" / "mf_icm+expansion@N" run the
# fast mean-field+ICM labeler most iterations and an exact on-device
# graph-cut pass every N-th iteration (and when cost1 improvement stalls);
# N=1 degenerates to exact cuts every iteration — the reference's E-step
# (phylo_hmrf.py:492-498)
_HYBRID_RE = r"^mf_icm\+(swap|expansion)@(\d+)$"


def parse_hybrid_labeler(labeler: str):
    """Returns (exact_method, period) for a hybrid labeler string, else
    None."""
    import re
    m = re.match(_HYBRID_RE, labeler)
    if not m:
        return None
    period = int(m.group(2))
    if period < 1:
        raise ValueError(f"hybrid labeler period must be >= 1: {labeler!r}")
    return m.group(1), period


@dataclasses.dataclass
class PhyloHMRFConfig:
    """All knobs for a Phylo-HMRF estimation run.

    Attributes mirror the reference flags (reference `phylo_hmrf.py:1531`)
    plus TPU-specific controls. All are plain Python values so the config can
    be serialized to JSON for checkpoint/resume.
    """

    # ---- model ----
    n_states: int = 10                 # -n/--num_states
    beta: float = 1.0                  # -b: Potts pairwise strength
    beta1: float = 0.5                 # --beta1: edge-weight decay, w_e = exp(-beta1 * d_e)
    cons_param: float = 1.0            # -c: lambda_0 ridge coefficient in the OU M-step
    min_covar: float = 1e-3            # jitter added to every synthesized covariance
    estimate_type: int = 0             # -g: 3 = weight the pairwise potential by edge weights
                                       # in the posterior/cost pass (graph cuts always use them)

    # ---- init blending (reference -d/-i/-k/-j) ----
    initial_mode: int = 0
    initial_weight: float = 0.3        # a1: weight on k-means-derived init params
    initial_weight1: float = 0.1       # a2: weight on previous-iteration params
    initial_magnitude: float = 1.0     # w2: magnitude of the random component

    # ---- EM control ----
    max_iter: int = 60                 # --miter
    threshold: float = 1e-3            # -e convergence threshold (relative cost change)
    patience: int = 50                 # iterations allowed past the best-cost iteration
    min_iter: int = 5                  # threshold-based stop only allowed after this many iters
    best_from_iter: int = 3            # best-tracked params/labels only recorded from this iter on
    em_pipeline: bool = True           # pipeline E-/M-step device dispatch: the next E-step
                                       # launches against the M-step's speculative device moments
                                       # so the M-step fetch never blocks the loop (bitwise-equal
                                       # trajectories; False forces the sequential loop)

    # ---- E-step label optimizer ----
    labeler: str = "mf_icm"            # "mf_icm" | "icm" | "lbp" (fast TPU
                                       # local opt) | "swap_tpu" / "expansion_tpu"
                                       #   (exact graph-cut moves on device
                                       #   via parallel push-relabel)
                                       # | "swap" / "expansion"
                                       #   (exact C++ oracle, CPU)
    use_pallas: str = "auto"           # "auto" (TPU only) | "on" | "off": fused MF Pallas kernel
    final_polish: bool = True          # polish the final state map with one
                                       # exact on-device graph-cut pass
    polish_method: str = "expansion"   # "expansion" (default: K dispatches/
                                       # cycle vs K(K-1)/2; measured on real
                                       # chr22 at K=20: 1.7x faster AND ~1%
                                       # lower energy than swap; a swap pass
                                       # after it improves only 0.003%) |
                                       # "swap" (the reference E-step's move
                                       # family, phylo_hmrf.py:496)
    swap_tpu_cycles: int = 4           # swap cycles per swap_tpu E-step /
                                       # final polish. Budget measured on
                                       # FULL real chr22 (K=5): cycle-1 gap
                                       # vs the C++ 5000-cycle oracle
                                       # 7.8e-4, cycle-2 4.5e-6, cycle-4
                                       # -4.2e-7 (below the oracle) at
                                       # 99.96% agreement; converged from
                                       # cycle 4 on (PARITY.md)
    hybrid_exact_hi: float = 0.05      # hybrid labelers only: run the exact
                                       # pass whenever the previous
                                       # iteration's relative cost1 change
                                       # exceeds this (trajectory still in
                                       # motion), in addition to the
                                       # periodic and stall triggers. The
                                       # fast labeler's gap vs exact cuts
                                       # concentrates in moving iterations
                                       # (tests/test_real_data.py)
    icm_max_sweeps: int = 60           # upper bound on checkerboard ICM sweeps per E-step
    swap_max_cycles: int = 5000        # C++ swap backend cycle budget (parity
                                       # with the reference graph-cut budget)
    prewarm_compiles: bool = True      # fit() warms every jit program it will
                                       # dispatch (per-bucket E-step, exact
                                       # graph-cut moves for hybrid/polish) in
                                       # a background thread on zero-capacity
                                       # dummies, so XLA compilation /
                                       # persistent-cache deserialization
                                       # overlaps the k-means init and the EM
                                       # iterations instead of serializing the
                                       # final polish (~105 s cold / 5-17 s
                                       # cache-warm at canonical K=20 scale)

    # ---- data pipeline ----
    resolution: int = 50000            # --resolution
    num_neighbor: int = 8              # --num_neighbor (4 or 8 connectivity)
    filter_mode: int = 0               # 0: anisotropic diffusion, 1: bilateral, else gaussian
    filter_sigma: float = 0.25         # -w (gaussian path)
    filter_param1: float = 5           # diffusion niter / bilateral sigma_color
    filter_param2: float = 50          # diffusion kappa / bilateral sigma_spatial
    diagonal_type: int = 0             # --dtype: 1 = keep only diagonal (symmetric) blocks
    mask_mode: str = "structural"      # "structural" (all grid pixels are
                                       # samples) | "observed" (drop interior
                                       # pixels with no Hi-C support, like the
                                       # reference's masked raster variant)
    x_min: float = 0.0
    legacy_bin_count: bool = True      # reproduce the reference's py2 floor-division bin count
    # centromere split points {chrom: (p1, p2)}; blocks spanning [p1,p2] are split.
    # Reference hard-codes hg38 chr3/chr6 (`utility.py:385`); here it is config.
    centromere_splits: dict = dataclasses.field(default_factory=lambda: {
        3: (90279522, 93797661),
        6: (57542947, 61520508),
    })

    # ---- numerics / hardware ----
    kmeans_backend: str = "jax"        # "jax" (TPU-native) | "sklearn"
                                       # (MiniBatchKMeans, reference parity)
    seed: int = 0
    dtype: str = "float32"
    mstep_iters: int = 150             # L-BFGS iterations per M-step solve
    mstep_retries: int = 10            # retry budget on NaN/out-of-bounds params (parity)
    param_lo: float = 1e-16            # SLSQP-equivalent box (reference `phylo_hmrf.py:1365`)
    param_hi: float = 100.0
    pad_h: int = 32                    # grid padding multiples; 32 lets the
                                       # fused MF/ICM kernels tile at >=32
                                       # rows (8 = f32 sublane minimum, but
                                       # small row tiles double halo traffic)
    pad_w: int = 128

    # ---- parallelism ----
    shard_mode: str = "region"         # "region": regions over devices;
                                       # "spatial": each region's rows over
                                       # devices (halo exchange — for few
                                       # huge grids, e.g. 10kb resolution)

    # ---- io ----
    run_id: int = 0
    output_path: str = "."
    annotation: str = "test"

    def __post_init__(self):
        if self.num_neighbor not in (4, 8):
            raise ValueError("num_neighbor must be 4 or 8 "
                             f"(got {self.num_neighbor})")
        if (self.labeler not in LABELERS
                and parse_hybrid_labeler(self.labeler) is None):
            raise ValueError(f"unknown labeler {self.labeler!r}")
        if self.polish_method not in ("swap", "expansion"):
            raise ValueError(f"unknown polish_method {self.polish_method!r}")

    @property
    def lambda_0(self) -> float:
        return self.cons_param

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PhyloHMRFConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


SMALL_EPS = 1e-16  # matches the reference's global `small_eps`
THRESH1 = 1e-5     # "missing pixel" threshold (reference `utility.py:47`)

"""phylo_hmrf_tpu_torch — the PyTorch/CUDA port of phylo_hmrf_tpu.

Runs ``PhyloHMRF(tree, regions, cfg, device=...).fit()`` for the
production ``mf_icm`` labeler and the default final exact polish
(graph-cut expansion or swap moves), in float32, on one device. The six
kernels of that path (mean-field sweep, checkerboard ICM phase, Potts
energy, fused posterior/statistics pass, push-relabel iteration, BFS
relabel sweep) are hand-written CUDA for the H100 (``csrc/``, built by
nvcc at first use); on CPU tensors their plain PyTorch versions run
instead. The package never imports jax; it
shares the JAX package's jax-free modules (config, tree, data, utils).

Importing the package turns TF32 off: the Gaussian quadratic form feeds
exp(), and reduced-precision matmul inputs visibly distort the posteriors.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from phylo_hmrf_tpu.config import PhyloHMRFConfig  # noqa: E402
from phylo_hmrf_tpu_torch.models.hmrf import FitResult, PhyloHMRF  # noqa: E402

__all__ = ["FitResult", "PhyloHMRF", "PhyloHMRFConfig"]

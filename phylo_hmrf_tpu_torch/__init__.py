"""phylo_hmrf_tpu_torch — the PyTorch/CUDA port of phylo_hmrf_tpu.

Runs ``PhyloHMRF(tree, regions, cfg, device=...).fit()`` for the
production ``mf_icm`` labeler and the default final exact polish
(graph-cut expansion or swap moves), in float32, on one device or over a
mesh of shards (``mesh=parallel.mesh.make_mesh(...)``, ``shard_mode``
"region" or "spatial"). The eight kernels of those paths (mean-field
sweep, checkerboard ICM phase, each also on halo-extended row shards;
Potts energy, fused posterior/statistics pass, push-relabel iteration, BFS
relabel sweep) are hand-written CUDA for the H100 (``csrc/``, built by
nvcc at first use); on CPU tensors their plain PyTorch versions run
instead. The package imports neither jax nor the JAX package: it keeps its
own copies of the config, tree, region grids, ``.mat`` writers, timers and
the C++ graph-cut oracle.

Importing the package turns TF32 off: the Gaussian quadratic form feeds
exp(), and reduced-precision matmul inputs visibly distort the posteriors.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig  # noqa: E402
from phylo_hmrf_tpu_torch.models.hmrf import FitResult, PhyloHMRF  # noqa: E402

__all__ = ["FitResult", "PhyloHMRF", "PhyloHMRFConfig"]

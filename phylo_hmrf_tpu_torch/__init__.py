"""phylo_hmrf_tpu_torch — the PyTorch/CUDA port of phylo_hmrf_tpu.

Runs ``PhyloHMRF(tree, regions, cfg, device=...).fit()`` with every
labeler of the JAX package and the default final exact polish (graph-cut
expansion or swap moves), in float32 or (``dtype="float64"``, on the
kernels' plain versions) float64, on one device or over a mesh of shards
(``mesh=parallel.mesh.make_mesh(...)``, ``shard_mode`` "region" or
"spatial"); around it the command line (``cli``), the post-processing
(``postprocess.smooth``), the metrics and ``compare`` tool, the simulator,
the BED helpers and the reconstruction script of the JAX package, without
pandas, scikit-learn or matplotlib. The eight kernels of those paths
(mean-field sweep, checkerboard ICM phase, each also on halo-extended row
shards;
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

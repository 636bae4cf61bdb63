"""Host helpers of the port: the ``.mat`` writers (``io``), the phase
timer, convergence monitor and trace scope (``profiling``), the label
metrics (``metrics``), EM checkpoints (``checkpoint``), the simulator
(``simulate``) and the BED helpers (``bedio``)."""

from phylo_hmrf_tpu_torch.utils.io import load_estimate, save_estimate
from phylo_hmrf_tpu_torch.utils.metrics import best_match_accuracy

__all__ = ["best_match_accuracy", "load_estimate", "save_estimate"]

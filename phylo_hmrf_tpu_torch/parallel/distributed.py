"""Multi-process initialization — counterpart of
``phylo_hmrf_tpu/parallel/distributed.py``.

Every process of a multi-process run calls `initialize_distributed` before
it reads any data. The processes join one ``torch.distributed`` group with
the ``gloo`` backend over TCP: what crosses processes is host (CPU) tensors
of sufficient statistics, cost scalars and the init's sample matrix
(``parallel/multiproc.py``), never device tensors, so NCCL is not used and
several processes may share one card. Each process runs its own regions on
the devices it sees (``CUDA_VISIBLE_DEVICES`` picks them).

The JAX package discovers a TPU pod when no argument is given; a GPU host
has no such runtime, so here a coordinator without a process count or id
raises.
"""

from __future__ import annotations

import os

import torch


def _local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def process_count() -> int:
    """Processes in the run (1 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> dict:
    """Join the run's process group from the arguments or the JAX
    package's env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID, the command line's contract): ``gloo`` with
    ``init_method=tcp://<coordinator_address>``.

    Returns a summary dict (``distributed``, ``process_index``,
    ``process_count``, ``n_devices`` over all processes,
    ``n_local_devices``); a no-op with no coordinator and at most one
    process."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    n_local = _local_device_count()
    if coordinator_address is None and num_processes in (None, 1):
        return {"distributed": False, "process_index": 0,
                "process_count": 1, "n_devices": n_local,
                "n_local_devices": n_local}
    if coordinator_address is None:
        raise ValueError(f"--num_processes {num_processes} needs "
                         f"--coordinator host:port (or "
                         f"JAX_COORDINATOR_ADDRESS)")
    if num_processes is None:
        raise ValueError(f"--coordinator {coordinator_address} needs "
                         f"--num_processes (or JAX_NUM_PROCESSES)")
    if process_id is None:
        raise ValueError(f"--coordinator {coordinator_address} needs "
                         f"--process_id (or JAX_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is outside "
                         f"[0, {num_processes})")

    import torch.distributed as dist

    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes)
    counts = [torch.zeros(1, dtype=torch.int64)
              for _ in range(num_processes)]
    dist.all_gather(counts, torch.tensor([n_local], dtype=torch.int64))
    return {"distributed": True,
            "process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "n_devices": int(sum(int(c) for c in counts)),
            "n_local_devices": n_local}

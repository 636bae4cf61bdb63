"""Multi-process initialization — counterpart of
``phylo_hmrf_tpu/parallel/distributed.py``.

Every process of a multi-process run calls `initialize_distributed` before
it reads any data. The processes join one ``torch.distributed`` group with
the ``gloo`` backend over TCP: what crosses processes is host (CPU) tensors
of sufficient statistics, cost scalars and the init's sample matrix
(``parallel/multiproc.py``), and the rows and shard sums of a mesh that
spans processes (`exchange_tensors`, `all_gather_tensors`), which are
staged through host (pinned) buffers, so NCCL is not used and several
processes may share one card (NCCL refuses two ranks on one card; a run
across cards over NCCL is not written). Each process runs its own regions
or shards on the devices it sees (``CUDA_VISIBLE_DEVICES`` picks them).

Every payload crosses as the raw bytes of its tensors (``uint8``) and is
reinterpreted on arrival, so float32 rows and int32 labels cross bit for
bit. Every cross-process call runs under `_collective`'s watchdog.

The JAX package discovers a TPU pod when no argument is given; a GPU host
has no such runtime, so here a coordinator without a process count or id
raises.
"""

from __future__ import annotations

import os
import time

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


def _collective(fn, *args):
    """Run a cross-process collective with an optional watchdog
    (PHMRF_COLLECTIVE_TIMEOUT_S > 0): a live-but-stuck peer otherwise
    stalls the gather until gloo's own timeout (30 minutes) with no
    diagnostic. On timeout the process prints a restart hint and
    HARD-exits (os._exit): recovery is restart-based (resume from the last
    checkpoint), so a fast loud death IS the detection mechanism — a gloo
    collective cannot be cancelled, and a plain raise would leave the
    process waiting on it."""
    t = float(os.environ.get("PHMRF_COLLECTIVE_TIMEOUT_S", "0"))
    if t <= 0:
        return fn(*args)
    import queue
    import sys
    import threading

    q = queue.Queue()

    def run():
        try:
            q.put((True, fn(*args)))
        except BaseException as e:   # noqa: BLE001 — relayed to caller
            q.put((False, e))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        ok, val = q.get(timeout=t)
    except queue.Empty:
        print(f"FATAL: cross-process collective timed out after "
              f"{t:.0f}s — a peer is unresponsive; restart the job to "
              f"resume from the last checkpoint", file=sys.stderr,
              flush=True)
        os._exit(17)
    if not ok:
        raise val
    return val


_pinned = {}


def _host_buffer(key, nbytes: int, device) -> torch.Tensor:
    """A CPU uint8 buffer of ``nbytes`` for staging tensors of ``device``:
    for a CUDA device a pinned buffer kept per ``key`` and size (the
    exchanges are synchronous, so each is free again when its call
    returns), else a new one."""
    if torch.device(device).type != "cuda":
        return torch.empty(nbytes, dtype=torch.uint8)
    buf = _pinned.get((key, nbytes))
    if buf is None:
        buf = _pinned[(key, nbytes)] = torch.empty(
            nbytes, dtype=torch.uint8, pin_memory=True)
    return buf


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` (C order) as a flat uint8 tensor on its device."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _pack(key, tensors) -> torch.Tensor:
    """The raw bytes of ``tensors``, one after another, in a host buffer
    (one copy from the device)."""
    raw = [_raw(t) for t in tensors]
    joined = raw[0] if len(raw) == 1 else torch.cat(raw)
    host = _host_buffer(key, joined.numel(), joined.device)
    host.copy_(joined)
    return host


def _unpack(buf: torch.Tensor, likes) -> list:
    """Tensors shaped and typed like ``likes``, on their device, read one
    after another from the host bytes ``buf`` (one copy to the device)."""
    dev = likes[0].device
    data = buf.to(dev) if dev.type != "cpu" else buf
    out, off = [], 0
    for like in likes:
        n = like.numel() * like.element_size()
        out.append(data[off:off + n].clone().view(like.dtype)
                   .reshape(like.shape))
        off += n
    return out


def _account(fn, nbytes: int, t0: float) -> None:
    fn.calls += 1
    fn.bytes += nbytes
    fn.seconds += time.perf_counter() - t0


def exchange_tensors(sends: dict, likes: dict) -> dict:
    """Point-to-point exchange with other processes of the default group:
    process ``p`` of ``sends`` gets the bytes of the tensors
    ``sends[p]`` in one message, and the one message from each process
    ``p`` of ``likes`` comes back as tensors shaped and typed like
    ``likes[p]``, on their device. Every pair of processes must call it
    at the same time, each side naming the other. Device tensors are
    staged through pinned host buffers (gloo's ``isend``/``irecv`` take
    CPU tensors). Counts its calls, the bytes it sent and its seconds
    (``exchange_tensors.calls`` / ``.bytes`` / ``.seconds``)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = {p: _pack(("send", p), ts) for p, ts in sends.items()}
    inbox = {p: _host_buffer(("recv", p),
                             sum(x.numel() * x.element_size() for x in ls),
                             ls[0].device)
             for p, ls in likes.items()}

    def run():
        works = [dist.irecv(b, src=p) for p, b in inbox.items()]
        works += [dist.isend(b, dst=p) for p, b in out.items()]
        for w in works:
            w.wait()
    _collective(run)
    got = {p: _unpack(inbox[p], ls) for p, ls in likes.items()}
    _account(exchange_tensors, sum(b.numel() for b in out.values()), t0)
    return got


exchange_tensors.calls = exchange_tensors.bytes = 0
exchange_tensors.seconds = 0.0


def all_gather_tensors(tensors, n_max: int) -> list:
    """Every process's list of ``tensors`` (at most ``n_max`` each, all
    shaped and typed like ``tensors[0]``), in process order: one
    all-gather of the raw bytes padded to ``n_max`` tensors. Returns one
    list of ``n_max`` tensors a process, on ``tensors[0]``'s device; only
    the first as many as that process gave hold its data. Counts like
    `exchange_tensors`."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    like = tensors[0]
    padded = list(tensors) + [like] * (n_max - len(tensors))
    mine = _pack("gather", padded)
    bufs = [torch.empty_like(mine, device="cpu")
            for _ in range(process_count())]
    _collective(dist.all_gather, bufs, mine)
    got = [_unpack(b, [like] * n_max) for b in bufs]
    _account(all_gather_tensors, mine.numel(), t0)
    return got


all_gather_tensors.calls = all_gather_tensors.bytes = 0
all_gather_tensors.seconds = 0.0

"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled by ``nvcc`` into ONE shared library with a plain C
interface and loaded through ``ctypes`` — no PyTorch headers are compiled,
so a cold build takes seconds, not minutes. Each ``.cu`` source compiles
to an object in its own ``nvcc`` process, all started together, and one
more ``nvcc`` links them. The library is built at first use, from the
``.cu``/``.cuh`` sources in this package only, into ``csrc/build/``
(git-ignored). Its file name carries a hash of the sources
and the compiler flags, so an edited source rebuilds on the next use and a
stale library is never loaded. Same pattern as the host C++ build of the
JAX package (``phylo_hmrf_tpu/native/__init__.py``).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0. Nothing
here falls back to a CPU path: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v: registers, shared memory and spills per kernel (build_log)
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]
LINK_FLAGS = [*_ARCH, "-shared"]

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the last build in this process
build_log = ""           # the compilers' messages of that build


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    return srcs, hdrs


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found (set CUDA_HOME or PATH)")
    return path


def lib_path() -> str:
    """Path of the library for the current sources and flags."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libphmrf_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no library for the current sources exists:
    one nvcc per source, all in parallel, then one link."""
    global build_seconds, build_log
    import time

    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs, _ = _sources()
    nvcc = _nvcc()
    tag = f"{path}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o",
                                   o, s], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, log) for s, p, log in zip(srcs, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(
                f"{s}:\n{log}" for s, log in failed))
        cmd = [nvcc, *LINK_FLAGS, "-o", f"{tag}.tmp", *objs]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise KernelBuildError(f"nvcc link failed ({' '.join(cmd)}):\n"
                                   f"{e.stdout}\n{e.stderr}") from e
        # atomic: a concurrent build never sees half a library
        os.replace(f"{tag}.tmp", path)
    finally:
        for f in [*objs, f"{tag}.tmp"]:
            if os.path.exists(f):
                os.remove(f)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return path


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (every one returns int = cudaError_t)
_SIGNATURES = {
    # the chained reference of K1 and K7 (one sweep): q, base, w, out, R,
    #     K, H, W, T, damp, one_minus_damp, beta, stream
    "phmrf_mf_sweep": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    # K1: q, base, w, out, R, K, H, W, n_inner, T, damp, one_minus_damp,
    #     beta, tile rows, tile cols, halo, threads, stream
    "phmrf_mf_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                       _I, _I, _I, _I, _P],
    # the chained reference of K2 and K8 (one phase): labels, unary, w,
    #     mask, R, K, H, W, beta, phase_a, phase_b, stream
    "phmrf_icm_phase": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # K7: shard table (int64 rows), shards, K, W, tile rows, sweeps, T,
    #     damp, one_minus_damp, beta, barrier word, stream
    "phmrf_mf_halo": [_P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    # K8: shard table (int64 rows), shards, K, W, first phase, phases,
    #     beta, changed counter, barrier word, stream
    "phmrf_icm_halo": [_P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    # the largest co-resident grids of K7 (K, tile rows) and K8
    "phmrf_mf_halo_grid": [_I, _I],
    "phmrf_icm_halo_grid": [],
    # K2: labels, out, unary, w, mask, R, K, H, W, beta, row_parity, tile
    #     rows, tile cols, threads, loop word (may be null), stream
    "phmrf_icm_pair": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                       _I, _P, _P],
    # K3: unary, mask, labels_a, labels_b (null: one labeling), w, partial,
    #     tickets, out, R, K, H, W, beta, stream
    "phmrf_potts_energy": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _F, _P],
    # K4: lp, img, mask, labels, w, partial, tickets, out, R, K, F, H, W,
    #     beta, small_eps, negate, out_f64, stream
    "phmrf_finish_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _F, _I, _I, _P],
    # K5: e, h, cap_t, caps, e_out, h_out, cap_t_out, caps_out, R, H, W, n,
    #     n_inner, loop word (may be null), stream
    "phmrf_pr_iterations": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P, _P],
    # K6: d, d_out, caps, R, H, W, n, n_inner, loop word (may be null),
    #     stream
    "phmrf_bfs_sweeps": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # the loop graphs (loops.cu), each writing its executable graph to the
    # last pointer; `units`: null (kernel nodes) or an array of captured
    # graphs (child nodes). BFS fixpoint: d0, d1, caps, R, H, W, n, bfs
    # word, counters, units
    "phmrf_graph_bfs": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # min cut: e, h, cap_t, caps, the other set of four, d0, d1, R, H, W,
    #     n, pr word, bfs word, counters, units
    "phmrf_graph_cut": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _P, _P, _P, _P, _P],
    # ICM: l0, l1, unary, w, mask, R, K, H, W, beta, tile rows, tile cols,
    #     threads, loop word, counters, units
    "phmrf_graph_icm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                        _P, _P, _P, _P],
    # a unit loop: the captured unit, loop word, counters, the counter of
    #     its launches, launches a body
    "phmrf_graph_unit_loop": [_P, _P, _P, _I, _I, _P],
    # executable graph, stream
    "phmrf_graph_launch": [_P, _P],
    "phmrf_graph_destroy": [_P],
    # out: the CUDA driver's version
    "phmrf_driver_version": [_P],
    # doubles of K3's / K4's partial-sum buffer: (R, H, W), (R, K, F, H, W)
    "phmrf_energy_slots": [_I, _I, _I],
    "phmrf_finish_slots": [_I, _I, _I, _I, _I],
}


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err}")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t):
    """Context that makes ``t``'s card the current one: a kernel launches
    on the current card, so every launch runs under its operands' card
    (shards of a mesh may sit on several)."""
    import torch
    return torch.cuda.device(t.device)


def check_tensors(what: str, **specs) -> None:
    """Validate kernel operands before their pointers go to C: each keyword
    is ``name=(tensor, dtype, shape)``; all must be contiguous, of that
    dtype and shape, and on one CUDA device. (It runs on every launch of
    the min-cut loop, so it reads each attribute once.)"""
    device = None
    for name, (t, dtype, shape) in specs.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")
        index = t.get_device()
        if device is None:
            device = index
        elif index != device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"other operands on cuda:{device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, needs {dtype}")
        if t.shape != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"needs {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")

"""The host C++ graph-cut oracle: lazy g++ build and ctypes bindings.

``maxflow.cc`` is a copy of ``phylo_hmrf_tpu/native/maxflow.cc`` (exact
alpha-expansion by Boykov-Kolmogorov max flow on a general graph, and the
weighted-Potts energy, in float64). The port holds its exact polish to it.
The library is built with g++ at first use into ``native/build/``
(git-ignored), named by a hash of the source and flags, so an edited
source rebuilds and a stale library is never loaded. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "maxflow.cc")
BUILD_DIR = os.path.join(_DIR, "build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def build() -> str:
    """Compile the oracle if no library for the current source exists;
    returns its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    path = os.path.join(BUILD_DIR,
                        f"libphmrf_oracle_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)   # atomic: no reader sees half a library
    except FileNotFoundError as e:
        raise NativeBuildError("g++ not available") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"oracle build failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the oracle; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.phmrf_potts_energy.restype = ctypes.c_double
            lib.phmrf_potts_energy.argtypes = [
                i64, i64, i64p, f64p, f64p, i32, ctypes.c_double, i32p]
            lib.phmrf_potts_expansion.restype = i32
            lib.phmrf_potts_expansion.argtypes = [
                i64, i64, i64p, f64p, f64p, i32, ctypes.c_double, i32, i32p]
            _lib = lib
    return _lib


def _graph(edges, weights, unary):
    """Contiguous int64 edge ids, float64 weights and unary, and their
    ctypes pointers (the arrays must outlive the call)."""
    e = np.ascontiguousarray(edges[:, :2], dtype=np.int64)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    u = np.ascontiguousarray(unary, dtype=np.float64)
    f64p = ctypes.POINTER(ctypes.c_double)
    return (e, w, u), (e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                       w.ctypes.data_as(f64p), u.ctypes.data_as(f64p))


def potts_energy(edges: np.ndarray, weights: np.ndarray, unary: np.ndarray,
                 beta: float, labels: np.ndarray) -> float:
    """Exact weighted-Potts energy on a general graph (float64). edges
    (E, >=2) flat sample ids, weights (E,), unary (N, K), labels (N,)."""
    lib = load()
    n, k = unary.shape
    arrays, (e_p, w_p, u_p) = _graph(edges, weights, unary)
    lab = np.ascontiguousarray(labels, dtype=np.int32)
    return lib.phmrf_potts_energy(
        n, edges.shape[0], e_p, w_p, u_p, k, beta,
        lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))


def potts_expansion(edges: np.ndarray, weights: np.ndarray,
                    unary: np.ndarray, beta: float, init_labels: np.ndarray,
                    max_cycles: int = 5000) -> np.ndarray:
    """Exact alpha-expansion from ``init_labels``; returns new labels."""
    lib = load()
    n, k = unary.shape
    arrays, (e_p, w_p, u_p) = _graph(edges, weights, unary)
    labels = np.array(init_labels, dtype=np.int32, copy=True)
    lib.phmrf_potts_expansion(
        n, edges.shape[0], e_p, w_p, u_p, k, beta, max_cycles,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels

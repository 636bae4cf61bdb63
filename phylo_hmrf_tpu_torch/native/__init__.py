"""The host C++ library: the graph-cut oracle and the data loader's hole
fill, built with g++ at first use, bound with ctypes.

``maxflow.cc`` is a copy of ``phylo_hmrf_tpu/native/maxflow.cc`` (exact
alpha-beta swap and alpha-expansion by Boykov-Kolmogorov max flow on a
general graph, and the weighted-Potts energy, in float64): the host
``swap`` / ``expansion`` labelers, and the oracle the port holds its exact
moves to.
``gridops.cc`` is a copy of ``phylo_hmrf_tpu/native/gridops.cc``: the
reference's sequential median hole fill (``data/filters.py::hole_fill``).
Both build into one library in ``native/build/`` (git-ignored), named by a
hash of the sources and flags, so an edited source rebuilds and a stale
library is never loaded. A failed build raises `NativeBuildError`.
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
SOURCES = [SOURCE, os.path.join(_DIR, "gridops.cc")]
BUILD_DIR = os.path.join(_DIR, "build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# hole-fill variant -> entry point (reference near_interpolation1,
# near_interpolation1a, near_interpolation2)
HOLE_FILLS = {"sym": "phmrf_hole_fill_sym", "rect": "phmrf_hole_fill_rect",
              "sym2": "phmrf_hole_fill_sym2"}
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def build() -> str:
    """Compile the library if none for the current sources exists;
    returns its path."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR,
                        f"libphmrf_native_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, *SOURCES], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)   # atomic: no reader sees half a library
    except FileNotFoundError as e:
        raise NativeBuildError("g++ not available") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"native build failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
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
            for name in ("phmrf_potts_swap", "phmrf_potts_expansion"):
                fn = getattr(lib, name)
                fn.restype = i32
                fn.argtypes = [i64, i64, i64p, f64p, f64p, i32,
                               ctypes.c_double, i32, i32p]
            for name in HOLE_FILLS.values():
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [f64p, i64, i64, ctypes.c_double, i32]
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


def _moves(entry: str, edges, weights, unary, beta, init_labels,
           max_cycles) -> np.ndarray:
    """Run the move-making entry point ``entry`` from ``init_labels``;
    returns the new labels."""
    n, k = unary.shape
    arrays, (e_p, w_p, u_p) = _graph(edges, weights, unary)
    labels = np.array(init_labels, dtype=np.int32, copy=True)
    getattr(load(), entry)(
        n, edges.shape[0], e_p, w_p, u_p, k, beta, max_cycles,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels


def potts_swap(edges: np.ndarray, weights: np.ndarray, unary: np.ndarray,
               beta: float, init_labels: np.ndarray,
               max_cycles: int = 5000) -> np.ndarray:
    """Exact alpha-beta swap from ``init_labels`` (the reference E-step's
    move family, ``pygco.cut_general_graph(..., algorithm='swap')``);
    returns new labels."""
    return _moves("phmrf_potts_swap", edges, weights, unary, beta,
                  init_labels, max_cycles)


def potts_expansion(edges: np.ndarray, weights: np.ndarray,
                    unary: np.ndarray, beta: float, init_labels: np.ndarray,
                    max_cycles: int = 5000) -> np.ndarray:
    """Exact alpha-expansion from ``init_labels``; returns new labels."""
    return _moves("phmrf_potts_expansion", edges, weights, unary, beta,
                  init_labels, max_cycles)


def hole_fill(mtx: np.ndarray, variant: str, threshold: float) -> None:
    """The sequential median hole fill of ``gridops.cc``, in place on a
    C-contiguous float64 (H, W) array; ``variant`` is a key of
    `HOLE_FILLS`."""
    if mtx.dtype != np.float64 or not mtx.flags.c_contiguous:
        raise ValueError("hole_fill needs a C-contiguous float64 array")
    fn = getattr(load(), HOLE_FILLS[variant])
    fn(mtx.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), mtx.shape[0],
       mtx.shape[1], threshold, 3)

"""Host-side graph preprocessing in C++ (``graph_prep.cpp``), bound with
ctypes.

Counterpart of ``laplace_gnn_tpu/native/__init__.py``, with its own copy of
the source. The shared library is compiled at first use (``g++ -O3
-shared -fPIC``, with OpenMP when that builds) into
``laplace_gnn_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source, so an edited source rebuilds and a stale
library is never loaded. Concurrent first uses (test workers) each compile
to a temporary file and rename it into place. Every entry point has a
numpy version in :mod:`laplace_gnn_torch.graph.container` with the same
results; ``available()`` gates every call site, and is False where no
compiler is present.

Build by hand: ``python -m laplace_gnn_torch.native.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "graph_prep.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"_graph_prep_{digest}.so"


def build(verbose: bool = False) -> str:
    """Compile ``graph_prep.cpp`` unless its library exists; returns the
    library's path."""
    so = library_path()
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    for extra in (["-fopenmp"], []):       # OpenMP where it builds
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *flags, *extra, str(SRC), "-o", tmp],
                           check=True, capture_output=not verbose)
            os.replace(tmp, so)
            return str(so)
        except (subprocess.CalledProcessError, FileNotFoundError):
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise RuntimeError("g++ compilation of graph_prep.cpp failed")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:     # no compiler, or no load
        print(f"laplace_gnn_torch.native: using numpy ({e})",
              file=sys.stderr)
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.lg_degree.argtypes = [i32p, f64p, ctypes.c_int64, ctypes.c_int32,
                              f64p]
    lib.lg_degree.restype = None
    lib.lg_sort_by_dst.argtypes = [i32p, i32p, f64p, ctypes.c_int64,
                                   ctypes.c_int32, i32p, i32p, f64p, i64p]
    lib.lg_sort_by_dst.restype = None
    lib.lg_lexsort2.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                                i64p]
    lib.lg_lexsort2.restype = None
    lib.lg_check_symmetric.argtypes = [i32p, i32p, f64p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_double,
                                       ctypes.c_double]
    lib.lg_check_symmetric.restype = ctypes.c_int
    lib.lg_choose_k.argtypes = [i64p, ctypes.c_int32, ctypes.c_double]
    lib.lg_choose_k.restype = ctypes.c_int32
    lib.lg_rem_count.argtypes = [i64p, ctypes.c_int32, ctypes.c_int32]
    lib.lg_rem_count.restype = ctypes.c_int64
    lib.lg_ell_pack.argtypes = [i32p, f64p, i64p, ctypes.c_int32,
                                ctypes.c_int32, i32p, f64p, i32p, i32p, f64p]
    lib.lg_ell_pack.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _as(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def degree(dst, w, n_nodes: int) -> np.ndarray:
    """Weighted in-degree (``np.add.at(deg, dst, w)``)."""
    lib = _load()
    dst = _as(dst, np.int32)
    w = _as(w, np.float64)
    out = np.zeros(n_nodes, np.float64)
    lib.lg_degree(_p(dst, ctypes.c_int32), _p(w, ctypes.c_double),
                  len(dst), n_nodes, _p(out, ctypes.c_double))
    return out


def sort_by_dst(src, dst, w, n_nodes: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stable sort of the edges by dst; returns (src, dst, w, offsets)."""
    lib = _load()
    src = _as(src, np.int32)
    dst = _as(dst, np.int32)
    w = _as(w, np.float64)
    E = len(src)
    so = np.empty(E, np.int32)
    do = np.empty(E, np.int32)
    wo = np.empty(E, np.float64)
    offs = np.empty(n_nodes + 1, np.int64)
    lib.lg_sort_by_dst(_p(src, ctypes.c_int32), _p(dst, ctypes.c_int32),
                       _p(w, ctypes.c_double), E, n_nodes,
                       _p(so, ctypes.c_int32), _p(do, ctypes.c_int32),
                       _p(wo, ctypes.c_double), _p(offs, ctypes.c_int64))
    return so, do, wo, offs


def check_symmetric(src, dst, w, n_nodes: int, rtol: float = 1e-5,
                    atol: float = 1e-8) -> bool:
    lib = _load()
    src = _as(src, np.int32)
    dst = _as(dst, np.int32)
    w = _as(w, np.float64)
    return bool(lib.lg_check_symmetric(
        _p(src, ctypes.c_int32), _p(dst, ctypes.c_int32),
        _p(w, ctypes.c_double), len(src), n_nodes, rtol, atol))


def choose_k(offsets: np.ndarray, pad_budget: float) -> int:
    lib = _load()
    offsets = _as(offsets, np.int64)
    return int(lib.lg_choose_k(_p(offsets, ctypes.c_int64),
                               len(offsets) - 1, pad_budget))


def ell_pack(src_sorted, w_sorted, offsets, K: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                        np.ndarray]:
    """Pack dst-sorted edges into an (N, K) ELL table and a COO remainder.

    Returns (cols, vals, rem_src, rem_dst, rem_w)."""
    lib = _load()
    src_sorted = _as(src_sorted, np.int32)
    w_sorted = _as(w_sorted, np.float64)
    offsets = _as(offsets, np.int64)
    n = len(offsets) - 1
    rem_n = int(lib.lg_rem_count(_p(offsets, ctypes.c_int64), n, K))
    cols = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K), np.float64)
    rem_src = np.empty(rem_n, np.int32)
    rem_dst = np.empty(rem_n, np.int32)
    rem_w = np.empty(rem_n, np.float64)
    lib.lg_ell_pack(_p(src_sorted, ctypes.c_int32),
                    _p(w_sorted, ctypes.c_double),
                    _p(offsets, ctypes.c_int64), n, K,
                    _p(cols, ctypes.c_int32), _p(vals, ctypes.c_double),
                    _p(rem_src, ctypes.c_int32), _p(rem_dst, ctypes.c_int32),
                    _p(rem_w, ctypes.c_double))
    return cols, vals, rem_src, rem_dst, rem_w

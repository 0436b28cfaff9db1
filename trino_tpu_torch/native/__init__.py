"""Host C++ loops of the page plane, bound through ctypes.

Counterpart of trino_tpu/native/__init__.py: `pagesplit.cpp` (a copy of
the reference's) scatters a page's columns into per-partition buffers in
one pass and extracts a batch's live rows. The library is compiled with
g++ at first use into ``trino_tpu_torch/_build/libpagesplit.so``
(skipped while it is newer than its source), never next to the source.

Unlike the reference, a failed build raises: no entry point falls back
to numpy on its own. The numpy versions (`partition_scatter_numpy`,
`mask_compact_numpy`) are the plain versions the tests compare against,
and run only where a caller names them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "pagesplit.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIBRARY = os.path.join(BUILD_DIR, "libpagesplit.so")

_lock = threading.Lock()  # native._lock
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the library if it is stale; returns its path. Raises
    RuntimeError when g++ fails or is missing."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a per-process path, then publish atomically: another
    # process may be building the same library
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SOURCE],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build pagesplit.cpp: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on pagesplit.cpp ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def get_lib() -> ctypes.CDLL:
    """The built library with its three entry points bound."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.partition_counts.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.scatter_column.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.mask_gather.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p,
            ]
            lib.mask_gather.restype = ctypes.c_int64
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def partition_scatter(
    columns: List[np.ndarray], pids: np.ndarray, n_parts: int
) -> List[List[np.ndarray]]:
    """Split columns by per-row partition id in one pass per column.
    Returns [partition][column] arrays. pids: int32, -1 = drop."""
    lib = get_lib()
    pids = np.ascontiguousarray(pids, dtype=np.int32)
    n = len(pids)
    counts = np.zeros(n_parts, dtype=np.int64)
    lib.partition_counts(_ptr(pids), n, n_parts, _ptr(counts))
    scratch = np.zeros(n_parts, dtype=np.int64)
    outs: List[List[np.ndarray]] = [[] for _ in range(n_parts)]
    for col in columns:
        col = np.ascontiguousarray(col)
        item = col.dtype.itemsize * (col.shape[1] if col.ndim == 2 else 1)
        bufs = [np.empty((int(counts[p]),) + col.shape[1:], dtype=col.dtype)
                for p in range(n_parts)]
        ptrs = (ctypes.c_void_p * n_parts)(*[b.ctypes.data for b in bufs])
        lib.scatter_column(
            _ptr(col), item, _ptr(pids), n, n_parts,
            ctypes.cast(ptrs, ctypes.c_void_p), _ptr(scratch),
        )
        for p in range(n_parts):
            outs[p].append(bufs[p])
    return outs


def partition_scatter_numpy(
    columns: List[np.ndarray], pids: np.ndarray, n_parts: int
) -> List[List[np.ndarray]]:
    """The plain version of `partition_scatter`: one boolean mask per
    partition."""
    pids = np.asarray(pids, dtype=np.int32)
    return [[np.ascontiguousarray(c[pids == p]) for c in columns]
            for p in range(n_parts)]


def mask_compact(columns: List[np.ndarray], mask: np.ndarray) -> List[np.ndarray]:
    """Extract live rows from each column (Page.from_batch's inner
    loop); a 2-D column (long-decimal limb pairs) moves whole rows."""
    lib = get_lib()
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    n_live = int(mask.sum())
    out = []
    for col in columns:
        col = np.ascontiguousarray(col)
        item = col.dtype.itemsize * (col.shape[1] if col.ndim == 2 else 1)
        buf = np.empty((n_live,) + col.shape[1:], dtype=col.dtype)
        w = lib.mask_gather(_ptr(col), item, _ptr(mask), len(mask), _ptr(buf))
        assert w == n_live
        out.append(buf)
    return out


def mask_compact_numpy(columns: List[np.ndarray], mask: np.ndarray) -> List[np.ndarray]:
    """The plain version of `mask_compact`: one boolean index each."""
    m = np.asarray(mask).astype(bool)
    return [np.ascontiguousarray(c[m]) for c in columns]

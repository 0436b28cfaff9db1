"""Build the port's CUDA sources and bind them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc
for sm_90a into ``_build/lib<name>.so`` at first use (skipped while the
library is newer than its source). ``build_all`` starts one nvcc per
source at once. Nothing here runs when a module is imported: the CPU
tests import every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Dict, Iterable, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("grouped_sum", "window_rank", "gather")

# what `nvcc -Xptxas -v` said about each source built in this process
PTXAS_LOG: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# guards every wrapper's `launches` and `shapes`: a distributed query's
# tasks launch kernels from several threads at once
_count_lock = threading.Lock()


def count_launch(wrapper, shape) -> None:
    """One launch of `wrapper`'s kernel: add one to its `launches` and
    record `shape` in its `shapes`."""
    with _count_lock:
        wrapper.launches += 1
        wrapper.shapes.add(shape)


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _fresh(name: str) -> bool:
    lib = library_path(name)
    return os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(
        source_path(name))


def _start(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library_path(name)}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, source_path(name),
    ]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(name: str, tmp: str, proc) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}\n{err}")
    os.replace(tmp, library_path(name))
    PTXAS_LOG[name] = err


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source, all nvcc processes started together.
    Returns {name: library path}."""
    started = {n: _start(n) for n in names if not _fresh(n)}
    failures = []
    for n, (tmp, proc) in started.items():
        try:
            _finish(n, tmp, proc)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    return {n: library_path(n) for n in names}


def build(name: str) -> str:
    """Compile one source if it is stale; returns the library path."""
    return build_all([name])[name]


def load(name: str, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The built library with `functions` ({symbol: argtypes}) bound;
    each returns a cudaError_t as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for sym, argtypes in functions.items():
                fn = getattr(lib, sym)
                fn.restype = ctypes.c_int
                fn.argtypes = list(argtypes)
            _libs[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    import torch

    return torch.cuda.get_device_properties(dev).multi_processor_count


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


# ctypes argument kinds (pointers and the stream must be c_void_p, or
# ctypes passes them as 32-bit ints)
PTR = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong

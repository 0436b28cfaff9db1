"""Build the port's CUDA sources and bind them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc
for sm_90a into ``lib<name>.so`` at first use (skipped while the library
is newer than its source). ``build_all`` starts one nvcc per source at
once. Nothing here runs when a module is imported: the CPU tests import
every module on a machine with no nvcc.

The libraries live in the salted directory of
compile/cache.PersistentCompileCache
(``_build/torch<version>-cuda<version>-schema<rev>/``): the first build
of a process scrubs it and evicts past its bound, and each library is
written to a temporary file and renamed into place. A failed build
raises. Each successful build counts once in METRICS ``programs_built``
(compile/cache.py).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Dict, Iterable, Sequence

from trino_tpu_torch.analysis.witness import named_lock

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("grouped_sum", "window_rank", "gather")

# what `nvcc -Xptxas -v` said about each source built in this process
PTXAS_LOG: Dict[str, str] = {}  # guarded_by: _build_lock

_libs: Dict[str, ctypes.CDLL] = {}  # guarded_by: _lock
_lock = named_lock("cuda_build._lock")
# serializes builds (two threads would share one tmp path) and guards
# PTXAS_LOG; ordered after _lock, which load holds when it builds
_build_lock = named_lock("cuda_build._build_lock")
# guards every wrapper's `launches` and `shapes`: a distributed query's
# tasks launch kernels from several threads at once
_count_lock = named_lock("cuda_build._count_lock")


def count_launch(wrapper, shape) -> None:
    """One launch of `wrapper`'s kernel: add one to its `launches` and
    record `shape` in its `shapes`."""
    with _count_lock:
        wrapper.launches += 1
        wrapper.shapes.add(shape)


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def build_dir() -> str:
    """The salted library directory, prepared at the first call."""
    from trino_tpu_torch.compile.cache import kernel_cache

    return kernel_cache().ensure()


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _fresh(name: str) -> bool:
    lib = library_path(name)
    return os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(
        source_path(name))


def _start(name: str):
    tmp = f"{library_path(name)}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, source_path(name),
    ]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(name: str, tmp: str, proc) -> str:
    """Wait for one nvcc; returns what ptxas said."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}\n{err}")
    os.replace(tmp, library_path(name))
    from trino_tpu_torch.runtime.metrics import note_program_built

    note_program_built()
    return err


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source, all nvcc processes started together.
    Returns {name: library path}."""
    failures = []
    with _build_lock:
        started = {n: _start(n) for n in names if not _fresh(n)}
        for n, (tmp, proc) in started.items():
            try:
                PTXAS_LOG[n] = _finish(n, tmp, proc)
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
    # every launch asks for its library: once loaded, it is read without
    # the lock (the entry is stored once, whole, under it)
    lib = _libs.get(name)  # unguarded-ok: atomic read of an entry stored once
    if lib is not None:
        return lib
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

"""The program cache and the managed kernel-library directory.

Counterpart of trino_tpu/compile/cache.py. Two tiers, as there:

**ProgramCache** (in-process, cross-query). The planner binds one
filter/project closure per fused stage (expr/compile.py through
exec/operators.make_filter_project_fn). Identical SQL replanned later
(a retry, a restarted LocalQueryRunner in the same process) would bind
the same closure again; the cache keys each stage on its structure
(expression reprs plus the input schema with its dictionary values) and
returns the closure already bound, so a replanned stage skips the
binding. The port adds the device to every key: a bound closure may hold
tensors (dictionary maps, constants) on the device it was bound for, and
a mesh's shards and the CPU tests bind on other devices, so a closure
bound for one device is never served to another.

**PersistentCompileCache** (on disk, cross-process). What the port
persists is the kernel libraries that ops/cuda_build.py compiles with
nvcc: they live under a salted directory
(`<root>/torch<version>-cuda<version>-schema<rev>/`), so a torch or CUDA
upgrade or an engine schema-rev bump starts a fresh namespace. Each
library is written through a temporary file and a rename; at start the
cache scrubs zero-byte and orphaned temporary files (a build killed
mid-write must not poison its successors) and evicts by mtime past its
bound. A failed build still raises: the cache never makes a kernel
optional.

**The port's compile counter.** The reference counts XLA backend
compiles (`xla_compiles`). The port has no XLA; what it builds at run
time is (a) the programs the ProgramCache builds (a miss binds a
closure) and (b) the kernel libraries ops/cuda_build.py compiles. Their
sum in this process is METRICS `programs_built`, charged also to the
query whose thread built them (`programs_built_by_query.<id>`,
runtime/metrics.note_program_built). EXPLAIN ANALYZE prints the query's
share as `programs_built_this_query=`.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from trino_tpu_torch.analysis.witness import named_lock

# Bump when the engine's batch layout or a kernel's C interface changes
# in a way that invalidates built libraries (the salt below keys the
# persistent directory on it).
ENGINE_SCHEMA_REV = 1

# the salted directory's bound: past it the oldest libraries go first
KERNEL_CACHE_MAX_BYTES = 1 << 30


class ProgramCache:
    """Thread-safe LRU of structurally keyed programs (bound closures,
    mesh program records). The reverse map (program -> key, which the
    planner uses to key compositions of cached stages) is an id() side
    table."""

    def __init__(self, max_entries: int = 1024):
        self._max_entries = max_entries
        self._lock = named_lock("ProgramCache._lock")
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()  # guarded_by: _lock
        self._keys_by_id: Dict[int, Any] = {}  # guarded_by: _lock
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_create(self, key: Any, builder: Callable[[], Any]) -> Any:
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return fn
        # build outside the lock; racing builders are benign (first
        # insert wins, and only it counts as a build)
        fn = builder()
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self.hits += 1
                return existing
            self.misses += 1
            self._entries[key] = fn
            self._keys_by_id[id(fn)] = key
            while len(self._entries) > self._max_entries:
                _, old = self._entries.popitem(last=False)
                self._keys_by_id.pop(id(old), None)
                self.evictions += 1
        from trino_tpu_torch.runtime.metrics import note_program_built

        note_program_built()
        return fn

    def key_of(self, fn: Any) -> Optional[Any]:
        with self._lock:
            return self._keys_by_id.get(id(fn))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }

    def fingerprints(self) -> list:
        """repr of every cached key, in LRU order: the program half of a
        joining replica's warm manifest (runtime/fabric.py)."""
        with self._lock:
            return [repr(k) for k in self._entries]


# the process singleton the planner and the mesh runner use
PROGRAM_CACHE = ProgramCache()


def schema_cache_key(schema) -> Optional[tuple]:
    """Structural signature of a [(DataType, Dictionary|None)] schema,
    dictionary values included: two plans over equal-typed columns with
    different string dictionaries bind different constants. None
    (uncacheable) for a RuntimeDictionary, whose values exist only at
    execution time."""
    from trino_tpu_torch.block import Dictionary

    parts = []
    for typ, d in schema:
        if d is None:
            dk = None
        elif type(d) is Dictionary:
            dk = d.values
        else:
            return None
        parts.append((str(typ), dk))
    return tuple(parts)


def expr_fingerprint(*parts) -> Optional[str]:
    """Deterministic fingerprint from expression-IR reprs; None when a
    repr leaked an object address."""
    fp = repr(parts)
    if " object at 0x" in fp:
        return None
    return fp


def _metrics_increment(name: str, delta: float = 1.0) -> None:
    from trino_tpu_torch.runtime.metrics import METRICS

    METRICS.increment(name, delta)


def default_salt() -> str:
    """`torch<version>-cuda<version>-schema<rev>`: the namespace of the
    libraries one toolchain builds."""
    import torch

    return (f"torch{torch.__version__}-cuda{torch.version.cuda or 'none'}"
            f"-schema{ENGINE_SCHEMA_REV}")


class PersistentCompileCache:
    """The salted directory of built kernel libraries (module
    docstring). `root` defaults to trino_tpu_torch/_build."""

    def __init__(self, root: Optional[str] = None, max_bytes: Optional[int] = None,
                 salt: Optional[str] = None):
        if root is None:
            root = os.environ.get("TRINO_TPU_TORCH_KERNEL_CACHE") or os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
        self.root = root
        self.salt = salt or default_salt()
        self.dir = os.path.join(self.root, self.salt)
        self.max_bytes = KERNEL_CACHE_MAX_BYTES if max_bytes is None else max_bytes
        self.scrubbed = 0
        self.evicted = 0
        self._prepared = False
        self._lock = named_lock("PersistentCompileCache._lock")

    def _entries(self):
        """[(path, size, mtime)] of the regular files in the salt dir."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            p = os.path.join(self.dir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            if os.path.isfile(p):
                out.append((p, st.st_size, st.st_mtime))
        return out

    def scrub(self) -> int:
        """Drop zero-byte entries and orphaned temporary files (a writer
        killed before its rename leaves both)."""
        removed = 0
        for p, size, _ in self._entries():
            base = os.path.basename(p)
            if size == 0 or base.endswith(".tmp") or base.startswith("tmp"):
                try:
                    os.remove(p)
                    removed += 1
                except OSError:
                    pass
        self.scrubbed += removed
        if removed:
            _metrics_increment("compile_cache_scrubbed", removed)
        return removed

    def evict(self) -> int:
        """Oldest-mtime entries go first until the salt dir fits
        max_bytes."""
        entries = sorted(self._entries(), key=lambda e: e[2])
        total = sum(size for _, size, _ in entries)
        removed = 0
        for p, size, _ in entries:
            if total <= self.max_bytes:
                break
            try:
                os.remove(p)
            except OSError:
                continue
            total -= size
            removed += 1
        self.evicted += removed
        if removed:
            _metrics_increment("compile_cache_evictions", removed)
        return removed

    def prepare(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        self.scrub()
        self.evict()

    def ensure(self) -> str:
        """prepare() once per process; returns the salt dir."""
        with self._lock:
            if not self._prepared:
                self.prepare()
                self._prepared = True
        return self.dir

    def entry_count(self) -> int:
        return len(self._entries())

    def total_bytes(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def stats(self) -> Dict[str, Any]:
        return {
            "dir": self.dir,
            "entries": self.entry_count(),
            "bytes": self.total_bytes(),
            "max_bytes": self.max_bytes,
            "scrubbed": self.scrubbed,
            "evicted": self.evicted,
        }


# the kernel-library cache of this process, made by ops/cuda_build.py at
# its first build (None until then)
ACTIVE_PERSISTENT_CACHE: Optional[PersistentCompileCache] = None
_active_lock = named_lock("cache._active_lock")


def kernel_cache() -> PersistentCompileCache:
    """The process's kernel-library cache, made on first use."""
    global ACTIVE_PERSISTENT_CACHE
    with _active_lock:
        if ACTIVE_PERSISTENT_CACHE is None:
            ACTIVE_PERSISTENT_CACHE = PersistentCompileCache()
        return ACTIVE_PERSISTENT_CACHE

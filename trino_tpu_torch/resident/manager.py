"""Generation-guarded pin manager for device-resident warm state.

Counterpart of trino_tpu/resident/manager.py (host code, line for line
but for its locks and the typed pool calls below).

`TableGenerations` is the invalidation clock: the plan cache's single
`generation` store-guard (serving/plan_cache.py) made table-granular.
Every resident cache key embeds a generation snapshot of the tables it
was built from; a write bumps the table's counter, so stale entries
become unreachable by key — and `invalidate_table` evicts them eagerly
so their device memory is actually reclaimed, not just orphaned.

`ResidentStateManager` owns the pin budget. Pinned payloads are opaque
(the mesh prelude pins its exported pctx tuple; the fast lane pins
`ResidentTable`s); the manager tracks bytes, evicts LRU-first when a
pin would exceed the budget, and refuses gracefully (cold path, never
an error) when a single payload cannot fit. When attached to a
MemoryPool the pinned bytes are charged against the pool and registered
revocable, so a query under memory pressure reclaims pins BEFORE the
low-memory killer picks a victim — warm state is the cheapest thing in
the building to throw away. Pinned bytes are the device bytes of the
payload's tensors (ResidentTable.device_bytes).

Counters surface in /v1/metrics as
resident.{hits,misses,pins,evictions,revocations,compactions} plus the
resident_pinned_bytes gauge.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Tuple

from trino_tpu_torch.analysis.witness import named_lock, named_rlock


def table_key(catalog: str, schema: str, table: str) -> Tuple[str, str, str]:
    """Canonical (catalog, schema, table) key — case-folded like the
    analyzer's identifier resolution."""
    return (str(catalog).lower(), str(schema).lower(), str(table).lower())


class TableGenerations:
    """Per-table write counters plus a global epoch for wholesale
    events (COMMIT, catalog registration) that cannot name a table."""

    def __init__(self):
        self._lock = named_lock("TableGenerations._lock")
        self._gens: Dict[Tuple[str, str, str], int] = {}
        self._epoch = 0

    def get(self, key: Tuple[str, str, str]) -> Tuple[int, int]:
        with self._lock:
            return (self._epoch, self._gens.get(key, 0))

    def bump(self, key: Tuple[str, str, str]) -> Tuple[int, int]:
        with self._lock:
            self._gens[key] = self._gens.get(key, 0) + 1
            return (self._epoch, self._gens[key])

    def bump_all(self) -> None:
        with self._lock:
            self._epoch += 1

    def snapshot(self, keys) -> Tuple:
        """Hashable generation vector over a table set — the generation
        component of a resident cache key."""
        return tuple(sorted((k, self.get(k)) for k in set(keys)))


class _Entry:
    __slots__ = ("payload", "bytes", "tables", "index_key")

    def __init__(self, payload, bytes_, tables, index_key):
        self.payload = payload
        self.bytes = int(bytes_)
        self.tables: FrozenSet = frozenset(tables)
        self.index_key = index_key


class ResidentStateManager:
    """LRU pin store under a device-memory budget.

    Keys are opaque hashable tuples whose LAST component is a
    `TableGenerations.snapshot(...)` of the entry's source tables;
    `index_key` (optional) is a generation-free alias so a consumer can
    find "the current pinned entry for this logical object" without
    recomputing build-time key components (dtype sig, capacity rung)."""

    def __init__(self, budget_bytes: int = 64 << 20):
        self._lock = named_rlock("ResidentStateManager._lock")
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._index: Dict[Tuple, Tuple] = {}
        self._pinned_bytes = 0
        self._pool = None
        self._pool_cid: Optional[int] = None
        # bytes actually reserved in the CURRENT pool — may lag
        # _pinned_bytes when pins predate the attach or a re-charge was
        # refused; frees clamp to it so the pool ledger never goes
        # negative
        self._pool_charged = 0
        self.hits = 0
        self.misses = 0
        self.pins = 0
        self.pin_rejects = 0
        self.evictions = 0
        self.revocations = 0
        self.compactions = 0
        self._gauge_registered = False

    # -- configuration -------------------------------------------------
    def configure(self, budget_bytes: int) -> None:
        with self._lock:
            self.budget_bytes = int(budget_bytes)
            while self._pinned_bytes > self.budget_bytes and self._entries:
                self._evict_lru()

    def attach_pool(self, pool) -> None:
        """Charge pins against a MemoryPool and register them revocable:
        pool.reserve under pressure calls back into `_revoke`, freeing
        every pin before the exhaustion handler considers killing a
        query."""
        with self._lock:
            self.detach_pool()
            self._pool = pool
            self._pool_cid = pool.register_revocable(self._revoke)
            # best-effort charge of pre-existing pins; a refusal leaves
            # them uncharged (the revocable registration is what the
            # killer needs either way)
            if self._pinned_bytes and pool.try_reserve(
                self._pinned_bytes, query_id="resident"
            ):
                self._pool_charged = self._pinned_bytes
            pool.set_revocable(self._pool_cid, self._pinned_bytes)

    def release_pool(self, pool) -> None:
        """Detach `pool` if it is the one attached: the query that owns
        it has ended, so no later pin is charged to it."""
        with self._lock:
            if self._pool is pool:
                self.detach_pool()

    def detach_pool(self) -> None:
        with self._lock:
            if self._pool is not None and self._pool_cid is not None:
                self._pool.unregister_revocable(self._pool_cid)
                if self._pool_charged:
                    self._pool.free(self._pool_charged, query_id="resident")
            self._pool = None
            self._pool_cid = None
            self._pool_charged = 0

    def _pool_reserve(self, bytes_: int) -> bool:
        """Charge `bytes_` to the attached pool; True when charged (or
        no pool is attached)."""
        if self._pool is None or not bytes_:
            return True
        if self._pool.try_reserve(bytes_, query_id="resident"):
            self._pool_charged += bytes_
            return True
        return False

    def _pool_free(self, bytes_: int) -> None:
        give = min(int(bytes_), self._pool_charged)
        if self._pool is None or give <= 0:
            return
        self._pool.free(give, query_id="resident")
        self._pool_charged -= give

    def _register_gauge(self) -> None:
        if self._gauge_registered:
            return
        from trino_tpu_torch.runtime.metrics import METRICS

        METRICS.register_gauge(
            "resident_pinned_bytes", lambda: float(self._pinned_bytes)
        )
        METRICS.register_gauge(
            "resident_entries", lambda: float(len(self._entries))
        )
        self._gauge_registered = True

    # -- cache ops -----------------------------------------------------
    def lookup(self, key: Tuple):
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                METRICS.increment("resident.misses")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            METRICS.increment("resident.hits")
            return entry.payload

    def peek(self, key: Tuple):
        """Payload without hit/miss accounting or LRU touch (the write
        path inspecting candidates for delta absorption)."""
        with self._lock:
            entry = self._entries.get(key)
            return None if entry is None else entry.payload

    def note_miss(self) -> None:
        """Count a miss discovered before the full key exists (the fast
        lane's index lookup failed, so `lookup` was never called)."""
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            self.misses += 1
        METRICS.increment("resident.misses")

    def find(self, index_key: Tuple):
        """Resolve a generation-free alias to its live (key, payload);
        None when nothing is pinned under it."""
        with self._lock:
            key = self._index.get(index_key)
            if key is None:
                return None
            entry = self._entries.get(key)
            if entry is None:
                self._index.pop(index_key, None)
                return None
            return key, entry.payload

    def pin(self, key: Tuple, payload, bytes_: int, tables,
            index_key: Optional[Tuple] = None) -> bool:
        """Pin a payload, evicting LRU entries to fit. Returns False —
        the caller's cold path, never an error — when the payload alone
        exceeds the budget or the attached pool refuses the charge."""
        from trino_tpu_torch.runtime.metrics import METRICS

        bytes_ = int(bytes_)
        with self._lock:
            self._register_gauge()
            if bytes_ > self.budget_bytes:
                self.pin_rejects += 1
                METRICS.increment("resident.pin_rejects")
                return False
            if key in self._entries:
                self._evict(key)  # replace: release the old charge first
            while (
                self._pinned_bytes + bytes_ > self.budget_bytes
                and self._entries
            ):
                self._evict_lru()
            if not self._pool_reserve(bytes_):
                self.pin_rejects += 1
                METRICS.increment("resident.pin_rejects")
                return False
            entry = _Entry(payload, bytes_, tables, index_key)
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._pinned_bytes += bytes_
            if index_key is not None:
                self._index[index_key] = key
            self.pins += 1
            METRICS.increment("resident.pins")
            self._sync_pool_revocable()
            return True

    def rekey(self, old_key: Tuple, new_key: Tuple) -> bool:
        """Move an entry to a new key (the delta path: an append keeps
        the payload warm under the table's NEW generation)."""
        with self._lock:
            entry = self._entries.pop(old_key, None)
            if entry is None:
                return False
            self._entries[new_key] = entry
            self._entries.move_to_end(new_key)
            if entry.index_key is not None:
                self._index[entry.index_key] = new_key
            return True

    def set_bytes(self, key: Tuple, bytes_: int) -> None:
        """Re-charge an entry whose device footprint changed (delta
        growth, compaction)."""
        bytes_ = int(bytes_)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            delta = bytes_ - entry.bytes
            entry.bytes = bytes_
            self._pinned_bytes += delta
            if delta > 0:
                self._pool_reserve(delta)
            elif delta < 0:
                self._pool_free(-delta)
            while self._pinned_bytes > self.budget_bytes and len(self._entries) > 1:
                self._evict_lru()
            self._sync_pool_revocable()

    # -- invalidation --------------------------------------------------
    def invalidate_table(self, tkey: Tuple[str, str, str]) -> int:
        """Evict every entry built from this table (DML/DDL). Returns
        the eviction count."""
        with self._lock:
            victims = [
                k for k, e in self._entries.items() if tkey in e.tables
            ]
            for k in victims:
                self._evict(k)
            return len(victims)

    def entries_for_prefix(self, prefix: Tuple) -> List[Tuple]:
        """Live keys sharing a leading tuple prefix (stale-generation
        sweep: same logical object, any generation)."""
        n = len(prefix)
        with self._lock:
            return [
                k for k in self._entries
                if isinstance(k, tuple) and k[:n] == prefix
            ]

    def entries_for(self, tkey: Tuple[str, str, str]) -> List[Tuple]:
        with self._lock:
            return [
                k for k, e in self._entries.items() if tkey in e.tables
            ]

    def evict_all(self) -> None:
        with self._lock:
            while self._entries:
                self._evict_lru()

    def evict(self, key: Tuple) -> bool:
        with self._lock:
            if key not in self._entries:
                return False
            self._evict(key)
            return True

    # -- internals (lock held) -----------------------------------------
    def _evict(self, key: Tuple) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        entry = self._entries.pop(key)
        self._pinned_bytes -= entry.bytes
        if entry.index_key is not None and self._index.get(entry.index_key) == key:
            self._index.pop(entry.index_key, None)
        self._pool_free(entry.bytes)
        self.evictions += 1
        METRICS.increment("resident.evictions")
        self._sync_pool_revocable()

    def _evict_lru(self) -> None:
        key = next(iter(self._entries))
        self._evict(key)

    def _sync_pool_revocable(self) -> None:
        if self._pool is not None and self._pool_cid is not None:
            self._pool.set_revocable(self._pool_cid, self._pinned_bytes)

    def _revoke(self) -> None:
        """MemoryPool revocation callback: a query needs the bytes more
        than the warm state does. Drop every pin (counted separately
        from ordinary LRU evictions)."""
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            n = len(self._entries)
            while self._entries:
                self._evict_lru()
            if n:
                self.revocations += n
                METRICS.increment("resident.revocations", n)

    def note_compaction(self) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        with self._lock:
            self.compactions += 1
        METRICS.increment("resident.compactions")

    # -- observability -------------------------------------------------
    @property
    def pinned_bytes(self) -> int:
        return self._pinned_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "pinned_bytes": self._pinned_bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "pins": self.pins,
                "pin_rejects": self.pin_rejects,
                "evictions": self.evictions,
                "revocations": self.revocations,
                "compactions": self.compactions,
            }

    def reset_stats(self) -> None:
        """Test/corpus hook: zero the counters (entries stay pinned)."""
        with self._lock:
            self.hits = self.misses = self.pins = 0
            self.pin_rejects = self.evictions = 0
            self.revocations = self.compactions = 0


# Process singletons (the METRICS / PROGRAM_CACHE idiom): one clock and
# one pin budget per process, shared by every runner and the mesh plane.
GENERATIONS = TableGenerations()
RESIDENT = ResidentStateManager()

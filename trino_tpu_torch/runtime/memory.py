"""Memory accounting: pools, contexts, revocation.

Counterpart of trino_tpu/runtime/memory.py (LocalMemoryContext,
MemoryPool and the revocable-memory protocol: Operator.startMemoryRevoke,
MemoryRevokingScheduler). "User memory" is the device-resident state of
an operator (group tables, build sides, sort buffers); revoking moves it
to disk through the spiller (exec/spill.py).

Reservation is synchronous: it fits, triggers revocation of the largest
revocable contexts, or raises ExceededMemoryLimitError. Pools keep a
per-query ledger; on exhaustion, after revocation failed to make room,
an installed exhaustion handler (ClusterMemoryManager with its
LowMemoryKiller) may doom the query with the largest reservation.

`batch_bytes` counts the port batch's real device footprint: each
tensor's `nbytes`, the validity masks, the live mask and a nested
column's views and children. The port carries unsigned hashes in int64
with a mask where the reference keeps uint32, and its nested columns
carry `starts`, so the count may differ from the reference's for the
same batch: tests compare answers and that a spill happened, never byte
counts. Its locks carry the reference's witness names (analysis/).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from trino_tpu_torch.analysis.witness import named_lock


class ExceededMemoryLimitError(RuntimeError):
    pass


class MemoryPool:
    """A byte budget shared by all operators of a query/worker
    (main/memory/MemoryPool.java). Revocation targets registered
    revocable contexts largest-first until the reservation fits."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._reserved = 0
        self._lock = named_lock("MemoryPool._lock")
        # context id -> (revocable bytes, revoke callback)
        self._revocable: Dict[int, tuple] = {}
        self._next_id = 0
        # per-query ledger (query_id -> bytes) for the low-memory killer
        self._by_query: Dict[str, int] = {}
        # per-query high-water mark (never decremented; survives context
        # close so the final QueryInfo can report peak memory)
        self._query_peak: Dict[str, int] = {}
        # query_id -> kill message; doomed queries fail reservations
        self._doomed: Dict[str, str] = {}
        # ClusterMemoryManager hook: handler(pool, bytes_, query_id) ->
        # bool (True = a kill was issued, retry the reservation)
        self.exhaustion_handler = None

    @property
    def reserved_bytes(self) -> int:
        return self._reserved

    def free_bytes(self) -> int:
        return self.max_bytes - self._reserved

    def query_reservations(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_query)

    def query_reserved_bytes(self, query_id: str) -> int:
        """One query's live reservation in this pool (0 once every task
        memory context closed). The abandonment reaper's ledger check —
        a reaped query must drain to zero here, or its bytes poison the
        shared pool for every later query."""
        with self._lock:
            return self._by_query.get(query_id, 0)

    def doom_query(self, query_id: str, message: str) -> None:
        """Mark a query dead-on-next-reservation: its operator threads
        unwind with ExceededMemoryLimitError(message) at their next
        set_bytes, freeing their reservations on context close."""
        with self._lock:
            self._doomed[query_id] = message

    def _check_doomed(self, query_id: Optional[str]) -> None:
        if query_id is None:
            return
        with self._lock:
            msg = self._doomed.get(query_id)
        if msg is not None:
            raise ExceededMemoryLimitError(msg)

    def try_reserve(self, bytes_: int, query_id: Optional[str] = None) -> bool:
        with self._lock:
            if self._reserved + bytes_ > self.max_bytes:
                return False
            self._reserved += bytes_
            if query_id is not None:
                now = self._by_query.get(query_id, 0) + bytes_
                self._by_query[query_id] = now
                if now > self._query_peak.get(query_id, 0):
                    self._query_peak[query_id] = now
            return True

    def query_peak_bytes(self, query_id: str) -> int:
        """High-water mark of one query's reservation in this pool
        (retained after the query drains; pruned by drop_query_peak so
        the dict stays bounded across a long-lived worker)."""
        with self._lock:
            return self._query_peak.get(query_id, 0)

    def query_peaks(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._query_peak)

    def drop_query_peak(self, query_id: str) -> int:
        """Retire a completed query's watermark, returning it."""
        with self._lock:
            return self._query_peak.pop(query_id, 0)

    def reserve(self, bytes_: int, for_ctx: Optional[int] = None,
                query_id: Optional[str] = None) -> None:
        """Reserve, revoking others' revocable memory if needed
        (MemoryRevokingScheduler's revoke-largest-first policy). A victim
        whose callback does not actually lower its registered revocable
        bytes is skipped on later rounds — re-picking it would spin
        forever (a revoke can legitimately no-op, e.g. an operator whose
        state just became non-spillable)."""
        self._check_doomed(query_id)
        if self.try_reserve(bytes_, query_id):
            return
        # revoke largest revocable contexts until it fits
        unhelpful: set = set()
        while True:
            with self._lock:
                candidates = [
                    (cid, rb, cb)
                    for cid, (rb, cb) in self._revocable.items()
                    if rb > 0 and cid != for_ctx and cid not in unhelpful
                ]
            if not candidates:
                break
            cid, rb, cb = max(candidates, key=lambda t: t[1])
            cb()  # operator spills and releases its revocable bytes
            if self.try_reserve(bytes_, query_id):
                return
            with self._lock:
                rb_after = self._revocable.get(cid, (0, None))[0]
            if rb_after >= rb:
                unhelpful.add(cid)
        if self.try_reserve(bytes_, query_id):
            return
        # revocation could not make room: escalate to the cluster
        # manager (kill-largest), which may doom THIS query
        handler = self.exhaustion_handler
        if handler is not None and handler(self, bytes_, query_id):
            self._check_doomed(query_id)
            if self.try_reserve(bytes_, query_id):
                return
        raise ExceededMemoryLimitError(
            f"cannot reserve {bytes_} bytes "
            f"(reserved {self._reserved}/{self.max_bytes})"
        )

    def free(self, bytes_: int, query_id: Optional[str] = None) -> None:
        with self._lock:
            self._reserved -= bytes_
            assert self._reserved >= 0, "double free in memory pool"
            if query_id is not None:
                left = self._by_query.get(query_id, 0) - bytes_
                if left > 0:
                    self._by_query[query_id] = left
                else:
                    self._by_query.pop(query_id, None)

    # -- revocable registry --
    def register_revocable(self, revoke: Callable[[], None]) -> int:
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            self._revocable[cid] = (0, revoke)
            return cid

    def set_revocable(self, cid: int, bytes_: int) -> None:
        with self._lock:
            _, cb = self._revocable[cid]
            self._revocable[cid] = (bytes_, cb)

    def unregister_revocable(self, cid: int) -> None:
        with self._lock:
            self._revocable.pop(cid, None)


class MemoryContext:
    """Per-operator accounting handle (LocalMemoryContext analogue):
    setBytes semantics — the operator reports its current footprint and
    the delta hits the pool."""

    def __init__(self, pool: MemoryPool, revoke: Optional[Callable[[], None]] = None,
                 query_id: Optional[str] = None, spill_dir: Optional[str] = None):
        self.pool = pool
        self.query_id = query_id
        # where the operator's spill files go (None: the process's
        # temporary directory)
        self.spill_dir = spill_dir
        self._bytes = 0
        self._revocable_bytes = 0
        self._cid = (
            pool.register_revocable(revoke) if revoke is not None else None
        )

    def set_revoker(self, revoke: Callable[[], None]) -> None:
        """Late-bind the revoke callback (operators register themselves
        after construction — Operator.startMemoryRevoke wiring)."""
        assert self._cid is None, "revoker already set"
        self._cid = self.pool.register_revocable(revoke)

    @property
    def reserved_bytes(self) -> int:
        return self._bytes

    def set_bytes(self, bytes_: int) -> None:
        delta = bytes_ - self._bytes
        if delta > 0:
            self.pool.reserve(delta, for_ctx=self._cid, query_id=self.query_id)
        elif delta < 0:
            self.pool.free(-delta, query_id=self.query_id)
        self._bytes = bytes_

    def set_revocable_bytes(self, bytes_: int) -> None:
        """The portion of this context's footprint a revoke() can free
        (spillable state)."""
        assert self._cid is not None, "context registered without revoke"
        self._revocable_bytes = bytes_
        self.pool.set_revocable(self._cid, bytes_)

    def close(self) -> None:
        self.set_bytes(0)
        if self._cid is not None:
            self.pool.unregister_revocable(self._cid)


class LowMemoryKiller:
    """Victim-selection policy under cluster memory exhaustion: kill the
    query with the LARGEST total reservation across all pools (the
    reference's TotalReservationLowMemoryKiller — predictable, and the
    biggest query is the one whose death frees the most room). Ties
    break on query id for determinism."""

    def pick_victim(self, totals: Dict[str, int]) -> Optional[str]:
        if not totals:
            return None
        return max(totals.items(), key=lambda kv: (kv[1], kv[0]))[0]


class ClusterMemoryManager:
    """Coordinator-side memory arbiter (ClusterMemoryManager.java:103).

    Installed as the exhaustion_handler on every worker pool. When a
    reservation still cannot fit after revocation/spill, it aggregates
    the per-query ledgers across pools, picks ONE victim via the
    LowMemoryKiller, dooms it in every pool (so all its operator threads
    unwind with the kill message), tells the coordinator to fail the
    query, then waits a bounded time for the victim's frees before the
    requester retries. Only the victim dies; every other query — and the
    worker itself — keeps running."""

    def __init__(self, pools: List[MemoryPool], fail_query=None,
                 killer: Optional[LowMemoryKiller] = None,
                 wait_s: float = 5.0, poll_s: float = 0.01):
        self.pools = list(pools)
        self._fail_query = fail_query  # fail_query(query_id, message)
        self.killer = killer or LowMemoryKiller()
        self.wait_s = wait_s
        self.poll_s = poll_s
        self._lock = named_lock("ClusterMemoryManager._lock")
        self.kills: List[str] = []  # observability / chaos assertions

    def install(self) -> None:
        for p in self.pools:
            p.exhaustion_handler = self._on_exhaustion

    def cluster_reservations(self) -> Dict[str, int]:
        totals: Dict[str, int] = {}
        for p in self.pools:
            for q, b in p.query_reservations().items():
                totals[q] = totals.get(q, 0) + b
        return totals

    def _on_exhaustion(self, pool: MemoryPool, bytes_: int,
                       query_id: Optional[str]) -> bool:
        with self._lock:  # one kill decision at a time
            totals = self.cluster_reservations()
            victim = self.killer.pick_victim(totals)
            if victim is None:
                return False
            message = (
                f"Query {victim} killed by the low-memory killer: cluster "
                f"out of memory (victim held {totals[victim]} bytes, "
                f"request was {bytes_} bytes)"
            )
            for p in self.pools:
                p.doom_query(victim, message)
            self.kills.append(victim)
            if self._fail_query is not None:
                try:
                    self._fail_query(victim, message)
                except Exception:
                    pass  # the doom marks still unwind the victim
        if victim == query_id:
            return True  # requester IS the victim: retry raises the kill
        deadline = time.monotonic() + self.wait_s
        while time.monotonic() < deadline:
            if pool.free_bytes() >= bytes_:
                break
            time.sleep(self.poll_s)
        return True


def _column_bytes(c) -> int:
    total = c.data.nbytes + (c.valid.nbytes if c.valid is not None else 0)
    for attr in ("starts", "flat", "flat_keys", "flat_values"):
        part = getattr(c, attr, None)
        if part is not None:
            total += part.nbytes if attr == "starts" else _column_bytes(part)
    for kid in getattr(c, "children", None) or ():
        total += _column_bytes(kid)
    return total


def batch_bytes(batch) -> int:
    """Device footprint of a RelBatch: every column's tensors (data,
    validity, nested views and children) and the live mask. A nested
    column's flattened children count in full, also where a gather
    shares them with another batch."""
    total = batch.live.nbytes if batch.live is not None else 0
    for c in batch.columns:
        total += _column_bytes(c)
    return total

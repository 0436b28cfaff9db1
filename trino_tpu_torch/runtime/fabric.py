"""Multi-host replica fabric: checkpoint transport and the membership bridge.

Counterpart of trino_tpu/runtime/fabric.py. Mesh checkpoints are
host-portable (recovery/checkpoint.py `export_bytes` / `import_bytes`,
the device-free checkpoint key); this module carries them between
coordinator processes and decides who the siblings are:

- **checkpoint transport**: `CheckpointPusher` ships `export_bytes`
  payloads to peer coordinators over runtime/http.py's FabricServer and
  FabricClient, each call inside the RequestErrorTracker loop, with a
  sha256 digest checked before the receiver's generation-fenced
  `import_bytes`. Pushes ride a bounded queue drained by one thread:
  the chunk loop only enqueues, and a full queue sheds the push
  (`fabric.push_sheds`). Pulls run on demand at failover
  (`Fabric.try_pull`).
- **membership**: `MembershipDriver` listens to the NodeManager's
  state transitions (runtime/discovery.py) and drives
  `ReplicaManager.leave` / `.join` under the monotonic membership
  epoch; a resume whose target's epoch moved is refused with the typed
  `MembershipEpochError` and restarts fresh.
- **warm join**: a joining replica replays the peer's warm-class
  manifest (compile/warmup.py `warm_manifest` / `apply_manifest`) and
  the mesh WarmupEntry registry before it enters the placement pool.

Keys and payloads are pickled, as the reference pickles them, so the
same key and payload give the reference's bytes; both travel only
inside the internal-auth domain (a FabricServer refuses to listen
without the internal secret unless told it is single-process).

Unlike the reference, which drops any failed push or pull, a push or
pull declines only when the error tracker's budget is spent
(RequestFailedError) or the peer answers with an HTTP protocol error;
each decline is counted (`fabric.push_failures`, `fabric.pull_declines`).
Any other error of the push thread is kept and raised by `flush()` or
`stop()`, and any other error of a pull propagates to the failover.
A receive refuses a digest mismatch, an undecodable key (`KeyDecodeError`)
and undecodable bytes; nothing else. Counters surface through
/v1/metrics under `fabric.` and through the EXPLAIN ANALYZE
`membership=` line.
"""

from __future__ import annotations

import base64
import hashlib
import pickle
import queue
import time
import urllib.error
from typing import Callable, List, Optional, Tuple

from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.witness import named_lock

# /v1/metrics counter names (registered at zero by register_fabric_metrics)
PUSHES = "fabric.pushes"
PULLS = "fabric.pulls"
PUSH_SHEDS = "fabric.push_sheds"
DIGEST_REJECTS = "fabric.digest_rejects"
JOINS = "fabric.joins"
LEAVES = "fabric.leaves"
EPOCH_FENCES = "fabric.epoch_fences"
# the port's typed declines (not registered: they appear on first use)
PUSH_FAILURES = "fabric.push_failures"
PULL_DECLINES = "fabric.pull_declines"

_COUNTERS = (PUSHES, PULLS, PUSH_SHEDS, DIGEST_REJECTS, JOINS, LEAVES, EPOCH_FENCES)


def register_fabric_metrics() -> None:
    from trino_tpu_torch.runtime.metrics import METRICS

    for name in _COUNTERS:
        METRICS.increment(name, 0.0)


class MembershipEpochError(RuntimeError):
    """A resume targeted a replica whose membership epoch moved past the
    epoch its checkpoint context was taken under (the replica left and
    rejoined in between). Typed so the dispatcher discards the stale
    context and restarts fresh."""

    def __init__(self, message: str, replica_id: Optional[int] = None,
                 expected_epoch: Optional[int] = None, actual_epoch: Optional[int] = None):
        super().__init__(message)
        self.replica_id = replica_id
        self.expected_epoch = expected_epoch
        self.actual_epoch = actual_epoch


class KeyDecodeError(ValueError):
    """A fabric key that does not decode to a tuple."""


def _declinable(exc: BaseException) -> bool:
    """The errors a push or pull declines on: the error tracker's spent
    budget, or an HTTP protocol error answer from the peer."""
    from trino_tpu_torch.runtime.error_tracker import RequestFailedError

    return isinstance(exc, (RequestFailedError, urllib.error.HTTPError))


# -- wire helpers -----------------------------------------------------


def checkpoint_digest(data: bytes) -> str:
    """sha256 of a serialized checkpoint: a corrupt transfer is refused
    before import_bytes sees it."""
    return hashlib.sha256(data).hexdigest()


def encode_key(key: tuple) -> str:
    """URL-safe transport form of a checkpoint key (the reference's
    bytes: base64 of the pickled tuple)."""
    raw = pickle.dumps(key, protocol=pickle.HIGHEST_PROTOCOL)
    return base64.urlsafe_b64encode(raw).decode("ascii")


def decode_key(ekey: str) -> tuple:
    """The tuple `encode_key` made. TypeError when the bytes decode to
    something else (the reference's error); KeyDecodeError when they do
    not decode at all."""
    try:
        raw = base64.urlsafe_b64decode(ekey.encode("ascii"))
        key = pickle.loads(raw)
    except (ValueError, pickle.UnpicklingError, EOFError, AttributeError, ImportError,
            IndexError, KeyError, OverflowError) as e:
        raise KeyDecodeError(f"fabric key does not decode: {type(e).__name__}: {e}") from e
    if not isinstance(key, tuple):
        raise TypeError(f"fabric key decoded to {type(key).__name__}")
    return key


# -- endpoint logic (behind runtime/http.py FabricServer) -------------


class HostFabric:
    """One host's fabric endpoint state: the receive and serve logic
    behind the FabricServer routes, bound to a checkpoint store."""

    def __init__(self, store=None, host_id: str = ""):
        if store is None:
            from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

            store = CHECKPOINTS
        self.store = store
        self.host_id = host_id
        self.received = 0
        self.served = 0
        self.digest_rejects = 0
        register_fabric_metrics()

    def _reject(self, reason: str) -> dict:
        from trino_tpu_torch.runtime.metrics import METRICS

        self.digest_rejects += 1
        METRICS.increment(DIGEST_REJECTS)
        return {"imported": False, "reason": reason}

    def receive_checkpoint(self, ekey: str, data: bytes, digest: str) -> dict:
        """POST /v1/fabric/checkpoint: check the digest, decode the key,
        then land the bytes under the local generation check
        (import_bytes, which refuses undecodable bytes). A refusal leaves
        the store untouched."""
        if checkpoint_digest(data) != digest:
            return self._reject("digest_mismatch")
        try:
            key = decode_key(ekey)
        except (KeyDecodeError, TypeError):
            return self._reject("bad_key")
        # the sender's generation epoch is process-local: rebase it,
        # keeping the per-table write counters (import_bytes)
        ok = self.store.import_bytes(key, data, rebase_epoch=True)
        if ok:
            self.received += 1
        return {"imported": bool(ok)}

    def serve_checkpoint(self, ekey: str) -> Optional[Tuple[bytes, str]]:
        """POST /v1/fabric/checkpoint/pull: the live entry's bytes (via
        `get`, so a stale generation is never served) and digest, or
        None (404)."""
        key = decode_key(ekey)
        data = self.store.export_bytes(key)
        if data is None:
            return None
        self.served += 1
        return data, checkpoint_digest(data)

    def status(self) -> dict:
        return {
            "host_id": self.host_id,
            "entries": len(self.store),
            "received": self.received,
            "served": self.served,
            "digest_rejects": self.digest_rejects,
        }


# -- push side --------------------------------------------------------


class CheckpointPusher:
    """Bounded asynchronous push queue over a set of peer clients.

    The chunk loop's checkpoint hook calls `offer(key)`, which never
    blocks: a full queue sheds the push (the next boundary's snapshot
    supersedes it). The worker thread exports and sends on its own
    time. A push the error tracker gave up on, or that the peer refused
    with an HTTP error, is counted in `push_failures` and dropped; any
    other error stops the thread and is raised by flush() or stop()."""

    _STOP = object()

    def __init__(self, store, clients: List, depth: int = 8):
        self.store = store
        self.clients = list(clients)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._busy = 0  # guarded_by: _lock
        self._lock = named_lock("CheckpointPusher._lock")
        self.pushes = 0
        self.sheds = 0
        self.push_failures = 0
        self.error: Optional[BaseException] = None
        self._thread = threadreg.spawn(
            "trino-tpu-fabric-push", self._run, owner="CheckpointPusher"
        )

    def offer(self, key: tuple) -> bool:
        try:
            self._q.put_nowait(key)
            return True
        except queue.Full:
            from trino_tpu_torch.runtime.metrics import METRICS

            self.sheds += 1
            METRICS.increment(PUSH_SHEDS)
            return False

    def queued(self) -> int:
        with self._lock:
            return self._q.qsize() + self._busy

    def _raise_kept(self) -> None:
        if self.error is not None:
            raise self.error

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Wait until every enqueued push is done. True when drained;
        raises the push thread's kept error."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._raise_kept()
            if self.queued() == 0 or not self._thread.is_alive():
                self._raise_kept()
                return self.queued() == 0
            time.sleep(0.005)
        self._raise_kept()
        return self.queued() == 0

    def stop(self) -> None:
        if self._thread.is_alive():
            self._q.put(self._STOP)
            self._thread.join(timeout=2.0)
        self._raise_kept()

    def _run(self) -> None:
        while True:
            key = self._q.get()
            if key is self._STOP:
                return
            with self._lock:
                self._busy += 1
            try:
                self._push(key)
            except BaseException as e:  # kept, raised by flush()/stop()
                self.error = e
                return
            finally:
                with self._lock:
                    self._busy -= 1

    def _push(self, key: tuple) -> None:
        from trino_tpu_torch.runtime.metrics import METRICS

        data = self.store.export_bytes(key)
        if data is None:
            return  # completed or invalidated since the boundary
        digest = checkpoint_digest(data)
        for client in self.clients:
            try:
                client.push_checkpoint(key, data, digest=digest)
            except Exception as e:
                if not _declinable(e):
                    raise
                self.push_failures += 1
                METRICS.increment(PUSH_FAILURES)
                continue
            self.pushes += 1
            METRICS.increment(PUSHES)


# -- process attachment -----------------------------------------------


class Fabric:
    """One coordinator process's fabric attachment: the push queue over
    its peers plus pull on demand at failover."""

    def __init__(self, peer_uris: List[str], store=None,
                 internal_secret: Optional[str] = "__env__", queue_depth: int = 8,
                 max_error_duration_s: float = 5.0):
        from trino_tpu_torch.runtime.error_tracker import RetryPolicy
        from trino_tpu_torch.runtime.http import FabricClient

        if store is None:
            from trino_tpu_torch.recovery.checkpoint import CHECKPOINTS

            store = CHECKPOINTS
        self.store = store
        self.peer_uris = list(peer_uris)
        policy = RetryPolicy(max_error_duration_s=float(max_error_duration_s),
                             min_backoff_s=0.01, max_backoff_s=0.5)
        self.clients = [FabricClient(uri, internal_secret=internal_secret, retry_policy=policy)
                        for uri in self.peer_uris]
        self.pusher = CheckpointPusher(store, self.clients, depth=queue_depth)
        self.pull_declines = 0
        register_fabric_metrics()

    def push_hook(self) -> Callable[[tuple], None]:
        """The chunk loop's CHECKPOINT_PUSH_HOOK: enqueue only."""
        def hook(key: tuple) -> None:
            self.pusher.offer(key)

        return hook

    def try_pull(self, key: tuple) -> bool:
        """Ask each peer for `key`, check the digest, and land the first
        good payload under the local generation check. False when no
        peer has it or every peer declined (spent budget, HTTP error):
        the caller restarts cold."""
        from trino_tpu_torch.runtime.metrics import METRICS

        for client in self.clients:
            try:
                data, digest = client.pull_checkpoint(key)
            except Exception as e:
                if not _declinable(e):
                    raise
                self.pull_declines += 1
                METRICS.increment(PULL_DECLINES)
                continue
            if data is None:
                continue
            if digest and checkpoint_digest(data) != digest:
                METRICS.increment(DIGEST_REJECTS)
                continue
            if self.store.import_bytes(key, data, rebase_epoch=True):
                METRICS.increment(PULLS)
                return True
        return False

    def stop(self) -> None:
        self.pusher.stop()


# the process's active attachment (one coordinator, one fabric; set by
# maybe_start_fabric, like recovery.CHECKPOINTS)
_fabric_lock = named_lock("fabric._fabric_lock")
ACTIVE_FABRIC: Optional[Fabric] = None  # guarded_by: _fabric_lock


def active_fabric() -> Optional[Fabric]:
    return ACTIVE_FABRIC  # unguarded-ok: atomic reference read


def maybe_start_fabric(session, store=None) -> Optional[Fabric]:
    """Attach the fabric when `session.fabric_peers` names peers (and
    re-attach when the peer set changed), installing the chunk loop's
    checkpoint push hook. A session without peers leaves an existing
    attachment alone."""
    global ACTIVE_FABRIC
    peers = [p.strip() for p in str(getattr(session, "fabric_peers", "") or "").split(",")
             if p.strip()]
    if not peers:
        return ACTIVE_FABRIC  # unguarded-ok: atomic reference read
    with _fabric_lock:
        if ACTIVE_FABRIC is not None and ACTIVE_FABRIC.peer_uris == peers:
            return ACTIVE_FABRIC
        if ACTIVE_FABRIC is not None:
            ACTIVE_FABRIC.stop()
        fab = Fabric(
            peers, store=store,
            queue_depth=int(getattr(session, "fabric_queue_depth", 8) or 8),
            max_error_duration_s=float(
                getattr(session, "fabric_max_error_duration_s", 5.0) or 5.0))
        from trino_tpu_torch.parallel import mesh_chunk

        mesh_chunk.CHECKPOINT_PUSH_HOOK = fab.push_hook()
        ACTIVE_FABRIC = fab
        return fab


def stop_fabric() -> None:
    """Detach and stop the active fabric (raises its push thread's kept
    error, after detaching)."""
    global ACTIVE_FABRIC
    with _fabric_lock:
        if ACTIVE_FABRIC is None:
            return
        from trino_tpu_torch.parallel import mesh_chunk

        mesh_chunk.CHECKPOINT_PUSH_HOOK = None
        fab, ACTIVE_FABRIC = ACTIVE_FABRIC, None
    fab.stop()


def fabric_status() -> dict:
    """The /v1/fabric surface: the counters and the attachment."""
    from trino_tpu_torch.runtime.metrics import METRICS

    s = METRICS.snapshot()
    out = {name.split(".", 1)[1]: int(s.get(name, 0.0)) for name in _COUNTERS}
    fab = ACTIVE_FABRIC  # unguarded-ok: atomic reference read
    out["attached"] = fab is not None
    if fab is not None:
        out["peers"] = list(fab.peer_uris)
        out["queued"] = fab.pusher.queued()
        out["push_failures"] = fab.pusher.push_failures
    return out


# -- warm join --------------------------------------------------------


def warm_join_manifest() -> dict:
    """What a serving host hands a joining peer: the warm-class census
    and the program-cache key fingerprints."""
    from trino_tpu_torch.compile.cache import PROGRAM_CACHE
    from trino_tpu_torch.compile.warmup import warm_manifest

    return {"classes": warm_manifest(), "programs": PROGRAM_CACHE.fingerprints()}


def warm_join_replay(manifest: Optional[dict] = None, mode: str = "block",
                     timeout_s: float = 60.0) -> int:
    """Warm a joining replica before it enters the placement pool:
    register the peer manifest's warm classes, then replay the local
    mesh WarmupEntry registry. Returns the number of classes applied. A
    failed warm-up entry keeps its error in the entry (WarmupService);
    anything else propagates."""
    from trino_tpu_torch.compile.warmup import WarmupService, apply_manifest
    from trino_tpu_torch.parallel.mesh_chunk import mesh_warmup_entries

    applied = apply_manifest(manifest.get("classes", [])) if manifest else 0
    entries = mesh_warmup_entries()
    if entries:
        WarmupService(entries, mode=mode).start().wait(timeout_s)
    return applied


# -- membership bridge ------------------------------------------------


class MembershipDriver:
    """Node state transitions (NodeManager.add_state_listener) drive
    ReplicaManager.leave/join. `replica_of` maps a worker id to the
    replica it backs (None: not a replica host); `warm` runs before a
    rejoin enters the pool."""

    def __init__(self, node_manager, replica_manager,
                 replica_of: Optional[Callable[[str], Optional[int]]] = None,
                 warm: Optional[Callable[[], object]] = None):
        self.node_manager = node_manager
        self.replica_manager = replica_manager
        self.replica_of = replica_of or (lambda worker_id: None)
        self.warm = warm if warm is not None else warm_join_replay
        node_manager.add_state_listener(self._on_state)

    def _on_state(self, worker_id: str, old: str, new: str) -> None:
        rid = self.replica_of(worker_id)
        if rid is None:
            return
        if new in ("failed", "shutting_down", "drained") and old == "active":
            self.replica_manager.leave(rid)
        elif new == "active" and old != "active":
            self.replica_manager.join(rid, warm=self.warm)

"""Node discovery + heartbeat failure detection.

Analogue of DiscoveryNodeManager (main/metadata/DiscoveryNodeManager.java:70
— workers announce, coordinator tracks ACTIVE/SHUTTING_DOWN) and
HeartbeatFailureDetector (main/failuredetector/HeartbeatFailureDetector.java:78
— continuous pings with decay-based failure stats). SURVEY.md §5.3.

Collapsed to the engine's needs: a registry of worker handles, a
background pinger with an exponentially-decayed failure rate, and an
active-set the scheduler consults per scheduling pass (which is how
workers join/leave mid-stream in FTE mode).

Circuit breaking: every node also carries a CircuitBreaker fed by
request outcomes (the NodeManager implements the error-tracker listener
protocol, so HTTP clients and exchange pullers report into it). A node
whose breaker trips is graylisted — `schedulable_workers()` excludes it
so FTE re-placement and new launches avoid the node — while the
heartbeat ping keeps probing it; one successful probe closes the
breaker and returns the node to rotation.

Graceful drain (GracefulShutdownHandler + the SHUTTING_DOWN node state
driven end-to-end): `request_drain` marks a node shutting_down (new
launches stop targeting it immediately) and tells the worker to refuse
task creation; `drain(worker_id, timeout)` additionally waits until
every task on the node reached a terminal state — committed, or failed
and re-placed elsewhere — then marks it `drained` (decommissionable).
Spooled output on a draining node stays readable throughout.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class CircuitBreaker:
    """Per-node breaker: `trip_threshold` consecutive failures open it;
    while open the node is graylisted (excluded from scheduling) but
    still probed by the heartbeat loop. After `cooldown_s` the next
    probe half-opens the breaker; a success closes it, another failure
    re-opens it and restarts the cooldown."""

    def __init__(self, trip_threshold: int = 3, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[[], None]] = None):
        self.trip_threshold = trip_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.state = "closed"  # closed | open | half_open
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.trips = 0  # observability: how often this node graylisted
        # trip listener (replica plane counts breaker_opens through it);
        # fired on closed -> open only, never on half_open re-opens
        self._on_open = on_open

    @property
    def is_open(self) -> bool:
        return self.state in ("open", "half_open")

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == "half_open":
            self.state = "open"  # probe failed: restart the cooldown
            self.opened_at = self._clock()
        elif (
            self.state == "closed"
            and self.consecutive_failures >= self.trip_threshold
        ):
            self.state = "open"
            self.opened_at = self._clock()
            self.trips += 1
            if self._on_open is not None:
                try:
                    self._on_open()
                except Exception:
                    pass  # a listener must never mask the trip itself

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != "closed":
            self.state = "closed"
            self.opened_at = None

    def mark_probing(self) -> None:
        """Transition open -> half_open once the cooldown elapsed (the
        heartbeat calls this right before its probe ping)."""
        if (
            self.state == "open"
            and self._clock() - (self.opened_at or 0.0) >= self.cooldown_s
        ):
            self.state = "half_open"


class NodeState:
    def __init__(self, handle, breaker: Optional[CircuitBreaker] = None):
        self.handle = handle
        # lifecycle: active -> shutting_down (drain requested; running
        # tasks finishing, no new launches) -> drained (nothing left
        # running; the node can be decommissioned). `failed` is the
        # heartbeat detector's verdict and can recover to active.
        self.state = "active"  # active | shutting_down | drained | failed
        self.failure_rate = 0.0  # exponentially decayed
        self.last_seen = time.monotonic()
        self.breaker = breaker or CircuitBreaker()


class NodeManager:
    """Tracks workers; the heartbeat loop updates liveness. `handle` is
    anything with .worker_id and .status() (in-process Worker gets a
    trivial status)."""

    DECAY = 0.8  # per-ping decay of the failure rate
    FAIL_THRESHOLD = 0.6

    def __init__(self, ping_interval: float = 1.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0):
        self._nodes: Dict[str, NodeState] = {}
        self._lock = threading.Lock()  # NodeManager._lock
        self._interval = ping_interval
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # state-transition listeners fired from the heartbeat loop:
        # fn(worker_id, old_state, new_state). The membership bridge
        # (runtime/fabric.py MembershipDriver) drives replica
        # join/leave through these.
        self._state_listeners: List[Callable[[str, str, str], None]] = []

    def register(self, handle) -> None:
        with self._lock:
            self._nodes[handle.worker_id] = NodeState(
                handle,
                CircuitBreaker(
                    self._breaker_threshold, self._breaker_cooldown_s
                ),
            )

    def active_workers(self) -> List:
        with self._lock:
            return [
                n.handle
                for n in self._nodes.values()
                if n.state == "active"
            ]

    def schedulable_workers(self) -> List:
        """Active workers whose breaker is closed — the set FTE
        placement and new launches draw from. Graylisted (open/half-
        open) nodes stay out until a heartbeat probe succeeds."""
        with self._lock:
            return [
                n.handle
                for n in self._nodes.values()
                if n.state == "active" and not n.breaker.is_open
            ]

    def all_states(self) -> Dict[str, str]:
        with self._lock:
            return {k: n.state for k, n in self._nodes.items()}

    def breaker_states(self) -> Dict[str, str]:
        with self._lock:
            return {k: n.breaker.state for k, n in self._nodes.items()}

    # -- graceful drain (DiscoveryNodeManager SHUTTING_DOWN end-to-end) --
    def request_drain(self, worker_id: str) -> NodeState:
        """Start draining a worker: mark it SHUTTING_DOWN locally FIRST
        (placement stops targeting it before any network round trip),
        then tell the worker to refuse new launches. An unreachable
        worker still leaves rotation — that is the point of draining."""
        with self._lock:
            n = self._nodes.get(worker_id)
            if n is None:
                raise KeyError(f"unknown worker {worker_id}")
            if n.state not in ("shutting_down", "drained"):
                n.state = "shutting_down"
        try:
            n.handle.shutdown_gracefully()
        except Exception:
            pass
        return n

    def drain(self, worker_id: str, timeout_s: float = 30.0,
              poll_s: float = 0.02) -> bool:
        """Request a drain and wait until every task on the worker
        reached a terminal state (committed, or failed and re-placed by
        the scheduler onto other nodes). Returns True once the node is
        `drained`; False on timeout (the node stays `shutting_down` —
        still out of rotation, still serving its spooled output)."""
        n = self.request_drain(worker_id)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                st = n.handle.status()
                running = int(st.get("running", st.get("tasks", 0)))
                if running == 0:
                    n.state = "drained"
                    return True
            except Exception:
                pass  # unreachable mid-drain: keep waiting for timeout
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    # -- error-tracker listener protocol (destination == worker_id) --
    def report_failure(self, destination: str) -> None:
        with self._lock:
            n = self._nodes.get(destination)
        if n is not None:
            n.breaker.record_failure()

    def report_success(self, destination: str) -> None:
        with self._lock:
            n = self._nodes.get(destination)
        if n is not None:
            n.breaker.record_success()

    # -- heartbeat loop (HeartbeatFailureDetector.ping:350) --
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="heartbeat-detector", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.ping_once()

    def add_state_listener(
        self, fn: Callable[[str, str, str], None]
    ) -> None:
        """Register fn(worker_id, old_state, new_state), fired from the
        heartbeat loop on every node state transition. A listener error
        never stalls the ping loop."""
        self._state_listeners.append(fn)

    def _notify_state(self, worker_id: str, old: str, new: str) -> None:
        if old == new:
            return
        for fn in self._state_listeners:
            try:
                fn(worker_id, old, new)
            except Exception:
                pass  # membership bridges must not break failure detection

    def ping_once(self) -> None:
        with self._lock:
            nodes = list(self._nodes.values())
        for n in nodes:
            before = n.state
            n.breaker.mark_probing()
            try:
                status = n.handle.status()
                n.failure_rate *= self.DECAY
                n.last_seen = time.monotonic()
                n.breaker.record_success()
                reported = status.get("state", "active")
                running = int(status.get("running", status.get("tasks", 0)))
                if (
                    reported == "shutting_down"
                    or n.state in ("shutting_down", "drained")
                ):
                    # drain is one-way (locally-requested drains stick
                    # even before the worker acks); shutting_down
                    # settles to drained once nothing is running
                    n.state = "drained" if running == 0 else "shutting_down"
                elif n.state != "failed" or n.failure_rate < self.FAIL_THRESHOLD:
                    n.state = "active"
            except Exception:
                n.failure_rate = n.failure_rate * self.DECAY + (1 - self.DECAY)
                n.breaker.record_failure()
                if n.failure_rate >= self.FAIL_THRESHOLD:
                    n.state = "failed"
            self._notify_state(n.handle.worker_id, before, n.state)

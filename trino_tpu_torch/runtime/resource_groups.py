"""Resource groups: hierarchical admission control.

Counterpart of trino_tpu/runtime/resource_groups.py (host code only).
Analogue of main/execution/resourcegroups/ (InternalResourceGroupManager,
InternalResourceGroup with hard/soft concurrency + queue limits,
selector-based routing — SURVEY.md §2.3) and the file-based config
plugin (trino-resource-group-managers). Groups form a tree; a query is
admitted when every group on its path has a free concurrency slot.
Contending sibling groups share capacity by WEIGHTED FAIRNESS
(scheduling_weight, the WeightedFairQueue analogue realized as stride
scheduling: each admission advances the group's virtual pass by
1/weight and the smallest pass admits next; FIFO within a group). Selectors map (user, source) -> group path."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.analysis.witness import named_condition


class QueryQueueFullError(RuntimeError):
    pass


class QueryKilledWhileQueuedError(RuntimeError):
    """The query was killed (DELETE / client abandon) while waiting for
    admission: its ticket is withdrawn without ever counting as running."""


@dataclasses.dataclass
class ResourceGroupSpec:
    name: str
    max_concurrency: int = 10
    max_queued: int = 100
    # relative share under a contended parent (WeightedFairQueue's
    # per-entry weight; execution/resourcegroups/WeightedFairQueue.java)
    scheduling_weight: int = 1
    sub_groups: List["ResourceGroupSpec"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class Selector:
    """Routes queries to a group path; regexes over user/source."""

    group: Tuple[str, ...]
    user_pattern: Optional[str] = None
    source_pattern: Optional[str] = None

    def matches(self, user: str, source: str) -> bool:
        if self.user_pattern and not re.fullmatch(self.user_pattern, user):
            return False
        if self.source_pattern and not re.fullmatch(self.source_pattern, source):
            return False
        return True


@dataclasses.dataclass
class _Ticket:
    """One waiting admission request (FIFO sequence within a group)."""

    seq: int
    admitted: bool = False


class _Group:
    def __init__(self, spec: ResourceGroupSpec, parent: Optional["_Group"]):
        self.spec = spec
        self.parent = parent
        self.running = 0
        self.queued = 0
        # stride-scheduling virtual pass: each admission advances the
        # group by 1/weight; the smallest pass admits next. New or
        # long-idle groups REJOIN at the scheduler's current pass, so
        # history never starves active siblings
        self.vpass = 0.0
        self.waiters: List["_Ticket"] = []
        self.children: Dict[str, _Group] = {
            c.name: _Group(c, self) for c in spec.sub_groups
        }

    def path(self) -> str:
        parts = []
        g: Optional[_Group] = self
        while g is not None:
            parts.append(g.spec.name)
            g = g.parent
        return ".".join(reversed(parts))


class ResourceGroupManager:
    """Admission: acquire() blocks while the target group (or any
    ancestor) is at max_concurrency; raises QueryQueueFullError when the
    queue cap is hit (the dispatcher's resource-group submit path,
    DispatchManager.createQueryInternal:219)."""

    def __init__(self, root: ResourceGroupSpec, selectors: List[Selector] = ()):
        self._root = _Group(root, None)
        self._selectors = list(selectors)
        self._lock = named_condition("ResourceGroupManager._lock")
        self._next_seq = 0
        self._gpass = 0.0

    def _resolve(self, user: str, source: str) -> _Group:
        for s in self._selectors:
            if s.matches(user, source):
                g = self._root
                for name in s.group:
                    if name == self._root.spec.name:
                        continue
                    g = g.children[name]
                return g
        return self._root

    def _chain(self, g: _Group) -> List[_Group]:
        out = []
        while g is not None:
            out.append(g)
            g = g.parent
        return out

    def _schedule_locked(self) -> None:
        """Admit as many waiting tickets as capacity allows, in
        weighted-fair order: among groups with waiters, the smallest
        stride-scheduling pass goes first (WeightedFairQueue's pick
        rule); FIFO within a group."""
        while True:
            candidates = []

            def collect(g: _Group) -> None:
                if g.waiters:
                    candidates.append(g)
                for c in g.children.values():
                    collect(c)

            collect(self._root)
            admitted = False
            for g in sorted(
                candidates,
                key=lambda g: (g.vpass, g.waiters[0].seq),
            ):
                chain = self._chain(g)
                if all(
                    x.running < x.spec.max_concurrency for x in chain
                ):
                    t = g.waiters.pop(0)
                    for x in chain:
                        x.running += 1
                        x.queued -= 1
                    # stride advance; global pass trails the winner so
                    # newcomers rejoin here, not at zero
                    self._gpass = max(self._gpass, g.vpass)
                    g.vpass = self._gpass + 1.0 / max(
                        g.spec.scheduling_weight, 1
                    )
                    t.admitted = True
                    admitted = True
                    break
            if not admitted:
                return

    def acquire(self, user: str = "user", source: str = "",
                timeout: float = 60.0, cancelled=None):
        """Returns a lease token (the group) once admitted. `cancelled`
        (optional zero-arg callable) is polled while waiting: when it
        turns true the ticket is withdrawn — releasing the queue slot
        without EVER counting toward `running` — and
        QueryKilledWhileQueuedError is raised (the dispatcher's
        killed-while-queued path)."""
        import time as _time

        group = self._resolve(user, source)
        chain = self._chain(group)
        deadline = _time.monotonic() + timeout
        with self._lock:
            t = _Ticket(self._next_seq)
            self._next_seq += 1
            for g in chain:
                g.queued += 1
            if not group.waiters:
                # rejoin at the current pass: idle history is not a
                # credit (the starvation guard of stride scheduling)
                group.vpass = max(group.vpass, self._gpass)
            group.waiters.append(t)
            self._schedule_locked()
            if not t.admitted:
                # the queue cap counts WAITING queries only — a query
                # admitted on arrival never queued (every tree level
                # applies its own cap)
                for g in chain:
                    if g.queued > g.spec.max_queued:
                        group.waiters.remove(t)
                        for x in chain:
                            x.queued -= 1
                        raise QueryQueueFullError(
                            f"group {g.path()} queue is full "
                            f"({g.spec.max_queued})"
                        )
            self._lock.notify_all()
            was_cancelled = False
            try:
                while not t.admitted:
                    if cancelled is not None and cancelled():
                        was_cancelled = True
                        break
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        break
                    # chunked wait so a kill is noticed promptly even
                    # with a long admission timeout
                    self._lock.wait_for(
                        lambda: t.admitted,
                        timeout=remaining if cancelled is None
                        else min(remaining, 0.05),
                    )
            finally:
                if not t.admitted:
                    # timed out, killed, or interrupted: withdraw the
                    # ticket (queue slot released, `running` untouched)
                    if t in group.waiters:
                        group.waiters.remove(t)
                    for g in chain:
                        g.queued -= 1
            if t.admitted and cancelled is not None and cancelled():
                # killed in the admit-to-wakeup window: hand the slot
                # straight back so it cannot leak
                for g in chain:
                    g.running -= 1
                self._schedule_locked()
                self._lock.notify_all()
                was_cancelled = True
            if was_cancelled:
                raise QueryKilledWhileQueuedError(
                    f"query killed while queued in group {group.path()}"
                )
            if not t.admitted:
                raise QueryQueueFullError(
                    f"group {group.path()} admission timed out"
                )
        return group

    def release(self, group: _Group) -> None:
        with self._lock:
            for g in self._chain(group):
                g.running -= 1
            self._schedule_locked()
            self._lock.notify_all()

    def total_running(self) -> int:
        """Admitted-and-not-yet-released queries across the whole tree
        (the root's counter — every admission increments it). The
        abandonment reaper's post-condition: after a reaped query
        unwinds, this must drop back, or a slot leaked."""
        with self._lock:
            return self._root.running

    def stats(self) -> Dict[str, Tuple[int, int]]:
        """group path -> (running, queued)."""
        out: Dict[str, Tuple[int, int]] = {}

        def walk(g: _Group) -> None:
            out[g.path()] = (g.running, g.queued)
            for c in g.children.values():
                walk(c)

        with self._lock:
            walk(self._root)
        return out

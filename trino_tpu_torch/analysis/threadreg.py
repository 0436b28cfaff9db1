"""Thread sanitizer: a registry every background spawn site goes through.

The engine spawns ~19 kinds of background threads (warmup, fabric push,
watchdogs, heartbeat, query tracker, HTTP servers, exchange pull loops,
chaos populations, ...).  Spawning through :func:`spawn` gives each one
a stable name and an owner, so

* leaks become *named* failures: the tier-1 autouse fixture calls
  :func:`non_daemon_leaks` / :func:`live` after every module;
* :func:`join_all` gives services a uniform teardown with a deadline;
* the static pass (``analysis.shared_state``) flags any direct
  ``threading.Thread(...)`` call in the package that bypasses this
  module, keeping the inventory complete by construction.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["ThreadRegistry", "THREADS", "spawn"]


class _Record:
    __slots__ = ("ref", "name", "owner")

    def __init__(self, thread: threading.Thread, name: str, owner: str):
        self.ref = weakref.ref(thread)
        self.name = name
        self.owner = owner


class ThreadRegistry:
    """Named ownership for every background thread the engine spawns."""

    def __init__(self):
        # Deliberately a plain lock: the registry is a leaf the witness
        # itself may sit above, and it must work before analysis.witness
        # is configured.
        self._lock = threading.Lock()
        self._records: List[_Record] = []
        self.spawned_total = 0

    def spawn(self, name: str, target: Callable, *, args: Tuple = (),
              kwargs: Optional[dict] = None, daemon: bool = True,
              owner: str = "", start: bool = True) -> threading.Thread:
        t = threading.Thread(  # thread-ok: the registry is the one sanctioned spawn site
            target=target, name=name, args=args, kwargs=kwargs or {},
            daemon=daemon,
        )
        self.register(t, name=name, owner=owner)
        if start:
            t.start()
        return t

    def register(self, thread: threading.Thread, *, name: Optional[str] = None,
                 owner: str = "") -> threading.Thread:
        """Adopt an externally-created thread into the registry."""
        with self._lock:
            self._prune_locked()
            self._records.append(_Record(thread, name or thread.name, owner))
            self.spawned_total += 1
        return thread

    def adopt_current(self, *, owner: str = "") -> threading.Thread:
        """Register the calling thread (the initializer of a
        ThreadPoolExecutor, whose workers the pool itself starts)."""
        return self.register(threading.current_thread(), owner=owner)

    def _prune_locked(self) -> None:
        self._records = [
            r for r in self._records
            if r.ref() is not None and (r.ref().is_alive() or not r.ref().ident)
        ]

    def live(self) -> List[Tuple[str, str, bool]]:
        """(name, owner, daemon) for every registered thread still alive."""
        out = []
        with self._lock:
            for r in self._records:
                t = r.ref()
                if t is not None and t.is_alive():
                    out.append((r.name, r.owner, t.daemon))
        return out

    def live_count(self) -> int:
        return len(self.live())

    def non_daemon_leaks(self) -> List[str]:
        """Alive non-daemon threads other than main/pytest internals.

        Covers *all* threads, registered or not, so a spawn site that
        dodged the registry still shows up — just without an owner.
        """
        known: Dict[int, _Record] = {}
        with self._lock:
            for r in self._records:
                t = r.ref()
                if t is not None and t.ident is not None:
                    known[t.ident] = r
        leaks = []
        main = threading.main_thread()
        for t in threading.enumerate():
            if t is main or t.daemon or not t.is_alive():
                continue
            if t.__class__.__name__ == "_DummyThread":
                continue
            rec = known.get(t.ident)
            if rec is not None:
                leaks.append("%s (owner=%s)" % (rec.name, rec.owner or "?"))
            else:
                leaks.append("%s (UNREGISTERED)" % (t.name,))
        return leaks

    def join_all(self, timeout: float = 5.0, owner: Optional[str] = None) -> List[str]:
        """Join registered threads (optionally one owner's); returns the
        names of threads still alive at the deadline."""
        deadline = time.monotonic() + timeout
        stragglers = []
        with self._lock:
            records = list(self._records)
        for r in records:
            t = r.ref()
            if t is None or not t.is_alive():
                continue
            if owner is not None and r.owner != owner:
                continue
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                stragglers.append("%s (owner=%s)" % (r.name, r.owner or "?"))
        with self._lock:
            self._prune_locked()
        return stragglers


THREADS = ThreadRegistry()


def spawn(name: str, target: Callable, *, args: Tuple = (),
          kwargs: Optional[dict] = None, daemon: bool = True,
          owner: str = "", start: bool = True) -> threading.Thread:
    """Module-level convenience over the process registry."""
    return THREADS.spawn(name, target, args=args, kwargs=kwargs,
                         daemon=daemon, owner=owner, start=start)

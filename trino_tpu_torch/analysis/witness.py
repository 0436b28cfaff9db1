"""Runtime lock witness: named locks with dynamic order checking.

Every lock in the engine is created through :func:`named_lock`,
:func:`named_rlock` or :func:`named_condition` so it carries a stable
name ("MeshScheduler._lock", "warmup._warm_lock", ...).  When the
witness is enabled (env ``TRINO_TPU_TORCH_LOCK_WITNESS=1``, and by default
under pytest) each acquisition is checked against the partial order
observed so far, in the style of the FreeBSD WITNESS checker and the
lockdep family:

* the first time lock B is acquired while A is held, the edge A -> B is
  recorded together with both call sites;
* a later acquisition of A while B is held contradicts the recorded
  order and raises :class:`LockOrderError` naming both locks and both
  stacks;
* same-thread re-entry on a non-reentrant lock raises immediately
  instead of deadlocking silently.

The static pass (``analysis.lockgraph``) derives the same graph from
the source; :func:`seed_order` lets callers pre-load those edges so the
dynamic checker starts from the statically-derived partial order rather
than first-observation order.

When the witness is disabled the wrappers degrade to a flag check plus
owner bookkeeping (needed for ``Condition._is_owned``); no stacks are
captured and no edges are recorded.
"""

from __future__ import annotations

import os
import sys
import threading
import weakref
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "LockOrderError",
    "named_lock",
    "named_rlock",
    "named_condition",
    "witness_enabled",
    "enable_witness",
    "held_locks",
    "lock_count",
    "order_edge_count",
    "violation_count",
    "seed_order",
    "reset_witness_for_tests",
]


class LockOrderError(RuntimeError):
    """A lock acquisition contradicts the witnessed partial order.

    Carries the two lock names plus the call sites that established the
    conflicting order, so the report names both locks and both stacks.
    """

    def __init__(self, message: str, *, lock_a: str, lock_b: str,
                 stack_a: Tuple[str, ...] = (), stack_b: Tuple[str, ...] = ()):
        super().__init__(message)
        self.lock_a = lock_a
        self.lock_b = lock_b
        self.stack_a = stack_a
        self.stack_b = stack_b


def _default_enabled() -> bool:
    v = os.environ.get("TRINO_TPU_TORCH_LOCK_WITNESS")
    if v is not None:
        return v.strip().lower() not in ("", "0", "false", "no", "off")
    return "pytest" in sys.modules or "PYTEST_CURRENT_TEST" in os.environ


_ENABLED = _default_enabled()

# -- global witness state -------------------------------------------------
# _succ holds the observed partial order: name -> set of names acquired
# while it was held.  _edge_site remembers the (hold, acquire) call sites
# that first established each edge so violations can print both stacks.
_order_mu = threading.Lock()
_succ: Dict[str, Set[str]] = {}
_edge_site: Dict[Tuple[str, str], Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}
_violations = 0
_registry: "weakref.WeakSet" = weakref.WeakSet()

_tls = threading.local()
# ident -> the same list object stored in that thread's TLS, for the
# cross-thread held_locks() snapshot used by the leak fixture.
_all_held: Dict[int, List[Tuple[object, str, Tuple[str, ...]]]] = {}

_SELF_FILE = __file__
_THREADING_FILE = threading.__file__


def witness_enabled() -> bool:
    return _ENABLED


def enable_witness(on: bool = True) -> None:
    """Flip the witness at runtime (used by the chaos witness gate,
    runtime/chaos.run_mesh_case)."""
    global _ENABLED
    _ENABLED = bool(on)


def _held() -> List[Tuple[object, str, Tuple[str, ...]]]:
    try:
        return _tls.held
    except AttributeError:
        lst: List[Tuple[object, str, Tuple[str, ...]]] = []
        _tls.held = lst
        _all_held[threading.get_ident()] = lst  # unlocked-ok: thread-own key, GIL-atomic setitem
        return lst


def _callsite(limit: int = 3) -> Tuple[Tuple[str, int, str], ...]:
    """Cheap stack summary: up to `limit` frames outside witness/threading.

    Returns raw (filename, lineno, co_name) tuples — this runs on every
    enabled acquire, so string formatting is deferred to _site_str,
    which only runs when building an error message."""
    frames: List[Tuple[str, int, str]] = []
    f = sys._getframe(1)
    while f is not None and len(frames) < limit:
        code = f.f_code
        fn = code.co_filename
        if fn != _SELF_FILE and fn != _THREADING_FILE:
            frames.append((fn, f.f_lineno, code.co_name))
        f = f.f_back
    return tuple(frames)


def _site_str(site: Tuple) -> str:
    return " | ".join("%s:%d in %s" % frame for frame in site)


def _path_between(src: str, dst: str) -> Optional[List[str]]:
    """DFS over _succ; caller holds _order_mu."""
    if src == dst:
        return [src]
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _succ.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_violation() -> None:
    global _violations
    _violations += 1


def _check_order(acquiring_name: str, acq_site: Tuple[str, ...]) -> None:
    """Record edges held->acquiring; raise if the reverse order exists."""
    held = _held()
    if not held:
        return
    for _lk, hname, hsite in held:
        if hname == acquiring_name:
            # Distinct instances sharing a name (per-replica locks): no
            # instance-level order is defined, so skip; true re-entry on
            # the same instance is caught before this point.
            continue
        succ = _succ.get(hname)
        if succ is not None and acquiring_name in succ:
            continue  # edge already known, fast path
        with _order_mu:
            succ = _succ.get(hname)
            if succ is not None and acquiring_name in succ:
                continue
            rev = _path_between(acquiring_name, hname)
            if rev is not None:
                first_edge = (rev[0], rev[1]) if len(rev) > 1 else (rev[0], rev[0])
                prior = _edge_site.get(first_edge, ((), ()))
                _record_violation()
                raise LockOrderError(
                    "lock order violation: acquiring %r while holding %r, "
                    "but the reverse order %s was already witnessed\n"
                    "  held %r at: %s\n"
                    "  acquiring %r at: %s\n"
                    "  prior edge %s -> %s established holding at %s, "
                    "acquiring at %s"
                    % (
                        acquiring_name, hname, " -> ".join(rev),
                        hname, _site_str(hsite) or "<unknown>",
                        acquiring_name, _site_str(acq_site) or "<unknown>",
                        first_edge[0], first_edge[1],
                        _site_str(prior[0]) or "<static>",
                        _site_str(prior[1]) or "<static>",
                    ),
                    lock_a=hname, lock_b=acquiring_name,
                    stack_a=hsite, stack_b=acq_site,
                )
            _succ.setdefault(hname, set()).add(acquiring_name)
            _edge_site.setdefault((hname, acquiring_name), (hsite, acq_site))


class _WitnessLock:
    """Non-reentrant named lock; witness-checked when enabled."""

    reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()
        self._owner = 0
        _registry.add(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        site: Tuple[str, ...] = ()
        if _ENABLED and blocking:
            if self._owner == me:
                site = _callsite()
                _record_violation()
                raise LockOrderError(
                    "non-reentrant re-entry: thread %d already holds %r, "
                    "re-acquiring at: %s" % (me, self.name, _site_str(site)),
                    lock_a=self.name, lock_b=self.name,
                    stack_a=self._held_site(), stack_b=site,
                )
            site = _callsite()
            _check_order(self.name, site)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            if _ENABLED:
                _held().append((self, self.name, site))
        return ok

    def release(self) -> None:
        self._owner = 0
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _held_site(self) -> Tuple[str, ...]:
        for lk, _name, site in _held():
            if lk is self:
                return site
        return ()

    # threading.Condition protocol
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return "<WitnessLock %s owner=%d>" % (self.name, self._owner)


class _WitnessRLock:
    """Reentrant named lock; supports the Condition save/restore protocol."""

    reentrant = True

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.RLock()
        self._owner = 0
        self._count = 0
        _registry.add(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        first = self._owner != me
        site: Tuple[str, ...] = ()
        if _ENABLED and blocking and first:
            site = _callsite()
            _check_order(self.name, site)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if first:
                self._owner = me
                self._count = 1
                if _ENABLED:
                    _held().append((self, self.name, site))
            else:
                self._count += 1
        return ok

    def release(self) -> None:
        if self._owner == threading.get_ident():
            self._count -= 1
            if self._count <= 0:
                self._owner = 0
                self._count = 0
                self._drop_held()
        self._inner.release()

    def _drop_held(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break

    # threading.Condition protocol: wait() fully releases the recursion
    # and restores it on wake.
    def _release_save(self):
        count = self._count
        self._owner = 0
        self._count = 0
        self._drop_held()
        return (self._inner._release_save(), count)

    def _acquire_restore(self, saved) -> None:
        inner_state, count = saved
        self._inner._acquire_restore(inner_state)
        self._owner = threading.get_ident()
        self._count = count
        if _ENABLED:
            _held().append((self, self.name, _callsite()))

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return "<WitnessRLock %s owner=%d count=%d>" % (
            self.name, self._owner, self._count)


def named_lock(name: str) -> _WitnessLock:
    """A non-reentrant lock registered with the witness under `name`."""
    return _WitnessLock(name)


def named_rlock(name: str) -> _WitnessRLock:
    """A reentrant lock registered with the witness under `name`."""
    return _WitnessRLock(name)


def named_condition(name: str, lock=None) -> threading.Condition:
    """A Condition over a witness lock (reentrant when lock is omitted,
    matching threading.Condition's own default of RLock)."""
    return threading.Condition(lock if lock is not None else named_rlock(name))


# -- introspection --------------------------------------------------------

def held_locks() -> List[str]:
    """Names of all witness locks currently held by any thread."""
    out: List[str] = []
    for lst in list(_all_held.values()):
        out.extend(name for _lk, name, _site in list(lst))
    return out


def lock_count() -> int:
    return len(_registry)


def order_edge_count() -> int:
    with _order_mu:
        return sum(len(s) for s in _succ.values())


def violation_count() -> int:
    return _violations


def seed_order(edges: Iterable[Tuple[str, str]]) -> int:
    """Pre-load statically-derived order edges; returns edges added."""
    added = 0
    with _order_mu:
        for a, b in edges:
            if a == b:
                continue
            if _path_between(b, a) is not None:
                continue  # never seed a contradiction
            succ = _succ.setdefault(a, set())
            if b not in succ:
                succ.add(b)
                added += 1
    return added


def reset_witness_for_tests() -> None:
    """Clear the observed order and counters (unit tests only)."""
    global _violations
    with _order_mu:
        _succ.clear()
        _edge_site.clear()
    _violations = 0

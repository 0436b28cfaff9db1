"""Listener-driven state machine.

Analogue of io.airlift-style StateMachine (main/execution/
StateMachine.java:44 — SURVEY.md §2.3): a thread-safe typed state
holder with terminal-state latching, change listeners fired OUTSIDE the
lock (the reference dispatches on an executor for the same reason:
a listener calling back into the machine must not deadlock), and
`wait_for` used by pollers instead of busy loops.

Query/task lifecycles (runtime/task.py, runtime/server.py) hold one of
these; the event-listener surface (runtime/events.py) subscribes query
transitions through it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence


class StateMachine:
    def __init__(
        self,
        name: str,
        initial: str,
        terminal_states: Sequence[str] = (),
    ):
        self.name = name
        self._state = initial
        self._terminal = frozenset(terminal_states)
        self._listeners: List[Callable[[str], None]] = []
        self._lock = threading.Lock()  # StateMachine._lock
        self._changed = threading.Condition(self._lock)
        # serializes listener delivery so states arrive in transition
        # order; reentrant because a listener may transition the machine
        # from inside its callback
        self._dispatch = threading.RLock()  # StateMachine._dispatch

    def get(self) -> str:
        with self._lock:
            return self._state

    def is_terminal(self, state: Optional[str] = None) -> bool:
        s = self.get() if state is None else state
        return s in self._terminal

    def add_listener(self, fn: Callable[[str], None]) -> None:
        """fn(new_state) on every transition; fires immediately with the
        current state (fireOnceStateChangeListener semantics: a listener
        added after a transition still observes it). The dispatch lock
        spans the append + initial fire so a concurrent set() cannot
        deliver a NEWER state before the initial one (stale-last-state
        would wedge consumers waiting on a terminal state)."""
        with self._dispatch:
            with self._lock:
                self._listeners.append(fn)
                current = self._state
            fn(current)

    def set(self, new_state: str) -> bool:
        """Unconditional transition; returns False if already terminal
        (terminal states latch, StateMachine.setIf contract). The
        dispatch lock is held ACROSS transition + delivery so two
        concurrent set() calls cannot deliver their states to listeners
        out of transition order."""
        with self._dispatch:
            with self._lock:
                if self._state in self._terminal or new_state == self._state:
                    return False
                self._state = new_state
                listeners = list(self._listeners)
                self._changed.notify_all()
            for fn in listeners:
                fn(new_state)
        return True

    def compare_and_set(self, expected: str, new_state: str) -> bool:
        with self._dispatch:
            with self._lock:
                if self._state != expected or self._state in self._terminal:
                    return False
                self._state = new_state
                listeners = list(self._listeners)
                self._changed.notify_all()
            for fn in listeners:
                fn(new_state)
        return True

    def wait_for(
        self, predicate: Callable[[str], bool], timeout: Optional[float] = None
    ) -> str:
        """Block until predicate(state) or timeout; returns the state
        observed (StateMachine.waitForStateChange)."""
        with self._lock:
            if timeout is None:
                while not predicate(self._state):
                    self._changed.wait()
            else:
                deadline = time.monotonic() + timeout
                while not predicate(self._state):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._changed.wait(remaining):
                        break
            return self._state


# canonical lifecycles (QueryState / TaskState enums)
QUERY_STATES = (
    "queued", "planning", "running", "finishing", "finished", "failed",
)
QUERY_TERMINAL = ("finished", "failed")
TASK_STATES = ("planned", "running", "finished", "failed", "aborted")
TASK_TERMINAL = ("finished", "failed", "aborted")


def query_state_machine(query_id: str) -> StateMachine:
    return StateMachine(query_id, "queued", QUERY_TERMINAL)


def task_state_machine(task_id: str) -> StateMachine:
    return StateMachine(task_id, "planned", TASK_TERMINAL)

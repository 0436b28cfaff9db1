"""Concurrency soundness plane.

Counterpart of trino_tpu/analysis/. Three cooperating layers over the
port's ~65 named locks and ~19 background thread spawn sites:

* :mod:`trino_tpu_torch.analysis.lockgraph` — static AST pass: every lock
  acquisition site attributed to a named lock, the
  may-hold-while-acquiring graph across call edges, cycle findings with
  file:line witness paths.
* :mod:`trino_tpu_torch.analysis.shared_state` — static lint: unlocked
  mutable-global writes, the ``# guarded_by:`` field convention, and
  raw ``threading.Thread`` spawns that bypass the registry.
* :mod:`trino_tpu_torch.analysis.witness` / :mod:`~.threadreg` — the dynamic
  half: named-lock order witness (on under pytest) and the thread
  registry the leak fixture drains.

``chip_smoke.py``'s phase build runs the static passes as a gate;
:func:`analyze_package` is its engine and is also what
tests/test_torch_concurrency_analysis.py's clean-tree test asserts on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.analysis.lockgraph import (
    Finding, LockGraphResult, PACKAGE_ROOT, scan_sources,
)
from trino_tpu_torch.analysis.shared_state import scan_shared_state
from trino_tpu_torch.analysis.witness import (
    LockOrderError, enable_witness, held_locks, lock_count, named_condition,
    named_lock, named_rlock, order_edge_count, seed_order, violation_count,
    witness_enabled,
)
from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.threadreg import THREADS, spawn

__all__ = [
    "Finding", "LockOrderError", "AnalysisReport",
    "analyze_package", "analyze_sources",
    "named_lock", "named_rlock", "named_condition", "spawn", "THREADS",
    "witness_enabled", "enable_witness", "seed_order",
    "concurrency_summary", "register_analysis_metrics",
]

_VIOLATION_KINDS = (
    "lock-cycle", "lock-reentry", "wait-while-holding",
    "unlocked-global-write", "guarded-field", "unregistered-thread",
)


@dataclass
class AnalysisReport:
    """Combined result of the static passes."""

    graph: LockGraphResult
    findings: List[Finding] = field(default_factory=list)
    files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_kind(self) -> Dict[str, int]:
        out = {k: 0 for k in _VIOLATION_KINDS}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def summary(self) -> Dict[str, object]:
        kinds = self.by_kind()
        return {
            "files": self.files,
            "locks": len(self.graph.locks),
            "sites": self.graph.sites,
            "edges": len(self.graph.edges),
            "cycles": kinds["lock-cycle"],
            "reentry": kinds["lock-reentry"],
            "wait_while_holding": kinds["wait-while-holding"],
            "unlocked_global_writes": kinds["unlocked-global-write"],
            "guarded_field_violations": kinds["guarded-field"],
            "unregistered_threads": kinds["unregistered-thread"],
            "violations": len(self.findings),
            "ok": self.ok,
        }


def _package_sources(root: Optional[str] = None) -> Dict[str, Tuple[str, str]]:
    root = root or PACKAGE_ROOT
    pkg_parent = os.path.dirname(root)
    sources: Dict[str, Tuple[str, str]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, pkg_parent)
            dotted = rel[:-3].replace(os.sep, ".")
            if dotted.endswith(".__init__"):
                dotted = dotted[: -len(".__init__")]
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    text = fh.read()
            except OSError:
                continue
            sources[dotted] = (os.path.relpath(path, os.getcwd())
                               if path.startswith(os.getcwd()) else path, text)
    return sources


def analyze_sources(sources: Dict[str, Tuple[str, str]]) -> AnalysisReport:
    """Static passes over in-memory sources: dotted name -> (path, text)."""
    graph = scan_sources(sources)
    findings = list(graph.findings)
    findings.extend(scan_shared_state(graph))
    findings.sort(key=lambda f: (f.file, f.line, f.kind))
    return AnalysisReport(graph=graph, findings=findings, files=len(sources))


def analyze_package(root: Optional[str] = None) -> AnalysisReport:
    """Static passes over the installed package tree (or `root`)."""
    return analyze_sources(_package_sources(root))


# -- runtime inventory ----------------------------------------------------

def concurrency_summary() -> Dict[str, object]:
    """Live witness/thread inventory for metrics and EXPLAIN ANALYZE."""
    return {
        "locks": lock_count(),
        "held": len(held_locks()),
        "order_edges": order_edge_count(),
        "threads_live": THREADS.live_count(),
        "threads_spawned": THREADS.spawned_total,
        "witness": int(witness_enabled()),
        "witness_violations": violation_count(),
    }


def register_analysis_metrics(registry=None) -> None:
    """Expose analysis.{locks,threads_live,witness_violations} gauges."""
    if registry is None:
        from trino_tpu_torch.runtime.metrics import METRICS as registry
    registry.register_gauge("analysis.locks", lock_count)
    registry.register_gauge("analysis.threads_live", THREADS.live_count)
    registry.register_gauge("analysis.witness_violations", violation_count)

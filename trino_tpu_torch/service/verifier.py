"""Query verifier: replay a query set against two engines, compare.

Counterpart of trino_tpu/service/verifier.py (host code only).

service/trino-verifier analogue (4.6k LoC in the reference): runs each
query on a control and a test target, compares row sets (order-
insensitive unless the query has a top-level ORDER BY, with float
tolerance), and reports per-query verdicts — the tool the reference
uses to validate a new build against production."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence


@dataclasses.dataclass
class VerifierResult:
    name: str
    status: str  # "match" | "mismatch" | "control_error" | "test_error"
    control_seconds: float = 0.0
    test_seconds: float = 0.0
    detail: str = ""


def _normalize(rows: Sequence[Sequence], float_tol: float):
    out = []
    for row in rows:
        norm = []
        for v in row:
            if isinstance(v, float):
                if math.isnan(v):
                    norm.append("NaN")
                else:
                    # bucket to tolerance so sort keys agree across engines
                    norm.append(round(v, 6) if float_tol else v)
            else:
                norm.append(v)
        out.append(tuple(norm))
    return out


def _rows_equal(a, b, ordered: bool, float_tol: float) -> Optional[str]:
    if len(a) != len(b):
        return f"row count {len(a)} != {len(b)}"
    ka, kb = _normalize(a, float_tol), _normalize(b, float_tol)
    if not ordered:
        key = repr
        ka = sorted(ka, key=key)
        kb = sorted(kb, key=key)
    for i, (ra, rb) in enumerate(zip(ka, kb)):
        if len(ra) != len(rb):
            return f"row {i}: column count differs"
        for va, vb in zip(ra, rb):
            if isinstance(va, float) and isinstance(vb, float):
                if abs(va - vb) > float_tol * max(1.0, abs(va), abs(vb)):
                    return f"row {i}: {va!r} != {vb!r}"
            elif va != vb:
                return f"row {i}: {va!r} != {vb!r}"
    return None


def _has_top_level_order_by(sql: str) -> bool:
    """Row order is only deterministic with a TOP-LEVEL ORDER BY;
    'order by' in a subquery (or a string literal) does not count, so
    ask the parser rather than substring-matching."""
    try:
        from trino_tpu_torch.sql.parser import parse

        stmt = parse(sql)
        return bool(getattr(stmt, "order_by", ()))
    except Exception:
        return "order by" in sql.lower()  # non-engine dialects


class Verifier:
    """control/test are callables sql -> rows (e.g. runner.execute(...)
    adapted, or a dbapi cursor) so any engine pairing works."""

    def __init__(
        self,
        control: Callable[[str], Sequence[Sequence]],
        test: Callable[[str], Sequence[Sequence]],
        float_tol: float = 1e-6,
    ):
        self.control = control
        self.test = test
        self.float_tol = float_tol

    def verify(self, name: str, sql: str) -> VerifierResult:
        t0 = time.perf_counter()
        try:
            control_rows = self.control(sql)
        except Exception as ex:
            return VerifierResult(
                name, "control_error", detail=f"{type(ex).__name__}: {ex}"[:300]
            )
        t1 = time.perf_counter()
        try:
            test_rows = self.test(sql)
        except Exception as ex:
            return VerifierResult(
                name, "test_error", t1 - t0,
                detail=f"{type(ex).__name__}: {ex}"[:300],
            )
        t2 = time.perf_counter()
        diff = _rows_equal(
            control_rows, test_rows, _has_top_level_order_by(sql),
            self.float_tol,
        )
        return VerifierResult(
            name,
            "match" if diff is None else "mismatch",
            t1 - t0,
            t2 - t1,
            diff or "",
        )

    def verify_suite(self, queries: dict) -> List[VerifierResult]:
        return [self.verify(name, sql) for name, sql in queries.items()]


def runner_target(runner) -> Callable[[str], Sequence[Sequence]]:
    """Adapt a LocalQueryRunner/DistributedQueryRunner."""
    return lambda sql: runner.execute(sql).rows


def client_target(client) -> Callable[[str], Sequence[Sequence]]:
    """Adapt a trino_tpu_torch.client.Client (HTTP)."""
    return lambda sql: client.execute(sql).rows

"""Analyzer + logical planner: AST -> typed logical plan.

Plays the role of Trino's Analyzer/StatementAnalyzer + LogicalPlanner/
RelationPlanner/QueryPlanner (main/sql/analyzer/StatementAnalyzer.java:391,
main/sql/planner/LogicalPlanner.java:232 — SURVEY.md §2.1/2.2), fused
into one pass: name/type resolution happens while the plan is built, so
expressions come out as channel-indexed typed IR directly.

Capabilities mirrored from the reference that shape this file:
- implicit-join reordering: FROM lists + WHERE equi-conjuncts become a
  greedy hash-join tree with smaller side as build (the stats-lite
  stand-in for the CBO's join ordering, main/cost/).
- subquery planning: EXISTS/NOT EXISTS -> semi/anti joins with residual
  filters; IN (subquery) -> semi/anti joins; scalar subqueries ->
  cross join (uncorrelated) or group-by + left join (correlated equi
  pattern) — the TransformCorrelated* / TransformExistsApplyToCorrelatedJoin
  rule family (main/sql/planner/iterative/rule/).
- aggregation analysis: group keys + aggregate calls pre-projected to
  channels; SELECT/HAVING/ORDER BY rewritten over the aggregate output
  (AggregationAnalyzer analogue).

Known deviations (documented):
- decimal overflow past 38 digits yields NULL rows instead of Trino's
  NUMERIC_VALUE_OUT_OF_RANGE error (same deviation class as
  data-dependent division by zero — a deferred error-flag sideband is
  the planned fix). Int128 division is complete: divisors beyond int64
  run the 128/128 bit-serial kernel (ops/int128.divmod_u128_u128).
Formerly-deviant semantics now implemented faithfully: NULL-aware
NOT IN (filter + anti join + subquery-NULL-count guard), scalar
subqueries yielding NULL on zero rows and raising on >1
(EnforceSingleRowNode), decimal-typed division and avg, and (r4) the
full Trino decimal type algebra — precisions to 38 carried as Int128
limb pairs (ops/int128.py), DecimalOperators result typing for
+,-,*,/,%, sum -> decimal(38,s), HALF_UP rescales.
"""

from __future__ import annotations

import contextvars
import dataclasses
import datetime
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.spi import CatalogManager
from trino_tpu_torch.expr import ir
from trino_tpu_torch.ops.sort import SortKey
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql import plan as P

AGG_FUNCS = {"sum", "count", "avg", "min", "max", "any_value", "arbitrary"}
# Composite aggregates lowered onto the primitive (sum/count/min/max)
# machinery by _plan_aggregation: each expands to shared primitive
# accumulators plus a finisher expression over their outputs — the
# moral equivalent of Trino's multi-field accumulator states
# (main/operator/aggregation/, e.g. VarianceState), except the state
# fields ARE primitive aggregates so partial->final distribution and
# spill ride the existing wire format unchanged.
COMPOSITE_AGG_FUNCS = {
    "stddev", "stddev_samp", "stddev_pop",
    "variance", "var_samp", "var_pop",
    "skewness", "kurtosis",
    "geometric_mean", "count_if", "bool_and", "bool_or", "every",
    "corr", "covar_pop", "covar_samp", "regr_slope", "regr_intercept",
    # r4 breadth: the full regression family (DoubleRegressionAggregation)
    # plus entropy/checksum — all derivable from the same moment sums
    "regr_avgx", "regr_avgy", "regr_count", "regr_r2",
    "regr_sxx", "regr_sxy", "regr_syy",
    "entropy", "checksum",
}
# Holistic aggregates: need the raw rows (order statistics), so the
# fragmenter runs them single-step after a gather and the operator
# takes its collect path. Single source of truth for the kind set:
# exec/operators.HOLISTIC_KINDS (fragmenter gates on it too).
from trino_tpu_torch.exec.operators import HOLISTIC_KINDS as _HOLISTIC_KINDS

HOLISTIC_AGG_FUNCS = set(_HOLISTIC_KINDS) | {"string_agg", "merge"}
AGG_FUNCS = AGG_FUNCS | COMPOSITE_AGG_FUNCS | HOLISTIC_AGG_FUNCS

_EPOCH = datetime.date(1970, 1, 1)


class AnalysisError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Scopes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScopeField:
    qualifier: Optional[str]
    name: Optional[str]
    type: T.DataType


class Scope:
    """Channel-aligned name table for one plan node's output."""

    def __init__(self, fields: Sequence[ScopeField]):
        self.fields = list(fields)

    def __len__(self):
        return len(self.fields)

    def try_resolve(self, parts: Tuple[str, ...]) -> Optional[Tuple[int, T.DataType]]:
        if len(parts) == 1:
            qualifier, name = None, parts[0]
        elif len(parts) == 2:
            qualifier, name = parts
        else:
            return None
        hits = [
            (i, f.type)
            for i, f in enumerate(self.fields)
            if f.name == name and (qualifier is None or f.qualifier == qualifier)
        ]
        if len(hits) > 1:
            raise AnalysisError(f"column '{'.'.join(parts)}' is ambiguous")
        return hits[0] if hits else None

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[int, T.DataType]:
        hit = self.try_resolve(parts)
        if hit is None:
            raise AnalysisError(f"column '{'.'.join(parts)}' cannot be resolved")
        return hit

    @staticmethod
    def concat(a: "Scope", b: "Scope") -> "Scope":
        return Scope(a.fields + b.fields)


def _plan_fields(scope: Scope) -> Tuple[P.Field, ...]:
    return tuple(P.Field(f.name, f.type) for f in scope.fields)


# ---------------------------------------------------------------------------
# Expression conversion
# ---------------------------------------------------------------------------


def _number_literal(text: str) -> ir.Literal:
    if "e" in text.lower():
        return ir.Literal(float(text), T.DOUBLE)
    if "." in text:
        frac = text.split(".")[1]
        scale = len(frac)
        digits = len(text.replace(".", "").lstrip("0")) or 1
        if digits > 15:
            # float would corrupt digits beyond ~2^53; carry the exact
            # value (scale_decimal_value handles Decimal exactly)
            import decimal as _d

            return ir.Literal(
                _d.Decimal(text),
                T.decimal(min(max(digits, scale + 1), 38), scale),
            )
        return ir.Literal(float(text), T.decimal(max(digits, scale + 1), scale))
    v = int(text)
    if abs(v) > 2 ** 63 - 1:
        # beyond BIGINT: an exact decimal literal (Trino types big
        # integer literals DECIMAL(n, 0))
        return ir.Literal(v, T.decimal(min(len(str(abs(v))), 38), 0))
    return ir.Literal(v, T.BIGINT)


def _date_days(value: str) -> int:
    y, m, d = map(int, value.split("-"))
    return (datetime.date(y, m, d) - _EPOCH).days


def _shift_date(days: int, unit: str, n: int) -> int:
    d = _EPOCH + datetime.timedelta(days=days)
    if unit == "day":
        return days + n
    if unit == "month":
        m = d.month - 1 + n
        y = d.year + m // 12
        m = m % 12 + 1
        import calendar

        day = min(d.day, calendar.monthrange(y, m)[1])
        return (datetime.date(y, m, day) - _EPOCH).days
    if unit == "year":
        return _shift_date(days, "month", 12 * n)
    raise AnalysisError(f"unsupported interval unit {unit}")


_KEEP_KINDS = frozenset((
    T.TypeKind.TIMESTAMP, T.TypeKind.TIMESTAMP_TZ, T.TypeKind.INTERVAL_DAY,
    T.TypeKind.INTERVAL_YEAR, T.TypeKind.ARRAY, T.TypeKind.MAP, T.TypeKind.ROW))


def _choice_type(types: Sequence[T.DataType]) -> T.DataType:
    """The type of CASE, IF and COALESCE: one temporal or nested type
    throughout keeps that type (the reference falls through to BIGINT
    here: ROADMAP §3); anything else unifies as GREATEST and ARRAY do."""
    known = [t for t in types if t.kind != T.TypeKind.UNKNOWN]
    if known and known[0].kind in _KEEP_KINDS and all(t == known[0] for t in known):
        return known[0]
    return _unify_types(types)


def _unify_types(types: Sequence[T.DataType]) -> T.DataType:
    types = [t for t in types if t.kind != T.TypeKind.UNKNOWN]
    if not types:
        return T.UNKNOWN
    if any(t.is_string for t in types):
        return T.VARCHAR
    if any(t.is_floating for t in types):
        return T.DOUBLE
    if any(t.is_decimal for t in types):
        scale = max((t.scale or 0) for t in types if t.is_decimal)
        intd = max(
            (T._as_decimal_shape(t)[0] - T._as_decimal_shape(t)[1])
            for t in types
            if t.is_numeric
        )
        return T.decimal(min(intd + scale, T.MAX_DECIMAL_PRECISION), scale)
    if any(t.kind == T.TypeKind.DATE for t in types):
        return T.DATE
    if any(t.kind == T.TypeKind.BOOLEAN for t in types):
        return T.BOOLEAN
    return T.BIGINT


# Per-query session time zone (Session.timezone), read by literal
# parsing and zone-dependent cast rewrites. A contextvar keeps
# concurrent server queries isolated (Session.java getTimeZoneKey).
_SESSION_ZONE = contextvars.ContextVar("trino_tpu_session_zone", default="UTC")

# set when analysis folds a VOLATILE value (now()/current_date/...)
# into the plan — such plans must not enter the SQL-text plan cache
# (a cached `select now()` would return its first timestamp forever)
_VOLATILE_PLAN = contextvars.ContextVar("trino_tpu_volatile_plan", default=False)


def session_zone() -> str:
    return _SESSION_ZONE.get()


def set_session_zone(zone: str) -> None:
    _SESSION_ZONE.set(zone)


# catalog/schema/user for the parenless session pseudo-columns
# (CURRENT_CATALOG / CURRENT_SCHEMA / CURRENT_USER)
_SESSION_INFO = contextvars.ContextVar(
    "trino_tpu_session_info", default=("", "", "user")
)


def set_session_info(catalog: str, schema: str, user: str) -> None:
    _SESSION_INFO.set((catalog, schema, user))


def reset_volatile_plan() -> None:
    _VOLATILE_PLAN.set(False)


def mark_volatile_plan() -> None:
    _VOLATILE_PLAN.set(True)


def plan_is_volatile() -> bool:
    return _VOLATILE_PLAN.get()


# functions whose tstz argument reads the LOCAL wall clock in the
# value's own zone (extract-family + formatting; DateTimes.java)
_TSTZ_WALL_FNS = {
    "year", "month", "day", "hour", "minute", "second", "millisecond",
    "quarter", "week", "dow", "doy", "day_of_week", "day_of_year",
    "day_of_month", "year_of_week", "yow", "format_datetime",
    "date_format", "last_day_of_month", "to_iso8601",
}


def _arith_type(op: str, lt: T.DataType, rt: T.DataType) -> T.DataType:
    if lt.kind == T.TypeKind.DATE or rt.kind == T.TypeKind.DATE:
        return T.DATE
    if lt.is_floating or rt.is_floating:
        return T.DOUBLE
    if lt.is_decimal or rt.is_decimal:
        # Trino's exact decimal operator typing incl. Int128 results
        # (main/type/DecimalOperators.java longVariables)
        return T.decimal_arith_type(op, lt, rt)
    return T.BIGINT


class ExprConverter:
    """AST expression -> typed IR over one scope, honoring replacement
    channels installed by aggregation/subquery planning."""

    def __init__(
        self,
        scope: Scope,
        replacements: Optional[Dict[ast.Expression, Tuple[int, T.DataType]]] = None,
    ):
        self.scope = scope
        self.replacements = replacements or {}

    def convert(self, e: ast.Expression) -> ir.Expr:
        if e in self.replacements:
            ch, t = self.replacements[e]
            return ir.InputRef(ch, t)
        if isinstance(e, ast.Identifier):
            lam_scope = getattr(self, "_lambda_scope", None)
            if lam_scope and len(e.parts) == 1:
                lv = lam_scope.get(e.parts[0].lower())
                if lv is not None:
                    return lv
            hit = self.scope.try_resolve(e.parts)
            if hit is None and len(e.parts) >= 2:
                # ROW field access: resolve the prefix as a row-typed
                # column, the last part as its field (RowType dereference,
                # spi/type/RowType field access)
                base = self.scope.try_resolve(e.parts[:-1])
                if base is not None and base[1].is_row:
                    ch, rt = base
                    fname = e.parts[-1].lower()
                    for fi, (n, ft) in enumerate(rt.row_fields):
                        if n is not None and n.lower() == fname:
                            return ir.Call(
                                "row_field",
                                (ir.InputRef(ch, rt),
                                 ir.Literal(fi, T.BIGINT)),
                                ft,
                            )
                    raise AnalysisError(
                        f"row type has no field {e.parts[-1]!r}"
                    )
            if hit is None and len(e.parts) == 1:
                special = self._zero_arg_special(e.parts[0].lower())
                if special is not None:
                    return special
            ch, t = self.scope.resolve(e.parts)
            return ir.InputRef(ch, t)
        if isinstance(e, ast.Subscript):
            return self._convert_subscript(e)
        if isinstance(e, ast.NumberLiteral):
            return _number_literal(e.text)
        if isinstance(e, ast.StringLiteral):
            return ir.Literal(e.value, T.VARCHAR)
        if isinstance(e, ast.BooleanLiteral):
            return ir.Literal(e.value, T.BOOLEAN)
        if isinstance(e, ast.NullLiteral):
            return ir.Literal(None, T.UNKNOWN)
        if isinstance(e, ast.DateLiteral):
            return ir.Literal(_date_days(e.value), T.DATE)
        if isinstance(e, ast.TimestampLiteral):
            from trino_tpu_torch.expr.pyfns import iso_to_micros
            from trino_tpu_torch.ops import tz as TZ

            # a trailing zone name/offset makes the literal a TIMESTAMP
            # WITH TIME ZONE (parser/sql/tree/TimestampLiteral + the
            # DateTimes.java literal parse)
            if TZ.literal_has_zone(e.value):
                packed = TZ.parse_tstz(e.value, session_zone())
                if packed is None:
                    raise AnalysisError(f"invalid timestamp: {e.value!r}")
                return ir.Literal(packed, T.TIMESTAMP_TZ)
            micros = iso_to_micros(e.value)
            if micros is None:
                raise AnalysisError(f"invalid timestamp: {e.value!r}")
            return ir.Literal(micros, T.TIMESTAMP)
        if isinstance(e, ast.AtTimeZone):
            return self._convert_at_timezone(e)
        if isinstance(e, ast.IntervalLiteral):
            raise AnalysisError("intervals are only supported in date arithmetic")
        if isinstance(e, ast.BinaryOp):
            return self._convert_binary(e)
        if isinstance(e, ast.UnaryOp):
            if e.op == "not":
                return ir.not_(self.convert(e.operand))
            if e.op == "negate":
                a = self.convert(e.operand)
                if isinstance(a, ir.Literal) and a.value is not None:
                    return ir.Literal(-a.value, a.type)
                return ir.Call("negate", (a,), a.type)
        if isinstance(e, ast.IsNullPredicate):
            x = ir.is_null(self.convert(e.operand))
            return ir.not_(x) if e.negated else x
        if isinstance(e, ast.Between):
            v = self.convert(e.value)
            lo = self.convert(e.low)
            hi = self.convert(e.high)
            v1, lo = self._coerce_temporal_pair(v, lo)
            v2, hi = self._coerce_temporal_pair(v1, hi)
            x = ir.and_(
                ir.comparison("ge", v2, lo), ir.comparison("le", v2, hi)
            )
            return ir.not_(x) if e.negated else x
        if isinstance(e, ast.InList):
            v = self.convert(e.value)
            opts = []
            for o in e.options:
                lit = self.convert(o)
                if not isinstance(lit, ir.Literal):
                    raise AnalysisError("IN list items must be literals")
                opts.append(lit)
            # temporal coercion over the WHOLE list at once: lifting v
            # mid-loop would leave earlier options un-lifted
            TSTZ_K = T.TypeKind.TIMESTAMP_TZ
            if v.type.kind == TSTZ_K or any(
                o.type.kind == TSTZ_K for o in opts
            ):
                coerced = []
                for lit in opts:
                    v, lit = self._coerce_temporal_pair(v, lit)
                    coerced.append(lit)
                opts = []
                for lit in coerced:
                    v, lit = self._coerce_temporal_pair(v, lit)
                    if not isinstance(lit, ir.Literal):
                        raise AnalysisError(
                            "IN list items must be literals"
                        )
                    opts.append(lit)
            x: ir.Expr = ir.InList(v, tuple(opts))
            return ir.not_(x) if e.negated else x
        if isinstance(e, ast.Like):
            v = self.convert(e.value)
            pat = self.convert(e.pattern)
            if not isinstance(pat, ir.Literal):
                raise AnalysisError("LIKE pattern must be a literal")
            args = [v, pat]
            if e.escape is not None:
                esc = self.convert(e.escape)
                args.append(esc)
            x = ir.Call("like", tuple(args), T.BOOLEAN)
            return ir.not_(x) if e.negated else x
        if isinstance(e, ast.Case):
            return self._convert_case(e)
        if isinstance(e, ast.Cast):
            return self._convert_cast(e)
        if isinstance(e, ast.Extract):
            a = self.convert(e.operand)
            if a.type.kind == T.TypeKind.TIMESTAMP_TZ:
                if e.field in ("timezone_hour", "timezone_minute"):
                    return ir.Call(f"tstz_{e.field}", (a,), T.BIGINT)
                # civil fields read the LOCAL wall clock in the value's
                # own zone (DateTimes.java extract semantics)
                a = ir.Call("tstz_to_ts", (a,), T.TIMESTAMP)
            if e.field in ("year", "month", "day"):
                return ir.Call(f"extract_{e.field}", (a,), T.BIGINT)
            if e.field in ("hour", "minute", "second"):
                # time-of-day fields need a timestamp operand (Trino
                # rejects DATE here with a type error)
                if a.type.kind != T.TypeKind.TIMESTAMP:
                    raise AnalysisError(
                        f"cannot extract {e.field} from {a.type}"
                    )
                return ir.Call(e.field, (a,), T.BIGINT)
            canon = {"quarter": "quarter", "week": "week",
                     "dow": "day_of_week", "day_of_week": "day_of_week",
                     "doy": "day_of_year", "day_of_year": "day_of_year"}
            if e.field in canon:
                return ir.Call(canon[e.field], (a,), T.BIGINT)
            raise AnalysisError(f"extract({e.field}) not supported")
        if isinstance(e, ast.FunctionCall):
            return self._convert_call(e)
        if isinstance(e, ast.Lambda):
            raise AnalysisError(
                "lambda expressions are only valid as higher-order "
                "function arguments (transform, filter, ...)"
            )
        if isinstance(e, ast.ArrayLiteral):
            vals = _const_array_values(e)
            if vals is None:
                raise AnalysisError(
                    "ARRAY[...] literals must contain constants"
                )
            elems = [self.convert(x) for x in e.elements]
            elem_t = _unify_types([x.type for x in elems]) if elems else T.BIGINT
            return ir.Literal(
                tuple(x.value for x in elems), T.array_of(elem_t)
            )
        if isinstance(e, (ast.Exists, ast.InSubquery)):
            # mark-join replacements register under the non-negated twin
            plain = dataclasses.replace(e, negated=False)
            hit = self.replacements.get(plain)
            if hit is not None:
                x: ir.Expr = ir.InputRef(hit[0], T.BOOLEAN)
                return ir.not_(x) if e.negated else x
        if isinstance(e, (ast.Exists, ast.InSubquery, ast.ScalarSubquery)):
            raise AnalysisError(
                "subquery in unsupported position (only WHERE/HAVING conjuncts)"
            )
        raise AnalysisError(f"cannot analyze expression {e!r}")

    # -- binary --
    def _convert_binary(self, e: ast.BinaryOp) -> ir.Expr:
        op = e.op
        if op in ("and", "or"):
            return ir.Call(op, (self.convert(e.left), self.convert(e.right)), T.BOOLEAN)
        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            l, r = self._coerce_temporal_pair(
                self.convert(e.left), self.convert(e.right)
            )
            return ir.comparison(op, l, r)
        if op == "is_distinct":
            l, r = self._coerce_temporal_pair(
                self.convert(e.left), self.convert(e.right)
            )
            # NOT ((a=b, null-safe false) OR (a NULL AND b NULL)) — the
            # eq lane must be made definite (coalesce) so the result is
            # never NULL, matching Trino's IS DISTINCT FROM
            eq_definite = ir.Call(
                "coalesce",
                (ir.comparison("eq", l, r), ir.Literal(False, T.BOOLEAN)),
                T.BOOLEAN,
            )
            same = ir.or_(eq_definite, ir.and_(ir.is_null(l), ir.is_null(r)))
            return ir.not_(same)
        if op in ("add", "sub", "mul", "div", "mod"):
            # date +- interval
            if isinstance(e.right, ast.IntervalLiteral) and op in ("add", "sub"):
                return self._date_interval(e.left, e.right, op)
            l = self.convert(e.left)
            r = self.convert(e.right)
            out_t = _arith_type(op, l.type, r.type)
            return ir.Call(op, (l, r), out_t)
        raise AnalysisError(f"operator {op} not supported")

    def _date_interval(self, date_ast, interval: ast.IntervalLiteral, op) -> ir.Expr:
        n = int(interval.value) * interval.sign * (1 if op == "add" else -1)
        d = self.convert(date_ast)
        if isinstance(d, ir.Literal) and d.type.kind == T.TypeKind.DATE:
            return ir.Literal(_shift_date(d.value, interval.unit, n), T.DATE)
        if d.type.kind == T.TypeKind.TIMESTAMP_TZ:
            # fixed-duration shift on the INSTANT (zone bits untouched;
            # Trino adds exact millis for day-second intervals)
            unit_ms = {
                "day": 86_400_000, "hour": 3_600_000,
                "minute": 60_000, "second": 1_000,
            }.get(interval.unit)
            if unit_ms is None:
                raise AnalysisError(
                    "month/year intervals on timestamp with time zone "
                    "are not supported"
                )
            return ir.Call(
                "tstz_shift",
                (d, ir.Literal(n * unit_ms, T.BIGINT)),
                T.TIMESTAMP_TZ,
            )
        if interval.unit == "day":
            return ir.Call("add", (d, ir.Literal(n, T.DATE)), T.DATE)
        raise AnalysisError(
            "month/year interval arithmetic requires a constant date operand"
        )

    def _convert_case(self, e: ast.Case) -> ir.Expr:
        whens = list(e.whens)
        if e.operand is not None:
            conds = [
                self.convert(ast.BinaryOp("eq", e.operand, w.condition)) for w in whens
            ]
        else:
            conds = [self.convert(w.condition) for w in whens]
        results = [self.convert(w.result) for w in whens]
        default = self.convert(e.default) if e.default is not None else None
        out_t = _choice_type(
            [r.type for r in results] + ([default.type] if default is not None else [])
        )
        return ir.Case(tuple(conds), tuple(results), default, out_t)

    def _convert_cast(self, e: ast.Cast) -> ir.Expr:
        a = self.convert(e.operand)
        return self._cast_to(a, resolve_type(e.target))

    def _cast_to(self, a: ir.Expr, dst: T.DataType) -> ir.Expr:
        """Casts involving TIMESTAMP WITH TIME ZONE rewrite into calls
        carrying the session zone as a literal (the zone must be fixed
        at ANALYSIS time — Session.getTimeZoneKey — because bound
        expressions run on workers with no session)."""
        src = a.type
        TSTZ = T.TypeKind.TIMESTAMP_TZ
        if dst.kind == TSTZ and src.kind != TSTZ:
            from trino_tpu_torch.ops import tz as TZ

            sz = ir.Literal(TZ.zone_id(session_zone()), T.INTEGER)
            if src.kind == T.TypeKind.TIMESTAMP:
                return ir.Call("ts_to_tstz", (a, sz), T.TIMESTAMP_TZ)
            if src.kind == T.TypeKind.DATE:
                ts = ir.Cast(a, T.TIMESTAMP)
                return ir.Call("ts_to_tstz", (ts, sz), T.TIMESTAMP_TZ)
            if src.is_string or src.kind == T.TypeKind.UNKNOWN:
                return ir.Call("parse_tstz", (a, sz), T.TIMESTAMP_TZ)
            raise AnalysisError(
                f"cannot cast {src} to timestamp with time zone"
            )
        if src.kind == TSTZ and dst.kind != TSTZ:
            if dst.kind == T.TypeKind.TIMESTAMP:
                return ir.Call("tstz_to_ts", (a,), T.TIMESTAMP)
            if dst.kind == T.TypeKind.DATE:
                return ir.Cast(
                    ir.Call("tstz_to_ts", (a,), T.TIMESTAMP), T.DATE
                )
            if dst.is_string:
                # constant folding in the binder (_format_cast_text);
                # column-valued follows the timestamp->varchar limit
                return ir.Cast(a, dst)
            raise AnalysisError(
                f"cannot cast timestamp with time zone to {dst}"
            )
        return ir.Cast(a, dst)

    def _coerce_temporal_pair(self, l: ir.Expr, r: ir.Expr):
        """Mixed TIMESTAMP/DATE vs TIMESTAMP WITH TIME ZONE comparison:
        the zone-less side coerces to tstz at the session zone (the
        implicit coercion Trino's type system inserts) — raw int64
        compare of micros against the packed encoding would be silent
        garbage."""
        TSTZ = T.TypeKind.TIMESTAMP_TZ
        plain = (T.TypeKind.TIMESTAMP, T.TypeKind.DATE)

        def lift(x: ir.Expr) -> ir.Expr:
            if isinstance(x, ir.Literal):
                # fold at analysis time so IN-list items stay literals
                if x.value is None:
                    return ir.Literal(None, T.TIMESTAMP_TZ)
                from trino_tpu_torch.ops import tz as TZ

                micros = int(x.value)
                if x.type.kind == T.TypeKind.DATE:
                    micros = micros * 86_400_000_000
                zid = TZ.zone_id(session_zone())
                wall_ms = micros // 1000
                off1 = TZ.offset_millis_py(zid, wall_ms)
                off2 = TZ.offset_millis_py(zid, wall_ms - off1)
                return ir.Literal(
                    TZ.pack_py(wall_ms - off2, zid), T.TIMESTAMP_TZ
                )
            if x.type.kind == T.TypeKind.DATE:
                x = ir.Cast(x, T.TIMESTAMP)
            return self._cast_to(x, T.TIMESTAMP_TZ)

        if l.type.kind == TSTZ and r.type.kind in plain:
            return l, lift(r)
        if r.type.kind == TSTZ and l.type.kind in plain:
            return lift(l), r
        return l, r

    def _zero_arg_special(self, name: str) -> Optional[ir.Expr]:
        """Parenless standard temporal pseudo-columns (SqlBase.g4
        specialDateTimeFunction): CURRENT_TIMESTAMP / CURRENT_DATE /
        LOCALTIMESTAMP / CURRENT_TIMEZONE, all at the session zone."""
        import time as _time

        from trino_tpu_torch.ops import tz as TZ

        if name == "current_timestamp":
            mark_volatile_plan()
            return ir.Literal(
                TZ.pack_py(
                    int(_time.time() * 1000), TZ.zone_id(session_zone())
                ),
                T.TIMESTAMP_TZ,
            )
        if name in ("current_date", "localtimestamp"):
            mark_volatile_plan()
            zid = TZ.zone_id(session_zone())
            now_ms = int(_time.time() * 1000)
            wall_ms = now_ms + TZ.offset_millis_py(zid, now_ms)
            if name == "localtimestamp":
                return ir.Literal(wall_ms * 1000, T.TIMESTAMP)
            return ir.Literal(wall_ms // 86_400_000, T.DATE)
        if name == "current_timezone":
            mark_volatile_plan()
            return ir.Literal(session_zone(), T.VARCHAR)
        if name in ("current_catalog", "current_schema", "current_user"):
            # session-dependent folds: the plan cache key carries no
            # identity/zone, so these plans must not be cached
            mark_volatile_plan()
            cat, sch, usr = _SESSION_INFO.get()
            v = {"current_catalog": cat, "current_schema": sch,
                 "current_user": usr}[name]
            return ir.Literal(v, T.VARCHAR)
        return None

    def _convert_at_timezone(self, e: "ast.AtTimeZone") -> ir.Expr:
        from trino_tpu_torch.ops import tz as TZ

        a = self.convert(e.operand)
        z = self.convert(e.zone)
        if not (
            isinstance(z, ir.Literal) and z.type.is_string
            and z.value is not None
        ):
            raise AnalysisError("AT TIME ZONE requires a constant zone")
        try:
            zid = TZ.zone_id(str(z.value))
        except ValueError as ex:
            raise AnalysisError(str(ex))
        if a.type.kind == T.TypeKind.TIMESTAMP:
            a = self._cast_to(a, T.TIMESTAMP_TZ)
        if a.type.kind != T.TypeKind.TIMESTAMP_TZ:
            raise AnalysisError("AT TIME ZONE requires a timestamp operand")
        return ir.Call(
            "at_timezone_id", (a, ir.Literal(zid, T.INTEGER)), T.TIMESTAMP_TZ
        )

    # higher-order (lambda-taking) functions: (collection positions,
    # lambda position, param-type derivation) — ArrayFunctions /
    # MapTransformValuesFunction analogues
    _LAMBDA_FUNCS = {
        "transform", "filter", "any_match", "all_match", "none_match",
        "transform_values", "transform_keys", "map_filter",
    }

    def _convert_breadth_call(self, name, e) -> Optional[ir.Expr]:
        """r4 breadth: session-fixed zero-arg functions, cast shorthands,
        desugarings, and constant folds for string-producing functions of
        non-string inputs (the engine's varchar columns are dictionary
        codes, so a per-row numeric->string projection has no vectorized
        carrier; constants fold here, columns get a clean AnalysisError).
        Reference seats: DateTimeFunctions.java (now/current_timezone),
        MathFunctions.java (to_base/random), ColorFunctions.java,
        StringFunctions.java:162 (concat_ws)."""
        import datetime as _dt

        def _arity(lo, hi=None):
            n = len(e.args)
            hi_ = lo if hi is None else hi
            if not lo <= n <= hi_:
                want = str(lo) if hi_ == lo else f"{lo}..{hi_}"
                raise AnalysisError(
                    f"{name}() expects {want} arguments, got {n}"
                )

        def _need_const(args, which=None):
            vals = []
            for i, a in enumerate(args):
                c = self.convert(a)
                if which is not None and i not in which:
                    vals.append(c)
                    continue
                if not isinstance(c, ir.Literal):
                    raise AnalysisError(
                        f"{name}(): argument {i + 1} must be a constant"
                        " (column-valued inputs have no varchar carrier)"
                    )
                vals.append(c)
            return vals

        if name == "now":
            import time as _time

            from trino_tpu_torch.ops import tz as TZ

            if e.args:
                raise AnalysisError("now() takes no arguments")
            # now()/current_timestamp: TIMESTAMP WITH TIME ZONE at the
            # session zone (DateTimeFunctions.java currentTimestamp)
            mark_volatile_plan()
            return ir.Literal(
                TZ.pack_py(
                    int(_time.time() * 1000), TZ.zone_id(session_zone())
                ),
                T.TIMESTAMP_TZ,
            )
        if name == "current_timezone":
            return ir.Literal(session_zone(), T.VARCHAR)
        if name in ("with_timezone", "at_timezone"):
            from trino_tpu_torch.ops import tz as TZ

            if len(e.args) != 2:
                raise AnalysisError(f"{name}() takes two arguments")
            a = self.convert(e.args[0])
            z = self.convert(e.args[1])
            if not (isinstance(z, ir.Literal) and z.value is not None):
                raise AnalysisError(f"{name}() zone must be a constant")
            try:
                zid = TZ.zone_id(str(z.value))
            except ValueError as ex:
                raise AnalysisError(str(ex))
            if name == "with_timezone":
                # wall time reinterpreted IN the given zone
                if a.type.kind != T.TypeKind.TIMESTAMP:
                    raise AnalysisError("with_timezone() takes a timestamp")
                return ir.Call(
                    "ts_to_tstz", (a, ir.Literal(zid, T.INTEGER)),
                    T.TIMESTAMP_TZ,
                )
            # at_timezone: same instant, displayed in the given zone
            if a.type.kind == T.TypeKind.TIMESTAMP:
                a = self._cast_to(a, T.TIMESTAMP_TZ)
            if a.type.kind != T.TypeKind.TIMESTAMP_TZ:
                raise AnalysisError("at_timezone() takes a timestamp")
            return ir.Call(
                "at_timezone_id", (a, ir.Literal(zid, T.INTEGER)),
                T.TIMESTAMP_TZ,
            )
        if name == "uuid":
            import uuid as _uuid

            mark_volatile_plan()
            return ir.Literal(str(_uuid.uuid4()), T.VARCHAR)
        if name == "version":
            return ir.Literal("trino_tpu_torch 0.4", T.VARCHAR)
        if name == "date":
            if len(e.args) != 1:
                raise AnalysisError("date() takes one argument")
            a = self.convert(e.args[0])
            if isinstance(a, ir.Literal) and a.type.is_string:
                if a.value is None:
                    return ir.Literal(None, T.DATE)
                try:
                    return ir.Literal(_date_days(str(a.value)), T.DATE)
                except ValueError:
                    raise AnalysisError(f"invalid date: {a.value!r}")
            return ir.Cast(a, T.DATE)
        if name in ("rand", "random"):
            args = tuple(self.convert(a) for a in e.args)
            if len(args) > 2:
                raise AnalysisError("rand() takes at most two arguments")
            return ir.Call(
                "rand", args, T.DOUBLE if not args else T.BIGINT
            )
        if name in ("regexp_split", "regexp_extract_all"):
            # validate the constant pattern/group at ANALYSIS time and
            # fall through to the registry for typing (the from_base
            # discipline: no raw re.error/IndexError mid-bind)
            import re as _re

            if len(e.args) >= 2:
                pat = self.convert(e.args[1])
                if isinstance(pat, ir.Literal) and pat.value is not None:
                    try:
                        rx = _re.compile(str(pat.value))
                    except _re.error as ex:
                        raise AnalysisError(f"{name}(): invalid pattern"
                                            f" ({ex})")
                    if name == "regexp_extract_all" and len(e.args) > 2:
                        gl = self.convert(e.args[2])
                        if isinstance(gl, ir.Literal) and \
                                gl.value is not None and \
                                not 0 <= int(gl.value) <= rx.groups:
                            raise AnalysisError(
                                f"{name}(): pattern has {rx.groups}"
                                f" groups, got group {gl.value}"
                            )
            return None
        if name == "from_base":
            # validate the constant radix HERE (analysis time) and fall
            # through to the registry for typing — the binder twin's
            # check would surface as a raw ValueError mid-execution
            if len(e.args) == 2:
                r = self.convert(e.args[1])
                if isinstance(r, ir.Literal) and r.value is not None \
                        and not 2 <= int(r.value) <= 36:
                    raise AnalysisError(
                        "from_base() radix must be in [2, 36]"
                    )
            return None
        if name in ("reverse", "concat") and e.args:
            # array overloads fold for constant arrays; non-array
            # arguments fall through to the varchar paths below
            arrs = [_const_array_values(a) for a in e.args]
            if arrs[0] is not None and (name == "reverse" or all(
                x is not None for x in arrs
            )):
                if name == "reverse":
                    if len(e.args) != 1:
                        return None
                    vals = [v.value for v in arrs[0]]
                    t = _array_element_type(arrs[0])
                    return ir.Literal(tuple(reversed(vals)), T.array_of(t))
                # unify element types ACROSS arguments: mixed-type
                # concat must fail at analysis, not corrupt the literal
                flat = [v for xs in arrs for v in xs]
                t = _array_element_type(flat) if flat else T.BIGINT
                return ir.Literal(
                    tuple(v.value for v in flat), T.array_of(t)
                )
            return None
        if name in ("date_format", "to_char", "format_datetime"):
            # constant fold only: per-row timestamp->string projection
            # has no varchar carrier (same rule as to_iso8601)
            import datetime as _dt

            if len(e.args) != 2:
                raise AnalysisError(f"{name}() takes two arguments")
            vals = _need_const(e.args)
            a, fmt = vals
            if a.value is None or fmt.value is None:
                return ir.Literal(None, T.VARCHAR)
            if a.type.kind == T.TypeKind.DATE:
                dt = _dt.datetime(1970, 1, 1) + _dt.timedelta(
                    days=int(a.value)
                )
            elif a.type.kind == T.TypeKind.TIMESTAMP:
                dt = _dt.datetime(1970, 1, 1) + _dt.timedelta(
                    microseconds=int(a.value)
                )
            elif a.type.kind == T.TypeKind.TIMESTAMP_TZ:
                # format the LOCAL wall clock in the value's own zone
                from trino_tpu_torch.ops import tz as TZ

                ms = int(a.value) >> TZ.MILLIS_SHIFT
                off = TZ.offset_millis_py(
                    int(a.value) & TZ.ZONE_MASK, ms
                )
                dt = _dt.datetime(1970, 1, 1) + _dt.timedelta(
                    milliseconds=ms + off
                )
            else:
                raise AnalysisError(f"{name}() takes a date or timestamp")
            if name == "date_format":
                # MySQL tokens (date_parse's inverse). ONLY the tokens
                # that map 1:1 onto strftime are accepted — %M/%W/%c and
                # friends mean different things in MySQL and strftime,
                # so passing them through would silently format wrong
                ok = {"Y": "%Y", "y": "%y", "m": "%m", "d": "%d",
                      "H": "%H", "h": "%I", "i": "%M", "s": "%S",
                      "p": "%p", "j": "%j", "a": "%a", "b": "%b",
                      "%": "%%"}
                src, out, i = str(fmt.value), [], 0
                while i < len(src):
                    if src[i] == "%":
                        tok = src[i + 1] if i + 1 < len(src) else ""
                        if tok not in ok:
                            raise AnalysisError(
                                f"date_format(): unsupported token %{tok}"
                            )
                        out.append(ok[tok])
                        i += 2
                    else:
                        out.append(src[i])
                        i += 1
                py = "".join(out)
            elif name == "format_datetime":
                from trino_tpu_torch.expr.pyfns import joda_to_strptime

                py = joda_to_strptime(str(fmt.value))
            else:
                from trino_tpu_torch.expr.pyfns import oracle_to_strptime

                py = oracle_to_strptime(str(fmt.value))
            return ir.Literal(dt.strftime(py), T.VARCHAR)
        if name == "empty_approx_set":
            from trino_tpu_torch.expr.pyfns import hll_merge

            if e.args:
                raise AnalysisError("empty_approx_set() takes no arguments")
            return ir.Literal(hll_merge([]), T.VARCHAR)
        if name == "format":
            if len(e.args) < 2:
                raise AnalysisError("format() needs a format + values")
            vals = _need_const(e.args)
            fmt = vals[0]
            if not fmt.type.is_string:
                raise AnalysisError("format() format must be a string")
            if fmt.value is None:
                return ir.Literal(None, T.VARCHAR)
            txt = str(fmt.value)
            # the reference uses Java's Formatter; the shared %s/%d/%x/%f
            # core maps 1:1 onto python %-formatting. %, separators and
            # argument indexes are not supported (AnalysisError below).
            try:
                out = txt % tuple(v.value for v in vals[1:])
            except (TypeError, ValueError) as ex:
                raise AnalysisError(f"format(): {ex}")
            return ir.Literal(out, T.VARCHAR)
        if name == "position":
            if len(e.args) != 2:
                raise AnalysisError("position() takes two arguments")
            sub = self.convert(e.args[0])
            hay = self.convert(e.args[1])
            if not isinstance(sub, ir.Literal):
                # the strpos binder's dictionary-table form needs a
                # constant needle; fail at ANALYSIS, not mid-execution
                raise AnalysisError(
                    "position(): the substring must be a constant"
                )
            return ir.Call("strpos", (hay, sub), T.BIGINT)
        if name == "concat_ws":
            if len(e.args) < 2:
                raise AnalysisError("concat_ws() needs separator + values")
            sep = self.convert(e.args[0])
            if not isinstance(sep, ir.Literal):
                raise AnalysisError("concat_ws() separator must be constant")
            if sep.value is None:
                return ir.Literal(None, T.VARCHAR)
            vals = [self.convert(a) for a in e.args[1:]]
            # NULL literals fold away here (the runtime Case below only
            # handles column nulls; the concat binder has no NULL-only
            # constant dictionary)
            vals = [
                v for v in vals
                if not (isinstance(v, ir.Literal) and v.value is None)
            ]
            if not vals:
                return ir.Literal("", T.VARCHAR)
            # NULL-skipping desugar: every NON-NULL value contributes
            # ``sep || value`` (NULL contributes ''), then ONE leading
            # separator is stripped — so NULLs vanish without doubling
            # separators while '' is kept (Trino's contract). Stays
            # inside the dictionary-concat machinery.
            sepl = ir.Literal(sep.value, T.VARCHAR)
            pieces = []
            for v in vals:
                sv = v if v.type.is_string else ir.Cast(v, T.VARCHAR)
                pieces.append(ir.Case(
                    (ir.is_null(v),), (ir.Literal("", T.VARCHAR),),
                    ir.Call("concat", (sepl, sv), T.VARCHAR), T.VARCHAR,
                ))
            glued = pieces[0]
            for p in pieces[1:]:
                glued = ir.Call("concat", (glued, p), T.VARCHAR)
            return ir.Call(
                "substr",
                (glued, ir.Literal(len(sep.value) + 1, T.BIGINT)),
                T.VARCHAR,
            )
        if name == "human_readable_seconds":
            _arity(1)
            (a,) = _need_const(e.args)
            if a.value is None:
                return ir.Literal(None, T.VARCHAR)
            secs = int(round(float(a.value)))
            units = [("week", 604800), ("day", 86400), ("hour", 3600),
                     ("minute", 60), ("second", 1)]
            neg, secs = secs < 0, abs(secs)
            parts = []
            for uname, u in units:
                q, secs = divmod(secs, u)
                if q:
                    parts.append(f"{q} {uname}{'s' if q != 1 else ''}")
            txt = ", ".join(parts) or "0 seconds"
            return ir.Literal(("-" if neg else "") + txt, T.VARCHAR)
        if name == "parse_duration":
            _arity(1)
            (a,) = _need_const(e.args)
            if a.value is None:
                return ir.Literal(None, T.INTERVAL_DAY)
            import re as _re

            m = _re.fullmatch(
                r"\s*([0-9.]+)\s*(ns|us|ms|s|m|h|d)\s*", str(a.value)
            )
            if not m:
                raise AnalysisError(f"invalid duration: {a.value!r}")
            mult = {"ns": 1e-3, "us": 1.0, "ms": 1e3, "s": 1e6,
                    "m": 6e7, "h": 3.6e9, "d": 8.64e10}[m.group(2)]
            return ir.Literal(
                int(float(m.group(1)) * mult), T.INTERVAL_DAY
            )
        if name == "parse_data_size":
            _arity(1)
            (a,) = _need_const(e.args)
            if a.value is None:
                return ir.Literal(None, T.decimal(38, 0))
            import re as _re

            m = _re.fullmatch(
                r"\s*([0-9.]+)\s*([kMGTPE]?B)\s*", str(a.value)
            )
            if not m:
                raise AnalysisError(f"invalid data size: {a.value!r}")
            exp = {"B": 0, "kB": 1, "MB": 2, "GB": 3, "TB": 4,
                   "PB": 5, "EB": 6}[m.group(2)]
            return ir.Literal(
                int(float(m.group(1)) * (1024 ** exp)),
                T.decimal(38, 0),
            )
        if name == "to_milliseconds":
            _arity(1)
            (a,) = _need_const(e.args)
            if a.type.kind != T.TypeKind.INTERVAL_DAY:
                raise AnalysisError(
                    "to_milliseconds() takes a day-to-second interval"
                )
            v = None if a.value is None else int(a.value) // 1000
            return ir.Literal(v, T.BIGINT)
        if name == "to_iso8601":
            _arity(1)
            (a,) = _need_const(e.args)
            if a.value is None:
                return ir.Literal(None, T.VARCHAR)
            if a.type.kind == T.TypeKind.DATE:
                d = _dt.date(1970, 1, 1) + _dt.timedelta(days=int(a.value))
                return ir.Literal(d.isoformat(), T.VARCHAR)
            if a.type.kind == T.TypeKind.TIMESTAMP:
                ts = _dt.datetime(1970, 1, 1) + _dt.timedelta(
                    microseconds=int(a.value)
                )
                return ir.Literal(ts.isoformat(), T.VARCHAR)
            raise AnalysisError("to_iso8601() takes a date or timestamp")
        if name == "to_base":
            _arity(2)
            a, r = _need_const(e.args)
            if a.value is None or r.value is None:
                return ir.Literal(None, T.VARCHAR)
            radix = int(r.value)
            if not 2 <= radix <= 36:
                raise AnalysisError("to_base() radix must be in [2, 36]")
            v, digits = abs(int(a.value)), "0123456789abcdefghijklmnopqrstuvwxyz"
            out = ""
            while True:
                v, rem = divmod(v, radix)
                out = digits[rem] + out
                if v == 0:
                    break
            return ir.Literal(
                ("-" if int(a.value) < 0 else "") + out, T.VARCHAR
            )
        if name in ("to_big_endian_32", "to_big_endian_64",
                    "to_ieee754_32", "to_ieee754_64"):
            import struct as _struct

            _arity(1)
            (a,) = _need_const(e.args)
            if a.value is None:
                return ir.Literal(None, T.VARCHAR)
            if name == "to_big_endian_32":
                b = int(a.value).to_bytes(4, "big", signed=True)
            elif name == "to_big_endian_64":
                b = int(a.value).to_bytes(8, "big", signed=True)
            elif name == "to_ieee754_32":
                b = _struct.pack(">f", float(a.value))
            else:
                b = _struct.pack(">d", float(a.value))
            # utf-8-replace decode: the engine's varbinary carrier (bytes
            # >= 0x80 do not round-trip — same documented limitation as
            # from_base64 of arbitrary bytes)
            return ir.Literal(b.decode("utf-8", "replace"), T.VARCHAR)
        if name == "format_number":
            _arity(1)
            (a,) = _need_const(e.args)
            if a.value is None:
                return ir.Literal(None, T.VARCHAR)
            v = float(a.value)
            for div, suf in ((1e12, "T"), (1e9, "B"), (1e6, "M"),
                             (1e3, "K")):
                if abs(v) >= div:
                    return ir.Literal(
                        f"{v / div:.2f}".rstrip("0").rstrip(".") + suf,
                        T.VARCHAR,
                    )
            txt = f"{v:.2f}".rstrip("0").rstrip(".")
            return ir.Literal(txt, T.VARCHAR)
        if name == "rgb":
            _arity(3)
            r, g, b = _need_const(e.args)
            if None in (r.value, g.value, b.value):
                return ir.Literal(None, T.BIGINT)
            for c in (r, g, b):
                if not 0 <= int(c.value) <= 255:
                    raise AnalysisError("rgb() components must be in [0,255]")
            return ir.Literal(
                (int(r.value) << 16) | (int(g.value) << 8) | int(b.value),
                T.BIGINT,
            )
        if name == "color":
            _arity(1)
            (a,) = _need_const(e.args)
            if a.value is None:
                return ir.Literal(None, T.BIGINT)
            s = str(a.value)
            named = {"black": 0x000000, "red": 0xFF0000, "green": 0x00FF00,
                     "yellow": 0xFFFF00, "blue": 0x0000FF,
                     "magenta": 0xFF00FF, "cyan": 0x00FFFF,
                     "white": 0xFFFFFF}
            if s.lower() in named:
                return ir.Literal(named[s.lower()], T.BIGINT)
            if s.startswith("#") and len(s) == 4:
                r, g, b = (int(c * 2, 16) for c in s[1:])
                return ir.Literal((r << 16) | (g << 8) | b, T.BIGINT)
            if s.startswith("#") and len(s) == 7:
                return ir.Literal(int(s[1:], 16), T.BIGINT)
            raise AnalysisError(f"invalid color: {s!r}")
        if name == "render":
            _arity(2)
            v, c = _need_const(e.args)
            if v.value is None or c.value is None:
                return ir.Literal(None, T.VARCHAR)
            rgb24 = int(c.value)
            r, g, b = (rgb24 >> 16) & 255, (rgb24 >> 8) & 255, rgb24 & 255
            return ir.Literal(
                f"\x1b[38;2;{r};{g};{b}m{v.value}\x1b[0m", T.VARCHAR
            )
        if name == "bar":
            _arity(2, 4)
            args = _need_const(e.args)
            if args[0].value is None or args[1].value is None:
                return ir.Literal(None, T.VARCHAR)
            x = float(args[0].value)
            width = int(args[1].value)
            lo = int(args[2].value) if len(args) > 2 else 0xFF0000
            hi = int(args[3].value) if len(args) > 3 else 0x00FF00
            x = min(max(x, 0.0), 1.0)
            n = int(round(x * width))
            out = []
            for i in range(n):
                t = i / max(width - 1, 1)
                r = int(((lo >> 16) & 255) * (1 - t) + ((hi >> 16) & 255) * t)
                g = int(((lo >> 8) & 255) * (1 - t) + ((hi >> 8) & 255) * t)
                b = int((lo & 255) * (1 - t) + (hi & 255) * t)
                out.append(f"\x1b[38;2;{r};{g};{b}m█")
            return ir.Literal(
                "".join(out) + ("\x1b[0m" if out else "") + " " * (width - n),
                T.VARCHAR,
            )
        return None

    def _convert_call(self, e: ast.FunctionCall) -> ir.Expr:
        name = e.name
        if name in AGG_FUNCS:
            raise AnalysisError(
                f"aggregate function {name}() in a non-aggregate context"
            )
        breadth = self._convert_breadth_call(name, e)
        if breadth is not None:
            return breadth
        if name in self._LAMBDA_FUNCS and len(e.args) == 2 and isinstance(
            e.args[1], ast.Lambda
        ):
            return self._convert_lambda_call(name, e)
        # constant-array functions fold at analysis time; column-typed
        # arguments vectorize over the nested layouts
        if name in ("cardinality", "element_at", "contains", "array_max",
                    "array_min", "array_join", "array_position",
                    "array_remove", "array_sort", "array_distinct",
                    "slice", "trim_array", "arrays_overlap",
                    "contains_sequence", "shuffle",
                    "array_intersect", "array_union", "array_except",
                    "flatten"):
            arr = (
                _const_array_values(e.args[0]) if e.args else None
            )
            if arr is None:
                if e.args:
                    ref = self.convert(e.args[0])
                    # cardinality vectorizes over the lengths array
                    # (ArrayColumn/MapColumn.data IS lengths)
                    if name == "cardinality" and (
                        ref.type.is_array or ref.type.is_map
                    ):
                        return ir.Call("array_length", (ref,), T.BIGINT)
                    if name == "cardinality" and ref.type.is_string:
                        # HyperLogLog estimate: sketches ride the
                        # varchar carrier (approx_set/merge), so a
                        # string cardinality() is unambiguously the HLL
                        # accessor (the reference types it HyperLogLog)
                        return ir.Call(
                            "hll_cardinality", (ref,), T.BIGINT
                        )
                    if name == "element_at" and ref.type.is_map:
                        key = self.convert(e.args[1])
                        return ir.Call(
                            "map_subscript", (ref, key), ref.type.element
                        )
                    if name == "element_at" and ref.type.is_array:
                        idx = self.convert(e.args[1])
                        return ir.Call(
                            "array_subscript", (ref, idx), ref.type.element
                        )
                    if name == "contains" and ref.type.is_array:
                        probe = self.convert(e.args[1])
                        return ir.Call(
                            "array_contains", (ref, probe), T.BOOLEAN
                        )
                    if name in ("array_min", "array_max") and ref.type.is_array:
                        return ir.Call(
                            f"{name}_col", (ref,), ref.type.element
                        )
                    if ref.type.is_array and name in (
                        "array_sort", "array_distinct", "array_remove",
                        "array_position", "slice", "trim_array",
                    ):
                        rest_ir = tuple(
                            self.convert(x) for x in e.args[1:]
                        )
                        out_t = (
                            T.BIGINT if name == "array_position"
                            else ref.type
                        )
                        return ir.Call(name, (ref,) + rest_ir, out_t)
                raise AnalysisError(
                    f"{name}() supports constant arrays"
                    + (" and array/map columns"
                       if name in ("cardinality", "element_at") else "")
                    + " only"
                )
            return self._fold_array_call(name, arr, e.args[1:])
        if name in self._LAMBDA_FUNCS:
            raise AnalysisError(
                f"{name}() takes a lambda as its second argument"
            )
        if name in ("map_keys", "map_values"):
            ref = self.convert(e.args[0]) if e.args else None
            if ref is None or not ref.type.is_map:
                raise AnalysisError(f"{name}() requires a map argument")
            out_t = T.array_of(
                ref.type.key if name == "map_keys" else ref.type.element
            )
            return ir.Call(name, (ref,), out_t)
        if name == "row":
            args = tuple(self.convert(a) for a in e.args)
            return ir.Call(
                "row_pack", args, T.row_of(*[a.type for a in args])
            )
        if name == "sequence":
            raise AnalysisError(
                "sequence() is usable inside UNNEST or array functions"
            )
        args = tuple(self.convert(a) for a in e.args)
        if name in ("substr", "substring"):
            return ir.Call("substr", args, T.VARCHAR)
        return self._convert_plain_call(name, e, args)

    def _convert_lambda_call(self, name: str, e: ast.FunctionCall) -> ir.Expr:
        coll = self.convert(e.args[0])
        lam: ast.Lambda = e.args[1]
        if name in ("transform", "filter", "any_match", "all_match",
                    "none_match"):
            if not coll.type.is_array:
                raise AnalysisError(f"{name}() requires an array argument")
            if len(lam.params) != 1:
                raise AnalysisError(f"{name}() lambda takes one parameter")
            param_types = [coll.type.element]
        else:
            if not coll.type.is_map:
                raise AnalysisError(f"{name}() requires a map argument")
            if len(lam.params) != 2:
                raise AnalysisError(f"{name}() lambda takes (key, value)")
            param_types = [coll.type.key, coll.type.element]
        prev = getattr(self, "_lambda_scope", None)
        self._lambda_scope = {
            p: ir.LambdaVar(i, t)
            for i, (p, t) in enumerate(zip(lam.params, param_types))
        }
        try:
            body = self.convert(lam.body)
        finally:
            self._lambda_scope = prev
        if _refers_outside_lambda(body):
            raise AnalysisError(
                f"{name}() lambda may only reference its parameters "
                "(outer-column captures are not supported yet)"
            )
        lam_ir = ir.LambdaExpr(body, len(lam.params), body.type)
        if name == "transform":
            out_t = T.array_of(body.type)
        elif name == "filter":
            out_t = coll.type
        elif name in ("any_match", "all_match", "none_match"):
            if body.type.kind != T.TypeKind.BOOLEAN:
                raise AnalysisError(f"{name}() lambda must return boolean")
            out_t = T.BOOLEAN
        elif name == "map_filter":
            if body.type.kind != T.TypeKind.BOOLEAN:
                raise AnalysisError(f"{name}() lambda must return boolean")
            out_t = coll.type
        elif name == "transform_values":
            out_t = T.map_of(coll.type.key, body.type)
        else:  # transform_keys
            out_t = T.map_of(body.type, coll.type.element)
        return ir.Call(name, (coll, lam_ir), out_t)

    def _convert_plain_call(self, name, e, args) -> ir.Expr:
        if name in ("upper", "lower"):
            return ir.Call(name, args, T.VARCHAR)
        if name == "length":
            return ir.Call(name, args, T.BIGINT)
        if name == "abs":
            return ir.Call(name, args, args[0].type)
        if name == "round":
            return ir.Call(name, args, args[0].type)
        if name in ("sqrt", "ln", "exp"):
            return ir.Call(name, args, T.DOUBLE)
        if name in ("floor", "ceil", "ceiling"):
            nm = "ceil" if name == "ceiling" else name
            out = T.DOUBLE if args[0].type.is_floating else T.BIGINT
            return ir.Call(nm, args, out)
        if name == "coalesce":
            out = _choice_type([a.type for a in args])
            return ir.Call(name, args, out)
        if name == "concat":
            return ir.Call("concat", args, T.VARCHAR)
        if name in ("trim", "ltrim", "rtrim", "reverse"):
            return ir.Call(name, args, T.VARCHAR)
        if name == "replace":
            return ir.Call(name, args, T.VARCHAR)
        if name == "starts_with":
            return ir.Call(name, args, T.BOOLEAN)
        if name == "nullif":
            if len(args) != 2:
                raise AnalysisError("nullif() takes two arguments")
            return ir.Call(name, args, args[0].type)
        if name in ("greatest", "least"):
            out = _unify_types([a.type for a in args])
            cast_args = tuple(
                a if a.type == out else ir.Cast(a, out) for a in args
            )
            return ir.Call(name, cast_args, out)
        if name in ("power", "pow"):
            return ir.Call("power", args, T.DOUBLE)
        if name in ("log2", "log10"):
            return ir.Call(name, args, T.DOUBLE)
        if name == "sign":
            out = T.DOUBLE if args[0].type.is_floating else T.BIGINT
            return ir.Call(name, args, out)
        if name == "mod":
            out_t = _arith_type("mod", args[0].type, args[1].type)
            return ir.Call("mod", args, out_t)
        if (
            name in _TSTZ_WALL_FNS
            and args
            and args[0].type.kind == T.TypeKind.TIMESTAMP_TZ
        ):
            # civil-field/formatting functions read the LOCAL wall clock
            # in the value's own zone (DateTimes.java) — rewrite the
            # tstz argument to its wall-clock timestamp
            args = [
                ir.Call("tstz_to_ts", (args[0],), T.TIMESTAMP), *args[1:]
            ]
        if name in ("year", "month", "day"):
            return ir.Call(f"extract_{name}", args, T.BIGINT)
        if name == "if":
            if len(args) not in (2, 3):
                raise AnalysisError("if() takes 2 or 3 arguments")
            default = args[2] if len(args) == 3 else None
            out = _choice_type(
                [args[1].type] + ([default.type] if default is not None else [])
            )
            return ir.Case((args[0],), (args[1],), default, out)
        if name in ("sin", "cos", "tan", "asin", "acos", "atan", "sinh",
                    "cosh", "tanh", "cbrt", "degrees", "radians"):
            return ir.Call(name, args, T.DOUBLE)
        if name in ("atan2", "log"):
            if len(args) != 2:
                raise AnalysisError(f"{name}() takes two arguments")
            return ir.Call(name, args, T.DOUBLE)
        if name == "pi":
            return ir.Literal(math.pi, T.DOUBLE)
        if name == "e":
            return ir.Literal(math.e, T.DOUBLE)
        if name == "nan":
            return ir.Literal(float("nan"), T.DOUBLE)
        if name == "infinity":
            return ir.Literal(float("inf"), T.DOUBLE)
        if name in ("is_nan", "is_infinite", "is_finite"):
            return ir.Call(name, args, T.BOOLEAN)
        if name == "truncate":
            out = args[0].type if args[0].type.is_decimal else T.DOUBLE
            return ir.Call(name, args, out)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_not", "bitwise_left_shift",
                    "bitwise_right_shift"):
            return ir.Call(name, args, T.BIGINT)
        if name in ("strpos", "codepoint"):
            return ir.Call(name, args, T.BIGINT)
        if name in ("ends_with", "regexp_like"):
            return ir.Call(name, args, T.BOOLEAN)
        if name in ("split_part", "lpad", "rpad", "translate",
                    "regexp_extract", "regexp_replace"):
            return ir.Call(name, args, T.VARCHAR)
        if name == "regexp_count":
            return ir.Call(name, args, T.BIGINT)
        if name == "chr":
            if not isinstance(args[0], ir.Literal):
                raise AnalysisError("chr() argument must be a constant")
            return ir.Literal(chr(int(args[0].value)), T.VARCHAR)
        TSTZ_K = T.TypeKind.TIMESTAMP_TZ
        if name == "to_unixtime" and args and args[0].type.kind == TSTZ_K:
            # unix time is the INSTANT, not the wall clock
            args = [
                ir.Call("tstz_to_instant_ts", (args[0],), T.TIMESTAMP),
                *args[1:],
            ]
        if name in ("quarter", "week", "day_of_week", "dow", "day_of_year",
                    "doy", "day_of_month"):
            canon = {"dow": "day_of_week", "doy": "day_of_year",
                     "day_of_month": "extract_day"}.get(name, name)
            return ir.Call(canon, args, T.BIGINT)
        if name == "date_trunc":
            if len(args) != 2:
                raise AnalysisError("date_trunc() takes two arguments")
            if args[1].type.kind == TSTZ_K:
                # truncate on the wall clock in the value's zone, then
                # restore the instant/zone packing (DateTimes.java
                # truncation semantics)
                wall = ir.Call("tstz_to_ts", (args[1],), T.TIMESTAMP)
                trunc = ir.Call("date_trunc", (args[0], wall), T.TIMESTAMP)
                return ir.Call(
                    "tstz_rewall", (trunc, args[1]), T.TIMESTAMP_TZ
                )
            return ir.Call(name, args, args[1].type)
        if name == "date_add":
            if len(args) != 3:
                raise AnalysisError("date_add() takes three arguments")
            if args[2].type.kind == TSTZ_K:
                unit = (
                    str(args[0].value).lower()
                    if isinstance(args[0], ir.Literal) else None
                )
                sub_day = {"millisecond": 1, "second": 1000,
                           "minute": 60_000, "hour": 3_600_000}
                if unit in sub_day:
                    # exact-duration shift on the instant
                    ms = ir.Call(
                        "mul",
                        (args[1], ir.Literal(sub_day[unit], T.BIGINT)),
                        T.BIGINT,
                    )
                    return ir.Call(
                        "tstz_shift", (args[2], ms), T.TIMESTAMP_TZ
                    )
                # calendar units move the wall clock in the value's zone
                wall = ir.Call("tstz_to_ts", (args[2],), T.TIMESTAMP)
                moved = ir.Call(
                    "date_add", (args[0], args[1], wall), T.TIMESTAMP
                )
                return ir.Call(
                    "tstz_rewall", (moved, args[2]), T.TIMESTAMP_TZ
                )
            return ir.Call(name, args, args[2].type)
        if name == "date_diff":
            if len(args) != 3:
                raise AnalysisError("date_diff() takes three arguments")
            if any(a.type.kind == TSTZ_K for a in args[1:]):
                unit = (
                    str(args[0].value).lower()
                    if isinstance(args[0], ir.Literal) else None
                )
                sub_day = ("millisecond", "second", "minute", "hour")
                conv = (
                    "tstz_to_instant_ts" if unit in sub_day else "tstz_to_ts"
                )
                new_args = [args[0]]
                for a in args[1:]:
                    if a.type.kind == TSTZ_K:
                        a = ir.Call(conv, (a,), T.TIMESTAMP)
                    new_args.append(a)
                return ir.Call(name, tuple(new_args), T.BIGINT)
            return ir.Call(name, args, T.BIGINT)
        if name == "last_day_of_month":
            return ir.Call(name, args, T.DATE)
        if name == "typeof":
            if len(args) != 1:
                raise AnalysisError("typeof() takes one argument")
            return ir.Literal(str(args[0].type), T.VARCHAR)
        # registry-resolved scalars (expr/registry.py): every function
        # not special-cased above types through the declarative catalog
        # (FunctionResolver analogue)
        from trino_tpu_torch.expr.registry import REGISTRY

        try:
            hit = REGISTRY.resolve(name, [a.type for a in args])
        except ValueError as ex:
            raise AnalysisError(str(ex))
        if hit is not None:
            canonical, out_t = hit
            meta = REGISTRY.get(name)
            for pos in meta.const_args:
                if pos < len(args) and not isinstance(args[pos], ir.Literal):
                    raise AnalysisError(
                        f"{meta.name}(): argument {pos + 1} must be a"
                        " constant"
                    )
            return ir.Call(canonical, args, out_t)
        raise AnalysisError(f"unknown function {name}()")

    def _convert_subscript(self, e) -> ir.Expr:
        """a[i] / m[k] (Trino's SubscriptExpression). Missing map keys
        and out-of-range array positions yield NULL (element_at
        semantics; the reference raises for bare [] on missing keys —
        documented divergence, NULL degrades instead of failing)."""
        if isinstance(e.operand, ast.ArrayLiteral):
            arr = _const_array_values(e.operand)
            if arr is not None:
                return self._fold_array_call("element_at", arr, (e.index,))
        base = self.convert(e.operand)
        idx = self.convert(e.index)
        if base.type.is_map:
            return ir.Call("map_subscript", (base, idx), base.type.element)
        if base.type.is_array:
            return ir.Call("array_subscript", (base, idx), base.type.element)
        raise AnalysisError(
            f"subscript requires an array or map operand, got {base.type}"
        )

    def _fold_array_call(
        self, name: str, arr: List[ir.Literal], rest: tuple
    ) -> ir.Expr:
        elem_t = _array_element_type(arr)  # raises on mixed types
        if name == "cardinality":
            return ir.Literal(len(arr), T.BIGINT)
        if name == "element_at":
            idx = _const_fold(self.convert(rest[0])) if rest else None
            if idx is None or idx.value is None:
                raise AnalysisError("element_at() index must be constant")
            i = int(idx.value)
            # 1-based; negative counts from the end; OOB -> NULL
            pos = i - 1 if i > 0 else len(arr) + i
            if i == 0:
                raise AnalysisError("element_at() index cannot be 0")
            if 0 <= pos < len(arr):
                return arr[pos]
            return ir.Literal(None, elem_t)
        if name == "contains":
            probe = _const_fold(self.convert(rest[0])) if rest else None
            if probe is None:
                raise AnalysisError("contains() value must be constant")
            if probe.value is None:
                return ir.Literal(None, T.BOOLEAN)  # NULL probe -> NULL
            if (
                probe.type.kind != T.TypeKind.UNKNOWN
                and arr
                and T.common_super_type(elem_t, probe.type) is None
            ):
                raise AnalysisError(
                    f"contains(): cannot compare {elem_t} with {probe.type}"
                )
            # avoid python bool==int conflation: compare type kinds too
            def same(a, b):
                return a == b and isinstance(a, bool) == isinstance(b, bool)

            if any(
                l.value is not None and same(l.value, probe.value)
                for l in arr
            ):
                return ir.Literal(True, T.BOOLEAN)
            # NULL element makes a non-match indeterminate (SQL IN)
            if any(l.value is None for l in arr):
                return ir.Literal(None, T.BOOLEAN)
            return ir.Literal(False, T.BOOLEAN)
        if name in ("array_max", "array_min"):
            vals = [l.value for l in arr if l.value is not None]
            if not vals or len(vals) != len(arr):  # Trino: NULL if any NULL
                return ir.Literal(None, elem_t)
            return ir.Literal(
                max(vals) if name == "array_max" else min(vals), elem_t
            )
        if name == "array_join":
            sep = _const_fold(self.convert(rest[0])) if rest else None
            if sep is None or sep.value is None:
                raise AnalysisError("array_join() delimiter must be constant")
            null_repl = None
            if len(rest) > 1:
                nr = _const_fold(self.convert(rest[1]))
                if nr is None:
                    raise AnalysisError(
                        "array_join() null replacement must be constant"
                    )
                null_repl = nr.value  # NULL replacement -> skip nulls
            parts = []
            for l in arr:
                if l.value is None:
                    if null_repl is not None:
                        parts.append(str(null_repl))
                else:
                    v = l.value
                    parts.append(
                        ("true" if v else "false")
                        if isinstance(v, bool) else str(v)
                    )
            return ir.Literal(str(sep.value).join(parts), T.VARCHAR)
        # r4 breadth: constant-array forms fold at analysis; COLUMN
        # arrays take the vectorized binder paths (expr/compile
        # _bind_array_fn) where layouts are canonical
        vals = [l.value for l in arr]

        def lit_arr(pyvals, t=None):
            return ir.Literal(tuple(pyvals), T.array_of(t or elem_t))

        def other_array(idx=0):
            o = _const_array_values(rest[idx]) if len(rest) > idx else None
            if o is None:
                raise AnalysisError(f"{name}() requires constant arrays")
            return [
                _const_fold(self.convert(x)).value for x in rest[idx].elements
            ]

        if name == "array_position":
            probe = _const_fold(self.convert(rest[0])) if rest else None
            if probe is None:
                raise AnalysisError("array_position() value must be constant")
            for i, v in enumerate(vals):
                if v is not None and v == probe.value:
                    return ir.Literal(i + 1, T.BIGINT)
            return ir.Literal(0, T.BIGINT)
        if name == "array_remove":
            probe = _const_fold(self.convert(rest[0])) if rest else None
            if probe is None:
                raise AnalysisError("array_remove() value must be constant")
            return lit_arr([v for v in vals if v is None or v != probe.value])
        if name == "array_sort":
            nn = sorted(v for v in vals if v is not None)
            return lit_arr(nn + [None] * (len(vals) - len(nn)))
        if name == "array_distinct":
            seen, out = set(), []
            has_null = False
            for v in vals:
                if v is None:
                    has_null = True
                elif v not in seen:
                    seen.add(v)
                    out.append(v)
            return lit_arr(out + ([None] if has_null else []))
        if name in ("slice", "trim_array"):
            a1 = _const_fold(self.convert(rest[0]))
            if name == "trim_array":
                n = int(a1.value)
                return lit_arr(vals[: max(len(vals) - n, 0)])
            a2 = _const_fold(self.convert(rest[1]))
            start, ln = int(a1.value), int(a2.value)
            pos = start - 1 if start > 0 else len(vals) + start
            return lit_arr(vals[max(pos, 0): max(pos, 0) + max(ln, 0)])
        if name in ("arrays_overlap", "array_intersect", "array_union",
                    "array_except"):
            other = other_array()
            sa = [v for v in vals if v is not None]
            sb = [v for v in other if v is not None]
            if name == "arrays_overlap":
                if set(sa) & set(sb):
                    return ir.Literal(True, T.BOOLEAN)
                if None in vals or None in other:
                    return ir.Literal(None, T.BOOLEAN)
                return ir.Literal(False, T.BOOLEAN)
            if name == "array_intersect":
                return lit_arr(sorted(set(sa) & set(sb)))
            if name == "array_union":
                u = sorted(set(sa) | set(sb))
                if None in vals or None in other:
                    u = u + [None]
                return lit_arr(u)
            return lit_arr(sorted(set(sa) - set(sb)))
        if name == "flatten":
            out = []
            for x in arr:  # elements are themselves array literals
                if x.value is None:
                    continue
                out.extend(x.value)
            return lit_arr(out, elem_t.element if elem_t.is_array else elem_t)
        if name == "contains_sequence":
            seq = other_array()
            n, m = len(vals), len(seq)
            hit = any(
                list(vals[i:i + m]) == list(seq)
                for i in range(n - m + 1)
            ) or m == 0
            return ir.Literal(hit, T.BOOLEAN)
        if name == "shuffle":
            import random as _random

            out = list(vals)
            _random.shuffle(out)  # nondeterministic, like the reference
            return lit_arr(out)
        raise AnalysisError(f"unknown array function {name}")


# ---------------------------------------------------------------------------
# Helpers over AST predicates
# ---------------------------------------------------------------------------


def split_conjuncts(e: Optional[ast.Expression]) -> List[ast.Expression]:
    if e is None:
        return []
    if isinstance(e, ast.BinaryOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def conjoin(parts: Sequence[ast.Expression]) -> Optional[ast.Expression]:
    out = None
    for p in parts:
        out = p if out is None else ast.BinaryOp("and", out, p)
    return out


def _idents(e: ast.Expression) -> List[ast.Identifier]:
    """All identifiers in an expression, NOT descending into subqueries."""
    out: List[ast.Identifier] = []

    def walk(x):
        if isinstance(x, ast.Identifier):
            out.append(x)
            return
        if isinstance(x, (ast.Exists, ast.InSubquery, ast.ScalarSubquery)):
            return  # inner scope owns those
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for i in x:
                walk(i)

    walk(e)
    return out


def _has_subquery(e: ast.Expression) -> bool:
    found = False

    def walk(x):
        nonlocal found
        if found:
            return
        if isinstance(x, (ast.Exists, ast.InSubquery, ast.ScalarSubquery)):
            found = True
            return
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for i in x:
                walk(i)

    walk(e)
    return found


def _scalar_subqueries(e: ast.Expression) -> List[ast.ScalarSubquery]:
    out: List[ast.ScalarSubquery] = []

    def walk(x):
        if isinstance(x, ast.ScalarSubquery):
            out.append(x)
            return
        if isinstance(x, (ast.Exists, ast.InSubquery)):
            return
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for i in x:
                walk(i)

    walk(e)
    return out


WINDOW_ONLY_FUNCS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "lead", "lag", "first_value", "last_value", "nth_value",
}


def _find_window_calls(e: ast.Expression) -> List[ast.WindowCall]:
    out: List[ast.WindowCall] = []

    def walk(x):
        if isinstance(x, ast.WindowCall):
            out.append(x)
            return
        if isinstance(x, (ast.Exists, ast.InSubquery, ast.ScalarSubquery)):
            return
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for i in x:
                walk(i)

    walk(e)
    return out


def resolve_type(t: ast.TypeName) -> T.DataType:
    """TypeName AST -> DataType (shared by CAST analysis and DDL)."""
    mapping = {
        "boolean": T.BOOLEAN, "tinyint": T.TINYINT, "smallint": T.SMALLINT,
        "integer": T.INTEGER, "bigint": T.BIGINT, "real": T.REAL,
        "double": T.DOUBLE, "date": T.DATE, "timestamp": T.TIMESTAMP,
        "timestamp with time zone": T.TIMESTAMP_TZ,
    }
    if t.name in mapping:
        return mapping[t.name]
    if t.name == "decimal":
        p = t.params[0] if t.params else 18
        s = t.params[1] if len(t.params) > 1 else 0
        return T.decimal(min(p, T.MAX_DECIMAL_PRECISION), s)
    if t.name in ("varchar", "char"):
        return T.VARCHAR
    if t.name == "array":
        return T.array_of(resolve_type(t.args[0][1]))
    if t.name == "map":
        return T.map_of(resolve_type(t.args[0][1]), resolve_type(t.args[1][1]))
    if t.name == "row":
        return T.row_of(*[(n, resolve_type(st)) for n, st in t.args])
    raise AnalysisError(f"unsupported type {t.name}")


def _array_element_type(arr: List[ir.Literal]) -> T.DataType:
    """Unified element type; mixed incompatible elements fail loudly at
    analysis time (ARRAY[1, 'a'] must not crash at execution)."""
    t: Optional[T.DataType] = None
    for lit in arr:
        if lit.type.kind == T.TypeKind.UNKNOWN:
            continue
        if t is None:
            t = lit.type
            continue
        u = T.common_super_type(t, lit.type)
        if u is None:
            raise AnalysisError(
                f"array elements have incompatible types {t} and {lit.type}"
            )
        t = u
    return t or T.BIGINT


def _const_array_values(e: ast.Expression) -> Optional[List[ir.Literal]]:
    """Fold a constant array expression (ARRAY[...] of foldable cells,
    or sequence(lo, hi[, step]) with literal bounds) to its elements."""
    conv = ExprConverter(Scope([]))
    if isinstance(e, ast.ArrayLiteral):
        out = []
        for cell in e.elements:
            lit = _const_fold(conv.convert(cell))
            if lit is None:
                return None
            out.append(lit)
        return out
    if isinstance(e, ast.FunctionCall) and e.name == "sequence":
        args = [_const_fold(conv.convert(a)) for a in e.args]
        if any(a is None or a.value is None for a in args):
            return None
        if len(args) == 2:
            lo, hi, step = int(args[0].value), int(args[1].value), 1
        elif len(args) == 3:
            lo, hi, step = (int(a.value) for a in args)
        else:
            raise AnalysisError("sequence() takes 2 or 3 arguments")
        if step == 0:
            raise AnalysisError("sequence() step must not be zero")
        if (hi - lo) * step < 0:
            raise AnalysisError(
                "sequence() step sign contradicts the start/stop direction"
            )
        if abs((hi - lo) // step) > 1_000_000:
            raise AnalysisError("sequence() result too large")
        stop = hi + (1 if step > 0 else -1)
        return [
            ir.Literal(v, T.BIGINT) for v in range(lo, stop, step)
        ]
    return None


def _const_fold(x: ir.Expr) -> Optional[ir.Literal]:
    """Literal, negate(Literal) or cast(Literal) -> folded Literal."""
    if isinstance(x, ir.Literal):
        return x
    if isinstance(x, ir.Call) and x.name == "negate":
        inner = _const_fold(x.args[0])
        if inner is not None and inner.value is not None:
            return ir.Literal(-inner.value, x.type)
    if isinstance(x, ir.Cast):
        inner = _const_fold(x.arg)
        if inner is not None:
            return ir.Literal(inner.value, x.type)
    return None


def _refers_outside_lambda(body: ir.Expr) -> bool:
    """True when a lambda body references anything but its parameters
    and constants (outer-column captures — unsupported)."""
    if isinstance(body, ir.InputRef):
        return True
    return any(_refers_outside_lambda(c) for c in body.children())


# scalar accessors that FUSE with the sketch aggregate they wrap:
# cardinality(approx_set(x)) etc. evaluate inside the aggregation's
# collect finalizer, because the digest's runtime dictionary is not
# plan-bindable (expr/compile dictionary-table discipline). Standalone
# accessors over TABLE columns bind normally.
_SKETCH_ACCESSORS = {"cardinality", "value_at_quantile",
                     "quantile_at_value", "values_at_quantiles"}
_SKETCH_AGGS = {"approx_set", "merge", "tdigest_agg", "qdigest_agg"}


def _find_agg_calls(e: ast.Expression) -> List[ast.FunctionCall]:
    out: List[ast.FunctionCall] = []

    def walk(x):
        if (
            isinstance(x, ast.FunctionCall)
            and x.name in _SKETCH_ACCESSORS
            and x.args
            and isinstance(x.args[0], ast.FunctionCall)
            and x.args[0].name in _SKETCH_AGGS
        ):
            out.append(x)  # fused accessor-over-sketch unit
            return
        if isinstance(x, ast.FunctionCall) and x.name in AGG_FUNCS:
            out.append(x)
            return  # no nested aggregates
        if isinstance(x, (ast.Exists, ast.InSubquery, ast.ScalarSubquery)):
            return
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for i in x:
                walk(i)

    walk(e)
    return out


def _common_or_conjuncts(e: ast.Expression) -> List[ast.Expression]:
    """Factor conjuncts common to every branch of an OR (Q19's
    `p_partkey = l_partkey` pattern) — ExtractCommonPredicatesExpressionRewriter
    analogue. The OR itself stays; the extracted conjuncts are implied."""
    branches: List[ast.Expression] = []

    def flatten_or(x):
        if isinstance(x, ast.BinaryOp) and x.op == "or":
            flatten_or(x.left)
            flatten_or(x.right)
        else:
            branches.append(x)

    flatten_or(e)
    if len(branches) < 2:
        return []
    sets = [split_conjuncts(b) for b in branches]
    common = [c for c in sets[0] if all(c in s for s in sets[1:])]
    return common


# ---------------------------------------------------------------------------
# Plan builder
# ---------------------------------------------------------------------------


class Builder:
    """Mutable (node, scope, replacements) triple threaded through
    planning; replacements map AST expressions to output channels."""

    def __init__(self, node: P.PlanNode, scope: Scope):
        self.node = node
        self.scope = scope
        self.replacements: Dict[ast.Expression, Tuple[int, T.DataType]] = {}

    def converter(self) -> ExprConverter:
        return ExprConverter(self.scope, self.replacements)

    def filter(self, predicate: ir.Expr) -> None:
        self.node = P.FilterNode(self.node, predicate, self.node.fields)


@dataclasses.dataclass
class _DeferredUnnest:
    """Marker for UNNEST over column references; resolved against the
    sibling FROM items after they all plan."""

    rel: "ast.UnnestRelation"


@dataclasses.dataclass
class RelationItem:
    """One FROM item during join planning."""

    node: P.PlanNode
    scope: Scope
    rows: float  # stats estimate


class Analyzer:
    def __init__(self, catalogs: CatalogManager, default_catalog: str, default_schema: str):
        self.catalogs = catalogs
        self.catalog = default_catalog
        self.schema = default_schema

    # ---- statements ----
    def plan(self, stmt: ast.Node) -> P.OutputNode:
        if isinstance(stmt, ast.Query):
            node, scope, names = self.plan_query(stmt, {})
            out = P.OutputNode(node, tuple(names), node.fields)
            _validate_array_usage(out)
            return out
        raise AnalysisError(f"cannot plan {type(stmt).__name__}")

    # ---- queries ----
    def plan_query(
        self, q: ast.Query, ctes: Dict[str, ast.WithQuery]
    ) -> Tuple[P.PlanNode, Scope, List[str]]:
        ctes = dict(ctes)
        for w in q.with_:
            ctes[w.name] = w
        if isinstance(q.body, ast.QuerySpec):
            return self.plan_query_spec(
                q.body, q.order_by, q.limit, q.offset, ctes
            )
        if isinstance(q.body, ast.SetOperation):
            return self._plan_set_op(q, ctes)
        if isinstance(q.body, ast.ValuesBody):
            if q.order_by or q.limit is not None or q.offset:
                raise AnalysisError("ORDER BY/LIMIT over VALUES not supported")
            return self._plan_values_body(q.body)
        raise AnalysisError("unsupported query body")

    def _plan_values_body(self, body: ast.ValuesBody):
        """VALUES rows -> ValuesNode: cells must be constant-foldable
        (Values analogue of parser/sql/tree/Values)."""
        conv = ExprConverter(Scope([]))
        rows = []
        col_types: List[Optional[T.DataType]] = []
        for r in body.rows:
            vals = []
            for i, cell in enumerate(r):
                lit = _const_fold(conv.convert(cell))
                if lit is None:
                    raise AnalysisError("VALUES cells must be constants")
                vals.append(lit.value)
                t = lit.type
                if i >= len(col_types):
                    col_types.append(t)
                else:
                    prev = col_types[i]
                    if prev is None or prev.kind == T.TypeKind.UNKNOWN:
                        col_types[i] = t
                    elif t.kind != T.TypeKind.UNKNOWN and t != prev:
                        u = T.common_super_type(prev, t)
                        if u is None:
                            raise AnalysisError(
                                f"VALUES column {i}: incompatible types {prev} and {t}"
                            )
                        col_types[i] = u
            if len(r) != len(body.rows[0]):
                raise AnalysisError("VALUES rows differ in width")
            rows.append(tuple(vals))
        types = [
            t if t is not None and t.kind != T.TypeKind.UNKNOWN else T.BIGINT
            for t in col_types
        ]
        names = [f"_col{i}" for i in range(len(types))]
        fields = tuple(P.Field(n, t) for n, t in zip(names, types))
        node = P.ValuesNode(fields, tuple(rows))
        scope = Scope([ScopeField(None, n, t) for n, t in zip(names, types)])
        return node, scope, names

    def _plan_set_op(self, q: ast.Query, ctes) -> Tuple[P.PlanNode, Scope, List[str]]:
        def plan_body(body) -> Tuple[P.PlanNode, Scope, List[str]]:
            if isinstance(body, ast.QuerySpec):
                return self.plan_query_spec(body, (), None, 0, ctes)
            if isinstance(body, ast.SetOperation):
                return plan_set(body)
            if isinstance(body, ast.ValuesBody):
                return self._plan_values_body(body)
            raise AnalysisError("unsupported set operation term")

        def plan_set(s: ast.SetOperation) -> Tuple[P.PlanNode, Scope, List[str]]:
            ln, lscope, lnames = plan_body(s.left)
            rn, rscope, _ = plan_body(s.right)
            if len(lscope) != len(rscope):
                raise AnalysisError("set operation inputs differ in width")
            for lf, rf in zip(ln.fields, rn.fields):
                if lf.type != rf.type:
                    raise AnalysisError(
                        f"set operation column types differ: {lf.type} vs {rf.type}"
                    )
            fields = ln.fields
            if s.op == "union":
                node: P.PlanNode = P.UnionAllNode((ln, rn), fields)
                if not s.all:
                    node = P.AggregateNode(
                        node, tuple(range(len(fields))), (), fields
                    )
            else:
                # INTERSECT/EXCEPT via dedup + semi/anti join on all
                # columns (the SetOperationNodeTranslator strategy).
                # Deviation: NULL rows follow join semantics (never
                # match), not the standard's NULLs-equal grouping.
                if s.all:
                    raise AnalysisError(f"{s.op} ALL not supported")
                w = len(fields)
                dedup = P.AggregateNode(ln, tuple(range(w)), (), fields)
                kind = "semi" if s.op == "intersect" else "anti"
                node = P.JoinNode(
                    kind, dedup, rn, tuple(range(w)), tuple(range(w)),
                    None, fields,
                )
            return node, Scope([ScopeField(None, f.name, f.type) for f in fields]), lnames

        node, scope, names = plan_set(q.body)
        # ORDER BY / LIMIT / OFFSET over the set operation's output
        sort_keys: List[SortKey] = []
        for s in q.order_by:
            ch = None
            if isinstance(s.expr, ast.NumberLiteral) and s.expr.text.isdigit():
                ch = int(s.expr.text) - 1
            elif isinstance(s.expr, ast.Identifier) and len(s.expr.parts) == 1:
                name = s.expr.parts[0]
                if name in names:
                    ch = names.index(name)
            if ch is None or not (0 <= ch < len(names)):
                raise AnalysisError(
                    "ORDER BY over set operations must reference output columns"
                )
            nf = s.nulls_first if s.nulls_first is not None else s.descending
            sort_keys.append(SortKey(ch, s.descending, nf))
        if sort_keys:
            if q.limit is not None and not q.offset:
                node = P.TopNNode(node, tuple(sort_keys), q.limit, node.fields)
            else:
                node = P.SortNode(node, tuple(sort_keys), node.fields)
                if q.limit is not None or q.offset:
                    node = P.LimitNode(node, q.limit, q.offset, node.fields)
        elif q.limit is not None or q.offset:
            node = P.LimitNode(node, q.limit, q.offset, node.fields)
        return node, scope, names

    # ---- the heart: one SELECT block ----
    def plan_query_spec(
        self,
        spec: ast.QuerySpec,
        order_by: Tuple[ast.SortItem, ...],
        limit: Optional[int],
        offset: int,
        ctes: Dict[str, ast.WithQuery],
    ) -> Tuple[P.PlanNode, Scope, List[str]]:
        builder, leftovers = self._plan_from_where(spec, ctes)

        # remaining predicates (subqueries, cross-item non-equi, ...)
        for conj in leftovers:
            self._plan_predicate(builder, conj, ctes)

        # -- aggregation analysis --
        select_items = self._expand_stars(spec, builder.scope)
        select_exprs = [it.expr for it in select_items]
        group_asts = self._resolve_group_ordinals(spec.group_by, select_exprs)
        agg_calls: List[ast.FunctionCall] = []
        for e in select_exprs + ([spec.having] if spec.having else []) + [
            s.expr for s in order_by
        ]:
            for c in _find_agg_calls(e):
                if c not in agg_calls:
                    agg_calls.append(c)
        if spec.group_by_sets is not None:
            self._plan_grouping_sets(
                builder, group_asts, spec.group_by_sets, agg_calls, ctes
            )
            if spec.having is not None:
                self._plan_predicate(builder, spec.having, ctes)
        elif group_asts or agg_calls:
            self._plan_aggregation(builder, group_asts, agg_calls, ctes)
            if spec.having is not None:
                self._plan_predicate(builder, spec.having, ctes)

        # -- window functions (evaluated after aggregation, like Trino's
        # WindowNode above the AggregationNode) --
        window_calls: List[ast.WindowCall] = []
        for e in select_exprs + [s.expr for s in order_by]:
            for c in _find_window_calls(e):
                if c not in window_calls:
                    window_calls.append(c)
        if window_calls:
            self._plan_windows(builder, window_calls)

        # -- subqueries in the SELECT list / ORDER BY: scalar subqueries
        # join in, EXISTS/IN become mark-join boolean channels --
        for e in select_exprs + [s.expr for s in order_by]:
            self._plan_embedded_subqueries(builder, e, ctes)

        # -- select projection (+ hidden order-by channels) --
        conv = builder.converter()
        out_exprs = [conv.convert(e) for e in select_exprs]
        names = [self._output_name(it, i) for i, it in enumerate(select_items)]

        sort_keys: List[SortKey] = []
        hidden = 0
        for s in order_by:
            ch = self._order_by_channel(s.expr, select_items, select_exprs, names)
            if ch is None:
                out_exprs.append(conv.convert(s.expr))
                ch = len(out_exprs) - 1
                hidden += 1
            desc = s.descending
            nf = s.nulls_first if s.nulls_first is not None else desc
            sort_keys.append(SortKey(ch, desc, nf))

        fields = tuple(
            P.Field(names[i] if i < len(names) else None, e.type)
            for i, e in enumerate(out_exprs)
        )
        node: P.PlanNode = P.ProjectNode(builder.node, tuple(out_exprs), fields)

        if spec.distinct:
            if hidden:
                raise AnalysisError("DISTINCT with non-selected ORDER BY expression")
            node = P.AggregateNode(node, tuple(range(len(fields))), (), fields)

        if sort_keys:
            if limit is not None and offset == 0:
                node = P.TopNNode(node, tuple(sort_keys), limit, node.fields)
            else:
                node = P.SortNode(node, tuple(sort_keys), node.fields)
                if limit is not None or offset:
                    node = P.LimitNode(node, limit, offset, node.fields)
        elif limit is not None or offset:
            node = P.LimitNode(node, limit, offset, node.fields)

        if hidden:
            keep = tuple(range(len(names)))
            kept_fields = tuple(node.fields[i] for i in keep)
            node = P.ProjectNode(
                node,
                tuple(ir.InputRef(i, node.fields[i].type) for i in keep),
                kept_fields,
            )

        out_scope = Scope([ScopeField(None, f.name, f.type) for f in node.fields])
        return node, out_scope, names

    # ---- FROM/WHERE with join ordering ----
    def _plan_from_where(
        self, spec: ast.QuerySpec, ctes
    ) -> Tuple[Builder, List[ast.Expression]]:
        conjunct_pool: List[ast.Expression] = []
        where_conjuncts = split_conjuncts(spec.where)
        for c in where_conjuncts:
            conjunct_pool.extend(_common_or_conjuncts(c))
        conjunct_pool.extend(where_conjuncts)

        if spec.from_ is None:
            node = P.ValuesNode((P.Field("dummy", T.BIGINT),), ((0,),))
            b = Builder(node, Scope([ScopeField(None, None, T.BIGINT)]))
            return b, conjunct_pool

        items: List[RelationItem] = []
        self._collect_relations(spec.from_, items, conjunct_pool, ctes)
        items, decl_segments = self._resolve_lateral_unnests(items)

        # classify conjuncts
        leftovers: List[ast.Expression] = []
        item_filters: Dict[int, List[ast.Expression]] = {i: [] for i in range(len(items))}
        join_edges: List[Tuple[int, int, ast.Identifier, ast.Identifier]] = []
        seen: Set[int] = set()
        for c in conjunct_pool:
            if id(c) in seen:
                continue
            seen.add(id(c))
            if _has_subquery(c):
                leftovers.append(c)
                continue
            owners = self._items_of(c, items)
            if owners is None:
                leftovers.append(c)  # references outer scope etc.
                continue
            if len(owners) == 1:
                item_filters[next(iter(owners))].append(c)
                continue
            edge = self._equi_edge(c, items)
            if edge is not None:
                join_edges.append(edge)
            else:
                leftovers.append(c)

        # apply single-item filters (predicate pushdown)
        for i, item in enumerate(items):
            if item_filters[i]:
                conv = ExprConverter(item.scope)
                pred = ir.and_(*[conv.convert(c) for c in item_filters[i]])
                item.node = P.FilterNode(item.node, pred, item.node.fields)
                item.rows = max(item.rows / 3.0, 1.0)

        # greedy join-order assembly
        joined = [0]
        current = items[0]
        current_offsets = {0: 0}
        pending_edges = list(join_edges)
        while len(joined) < len(items):
            # pick a connected item (smallest) else smallest remaining
            candidates: Dict[int, List] = {}
            for e in pending_edges:
                a, b_, _, _ = e
                if (a in joined) != (b_ in joined):
                    new = b_ if a in joined else a
                    candidates.setdefault(new, []).append(e)
            if candidates:
                new = min(candidates, key=lambda i: items[i].rows)
                edges = candidates[new]
            else:
                remaining = [i for i in range(len(items)) if i not in joined]
                new = min(remaining, key=lambda i: items[i].rows)
                edges = []
            current, current_offsets = self._join_items(
                current, current_offsets, items, new, edges
            )
            joined.append(new)
            pending_edges = [e for e in pending_edges if e not in edges]

        # restore FROM declaration order: greedy assembly (and the
        # build/probe swap in _join_items) concatenates scopes in join
        # order, but SELECT * and positional semantics follow the FROM
        # clause — re-project when the two differ
        perm: List[int] = []
        for pi, lo, hi in decl_segments:
            base = current_offsets[pi]
            perm.extend(range(base + lo, base + hi))
        if perm != list(range(len(current.scope.fields))):
            fields = tuple(current.node.fields[c] for c in perm)
            exprs = tuple(
                ir.InputRef(c, current.node.fields[c].type) for c in perm
            )
            node = P.ProjectNode(current.node, exprs, fields)
            scope = Scope([current.scope.fields[c] for c in perm])
            current = RelationItem(node, scope, current.rows)
        builder = Builder(current.node, current.scope)
        # any pending equi edges not used as keys become filters
        for a, b_, ia, ib in pending_edges:
            leftovers.append(ast.BinaryOp("eq", ia, ib))
        return builder, leftovers

    def _join_items(self, current, offsets, items, new_idx, edges):
        """Hash-join `current` (accumulated) with items[new_idx]; smaller
        side becomes the build side (the CostCalculator-lite rule)."""
        new = items[new_idx]
        cur_keys: List[int] = []
        new_keys: List[int] = []
        for a, b_, ia, ib in edges:
            if a in offsets:
                cur_ident, new_ident = ia, ib
            else:
                cur_ident, new_ident = ib, ia
            cur_keys.append(current.scope.resolve(cur_ident.parts)[0])
            new_keys.append(new.scope.resolve(new_ident.parts)[0])
        if not edges:
            # cross join: build = new side
            node = P.JoinNode(
                "cross", current.node, new.node, (), (), None,
                current.node.fields + new.node.fields,
            )
            scope = Scope.concat(current.scope, new.scope)
            item = RelationItem(node, scope, current.rows * max(new.rows, 1.0))
            offsets = dict(offsets)
            offsets[new_idx] = len(current.scope)
            return item, offsets
        if new.rows <= current.rows:
            # probe = current, build = new
            node = P.JoinNode(
                "inner", current.node, new.node,
                tuple(cur_keys), tuple(new_keys), None,
                current.node.fields + new.node.fields,
            )
            scope = Scope.concat(current.scope, new.scope)
            offsets = dict(offsets)
            offsets[new_idx] = len(current.scope)
        else:
            # probe = new, build = current (swap sides)
            node = P.JoinNode(
                "inner", new.node, current.node,
                tuple(new_keys), tuple(cur_keys), None,
                new.node.fields + current.node.fields,
            )
            scope = Scope.concat(new.scope, current.scope)
            shift = len(new.scope)
            offsets = {k: v + shift for k, v in offsets.items()}
            offsets[new_idx] = 0
        rows = max(current.rows, new.rows)
        return RelationItem(node, scope, rows), offsets

    def _items_of(self, e: ast.Expression, items) -> Optional[Set[int]]:
        owners: Set[int] = set()
        for ident in _idents(e):
            hit = None
            for i, item in enumerate(items):
                r = item.scope.try_resolve(ident.parts)
                if r is not None:
                    if hit is not None:
                        raise AnalysisError(f"column '{ident}' is ambiguous")
                    hit = i
            if hit is None:
                return None  # outer reference or unknown
            owners.add(hit)
        return owners

    def _equi_edge(self, c, items):
        if not (isinstance(c, ast.BinaryOp) and c.op == "eq"):
            return None
        if not (isinstance(c.left, ast.Identifier) and isinstance(c.right, ast.Identifier)):
            return None
        la = self._items_of(c.left, items)
        ra = self._items_of(c.right, items)
        if la is None or ra is None or len(la) != 1 or len(ra) != 1:
            return None
        a, b = next(iter(la)), next(iter(ra))
        if a == b:
            return None
        return (a, b, c.left, c.right)

    def _collect_relations(self, rel: ast.Relation, items, conjunct_pool, ctes):
        if isinstance(rel, ast.UnnestRelation) and all(
            isinstance(a, ast.Identifier) for a in rel.arrays
        ):
            # lateral UNNEST over columns of a sibling relation:
            # deferred until every FROM item is planned
            # (_resolve_lateral_unnests)
            items.append(_DeferredUnnest(rel))
            return
        if isinstance(rel, ast.Join):
            if rel.kind == "cross":
                self._collect_relations(rel.left, items, conjunct_pool, ctes)
                self._collect_relations(rel.right, items, conjunct_pool, ctes)
                return
            if rel.kind == "inner":
                self._collect_relations(rel.left, items, conjunct_pool, ctes)
                self._collect_relations(rel.right, items, conjunct_pool, ctes)
                if rel.condition is not None:
                    conjunct_pool.extend(split_conjuncts(rel.condition))
                for col in rel.using:
                    raise AnalysisError("USING not yet supported")
                return
            # outer joins: plan as one composite item
            items.append(self._plan_outer_join(rel, ctes))
            return
        items.append(self._plan_relation_leaf(rel, ctes))

    def _plan_outer_join(self, rel: ast.Join, ctes) -> RelationItem:
        left_items: List[RelationItem] = []
        pool: List[ast.Expression] = []
        self._collect_relations(rel.left, left_items, pool, ctes)
        if len(left_items) == 1 and not pool:
            left = left_items[0]
        else:
            # composite left side (a join tree feeding the outer join —
            # the q72 shape): assemble it with the shared greedy-join
            # machinery, leftovers become pre-join filters
            lb, leftovers = self._assemble_items(left_items, pool)
            for c in leftovers:
                lb.filter(ExprConverter(lb.scope).convert(c))
            left = RelationItem(lb.node, lb.scope, 1000.0)
        right = self._plan_relation_leaf_any(rel.right, ctes)
        swapped = rel.kind == "right"
        if swapped:
            # RIGHT join plans as LEFT with sides swapped (the reference
            # does the same in RelationPlanner); the output projection
            # below restores declared column order
            left, right = right, left
        lkeys: List[int] = []
        rkeys: List[int] = []
        residuals: List[ast.Expression] = []
        for c in split_conjuncts(rel.condition):
            if isinstance(c, ast.BinaryOp) and c.op == "eq" and isinstance(
                c.left, ast.Identifier
            ) and isinstance(c.right, ast.Identifier):
                l_hit = left.scope.try_resolve(c.left.parts)
                r_hit = right.scope.try_resolve(c.right.parts)
                if l_hit is not None and r_hit is not None:
                    lkeys.append(l_hit[0])
                    rkeys.append(r_hit[0])
                    continue
                l_hit2 = left.scope.try_resolve(c.right.parts)
                r_hit2 = right.scope.try_resolve(c.left.parts)
                if l_hit2 is not None and r_hit2 is not None:
                    lkeys.append(l_hit2[0])
                    rkeys.append(r_hit2[0])
                    continue
            residuals.append(c)
        residual_ir = None
        if residuals:
            conv = ExprConverter(Scope.concat(left.scope, right.scope))
            residual_ir = ir.and_(*[conv.convert(c) for c in residuals])
        kind = "full" if rel.kind == "full" else "left"
        node = P.JoinNode(
            kind, left.node, right.node, tuple(lkeys), tuple(rkeys),
            residual_ir, left.node.fields + right.node.fields,
        )
        item = RelationItem(
            node, Scope.concat(left.scope, right.scope), max(left.rows, right.rows)
        )
        if swapped:
            # restore declared column order (probe side was moved left)
            w_r = len(left.scope.fields)  # right relation is now probe
            perm = list(range(w_r, w_r + len(right.scope.fields))) + list(
                range(w_r)
            )
            exprs = tuple(
                ir.InputRef(c, node.fields[c].type) for c in perm
            )
            fields = tuple(node.fields[c] for c in perm)
            scope = Scope([item.scope.fields[c] for c in perm])
            item = RelationItem(
                P.ProjectNode(node, exprs, fields), scope, item.rows
            )
        return item

    def _plan_relation_leaf_any(self, rel, ctes) -> RelationItem:
        items: List[RelationItem] = []
        pool: List[ast.Expression] = []
        self._collect_relations(rel, items, pool, ctes)
        # single-item requirement => segments are always in order here
        items, _ = self._resolve_lateral_unnests(items)
        if len(items) != 1 or pool:
            raise AnalysisError("nested join tree not yet supported here")
        return items[0]

    def _resolve_lateral_unnests(self, items):
        """Fold _DeferredUnnest markers (UNNEST over column references,
        `FROM t, UNNEST(t.arr)`) into their source items as UnnestNodes
        — the reference's correlated-unnest planning
        (RelationPlanner.planJoinUnnest).

        Returns (physical_items, segments): `segments` lists, in FROM
        declaration order, (physical_idx, field_lo, field_hi) ranges so
        the caller can re-project the assembled join back to declaration
        order — the unnest's columns belong at the MARKER's position in
        SELECT *, not at the end of its owner's columns."""
        out = [it for it in items if not isinstance(it, _DeferredUnnest)]
        # declaration-ordered slots; marker slots are patched as folded
        segments: List = []
        slot_of_marker: Dict[int, int] = {}
        phys = 0
        for i, it in enumerate(items):
            if isinstance(it, _DeferredUnnest):
                slot_of_marker[i] = len(segments)
                segments.append(None)
            else:
                segments.append((phys, 0, len(it.scope.fields)))
                phys += 1
        markers = [
            (i, it) for i, it in enumerate(items)
            if isinstance(it, _DeferredUnnest)
        ]
        if not markers:
            return items, segments
        for marker_pos, marker in markers:
            rel = marker.rel
            # locate the single source item owning every referenced column
            owner_idx = None
            channels: List[int] = []
            elem_types: List[T.DataType] = []
            for e in rel.arrays:
                hit = None
                for j, it in enumerate(out):
                    r = it.scope.try_resolve(e.parts)
                    if r is not None:
                        if hit is not None:
                            raise AnalysisError(
                                f"UNNEST argument '{e}' is ambiguous"
                            )
                        hit = (j, r[0], r[1])
                if hit is None:
                    raise AnalysisError(
                        f"UNNEST argument '{e}' not found (constant"
                        " arrays and array columns are supported)"
                    )
                j, ch, t = hit
                if not t.is_array:
                    raise AnalysisError(
                        f"UNNEST argument '{e}' is {t}, not an array"
                    )
                if owner_idx is None:
                    owner_idx = j
                elif owner_idx != j:
                    raise AnalysisError(
                        "UNNEST arguments must come from one relation"
                    )
                channels.append(ch)
                elem_types.append(t.element)
            src = out[owner_idx]
            n_new = len(channels) + (1 if rel.ordinality else 0)
            names = list(rel.column_aliases) if rel.column_aliases else [
                f"_col{i}" for i in range(n_new)
            ]
            if len(names) != n_new:
                raise AnalysisError(
                    f"UNNEST alias has {len(names)} columns,"
                    f" produces {n_new}"
                )
            new_fields = [
                P.Field(nm, t) for nm, t in zip(names, elem_types)
            ]
            if rel.ordinality:
                new_fields.append(P.Field(names[-1], T.BIGINT))
            node = P.UnnestNode(
                src.node,
                tuple(channels),
                rel.ordinality,
                src.node.fields + tuple(new_fields),
            )
            scope = Scope(
                src.scope.fields
                + [
                    ScopeField(rel.alias, f.name, f.type)
                    for f in new_fields
                ]
            )
            w_before = len(src.scope.fields)
            segments[slot_of_marker[marker_pos]] = (
                owner_idx, w_before, w_before + len(new_fields)
            )
            out[owner_idx] = RelationItem(node, scope, src.rows * 3.0)
        return out, segments

    def _plan_relation_leaf(self, rel: ast.Relation, ctes) -> RelationItem:
        if isinstance(rel, ast.TableRef):
            name = rel.name
            if len(name) == 1 and name[0] in ctes:
                w = ctes[name[0]]
                inner_ctes = {k: v for k, v in ctes.items() if k != name[0]}
                node, scope, names = self.plan_query(w.query, inner_ctes)
                out_names = list(w.column_names) if w.column_names else names
                qual = rel.alias or name[0]
                sc = Scope(
                    [
                        ScopeField(qual, n, f.type)
                        for n, f in zip(out_names, node.fields)
                    ]
                )
                return RelationItem(node, sc, 1000.0)
            return self._plan_table(rel)
        if isinstance(rel, ast.UnnestRelation):
            return self._plan_unnest(rel)
        if isinstance(rel, ast.TableFunctionRelation):
            return self._plan_table_function(rel, ctes)
        if isinstance(rel, ast.MatchRecognizeRelation):
            return self._plan_match_recognize(rel, ctes)
        if isinstance(rel, ast.SubqueryRelation):
            node, scope, names = self.plan_query(rel.query, ctes)
            if rel.column_aliases:
                if len(rel.column_aliases) != len(node.fields):
                    raise AnalysisError(
                        f"column alias list has {len(rel.column_aliases)} "
                        f"names but relation has {len(node.fields)} columns"
                    )
                names = list(rel.column_aliases)
            sc = Scope(
                [ScopeField(rel.alias, n, f.type) for n, f in zip(names, node.fields)]
            )
            return RelationItem(node, sc, 1000.0)
        raise AnalysisError(f"unsupported relation {type(rel).__name__}")

    def _plan_unnest(self, rel: ast.UnnestRelation) -> RelationItem:
        """UNNEST over constant arrays (ARRAY[...] literals and
        sequence(...)) — the UnnestOperator's surface
        (main/operator/unnest/UnnestOperator.java) for the array values
        this engine can hold; array-typed COLUMNS need the nested
        column representation (offsets + flat values), planned work.
        Multiple arrays zip positionally, short ones padded with NULL
        (Trino's multi-argument UNNEST semantics)."""
        columns = []
        for e in rel.arrays:
            vals = _const_array_values(e)
            if vals is None:
                raise AnalysisError(
                    "UNNEST supports constant arrays (ARRAY[...] /"
                    " sequence(...)); array-typed columns are not yet"
                    " representable"
                )
            columns.append(vals)
        n = max((len(c) for c in columns), default=0)
        col_types = [_array_element_type(c) for c in columns]
        rows = []
        for i in range(n):
            row = [
                (c[i].value if i < len(c) else None) for c in columns
            ]
            if rel.ordinality:
                row.append(i + 1)
            rows.append(tuple(row))
        if rel.ordinality:
            col_types.append(T.BIGINT)
        names = list(rel.column_aliases) if rel.column_aliases else [
            f"_col{i}" for i in range(len(col_types))
        ]
        if len(names) != len(col_types):
            raise AnalysisError(
                f"UNNEST alias has {len(names)} columns, produces {len(col_types)}"
            )
        fields = tuple(P.Field(nm, t) for nm, t in zip(names, col_types))
        node = P.ValuesNode(fields, tuple(rows))
        scope = Scope(
            [ScopeField(rel.alias, nm, t) for nm, t in zip(names, col_types)]
        )
        return RelationItem(node, scope, float(max(n, 1)))

    @staticmethod
    def _pattern_vars(node) -> Set[str]:
        return _pattern_var_names(node)

    def _plan_match_recognize(
        self, rel: ast.MatchRecognizeRelation, ctes
    ) -> RelationItem:
        """Row pattern recognition (StatementAnalyzer's
        analyzePatternRecognition — SURVEY.md §2.6). Supported subset:
        ONE ROW PER MATCH; DEFINE conditions over current-row columns
        and PREV/NEXT(col [, n]) (vectorized as shifted columns —
        references to OTHER variables' rows, e.g. LAST(A.price) inside
        DEFINE, need running match state and are rejected); measures
        FIRST/LAST(var.col), var.col, MATCH_NUMBER(), CLASSIFIER()."""
        if rel.rows_per_match != "one":
            raise AnalysisError(
                "only ONE ROW PER MATCH is supported"
            )
        item = self._plan_relation_leaf_any(rel.input, ctes)
        scope = item.scope
        pattern_vars = _pattern_var_names(rel.pattern)
        define_vars = {v.lower() for v, _ in rel.defines}
        for v in define_vars:
            if v not in pattern_vars:
                raise AnalysisError(
                    f"DEFINE variable '{v}' does not appear in PATTERN"
                )

        def channel_of(e: ast.Expression) -> int:
            if not isinstance(e, ast.Identifier):
                raise AnalysisError(
                    "MATCH_RECOGNIZE partition/order items must be columns"
                )
            return scope.resolve(e.parts)[0]

        partition_channels = tuple(channel_of(e) for e in rel.partition_by)
        order_keys = tuple(
            SortKey(channel_of(s.expr), s.descending)
            for s in rel.order_by
        )
        # -- DEFINE conditions -> ir over the extended schema --
        shifts: List[Tuple[int, int]] = []  # (channel, roll offset)
        shift_index: Dict[Tuple[int, int], int] = {}
        base_width = len(scope.fields)

        def shifted_field(ch: int, off: int) -> ast.Identifier:
            key = (ch, off)
            if key not in shift_index:
                shift_index[key] = len(shifts)
                shifts.append(key)
            return ast.Identifier((f"__shift{shift_index[key]}",))

        def rewrite(e: ast.Expression, var: str) -> ast.Expression:
            if isinstance(e, ast.Identifier):
                if len(e.parts) == 2 and e.parts[0].lower() in pattern_vars:
                    if e.parts[0].lower() != var:
                        raise AnalysisError(
                            f"DEFINE {var.upper()}: references to other"
                            f" variables' rows ({e.parts[0]}.{e.parts[1]})"
                            " are not supported — use PREV/NEXT navigation"
                        )
                    return ast.Identifier((e.parts[1],))
                return e
            if isinstance(e, ast.FunctionCall) and e.name.lower() in (
                "prev", "next"
            ):
                if not e.args or not isinstance(e.args[0], ast.Identifier):
                    raise AnalysisError(
                        f"{e.name}() supports a column reference argument"
                    )
                inner = rewrite(e.args[0], var)
                ch = scope.resolve(inner.parts)[0]
                n = 1
                if len(e.args) > 1:
                    if not isinstance(e.args[1], ast.NumberLiteral):
                        raise AnalysisError(
                            f"{e.name}() offset must be a number literal"
                        )
                    n = int(e.args[1].text)
                off = n if e.name.lower() == "prev" else -n
                return shifted_field(ch, off)
            # rebuild recursively over dataclass fields
            import dataclasses as _dc

            if _dc.is_dataclass(e) and isinstance(e, ast.Node):
                changes = {}
                for f in _dc.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, ast.Expression):
                        changes[f.name] = rewrite(v, var)
                    elif isinstance(v, tuple) and v and isinstance(
                        v[0], ast.Expression
                    ):
                        changes[f.name] = tuple(rewrite(x, var) for x in v)
                if changes:
                    return _dc.replace(e, **changes)
            return e

        # conversions happen against an extended scope that appends one
        # pseudo-column per distinct (channel, offset)
        defines_ir: List[Tuple[str, ir.Expr]] = []
        rewritten = [
            (v.lower(), rewrite(cond, v.lower())) for v, cond in rel.defines
        ]
        ext_fields = list(scope.fields)
        for i, (ch, _off) in enumerate(shifts):
            ext_fields.append(
                ScopeField(None, f"__shift{i}", scope.fields[ch].type)
            )
        ext_scope = Scope(ext_fields)
        for v, cond in rewritten:
            conv = ExprConverter(ext_scope)
            pred = conv.convert(cond)
            if pred.type.kind != T.TypeKind.BOOLEAN:
                raise AnalysisError(
                    f"DEFINE {v.upper()} must be a boolean condition"
                )
            defines_ir.append((v, pred))
        # -- measures --
        measures: List[P.MeasureSpec] = []
        for mi in rel.measures:
            e = mi.expr
            if isinstance(e, ast.FunctionCall) and e.name.lower() in (
                "match_number", "classifier"
            ):
                kind = e.name.lower()
                measures.append(P.MeasureSpec(
                    kind, mi.name,
                    T.BIGINT if kind == "match_number" else T.VARCHAR,
                ))
                continue
            kind = "last"
            if isinstance(e, ast.FunctionCall) and e.name.lower() in (
                "first", "last"
            ):
                kind = e.name.lower()
                if len(e.args) != 1:
                    raise AnalysisError(f"{e.name}() takes one argument")
                e = e.args[0]
            if not isinstance(e, ast.Identifier):
                raise AnalysisError(
                    "measures support FIRST/LAST(var.col), var.col,"
                    " MATCH_NUMBER() and CLASSIFIER()"
                )
            var = None
            parts = e.parts
            if len(parts) == 2 and parts[0].lower() in pattern_vars:
                var = parts[0].lower()
                parts = (parts[1],)
            ch, t = scope.resolve(parts)
            measures.append(P.MeasureSpec(kind, mi.name, t, var, ch))
        # -- output schema: partition columns + measures --
        out_fields: List[P.Field] = []
        out_scope_fields: List[ScopeField] = []
        for ch in partition_channels:
            f = scope.fields[ch]
            out_fields.append(P.Field(f.name, f.type))
            out_scope_fields.append(ScopeField(rel.alias, f.name, f.type))
        for m in measures:
            out_fields.append(P.Field(m.name, m.out_type))
            out_scope_fields.append(
                ScopeField(rel.alias, m.name, m.out_type)
            )
        node = P.MatchRecognizeNode(
            item.node,
            partition_channels,
            order_keys,
            tuple(defines_ir),
            tuple(shifts),
            rel.pattern,
            tuple(measures),
            rel.after_match,
            tuple(out_fields),
        )
        return RelationItem(node, Scope(out_scope_fields), item.rows / 4.0)

    def _plan_table_function(
        self, rel: ast.TableFunctionRelation, ctes
    ) -> RelationItem:
        """FROM TABLE(fn(...)) — polymorphic table functions
        (spi/ptf/ConnectorTableFunction.java surface). Built-ins
        `sequence` and `exclude_columns` are engine-side
        (the reference's io.trino.operator.table.Sequence /
        ExcludeColumns); other names resolve to the connector's
        TableFunction registry and evaluate at plan time over literal
        arguments."""
        fn_name = rel.name[-1].lower()
        # assemble arguments: positional list + named dict
        named: Dict[str, ast.Expression] = {
            k.lower(): v for k, v in rel.named_args
        }

        def scalar(e) -> object:
            if e is None:
                raise AnalysisError(
                    f"table function {fn_name}(): missing required argument"
                )
            conv = ExprConverter(Scope([]))
            lit = conv.convert(e)
            if not isinstance(lit, ir.Literal):
                raise AnalysisError(
                    f"table function {fn_name}() arguments must be"
                    " constants"
                )
            return lit.value

        if fn_name == "sequence" and len(rel.name) == 1:
            args = list(rel.args)
            start = scalar(named.get("start", args[0] if args else None))
            stop = scalar(named.get("stop", args[1] if len(args) > 1 else None))
            step_e = named.get("step", args[2] if len(args) > 2 else None)
            step = scalar(step_e) if step_e is not None else 1
            if step == 0:
                raise AnalysisError("sequence() step must not be zero")
            start, stop, step = int(start), int(stop), int(step)
            count = max(0, (stop - start) // step + 1)
            if count > 10_000_000:
                # plan-time materialization cap (the reference streams
                # this function; a runaway range must not OOM analysis)
                raise AnalysisError(
                    f"sequence() would produce {count} rows"
                    " (limit 10000000)"
                )
            vals = list(range(start, stop + (1 if step > 0 else -1), step))
            names = list(rel.column_aliases) or ["sequential_number"]
            fields = (P.Field(names[0], T.BIGINT),)
            node = P.ValuesNode(fields, tuple((v,) for v in vals))
            scope = Scope([ScopeField(rel.alias, names[0], T.BIGINT)])
            return RelationItem(node, scope, float(max(len(vals), 1)))
        if fn_name == "exclude_columns" and len(rel.name) == 1:
            args = list(rel.args)
            tbl = named.get("input", args[0] if args else None)
            desc = named.get("columns", args[1] if len(args) > 1 else None)
            if not isinstance(tbl, ast.TableArg) or not isinstance(
                desc, ast.Descriptor
            ):
                raise AnalysisError(
                    "exclude_columns(input => TABLE(...), columns =>"
                    " DESCRIPTOR(...))"
                )
            item = self._plan_relation_leaf_any(tbl.relation, ctes)
            drop = {n.lower() for n in desc.names}
            keep = [
                (i, f)
                for i, f in enumerate(item.scope.fields)
                if (f.name or "").lower() not in drop
            ]
            missing = drop - {
                (f.name or "").lower() for f in item.scope.fields
            }
            if missing:
                raise AnalysisError(
                    f"exclude_columns: no such columns {sorted(missing)}"
                )
            if not keep:
                raise AnalysisError("exclude_columns removed every column")
            exprs = tuple(ir.InputRef(i, f.type) for i, f in keep)
            fields = tuple(
                P.Field(f.name, f.type) for _, f in keep
            )
            node = P.ProjectNode(item.node, exprs, fields)
            scope = Scope(
                [ScopeField(rel.alias, f.name, f.type) for _, f in keep]
            )
            return RelationItem(node, scope, item.rows)
        # connector-provided table function
        catalog = rel.name[0] if len(rel.name) > 1 else self.catalog
        try:
            conn = self.catalogs.get(catalog)
        except KeyError:
            raise AnalysisError(f"unknown catalog '{catalog}'")
        tf = conn.table_functions.get(fn_name)
        if tf is None:
            raise AnalysisError(
                f"unknown table function {'.'.join(rel.name)}()"
            )
        call_args = {k: scalar(v) for k, v in named.items()}
        for i, a in enumerate(rel.args):
            call_args[f"_{i}"] = scalar(a)
        columns, rows = tf.fn(call_args)
        names = (
            list(rel.column_aliases)
            if rel.column_aliases
            else [c.name for c in columns]
        )
        if len(names) != len(columns):
            raise AnalysisError(
                f"alias has {len(names)} columns, function produces"
                f" {len(columns)}"
            )
        fields = tuple(
            P.Field(nm, c.type) for nm, c in zip(names, columns)
        )
        node = P.ValuesNode(fields, tuple(tuple(r) for r in rows))
        scope = Scope(
            [
                ScopeField(rel.alias, nm, c.type)
                for nm, c in zip(names, columns)
            ]
        )
        return RelationItem(node, scope, float(max(len(rows), 1)))

    def _plan_table(self, rel: ast.TableRef) -> RelationItem:
        parts = rel.name
        if len(parts) == 1:
            catalog, schema, table = self.catalog, self.schema, parts[0]
        elif len(parts) == 2:
            catalog, schema, table = self.catalog, parts[0], parts[1]
        else:
            catalog, schema, table = parts
        conn, handle = self.catalogs.resolve_table(catalog, schema, table)
        meta = conn.metadata.get_table_metadata(handle)
        columns = tuple(c.name for c in meta.columns)
        fields = tuple(P.Field(c.name, c.type) for c in meta.columns)
        node = P.ScanNode(catalog, handle, columns, fields)
        qual = rel.alias or table
        scope = Scope([ScopeField(qual, c.name, c.type) for c in meta.columns])
        stats = conn.metadata.get_table_statistics(handle)
        rows = stats.row_count or 1000.0
        return RelationItem(node, scope, rows)

    # ---- predicates with subqueries ----
    def _plan_predicate(self, builder: Builder, e: ast.Expression, ctes) -> None:
        for conj in split_conjuncts(e):
            if isinstance(conj, ast.Exists):
                self._plan_exists(builder, conj.query, conj.negated, ctes)
                continue
            if (
                isinstance(conj, ast.UnaryOp)
                and conj.op == "not"
                and isinstance(conj.operand, ast.Exists)
            ):
                self._plan_exists(builder, conj.operand.query, True, ctes)
                continue
            if isinstance(conj, ast.InSubquery):
                self._plan_in_subquery(builder, conj, ctes)
                continue
            # general positions: EXISTS/IN under OR or NOT, scalar
            # subqueries anywhere in the conjunct — mark joins +
            # replacement channels
            self._plan_embedded_subqueries(builder, conj, ctes)
            pred = builder.converter().convert(conj)
            builder.filter(pred)

    def _plan_exists(self, builder: Builder, q: ast.Query, negated: bool, ctes) -> None:
        if not isinstance(q.body, ast.QuerySpec) or q.body.group_by or q.with_:
            raise AnalysisError("EXISTS subquery too complex")
        spec = q.body
        inner_items: List[RelationItem] = []
        pool: List[ast.Expression] = []
        self._collect_relations(spec.from_, inner_items, pool, ctes)
        pool.extend(split_conjuncts(spec.where))
        (
            inner,
            probe_keys,
            build_keys,
            residuals,
        ) = self._decorrelate(builder, inner_items, pool)
        residual_ir = None
        if residuals:
            conv = ExprConverter(Scope.concat(builder.scope, inner.scope))
            residual_ir = ir.and_(*[conv.convert(c) for c in residuals])
        kind = "anti" if negated else "semi"
        builder.node = P.JoinNode(
            kind, builder.node, inner.node,
            tuple(probe_keys), tuple(build_keys), residual_ir, builder.node.fields,
        )
        # scope unchanged: semi/anti output = probe columns

    def _decorrelate(self, builder: Builder, inner_items, pool,
                     filter_outer: bool = True):
        """Assemble the subquery side and split its conjuncts into inner
        filters / correlation equi keys / cross-scope residuals.

        `filter_outer=False` (mark joins): outer-only conjuncts become
        RESIDUALS instead of filters on the outer query — a mark join
        must preserve outer cardinality, so an outer-only predicate may
        only flip match flags, never delete outer rows."""
        inner_filters: List[ast.Expression] = []
        corr_pairs: List[Tuple[ast.Identifier, ast.Identifier]] = []
        residuals: List[ast.Expression] = []
        inner_scope_probe = Scope(
            [f for it in inner_items for f in it.scope.fields]
        )
        for c in pool:
            if _has_subquery(c):
                raise AnalysisError("nested subquery inside EXISTS not supported")
            refs_inner = refs_outer = False
            for ident in _idents(c):
                if inner_scope_probe.try_resolve(ident.parts) is not None:
                    refs_inner = True
                elif builder.scope.try_resolve(ident.parts) is not None:
                    refs_outer = True
                else:
                    raise AnalysisError(f"cannot resolve {ident}")
            if refs_outer and not refs_inner:
                if filter_outer:
                    # conjunct-position EXISTS: outer-only predicate
                    # inside the subquery filters the outer query
                    self._plan_predicate(builder, c, {})
                else:
                    residuals.append(c)
                continue
            if not refs_outer:
                inner_filters.append(c)
                continue
            if (
                isinstance(c, ast.BinaryOp)
                and c.op == "eq"
                and isinstance(c.left, ast.Identifier)
                and isinstance(c.right, ast.Identifier)
            ):
                l_inner = inner_scope_probe.try_resolve(c.left.parts)
                r_inner = inner_scope_probe.try_resolve(c.right.parts)
                if l_inner is None and r_inner is not None:
                    corr_pairs.append((c.left, c.right))
                    continue
                if r_inner is None and l_inner is not None:
                    corr_pairs.append((c.right, c.left))
                    continue
            residuals.append(c)

        # assemble the inner side with its own greedy join order
        inner_builder, inner_leftovers = self._assemble_items(
            inner_items, inner_filters
        )
        for c in inner_leftovers:
            pred = ExprConverter(inner_builder.scope).convert(c)
            inner_builder.filter(pred)
        inner = RelationItem(inner_builder.node, inner_builder.scope, 0.0)
        probe_keys = [builder.scope.resolve(o.parts)[0] for o, _ in corr_pairs]
        build_keys = [inner.scope.resolve(i.parts)[0] for _, i in corr_pairs]
        return inner, probe_keys, build_keys, residuals

    def _assemble_items(self, items, conjuncts) -> Tuple[Builder, List[ast.Expression]]:
        """Greedy-join a prepared item list with a conjunct pool (shared
        by FROM planning and subquery decorrelation)."""
        spec_like_pool = list(conjuncts)
        leftovers: List[ast.Expression] = []
        item_filters: Dict[int, List[ast.Expression]] = {
            i: [] for i in range(len(items))
        }
        join_edges = []
        for c in spec_like_pool:
            owners = self._items_of(c, items)
            if owners is None:
                leftovers.append(c)
                continue
            if len(owners) == 1:
                item_filters[next(iter(owners))].append(c)
                continue
            edge = self._equi_edge(c, items)
            if edge is not None:
                join_edges.append(edge)
            else:
                leftovers.append(c)
        for i, item in enumerate(items):
            if item_filters[i]:
                conv = ExprConverter(item.scope)
                pred = ir.and_(*[conv.convert(c) for c in item_filters[i]])
                item.node = P.FilterNode(item.node, pred, item.node.fields)
                item.rows = max(item.rows / 3.0, 1.0)
        joined = [0]
        current = items[0]
        offsets = {0: 0}
        pending = list(join_edges)
        while len(joined) < len(items):
            candidates: Dict[int, List] = {}
            for e in pending:
                a, b_, _, _ = e
                if (a in joined) != (b_ in joined):
                    new = b_ if a in joined else a
                    candidates.setdefault(new, []).append(e)
            if candidates:
                new = min(candidates, key=lambda i: items[i].rows)
                edges = candidates[new]
            else:
                remaining = [i for i in range(len(items)) if i not in joined]
                new = min(remaining, key=lambda i: items[i].rows)
                edges = []
            current, offsets = self._join_items(current, offsets, items, new, edges)
            joined.append(new)
            pending = [e for e in pending if e not in edges]
        return Builder(current.node, current.scope), leftovers

    def _plan_in_subquery(self, builder: Builder, conj: ast.InSubquery, ctes) -> None:
        node, scope, _ = self.plan_query(conj.query, ctes)
        if len(node.fields) != 1:
            raise AnalysisError("IN subquery must return one column")
        value = conj.value
        if not isinstance(value, ast.Identifier):
            raise AnalysisError("IN (subquery) value must be a column")
        probe_ch, probe_t = builder.scope.resolve(value.parts)
        if not conj.negated:
            builder.node = P.JoinNode(
                "semi", builder.node, node, (probe_ch,), (0,), None,
                builder.node.fields,
            )
            return
        # NULL-aware NOT IN. `x NOT IN S` is TRUE iff x matches nothing
        # in S, S contains no NULL (one NULL makes every non-match
        # UNKNOWN), and x itself is non-NULL — EXCEPT that S being empty
        # makes the predicate TRUE for every row, NULL x included.
        # Planned as: anti join (NULL probes survive: they match
        # nothing) -> cross join with ONE scalar aggregate of S giving
        # (count(*), count(col)) -> filter
        # (count(*) = count(col)) AND (x IS NOT NULL OR count(*) = 0).
        # The shape of Trino's null-aware semi-join rewrite family.
        # NOTE: the subquery appears twice (build side AND count
        # source), so it executes twice — shared-subtree materialization
        # (CTE reuse) is the planned fix. It is PLANNED twice so the two
        # uses are distinct subtrees: node identity doubles as the plan-
        # node id, and the structure validator rejects a DAG.
        builder.node = P.JoinNode(
            "anti", builder.node, node, (probe_ch,), (0,), None,
            builder.node.fields,
        )
        sub_t = node.fields[0].type
        count_source, _, _ = self.plan_query(conj.query, ctes)
        counts = P.AggregateNode(
            count_source,
            (),
            (
                P.AggCall("count_star", None, T.BIGINT),
                P.AggCall("count", 0, T.BIGINT),
            ),
            (P.Field(None, T.BIGINT), P.Field(None, T.BIGINT)),
        )
        total_ch = len(builder.scope)
        builder.node = P.JoinNode(
            "cross", builder.node, counts, (), (), None,
            builder.node.fields + counts.fields,
        )
        builder.scope = Scope(
            builder.scope.fields
            + [ScopeField(None, None, T.BIGINT), ScopeField(None, None, T.BIGINT)]
        )
        total = ir.InputRef(total_ch, T.BIGINT)
        nonnull = ir.InputRef(total_ch + 1, T.BIGINT)
        zero = ir.Literal(0, T.BIGINT)
        builder.filter(
            ir.and_(
                ir.comparison("eq", total, nonnull),
                ir.or_(
                    ir.not_(ir.is_null(ir.InputRef(probe_ch, probe_t))),
                    ir.comparison("eq", total, zero),
                ),
            )
        )

    def _plan_embedded_subqueries(self, builder: Builder, e, ctes) -> None:
        """Plan every subquery appearing in a GENERAL position inside
        `e` (under OR/NOT, in the SELECT list, in ORDER BY): scalar
        subqueries join as before; EXISTS/IN become MARK joins whose
        boolean channel replaces the subquery expression — the
        TransformExistsApplyToCorrelatedJoin / semiJoinOutput device
        (planner/iterative/rule/TransformExistsApplyToCorrelatedJoin
        .java, plan/SemiJoinNode.java)."""

        def walk(x):
            if isinstance(x, ast.ScalarSubquery):
                if x not in builder.replacements:
                    self._plan_scalar_subquery(builder, x, ctes)
                return
            if isinstance(x, (ast.Exists, ast.InSubquery)):
                self._plan_mark(builder, x, ctes)
                if isinstance(x, ast.InSubquery):
                    walk(x.value)
                return
            if dataclasses.is_dataclass(x):
                for f in dataclasses.fields(x):
                    walk(getattr(x, f.name))
            elif isinstance(x, tuple):
                for i in x:
                    walk(i)

        walk(e)

    def _plan_mark(self, builder: Builder, node, ctes) -> None:
        """EXISTS / IN in a general position -> mark join appending a
        BOOLEAN channel. Uncorrelated IN keeps full three-valued
        semantics ("mark"); EXISTS and correlated IN are two-valued
        ("mark_exists" — for correlated IN that collapses UNKNOWN to
        FALSE, exact in filter contexts where the two coincide)."""
        plain = dataclasses.replace(node, negated=False)
        if plain in builder.replacements:
            return
        ch = len(builder.scope)
        fields = builder.node.fields + (P.Field(None, T.BOOLEAN),)
        if isinstance(node, ast.Exists):
            q = node.query
            if not isinstance(q.body, ast.QuerySpec) or q.body.group_by \
                    or q.with_:
                raise AnalysisError("EXISTS subquery too complex")
            spec = q.body
            inner_items: List[RelationItem] = []
            pool: List[ast.Expression] = []
            self._collect_relations(spec.from_, inner_items, pool, ctes)
            pool.extend(split_conjuncts(spec.where))
            inner, probe_keys, build_keys, residuals = self._decorrelate(
                builder, inner_items, pool, filter_outer=False
            )
            residual_ir = None
            if residuals:
                conv = ExprConverter(
                    Scope.concat(builder.scope, inner.scope)
                )
                residual_ir = ir.and_(
                    *[conv.convert(c) for c in residuals]
                )
            builder.node = P.JoinNode(
                "mark_exists", builder.node, inner.node,
                tuple(probe_keys), tuple(build_keys), residual_ir, fields,
            )
        else:  # InSubquery
            value = node.value
            if not isinstance(value, ast.Identifier):
                raise AnalysisError(
                    "IN (subquery) value must be a column"
                )
            q = node.query
            correlated = self._query_is_correlated(builder, q, ctes)
            if not correlated:
                sub_node, _, _ = self.plan_query(q, ctes)
                if len(sub_node.fields) != 1:
                    raise AnalysisError(
                        "IN subquery must return one column"
                    )
                probe_ch, _ = builder.scope.resolve(value.parts)
                builder.node = P.JoinNode(
                    "mark", builder.node, sub_node,
                    (probe_ch,), (0,), None, fields,
                )
            else:
                # correlated IN: full three-valued semantics from THREE
                # two-valued marks (TransformCorrelatedInPredicateToJoin
                # decomposition): match = EXISTS(corr AND c = x);
                # null-in-set = EXISTS(corr AND c IS NULL);
                # nonempty = EXISTS(corr). IN is then
                # TRUE if match; NULL if null-in-set or (x IS NULL and
                # nonempty); else FALSE.
                if not isinstance(q.body, ast.QuerySpec) or \
                        q.body.group_by or q.with_:
                    raise AnalysisError(
                        "correlated IN subquery too complex"
                    )
                spec = q.body
                if len(spec.select) != 1 or isinstance(
                    spec.select[0].expr, ast.Star
                ):
                    raise AnalysisError(
                        "IN subquery must select one column"
                    )
                sel = spec.select[0].expr

                def add_mark(extra: Optional[ast.Expression],
                             match_value: bool = False) -> int:
                    mark_ch = len(builder.scope)
                    inner_items: List[RelationItem] = []
                    pool: List[ast.Expression] = []
                    self._collect_relations(
                        spec.from_, inner_items, pool, ctes
                    )
                    pool.extend(split_conjuncts(spec.where))
                    if extra is not None:
                        pool.append(extra)
                    inner, pk, bk, residuals = self._decorrelate(
                        builder, inner_items, pool, filter_outer=False
                    )
                    if match_value:
                        # the value = sel correlation passes as EXPLICIT
                        # key channels — injecting the equality into the
                        # pool would let an outer value identifier
                        # mis-resolve against a same-named inner column
                        if (
                            isinstance(sel, ast.Identifier)
                            and inner.scope.try_resolve(sel.parts)
                            is not None
                        ):
                            bk_ch = inner.scope.resolve(sel.parts)[0]
                        else:
                            # expression select item: project it onto a
                            # fresh inner channel and key-join on that
                            sel_ir = ExprConverter(
                                inner.scope
                            ).convert(sel)
                            bk_ch = len(inner.scope.fields)
                            exprs = tuple(
                                ir.InputRef(i, f.type)
                                for i, f in enumerate(inner.node.fields)
                            ) + (sel_ir,)
                            nf = inner.node.fields + (
                                P.Field(None, sel_ir.type),
                            )
                            inner = RelationItem(
                                P.ProjectNode(inner.node, exprs, nf),
                                Scope(
                                    inner.scope.fields
                                    + [ScopeField(
                                        None, None, sel_ir.type
                                    )]
                                ),
                                0.0,
                            )
                        pk = list(pk) + [
                            builder.scope.resolve(value.parts)[0]
                        ]
                        bk = list(bk) + [bk_ch]
                    residual_ir = None
                    if residuals:
                        conv = ExprConverter(
                            Scope.concat(builder.scope, inner.scope)
                        )
                        residual_ir = ir.and_(
                            *[conv.convert(c) for c in residuals]
                        )
                    builder.node = P.JoinNode(
                        "mark_exists", builder.node, inner.node,
                        tuple(pk), tuple(bk), residual_ir,
                        builder.node.fields + (P.Field(None, T.BOOLEAN),),
                    )
                    builder.scope = Scope(
                        builder.scope.fields
                        + [ScopeField(None, None, T.BOOLEAN)]
                    )
                    return mark_ch

                m_match = add_mark(None, match_value=True)
                m_null = add_mark(ast.IsNullPredicate(sel, False))
                m_any = add_mark(None)
                conv = builder.converter()
                v_ir = conv.convert(value)
                b = T.BOOLEAN
                in_ir = ir.Case(
                    (
                        ir.InputRef(m_match, b),
                        ir.or_(
                            ir.InputRef(m_null, b),
                            ir.and_(
                                ir.is_null(v_ir), ir.InputRef(m_any, b)
                            ),
                        ),
                    ),
                    (ir.Literal(True, b), ir.Literal(None, b)),
                    ir.Literal(False, b),
                    b,
                )
                # materialize the three-valued IN as a real channel
                ch = len(builder.scope)
                exprs = tuple(
                    ir.InputRef(i, f.type)
                    for i, f in enumerate(builder.node.fields)
                ) + (in_ir,)
                new_fields = builder.node.fields + (
                    P.Field(None, T.BOOLEAN),
                )
                builder.node = P.ProjectNode(
                    builder.node, exprs, new_fields
                )
                builder.scope = Scope(
                    builder.scope.fields
                    + [ScopeField(None, None, T.BOOLEAN)]
                )
                builder.replacements[plain] = (ch, T.BOOLEAN)
                return
        builder.scope = Scope(
            builder.scope.fields + [ScopeField(None, None, T.BOOLEAN)]
        )
        builder.replacements[plain] = (ch, T.BOOLEAN)

    def _query_is_correlated(self, builder: Builder, q: ast.Query,
                             ctes) -> bool:
        """Does the subquery reference the outer scope? (the
        classification probe shared with _plan_scalar_subquery)."""
        if not isinstance(q.body, ast.QuerySpec) or q.body.from_ is None:
            return False
        probe_items: List[RelationItem] = []
        pool: List[ast.Expression] = []
        self._collect_relations(q.body.from_, probe_items, pool, ctes)
        probe_scope = Scope(
            [f for it in probe_items for f in it.scope.fields]
        )
        for c in pool + split_conjuncts(q.body.where):
            for ident in _idents(c):
                if probe_scope.try_resolve(ident.parts) is None:
                    if builder.scope.try_resolve(ident.parts) is not None:
                        return True
        return False

    def _plan_scalar_subquery(self, builder: Builder, sub: ast.ScalarSubquery, ctes) -> None:
        q = sub.query
        # classify correlation by probing the subquery's FROM scopes
        correlated = False
        if isinstance(q.body, ast.QuerySpec) and q.body.from_ is not None:
            probe_items: List[RelationItem] = []
            pool: List[ast.Expression] = []
            self._collect_relations(q.body.from_, probe_items, pool, ctes)
            probe_scope = Scope([f for it in probe_items for f in it.scope.fields])
            for c in pool + split_conjuncts(q.body.where):
                for ident in _idents(c):
                    if probe_scope.try_resolve(ident.parts) is None:
                        if builder.scope.try_resolve(ident.parts) is not None:
                            correlated = True
        if not correlated:
            node, scope, _ = self.plan_query(q, ctes)
            if len(node.fields) != 1:
                raise AnalysisError("scalar subquery must return one column")
            # cardinality guard: zero rows must yield NULL (not drop the
            # outer rows) and >1 rows must raise — a global aggregate
            # always returns exactly one row, so it skips the guard
            probe = node
            while isinstance(probe, P.ProjectNode):
                probe = probe.child
            always_one = (
                isinstance(probe, P.AggregateNode)
                and not probe.group_channels
            )
            if not always_one:
                node = P.EnforceSingleRowNode(node, node.fields)
            ch = len(builder.scope)
            t = node.fields[0].type
            builder.node = P.JoinNode(
                "cross", builder.node, node, (), (), None,
                builder.node.fields + node.fields,
            )
            builder.scope = Scope(
                builder.scope.fields + [ScopeField(None, None, t)]
            )
            builder.replacements[sub] = (ch, t)
            return
        self._plan_correlated_scalar(builder, q, sub, ctes)

    def _plan_correlated_scalar(self, builder, q: ast.Query, sub, ctes) -> None:
        """Correlated scalar aggregate -> group the subquery by its
        correlation keys and LEFT-join (the TransformCorrelatedScalar-
        AggregationToJoin rule)."""
        if not isinstance(q.body, ast.QuerySpec) or q.body.group_by or q.with_:
            raise AnalysisError("unsupported correlated scalar subquery shape")
        spec = q.body
        if len(spec.select) != 1:
            raise AnalysisError("scalar subquery must select one expression")
        inner_items: List[RelationItem] = []
        pool: List[ast.Expression] = []
        self._collect_relations(spec.from_, inner_items, pool, ctes)
        pool.extend(split_conjuncts(spec.where))
        inner_scope_probe = Scope([f for it in inner_items for f in it.scope.fields])
        inner_filters: List[ast.Expression] = []
        corr_pairs: List[Tuple[ast.Identifier, ast.Identifier]] = []
        for c in pool:
            refs_outer = False
            for ident in _idents(c):
                if inner_scope_probe.try_resolve(ident.parts) is None:
                    if builder.scope.try_resolve(ident.parts) is not None:
                        refs_outer = True
                    else:
                        raise AnalysisError(f"cannot resolve {ident}")
            if not refs_outer:
                inner_filters.append(c)
                continue
            if (
                isinstance(c, ast.BinaryOp)
                and c.op == "eq"
                and isinstance(c.left, ast.Identifier)
                and isinstance(c.right, ast.Identifier)
            ):
                l_inner = inner_scope_probe.try_resolve(c.left.parts)
                r_inner = inner_scope_probe.try_resolve(c.right.parts)
                if l_inner is None and r_inner is not None:
                    corr_pairs.append((c.left, c.right))
                    continue
                if r_inner is None and l_inner is not None:
                    corr_pairs.append((c.right, c.left))
                    continue
            raise AnalysisError(
                "only equality correlation supported in scalar subqueries"
            )
        if not corr_pairs:
            raise AnalysisError("correlated scalar subquery without equi correlation")
        # synthetic query: SELECT <inner keys>..., <value> FROM ... GROUP BY keys
        key_idents = tuple(i for _, i in corr_pairs)
        synth_spec = ast.QuerySpec(
            select=tuple(ast.SelectItem(i) for i in key_idents)
            + (spec.select[0],),
            from_=spec.from_,
            where=conjoin(inner_filters),
            group_by=key_idents,
        )
        node, scope, _ = self.plan_query_spec(synth_spec, (), None, 0, ctes)
        k = len(key_idents)
        value_t = node.fields[k].type
        probe_keys = tuple(builder.scope.resolve(o.parts)[0] for o, _ in corr_pairs)
        ch = len(builder.scope) + k
        builder.node = P.JoinNode(
            "left", builder.node, node, probe_keys, tuple(range(k)), None,
            builder.node.fields + node.fields,
        )
        builder.scope = Scope(
            builder.scope.fields
            + [ScopeField(None, None, f.type) for f in node.fields]
        )
        builder.replacements[sub] = (ch, value_t)

    # ---- aggregation ----
    def _plan_aggregation(self, builder: Builder, group_asts, agg_calls, ctes) -> None:
        conv = builder.converter()
        key_irs = [conv.convert(g) for g in group_asts]
        pre_exprs: List[ir.Expr] = list(key_irs)
        aggs: List[P.AggCall] = []
        prim_cache: Dict[tuple, int] = {}

        def add_prim(kind, arg_ir, out_t, distinct=False) -> int:
            """Append one primitive accumulator, deduplicated
            structurally so composites sharing a moment (e.g. corr and
            covar_pop over the same pair) compute it once."""
            key = (kind, arg_ir, distinct)
            if key in prim_cache:
                return prim_cache[key]
            if arg_ir is None:
                spec = P.AggCall(kind, None, out_t, distinct)
            else:
                arg_ch = len(pre_exprs)
                pre_exprs.append(arg_ir)
                spec = P.AggCall(kind, arg_ch, out_t, distinct)
            aggs.append(spec)
            prim_cache[key] = len(aggs) - 1
            return len(aggs) - 1

        # per original call: ("plain", prim_idx) or ("comp", finisher, out_t)
        # where finisher(ref) builds the result expression from
        # ref(prim_idx) -> InputRef over the AggregateNode's output
        per_call: List[tuple] = []
        for call in agg_calls:
            kind = call.name
            distinct = call.distinct
            if kind == "count" and (
                not call.args or isinstance(call.args[0], ast.Star)
            ):
                per_call.append(
                    ("plain", add_prim("count_star", None, T.BIGINT))
                )
                continue
            if kind in COMPOSITE_AGG_FUNCS:
                per_call.append(
                    self._expand_composite_agg(call, conv, add_prim)
                )
                continue
            if kind == "approx_distinct":
                # exact distinct count through the holistic (gathered)
                # path: mixable with any other aggregates in one SELECT,
                # unlike the old lone-DISTINCT rewrite. The optional
                # max-standard-error argument is accepted and ignored
                # (exact answers satisfy any error bound).
                if len(call.args) not in (1, 2) or distinct:
                    raise AnalysisError(
                        "approx_distinct(x[, e]) takes one or two arguments"
                    )
                x = conv.convert(call.args[0])
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                aggs.append(P.AggCall("approx_distinct", x_ch, T.BIGINT))
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind in ("min_by", "max_by"):
                if len(call.args) != 2 or distinct:
                    raise AnalysisError(f"{kind}(x, y) takes two arguments")
                x = conv.convert(call.args[0])
                y = conv.convert(call.args[1])
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                y_ch = len(pre_exprs)
                pre_exprs.append(y)
                aggs.append(
                    P.AggCall(kind, x_ch, x.type, arg2_channel=y_ch)
                )
                per_call.append(("plain", len(aggs) - 1))
                continue
            if (
                kind in _SKETCH_ACCESSORS
                and call.args
                and isinstance(call.args[0], ast.FunctionCall)
                and call.args[0].name in _SKETCH_AGGS
            ):
                # fused accessor-over-sketch (see _find_agg_calls): the
                # accessor evaluates inside the collect finalizer where
                # the digest is a python string, sidestepping the
                # runtime-dictionary binding wall
                inner = call.args[0]
                if not inner.args:
                    raise AnalysisError(f"{inner.name}() arguments")
                x = conv.convert(inner.args[0])
                if inner.name == "merge":
                    if not x.type.is_string:
                        raise AnalysisError(
                            "merge() takes a serialized sketch"
                        )
                    canon = "sketch_merge"
                elif inner.name in ("tdigest_agg", "qdigest_agg"):
                    if x.type.kind != T.TypeKind.DOUBLE:
                        x = ir.Cast(x, T.DOUBLE)
                    canon = "tdigest_agg"
                else:
                    canon = "approx_set"
                if kind == "cardinality":
                    if canon == "tdigest_agg":
                        raise AnalysisError(
                            "cardinality() reads HyperLogLog sketches"
                        )
                    post, out_t, qv = "card", T.BIGINT, None
                else:
                    if canon == "approx_set":
                        raise AnalysisError(
                            f"{kind}() reads t-digest sketches"
                        )
                    if len(call.args) != 2:
                        raise AnalysisError(f"{kind}(d, q) arguments")
                    q = _const_fold(conv.convert(call.args[1]))
                    if q is None or q.value is None:
                        raise AnalysisError(
                            f"{kind}() argument must be a constant"
                        )
                    if kind == "values_at_quantiles":
                        qv = tuple(float(x) for x in q.value)
                        post = "vaq"
                        out_t = T.array_of(T.DOUBLE)
                    else:
                        # analyzer-level literals carry SQL values (the
                        # physical scaled-int form only exists in the
                        # binder)
                        qv = float(q.value)
                        post = "vq" if kind == "value_at_quantile" else "qv"
                        out_t = T.DOUBLE
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                aggs.append(P.AggCall(
                    canon, x_ch, out_t, param=qv, post=post
                ))
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind in ("approx_set", "tdigest_agg", "qdigest_agg",
                        "merge"):
                # sketch builders: HyperLogLog / TDigest serialized on
                # the varchar carrier (expr/pyfns digests; the reference
                # gives these first-class SPI types). approx_set's
                # optional max-error argument is accepted and ignored.
                max_args = {"approx_set": 2, "qdigest_agg": 3}.get(kind, 1)
                if not call.args or len(call.args) > max_args or distinct:
                    raise AnalysisError(f"{kind}() arguments")
                x = conv.convert(call.args[0])
                if kind == "merge":
                    if not x.type.is_string:
                        raise AnalysisError(
                            "merge() takes a serialized sketch"
                        )
                    canon = "sketch_merge"
                elif kind in ("tdigest_agg", "qdigest_agg"):
                    # one mergeable digest carrier serves both SQL
                    # sketch types (lib/trino-qdigest vs TDigest — the
                    # quantile API is identical; accuracy here is
                    # exact-collection grade either way)
                    if x.type.kind != T.TypeKind.DOUBLE:
                        x = ir.Cast(x, T.DOUBLE)
                    canon = "tdigest_agg"
                else:
                    canon = kind
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                aggs.append(P.AggCall(canon, x_ch, T.VARCHAR))
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind in ("array_agg", "histogram", "map_union",
                        "bitwise_and_agg", "bitwise_or_agg",
                        "bitwise_xor_agg"):
                if len(call.args) != 1 or distinct:
                    raise AnalysisError(f"{kind}(x) takes one argument")
                x = conv.convert(call.args[0])
                if kind == "array_agg":
                    out_t = T.array_of(x.type)
                elif kind == "histogram":
                    out_t = T.map_of(x.type, T.BIGINT)
                elif kind == "map_union":
                    if not x.type.is_map:
                        raise AnalysisError("map_union() aggregates maps")
                    out_t = x.type
                else:
                    if x.type.is_string or x.type.is_nested or \
                            x.type.kind == T.TypeKind.ARRAY:
                        raise AnalysisError(
                            f"{kind}() aggregates integer values"
                        )
                    out_t = T.BIGINT
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                aggs.append(P.AggCall(kind, x_ch, out_t))
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind in ("map_agg", "multimap_agg"):
                if len(call.args) != 2 or distinct:
                    raise AnalysisError(f"{kind}(k, v) takes two arguments")
                k = conv.convert(call.args[0])
                v = conv.convert(call.args[1])
                out_t = (T.map_of(k.type, v.type) if kind == "map_agg"
                         else T.map_of(k.type, T.array_of(v.type)))
                k_ch = len(pre_exprs)
                pre_exprs.append(k)
                v_ch = len(pre_exprs)
                pre_exprs.append(v)
                aggs.append(
                    P.AggCall(kind, k_ch, out_t, arg2_channel=v_ch)
                )
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind in ("numeric_histogram", "approx_most_frequent"):
                # (buckets, x[, capacity]) — buckets must be constant;
                # the trailing capacity argument is accepted and ignored
                # (the collect path is exact within the gathered rows)
                lo, hi = (2, 3)
                if not lo <= len(call.args) <= hi or distinct:
                    raise AnalysisError(
                        f"{kind}(buckets, x[, capacity]) arguments"
                    )
                b = _const_fold(conv.convert(call.args[0]))
                if b is None or b.value is None:
                    raise AnalysisError(
                        f"{kind}() bucket count must be a constant"
                    )
                if int(b.value) < 1:
                    raise AnalysisError(
                        f"{kind}() bucket count must be positive"
                    )
                x = conv.convert(call.args[1])
                if kind == "numeric_histogram":
                    if x.type.kind != T.TypeKind.DOUBLE:
                        x = ir.Cast(x, T.DOUBLE)
                    out_t = T.map_of(T.DOUBLE, T.DOUBLE)
                else:
                    out_t = T.map_of(x.type, T.BIGINT)
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                aggs.append(
                    P.AggCall(kind, x_ch, out_t, param=float(b.value))
                )
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind in ("listagg", "string_agg"):
                if len(call.args) != 2 or distinct:
                    raise AnalysisError(
                        f"{kind}(x, separator) takes two arguments"
                    )
                x = conv.convert(call.args[0])
                if not x.type.is_string:
                    raise AnalysisError(f"{kind}() aggregates VARCHAR values")
                sep = _const_fold(conv.convert(call.args[1]))
                if (
                    sep is None
                    or sep.value is None
                    or not sep.type.is_string
                ):
                    raise AnalysisError(
                        f"{kind}() separator must be a constant string"
                    )
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                aggs.append(
                    P.AggCall(
                        "listagg", x_ch, T.VARCHAR, separator=str(sep.value)
                    )
                )
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind == "approx_percentile":
                if len(call.args) != 2 or distinct:
                    raise AnalysisError(
                        "approx_percentile(x, fraction) takes two arguments"
                    )
                x = conv.convert(call.args[0])
                frac = _const_fold(conv.convert(call.args[1]))
                if frac is None or frac.value is None:
                    raise AnalysisError(
                        "approx_percentile() fraction must be a constant"
                    )
                p = float(frac.value)
                if not 0.0 <= p <= 1.0:
                    raise AnalysisError(
                        "approx_percentile() fraction must be in [0, 1]"
                    )
                x_ch = len(pre_exprs)
                pre_exprs.append(x)
                aggs.append(
                    P.AggCall("approx_percentile", x_ch, x.type, percentile=p)
                )
                per_call.append(("plain", len(aggs) - 1))
                continue
            if kind in ("any_value", "arbitrary"):
                kind = "any"
            if len(call.args) != 1:
                raise AnalysisError(f"{call.name}() takes one argument")
            arg = conv.convert(call.args[0])
            out_t = self._agg_out_type(kind, arg.type)
            per_call.append(("plain", add_prim(kind, arg, out_t, distinct)))

        pre_fields = tuple(
            P.Field(
                g.parts[-1] if isinstance(g, ast.Identifier) else None,
                e.type,
            )
            for g, e in zip(group_asts, key_irs)
        ) + tuple(P.Field(None, e.type) for e in pre_exprs[len(key_irs):])
        pre = P.ProjectNode(builder.node, tuple(pre_exprs), pre_fields)

        k = len(key_irs)
        out_fields = tuple(pre_fields[:k]) + tuple(
            P.Field(None, a.out_type) for a in aggs
        )
        builder.node = P.AggregateNode(
            pre, tuple(range(k)), tuple(aggs), out_fields
        )

        def ref(prim_idx: int) -> ir.InputRef:
            return ir.InputRef(k + prim_idx, aggs[prim_idx].out_type)

        # the finisher projection is also needed when dedup collapsed two
        # textually-identical plain aggregates: downstream (grouping
        # sets, select resolution) assumes one output channel per call
        plain_chans = [e[1] for e in per_call if e[0] == "plain"]
        has_comp = (
            any(tag == "comp" for tag, *_ in per_call)
            or len(set(plain_chans)) < len(plain_chans)
        )
        if has_comp:
            # finisher projection over the accumulator outputs (the
            # Accumulator.evaluateFinal step, as a plan-level Project)
            post_exprs: List[ir.Expr] = [
                ir.InputRef(i, e.type) for i, e in enumerate(key_irs)
            ]
            call_types: List[T.DataType] = []
            for entry in per_call:
                if entry[0] == "plain":
                    e: ir.Expr = ref(entry[1])
                else:
                    e = entry[1](ref)
                post_exprs.append(e)
                call_types.append(e.type)
            node_fields = tuple(pre_fields[:k]) + tuple(
                P.Field(None, t) for t in call_types
            )
            builder.node = P.ProjectNode(
                builder.node, tuple(post_exprs), node_fields
            )
            chan_of_call = [k + j for j in range(len(per_call))]
        else:
            call_types = [aggs[e[1]].out_type for e in per_call]
            chan_of_call = [k + e[1] for e in per_call]

        # post-agg scope: group keys keep (qualifier, name) when they were
        # plain identifiers so ORDER BY/SELECT can re-resolve them
        post_fields = []
        replacements: Dict[ast.Expression, Tuple[int, T.DataType]] = {}
        for i, (g, e) in enumerate(zip(group_asts, key_irs)):
            if isinstance(g, ast.Identifier):
                qualifier = g.parts[0] if len(g.parts) == 2 else None
                name = g.parts[-1]
            else:
                qualifier, name = None, None
            post_fields.append(ScopeField(qualifier, name, e.type))
            replacements[g] = (i, e.type)
        n_chan = len(builder.node.fields)
        chan_fields = [None] * (n_chan - k)
        for call, ch, t in zip(agg_calls, chan_of_call, call_types):
            replacements[call] = (ch, t)
            chan_fields[ch - k] = ScopeField(None, None, t)
        for j in range(n_chan - k):
            if chan_fields[j] is None:  # deduped-away duplicate channel
                chan_fields[j] = ScopeField(
                    None, None, builder.node.fields[k + j].type
                )
        builder.scope = Scope(post_fields + chan_fields)
        builder.replacements = replacements

    def _expand_composite_agg(self, call: ast.FunctionCall, conv, add_prim):
        """Lower one composite aggregate to primitive accumulators plus a
        finisher expression (SURVEY.md §2.6 aggregation functions: the
        ~130-function library is built from shared moment/flag
        primitives instead of one compiled accumulator per function)."""
        kind = call.name
        if call.distinct:
            raise AnalysisError(f"DISTINCT {kind}() is not supported")

        def dbl(e: ir.Expr) -> ir.Expr:
            return e if e.type == T.DOUBLE else ir.Cast(e, T.DOUBLE)

        def lit(v) -> ir.Expr:
            return ir.Literal(float(v), T.DOUBLE)

        def mul(a, b):
            return ir.call("mul", T.DOUBLE, a, b)

        def sub(a, b):
            return ir.call("sub", T.DOUBLE, a, b)

        def addx(a, b):
            return ir.call("add", T.DOUBLE, a, b)

        def div(a, b):
            return ir.call("div", T.DOUBLE, a, b)

        def sqrt(a):
            return ir.call("sqrt", T.DOUBLE, a)

        def guard(cond_null: ir.Expr, value: ir.Expr) -> ir.Expr:
            """CASE WHEN cond THEN NULL ELSE value END."""
            return ir.Case(
                (cond_null,), (ir.Literal(None, value.type),), value, value.type
            )

        def nneg(v: ir.Expr) -> ir.Expr:
            """Clamp tiny negative central moments (float error) to 0."""
            return ir.Case(
                (ir.comparison("lt", v, lit(0)),), (lit(0),), v, T.DOUBLE
            )

        if kind in ("count_if", "bool_and", "bool_or", "every"):
            if len(call.args) != 1:
                raise AnalysisError(f"{kind}() takes one argument")
            b = conv.convert(call.args[0])
            if b.type.kind != T.TypeKind.BOOLEAN:
                raise AnalysisError(f"{kind}() argument must be boolean")
            # NULL-preserving 0/1 encoding of the flag
            ib = ir.Case(
                (ir.is_null(b), b),
                (ir.Literal(None, T.BIGINT), ir.Literal(1, T.BIGINT)),
                ir.Literal(0, T.BIGINT),
                T.BIGINT,
            )
            if kind == "count_if":
                i = add_prim("sum", ib, T.BIGINT)
                return (
                    "comp",
                    lambda ref, i=i: ir.Case(
                        (ir.is_null(ref(i)),),
                        (ir.Literal(0, T.BIGINT),),
                        ref(i),
                        T.BIGINT,
                    ),
                    T.BIGINT,
                )
            prim = "min" if kind in ("bool_and", "every") else "max"
            i = add_prim(prim, ib, T.BIGINT)
            return (
                "comp",
                lambda ref, i=i: ir.comparison(
                    "eq", ref(i), ir.Literal(1, T.BIGINT)
                ),
                T.BOOLEAN,
            )

        if kind in (
            "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
            "var_pop", "geometric_mean", "skewness", "kurtosis",
        ):
            if len(call.args) != 1:
                raise AnalysisError(f"{kind}() takes one argument")
            x = dbl(conv.convert(call.args[0]))
            n_i = add_prim("count", x, T.BIGINT)
            if kind == "geometric_mean":
                sl_i = add_prim("sum", ir.call("ln", T.DOUBLE, x), T.DOUBLE)

                def fin_geo(ref):
                    n = dbl(ref(n_i))
                    return guard(
                        ir.comparison("eq", ref(n_i), ir.Literal(0, T.BIGINT)),
                        ir.call("exp", T.DOUBLE, div(ref(sl_i), n)),
                    )

                return ("comp", fin_geo, T.DOUBLE)
            s_i = add_prim("sum", x, T.DOUBLE)
            ss_i = add_prim("sum", mul(x, x), T.DOUBLE)
            if kind in ("skewness", "kurtosis"):
                s3_i = add_prim("sum", mul(mul(x, x), x), T.DOUBLE)
                if kind == "kurtosis":
                    s4_i = add_prim("sum", mul(mul(x, x), mul(x, x)), T.DOUBLE)

                def fin_moment(ref, want=kind):
                    n = dbl(ref(n_i))
                    s, ss = ref(s_i), ref(ss_i)
                    mean = div(s, n)
                    m2 = nneg(sub(ss, mul(s, mean)))  # sum((x-mean)^2)
                    # sum((x-mean)^3) from raw moments
                    m3 = addx(
                        sub(ref(s3_i), mul(lit(3), mul(mean, ss))),
                        mul(lit(2), mul(n, mul(mean, mul(mean, mean)))),
                    )
                    if want == "skewness":
                        # sqrt(n) * m3 / m2^1.5, NULL when n < 3 or m2 == 0
                        val = div(
                            mul(sqrt(n), m3), mul(m2, sqrt(m2))
                        )
                        bad = ir.or_(
                            ir.comparison(
                                "lt", ref(n_i), ir.Literal(3, T.BIGINT)
                            ),
                            ir.comparison("le", m2, lit(0)),
                        )
                        return guard(bad, val)
                    # sample excess kurtosis:
                    # n(n+1)(n-1)/((n-2)(n-3)) * m4/m2^2
                    #   - 3(n-1)^2/((n-2)(n-3)),   NULL when n < 4 or m2 == 0
                    m4 = sub(
                        addx(
                            sub(
                                ref(s4_i),
                                mul(lit(4), mul(mean, ref(s3_i))),
                            ),
                            mul(lit(6), mul(mul(mean, mean), ss)),
                        ),
                        mul(
                            lit(3),
                            mul(n, mul(mul(mean, mean), mul(mean, mean))),
                        ),
                    )
                    n1, n2, n3 = sub(n, lit(1)), sub(n, lit(2)), sub(n, lit(3))
                    term1 = mul(
                        div(mul(n, mul(addx(n, lit(1)), n1)), mul(n2, n3)),
                        div(m4, mul(m2, m2)),
                    )
                    term2 = div(mul(lit(3), mul(n1, n1)), mul(n2, n3))
                    bad = ir.or_(
                        ir.comparison("lt", ref(n_i), ir.Literal(4, T.BIGINT)),
                        ir.comparison("le", m2, lit(0)),
                    )
                    return guard(bad, sub(term1, term2))

                return ("comp", fin_moment, T.DOUBLE)

            pop = kind.endswith("_pop")

            def fin_var(ref, pop=pop, want=kind):
                n = dbl(ref(n_i))
                s = ref(s_i)
                m2 = nneg(sub(ref(ss_i), div(mul(s, s), n)))
                denom = n if pop else sub(n, lit(1))
                v = div(m2, denom)
                min_n = 1 if pop else 2
                bad = ir.comparison(
                    "lt", ref(n_i), ir.Literal(min_n, T.BIGINT)
                )
                if want.startswith("stddev"):
                    v = sqrt(v)
                return guard(bad, v)

            return ("comp", fin_var, T.DOUBLE)

        # two-argument covariance family: rows where EITHER argument is
        # NULL are excluded from every moment (pairwise masking)
        if kind == "entropy":
            # -sum(c/S * log2(c/S)) = (ln(S) - sum(c ln c)/S) / ln 2,
            # from two plain sums (the reference's EntropyAggregation
            # keeps the same two-moment state)
            if len(call.args) != 1:
                raise AnalysisError("entropy(c) takes one argument")
            c0 = dbl(conv.convert(call.args[0]))
            bad_in = ir.comparison("lt", c0, lit(0))
            c = ir.Case((bad_in,), (ir.Literal(None, T.DOUBLE),), c0,
                        T.DOUBLE)
            s_i = add_prim("sum", c, T.DOUBLE)
            clnc = mul(c, ir.Case(
                (ir.comparison("le", c, lit(0)),), (lit(0),),
                ir.call("ln", T.DOUBLE, c), T.DOUBLE,
            ))
            slnc_i = add_prim("sum", clnc, T.DOUBLE)

            def fin_entropy(ref):
                s = ref(s_i)
                ent = div(
                    sub(ir.call("ln", T.DOUBLE, s), div(ref(slnc_i), s)),
                    lit(math.log(2.0)),
                )
                zero = ir.or_(
                    ir.is_null(s), ir.comparison("le", s, lit(0))
                )
                return ir.Case((zero,), (lit(0),), ent, T.DOUBLE)

            return ("comp", fin_entropy, T.DOUBLE)
        if kind == "checksum":
            # order-insensitive 64-bit checksum: wrapping sum of per-row
            # value hashes (the reference's ChecksumAggregationFunction
            # sums XxHash64 values; rendered as BIGINT here — the
            # varbinary carrier documents this divergence)
            if len(call.args) != 1:
                raise AnalysisError("checksum(x) takes one argument")
            x = conv.convert(call.args[0])
            if x.type.is_nested or x.type.kind == T.TypeKind.ARRAY:
                raise AnalysisError(
                    "checksum() over nested types is not supported"
                )
            h = ir.Call("checksum_hash", (x,), T.BIGINT)
            i = add_prim("sum", h, T.BIGINT)
            return ("comp", lambda ref, i=i: ref(i), T.BIGINT)
        if kind in ("regr_avgx", "regr_avgy", "regr_count", "regr_r2",
                    "regr_sxx", "regr_sxy", "regr_syy"):
            if len(call.args) != 2:
                raise AnalysisError(f"{kind}(y, x) takes two arguments")
            y0 = dbl(conv.convert(call.args[0]))
            x0 = dbl(conv.convert(call.args[1]))
            both = ir.and_(ir.not_(ir.is_null(y0)), ir.not_(ir.is_null(x0)))

            def masked(ex):
                return ir.Case((both,), (ex,), ir.Literal(None, T.DOUBLE),
                               T.DOUBLE)

            y, x = masked(y0), masked(x0)
            n_i = add_prim("count", y, T.BIGINT)
            if kind == "regr_count":
                return ("comp", lambda ref, i=n_i: ref(i), T.BIGINT)
            sy_i = add_prim("sum", y, T.DOUBLE)
            sx_i = add_prim("sum", x, T.DOUBLE)

            def zero_guard(ref, value):
                return guard(
                    ir.comparison("eq", ref(n_i), ir.Literal(0, T.BIGINT)),
                    value,
                )

            if kind == "regr_avgx":
                return ("comp", lambda ref: zero_guard(
                    ref, div(ref(sx_i), dbl(ref(n_i)))), T.DOUBLE)
            if kind == "regr_avgy":
                return ("comp", lambda ref: zero_guard(
                    ref, div(ref(sy_i), dbl(ref(n_i)))), T.DOUBLE)
            sxy_i = add_prim("sum", mul(y, x), T.DOUBLE)
            sxx_i = add_prim("sum", mul(x, x), T.DOUBLE)
            if kind == "regr_sxy":
                return ("comp", lambda ref: zero_guard(ref, sub(
                    ref(sxy_i),
                    div(mul(ref(sx_i), ref(sy_i)), dbl(ref(n_i))),
                )), T.DOUBLE)
            if kind == "regr_sxx":
                return ("comp", lambda ref: zero_guard(ref, nneg(sub(
                    ref(sxx_i),
                    div(mul(ref(sx_i), ref(sx_i)), dbl(ref(n_i))),
                ))), T.DOUBLE)
            syy_i = add_prim("sum", mul(y, y), T.DOUBLE)
            if kind == "regr_syy":
                return ("comp", lambda ref: zero_guard(ref, nneg(sub(
                    ref(syy_i),
                    div(mul(ref(sy_i), ref(sy_i)), dbl(ref(n_i))),
                ))), T.DOUBLE)

            # regr_r2: square of corr; vx == 0 -> NULL, vy == 0 -> 1
            def fin_r2(ref):
                n = dbl(ref(n_i))
                vx = nneg(
                    sub(ref(sxx_i), div(mul(ref(sx_i), ref(sx_i)), n))
                )
                vy = nneg(
                    sub(ref(syy_i), div(mul(ref(sy_i), ref(sy_i)), n))
                )
                cxy = sub(ref(sxy_i), div(mul(ref(sx_i), ref(sy_i)), n))
                r2 = div(mul(cxy, cxy), mul(vx, vy))
                return ir.Case(
                    (
                        ir.or_(
                            ir.comparison(
                                "eq", ref(n_i), ir.Literal(0, T.BIGINT)
                            ),
                            ir.comparison("le", vx, lit(0)),
                        ),
                        ir.comparison("le", vy, lit(0)),
                    ),
                    (ir.Literal(None, T.DOUBLE), lit(1)),
                    r2,
                    T.DOUBLE,
                )

            return ("comp", fin_r2, T.DOUBLE)
        if kind in ("corr", "covar_pop", "covar_samp", "regr_slope",
                    "regr_intercept"):
            if len(call.args) != 2:
                raise AnalysisError(f"{kind}() takes two arguments")
            y0 = dbl(conv.convert(call.args[0]))
            x0 = dbl(conv.convert(call.args[1]))
            both = ir.and_(ir.not_(ir.is_null(y0)), ir.not_(ir.is_null(x0)))

            def masked(e):
                return ir.Case((both,), (e,), ir.Literal(None, T.DOUBLE),
                               T.DOUBLE)

            y, x = masked(y0), masked(x0)
            n_i = add_prim("count", y, T.BIGINT)
            sy_i = add_prim("sum", y, T.DOUBLE)
            sx_i = add_prim("sum", x, T.DOUBLE)
            sxy_i = add_prim("sum", mul(y, x), T.DOUBLE)
            if kind in ("corr",):
                sxx_i = add_prim("sum", mul(x, x), T.DOUBLE)
                syy_i = add_prim("sum", mul(y, y), T.DOUBLE)

                def fin_corr(ref):
                    n = dbl(ref(n_i))
                    cxy = sub(ref(sxy_i), div(mul(ref(sx_i), ref(sy_i)), n))
                    vx = nneg(
                        sub(ref(sxx_i), div(mul(ref(sx_i), ref(sx_i)), n))
                    )
                    vy = nneg(
                        sub(ref(syy_i), div(mul(ref(sy_i), ref(sy_i)), n))
                    )
                    denom = sqrt(mul(vx, vy))
                    bad = ir.or_(
                        ir.comparison(
                            "eq", ref(n_i), ir.Literal(0, T.BIGINT)
                        ),
                        ir.comparison("le", denom, lit(0)),
                    )
                    return guard(bad, div(cxy, denom))

                return ("comp", fin_corr, T.DOUBLE)
            if kind in ("regr_slope", "regr_intercept"):
                sxx_i = add_prim("sum", mul(x, x), T.DOUBLE)

                def fin_regr(ref, want=kind):
                    n = dbl(ref(n_i))
                    cxy = sub(ref(sxy_i), div(mul(ref(sx_i), ref(sy_i)), n))
                    vx = sub(ref(sxx_i), div(mul(ref(sx_i), ref(sx_i)), n))
                    slope = div(cxy, vx)
                    bad = ir.or_(
                        ir.comparison(
                            "eq", ref(n_i), ir.Literal(0, T.BIGINT)
                        ),
                        ir.comparison("le", nneg(vx), lit(0)),
                    )
                    if want == "regr_slope":
                        return guard(bad, slope)
                    intercept = sub(
                        div(ref(sy_i), n), mul(slope, div(ref(sx_i), n))
                    )
                    return guard(bad, intercept)

                return ("comp", fin_regr, T.DOUBLE)

            pop = kind == "covar_pop"

            def fin_covar(ref, pop=pop):
                n = dbl(ref(n_i))
                cxy = sub(ref(sxy_i), div(mul(ref(sx_i), ref(sy_i)), n))
                denom = n if pop else sub(n, lit(1))
                min_n = 1 if pop else 2
                bad = ir.comparison(
                    "lt", ref(n_i), ir.Literal(min_n, T.BIGINT)
                )
                return guard(bad, div(cxy, denom))

            return ("comp", fin_covar, T.DOUBLE)

        raise AnalysisError(f"unknown aggregate {kind}")

    def _plan_grouping_sets(
        self, builder: Builder, group_asts, sets, agg_calls, ctes
    ) -> None:
        """ROLLUP/CUBE/GROUPING SETS as a UNION ALL of per-set
        aggregations over the same source, each projected onto the
        canonical [all keys..., aggs...] layout with typed NULLs for
        absent keys (the GroupIdNode expansion, unrolled)."""
        base_node, base_scope = builder.node, builder.scope
        base_repl = dict(builder.replacements)
        key_types = [
            ExprConverter(base_scope, base_repl).convert(g).type
            for g in group_asts
        ]
        branches = []
        # larger sets first so the union schema carries real dictionaries
        for s in sorted(sets, key=len, reverse=True):
            b = Builder(base_node, base_scope)
            b.replacements = dict(base_repl)
            self._plan_aggregation(
                b, [group_asts[i] for i in s], agg_calls, ctes
            )
            k_set = len(s)
            exprs: List[ir.Expr] = []
            fields: List[P.Field] = []
            pos_of = {g: p for p, g in enumerate(s)}
            for j, t in enumerate(key_types):
                if j in pos_of:
                    exprs.append(ir.InputRef(pos_of[j], t))
                else:
                    exprs.append(ir.Cast(ir.Literal(None, T.UNKNOWN), t))
                fields.append(P.Field(None, t))
            for i2, call in enumerate(agg_calls):
                t = b.node.fields[k_set + i2].type
                exprs.append(ir.InputRef(k_set + i2, t))
                fields.append(P.Field(None, t))
            branches.append(
                P.ProjectNode(b.node, tuple(exprs), tuple(fields))
            )
        union_fields = branches[0].fields
        builder.node = P.UnionAllNode(tuple(branches), union_fields)
        post_fields = []
        replacements: Dict[ast.Expression, Tuple[int, T.DataType]] = {}
        for j, (g, t) in enumerate(zip(group_asts, key_types)):
            if isinstance(g, ast.Identifier):
                qualifier = g.parts[0] if len(g.parts) == 2 else None
                name = g.parts[-1]
            else:
                qualifier, name = None, None
            post_fields.append(ScopeField(qualifier, name, t))
            replacements[g] = (j, t)
        k = len(group_asts)
        for i2, call in enumerate(agg_calls):
            t = union_fields[k + i2].type
            post_fields.append(ScopeField(None, None, t))
            replacements[call] = (k + i2, t)
        builder.scope = Scope(post_fields)
        builder.replacements = replacements

    def _plan_windows(self, builder: Builder, calls: List[ast.WindowCall]) -> None:
        """Plan WindowNodes: one per distinct (partition, order, frame)
        spec, functions sharing a spec computed together (Trino merges
        window specs the same way in PlanWindowFunctions). Each call's
        result channel is registered as a replacement so SELECT/ORDER BY
        conversion sees a plain channel reference."""
        by_spec: Dict[ast.WindowSpec, List[ast.WindowCall]] = {}
        for c in calls:
            by_spec.setdefault(c.spec, []).append(c)
        for spec, group in by_spec.items():
            conv = builder.converter()
            width = len(builder.scope)
            # pre-projection: identity + partition keys + order keys + args
            pre_exprs: List[ir.Expr] = [
                ir.InputRef(i, f.type) for i, f in enumerate(builder.scope.fields)
            ]

            def channel_of(e: ast.Expression) -> int:
                x = conv.convert(e)
                if isinstance(x, ir.InputRef):
                    return x.index
                pre_exprs.append(x)
                return len(pre_exprs) - 1

            part_channels = tuple(channel_of(e) for e in spec.partition_by)
            order_keys = []
            for s in spec.order_by:
                ch = channel_of(s.expr)
                nf = s.nulls_first if s.nulls_first is not None else s.descending
                order_keys.append(SortKey(ch, s.descending, nf))
            functions: List[P.WindowFuncSpec] = []
            for c in group:
                functions.append(self._window_func(c, channel_of, conv))
            pre_fields = tuple(
                P.Field(None, e.type) for e in pre_exprs
            )
            pre = P.ProjectNode(builder.node, tuple(pre_exprs), pre_fields)
            out_fields = pre_fields + tuple(
                P.Field(None, f.out_type) for f in functions
            )
            builder.node = P.WindowNode(
                pre, part_channels, tuple(order_keys), tuple(functions),
                spec.frame, out_fields,
            )
            new_fields = list(builder.scope.fields)
            for e in pre_exprs[width:]:
                new_fields.append(ScopeField(None, None, e.type))
            for i, (c, f) in enumerate(zip(group, functions)):
                new_fields.append(ScopeField(None, None, f.out_type))
                builder.replacements[c] = (len(pre_exprs) + i, f.out_type)
            builder.scope = Scope(new_fields)

    def _window_func(self, c: ast.WindowCall, channel_of, conv) -> P.WindowFuncSpec:
        name = c.name
        if name in ("row_number", "rank", "dense_rank"):
            if c.args:
                raise AnalysisError(f"{name}() takes no arguments")
            return P.WindowFuncSpec(name, None, T.BIGINT)
        if name in ("percent_rank", "cume_dist"):
            if c.args:
                raise AnalysisError(f"{name}() takes no arguments")
            return P.WindowFuncSpec(name, None, T.DOUBLE)
        if name == "ntile":
            n = c.args[0] if c.args else None
            if not isinstance(n, ast.NumberLiteral) or not n.text.isdigit():
                raise AnalysisError("ntile() requires a literal integer")
            return P.WindowFuncSpec("ntile", None, T.BIGINT, offset=int(n.text))
        if name in ("lead", "lag"):
            if not c.args:
                raise AnalysisError(f"{name}() requires an argument")
            ch = channel_of(c.args[0])
            off = 1
            if len(c.args) > 1:
                a1 = c.args[1]
                if not isinstance(a1, ast.NumberLiteral) or not a1.text.isdigit():
                    raise AnalysisError(f"{name}() offset must be a literal integer")
                off = int(a1.text)
            if len(c.args) > 2:
                raise AnalysisError(f"{name}() default values not supported")
            t = conv.convert(c.args[0]).type
            return P.WindowFuncSpec(name, ch, t, offset=off)
        if name in ("first_value", "last_value"):
            ch = channel_of(c.args[0])
            t = conv.convert(c.args[0]).type
            return P.WindowFuncSpec(name, ch, t)
        if name == "nth_value":
            if len(c.args) != 2:
                raise AnalysisError("nth_value(x, n) takes two arguments")
            a1 = c.args[1]
            if not isinstance(a1, ast.NumberLiteral) or not a1.text.isdigit():
                raise AnalysisError(
                    "nth_value() offset must be a literal positive integer"
                )
            n = int(a1.text)
            if n < 1:
                raise AnalysisError("nth_value() offset must be >= 1")
            ch = channel_of(c.args[0])
            t = conv.convert(c.args[0]).type
            return P.WindowFuncSpec(name, ch, t, offset=n)
        if name == "count":
            if not c.args or isinstance(c.args[0], ast.Star):
                return P.WindowFuncSpec("count_star", None, T.BIGINT)
            return P.WindowFuncSpec("count", channel_of(c.args[0]), T.BIGINT)
        if name in ("sum", "avg", "min", "max"):
            ch = channel_of(c.args[0])
            t = conv.convert(c.args[0]).type
            return P.WindowFuncSpec(name, ch, self._agg_out_type(name, t))
        raise AnalysisError(f"unknown window function {name}()")

    @staticmethod
    def _agg_out_type(kind: str, arg_t: T.DataType) -> T.DataType:
        if kind == "count":
            return T.BIGINT
        if kind == "avg":
            # Trino: avg(decimal(p, s)) -> decimal(p, s)
            # (DecimalAverageAggregation @OutputFunction("decimal(p,s)"))
            if arg_t.is_decimal:
                return T.decimal(arg_t.precision or 18, arg_t.scale or 0)
            return T.DOUBLE
        if kind == "sum":
            # Trino: sum(decimal(p, s)) -> decimal(38, s)
            # (DecimalSumAggregation @OutputFunction("decimal(38,s)"))
            if arg_t.is_decimal:
                return T.decimal(T.MAX_DECIMAL_PRECISION, arg_t.scale or 0)
            if arg_t.is_floating:
                return T.DOUBLE
            return T.BIGINT
        if kind in ("min", "max", "any"):
            return arg_t
        raise AnalysisError(f"unknown aggregate {kind}")

    # ---- select helpers ----
    def _expand_stars(self, spec: ast.QuerySpec, scope: Scope) -> List[ast.SelectItem]:
        out: List[ast.SelectItem] = []
        for item in spec.select:
            if isinstance(item.expr, ast.Star):
                q = item.expr.qualifier
                for f in scope.fields:
                    if f.name is None:
                        continue
                    if q is not None and f.qualifier != q:
                        continue
                    parts = (f.qualifier, f.name) if f.qualifier else (f.name,)
                    out.append(ast.SelectItem(ast.Identifier(parts)))
            else:
                out.append(item)
        return out

    @staticmethod
    def _resolve_group_ordinals(group_by, select_exprs) -> List[ast.Expression]:
        out = []
        for g in group_by:
            if isinstance(g, ast.NumberLiteral) and g.text.isdigit():
                idx = int(g.text) - 1
                if not 0 <= idx < len(select_exprs):
                    raise AnalysisError(f"GROUP BY ordinal {g.text} out of range")
                out.append(select_exprs[idx])
            else:
                out.append(g)
        return out

    @staticmethod
    def _output_name(item: ast.SelectItem, i: int) -> str:
        if item.alias:
            return item.alias
        if isinstance(item.expr, ast.Identifier):
            return item.expr.parts[-1]
        return f"_col{i}"

    @staticmethod
    def _order_by_channel(e, select_items, select_exprs, names) -> Optional[int]:
        if isinstance(e, ast.NumberLiteral) and e.text.isdigit():
            idx = int(e.text) - 1
            if not 0 <= idx < len(select_exprs):
                raise AnalysisError(f"ORDER BY ordinal {e.text} out of range")
            return idx
        if isinstance(e, ast.Identifier) and len(e.parts) == 1:
            if e.parts[0] in names:
                return names.index(e.parts[0])
        if e in select_exprs:
            return select_exprs.index(e)
        return None


def _pattern_var_names(node) -> Set[str]:
    """Variable names (lowercased) appearing in a pattern tuple-AST."""
    kind = node[0]
    if kind == "var":
        return {node[1].lower()}
    if kind in ("seq", "alt"):
        out: Set[str] = set()
        for p in node[1]:
            out |= _pattern_var_names(p)
        return out
    return _pattern_var_names(node[1])


def _validate_array_usage(node: P.PlanNode) -> None:
    """Nested columns (ARRAY/MAP/ROW) have no value-wise ordering/hash
    operators (the physical per-row value is the LENGTH for array/map
    and a constant presence byte for row — block.py), so using them as
    grouping/sort/join/partition keys would silently collapse distinct
    values. Reject at analysis time (the reference's ArrayType/MapType/
    RowType have real operators; until this engine's do, fail loudly)."""

    def bad(where: str):
        raise AnalysisError(
            f"ARRAY/MAP/ROW values cannot be used as {where} (use UNNEST,"
            " subscripts or cardinality to operate on nested contents)"
        )

    def check(child: P.PlanNode, channels, where: str):
        for ch in channels:
            if child.fields[ch].type.is_nested:
                bad(where)

    if isinstance(node, P.AggregateNode):
        check(node.child, node.group_channels, "grouping keys")
        for a in node.aggs:
            if a.kind in ("map_union", "array_agg"):
                # collect-path aggregates consume the nested VALUE
                # host-side (no value-wise device operator needed)
                continue
            for ch in (a.arg_channel, a.arg2_channel):
                if ch is not None and node.child.fields[ch].type.is_nested:
                    bad("aggregate arguments")
    elif isinstance(node, P.JoinNode):
        check(node.left, node.left_keys, "join keys")
        check(node.right, node.right_keys, "join keys")
    elif isinstance(node, (P.SortNode, P.TopNNode)):
        check(node.child, [k.channel for k in node.keys], "sort keys")
    elif isinstance(node, P.WindowNode):
        check(node.child, node.partition_channels, "window partition keys")
        check(node.child, [k.channel for k in node.order_keys],
              "window order keys")
    elif isinstance(node, P.MatchRecognizeNode):
        check(node.child, node.partition_channels, "pattern partition keys")
    for c in node.children():
        _validate_array_usage(c)

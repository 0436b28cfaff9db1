"""Typed EXECUTE ... USING parameter binding.

The parser tolerates `?` placeholders anywhere an expression goes and
`substitute_parameters` splices the bound values in positionally before
analysis — so an arity or type mismatch used to surface only as an
analyzer error deep inside the substituted statement (or worse, as a
silently-wrong comparison). This module checks the binding UP FRONT
against the prepared statement:

- arity: the number of bound values must equal the number of distinct
  placeholder positions (`?` count);
- dtypes: where a placeholder's expected type can be inferred from its
  use site (`col = ?`, `? < col`, `col IN (?, ...)`, `col BETWEEN ?
  AND ?` against a resolvable base table), the bound literal must
  coerce to it under the analyzer's own lattice (common_super_type) —
  the check can never be stricter or looser than analysis itself.

Uninferable positions (parameters inside function calls, derived
tables, expressions) stay unchecked: None in the dtype vector means
"analysis will judge". Failures raise ParameterBindingError naming the
1-based position, the expected type, and the got type.
"""

from __future__ import annotations

from typing import List, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.sql import ast

# comparison ops whose two sides must share a common super type
_COMPARISONS = {
    "eq", "ne", "lt", "le", "gt", "ge", "is_distinct",
    "=", "<>", "<", "<=", ">", ">=",
}


class ParameterBindingError(ValueError):
    """EXECUTE ... USING arity or dtype mismatch, raised before any
    planning work. `position` is 1-based (the protocol's convention)."""

    def __init__(self, message: str, position: Optional[int] = None,
                 expected=None, got=None):
        super().__init__(message)
        self.position = position
        self.expected = expected
        self.got = got


def literal_dtype(expr) -> Optional[T.DataType]:
    """Static type of a bound literal expression; None when it is not
    a plain literal (analysis will type it)."""
    if isinstance(expr, ast.NumberLiteral):
        text = expr.text.lower()
        if "." in text or "e" in text:
            return T.DOUBLE
        return T.BIGINT
    if isinstance(expr, ast.StringLiteral):
        return T.VARCHAR
    if isinstance(expr, ast.BooleanLiteral):
        return T.BOOLEAN
    if isinstance(expr, ast.NullLiteral):
        return T.UNKNOWN
    if isinstance(expr, ast.DateLiteral):
        return T.DATE
    if isinstance(expr, ast.TimestampLiteral):
        return T.TIMESTAMP
    if isinstance(expr, ast.UnaryOp) and expr.op in ("-", "+"):
        return literal_dtype(expr.operand)
    if isinstance(expr, ast.Cast):
        try:
            from trino_tpu_torch.sql.analyzer import resolve_type

            return resolve_type(expr.type)
        except Exception:
            return None
    return None


def count_parameters(node) -> int:
    """Number of placeholder positions in a statement (max index + 1 —
    the parser numbers them left to right)."""
    import dataclasses as _dc

    top = -1

    def walk(x):
        nonlocal top
        if isinstance(x, ast.Parameter):
            top = max(top, x.index)
        elif _dc.is_dataclass(x) and isinstance(x, ast.Node):
            for f in _dc.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for e in x:
                walk(e)

    walk(node)
    return top + 1


def _column_types(node, catalogs, catalog: str, schema: str) -> dict:
    """column name -> DataType over every base table referenced by the
    statement. Names colliding across tables with DIFFERENT types map
    to None (ambiguous — leave those positions unchecked)."""
    import dataclasses as _dc

    out: dict = {}

    def add_table(parts) -> None:
        cat, sch = catalog, schema
        table = parts[-1]
        if len(parts) == 2:
            sch = parts[0]
        elif len(parts) == 3:
            cat, sch = parts[0], parts[1]
        try:
            conn = catalogs.get(cat)
            handle = conn.metadata.get_table_handle(sch, table)
            if handle is None:
                return
            meta = conn.metadata.get_table_metadata(handle)
        except Exception:
            return
        for col in meta.columns:
            if col.name in out:
                if out[col.name] is not None and out[col.name] != col.type:
                    out[col.name] = None  # ambiguous across tables
            else:
                out[col.name] = col.type

    def walk(x):
        if isinstance(x, ast.TableRef):
            add_table(x.name)
        elif _dc.is_dataclass(x) and isinstance(x, ast.Node):
            for f in _dc.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for e in x:
                walk(e)

    walk(node)
    return out


def infer_parameter_types(
    stmt, catalogs=None, catalog: str = "", schema: str = "",
) -> List[Optional[T.DataType]]:
    """Expected dtype per placeholder position, None where the use site
    does not pin a type. Resolution covers the serving hot paths —
    `col op ?`, `? op col`, `col IN (?, ...)`, `col BETWEEN ? AND ?` —
    against any base table the statement references."""
    import dataclasses as _dc

    n = count_parameters(stmt)
    expected: List[Optional[T.DataType]] = [None] * n
    if n == 0 or catalogs is None:
        return expected
    cols = _column_types(stmt, catalogs, catalog, schema)

    def col_type(e) -> Optional[T.DataType]:
        if isinstance(e, ast.Identifier):
            return cols.get(e.parts[-1])
        return None

    def note(param, ty) -> None:
        if ty is not None and isinstance(param, ast.Parameter):
            if expected[param.index] is None:
                expected[param.index] = ty

    def walk(x):
        if isinstance(x, ast.BinaryOp) and x.op in _COMPARISONS:
            note(x.right, col_type(x.left))
            note(x.left, col_type(x.right))
        elif isinstance(x, ast.InList):
            ty = col_type(x.value)
            for opt in x.options:
                note(opt, ty)
        elif isinstance(x, ast.Between):
            ty = col_type(x.value)
            note(x.low, ty)
            note(x.high, ty)
        if _dc.is_dataclass(x) and isinstance(x, ast.Node):
            for f in _dc.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):
            for e in x:
                walk(e)

    walk(stmt)
    return expected


def bound_dtypes(parameters) -> List[Optional[T.DataType]]:
    """Dtype vector of the bound values (the plan-cache key component)."""
    return [literal_dtype(p) for p in parameters]


def check_parameters(
    stmt, parameters, catalogs=None, catalog: str = "", schema: str = "",
) -> List[Optional[T.DataType]]:
    """Arity + dtype check of `parameters` against the prepared
    statement; returns the bound dtype vector for plan-cache keying.
    Raises ParameterBindingError on mismatch."""
    n = count_parameters(stmt)
    if len(parameters) != n:
        raise ParameterBindingError(
            f"prepared statement expects {n} parameter"
            f"{'s' if n != 1 else ''}, got {len(parameters)}"
        )
    got = bound_dtypes(parameters)
    expected = infer_parameter_types(stmt, catalogs, catalog, schema)
    for i, (exp, g) in enumerate(zip(expected, got)):
        if exp is None or g is None or g.kind == T.TypeKind.UNKNOWN:
            continue
        if T.common_super_type(exp, g) is None:
            raise ParameterBindingError(
                f"parameter {i + 1}: expected {exp}, got {g}",
                position=i + 1, expected=exp, got=g,
            )
    return got

"""AST -> SQL renderer.

Analogue of the reference's SqlFormatter/ExpressionFormatter
(core/trino-parser/src/main/java/io/trino/sql/SqlFormatter.java and
ExpressionFormatter.java): renders every AST node back to SQL text that
re-parses to an equivalent tree. Used by the verifier/proxy for query
normalization and by EXPLAIN output; the round-trip property
(parse(format(parse(sql))) == parse(sql)) is the tested contract.

Unlike the reference's indenting pretty-printer this emits single-line
canonical text — the engine has no multi-page DDL to pretty-print, and
one-line output is what the test oracle and the verifier diff.
"""

from __future__ import annotations

from typing import Optional

from . import ast

_IDENT_SAFE = set("abcdefghijklmnopqrstuvwxyz0123456789_")


def _ident(part: str) -> str:
    """Quote an identifier part unless it is a plain lowercase name."""
    if part and part[0].isalpha() and all(c in _IDENT_SAFE for c in part):
        return part
    return '"' + part.replace('"', '""') + '"'


def _name(parts) -> str:
    return ".".join(_ident(p) for p in parts)


def _str(value: str) -> str:
    return "'" + value.replace("'", "''") + "'"


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

# binding powers mirror the parser's Pratt table so parentheses are
# emitted exactly where re-parsing needs them; keys are the parser's
# normalized op names (parser.py:616-710)
_PREC = {
    "or": 1, "and": 2,
    "eq": 4, "ne": 4, "lt": 4, "le": 4, "gt": 4, "ge": 4,
    "is_distinct": 4,
    "add": 6, "sub": 6,
    "mul": 7, "div": 7, "mod": 7,
}

_OP_TEXT = {
    "or": "OR", "and": "AND",
    "eq": "=", "ne": "<>", "lt": "<", "le": "<=", "gt": ">", "ge": ">=",
    "is_distinct": "IS DISTINCT FROM",
    "add": "+", "sub": "-", "mul": "*", "div": "/", "mod": "%",
}


def format_expression(e: ast.Expression) -> str:
    if isinstance(e, ast.Parameter):
        return "?"
    return _expr(e, 0)


def _maybe_paren(text: str, prec: int, limit: int) -> str:
    return f"({text})" if prec < limit else text


def _expr(e, limit: int = 0) -> str:
    if isinstance(e, ast.Parameter):
        return "?"
    if isinstance(e, ast.Identifier):
        return _name(e.parts)
    if isinstance(e, ast.NumberLiteral):
        return e.text
    if isinstance(e, ast.StringLiteral):
        return _str(e.value)
    if isinstance(e, ast.BooleanLiteral):
        return "TRUE" if e.value else "FALSE"
    if isinstance(e, ast.NullLiteral):
        return "NULL"
    if isinstance(e, ast.DateLiteral):
        return f"DATE {_str(e.value)}"
    if isinstance(e, ast.TimestampLiteral):
        return f"TIMESTAMP {_str(e.value)}"
    if isinstance(e, ast.IntervalLiteral):
        sign = "- " if e.sign < 0 else ""
        return f"INTERVAL {sign}{_str(e.value)} {e.unit.upper()}"
    if isinstance(e, ast.Star):
        return f"{_ident(e.qualifier)}.*" if e.qualifier else "*"
    if isinstance(e, ast.BinaryOp):
        prec = _PREC[e.op]
        kw = _OP_TEXT[e.op]
        # left-assoc: right side needs one more level of binding
        text = f"{_expr(e.left, prec)} {kw} {_expr(e.right, prec + 1)}"
        return _maybe_paren(text, prec, limit)
    if isinstance(e, ast.UnaryOp):
        if e.op == "not":
            return _maybe_paren(f"NOT {_expr(e.operand, 3)}", 3, limit)
        sym = "-" if e.op == "negate" else "+"
        return _maybe_paren(f"{sym}{_expr(e.operand, 8)}", 8, limit)
    if isinstance(e, ast.IsNullPredicate):
        kw = "IS NOT NULL" if e.negated else "IS NULL"
        return _maybe_paren(f"{_expr(e.operand, 4)} {kw}", 3, limit)
    if isinstance(e, ast.Between):
        kw = "NOT BETWEEN" if e.negated else "BETWEEN"
        text = (f"{_expr(e.value, 4)} {kw} {_expr(e.low, 5)}"
                f" AND {_expr(e.high, 5)}")
        return _maybe_paren(text, 3, limit)
    if isinstance(e, ast.InList):
        kw = "NOT IN" if e.negated else "IN"
        opts = ", ".join(_expr(o) for o in e.options)
        return _maybe_paren(f"{_expr(e.value, 4)} {kw} ({opts})", 3, limit)
    if isinstance(e, ast.InSubquery):
        kw = "NOT IN" if e.negated else "IN"
        return _maybe_paren(
            f"{_expr(e.value, 4)} {kw} ({format_query(e.query)})", 3, limit
        )
    if isinstance(e, ast.Exists):
        text = f"EXISTS ({format_query(e.query)})"
        return f"NOT {text}" if e.negated else text
    if isinstance(e, ast.ScalarSubquery):
        return f"({format_query(e.query)})"
    if isinstance(e, ast.Like):
        kw = "NOT LIKE" if e.negated else "LIKE"
        text = f"{_expr(e.value, 4)} {kw} {_expr(e.pattern, 5)}"
        if e.escape is not None:
            text += f" ESCAPE {_expr(e.escape, 5)}"
        return _maybe_paren(text, 3, limit)
    if isinstance(e, ast.FunctionCall):
        inner = ", ".join(_expr(a) for a in e.args)
        if e.distinct:
            inner = "DISTINCT " + inner
        return f"{e.name}({inner})"
    if isinstance(e, ast.WindowCall):
        args = ", ".join(_expr(a) for a in e.args)
        return f"{e.name}({args}) OVER ({_window_spec(e.spec)})"
    if isinstance(e, ast.Extract):
        return f"EXTRACT({e.field.upper()} FROM {_expr(e.operand)})"
    if isinstance(e, ast.Cast):
        return f"CAST({_expr(e.operand)} AS {_type(e.target)})"
    if isinstance(e, ast.Case):
        parts = ["CASE"]
        if e.operand is not None:
            parts.append(_expr(e.operand))
        for w in e.whens:
            parts.append(f"WHEN {_expr(w.condition)} THEN {_expr(w.result)}")
        if e.default is not None:
            parts.append(f"ELSE {_expr(e.default)}")
        parts.append("END")
        return " ".join(parts)
    if isinstance(e, ast.ArrayLiteral):
        return "ARRAY[" + ", ".join(_expr(x) for x in e.elements) + "]"
    raise NotImplementedError(f"cannot format {type(e).__name__}")


def _type(t: ast.TypeName) -> str:
    if t.params:
        return f"{t.name}({', '.join(str(p) for p in t.params)})"
    return t.name


def _window_spec(spec: ast.WindowSpec) -> str:
    parts = []
    if spec.partition_by:
        parts.append(
            "PARTITION BY " + ", ".join(_expr(x) for x in spec.partition_by)
        )
    if spec.order_by:
        parts.append(
            "ORDER BY " + ", ".join(_sort_item(s) for s in spec.order_by)
        )
    if spec.frame == "rows":
        parts.append("ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW")
    elif spec.frame == "partition" and spec.order_by:
        parts.append(
            "ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING"
        )
    return " ".join(parts)


def _sort_item(s: ast.SortItem) -> str:
    text = _expr(s.expr)
    if s.descending:
        text += " DESC"
    if s.nulls_first is not None:
        text += " NULLS FIRST" if s.nulls_first else " NULLS LAST"
    return text


# ---------------------------------------------------------------------------
# relations
# ---------------------------------------------------------------------------


def _relation(r: ast.Relation) -> str:
    if isinstance(r, ast.TableRef):
        text = _name(r.name)
        if r.alias:
            text += f" AS {_ident(r.alias)}"
        return text
    if isinstance(r, ast.SubqueryRelation):
        text = f"({format_query(r.query)})"
        if r.alias:
            text += f" AS {_ident(r.alias)}"
            if r.column_aliases:
                text += "(" + ", ".join(
                    _ident(c) for c in r.column_aliases
                ) + ")"
        return text
    if isinstance(r, ast.Join):
        left = _relation(r.left)
        right = r.right
        # nested joins on the right need parens to keep associativity
        rtext = (
            f"({_relation(right)})"
            if isinstance(right, ast.Join)
            else _relation(right)
        )
        if r.kind == "cross":
            return f"{left} CROSS JOIN {rtext}"
        kw = {"inner": "INNER JOIN", "left": "LEFT JOIN",
              "right": "RIGHT JOIN", "full": "FULL JOIN"}[r.kind]
        text = f"{left} {kw} {rtext}"
        if r.using:
            text += " USING (" + ", ".join(_ident(c) for c in r.using) + ")"
        elif r.condition is not None:
            text += f" ON {_expr(r.condition)}"
        return text
    if isinstance(r, ast.MatchRecognizeRelation):
        inner = []
        if r.partition_by:
            inner.append(
                "PARTITION BY " + ", ".join(_expr(x) for x in r.partition_by)
            )
        if r.order_by:
            inner.append(
                "ORDER BY " + ", ".join(_sort_item(s) for s in r.order_by)
            )
        if r.measures:
            inner.append("MEASURES " + ", ".join(
                f"{_expr(m.expr)} AS {_ident(m.name)}" for m in r.measures
            ))
        inner.append(
            "ONE ROW PER MATCH" if r.rows_per_match == "one"
            else "ALL ROWS PER MATCH"
        )
        inner.append(
            "AFTER MATCH SKIP PAST LAST ROW"
            if r.after_match == "past_last"
            else "AFTER MATCH SKIP TO NEXT ROW"
        )
        inner.append(f"PATTERN ({_pattern(r.pattern)})")
        inner.append("DEFINE " + ", ".join(
            f"{_ident(v)} AS {_expr(c)}" for v, c in r.defines
        ))
        text = f"{_relation(r.input)} MATCH_RECOGNIZE ({' '.join(inner)})"
        if r.alias:
            text += f" AS {_ident(r.alias)}"
        return text
    if isinstance(r, ast.TableFunctionRelation):
        parts = []
        for a in r.args:
            parts.append(_tf_arg(a))
        for n, a in r.named_args:
            parts.append(f"{_ident(n)} => {_tf_arg(a)}")
        text = f"TABLE({_name(r.name)}({', '.join(parts)}))"
        if r.alias:
            text += f" AS {_ident(r.alias)}"
            if r.column_aliases:
                text += "(" + ", ".join(
                    _ident(c) for c in r.column_aliases
                ) + ")"
        return text
    if isinstance(r, ast.UnnestRelation):
        text = "UNNEST(" + ", ".join(_expr(a) for a in r.arrays) + ")"
        if r.ordinality:
            text += " WITH ORDINALITY"
        if r.alias:
            text += f" AS {_ident(r.alias)}"
            if r.column_aliases:
                text += "(" + ", ".join(
                    _ident(c) for c in r.column_aliases
                ) + ")"
        return text
    raise NotImplementedError(f"cannot format {type(r).__name__}")


def _pattern(node) -> str:
    kind = node[0]
    if kind == "var":
        return _ident(node[1])
    if kind == "seq":
        return " ".join(
            f"({_pattern(p)})" if p[0] == "alt" else _pattern(p)
            for p in node[1]
        )
    if kind == "alt":
        return " | ".join(_pattern(p) for p in node[1])
    inner = node[1]
    body = (
        f"({_pattern(inner)})"
        if inner[0] in ("seq", "alt")
        else _pattern(inner)
    )
    if kind == "star":
        return body + "*"
    if kind == "plus":
        return body + "+"
    if kind == "opt":
        return body + "?"
    lo, hi = node[2], node[3]
    if hi == lo:
        return f"{body}{{{lo}}}"
    return f"{body}{{{lo},{'' if hi is None else hi}}}"


def _tf_arg(a) -> str:
    if isinstance(a, ast.TableArg):
        return f"TABLE({_relation(a.relation)})"
    if isinstance(a, ast.Descriptor):
        return "DESCRIPTOR(" + ", ".join(_ident(n) for n in a.names) + ")"
    return _expr(a)


# ---------------------------------------------------------------------------
# query bodies & statements
# ---------------------------------------------------------------------------


def _group_by(spec: ast.QuerySpec) -> Optional[str]:
    if not spec.group_by:
        return None
    exprs = [_expr(g) for g in spec.group_by]
    if spec.group_by_sets is None:
        return "GROUP BY " + ", ".join(exprs)
    # grouping-set index tuples render back as explicit GROUPING SETS —
    # ROLLUP/CUBE sugar is already desugared by the parser and the
    # explicit form re-parses to the identical index sets
    sets = ", ".join(
        "(" + ", ".join(exprs[i] for i in s) + ")"
        for s in spec.group_by_sets
    )
    return f"GROUP BY GROUPING SETS ({sets})"


def _query_spec(spec: ast.QuerySpec) -> str:
    parts = ["SELECT"]
    if spec.distinct:
        parts.append("DISTINCT")
    items = []
    for it in spec.select:
        text = _expr(it.expr)
        if it.alias:
            text += f" AS {_ident(it.alias)}"
        items.append(text)
    parts.append(", ".join(items))
    if spec.from_ is not None:
        parts.append("FROM " + _relation(spec.from_))
    if spec.where is not None:
        parts.append("WHERE " + _expr(spec.where))
    gb = _group_by(spec)
    if gb:
        parts.append(gb)
    if spec.having is not None:
        parts.append("HAVING " + _expr(spec.having))
    return " ".join(parts)


def _body(body) -> str:
    if isinstance(body, ast.QuerySpec):
        return _query_spec(body)
    if isinstance(body, ast.SetOperation):
        kw = body.op.upper() + (" ALL" if body.all else "")
        left = _body(body.left)
        right = body.right
        rtext = (
            f"({_body(right)})"
            if isinstance(right, ast.SetOperation)
            else _body(right)
        )
        return f"{left} {kw} {rtext}"
    if isinstance(body, ast.ValuesBody):
        rows = ", ".join(
            "(" + ", ".join(_expr(e) for e in row) + ")"
            for row in body.rows
        )
        return "VALUES " + rows
    raise NotImplementedError(f"cannot format {type(body).__name__}")


def format_query(q: ast.Query) -> str:
    parts = []
    if q.with_:
        ctes = []
        for w in q.with_:
            head = _ident(w.name)
            if w.column_names:
                head += "(" + ", ".join(
                    _ident(c) for c in w.column_names
                ) + ")"
            ctes.append(f"{head} AS ({format_query(w.query)})")
        parts.append("WITH " + ", ".join(ctes))
    parts.append(_body(q.body))
    if q.order_by:
        parts.append(
            "ORDER BY " + ", ".join(_sort_item(s) for s in q.order_by)
        )
    if q.offset:
        parts.append(f"OFFSET {q.offset}")
    if q.limit is not None:
        parts.append(f"LIMIT {q.limit}")
    return " ".join(parts)


def format_statement(node: ast.Node) -> str:
    """Render any statement node produced by parser.parse_statement."""
    if isinstance(node, ast.Query):
        return format_query(node)
    if isinstance(node, ast.ExplainStatement):
        kw = "EXPLAIN ANALYZE" if node.analyze else "EXPLAIN"
        return f"{kw} {format_query(node.query)}"
    if isinstance(node, ast.CreateTable):
        cols = ", ".join(
            f"{_ident(n)} {_type(t)}" for n, t in node.columns
        )
        return f"CREATE TABLE {_name(node.table)} ({cols})"
    if isinstance(node, ast.CreateTableAs):
        return (
            f"CREATE TABLE {_name(node.table)} AS {format_query(node.query)}"
        )
    if isinstance(node, ast.Insert):
        cols = (
            " (" + ", ".join(_ident(c) for c in node.columns) + ")"
            if node.columns
            else ""
        )
        return f"INSERT INTO {_name(node.table)}{cols} {format_query(node.query)}"
    if isinstance(node, ast.DropTable):
        return f"DROP TABLE {_name(node.table)}"
    if isinstance(node, ast.Delete):
        text = f"DELETE FROM {_name(node.table)}"
        if node.where is not None:
            text += f" WHERE {_expr(node.where)}"
        return text
    if isinstance(node, ast.Update):
        sets = ", ".join(
            f"{_ident(c)} = {_expr(e)}" for c, e in node.assignments
        )
        text = f"UPDATE {_name(node.table)} SET {sets}"
        if node.where is not None:
            text += f" WHERE {_expr(node.where)}"
        return text
    if isinstance(node, ast.SetSession):
        return f"SET SESSION {node.name} = {node.value}"
    if isinstance(node, ast.StartTransaction):
        return "START TRANSACTION" + (
            " READ ONLY" if node.read_only else ""
        )
    if isinstance(node, ast.Commit):
        return "COMMIT"
    if isinstance(node, ast.Rollback):
        return "ROLLBACK"
    if isinstance(node, ast.ShowSession):
        return "SHOW SESSION"
    if isinstance(node, ast.ShowTables):
        if node.schema:
            return f"SHOW TABLES FROM {_name(node.schema)}"
        return "SHOW TABLES"
    if isinstance(node, ast.ShowSchemas):
        if node.catalog:
            return f"SHOW SCHEMAS FROM {_ident(node.catalog)}"
        return "SHOW SCHEMAS"
    if isinstance(node, ast.ShowColumns):
        return f"SHOW COLUMNS FROM {_name(node.table)}"
    if isinstance(node, ast.ShowFunctions):
        return "SHOW FUNCTIONS"
    raise NotImplementedError(f"cannot format {type(node).__name__}")

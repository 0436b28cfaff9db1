"""Inter-query micro-batching: one device step for many point lookups.

Counterpart of trino_tpu/serving/batcher.py (host code). The
classifier stays strict; where the reference turns any exception of
classification into "not batchable", the port does so only for the
statement's own faults (a parse error, a bad parameter binding: the
cold path then reports them), and lets anything else propagate. And
one batch of a group key executes at a time: a leader whose window
ends while a batch of its key still executes keeps its group open
until that batch is done. The reference's executions run outside the
interpreter lock and keep their clients in step; the port's Python
between kernels does not, so concurrent leaders of one key would each
take the lock in turn, spread their clients' next arrivals apart and
coalesce nothing.

Concurrent point lookups against the same table and key column are
individually tiny — each one pays a full scheduling round and its own
device dispatch for a handful of rows. When several arrive within a
short window they share an XLA shape class anyway (same operator tree,
same capacity rung, same dtypes), so the batcher coalesces them into
ONE rewritten query

    SELECT <key>, <cols> FROM t WHERE <key> IN (v1, ..., vN)

executes it once, and demultiplexes the result rows back to each
caller by key value. The IN list is padded to a power-of-two length by
repeating the last value (duplicates are harmless under demux-by-
equality), so N concurrent clients produce O(log N) distinct canonical
texts instead of N — repeat traffic re-lands on both the plan cache
and the compiled-program cache.

Leader/follower protocol: the first arrival in a (user, table, key
column, select list, key dtype) group becomes the leader, sleeps the
batch window (or until the group hits max_batch), then executes the
combined query and distributes per-member results. Followers block on
their member event. Classification is STRICT — single TableRef, WHERE
exactly `key = literal`, plain-identifier select list, integer or
string key (float equality is never a point lookup) — and anything
surprising returns None so the caller falls through to the normal
execute path.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.analysis.witness import named_lock

# follower safety net: if the leader thread dies without settling the
# group (executor torn down mid-batch), members unblock and re-raise
# rather than hang the server thread forever
_MEMBER_WAIT_S = 60.0


class _Member:
    __slots__ = ("value", "value_sql", "event", "result", "error")

    def __init__(self, value, value_sql):
        self.value = value
        self.value_sql = value_sql
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Group:
    __slots__ = ("ctx", "members", "closed", "full")

    def __init__(self, ctx):
        self.ctx = ctx  # _Lookup of the FIRST member (shared shape)
        self.members: List[_Member] = []
        self.closed = False
        self.full = threading.Event()


class _Lookup:
    """A classified point lookup: everything needed to key the group
    and to rebuild the combined query."""

    __slots__ = ("group_key", "table_sql", "key_col", "select_sql", "value",
                 "value_sql")

    def __init__(self, group_key, table_sql, key_col, select_sql, value,
                 value_sql):
        self.group_key = group_key
        self.table_sql = table_sql
        self.key_col = key_col
        self.select_sql = select_sql
        self.value = value
        self.value_sql = value_sql


def classify(sql: str, runner=None, prepared=None) -> Optional[_Lookup]:
    """Strict point-lookup classification; None = not batchable."""
    try:
        return _classify(sql, runner, prepared)
    except ValueError:  # ParsingError, a parameter binding's arity
        return None


def _classify(sql: str, runner, prepared) -> Optional[_Lookup]:
    from trino_tpu_torch.sql import ast
    from trino_tpu_torch.sql.parser import parse

    stmt = parse(sql)
    if isinstance(stmt, ast.ExecuteStmt):
        text = (prepared or {}).get(stmt.name)
        if text is None and runner is not None:
            store = getattr(runner, "_prepared", None)
            if store is None and hasattr(runner, "_embedded_runner"):
                store = runner._embedded_runner()._prepared
            hit = (store or {}).get(stmt.name)
            text = hit[1] if hit else None
        if text is None:
            return None
        stmt = ast.substitute_parameters(parse(text), stmt.parameters)
    if not isinstance(stmt, ast.Query):
        return None
    if stmt.with_ or stmt.order_by or stmt.limit is not None or stmt.offset:
        return None
    spec = stmt.body
    if not isinstance(spec, ast.QuerySpec):
        return None
    if (spec.distinct or spec.group_by or spec.having is not None
            or spec.group_by_sets is not None):
        return None
    if not isinstance(spec.from_, ast.TableRef) or spec.from_.alias:
        return None
    # WHERE must be exactly `key = literal` (either side order)
    w = spec.where
    if not isinstance(w, ast.BinaryOp) or w.op not in ("eq", "="):
        return None
    ident, lit = w.left, w.right
    if not isinstance(ident, ast.Identifier):
        ident, lit = w.right, w.left
    if not isinstance(ident, ast.Identifier) or len(ident.parts) != 1:
        return None
    if isinstance(lit, ast.NumberLiteral):
        text = lit.text.lower()
        if "." in text or "e" in text:
            return None  # float equality is never a point lookup
        value = int(lit.text)
        dkind = "i"
    elif isinstance(lit, ast.StringLiteral):
        value = lit.value
        dkind = "s"
    else:
        return None
    # select list: plain unaliased single-part identifiers only
    cols = []
    for item in spec.select:
        if item.alias is not None:
            return None
        e = item.expr
        if not isinstance(e, ast.Identifier) or len(e.parts) != 1:
            return None
        cols.append(e.parts[0])
    if not cols:
        return None
    from trino_tpu_torch.sql.formatter import format_expression

    table_sql = ".".join(spec.from_.name)
    key_col = ident.parts[0]
    select_sql = ", ".join(cols)
    group_key = (table_sql, key_col, select_sql, dkind)
    return _Lookup(
        group_key, table_sql, key_col, select_sql, value,
        format_expression(lit),
    )


class MicroBatcher:
    """submit() either returns a demultiplexed MaterializedResult (the
    query was coalesced) or None (not batchable — caller executes it
    normally). Exceptions from the shared execution propagate to every
    member of the batch."""

    def __init__(self, runner, window_s: float = 0.002, max_batch: int = 16):
        self.runner = runner
        self.window_s = window_s
        self.max_batch = max(1, int(max_batch))
        self._lock = named_lock("MicroBatcher._lock")
        self._idle = threading.Condition(self._lock)  # a key's batch ended
        self._groups: Dict[Tuple, _Group] = {}
        self._executing: set = set()  # group keys with a batch executing
        self.batches = 0
        self.batched_queries = 0

    def submit(self, sql: str, identity=None, prepared=None):
        look = classify(sql, runner=self.runner, prepared=prepared)
        if look is None:
            return None
        # the combined query executes under ONE identity: never coalesce
        # across users, or the leader's permissions would leak to all
        gkey = look.group_key + (getattr(identity, "user", None),)
        look.group_key = gkey
        member = _Member(look.value, look.value_sql)
        with self._lock:
            group = self._groups.get(look.group_key)
            if group is None or group.closed:
                group = _Group(look)
                self._groups[look.group_key] = group
                leader = True
            else:
                leader = False
            group.members.append(member)
            if len(group.members) >= self.max_batch:
                group.closed = True
                group.full.set()
        if leader:
            group.full.wait(self.window_s)
            with self._lock:
                # the group takes arrivals until its key's batch in
                # flight is done (or it fills)
                while gkey in self._executing:
                    self._idle.wait()
                self._executing.add(gkey)
                group.closed = True
                if self._groups.get(gkey) is group:
                    del self._groups[gkey]
                members = list(group.members)
            try:
                self._run_group(group.ctx, members, identity)
            finally:
                with self._lock:
                    self._executing.discard(gkey)
                    self._idle.notify_all()
        else:
            if not member.event.wait(_MEMBER_WAIT_S):
                raise RuntimeError(
                    "micro-batch leader never settled the group "
                    f"(waited {_MEMBER_WAIT_S:g}s)"
                )
        if member.error is not None:
            raise member.error
        return member.result

    def _run_group(self, ctx: _Lookup, members: List[_Member], identity):
        from trino_tpu_torch.runtime.metrics import METRICS

        try:
            # dedupe + sort the key values, then pad to the next power
            # of two by repeating the last value: the combined canonical
            # text is a function of the VALUE SET, not of arrival order
            # or multiplicity, so a hot key pool produces a small, fast-
            # warming family of texts that re-land on cached plans and
            # warm lowerings
            values_sql = sorted({m.value_sql for m in members})
            n = 1
            while n < len(values_sql):
                n *= 2
            values_sql = values_sql + [values_sql[-1]] * (n - len(values_sql))
            combined = (
                f"SELECT {ctx.key_col}, {ctx.select_sql} "
                f"FROM {ctx.table_sql} "
                f"WHERE {ctx.key_col} IN ({', '.join(values_sql)})"
            )
            kwargs = {}
            if identity is not None:
                kwargs["identity"] = identity
            result = self.runner.execute(combined, **kwargs)
            from trino_tpu_torch.engine import MaterializedResult

            names = list(result.column_names[1:])
            types = list(result.column_types[1:])
            self.batches += 1
            self.batched_queries += len(members)
            METRICS.increment("batcher.batches")
            METRICS.increment("batcher.batched_queries", len(members))
            METRICS.observe("batcher.batch_size", float(len(members)))
            for m in members:
                rows = [list(r[1:]) for r in result.rows if r[0] == m.value]
                m.result = MaterializedResult(rows, names, types)
                m.event.set()
        except BaseException as e:
            for m in members:
                if not m.event.is_set():
                    m.error = e
                    m.event.set()
            # the leader's own submit() re-raises via member.error

    def stats(self) -> dict:
        with self._lock:
            return {
                "batches": self.batches,
                "batched_queries": self.batched_queries,
                "open_groups": len(self._groups),
            }

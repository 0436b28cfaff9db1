"""In-process query engine: SQL text in, rows out.

Counterpart of trino_tpu/engine.py (LocalQueryRunner: plan and execute
SQL fully in-process with real operators). The parse -> analyze ->
optimize chain is the reference's host code (copied under sql/); the
physical plan runs on one torch device.

Device selection: `LocalQueryRunner(session, device=None)` runs on the
CUDA card and raises when there is none; the CPU is used only when the
caller passes device="cpu". There is no fallback between the two.

The write side (the reference's engine.py:336-529, :687-1205): CREATE
TABLE, CREATE TABLE AS, INSERT, DELETE, UPDATE, MERGE, DROP TABLE and
START TRANSACTION / COMMIT / ROLLBACK. INSERT and CTAS stream a query
into the connector's page sink (TableWriterOperator, through
ScaledWriterSink for autocommit writes); DELETE, UPDATE and MERGE are
read-rewrites whose result batches replace the table's rows. Every
query they run plans on the runner's device.

Not ported yet: access control, EXPLAIN, SHOW, SET SESSION, prepared
statements and the plan cache (ROADMAP §1 item 8b), and the resident,
adaptive, recovery, serving, compile-cache, tracing and metrics tiers
(item 13).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.spi import CatalogManager, ColumnMetadata, Connector
from trino_tpu_torch.exec import (
    CollectorSink,
    Driver,
    Pipeline,
    ScaledWriterSink,
    TableWriterOperator,
)
from trino_tpu_torch.expr import ir
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql import plan as P
from trino_tpu_torch.sql.analyzer import (
    AnalysisError,
    Analyzer,
    resolve_type,
    set_session_info,
    set_session_zone,
)
from trino_tpu_torch.sql.local_planner import LocalPlanner
from trino_tpu_torch.sql.optimizer import canonicalize_tstz_keys, optimize
from trino_tpu_torch.sql.parser import parse
from trino_tpu_torch.transaction import TransactionError, TransactionManager

# statements the port does not run yet, all of ROADMAP §1 item 8b
_ITEM_8B = (ast.ExplainStatement, ast.SetSession, ast.ShowSession, ast.ShowFunctions,
            ast.ShowSchemas, ast.ShowTables, ast.ShowColumns, ast.Prepare,
            ast.ExecuteStmt, ast.Deallocate)


@dataclasses.dataclass
class Session:
    """Per-query context: the fields the ported query path reads.
    `batch_rows` counts source rows per scan chunk (orders for the
    lineitem generator), as in the reference."""

    catalog: str = "tpch"
    schema: str = "tiny"
    user: str = "user"
    timezone: str = "UTC"
    batch_rows: int = 1 << 20
    target_splits: int = 1
    enable_optimizer: bool = True
    join_reordering_strategy: str = "automatic"
    enable_pushdown: bool = True
    # the join-project route (ops/mxu_join.py) for a grouped aggregate
    # over a high-fanout inner equi-join, and its work threshold
    mxu_join_enabled: bool = False
    mxu_join_min_work: float = 16.0
    # writers per autocommit bulk write (ScaledWriterSink); 1 = one sink
    task_concurrency: int = 2


@dataclasses.dataclass
class MaterializedResult:
    rows: List[list]
    column_names: List[str]
    column_types: List[T.DataType]
    # START TRANSACTION's id, for explicit threading (execute's
    # transaction_id)
    started_transaction_id: Optional[str] = None

    def only_value(self):
        assert len(self.rows) == 1 and len(self.rows[0]) == 1, self.rows
        return self.rows[0][0]


def _raise_deferred_checks(ctx: dict) -> None:
    """Assertions deferred to the end of the query (the results are
    already materialized, so these bools are cheap)."""
    for flag, msg in ctx.get("deferred_checks", ()):
        if bool(flag):
            raise RuntimeError(msg)


def _done() -> MaterializedResult:
    return MaterializedResult([[True]], ["result"], [T.BOOLEAN])


def _count(n: int) -> MaterializedResult:
    return MaterializedResult([[n]], ["rows"], [T.BIGINT])


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card (raises when there is none); anything else
    is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: LocalQueryRunner runs on the card; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class LocalQueryRunner:
    def __init__(self, session: Optional[Session] = None, device=None):
        self.session = session or Session()
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.transactions = TransactionManager(self.catalogs)
        self._current_txn: Optional[str] = None
        # per-statement active transaction (explicit protocol threading)
        self._stmt_txn = threading.local()

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs.register(name, connector)

    # -- entry point --
    def execute(self, sql: str, transaction_id: Optional[str] = None) -> MaterializedResult:
        """`transaction_id` selects EXPLICIT transaction threading — the
        protocol model, where each client carries its own transaction id
        and the shared runner holds no cross-client state. Pass "NONE"
        for an autocommit statement in explicit mode. When None, the
        runner's own session transaction applies."""
        stmt = parse(sql)
        explicit = transaction_id is not None
        active = None if transaction_id in (None, "NONE") else transaction_id
        if not explicit:
            active = self._current_txn
        self._stmt_txn.value = active
        try:
            return self._dispatch(stmt, active, explicit)
        finally:
            self._stmt_txn.value = None

    def _active_txn(self) -> Optional[str]:
        return getattr(self._stmt_txn, "value", None)

    def _check_writable(self) -> None:
        txn = self._active_txn()
        if txn is not None and self.transactions.is_read_only(txn):
            raise TransactionError(
                "READ_ONLY_VIOLATION: cannot write in a read-only transaction"
            )

    def _dispatch(self, stmt, active: Optional[str], explicit: bool) -> MaterializedResult:
        # access control (check_can_*) waits for security.py, ROADMAP §1
        # item 8b: until then every statement is allowed, as under the
        # reference's default AllowAllAccessControl
        if isinstance(stmt, ast.Query):
            return self._execute_query(stmt)
        if isinstance(stmt, ast.StartTransaction):
            if active is not None:
                raise TransactionError("transaction already in progress")
            new_txn = self.transactions.begin(stmt.read_only)
            if not explicit:
                self._current_txn = new_txn
            return dataclasses.replace(_done(), started_transaction_id=new_txn)
        if isinstance(stmt, (ast.Commit, ast.Rollback)):
            if active is None:
                raise TransactionError("NOT_IN_TRANSACTION: no transaction in progress")
            try:
                if isinstance(stmt, ast.Commit):
                    self.transactions.commit(active)
                else:
                    self.transactions.rollback(active)
            finally:
                # a failed commit still ends the transaction (the
                # reference's semantics): never wedge the session
                if not explicit:
                    self._current_txn = None
            return _done()
        if isinstance(stmt, ast.CreateTable):
            _, conn, schema, table = self._resolve_target(stmt.table)
            self._check_writable()
            cols = [ColumnMetadata(n, resolve_type(t)) for n, t in stmt.columns]
            conn.metadata.create_table(schema, table, cols)
            return _done()
        if isinstance(stmt, ast.CreateTableAs):
            return self._execute_ctas(stmt)
        if isinstance(stmt, ast.Insert):
            return self._execute_insert(stmt.table, stmt.columns, stmt.query)
        if isinstance(stmt, ast.Delete):
            return self._execute_rewrite_dml(stmt.table, stmt.where, None)
        if isinstance(stmt, ast.Merge):
            return self._execute_merge(stmt)
        if isinstance(stmt, ast.Update):
            names = [c for c, _ in stmt.assignments]
            if len(set(names)) != len(names):
                raise AnalysisError("multiple assignments for the same column")
            return self._execute_rewrite_dml(stmt.table, stmt.where, dict(stmt.assignments))
        if isinstance(stmt, ast.DropTable):
            _, conn, schema, table = self._resolve_target(stmt.table)
            self._check_writable()
            handle = conn.metadata.get_table_handle(schema, table)
            if handle is None:
                raise AnalysisError(f"table {schema}.{table} does not exist")
            conn.metadata.drop_table(handle)
            return _done()
        if isinstance(stmt, _ITEM_8B):
            raise NotImplementedError(
                f"{type(stmt).__name__}: not in trino_tpu_torch yet (EXPLAIN, SHOW, "
                "SET SESSION and prepared statements: ROADMAP §1 item 8b)"
            )
        raise AnalysisError(f"cannot execute {type(stmt).__name__}")

    def _analyze(self, q: ast.Query):
        set_session_zone(self.session.timezone)
        set_session_info(
            self.session.catalog, self.session.schema, self.session.user
        )
        analyzer = Analyzer(
            self.catalogs, self.session.catalog, self.session.schema
        )
        root = optimize(analyzer.plan(q), self.catalogs, self.session)
        return canonicalize_tstz_keys(root)

    def _planner(self) -> LocalPlanner:
        return LocalPlanner(
            self.catalogs, self.device,
            batch_rows=self.session.batch_rows,
            target_splits=self.session.target_splits,
            mxu_join=self.session.mxu_join_enabled,
            mxu_join_min_work=self.session.mxu_join_min_work,
        )

    def _instantiate(self, node) -> tuple:
        """(ctx, pipelines, chain) of `node` planned on the runner's device."""
        ctx: dict = {}
        pipelines, chain = self._planner().plan(node).instantiate(ctx)
        return ctx, pipelines, chain

    @staticmethod
    def _drive(instance: tuple, sink) -> None:
        """Run an instantiated plan into `sink`: build pipelines first,
        in plan order (each fills the bridge that a later pipeline or
        the main chain probes)."""
        ctx, pipelines, chain = instance
        for ops in pipelines:
            Driver(Pipeline(ops)).run()
        Driver(Pipeline(chain + [sink])).run()
        _raise_deferred_checks(ctx)

    def _run(self, node, sink) -> None:
        self._drive(self._instantiate(node), sink)

    def _execute_query(self, q: ast.Query) -> MaterializedResult:
        output = self._analyze(q)
        sink = CollectorSink()
        self._run(output, sink)
        return MaterializedResult(
            sink.rows(), list(output.names), [f.type for f in output.fields]
        )

    # -- DML (BeginTableWrite/TableWriter/TableFinish path) --
    # The reference's _invalidate_plans serves the plan cache (item 8b)
    # and the resident tier (item 13); the port has neither, and the
    # memory connector drops a written table's device batches itself.
    def _resolve_target(self, parts):
        """(registered catalog name, connector, schema, table)."""
        cat, schema = self.session.catalog, self.session.schema
        table = parts[-1]
        if len(parts) == 2:
            schema = parts[0]
        elif len(parts) == 3:
            cat, schema = parts[0], parts[1]
        return cat, self.catalogs.get(cat), schema, table

    def _execute_ctas(self, stmt: ast.CreateTableAs) -> MaterializedResult:
        output = self._analyze(stmt.query)
        _, conn, schema, table = self._resolve_target(stmt.table)
        self._check_writable()  # before the table is created
        cols = [
            ColumnMetadata(n or f"_col{i}", f.type)
            for i, (n, f) in enumerate(zip(output.names, output.fields))
        ]
        conn.metadata.create_table(schema, table, cols)
        return self._write_into(conn, schema, table, output, list(output.names))

    def _execute_insert(self, parts, columns, query: ast.Query) -> MaterializedResult:
        _, conn, schema, table = self._resolve_target(parts)
        output = self._analyze(query)
        return self._write_into(
            conn, schema, table, output, list(columns) if columns else None
        )

    def _table(self, conn, schema: str, table: str):
        handle = conn.metadata.get_table_handle(schema, table)
        if handle is None:
            raise AnalysisError(f"table {schema}.{table} does not exist")
        return handle, conn.metadata.get_table_metadata(handle)

    def _execute_rewrite_dml(self, parts, where, assignments: Optional[dict]) -> MaterializedResult:
        """DELETE (assignments=None) / UPDATE as a read-rewrite: scan
        the surviving/updated rows into device batches and swap them in
        as the table's rows — the memory-connector analogue of the
        reference's row-level delete/update pushdown. The affected-row
        count comes from a matched-rows count pass."""
        _, conn, schema, table = self._resolve_target(parts)
        self._check_writable()
        if self._active_txn() is not None:
            raise TransactionError(
                "DELETE/UPDATE inside an explicit transaction is not supported"
            )
        handle, meta = self._table(conn, schema, table)
        if assignments is not None:
            known = {c.name for c in meta.columns}
            for col in assignments:
                if col not in known:
                    raise AnalysisError(f"unknown column {col} in UPDATE")
        rel = ast.TableRef(parts)
        matched = where if where is not None else ast.BooleanLiteral(True)
        count_q = ast.Query(ast.QuerySpec(
            (ast.SelectItem(ast.FunctionCall("count", (ast.Star(),))),),
            from_=rel, where=where,
        ))
        affected = self._execute_query(count_q).only_value()
        if assignments is None:
            if where is None:  # unconditional DELETE = truncate
                conn.metadata.truncate_table(handle)
                return _count(affected)
            # keep rows where the predicate is NOT TRUE
            keep = ast.UnaryOp(
                "not", ast.FunctionCall("coalesce", (where, ast.BooleanLiteral(False)))
            )
            select = tuple(ast.SelectItem(ast.Identifier((c.name,))) for c in meta.columns)
            rewrite_q = ast.Query(ast.QuerySpec(select, from_=rel, where=keep))
        else:
            # per column: CASE WHEN pred THEN new ELSE old END
            items = []
            for c in meta.columns:
                old = ast.Identifier((c.name,))
                e = old
                if c.name in assignments:
                    new = assignments[c.name]
                    e = (ast.Case(None, (ast.WhenClause(matched, new),), old)
                         if where is not None else new)
                items.append(ast.SelectItem(e, c.name))
            rewrite_q = ast.Query(ast.QuerySpec(tuple(items), from_=rel))
        self._replace_table_from_queries(conn, handle, meta, [rewrite_q])
        return _count(affected)

    def _coerced(self, output, meta, sources) -> P.ProjectNode:
        """`output`'s rows projected onto the table schema: column i
        takes source channel sources[i] (None: a NULL), cast where the
        types differ."""
        exprs = []
        for col, i in zip(meta.columns, sources):
            if i is None:
                exprs.append(ir.Cast(ir.Literal(None, T.UNKNOWN), col.type))
                continue
            e: ir.Expr = ir.InputRef(i, output.fields[i].type)
            if output.fields[i].type != col.type:
                e = ir.Cast(e, col.type)
            exprs.append(e)
        fields = tuple(P.Field(c.name, c.type) for c in meta.columns)
        return P.ProjectNode(output.child, tuple(exprs), fields)

    def _replace_table_from_queries(self, conn, handle, meta, queries) -> List[int]:
        """Materialize each rewrite query, coerce onto the table schema,
        and swap the combined batches in as the table's new contents
        (shared by DELETE/UPDATE/MERGE; MERGE runs survivors and inserts
        as separate queries so their string columns keep independent
        dictionaries). Returns the per-query row counts (MERGE reads the
        insert count)."""
        batches = []
        counts = []
        for rewrite_q in queries:
            output = self._analyze(rewrite_q)
            sink = CollectorSink()
            self._run(self._coerced(output, meta, range(len(meta.columns))), sink)
            counts.append(sum(b.row_count() for b in sink.batches))
            batches.extend(sink.batches)
        replace = getattr(conn, "replace_rows", None)
        if replace is not None:  # atomic: stage, then swap
            replace(handle, batches)
        else:  # truncate + append: NOT crash-atomic
            conn.metadata.truncate_table(handle)
            writer_sink = conn.page_sink(handle)
            for b in batches:
                writer_sink.append(b)
            writer_sink.finish()
        return counts

    def _execute_merge(self, stmt: ast.Merge) -> MaterializedResult:
        """MERGE as a read-rewrite over the query machinery
        (parser/sql/tree/Merge.java): survivors and inserts become the
        table's new contents, as for DELETE/UPDATE.

        - survivors: target LEFT JOIN source; per column a CASE chain
          applies the FIRST matching WHEN MATCHED arm; rows whose first
          arm is DELETE drop.
        - inserts: source rows with NO target match (NOT EXISTS) and a
          matching WHEN NOT MATCHED arm.
        - a target row matching >1 source rows is an error (Trino's
          MERGE cardinality rule), checked with a row_number-keyed
          grouped count before the rewrite."""
        _, conn, schema, table = self._resolve_target(stmt.table)
        self._check_writable()
        if self._active_txn() is not None:
            raise TransactionError("MERGE inside an explicit transaction is not supported")
        handle, meta = self._table(conn, schema, table)
        known = {c.name for c in meta.columns}
        for cl in stmt.clauses:
            set_names = [c for c, _ in cl.assignments]
            if len(set(set_names)) != len(set_names):
                raise AnalysisError("multiple assignments for the same column in MERGE")
            for col in set_names:
                if col not in known:
                    raise AnalysisError(f"unknown column {col} in MERGE")
            if cl.action == "insert":
                cols = cl.insert_columns or tuple(c.name for c in meta.columns)
                if len(cols) != len(cl.insert_values):
                    raise AnalysisError("MERGE INSERT column/value count mismatch")
                for col in cols:
                    if col not in known:
                        raise AnalysisError(f"unknown column {col} in MERGE INSERT")

        t_alias = stmt.target_alias or table
        s_alias = getattr(stmt.source, "alias", None)
        if s_alias is None and isinstance(stmt.source, ast.TableRef):
            s_alias = stmt.source.name[-1]
        if s_alias is None:
            raise AnalysisError("MERGE source requires an alias")
        target_rel = ast.TableRef(stmt.table, alias=t_alias)
        true_lit = ast.BooleanLiteral(True)
        false_lit = ast.BooleanLiteral(False)
        count_star = ast.SelectItem(ast.FunctionCall("count", (ast.Star(),)))

        def tcol(name: str) -> ast.Identifier:
            return ast.Identifier((t_alias, name))

        def any_of(clauses):
            out = None
            for cl in clauses:
                c = cl.condition or true_lit
                out = c if out is None else ast.BinaryOp("or", out, c)
            return out

        m_clauses = [c for c in stmt.clauses if c.matched]
        nm_clauses = [c for c in stmt.clauses if not c.matched]
        # cardinality rule: no target row may match more than one
        # source row (io.trino MERGE_TARGET_ROW_MULTIPLE_MATCHES)
        rid_target = ast.SubqueryRelation(
            ast.Query(ast.QuerySpec(
                (ast.SelectItem(ast.Star()),
                 ast.SelectItem(ast.WindowCall("row_number", (), ast.WindowSpec()),
                                "__merge_rid")),
                from_=ast.TableRef(stmt.table),
            )),
            alias=t_alias,
        )
        dup_q = ast.Query(ast.QuerySpec(
            (count_star,),
            from_=ast.SubqueryRelation(
                ast.Query(ast.QuerySpec(
                    (ast.SelectItem(tcol("__merge_rid")),),
                    from_=ast.Join("inner", rid_target, stmt.source, stmt.on),
                    group_by=(tcol("__merge_rid"),),
                    having=ast.BinaryOp(
                        "gt", ast.FunctionCall("count", (ast.Star(),)),
                        ast.NumberLiteral("1"),
                    ),
                )),
                alias="__merge_dups",
            ),
        ))
        if m_clauses and self._execute_query(dup_q).only_value() > 0:
            raise RuntimeError("One MERGE target table row matched more than one source row")

        # the matched flag rides the source side of the LEFT JOIN
        flagged_source = ast.SubqueryRelation(
            ast.Query(ast.QuerySpec(
                (ast.SelectItem(ast.Star()), ast.SelectItem(true_lit, "__merge_m")),
                from_=stmt.source,
            )),
            alias=s_alias,
        )
        matched = ast.FunctionCall(
            "coalesce", (ast.Identifier((s_alias, "__merge_m")), false_lit)
        )
        # survivors: per column, the FIRST matching arm's value. With no
        # WHEN MATCHED arm the target is untouched and must NOT join (a
        # LEFT JOIN would fan out on multiple source matches, which
        # insert-only MERGE legally allows)
        if not m_clauses:
            survivors = ast.QuerySpec(
                tuple(ast.SelectItem(tcol(c.name), c.name) for c in meta.columns),
                from_=target_rel,
            )
        else:
            items = []
            for col in meta.columns:
                old = tcol(col.name)
                whens = []
                for cl in m_clauses:
                    cond = cl.condition or true_lit
                    val = (dict(cl.assignments).get(col.name, old)
                           if cl.action == "update" else old)
                    whens.append(ast.WhenClause(ast.BinaryOp("and", matched, cond), val))
                items.append(ast.SelectItem(ast.Case(None, tuple(whens), old), col.name))
            # a row drops iff matched AND its first applicable arm is DELETE
            del_whens = [
                ast.WhenClause(cl.condition or true_lit,
                               true_lit if cl.action == "delete" else false_lit)
                for cl in m_clauses
            ]
            drop = ast.BinaryOp("and", matched, ast.Case(None, tuple(del_whens), false_lit))
            survivors = ast.QuerySpec(
                tuple(items),
                from_=ast.Join("left", target_rel, flagged_source, stmt.on),
                where=ast.UnaryOp("not", drop),
            )
        # affected rows: matched pairs whose first arm applies + inserts
        updated = 0
        if m_clauses:
            updated = self._execute_query(ast.Query(ast.QuerySpec(
                (count_star,),
                from_=ast.Join("inner", target_rel, stmt.source, stmt.on),
                where=any_of(m_clauses),
            ))).only_value()
        queries = [ast.Query(survivors)]
        if nm_clauses:
            anti = ast.Exists(ast.Query(ast.QuerySpec(
                (ast.SelectItem(ast.NumberLiteral("1")),),
                from_=target_rel, where=stmt.on,
            )), negated=True)
            ins_items = []
            for col in meta.columns:
                whens = []
                for cl in nm_clauses:
                    cols = cl.insert_columns or tuple(c.name for c in meta.columns)
                    val = dict(zip(cols, cl.insert_values)).get(col.name, ast.NullLiteral())
                    whens.append(ast.WhenClause(cl.condition or true_lit, val))
                ins_items.append(ast.SelectItem(
                    ast.Case(None, tuple(whens), ast.NullLiteral()), col.name))
            queries.append(ast.Query(ast.QuerySpec(
                tuple(ins_items), from_=stmt.source,
                where=ast.BinaryOp("and", anti, any_of(nm_clauses)),
            )))
        counts = self._replace_table_from_queries(conn, handle, meta, queries)
        # the insert rewrite IS the anti join: its row count is the
        # inserted count (no third join execution)
        inserted = counts[1] if nm_clauses else 0
        return _count(updated + inserted)

    def _write_into(self, conn, schema: str, table: str, output,
                    insert_columns: Optional[List[str]]) -> MaterializedResult:
        """Coerce the source onto the table schema and stream it into
        the connector page sink (TableWriterOperator)."""
        handle, meta = self._table(conn, schema, table)
        src_fields = output.fields
        if insert_columns is None:
            insert_columns = [c.name for c in meta.columns[: len(src_fields)]]
        if len(insert_columns) != len(src_fields):
            raise AnalysisError(
                f"INSERT has {len(src_fields)} columns but {len(insert_columns)} targets"
            )
        if len(set(insert_columns)) != len(insert_columns):
            raise AnalysisError("duplicate target column names in INSERT/CTAS")
        src_of = {name: i for i, name in enumerate(insert_columns)}
        instance = self._instantiate(
            self._coerced(output, meta, [src_of.get(c.name) for c in meta.columns]))
        self._check_writable()
        active = self._active_txn()
        txn_handle = (self.transactions.join(active, conn.name, conn)
                      if active is not None else None)
        if txn_handle is None and self.session.task_concurrency > 1:
            # autocommit bulk writes scale out with observed volume;
            # transactional writes keep ONE sink so the commit stays a
            # single handshake
            sink_impl = ScaledWriterSink(lambda: conn.page_sink(handle),
                                         max_writers=self.session.task_concurrency)
        else:
            sink_impl = conn.page_sink(handle, transaction=txn_handle)
        # the resident tier's delta tap (fastlane.TeeSink) is item 13
        writer = TableWriterOperator(sink_impl)
        self._drive(instance, writer)
        return _count(writer.rows_written)

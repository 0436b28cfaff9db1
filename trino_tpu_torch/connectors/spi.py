"""Connector SPI.

The plugin boundary between the engine and data sources — the analogue
of spi/connector/: ConnectorMetadata (spi/connector/ConnectorMetadata.java:64),
ConnectorSplitManager, ConnectorPageSourceProvider
(spi/connector/ConnectorPageSource.java:24) and the Plugin registration
surface (spi/Plugin.java:35), reduced to the capability set the
ported engine consumes: the read side, and the write side of DDL/DML
(create/drop/truncate, page sinks, connector transactions). Deltas from
the reference:

- Page sources yield ``RelBatch`` (device-ready SoA) instead of
  Page/Block, and declare *table-stable dictionaries* per string column
  so expression binding happens once per pipeline (see expr/compile.py).
- Splits carry explicit row ranges; a split is the unit of source
  parallelism (SOURCE_DISTRIBUTION — SystemPartitioningHandle.java:55).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.block import Dictionary, RelBatch
from trino_tpu_torch.transaction import ConnectorTransactionHandle


@dataclasses.dataclass(frozen=True)
class ColumnMetadata:
    name: str
    type: T.DataType


@dataclasses.dataclass(frozen=True)
class TableMetadata:
    schema: str
    name: str
    columns: Tuple[ColumnMetadata, ...]

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ColumnConstraint:
    """One pushed-down per-column predicate — the scalar reduction of
    spi/predicate/TupleDomain: `column op value` with op in
    {lt, le, gt, ge, eq, ne}. `value` is a python scalar in the
    column's PHYSICAL value space (epoch days for DATE, scaled ints for
    DECIMAL), matching what the connector's page source materializes."""

    column: str
    op: str
    value: Any


@dataclasses.dataclass(frozen=True)
class TableHandle:
    """Engine-side opaque reference to a connector table."""

    catalog: str
    schema: str
    table: str
    # connector-private payload (e.g. tpch scale factor)
    payload: Any = None
    # constraints the connector has ACCEPTED via apply_filter — every
    # row its page source emits for this handle satisfies all of them
    constraints: Tuple[ColumnConstraint, ...] = ()


@dataclasses.dataclass(frozen=True)
class Split:
    """A retryable unit of scan work (spi/connector/ConnectorSplit.java).
    `row_range` is [start, end) within the table for generator/memory
    connectors; `payload` is connector-private."""

    table: TableHandle
    seq: int
    row_range: Optional[Tuple[int, int]] = None
    payload: Any = None


@dataclasses.dataclass
class TableStatistics:
    """CBO inputs (spi/statistics/TableStatistics.java)."""

    row_count: Optional[float] = None
    # per-column: distinct count, null fraction, min, max
    columns: Dict[str, Tuple[Optional[float], Optional[float], Any, Any]] = dataclasses.field(
        default_factory=dict
    )


class ConnectorMetadata:
    """Per-connector metadata surface (ConnectorMetadata.java:64)."""

    def list_schemas(self) -> List[str]:
        raise NotImplementedError

    def list_tables(self, schema: str) -> List[str]:
        raise NotImplementedError

    def get_table_handle(self, schema: str, table: str) -> Optional[TableHandle]:
        raise NotImplementedError

    def get_table_metadata(self, handle: TableHandle) -> TableMetadata:
        raise NotImplementedError

    def column_dictionary(self, handle: TableHandle, column: str) -> Optional[Dictionary]:
        """Table-stable dictionary for a string column (None for
        non-string). Called at plan time so binding can be pipeline-wide."""
        return None

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        return TableStatistics()

    def apply_filter(
        self, handle: TableHandle, constraints: Sequence[ColumnConstraint]
    ) -> Optional[Tuple[TableHandle, Tuple[ColumnConstraint, ...]]]:
        """PushPredicateIntoTableScan seat (the reference's
        ConnectorMetadata.applyFilter, ConnectorMetadata.java:1290):
        offered the scan-pushable conjuncts of a filter above this
        table's scan. Return None when nothing can be pushed, or
        ``(new_handle, residual)`` where ``new_handle`` carries the
        accepted constraints (by convention in
        ``TableHandle.constraints``) and ``residual`` lists the OFFERED
        constraints this connector will not fully enforce — the engine
        keeps their conjuncts in a FilterNode above the scan.

        Enforcement contract: the page source must emit NO row that
        violates an accepted constraint (full enforcement; connectors
        that can only prune coarsely, e.g. by row group, must re-filter
        exactly or leave the constraint in ``residual``)."""
        return None

    def apply_projection(
        self, handle: TableHandle, columns: Sequence[str]
    ) -> Optional[TableHandle]:
        """PushProjectionIntoTableScan seat: asked to narrow the scan to
        `columns` (a subset of the table's columns, in scan order).
        Return a handle whose page source materializes ONLY those
        columns (sources that already honor the per-call ``columns``
        projection may return ``handle`` unchanged), or None when
        unsupported — the engine then keeps the wide scan."""
        return None

    def table_partitioning(self, handle: TableHandle) -> Optional[Tuple[str, ...]]:
        """Declared bucketing of a table: the ordered key columns whose
        engine-hash buckets the connector's splits are 1:1 with (split i
        holds exactly the rows where partition_of(hash32(keys), n)==i),
        or None when splits are arbitrary row ranges. The planner uses
        this to cancel repartition exchanges over co-bucketed tables —
        the ConnectorTablePartitioning / NodePartitioningManager.java:96
        seat (TpchNodePartitioningProvider.java:46 declares the same for
        the reference's tpch connector). A connector must only declare
        this if its split manager honors ANY requested split count with
        engine-hash buckets (ops/hashing.hash32_np is the lock-step
        host-side bucket function)."""
        return None

    # -- writes (optional capability) --
    def create_table(self, schema: str, table: str,
                     columns: Sequence[ColumnMetadata]) -> TableHandle:
        raise NotImplementedError(f"{type(self).__name__} does not support CREATE TABLE")

    def drop_table(self, handle: TableHandle) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support DROP TABLE")

    def truncate_table(self, handle: TableHandle) -> None:
        """Remove all rows, keeping the table (DELETE/UPDATE rewrite
        support; the reference's ConnectorMetadata.executeDelete
        whole-table path)."""
        raise NotImplementedError(f"{type(self).__name__} does not support DELETE")


class ConnectorSplitManager:
    def get_splits(self, handle: TableHandle, target_split_count: int) -> List[Split]:
        raise NotImplementedError

    def invalidate_cache(self) -> None:
        """Drop any cached split listings (a whole-query retry replays
        against a fresh listing). Default: stateless split managers
        have nothing to drop."""


class ConnectorPageSource:
    """Produces batches for one split (ConnectorPageSource.java:24).
    `columns` is the pruned projection (channel names); `device` is
    where the yielded batches' tensors live (the runner's device)."""

    def batches(self, split: Split, columns: Sequence[str], batch_rows: int,
                device="cpu", stabilizer=None) -> Iterator[RelBatch]:
        raise NotImplementedError


class ConnectorPageSink:
    """Accepts batches for a write (ConnectorPageSinkProvider analogue).
    Batches arrive on the runner's device; a sink copies the live rows
    it keeps to the host."""

    def append(self, batch: RelBatch) -> None:
        raise NotImplementedError

    def finish(self) -> int:
        """Commit; returns row count written."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TableFunction:
    """A connector-provided polymorphic table function
    (spi/ptf/ConnectorTableFunction.java analogue, reduced to the
    scalar-argument form: `fn(args) -> (columns, rows)` evaluated at
    plan time; table-valued arguments are handled engine-side for the
    built-ins, see sql/analyzer.py)."""

    name: str
    # fn(args: dict[str, value]) -> (List[ColumnMetadata], List[List])
    fn: Any
    description: str = ""


class Connector:
    """One catalog's capability bundle (spi/connector/Connector.java)."""

    def __init__(
        self,
        name: str,
        metadata: ConnectorMetadata,
        split_manager: Optional[ConnectorSplitManager] = None,
        page_source: Optional[ConnectorPageSource] = None,
        table_functions: Optional[Dict[str, "TableFunction"]] = None,
    ):
        self.name = name
        self.metadata = metadata
        self.split_manager = split_manager
        self.page_source = page_source
        self.table_functions = table_functions or {}

    def page_sink(self, handle: TableHandle, transaction=None) -> ConnectorPageSink:
        """`transaction` is this connector's ConnectorTransactionHandle
        (trino_tpu_torch.transaction) when the write runs inside an
        explicit transaction; connectors that support transactional
        writes buffer until its commit. Autocommit (None) publishes at
        finish()."""
        raise NotImplementedError(f"connector {self.name} does not support writes")

    def begin_transaction(self, read_only: bool = False):
        """Optional: return a connector transaction handle
        (spi/transaction/ConnectorTransactionHandle analogue). Default
        is autocommit semantics."""
        return ConnectorTransactionHandle()

    def invalidate_split_caches(self) -> None:
        """Flush this catalog's split-listing caches (whole-query retry
        boundary — see ConnectorSplitManager.invalidate_cache)."""
        if self.split_manager is not None:
            self.split_manager.invalidate_cache()


class CatalogManager:
    """Engine-wide catalog registry — MetadataManager/CatalogManager
    analogue (main/metadata/MetadataManager.java)."""

    def __init__(self):
        self._catalogs: Dict[str, Connector] = {}

    def register(self, catalog: str, connector: Connector) -> None:
        self._catalogs[catalog] = connector

    def get(self, catalog: str) -> Connector:
        if catalog not in self._catalogs:
            raise KeyError(f"catalog '{catalog}' not registered")
        return self._catalogs[catalog]

    def catalogs(self) -> List[str]:
        return sorted(self._catalogs)

    def resolve_table(self, catalog: str, schema: str, table: str) -> Tuple[Connector, TableHandle]:
        conn = self.get(catalog)
        handle = conn.metadata.get_table_handle(schema, table)
        if handle is None:
            raise KeyError(f"table '{catalog}.{schema}.{table}' does not exist")
        return conn, handle

    def invalidate_split_listings(self) -> None:
        """Flush split-listing caches across every catalog. Connector
        errors are swallowed: a broken cache flush must not mask the
        failure that asked for it."""
        for conn in self._catalogs.values():
            try:
                conn.invalidate_split_caches()
            except Exception:
                pass

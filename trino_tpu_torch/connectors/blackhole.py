"""Blackhole connector — the null sink (plugin/trino-blackhole).

Counterpart of trino_tpu/connectors/blackhole.py: CREATE TABLE records
only metadata; INSERT counts and discards rows; SELECT returns zero
rows, as one empty batch on the runner's device. Used by write
benchmarks and tests that need a sink without storage."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch.block import Column, RelBatch, phys_zeros
from trino_tpu_torch.connectors.spi import (
    ColumnMetadata,
    Connector,
    ConnectorMetadata,
    ConnectorPageSink,
    ConnectorPageSource,
    ConnectorSplitManager,
    Split,
    TableHandle,
    TableMetadata,
    TableStatistics,
)


class BlackholeMetadata(ConnectorMetadata):
    def __init__(self):
        self.tables: Dict[Tuple[str, str], List[ColumnMetadata]] = {}

    def list_schemas(self) -> List[str]:
        return sorted({s for s, _ in self.tables} | {"default"})

    def list_tables(self, schema: str) -> List[str]:
        return sorted(n for s, n in self.tables if s == schema)

    def get_table_handle(self, schema: str, table: str) -> Optional[TableHandle]:
        if (schema, table) not in self.tables:
            return None
        return TableHandle("blackhole", schema, table)

    def get_table_metadata(self, handle: TableHandle) -> TableMetadata:
        return TableMetadata(
            handle.schema, handle.table, tuple(self.tables[(handle.schema, handle.table)])
        )

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        return TableStatistics(row_count=0.0)

    def create_table(self, schema: str, table: str,
                     columns: Sequence[ColumnMetadata]) -> TableHandle:
        self.tables[(schema, table)] = list(columns)
        return TableHandle("blackhole", schema, table)

    def drop_table(self, handle: TableHandle) -> None:
        self.tables.pop((handle.schema, handle.table), None)


class BlackholeSplitManager(ConnectorSplitManager):
    def get_splits(self, handle: TableHandle, target_split_count: int) -> List[Split]:
        return [Split(handle, 0, (0, 0))]


class BlackholePageSource(ConnectorPageSource):
    def __init__(self, metadata: BlackholeMetadata):
        self.metadata = metadata

    def batches(self, split: Split, columns: Sequence[str], batch_rows: int,
                device="cpu", stabilizer=None) -> Iterator[RelBatch]:
        cols_meta = {
            c.name: c for c in self.metadata.tables[(split.table.schema, split.table.table)]
        }
        yield RelBatch(
            [Column(cols_meta[n].type, phys_zeros(cols_meta[n].type, 16, device))
             for n in columns],
            torch.zeros(16, dtype=torch.bool, device=device),
        )


class BlackholePageSink(ConnectorPageSink):
    def __init__(self):
        self.rows = 0

    def append(self, batch: RelBatch) -> None:
        self.rows += batch.row_count()

    def finish(self) -> int:
        return self.rows


class BlackholeConnector(Connector):
    def __init__(self):
        md = BlackholeMetadata()
        super().__init__(
            "blackhole", md, BlackholeSplitManager(), BlackholePageSource(md)
        )

    def page_sink(self, handle: TableHandle) -> ConnectorPageSink:
        return BlackholePageSink()


def create_blackhole_connector() -> Connector:
    return BlackholeConnector()

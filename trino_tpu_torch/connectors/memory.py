"""In-memory connector.

Counterpart of trino_tpu/connectors/memory.py (plugin/trino-memory's
MemoryPagesStore analogue): tables live as dense host-side numpy column
arrays; string columns keep one table-wide dictionary, so scans bind
pipeline-wide. An ARRAY column of flat elements keeps a flat store
(per-row lengths and offsets into one element array, string elements
coded by one table-wide dictionary); MAP and ROW columns, and arrays of
nested elements, keep python objects, as in the reference.
`MemoryConnector.load_table` bulk-loads a table, and the page source
copies row ranges (or the rows of one hash bucket) to the runner's
device, keeping the batches of the table's current version.

The write side: CREATE/DROP/TRUNCATE, the page sink (`MemoryPageSink`:
each batch's live rows copied from the device to the host and appended,
string codes remapped into the table dictionary), transactional writes
buffered until commit (`MemoryTransactionHandle`), and `replace_rows`,
the stage-then-swap commit of the DELETE/UPDATE/MERGE rewrites. Every
write bumps the table's version and drops the device batches and bucket
ids kept for older versions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import (
    ArrayColumn,
    Column,
    Dictionary,
    RelBatch,
    bucket_capacity,
    element_positions,
    host_rows,
    phys_zeros,
)
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
from trino_tpu_torch.transaction import ConnectorTransactionHandle
from trino_tpu_torch.analysis.witness import named_lock


@dataclasses.dataclass
class _StoredColumn:
    type: T.DataType
    # host array, dense (no padding); a _FlatArrays for an ARRAY of flat
    # elements; a list of python objects for the other nested columns
    data: object
    valid: Optional[np.ndarray]
    dictionary: Optional[Dictionary]  # string elements' for an ARRAY


@dataclasses.dataclass
class _FlatArrays:
    """An ARRAY column's flat store: row i's elements are
    values[offsets[i]:offsets[i + 1]]."""

    offsets: np.ndarray  # int64 (n + 1,)
    values: np.ndarray  # element physical values (string codes)
    value_valid: Optional[np.ndarray]  # element NULLs

    @staticmethod
    def empty(element: T.DataType) -> "_FlatArrays":
        return _FlatArrays(np.zeros(1, dtype=np.int64), _empty_data(element), None)

    @staticmethod
    def of_lists(element: T.DataType, rows, dictionary: Optional[Dictionary]):
        lens = np.fromiter((0 if r is None else len(r) for r in rows), np.int64, len(rows))
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        items = [x for r in rows if r is not None for x in r]
        has_null = any(x is None for x in items)
        if element.is_string:
            vals = np.asarray([dictionary.code(x) if x is not None else 0 for x in items],
                              dtype=np.int32)
        else:
            vals = Column.from_pylist(element, items, capacity=len(items)).data.numpy()
        valid = np.asarray([x is not None for x in items], bool) if has_null else None
        return _FlatArrays(offsets, vals, valid)

    def column(self, t: T.DataType, rows, valid: Optional[np.ndarray], cap: int,
               dictionary: Optional[Dictionary], device) -> ArrayColumn:
        """The ArrayColumn of the stored rows `rows` (a slice or an index
        array), front-packed into `cap` rows."""
        if isinstance(rows, slice):
            lo, hi = self.offsets[rows.start], self.offsets[rows.stop]
            begins = self.offsets[rows]
            lens = self.offsets[rows.start + 1:rows.stop + 1] - begins
            starts = begins - lo
            take = slice(lo, hi)
        else:
            begins = self.offsets[rows]
            lens = self.offsets[rows + 1] - begins
            starts, take = element_positions(begins, lens)
        n = len(lens)
        lengths = np.zeros(cap, dtype=np.int32)
        lengths[:n] = lens
        st = np.zeros(cap, dtype=np.int32)
        st[:n] = starts
        flat = Column.from_numpy(
            t.element, self.values[take],
            None if self.value_valid is None else self.value_valid[take], dictionary,
            device=device)
        v = None
        if valid is not None:
            v = np.zeros(cap, dtype=bool)
            v[:n] = valid[rows]
            v = torch.from_numpy(v).to(device)
        return ArrayColumn(t, torch.from_numpy(lengths).to(device), v, None,
                           torch.from_numpy(st).to(device), flat)


def _nested_column(sc: _StoredColumn, rows, n: int, cap: int, device) -> Column:
    """A nested column's batch view of the stored rows `rows`."""
    if isinstance(sc.data, _FlatArrays):
        return sc.data.column(sc.type, rows, sc.valid, cap, sc.dictionary, device)
    vals = (list(sc.data[rows]) if isinstance(rows, slice)
            else [sc.data[j] for j in rows])
    if sc.type.is_array:
        return ArrayColumn.from_pylists(sc.type.element, vals + [None] * (cap - n),
                                        capacity=cap, dictionary=sc.dictionary,
                                        device=device)
    return Column.from_pylist(sc.type, vals, capacity=cap, device=device)


@dataclasses.dataclass
class _StoredTable:
    schema: str
    name: str
    columns: List[ColumnMetadata]
    data: Dict[str, _StoredColumn] = dataclasses.field(default_factory=dict)
    row_count: int = 0
    version: int = 0  # bumped on writes; invalidates the caches
    # device batches already built, per (version, columns, chunking,
    # split, constraints, device)
    device_cache: Dict[tuple, list] = dataclasses.field(default_factory=dict)
    # declared bucketing: ordered key column names; splits are then 1:1
    # with engine-hash buckets (spi.ConnectorMetadata.table_partitioning)
    bucketed_by: Optional[Tuple[str, ...]] = None
    # (version, n_buckets) -> int32 bucket id per row
    bucket_cache: Dict[tuple, np.ndarray] = dataclasses.field(default_factory=dict)

    def written(self) -> None:
        """A write: a new version, and the older versions' device
        batches and bucket ids dropped (no later scan can read them)."""
        self.version += 1
        self.device_cache.clear()
        self.bucket_cache.clear()


def _empty_data(t: T.DataType):
    """The empty store of a column of type `t` (an ARRAY of flat
    elements: a _FlatArrays)."""
    if t.is_array and not t.element.is_nested:
        return _FlatArrays.empty(t.element)
    if t.is_nested:
        return []
    return np.zeros((0, 2) if t.lanes == 2 else (0,), dtype=t.np_dtype)


class _Store:
    """The MemoryPagesStore analogue; table creation takes its lock."""

    def __init__(self):
        self.tables: Dict[Tuple[str, str], _StoredTable] = {}
        self.lock = named_lock("_Store.lock")


class MemoryMetadata(ConnectorMetadata):
    def __init__(self, store: _Store):
        self.store = store
        # (schema, table) -> (stored-table obj, version, TableStatistics)
        self._stats_cache: Dict[Tuple[str, str], tuple] = {}

    def list_schemas(self) -> List[str]:
        return sorted({s for s, _ in self.store.tables} | {"default"})

    def list_tables(self, schema: str) -> List[str]:
        return sorted(n for s, n in self.store.tables if s == schema)

    def get_table_handle(self, schema: str, table: str) -> Optional[TableHandle]:
        if (schema, table) not in self.store.tables:
            return None
        return TableHandle("memory", schema, table)

    def get_table_metadata(self, handle: TableHandle) -> TableMetadata:
        t = self.store.tables[(handle.schema, handle.table)]
        return TableMetadata(handle.schema, handle.table, tuple(t.columns))

    def column_dictionary(self, handle: TableHandle, column: str) -> Optional[Dictionary]:
        t = self.store.tables[(handle.schema, handle.table)]
        sc = t.data.get(column)
        return sc.dictionary if sc is not None else None

    def table_partitioning(self, handle: TableHandle):
        t = self.store.tables[(handle.schema, handle.table)]
        return t.bucketed_by

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        """Row count plus sampled per-column (ndv, null_fraction, min,
        max), as the reference estimates them: stride-sample up to 256 K
        non-NULL values, Duj1 NDV from the sample's singletons, exact
        min/max. Cached per table version."""
        t = self.store.tables[(handle.schema, handle.table)]
        key = (handle.schema, handle.table)
        cached = self._stats_cache.get(key)
        if cached is not None and cached[0] is t and cached[1] == t.version:
            return cached[2]
        cols: Dict[str, tuple] = {}
        n = t.row_count
        for name, sc in t.data.items():
            if n == 0 or sc.type.is_nested:
                continue
            arr = sc.data[:n]
            nf = 0.0
            if sc.valid is not None:
                nf = float(1.0 - np.count_nonzero(sc.valid[:n]) / n)
                # NULL slots hold placeholder payloads: keep them out of
                # ndv/min/max
                arr = arr[sc.valid[:n]]
                if len(arr) == 0:
                    cols[name] = (0.0, nf, None, None)
                    continue
            pop = len(arr)
            sample = arr[:: max(1, pop // 262144)]
            s = len(sample)
            vals, counts = np.unique(sample, return_counts=True)
            d = float(len(vals))
            f1 = float(np.count_nonzero(counts == 1))
            # Duj1: ndv = d / (1 - ((pop-s)/pop) * (f1/s))
            denom = 1.0 - ((pop - s) / pop) * (f1 / max(s, 1))
            ndv = min(d / max(denom, 1e-9), float(pop))
            lo = hi = None
            if not sc.type.is_string and arr.dtype.kind in "iuf":
                lo, hi = float(arr.min()), float(arr.max())
            cols[name] = (ndv, nf, lo, hi)
        ts = TableStatistics(row_count=float(n), columns=cols)
        self._stats_cache[key] = (t, t.version, ts)
        return ts

    def apply_filter(self, handle: TableHandle, constraints):
        """Accept constraints on flat numeric/temporal columns; the page
        source masks the stored arrays before building device batches."""
        from trino_tpu_torch.connectors.pushdown import (
            merge_handle_constraints,
            split_supported,
        )

        t = self.store.tables[(handle.schema, handle.table)]
        types = {c.name: c.type for c in t.columns}
        accepted, residual = split_supported(constraints, types.get)
        if not accepted:
            return None
        return merge_handle_constraints(handle, accepted), tuple(residual)

    def apply_projection(self, handle: TableHandle, columns) -> TableHandle:
        # the page source already builds only the requested columns
        return handle

    def create_table(self, schema: str, table: str,
                     columns: Sequence[ColumnMetadata]) -> TableHandle:
        with self.store.lock:
            if (schema, table) in self.store.tables:
                raise ValueError(f"table '{schema}.{table}' already exists")
            st = _StoredTable(schema, table, list(columns))
            for c in columns:
                strings = c.type.element.is_string if c.type.is_array else c.type.is_string
                st.data[c.name] = _StoredColumn(
                    c.type, _empty_data(c.type), None,
                    Dictionary([]) if strings else None)
            self.store.tables[(schema, table)] = st
        return TableHandle("memory", schema, table)

    def truncate_table(self, handle: TableHandle) -> None:
        with self.store.lock:
            t = self.store.tables[(handle.schema, handle.table)]
            for sc in t.data.values():
                sc.data = _empty_data(sc.type)
                sc.valid = None
            t.row_count = 0
            t.written()

    def drop_table(self, handle: TableHandle) -> None:
        with self.store.lock:
            t = self.store.tables.pop((handle.schema, handle.table), None)
            # the stats cache pins the stored table (host arrays + the
            # device-resident batch cache); a dropped table frees both
            self._stats_cache.pop((handle.schema, handle.table), None)
            if t is not None:
                t.device_cache.clear()


class MemorySplitManager(ConnectorSplitManager):
    def __init__(self, store: _Store):
        self.store = store

    def get_splits(self, handle: TableHandle, target_split_count: int) -> List[Split]:
        t = self.store.tables[(handle.schema, handle.table)]
        n = t.row_count
        if t.bucketed_by and target_split_count > 1:
            # bucketed table: exactly the requested count, split i = the
            # rows whose engine key-hash lands in partition i of k
            return [
                Split(handle, i, None, ("bucket", i, target_split_count))
                for i in range(target_split_count)
            ]
        k = max(1, min(target_split_count, max(n, 1)))
        per = -(-max(n, 1) // k)
        return [
            Split(handle, s, (a, min(a + per, n)))
            for s, a in enumerate(range(0, max(n, 1), per))
        ]


class MemoryPageSource(ConnectorPageSource):
    def __init__(self, store: _Store):
        self.store = store

    def batches(self, split: Split, columns: Sequence[str], batch_rows: int,
                device="cpu", stabilizer=None) -> Iterator[RelBatch]:
        """The split's rows in chunks of `batch_rows`, as batches on
        `device`; a second scan of the same table version, columns,
        split, device and capacity ladder yields the batches built by
        the first."""
        t = self.store.tables[(split.table.schema, split.table.table)]
        cs = getattr(split.table, "constraints", ())
        # the stabilizer changes capacities, so it keys the cache too
        dev = (str(torch.device(device)),
               (stabilizer.ladder.base, stabilizer.ladder.min_capacity)
               if stabilizer is not None else None)
        if split.payload is not None and split.payload[0] == "bucket":
            _, bi, nb = split.payload
            idx = np.nonzero(self._bucket_ids(t, nb) == bi)[0]
            lo = hi = None
            cache_key = (t.version, tuple(columns), batch_rows, "bucket", bi,
                         nb, cs, dev)
        else:
            lo, hi = split.row_range
            idx = None
            cache_key = (t.version, tuple(columns), batch_rows, lo, hi, cs, dev)
        cached = t.device_cache.get(cache_key)
        if cached is not None:
            yield from cached
            return
        if cs and t.row_count:
            # pushed-down predicate: mask the stored arrays, then gather
            # the surviving rows (the path bucket splits take)
            from trino_tpu_torch.connectors.pushdown import constraint_mask

            n = t.row_count
            mask = constraint_mask(
                cs,
                lambda name: (
                    np.asarray(t.data[name].data[:n]),
                    None if t.data[name].valid is None
                    else t.data[name].valid[:n],
                ),
            )
            if idx is None:
                idx = np.nonzero(mask[lo:hi])[0] + lo
                lo = hi = None
            else:
                idx = idx[mask[idx]]
        out = []
        for batch in self._materialize(t, columns, batch_rows, lo, hi, idx, device,
                                       stabilizer):
            out.append(batch)
            yield batch
        if cache_key[0] == t.version:  # no write ran during the scan
            t.device_cache[cache_key] = out

    def _bucket_ids(self, t: _StoredTable, nb: int) -> np.ndarray:
        """Row -> bucket id by the engine's exchange hash (the host
        replica `ops/hashing.hash32_np`; dictionary strings hash their
        values through `dictionary_lut`). Cached per (version, count)."""
        key = (t.version, nb)
        got = t.bucket_cache.get(key)
        if got is not None:
            return got
        from trino_tpu_torch.ops.hashing import (
            dictionary_lut,
            hash32_np,
            partition_of_np,
        )

        n = t.row_count
        lanes, valids = [], []
        for name in t.bucketed_by:
            sc = t.data[name]
            lut = dictionary_lut(sc.dictionary)
            if lut is not None:
                codes = np.clip(np.asarray(sc.data[:n]), 0, len(lut) - 1)
                lanes.append(lut[codes.astype(np.int64)])
            else:
                lanes.append(np.asarray(sc.data[:n]).astype(np.int64))
            valids.append(None if sc.valid is None else sc.valid[:n])
        bids = partition_of_np(hash32_np(lanes, valids), nb)
        t.bucket_cache[key] = bids
        return bids

    def _materialize(self, t: _StoredTable, columns: Sequence[str], batch_rows: int,
                     lo, hi, idx: Optional[np.ndarray], device,
                     stabilizer=None) -> Iterator[RelBatch]:
        """Chunk a contiguous [lo, hi) row range (slices) or an explicit
        row-index array (bucket splits, pushed-down filters: gathers)."""
        if idx is None:
            total = hi - lo
            sels = (slice(a, min(a + batch_rows, hi))
                    for a in range(lo, hi, batch_rows))
        else:
            total = len(idx)
            sels = (idx[a: a + batch_rows] for a in range(0, total, batch_rows))
        for sel in sels:
            ranged = isinstance(sel, slice)
            n = (sel.stop - sel.start) if ranged else len(sel)
            if stabilizer is None:
                cap = bucket_capacity(n)
            elif ranged:
                # contiguous chunks are unpruned: the slice is the span
                cap = stabilizer.chunk_capacity(n)
            else:
                # gathered chunks (pruned rows, bucket splits) pad to the
                # table's main scan class
                cap = stabilizer.chunk_capacity(min(t.row_count, batch_rows))
            cols = []
            for name in columns:
                sc = t.data[name]
                if sc.type.is_nested:
                    cols.append(_nested_column(sc, sel, n, cap, device))
                    continue
                valid = None if sc.valid is None else sc.valid[sel]
                cols.append(Column.from_numpy(
                    sc.type, sc.data[sel], valid, sc.dictionary, capacity=cap,
                    device=device,
                ))
            live = None
            if n != cap:
                lv = np.zeros(cap, dtype=bool)
                lv[:n] = True
                live = torch.from_numpy(lv).to(device)
            yield RelBatch(cols, live)
        if total == 0:  # empty split: one empty batch so schemas propagate
            cols = []
            for name in columns:
                sc = t.data[name]
                if sc.type.is_nested:
                    cols.append(Column.from_pylist(sc.type, [None] * 16, capacity=16,
                                                   device=device))
                    continue
                cols.append(Column(sc.type, phys_zeros(sc.type, 16, device),
                                   None, sc.dictionary))
            yield RelBatch(cols, torch.zeros(16, dtype=torch.bool, device=device))


def _append_valid(old: Optional[np.ndarray], n_old: int,
                  new: Optional[np.ndarray], n_new: int) -> Optional[np.ndarray]:
    if old is None and new is None:
        return None
    return np.concatenate([old if old is not None else np.ones(n_old, dtype=bool),
                           new if new is not None else np.ones(n_new, dtype=bool)])


def _remap_strings(sc_dictionary: Optional[Dictionary], incoming: Optional[Dictionary],
                   old: np.ndarray, codes: np.ndarray):
    """(table dictionary, stored codes, incoming codes) after folding the
    incoming dictionary into the table's (Dictionary.unify)."""
    if not incoming:  # no values: the codes stay (NULLs, or no rows)
        return sc_dictionary, old, codes
    if not sc_dictionary or sc_dictionary == incoming:
        # the merged dictionary is the incoming one, and no code moves
        return incoming, old, codes
    merged, remap_old, remap_new = Dictionary.unify(sc_dictionary, incoming)
    if len(old):
        old = remap_old[old]
    return merged, old, remap_new[np.clip(codes, 0, len(incoming) - 1)]


class MemoryPageSink(ConnectorPageSink):
    """Appends batches: each column's live rows are copied from the
    runner's device to the host once a batch; string columns (and string
    array elements) re-encode into the table's growing dictionary
    (unify) so the table dictionary stays authoritative."""

    def __init__(self, store: _Store, handle: TableHandle):
        self.store = store
        self.handle = handle
        self.rows = 0

    def append(self, batch: RelBatch) -> None:
        key = (self.handle.schema, self.handle.table)
        live, n = batch.live_rows()
        with self.store.lock:
            t = self.store.tables[key]
            for cm, col in zip(t.columns, batch.columns):
                sc = t.data[cm.name]
                if cm.type.is_nested and not isinstance(sc.data, _FlatArrays):
                    # MAP, ROW and arrays of nested elements: python values
                    sc.data = list(sc.data) + col.to_pylist(
                        live=None if live is None else live.cpu().numpy())
                    continue
                valid = None if col.valid is None else host_rows(col.valid, live)
                if isinstance(sc.data, _FlatArrays):
                    if not isinstance(col, ArrayColumn):
                        raise TypeError(f"column {cm.name}: expected ARRAY data")
                    self._append_flat(sc, col, live, valid, t.row_count, n)
                else:
                    data = host_rows(col.data, live)
                    if cm.type.is_string:
                        sc.dictionary, sc.data, data = _remap_strings(
                            sc.dictionary, col.dictionary, sc.data, data)
                    sc.data = np.concatenate([sc.data, data.astype(cm.type.np_dtype)])
                    sc.valid = _append_valid(sc.valid, t.row_count, valid, n)
            t.row_count += n
            t.written()
            self.rows += n

    @staticmethod
    def _append_flat(sc: _StoredColumn, col: ArrayColumn, live, valid,
                     n_old: int, n: int) -> None:
        """An ARRAY of flat elements onto the flat store: the live rows'
        lengths, and their elements gathered row after row."""
        lengths = host_rows(col.data, live).astype(np.int64)
        starts = host_rows(col.starts, live).astype(np.int64)
        if valid is not None:
            lengths = np.where(valid, lengths, 0)
        _, pos = element_positions(starts, lengths)
        idx = torch.from_numpy(pos).to(col.flat.data.device)
        vals = col.flat.data.index_select(0, idx).cpu().numpy()
        vvalid = (None if col.flat.valid is None
                  else col.flat.valid.index_select(0, idx).cpu().numpy())
        fa = sc.data
        old_vals = fa.values
        if col.type.element.is_string:
            sc.dictionary, old_vals, vals = _remap_strings(
                sc.dictionary, col.flat.dictionary, old_vals, vals)
        m_old, m_new = len(fa.values), len(vals)
        offsets = np.concatenate([fa.offsets, fa.offsets[-1] + np.cumsum(lengths)])
        sc.data = _FlatArrays(
            offsets, np.concatenate([old_vals, vals.astype(old_vals.dtype)]),
            _append_valid(fa.value_valid, m_old, vvalid, m_new))
        sc.valid = _append_valid(sc.valid, n_old, valid, n)

    def finish(self) -> int:
        return self.rows


class MemoryTransactionHandle(ConnectorTransactionHandle):
    """Buffers writes until commit (read-committed: in-transaction
    scans do NOT see the transaction's own pending writes, as in the
    reference). The staged batches stay on the device until then."""

    def __init__(self, store: _Store):
        self.store = store
        self._pending: List[tuple] = []  # (handle, batch)

    def stage(self, handle: TableHandle, batch: RelBatch) -> None:
        self._pending.append((handle, batch))

    def commit(self) -> None:
        for handle, batch in self._pending:
            MemoryPageSink(self.store, handle).append(batch)
        self._pending.clear()

    def rollback(self) -> None:
        self._pending.clear()


class _TransactionalMemorySink(ConnectorPageSink):
    def __init__(self, txn: MemoryTransactionHandle, handle: TableHandle):
        self.txn = txn
        self.handle = handle
        self.rows = 0

    def append(self, batch: RelBatch) -> None:
        self.txn.stage(self.handle, batch)
        self.rows += batch.row_count()

    def finish(self) -> int:
        return self.rows  # publish happens at transaction commit


class MemoryConnector(Connector):
    def __init__(self):
        store = _Store()
        super().__init__(
            "memory",
            MemoryMetadata(store),
            MemorySplitManager(store),
            MemoryPageSource(store),
        )
        self.store = store

    def begin_transaction(self, read_only: bool = False):
        return MemoryTransactionHandle(self.store)

    def replace_rows(self, handle: TableHandle, batches) -> None:
        """Atomically replace the table's rows with `batches` (the
        DELETE/UPDATE/MERGE rewrite commit): stage into a detached copy
        of the table, then swap under the store lock — a mid-stage
        failure leaves the original untouched."""
        key = (handle.schema, handle.table)
        with self.store.lock:
            t = self.store.tables[key]
            staging = _StoredTable(t.schema, t.name, list(t.columns))
            for cm in t.columns:
                # keep the table dictionary stable
                staging.data[cm.name] = _StoredColumn(
                    cm.type, _empty_data(cm.type), None, t.data[cm.name].dictionary)
        staging_store = _Store()
        staging_store.tables[key] = staging
        sink = MemoryPageSink(staging_store, handle)
        for b in batches:
            sink.append(b)
        with self.store.lock:
            t = self.store.tables.get(key)
            if t is None:
                raise KeyError(f"table {key} dropped during rewrite")
            t.data = staging.data
            t.row_count = staging.row_count
            t.written()

    def page_sink(self, handle: TableHandle, transaction=None) -> ConnectorPageSink:
        if isinstance(transaction, MemoryTransactionHandle):
            return _TransactionalMemorySink(transaction, handle)
        return MemoryPageSink(self.store, handle)

    def load_table(
        self,
        schema: str,
        table: str,
        columns: Sequence[ColumnMetadata],
        arrays: Sequence[np.ndarray],
        valids: Sequence[Optional[np.ndarray]] = None,
        dictionaries: Sequence[Optional[Dictionary]] = None,
        bucketed_by: Optional[Sequence[str]] = None,
    ) -> None:
        """Bulk-load dense host columns. A string column comes either as
        int32 codes with its dictionary or as python strings, encoded
        here (a None takes code 0: NULLs come from `valids`, as for
        every column). A nested column comes as python values (lists,
        dicts, tuples; None is NULL). `bucketed_by` declares
        engine-hash bucketing on integer-family or string key columns:
        splits then become hash buckets."""
        self.metadata.create_table(schema, table, columns)
        t = self.store.tables[(schema, table)]
        if bucketed_by:
            by_name = {cm.name: cm for cm in columns}
            for c in bucketed_by:
                cm = by_name.get(c)
                if cm is None:
                    raise ValueError(f"bucketed_by column {c!r} not in table")
                ok = cm.type.is_string or (
                    not cm.type.is_nested and cm.type.lanes == 1
                    and np.issubdtype(cm.type.np_dtype, np.integer)
                )
                if not ok:
                    # float keys need the 3-lane f64 split and long
                    # decimals the 4-lane limb split: no host replica
                    raise ValueError(
                        f"bucketed_by column {c!r}: only integer-family "
                        f"and string types can declare bucketing"
                    )
            t.bucketed_by = tuple(bucketed_by)
        n = len(arrays[0]) if arrays else 0
        for i, (cm, arr) in enumerate(zip(columns, arrays)):
            if cm.type.is_nested:
                t.data[cm.name] = self._nested_store(cm.type, list(arr))
                continue
            d = dictionaries[i] if dictionaries else None
            if cm.type.is_string and d is None:
                vals = list(arr)
                d = Dictionary([v for v in vals if v is not None])
                arr = np.asarray(
                    [d.code(v) if v is not None else 0 for v in vals],
                    dtype=np.int32,
                )
            t.data[cm.name] = _StoredColumn(
                cm.type,
                np.asarray(arr, dtype=cm.type.np_dtype),
                valids[i] if valids else None,
                d if d is not None else (
                    Dictionary([]) if cm.type.is_string else None
                ),
            )
        t.row_count = n
        t.written()

    @staticmethod
    def _nested_store(t: T.DataType, rows: list) -> _StoredColumn:
        """An ARRAY of flat elements gets its flat store (string elements
        one table-wide dictionary); MAP, ROW and arrays of nested
        elements keep the python values."""
        d = None
        if t.is_array and t.element.is_string:
            d = Dictionary([v for r in rows if r is not None for v in r if v is not None])
        if not t.is_array or t.element.is_nested:
            return _StoredColumn(t, rows, None, d)
        valid = (np.asarray([r is not None for r in rows], bool)
                 if any(r is None for r in rows) else None)
        return _StoredColumn(t, _FlatArrays.of_lists(t.element, rows, d), valid, d)


def create_memory_connector() -> MemoryConnector:
    return MemoryConnector()

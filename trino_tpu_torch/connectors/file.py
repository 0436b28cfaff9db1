"""Local-filesystem file connector (CSV / JSON-lines / Parquet).

Counterpart of trino_tpu/connectors/file.py. Unlike tpch/memory, which
are in-process, this connector reads external data through the full
SPI surface (schema discovery, type inference, splits, page source,
sink, DDL), the shape of plugin/trino-hive's file-format path reduced
to local files:

  root/
    <schema>/                directory per schema
      <table>.csv            single-file table (header row)
      <table>.jsonl          single-file table (one JSON object/line)
      <table>/part-*.csv     multi-file table (writes append parts)
      <table>/part-*.parquet

Parsed files become host-side column arrays with table-stable
dictionaries for strings (spi.py contract), cached per (path, mtime) so
repeated scans skip the parse; the page source copies each chunk to the
runner's device, padded to a power-of-two capacity. Parquet tables prune
row groups by the min/max statistics of the constraints known at split
enumeration.

Deltas from the reference, each a reference fault (ROADMAP §3):
- A split's row range indexes the table filtered by the constraints it
  was enumerated under; constraints folded in at run time (the dynamic
  filters' build domains) mask rows within that range.
- A long decimal (precision > 18) is written to CSV as its unscaled
  integer and read back exactly; parquet, and CSV for ARRAY/MAP/ROW,
  refuse the column (ValueError) before anything is written.
- A REAL cell of a CSV table parses as a float, not truncated.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import (
    Column,
    Dictionary,
    RelBatch,
    bucket_capacity,
    host_rows,
    phys_zeros,
)
from trino_tpu_torch.connectors.pushdown import (
    constraint_mask,
    merge_handle_constraints,
    range_predicate,
    split_supported,
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
from trino_tpu_torch.analysis.witness import named_lock

_EPOCH = datetime.date(1970, 1, 1)
_SAMPLE_ROWS = 100  # rows examined for type inference


# ---------------------------------------------------------------------------
# type inference (the hive-connector column-coercion analogue, local form)
# ---------------------------------------------------------------------------


def _classify(text: str) -> str:
    if text == "":
        return "null"
    low = text.lower()
    if low in ("true", "false"):
        return "boolean"
    try:
        int(text)
        return "bigint"
    except ValueError:
        pass
    try:
        float(text)
        return "double"
    except ValueError:
        pass
    try:
        datetime.date.fromisoformat(text)
        return "date"
    except ValueError:
        pass
    return "varchar"


_WIDEN = {
    frozenset(("bigint", "double")): "double",
}


def _unify_kinds(kinds) -> str:
    kinds = {k for k in kinds if k != "null"}
    if not kinds:
        return "varchar"
    if len(kinds) == 1:
        return next(iter(kinds))
    widened = _WIDEN.get(frozenset(kinds))
    return widened or "varchar"


_KIND_TO_TYPE = {
    "boolean": T.BOOLEAN,
    "bigint": T.BIGINT,
    "double": T.DOUBLE,
    "date": T.DATE,
    "varchar": T.VARCHAR,
}


def _parquet_type(c) -> T.DataType:
    """Parquet physical+converted type -> engine type."""
    from trino_tpu_torch.connectors import parquet_format as PQ

    if c.physical == PQ.T_BOOLEAN:
        return T.BOOLEAN
    if c.physical == PQ.T_INT32:
        if c.converted == PQ.C_DATE:
            return T.DATE
        if c.converted == PQ.C_DECIMAL:
            return T.decimal(min(c.precision or 9, 18), c.scale or 0)
        return T.INTEGER
    if c.physical == PQ.T_INT64:
        if c.converted == PQ.C_DECIMAL:
            return T.decimal(min(c.precision or 18, 18), c.scale or 0)
        if c.converted == PQ.C_TIMESTAMP_MICROS:
            return T.TIMESTAMP
        return T.BIGINT
    if c.physical == PQ.T_FLOAT:
        return T.REAL
    if c.physical == PQ.T_DOUBLE:
        return T.DOUBLE
    if c.physical == PQ.T_BYTE_ARRAY:
        if c.converted not in (None, PQ.C_UTF8):
            raise ValueError(
                f"unsupported BYTE_ARRAY converted type {c.converted}"
            )
        if c.converted is None:
            # raw VARBINARY has no engine representation yet
            raise ValueError(
                "BYTE_ARRAY without UTF8 annotation (varbinary) is not"
                " supported"
            )
        return T.VARCHAR
    raise ValueError(f"unsupported parquet physical type {c.physical}")


def _to_parquet_column(cm, data, valid, dictionary):
    """Engine host column -> ParquetColumn (write path)."""
    from trino_tpu_torch.connectors import parquet_format as PQ

    t = cm.type
    if t.is_string:
        vals = [
            (dictionary.values[int(v)] if dictionary else "").encode("utf-8")
            for v in data
        ]
        return PQ.ParquetColumn(cm.name, PQ.T_BYTE_ARRAY, PQ.C_UTF8,
                                values=vals, valid=valid)
    if t.kind == T.TypeKind.BOOLEAN:
        return PQ.ParquetColumn(cm.name, PQ.T_BOOLEAN,
                                values=np.asarray(data, bool), valid=valid)
    if t.kind == T.TypeKind.DATE:
        return PQ.ParquetColumn(cm.name, PQ.T_INT32, PQ.C_DATE,
                                values=np.asarray(data, np.int32),
                                valid=valid)
    if t.kind == T.TypeKind.INTEGER:
        return PQ.ParquetColumn(cm.name, PQ.T_INT32,
                                values=np.asarray(data, np.int32),
                                valid=valid)
    if t.is_decimal and not t.is_long_decimal:
        # a long decimal has no INT64 form: it falls through to the
        # refusal (the reference writes it capped at precision 18)
        return PQ.ParquetColumn(cm.name, PQ.T_INT64, PQ.C_DECIMAL,
                                scale=t.scale, precision=t.precision,
                                values=np.asarray(data, np.int64),
                                valid=valid)
    if t.kind == T.TypeKind.TIMESTAMP:
        return PQ.ParquetColumn(cm.name, PQ.T_INT64, PQ.C_TIMESTAMP_MICROS,
                                values=np.asarray(data, np.int64),
                                valid=valid)
    if t.kind == T.TypeKind.REAL:
        return PQ.ParquetColumn(cm.name, PQ.T_FLOAT,
                                values=np.asarray(data, np.float32),
                                valid=valid)
    if t.kind == T.TypeKind.DOUBLE:
        return PQ.ParquetColumn(cm.name, PQ.T_DOUBLE,
                                values=np.asarray(data, np.float64),
                                valid=valid)
    if t.kind in (T.TypeKind.BIGINT, T.TypeKind.TINYINT,
                  T.TypeKind.SMALLINT):
        # narrow ints widen to INT64 (parquet has no INT8/16 physical);
        # they read back as BIGINT — documented widening, not drift
        return PQ.ParquetColumn(cm.name, PQ.T_INT64,
                                values=np.asarray(data, np.int64),
                                valid=valid)
    raise ValueError(f"cannot write {t} to parquet")


def _parse_cell(text: str, t: T.DataType):
    """-> (value, is_null) in the column's storage representation.
    Cells that fail to parse as the inferred/declared type become NULL
    (hive's lenient malformed-cell semantics) — inference samples only
    the head of the file, so a stray 'n/a' at row 101 must not kill
    the scan."""
    if text == "":
        return 0, True
    try:
        if t.kind == T.TypeKind.BOOLEAN:
            return text.lower() == "true", False
        if t.kind == T.TypeKind.DATE:
            return (datetime.date.fromisoformat(text) - _EPOCH).days, False
        if t.is_floating:
            return float(text), False
        if t.is_string:
            return text, False
        # bigint: int(text) first — int(float(text)) loses precision past
        # 2^53 (9007199254740993 would read back as ...992); the float
        # path only tolerates decimal-looking text like "3.0"
        try:
            return int(text), False
        except ValueError:
            return int(float(text)), False
    except (ValueError, OverflowError):
        return 0, True


def _host_array(t: T.DataType, vals: list) -> np.ndarray:
    """Parsed cells -> the column's host array; a long decimal's python
    ints become (n, 2) int64 limb pairs."""
    if t.lanes == 2:
        from trino_tpu_torch.ops.int128 import from_python

        return np.asarray([from_python(int(v)) for v in vals],
                          dtype=np.int64).reshape(-1, 2)
    return np.asarray(vals, dtype=t.np_dtype)


# ---------------------------------------------------------------------------
# parsed-table cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ParsedTable:
    columns: List[ColumnMetadata]
    data: Dict[str, np.ndarray]
    valid: Dict[str, Optional[np.ndarray]]
    dictionaries: Dict[str, Optional[Dictionary]]
    row_count: int
    stamp: tuple  # (paths, mtimes) fingerprint


@dataclasses.dataclass
class _ParquetMeta:
    """Footer-derived table facts for all-parquet tables: schema, row
    count, and chunk-statistics aggregates — enough for metadata,
    statistics, and apply_filter without reading any data pages."""

    columns: List[ColumnMetadata]
    row_count: int
    stats: Dict[str, Optional[tuple]]  # name -> (min, max, null_count)
    stamp: tuple


class _FileStore:
    _MAX_FILTERED = 8  # bounded per-constraint-set parse cache

    def __init__(self, root: str):
        self.root = root
        self.lock = named_lock("_FileStore.lock")
        self._cache: Dict[Tuple[str, str], _ParsedTable] = {}
        # (schema, table, constraints) -> filtered _ParsedTable
        self._filtered_cache: Dict[tuple, _ParsedTable] = {}
        self._meta_cache: Dict[Tuple[str, str], _ParquetMeta] = {}

    # -- layout --
    def table_paths(self, schema: str, table: str) -> List[str]:
        base = os.path.join(self.root, schema)
        for ext in (".csv", ".jsonl", ".parquet"):
            p = os.path.join(base, table + ext)
            if os.path.isfile(p):
                return [p]
        d = os.path.join(base, table)
        if os.path.isdir(d):
            return sorted(
                os.path.join(d, f)
                for f in os.listdir(d)
                if f.endswith((".csv", ".jsonl", ".parquet"))
            )
        return []

    def _stamp(self, paths: List[str]) -> tuple:
        return tuple((p, os.path.getmtime(p)) for p in paths)

    def declared_schema(self, schema: str, table: str):
        """Declared column types from the table's sidecar schema file
        (the metastore-schema analogue: DDL-declared types win over
        data inference, exactly hive's schema-vs-file split). None for
        bare files that were never CREATEd."""
        p = os.path.join(self.root, schema, table, ".schema.json")
        if not os.path.isfile(p):
            return None
        with open(p) as f:
            decl = json.load(f)
        return [
            ColumnMetadata(
                c["name"],
                T.DataType(
                    T.TypeKind(c["kind"]), c.get("precision"), c.get("scale")
                ),
            )
            for c in decl
        ]

    def parsed(self, schema: str, table: str) -> _ParsedTable:
        paths = self.table_paths(schema, table)
        if not paths:
            raise KeyError(f"no files for table {schema}.{table}")
        stamp = self._stamp(paths)
        key = (schema, table)
        with self.lock:
            hit = self._cache.get(key)
            if hit is not None and hit.stamp == stamp:
                return hit
        pq = [p for p in paths if p.endswith(".parquet")]
        if pq and len(pq) != len(paths):
            raise ValueError(
                f"table {schema}.{table} mixes parquet and text parts"
            )
        if pq:
            parsed = self._parse_parquet(paths, stamp)
        else:
            parsed = self._parse(
                paths, stamp, self.declared_schema(schema, table)
            )
        with self.lock:
            self._cache[key] = parsed
        return parsed

    def parquet_meta(self, schema: str, table: str) -> Optional[_ParquetMeta]:
        """Footer-only schema + statistics for all-parquet tables (None
        for text tables or LIST schemas). Reads no data pages, so
        metadata and statistics queries never force a full parse — the
        scan pays for exactly the row groups it keeps."""
        paths = self.table_paths(schema, table)
        if not paths or not all(p.endswith(".parquet") for p in paths):
            return None
        stamp = self._stamp(paths)
        key = (schema, table)
        with self.lock:
            hit = self._meta_cache.get(key)
            if hit is not None and hit.stamp == stamp:
                return hit
        from trino_tpu_torch.connectors import parquet_format as PQ

        per = [PQ.read_parquet_meta(p) for p in paths]
        first_cols = per[0][0]
        if any(c.list_lengths is not None for c in first_cols):
            return None  # LIST columns: the parse path fails loudly
        columns = [
            ColumnMetadata(c.name, _parquet_type(c)) for c in first_cols
        ]
        row_count = sum(n for _, n, _ in per)
        stats: Dict[str, Optional[tuple]] = {}
        for cm in columns:
            parts = [s.get(cm.name) for _, _, s in per]
            if any(p is None for p in parts):
                stats[cm.name] = None
                continue
            nulls = (
                None
                if any(p[2] is None for p in parts)
                else sum(p[2] for p in parts)
            )
            stats[cm.name] = (
                min(p[0] for p in parts), max(p[1] for p in parts), nulls
            )
        out = _ParquetMeta(columns, row_count, stats, stamp)
        with self.lock:
            self._meta_cache[key] = out
        return out

    def parsed_filtered(
        self, schema: str, table: str, constraints: tuple
    ) -> _ParsedTable:
        """Parsed table with ``constraints`` fully enforced (rows
        compacted). Parquet tables prune whole row groups by min/max
        stats first (read_parquet predicate), then apply the exact
        mask; text tables mask the cached full parse. Cached per
        constraint set with the same mtime stamp as the base cache."""
        if not constraints:
            return self.parsed(schema, table)
        paths = self.table_paths(schema, table)
        if not paths:
            raise KeyError(f"no files for table {schema}.{table}")
        stamp = self._stamp(paths)
        key = (schema, table, tuple(constraints))
        with self.lock:
            hit = self._filtered_cache.get(key)
            if hit is not None and hit.stamp == stamp:
                return hit
            base = self._cache.get((schema, table))
        if base is not None and base.stamp == stamp:
            pass  # already in memory — masking beats re-reading
        elif all(p.endswith(".parquet") for p in paths):
            base = self._parse_parquet(
                paths, stamp, predicate=range_predicate(constraints)
            )
        else:
            base = self.parsed(schema, table)
        mask = constraint_mask(
            constraints,
            lambda name: (base.data[name], base.valid[name]),
        )
        keep = (
            np.nonzero(mask)[0]
            if mask is not None
            else np.arange(base.row_count)
        )
        data = {n: a[keep] for n, a in base.data.items()}
        valid = {
            n: (v[keep] if v is not None else None)
            for n, v in base.valid.items()
        }
        out = _ParsedTable(
            base.columns, data, valid, base.dictionaries,
            int(len(keep)), stamp,
        )
        with self.lock:
            if len(self._filtered_cache) >= self._MAX_FILTERED:
                self._filtered_cache.pop(next(iter(self._filtered_cache)))
            self._filtered_cache[key] = out
        return out

    # -- parsing --
    def _rows_of(self, path: str) -> Tuple[List[str], List[List[str]]]:
        """-> (column names, rows of raw strings)."""
        if path.endswith(".jsonl"):
            names: List[str] = []
            rows: List[dict] = []
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    for k in obj:
                        if k not in names:
                            names.append(k)
                    rows.append(obj)
            out = []
            for obj in rows:
                out.append([
                    "" if obj.get(k) is None else str(obj.get(k))
                    for k in names
                ])
            return names, out
        with open(path, newline="") as f:
            reader = csv.reader(f)
            try:
                names = next(reader)
            except StopIteration:
                return [], []
            return names, [row for row in reader]

    def _parse(
        self, paths: List[str], stamp: tuple, declared=None
    ) -> _ParsedTable:
        names: List[str] = []
        all_rows: List[List[str]] = []
        for p in paths:
            file_names, rows = self._rows_of(p)
            if not names:
                names = file_names
            elif file_names and file_names != names:
                raise ValueError(
                    f"schema mismatch across parts: {file_names} vs {names}"
                )
            all_rows.extend(rows)
        if declared is not None:
            if not names:
                names = [c.name for c in declared]
            columns = list(declared)
        else:
            # infer each column's type from a sample
            kinds = []
            for i in range(len(names)):
                sample = (
                    row[i] if i < len(row) else ""
                    for row in all_rows[:_SAMPLE_ROWS]
                )
                kinds.append(_unify_kinds(_classify(c) for c in sample))
            columns = [
                ColumnMetadata(n, _KIND_TO_TYPE[k])
                for n, k in zip(names, kinds)
            ]
        data: Dict[str, np.ndarray] = {}
        valid: Dict[str, Optional[np.ndarray]] = {}
        dicts: Dict[str, Optional[Dictionary]] = {}
        n = len(all_rows)
        for i, cm in enumerate(columns):
            vals = []
            nulls = np.zeros(n, dtype=bool)
            for r, row in enumerate(all_rows):
                cell = row[i] if i < len(row) else ""
                v, is_null = _parse_cell(cell, cm.type)
                nulls[r] = is_null
                vals.append(v)
            if cm.type.is_string:
                d = Dictionary(sorted({v for v in vals if isinstance(v, str)}))
                codes = np.asarray(
                    [d.code(v) if isinstance(v, str) else 0 for v in vals],
                    dtype=np.int32,
                )
                data[cm.name] = codes
                dicts[cm.name] = d
            else:
                data[cm.name] = _host_array(cm.type, vals)
                dicts[cm.name] = None
            valid[cm.name] = ~nulls if nulls.any() else None
        return _ParsedTable(columns, data, valid, dicts, n, stamp)

    def _parse_parquet(
        self, paths: List[str], stamp: tuple, predicate=None
    ) -> _ParsedTable:
        """Typed parquet parts -> the parsed-table form (the
        lib/trino-parquet read path reduced to the engine's types).
        ``predicate`` ({col: (lo, hi)}) skips row groups whose min/max
        stats fall outside the range — the caller must still enforce
        the exact constraints on what survives."""
        from trino_tpu_torch.connectors import parquet_format as PQ

        per_file = [PQ.read_parquet(p, predicate=predicate) for p in paths]
        first_cols, _ = per_file[0]
        columns: List[ColumnMetadata] = []
        for c in first_cols:
            if c.list_lengths is not None:
                # the parquet codec reads 3-level LISTs (r5); mapping
                # them onto engine ArrayColumns through this connector
                # is not wired yet — fail loudly, never flatten
                raise ValueError(
                    f"parquet LIST column {c.name!r} is not yet "
                    "supported by the file connector"
                )
            columns.append(ColumnMetadata(c.name, _parquet_type(c)))
        data: Dict[str, np.ndarray] = {}
        valid: Dict[str, Optional[np.ndarray]] = {}
        dicts: Dict[str, Optional[Dictionary]] = {}
        n = sum(nr for _, nr in per_file)
        # scale/precision are part of the signature: DECIMAL parts with
        # different scales would otherwise concatenate their scaled
        # int64 payloads unrescaled (ADVICE r3)
        def _sig(cols):
            return [
                (c.name, c.physical, c.converted, c.scale, c.precision)
                for c in cols
            ]

        first_sig = _sig(first_cols)
        for cols_f, _ in per_file[1:]:
            sig = _sig(cols_f)
            if sig != first_sig:
                raise ValueError(
                    f"schema mismatch across parquet parts: {sig} vs"
                    f" {first_sig}"
                )
        for i, cm in enumerate(columns):
            parts = [cols[i] for cols, _ in per_file]
            valids = [
                p.valid
                if p.valid is not None
                else np.ones(
                    len(p.values) if isinstance(p.values, list)
                    else p.values.shape[0], bool
                )
                for p in parts
            ]
            v = np.concatenate(valids) if valids else np.ones(0, bool)
            if cm.type.is_string:
                texts: List[Optional[str]] = []
                for p, pv in zip(parts, valids):
                    for b, ok in zip(p.values, pv):
                        texts.append(
                            b.decode("utf-8") if ok else None
                        )
                d = Dictionary(sorted({t for t in texts if t is not None}))
                data[cm.name] = np.asarray(
                    [d.code(t) if t is not None else 0 for t in texts],
                    dtype=np.int32,
                )
                dicts[cm.name] = d
            else:
                data[cm.name] = np.concatenate(
                    [np.asarray(p.values) for p in parts]
                ).astype(cm.type.np_dtype)
                dicts[cm.name] = None
            valid[cm.name] = v if not v.all() else None
        return _ParsedTable(columns, data, valid, dicts, n, stamp)


# ---------------------------------------------------------------------------
# SPI surfaces
# ---------------------------------------------------------------------------


class FileMetadata(ConnectorMetadata):
    def __init__(self, store: _FileStore, file_format: str = "csv"):
        self.store = store
        self.file_format = file_format

    def list_schemas(self) -> List[str]:
        root = self.store.root
        if not os.path.isdir(root):
            return []
        return sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )

    def list_tables(self, schema: str) -> List[str]:
        base = os.path.join(self.store.root, schema)
        if not os.path.isdir(base):
            return []
        out = set()
        for f in os.listdir(base):
            p = os.path.join(base, f)
            if os.path.isfile(p) and f.endswith((".csv", ".jsonl")):
                out.add(f.rsplit(".", 1)[0])
            elif os.path.isdir(p):
                out.add(f)
        return sorted(out)

    def get_table_handle(self, schema: str, table: str) -> Optional[TableHandle]:
        if not self.store.table_paths(schema, table):
            return None
        return TableHandle("file", schema, table)

    def get_table_metadata(self, handle: TableHandle) -> TableMetadata:
        pm = self.store.parquet_meta(handle.schema, handle.table)
        if pm is not None:
            return TableMetadata(
                handle.schema, handle.table, tuple(pm.columns)
            )
        parsed = self.store.parsed(handle.schema, handle.table)
        return TableMetadata(
            handle.schema, handle.table, tuple(parsed.columns)
        )

    def column_dictionary(self, handle: TableHandle, column: str):
        pm = self.store.parquet_meta(handle.schema, handle.table)
        if pm is not None:
            t = next(
                (c.type for c in pm.columns if c.name == column), None
            )
            if t is not None and not t.is_string:
                return None  # footer answers without touching pages
        # a constrained handle must hand out the FILTERED table's
        # dictionary — its batches carry that table's codes
        cs = getattr(handle, "constraints", ())
        parsed = (
            self.store.parsed_filtered(handle.schema, handle.table, cs)
            if cs
            else self.store.parsed(handle.schema, handle.table)
        )
        return parsed.dictionaries.get(column)

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        pm = self.store.parquet_meta(handle.schema, handle.table)
        if pm is not None:
            # footer chunk statistics: exact min/max/null-fraction, ndv
            # unknowable without reading pages — live row count is the
            # standard upper-bound estimate
            cols = {}
            for cm in pm.columns:
                st = pm.stats.get(cm.name)
                if cm.type.is_string or st is None or pm.row_count == 0:
                    continue
                mn, mx, nulls = st
                nf = (
                    float(nulls) / pm.row_count if nulls is not None else 0.0
                )
                cols[cm.name] = (
                    pm.row_count * (1.0 - nf), nf, float(mn), float(mx)
                )
            return TableStatistics(
                row_count=float(pm.row_count), columns=cols
            )
        parsed = self.store.parsed(handle.schema, handle.table)
        cols = {}
        for cm in parsed.columns:
            arr = parsed.data[cm.name]
            valid = parsed.valid[cm.name]
            # NULL placeholders (stored 0) must not pollute min/max/ndv
            live = arr if valid is None else arr[valid]
            nf = (
                0.0
                if valid is None or len(arr) == 0
                else 1.0 - float(valid.sum()) / len(arr)
            )
            if cm.type.is_string or cm.type.lanes == 2 or len(live) == 0:
                continue
            cols[cm.name] = (
                float(len(np.unique(live))), nf,
                float(live.min()), float(live.max()),
            )
        return TableStatistics(
            row_count=float(parsed.row_count), columns=cols
        )

    def apply_filter(self, handle, constraints):
        pm = self.store.parquet_meta(handle.schema, handle.table)
        cols = (
            pm.columns
            if pm is not None
            else self.store.parsed(handle.schema, handle.table).columns
        )
        types = {c.name: c.type for c in cols}
        accepted, residual = split_supported(constraints, types.get)
        if not accepted:
            return None
        return merge_handle_constraints(handle, accepted), tuple(residual)

    def apply_projection(self, handle, columns):
        # batches() already materializes only the requested columns;
        # accepting keeps the ProjectNode narrowing in the plan
        return handle

    def create_table(
        self, schema: str, table: str, columns: Sequence[ColumnMetadata]
    ) -> TableHandle:
        d = os.path.join(self.store.root, schema, table)
        if self.store.table_paths(schema, table):
            raise ValueError(f"table '{schema}.{table}' already exists")
        # a column the write format cannot hold is refused before any
        # file is made: parquet takes what _to_parquet_column maps, CSV
        # every type but ARRAY, MAP and ROW
        if self.file_format == "parquet":
            from trino_tpu_torch.connectors import parquet_format as PQ

            empty = [
                _to_parquet_column(
                    c, np.zeros(0, dtype=c.type.np_dtype)
                    if not c.type.is_string else [], None, None
                )
                for c in columns
            ]
        else:
            nested = next((c.type for c in columns if c.type.is_nested), None)
            if nested is not None:
                raise ValueError(f"cannot write {nested} to csv")
        os.makedirs(d, exist_ok=True)
        # a header-only/empty part records the column ORDER and (for
        # parquet) the TYPES; the sidecar schema file records declared
        # types for the text formats (metastore analogue)
        if self.file_format == "parquet":
            PQ.write_parquet(os.path.join(d, "part-0.parquet"), empty, 0)
        else:
            with open(os.path.join(d, "part-0.csv"), "w", newline="") as f:
                csv.writer(f).writerow([c.name for c in columns])
        with open(os.path.join(d, ".schema.json"), "w") as f:
            json.dump(
                [
                    {
                        "name": c.name,
                        "kind": c.type.kind.value,
                        "precision": c.type.precision,
                        "scale": c.type.scale,
                    }
                    for c in columns
                ],
                f,
            )
        return TableHandle("file", schema, table)

    def drop_table(self, handle: TableHandle) -> None:
        import shutil

        for p in self.store.table_paths(handle.schema, handle.table):
            parent = os.path.dirname(p)
            if os.path.basename(parent) == handle.table:
                shutil.rmtree(parent, ignore_errors=True)
                break
            os.unlink(p)
        with self.store.lock:
            self.store._cache.pop((handle.schema, handle.table), None)
            self.store._meta_cache.pop((handle.schema, handle.table), None)
            for k in [
                k for k in self.store._filtered_cache
                if k[:2] == (handle.schema, handle.table)
            ]:
                self.store._filtered_cache.pop(k, None)


class FileSplitManager(ConnectorSplitManager):
    """One split per row range of the parsed table — the unit of source
    parallelism and FTE retry, like the hive connector's per-file
    splits collapsed onto the parse cache."""

    def __init__(self, store: _FileStore):
        self.store = store
        self.invalidations = 0  # observability for retry-boundary tests

    def invalidate_cache(self) -> None:
        """QUERY-retry boundary: drop every parsed/filtered/metadata
        listing so the replay re-reads the files (the mtime stamp
        already catches rewrites, but a stale-cache failure mode —
        e.g. a file deleted underneath a cached parse — needs the hard
        flush)."""
        self.invalidations += 1
        self.store._cache.clear()
        self.store._filtered_cache.clear()
        self.store._meta_cache.clear()

    def get_splits(self, handle: TableHandle, target_split_count: int) -> List[Split]:
        cs = getattr(handle, "constraints", ())
        parsed = (
            self.store.parsed_filtered(handle.schema, handle.table, cs)
            if cs
            else self.store.parsed(handle.schema, handle.table)
        )
        n = parsed.row_count
        k = max(1, min(target_split_count, max(n, 1)))
        per = -(-max(n, 1) // k)
        # the payload keeps the constraints the ranges index under: a
        # scan that adds more at run time masks rows within its range
        return [
            Split(handle, s, (a, min(a + per, n)), tuple(cs))
            for s, a in enumerate(range(0, max(n, 1), per))
        ]


class FilePageSource(ConnectorPageSource):
    def __init__(self, store: _FileStore):
        self.store = store

    def batches(
        self, split: Split, columns: Sequence[str], batch_rows: int,
        device="cpu", stabilizer=None,
    ) -> Iterator[RelBatch]:
        """The split's rows of the table filtered by the constraints it
        was enumerated under (its payload), in chunks of `batch_rows`,
        as batches on `device`. Constraints the handle gained since (the
        dynamic filters' build domains, folded in at run time) keep only
        the rows of the range that satisfy them."""
        cs = tuple(getattr(split.table, "constraints", ()))
        planned = split.payload
        t = (
            self.store.parsed_filtered(
                split.table.schema, split.table.table, planned
            )
            if planned
            else self.store.parsed(split.table.schema, split.table.table)
        )
        lo, hi = split.row_range
        types = {c.name: c.type for c in t.columns}
        added = tuple(c for c in cs if c not in planned)
        if added and hi > lo:
            mask = constraint_mask(
                added,
                lambda name: (
                    t.data[name][lo:hi],
                    None if t.valid[name] is None else t.valid[name][lo:hi],
                ),
            )
            keep = np.nonzero(mask)[0] + lo
            sels = [keep[a:a + batch_rows] for a in range(0, len(keep), batch_rows)]
        else:
            sels = [slice(a, min(a + batch_rows, hi)) for a in range(lo, hi, batch_rows)]
        for sel in sels:
            ranged = isinstance(sel, slice)
            n = (sel.stop - sel.start) if ranged else len(sel)
            if stabilizer is None:
                cap = bucket_capacity(n)
            elif ranged:
                # a contiguous chunk's length is its span
                cap = stabilizer.chunk_capacity(n)
            else:
                # rows masked by a run-time constraint pad to the range's
                # main class, so the filter never mints a smaller class
                cap = stabilizer.chunk_capacity(min(hi - lo, batch_rows))
            cols = []
            for name in columns:
                valid = t.valid[name]
                cols.append(Column.from_numpy(
                    types[name], t.data[name][sel],
                    None if valid is None else valid[sel],
                    t.dictionaries[name], capacity=cap, device=device,
                ))
            live = None
            if n != cap:
                lv = np.zeros(cap, dtype=bool)
                lv[:n] = True
                live = torch.from_numpy(lv).to(device)
            yield RelBatch(cols, live)
        if not sels:  # no rows: one empty batch so schemas propagate
            yield RelBatch(
                [
                    Column(types[name], phys_zeros(types[name], 16, device),
                           None, t.dictionaries[name])
                    for name in columns
                ],
                torch.zeros(16, dtype=torch.bool, device=device),
            )


def _csv_cells(t: T.DataType, data: np.ndarray, valid: Optional[np.ndarray],
               d: Optional[Dictionary]) -> list:
    """One column's CSV cells: NULL as the empty cell, strings decoded,
    dates ISO, booleans true/false, a long decimal its unscaled integer,
    every other value its number."""
    if t.is_string:
        cells = (list(np.asarray(d.values, dtype=object)[data]) if d
                 else [""] * len(data))
    elif t.kind == T.TypeKind.DATE:
        cells = [(_EPOCH + datetime.timedelta(days=int(x))).isoformat() for x in data]
    elif t.kind == T.TypeKind.BOOLEAN:
        cells = ["true" if x else "false" for x in data]
    elif t.lanes == 2:
        from trino_tpu_torch.ops.int128 import to_python

        cells = [to_python(h, lo) for h, lo in data.tolist()]
    else:
        cells = list(data)
    if valid is not None:
        cells = [c if ok else "" for c, ok in zip(cells, valid)]
    return cells


class FilePageSink(ConnectorPageSink):
    """Each write lands a new part file (hive's write-then-rename
    discipline: parts are written under a dotted temp name and renamed
    into place at finish, so readers never see partial parts). Each
    batch's live rows are copied from the runner's device once."""

    def __init__(self, store: _FileStore, handle: TableHandle):
        self.store = store
        self.handle = handle
        self.rows = 0
        d = os.path.join(store.root, handle.schema, handle.table)
        if os.path.isfile(d + ".csv") or os.path.isfile(d + ".jsonl"):
            raise ValueError(
                "single-file tables are read-only; CREATE the table to "
                "get a multi-part directory"
            )
        os.makedirs(d, exist_ok=True)
        # unique part names: concurrent INSERTs must never collide on a
        # count-derived index (hive's UUID-suffixed write files)
        import uuid

        part = uuid.uuid4().hex[:12]
        self._final = os.path.join(d, f"part-{part}.csv")
        self._tmp = os.path.join(d, f".part-{part}.csv.tmp")
        self._file = open(self._tmp, "w", newline="")
        self._writer = csv.writer(self._file)
        parsed = self.store.parsed(handle.schema, handle.table)
        self._columns = parsed.columns
        self._writer.writerow([c.name for c in self._columns])

    def append(self, batch: RelBatch) -> None:
        live, n = batch.live_rows()
        cells = []
        for cm, col in zip(self._columns, batch.columns):
            valid = None if col.valid is None else host_rows(col.valid, live)
            cells.append(_csv_cells(cm.type, host_rows(col.data, live), valid,
                                    col.dictionary))
        self._writer.writerows(zip(*cells))
        self.rows += n

    def finish(self) -> int:
        self._file.close()
        os.replace(self._tmp, self._final)
        return self.rows


class ParquetPageSink(ConnectorPageSink):
    """Columnar write path: batches buffer host-side (each batch's live
    rows copied from the runner's device once) and land as ONE parquet
    part at finish (write-then-rename, like the CSV sink)."""

    def __init__(self, store: _FileStore, handle: TableHandle):
        import uuid

        self.store = store
        self.handle = handle
        self.rows = 0
        d = os.path.join(store.root, handle.schema, handle.table)
        for ext in (".parquet", ".csv", ".jsonl"):
            if os.path.isfile(d + ext):
                raise ValueError(
                    "single-file tables are read-only; CREATE the table"
                    " to get a multi-part directory"
                )
        os.makedirs(d, exist_ok=True)
        part = uuid.uuid4().hex[:12]
        self._final = os.path.join(d, f"part-{part}.parquet")
        self._tmp = os.path.join(d, f".part-{part}.parquet.tmp")
        parsed = store.parsed(handle.schema, handle.table)
        self._columns = parsed.columns
        self._bufs = [([], []) for _ in self._columns]  # (data, valid)

    def append(self, batch: RelBatch) -> None:
        live, n = batch.live_rows()
        for i, (cm, col) in enumerate(zip(self._columns, batch.columns)):
            data = host_rows(col.data, live)
            valid = (
                host_rows(col.valid, live)
                if col.valid is not None
                else np.ones(len(data), bool)
            )
            if cm.type.is_string:
                # decode now: dictionaries differ per batch; a missing
                # dictionary (NULL-only projections, outer-join padding)
                # decodes as empty strings under an all-false mask
                d = col.dictionary
                data = (np.where(valid, np.asarray(d.values, dtype=object)[data], "")
                        if d else np.full(len(data), "", dtype=object))
            self._bufs[i][0].append(data)
            self._bufs[i][1].append(valid)
        self.rows += n

    def finish(self) -> int:
        from trino_tpu_torch.connectors import parquet_format as PQ

        cols = []
        for cm, (datas, valids) in zip(self._columns, self._bufs):
            if cm.type.is_string:
                flat = [v for part in datas for v in part]
                valid = np.concatenate(valids) if valids else np.zeros(0, bool)
                vals = [s.encode("utf-8") for s in flat]
                cols.append(PQ.ParquetColumn(
                    cm.name, PQ.T_BYTE_ARRAY, PQ.C_UTF8,
                    values=vals,
                    valid=None if valid.all() else valid,
                ))
                continue
            data = (
                np.concatenate(datas) if datas
                else np.zeros(0, dtype=cm.type.np_dtype)
            )
            valid = np.concatenate(valids) if valids else np.zeros(0, bool)
            cols.append(_to_parquet_column(
                cm, data, None if valid.all() else valid, None
            ))
        # gzip (zlib) + dictionary pages by default; SNAPPY/ZSTD are
        # read+write capable (parquet_format) but the pure-python snappy
        # encoder would tax every CTAS. 64k-row groups give min/max
        # pruning real skip granularity
        PQ.write_parquet(
            self._tmp, cols, self.rows, codec="gzip",
            row_group_rows=1 << 16,
        )
        os.replace(self._tmp, self._final)
        return self.rows


class FileConnector(Connector):
    """`file_format` chooses the WRITE format for CREATE/INSERT parts
    ("csv" default, "parquet" for the columnar path); reads always
    dispatch by extension."""

    def __init__(self, root: str, file_format: str = "csv"):
        store = _FileStore(root)
        super().__init__(
            "file",
            FileMetadata(store, file_format),
            FileSplitManager(store),
            FilePageSource(store),
        )
        self.store = store
        self.file_format = file_format

    def page_sink(self, handle: TableHandle, transaction=None) -> ConnectorPageSink:
        # the TABLE's existing parts decide the write format — an INSERT
        # must never land a mismatched part next to them (which would
        # fail every subsequent read); the connector's configured format
        # only applies to freshly created tables
        paths = self.store.table_paths(handle.schema, handle.table)
        if paths:
            fmt = "parquet" if paths[0].endswith(".parquet") else "csv"
        else:
            fmt = self.file_format
        if fmt == "parquet":
            return ParquetPageSink(self.store, handle)
        return FilePageSink(self.store, handle)


def create_file_connector(root: str, file_format: str = "csv") -> Connector:
    """plugin entry point (Plugin.getConnectorFactories analogue)."""
    return FileConnector(root, file_format)

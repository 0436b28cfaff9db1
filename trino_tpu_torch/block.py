"""Columnar data model: device-resident structure-of-arrays batches.

Counterpart of trino_tpu/block.py (the Page/Block analogue):

- A ``Column`` is one fixed-capacity tensor plus an optional validity
  mask (NULLs) and an optional host-side string dictionary (VARCHAR
  values live on the device as int32 codes).
- ``ArrayColumn``, ``MapColumn`` and ``RowColumn`` are the nested
  columns: per-row lengths (or a presence byte) in ``data``, plus
  per-row ``starts`` into shared flattened children (ARRAY, MAP) or
  parallel child columns (ROW). A gather moves only the per-row views.
- A ``RelBatch`` is N columns sharing a capacity plus a ``live`` row
  mask. Capacities stay bucketed powers of two and filters only flip
  mask bits, as in the reference, so the two packages see the same
  batch shapes.

Every tensor of a batch lives on one device; the connector places the
scan batches and operators allocate beside their inputs.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.ops.tz import format_tstz

MIN_CAPACITY = 16


def phys_zeros(t, capacity: int, device="cpu") -> torch.Tensor:
    """Zero tensor in a type's physical shape: (capacity,) for flat
    types, (capacity, 2) int64 limb pairs for decimal(>18)."""
    if t.lanes == 2:
        return torch.zeros((capacity, 2), dtype=t.dtype, device=device)
    return torch.zeros(capacity, dtype=t.dtype, device=device)


def null_column(t, capacity: int, dictionary=None, device="cpu") -> "Column":
    """All-NULL column of any type: outer-join padding. Nested types get
    structurally valid empty layouts."""
    invalid = torch.zeros(capacity, dtype=torch.bool, device=device)

    def zeros(dtype):
        return torch.zeros(capacity, dtype=dtype, device=device)
    if t.is_array:
        return ArrayColumn(t, zeros(torch.int32), invalid, None, zeros(torch.int32),
                           null_column(t.element, MIN_CAPACITY, device=device))
    if t.is_map:
        return MapColumn(t, zeros(torch.int32), invalid, None, zeros(torch.int32),
                         null_column(t.key, MIN_CAPACITY, device=device),
                         null_column(t.element, MIN_CAPACITY, device=device))
    if t.is_row:
        return RowColumn(t, zeros(torch.int8), invalid, None,
                         [null_column(ft, capacity, device=device)
                          for _, ft in t.row_fields])
    return Column(t, phys_zeros(t, capacity, device), invalid, dictionary)


def bucket_capacity(n: int) -> int:
    """Round row counts up to a power of two (>= MIN_CAPACITY)."""
    c = MIN_CAPACITY
    while c < n:
        c <<= 1
    return c


class Dictionary:
    """Host-side sorted string dictionary. Device tensors hold int32
    codes; code order == lexical order within one dictionary."""

    __slots__ = ("values", "_index")

    def __init__(self, values: Sequence[str]):
        vals = sorted(set(values))
        self.values: tuple = tuple(vals)
        self._index = {v: i for i, v in enumerate(vals)}

    def __len__(self) -> int:
        return len(self.values)

    def __hash__(self):
        return hash(self.values)

    def __eq__(self, other):
        return isinstance(other, Dictionary) and self.values == other.values

    def code(self, value: str) -> int:
        """Code for value; -1 if absent."""
        return self._index.get(value, -1)

    def encode(self, values: Sequence[str]) -> np.ndarray:
        """int32 codes of values that are all in the dictionary."""
        return np.asarray([self._index[v] for v in values], dtype=np.int32)

    def code_lower_bound(self, value: str) -> int:
        """Smallest code whose value >= `value`."""
        return bisect.bisect_left(self.values, value)

    @staticmethod
    def unify(a: "Dictionary", b: "Dictionary"):
        """Merged dictionary plus remap arrays old-code -> new-code."""
        merged = Dictionary(a.values + b.values)
        remap_a = np.asarray([merged._index[v] for v in a.values], dtype=np.int32)
        remap_b = np.asarray([merged._index[v] for v in b.values], dtype=np.int32)
        return merged, remap_a, remap_b


class RuntimeDictionary(Dictionary):
    """Plan-time placeholder for a string column whose dictionary is made
    at execution time (listagg builds new strings). Column references
    pass the batch's own dictionary through
    (operators.make_filter_project_fn); a plan-time string operation on
    it cannot know the values and raises at bind time."""

    def __init__(self):
        super().__init__([])


@dataclasses.dataclass
class Column:
    """One column: fixed-capacity tensor + validity + dictionary."""

    type: T.DataType
    data: torch.Tensor  # (capacity,) or (capacity, 2); dtype = type.dtype
    valid: Optional[torch.Tensor] = None  # bool (capacity,), None = all valid
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.capacity, dtype=torch.bool, device=self.device)
        return self.valid

    def with_data(self, data, valid="__same__") -> "Column":
        """The same column (nested layout included) over new per-row data."""
        return dataclasses.replace(
            self, data=data, valid=self.valid if isinstance(valid, str) else valid)

    def _gather_rows(self, positions, positions_valid):
        """(pos, gathered data, gathered valid) of a clipped row gather."""
        pos = torch.clamp(positions.to(torch.int64), 0, self.capacity - 1)
        data = self.data.index_select(0, pos)
        valid = None
        if self.valid is not None:
            valid = self.valid.index_select(0, pos)
        if positions_valid is not None:
            valid = positions_valid if valid is None else (valid & positions_valid)
        return pos, data, valid

    def gather(self, positions: torch.Tensor, positions_valid=None) -> "Column":
        """Vectorized position copy (clipped positions)."""
        _, data, valid = self._gather_rows(positions, positions_valid)
        return Column(self.type, data, valid, self.dictionary)

    # -- host conversion --
    @staticmethod
    def from_numpy(
        type_: T.DataType,
        values: np.ndarray,
        valid: Optional[np.ndarray] = None,
        dictionary: Optional[Dictionary] = None,
        capacity: Optional[int] = None,
        device="cpu",
    ) -> "Column":
        n = len(values)
        cap = capacity if capacity is not None else bucket_capacity(n)
        shape = (cap, 2) if type_.lanes == 2 else (cap,)
        data = np.zeros(shape, dtype=type_.np_dtype)
        data[:n] = values
        v = None
        if valid is not None:
            v = np.zeros(cap, dtype=bool)
            v[:n] = valid
            v = torch.from_numpy(v).to(device)
        return Column(type_, torch.from_numpy(data).to(device), v, dictionary)

    @staticmethod
    def from_pylist(type_: T.DataType, values: Sequence[Any], capacity=None,
                    device="cpu") -> "Column":
        if type_.is_array:
            return ArrayColumn.from_pylists(type_.element, values, capacity, device=device)
        if type_.is_map:
            return MapColumn.from_pydicts(type_.key, type_.element, values, capacity,
                                          device=device)
        if type_.is_row:
            return RowColumn.from_pytuples(type_, values, capacity, device=device)
        has_null = any(v is None for v in values)
        if type_.is_string:
            dictionary = Dictionary([v for v in values if v is not None])
            arr = np.asarray(
                [dictionary.code(v) if v is not None else 0 for v in values],
                dtype=np.int32,
            )
        elif type_.is_decimal:
            dictionary = None
            sf = T.decimal_scale_factor(type_)

            def scaled(v):
                from decimal import Decimal

                if isinstance(v, float):
                    return round(v * sf)
                return int(Decimal(str(v)) * sf)

            if type_.is_long_decimal:
                from trino_tpu_torch.ops.int128 import from_python

                pairs = [
                    from_python(scaled(v)) if v is not None else (0, 0)
                    for v in values
                ]
                arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
            else:
                arr = np.asarray(
                    [scaled(v) if v is not None else 0 for v in values],
                    dtype=type_.np_dtype,
                )
        else:
            dictionary = None
            arr = np.asarray(
                [v if v is not None else 0 for v in values], dtype=type_.np_dtype
            )
        valid = None
        if has_null:
            valid = np.asarray([v is not None for v in values], dtype=bool)
        return Column.from_numpy(type_, arr, valid, dictionary, capacity, device)

    def to_pylist(self, count: Optional[int] = None, live: Optional[np.ndarray] = None):
        data = self.data.cpu().numpy()
        valid = (
            self.valid.cpu().numpy() if self.valid is not None
            else np.ones(len(data), bool)
        )
        if live is not None:
            keep = np.asarray(live)
            data, valid = data[keep], valid[keep]
        if count is not None:
            data, valid = data[:count], valid[:count]
        dict_values = self.dictionary.values if self.dictionary else None
        return decode_values(self.type, data, valid, dict_values)


def _host_valid(c: Column, n: int) -> np.ndarray:
    return c.valid.cpu().numpy() if c.valid is not None else np.ones(n, bool)


def _views(c: Column, live, count):
    """(starts, lengths, valid) of the rows `to_pylist` returns, and the
    flat positions of their elements, row after row: only those elements
    are decoded (a filtered or gathered column's flat child can be far
    larger than what its live rows read)."""
    lengths = c.data.cpu().numpy().astype(np.int64)
    starts = c.starts.cpu().numpy().astype(np.int64)
    valid = _host_valid(c, len(lengths))
    if live is not None:
        keep = np.asarray(live)
        lengths, starts, valid = lengths[keep], starts[keep], valid[keep]
    if count is not None:
        lengths, starts, valid = lengths[:count], starts[:count], valid[:count]
    lengths = np.where(valid, lengths, 0)
    first, pos = element_positions(starts, lengths)
    return first, lengths, valid, torch.from_numpy(pos)


def element_positions(starts: np.ndarray, lengths: np.ndarray):
    """Host form of the rows' elements laid out row after row: (each
    row's first slot, the flat position of every slot)."""
    first = np.cumsum(lengths) - lengths
    return first, np.repeat(starts - first, lengths) + np.arange(int(lengths.sum()))


def _flat_extents(values, cap: int):
    """(lengths, starts, valid or None, flattened items) of a list of
    python sequences or dicts (None = NULL), laid out row after row."""
    lengths = np.zeros(cap, dtype=np.int32)
    starts = np.zeros(cap, dtype=np.int32)
    valid = np.zeros(cap, dtype=bool) if any(v is None for v in values) else None
    items: list = []
    for i, v in enumerate(values):
        starts[i] = len(items)
        if v is None:
            continue
        if valid is not None:
            valid[i] = True
        lengths[i] = len(v)
        items.extend(v.items() if isinstance(v, dict) else v)
    return lengths, starts, valid, items


@dataclasses.dataclass
class ArrayColumn(Column):
    """ARRAY column: per-row views into one flattened element column
    (ArrayBlock's offsets + values). `data` holds per-row LENGTHS, so
    code that needs only cardinality reads an ordinary int32 tensor;
    `starts` + `flat` carry the elements. A gather moves only the views:
    the flat child is shared, so after a join, sort or TopN the rows'
    slices of `flat` are no longer in row order, and may repeat."""

    starts: Optional[torch.Tensor] = None  # int32 (capacity,)
    flat: Optional[Column] = None  # flattened elements

    def gather(self, positions: torch.Tensor, positions_valid=None) -> "ArrayColumn":
        pos, lengths, valid = self._gather_rows(positions, positions_valid)
        return ArrayColumn(self.type, lengths, valid, self.dictionary,
                           self.starts.index_select(0, pos), self.flat)

    @staticmethod
    def from_pylists(element_type: T.DataType, values, capacity=None,
                     dictionary: Optional[Dictionary] = None,
                     device="cpu") -> "ArrayColumn":
        """values: python lists (None = NULL array). `dictionary`: a
        table-stable element dictionary for string elements."""
        cap = capacity if capacity is not None else bucket_capacity(len(values))
        lengths, starts, valid, flat_vals = _flat_extents(values, cap)
        if dictionary is not None and element_type.is_string:
            codes = np.asarray([dictionary.code(v) if v is not None else 0
                                for v in flat_vals], dtype=np.int32)
            fvalid = (np.asarray([v is not None for v in flat_vals], dtype=bool)
                      if any(v is None for v in flat_vals) else None)
            flat = Column.from_numpy(element_type, codes, fvalid, dictionary, device=device)
        else:
            flat = Column.from_pylist(element_type, flat_vals, device=device)
        return ArrayColumn(
            T.array_of(element_type), torch.from_numpy(lengths).to(device),
            None if valid is None else torch.from_numpy(valid).to(device), None,
            torch.from_numpy(starts).to(device), flat)

    def to_pylist(self, count: Optional[int] = None, live: Optional[np.ndarray] = None):
        first, lengths, valid, pos = _views(self, live, count)
        vals = self.flat.gather(pos.to(self.flat.device)).to_pylist(count=len(pos))
        return [vals[s:s + n] if ok else None for s, n, ok in zip(first, lengths, valid)]


@dataclasses.dataclass
class MapColumn(Column):
    """MAP column: per-row entry views into two flattened child columns
    (MapBlock's keys + values). `data` holds per-row entry COUNTS;
    `starts` + `flat_keys`/`flat_values` carry the entries. A gather
    moves only the views; the flat children are shared."""

    starts: Optional[torch.Tensor] = None  # int32 (capacity,)
    flat_keys: Optional[Column] = None
    flat_values: Optional[Column] = None

    def gather(self, positions: torch.Tensor, positions_valid=None) -> "MapColumn":
        pos, lengths, valid = self._gather_rows(positions, positions_valid)
        return MapColumn(self.type, lengths, valid, self.dictionary,
                         self.starts.index_select(0, pos), self.flat_keys,
                         self.flat_values)

    @staticmethod
    def from_pydicts(key_type: T.DataType, value_type: T.DataType, values,
                     capacity=None, device="cpu") -> "MapColumn":
        """values: python dicts (None = NULL map)."""
        cap = capacity if capacity is not None else bucket_capacity(len(values))
        lengths, starts, valid, entries = _flat_extents(values, cap)
        return MapColumn(
            T.map_of(key_type, value_type), torch.from_numpy(lengths).to(device),
            None if valid is None else torch.from_numpy(valid).to(device), None,
            torch.from_numpy(starts).to(device),
            Column.from_pylist(key_type, [k for k, _ in entries], device=device),
            Column.from_pylist(value_type, [x for _, x in entries], device=device))

    def to_pylist(self, count: Optional[int] = None, live: Optional[np.ndarray] = None):
        first, lengths, valid, pos = _views(self, live, count)
        idx = pos.to(self.flat_keys.device)
        ks = self.flat_keys.gather(idx).to_pylist(count=len(pos))
        vs = self.flat_values.gather(idx).to_pylist(count=len(pos))
        return [dict(zip(ks[s:s + n], vs[s:s + n])) if ok else None
                for s, n, ok in zip(first, lengths, valid)]


@dataclasses.dataclass
class RowColumn(Column):
    """ROW column: parallel child columns, one per field (RowBlock).
    `data` is a per-row presence byte; NULL rows ride `valid`."""

    children: Optional[list] = None  # list[Column], same capacity

    def gather(self, positions: torch.Tensor, positions_valid=None) -> "RowColumn":
        _, data, valid = self._gather_rows(positions, positions_valid)
        return RowColumn(self.type, data, valid, self.dictionary,
                         [c.gather(positions, positions_valid) for c in self.children])

    @staticmethod
    def from_pytuples(row_type: T.DataType, values, capacity=None,
                      device="cpu") -> "RowColumn":
        """values: python tuples or lists (None = NULL row)."""
        n = len(values)
        cap = capacity if capacity is not None else bucket_capacity(n)
        presence = np.zeros(cap, dtype=np.int8)
        presence[:n] = 1
        valid = None
        if any(v is None for v in values):
            valid = np.zeros(cap, dtype=bool)
            valid[:n] = [v is not None for v in values]
        kids = [Column.from_pylist(ft, [None if v is None else v[fi] for v in values],
                                   capacity=cap, device=device)
                for fi, (_, ft) in enumerate(row_type.row_fields)]
        return RowColumn(row_type, torch.from_numpy(presence).to(device),
                         None if valid is None else torch.from_numpy(valid).to(device),
                         None, kids)

    def to_pylist(self, count: Optional[int] = None, live: Optional[np.ndarray] = None):
        valid = _host_valid(self, self.capacity)
        if live is not None:
            valid = valid[np.asarray(live)]
        if count is not None:
            valid = valid[:count]
        kid_vals = [c.to_pylist(count, live) for c in self.children]
        return [tuple(kv[i] for kv in kid_vals) if ok else None
                for i, ok in enumerate(valid)]


@dataclasses.dataclass
class RelBatch:
    """A batch of rows: columns share capacity; `live` masks real rows
    (None = all `capacity` rows live)."""

    columns: list  # list[Column]
    live: Optional[torch.Tensor] = None  # bool (capacity,)

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def width(self) -> int:
        return len(self.columns)

    @property
    def device(self) -> torch.device:
        if self.live is not None:
            return self.live.device
        return self.columns[0].device

    def live_mask(self) -> torch.Tensor:
        if self.live is None:
            return torch.ones(self.capacity, dtype=torch.bool, device=self.device)
        return self.live

    def row_count(self) -> int:
        """Host-synced live-row count."""
        if self.live is None:
            return self.capacity
        return int(torch.sum(self.live))

    def live_rows(self):
        """(the live mask, None when every row is live; the live-row
        count), host-synced: what a sink copying the live rows needs."""
        if self.live is None:
            return None, self.capacity
        n = int(self.live.sum())
        return (None if n == self.live.numel() else self.live), n

    def mask(self, keep: torch.Tensor) -> "RelBatch":
        """Filter: AND `keep` into the live mask (no data movement)."""
        live = keep if self.live is None else (self.live & keep)
        return RelBatch(self.columns, live)

    def gather(self, positions: torch.Tensor, positions_live=None) -> "RelBatch":
        return RelBatch([c.gather(positions) for c in self.columns], positions_live)

    def compact(self) -> "RelBatch":
        """Front-pack live rows (stable); capacity unchanged."""
        if self.live is None:
            return self
        order = torch.argsort((~self.live).to(torch.int8), stable=True)
        n_live = torch.sum(self.live)
        new_live = torch.arange(self.capacity, device=self.device) < n_live
        return RelBatch([c.gather(order) for c in self.columns], new_live)

    # -- host conversion --
    @staticmethod
    def from_pydict(schema, data: dict, capacity=None, device="cpu") -> "RelBatch":
        """schema: list[(name, DataType)] — names are positional only."""
        n = None
        for name, _ in schema:
            vals = data[name]
            n = len(vals) if n is None else n
            assert len(vals) == n
        cap = capacity if capacity is not None else bucket_capacity(n or 0)
        cols = [
            Column.from_pylist(typ, data[name], capacity=cap, device=device)
            for name, typ in schema
        ]
        live = None
        if (n or 0) != cap:
            lv = np.zeros(cap, dtype=bool)
            lv[: n or 0] = True
            live = torch.from_numpy(lv).to(device)
        return RelBatch(cols, live)

    def to_pylists(self):
        """Rows as lists of python values, live rows only, in order."""
        live = None if self.live is None else self.live.cpu().numpy()
        cols = [c.to_pylist(live=live) for c in self.columns]
        return [list(row) for row in zip(*cols)] if cols else []


def host_rows(x: torch.Tensor, live: Optional[torch.Tensor]) -> np.ndarray:
    """The rows of a device tensor that `live` keeps (all when None),
    copied to the host."""
    return (x if live is None else x[live]).cpu().numpy()


# an int64 magnitude below this, and every decimal(<=18) scale factor
# (10**18 = 2**18 * 5**18), convert to float64 exactly, so a float64
# division is Python's correctly rounded int / int
_EXACT_FLOAT = 1 << 53


def decode_values(type_: T.DataType, data, valid, dict_values) -> list:
    """Physical values -> python values (the host-side decode rules).
    A flat column decodes as one array (numpy's tolist); long decimals,
    zoned timestamps and decimals at 2**53 or above decode value by
    value. NULL slots decode to None."""
    arr = np.asarray(data)
    valid = np.asarray(valid, dtype=bool)
    if type_.is_long_decimal:
        from trino_tpu_torch.ops.int128 import to_python

        scale = T.decimal_scale_factor(type_)
        vals = [to_python(int(x[0]), int(x[1])) / scale if ok else None
                for x, ok in zip(arr, valid)]
    elif type_.kind == T.TypeKind.TIMESTAMP_TZ:
        vals = [format_tstz(x) if ok else None for x, ok in zip(arr.tolist(), valid)]
    elif type_.is_decimal:
        scale = T.decimal_scale_factor(type_)
        ints = np.where(valid, arr, 0).astype(np.int64)
        if ints.size and int(np.abs(ints).max()) >= _EXACT_FLOAT:
            vals = [x / scale for x in ints.tolist()]
        else:
            vals = (ints.astype(np.float64) / float(scale)).tolist()
    elif type_.is_string:
        codes = np.where(valid, arr, 0).astype(np.int64).tolist()
        vals = [dict_values[c] for c in codes] if dict_values else [str(c) for c in codes]
    elif type_.kind == T.TypeKind.BOOLEAN:
        vals = arr.astype(bool).tolist()
    elif type_.is_floating:
        vals = arr.astype(np.float64).tolist()
    else:
        vals = arr.astype(np.int64).tolist()
    if valid.all():
        return vals
    return [v if ok else None for v, ok in zip(vals, valid.tolist())]


def unify_column_dicts(cols: Sequence[Column]) -> list:
    """Remap same-type string columns onto one merged dictionary (no-op
    when the dictionaries already agree)."""
    dicts = [c.dictionary for c in cols]
    present = [d for d in dicts if d is not None]
    if not present or all(d == present[0] for d in dicts if d is not None):
        return list(cols)
    merged = present[0]
    for d in present[1:]:
        merged, _, _ = Dictionary.unify(merged, d)
    out = []
    for c in cols:
        if c.dictionary is None or c.dictionary == merged:
            out.append(Column(c.type, c.data, c.valid, merged))
            continue
        remap = torch.tensor(
            [merged.code(v) for v in c.dictionary.values], dtype=torch.int32,
            device=c.device,
        )
        idx = torch.clamp(c.data.to(torch.int64), 0, max(len(c.dictionary) - 1, 0))
        out.append(Column(c.type, remap[idx], c.valid, merged))
    return out


def _concat_valid(parts):
    if any(p.valid is not None for p in parts):
        return torch.cat([p.valid_mask() for p in parts])
    return None


def _concat_columns(parts: list) -> Column:
    """Concatenate the fragments of one schema slot, keeping nested
    layouts: array/map flats concatenate, with each part's starts
    rebased by the capacities of the flats before it; row children
    concatenate field by field."""
    first = parts[0]
    if isinstance(first, (ArrayColumn, MapColumn)):
        data = torch.cat([p.data for p in parts])
        starts, off = [], 0
        keys, vals = [], []
        for p in parts:
            starts.append(p.starts + off)
            if isinstance(p, ArrayColumn):
                off += p.flat.capacity
                keys.append(p.flat)
            else:
                off += p.flat_keys.capacity
                keys.append(p.flat_keys)
                vals.append(p.flat_values)
        starts = torch.cat(starts).to(torch.int32)
        if isinstance(first, ArrayColumn):
            return ArrayColumn(first.type, data, _concat_valid(parts), None, starts,
                               _concat_columns(keys))
        return MapColumn(first.type, data, _concat_valid(parts), None, starts,
                         _concat_columns(keys), _concat_columns(vals))
    if isinstance(first, RowColumn):
        kids = [_concat_columns([p.children[i] for p in parts])
                for i in range(len(first.children))]
        return RowColumn(first.type, torch.cat([p.data for p in parts]),
                         _concat_valid(parts), None, kids)
    parts = unify_column_dicts(parts)
    data = torch.cat([p.data for p in parts])
    return Column(parts[0].type, data, _concat_valid(parts), parts[0].dictionary)


def concat_batches(batches: Sequence[RelBatch]) -> RelBatch:
    """Concatenate batches; capacity is the sum of input capacities."""
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    cols = [
        _concat_columns([b.columns[i] for b in batches])
        for i in range(batches[0].width)
    ]
    live = torch.cat([b.live_mask() for b in batches])
    return RelBatch(cols, live)


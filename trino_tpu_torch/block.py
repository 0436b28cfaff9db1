"""Columnar data model: device-resident structure-of-arrays batches.

Counterpart of trino_tpu/block.py (the Page/Block analogue):

- A ``Column`` is one fixed-capacity tensor plus an optional validity
  mask (NULLs) and an optional host-side string dictionary (VARCHAR
  values live on the device as int32 codes).
- A ``RelBatch`` is N columns sharing a capacity plus a ``live`` row
  mask. Capacities stay bucketed powers of two and filters only flip
  mask bits, as in the reference, so the two packages see the same
  batch shapes.

Every tensor of a batch lives on one device; the connector places the
scan batches and operators allocate beside their inputs.

Not ported yet (each raises NotImplementedError naming its queue item
in ROADMAP.md): the nested ARRAY/MAP/ROW columns and TIMESTAMP WITH
TIME ZONE formatting.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T

MIN_CAPACITY = 16


def phys_zeros(t, capacity: int, device="cpu") -> torch.Tensor:
    """Zero tensor in a type's physical shape: (capacity,) for flat
    types, (capacity, 2) int64 limb pairs for decimal(>18)."""
    if t.lanes == 2:
        return torch.zeros((capacity, 2), dtype=t.dtype, device=device)
    return torch.zeros(capacity, dtype=t.dtype, device=device)


def null_column(t, capacity: int, dictionary=None, device="cpu") -> "Column":
    """All-NULL column of a flat type: outer-join padding."""
    if t.is_nested:
        raise NotImplementedError(
            f"nested column {t}: ROADMAP §1 item 4 (nested ARRAY/MAP/ROW)"
        )
    invalid = torch.zeros(capacity, dtype=torch.bool, device=device)
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

    def gather(self, positions: torch.Tensor, positions_valid=None) -> "Column":
        """Vectorized position copy (clipped positions)."""
        pos = torch.clamp(positions.to(torch.int64), 0, self.capacity - 1)
        data = self.data.index_select(0, pos)
        valid = None
        if self.valid is not None:
            valid = self.valid.index_select(0, pos)
        if positions_valid is not None:
            valid = positions_valid if valid is None else (valid & positions_valid)
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
        if type_.is_nested:
            raise NotImplementedError(
                f"nested column {type_}: ROADMAP §1 item 4 (nested ARRAY/MAP/ROW)"
            )
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


def decode_values(type_: T.DataType, data, valid, dict_values) -> list:
    """Physical values -> python values (the host-side decode rules)."""
    out = []
    for x, ok in zip(data, valid):
        if not ok:
            out.append(None)
        elif type_.is_string:
            out.append(dict_values[int(x)] if dict_values else str(int(x)))
        elif type_.is_decimal:
            if type_.is_long_decimal:
                from trino_tpu_torch.ops.int128 import to_python

                v = to_python(int(x[0]), int(x[1]))
                out.append(v / T.decimal_scale_factor(type_))
            else:
                out.append(int(x) / T.decimal_scale_factor(type_))
        elif type_.kind == T.TypeKind.BOOLEAN:
            out.append(bool(x))
        elif type_.is_floating:
            out.append(float(x))
        elif type_.kind == T.TypeKind.TIMESTAMP_TZ:
            raise NotImplementedError(
                "TIMESTAMP WITH TIME ZONE formatting: ROADMAP §1 item 6 (ops/tz.py)"
            )
        else:
            out.append(int(x))
    return out


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
    if parts[0].type.is_nested:
        raise NotImplementedError(
            f"nested column {parts[0].type}: ROADMAP §1 item 4 (nested ARRAY/MAP/ROW)"
        )
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


def _nested_not_ported(name: str):
    class _Nested(Column):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name}: ROADMAP §1 item 4 (nested ARRAY/MAP/ROW)"
            )

    _Nested.__name__ = _Nested.__qualname__ = name
    return _Nested


ArrayColumn = _nested_not_ported("ArrayColumn")
MapColumn = _nested_not_ported("MapColumn")
RowColumn = _nested_not_ported("RowColumn")

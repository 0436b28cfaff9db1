"""Page wire format: host-side serialized batches.

Counterpart of trino_tpu/exec/serde.py, and its wire format byte for
byte: the same host rows give the same bytes in both packages (the
distributed page plane and the spill files are held against it). The
wire unit is a host ``Page``: compacted numpy columns, dead rows never
on the wire. A ``Page`` is made from a device batch with ONE
device->host copy (every tensor of the batch packed into one byte
buffer on the device first), then the live rows are extracted on the
host by the native mask sweep (trino_tpu_torch/native). Nested columns
(ARRAY/MAP/ROW) compact recursively into ``HostNested`` trees.
``Page.to_batch`` builds the tensors on an explicit device.

Framing:  [u8 codec] [u32 raw_len] [body]
  codec: 0 = raw body, 1 = zlib-compressed body.
The body is a self-describing binary layout (typed column descriptors
and raw numpy buffers); no object deserializer ever reads wire bytes.

A column's physical dtype is its SQL type's in both packages
(types.py); a host array of another dtype is cast to it at the page
boundary. TIMESTAMP WITH TIME ZONE values are packed with zone ids of
the host's TZif registry (ops/tz.py): a page read on a host whose
registry differs names other zones.
"""

from __future__ import annotations

import collections
import dataclasses
import struct
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import (
    ArrayColumn,
    Column,
    Dictionary,
    MapColumn,
    RelBatch,
    RowColumn,
    bucket_capacity,
    decode_values,
)

_HEADER = struct.Struct("<BI")


@dataclasses.dataclass
class HostNested:
    """Host-side compacted nested column (ARRAY/MAP/ROW): per-row
    physical array (lengths / entry counts / presence), validity, and
    child columns. Children are HostNested too (leaves have none)."""

    type: T.DataType
    data: np.ndarray
    valid: Optional[np.ndarray]
    dictionary: Optional[Tuple[str, ...]]
    children: List["HostNested"]

    def nbytes(self) -> int:
        n = self.data.nbytes + (self.valid.nbytes if self.valid is not None else 0)
        return n + sum(c.nbytes() for c in self.children)

    def to_pylist(self) -> list:
        """Decode to python values (lists / dicts / tuples / scalars)."""
        t = self.type
        n = len(self.data)
        valid = self.valid if self.valid is not None else np.ones(n, bool)
        if t.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP):
            offs = np.concatenate([[0], np.cumsum(self.data)])
            if t.kind == T.TypeKind.ARRAY:
                flat = self.children[0].to_pylist()
                return [
                    list(flat[offs[i]:offs[i + 1]]) if valid[i] else None
                    for i in range(n)
                ]
            ks = self.children[0].to_pylist()
            vs = self.children[1].to_pylist()
            return [
                dict(zip(ks[offs[i]:offs[i + 1]], vs[offs[i]:offs[i + 1]]))
                if valid[i] else None
                for i in range(n)
            ]
        if t.kind == T.TypeKind.ROW:
            kid_vals = [c.to_pylist() for c in self.children]
            return [
                tuple(kv[i] for kv in kid_vals) if valid[i] else None
                for i in range(n)
            ]
        return decode_values(t, self.data, valid, self.dictionary)


def _slice_ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat positions of the concatenated [starts[i], starts[i]+len[i])
    slices (the gather list of a nested compaction)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out_off = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return np.repeat(starts.astype(np.int64), lengths) + (
        np.arange(total, dtype=np.int64) - np.repeat(out_off, lengths)
    )


def slice_host_nested(hn: HostNested, idx: np.ndarray) -> HostNested:
    """Row selection over a compacted HostNested (exchange partitioning):
    keeps the selected rows and exactly their element slices."""
    data = hn.data[idx]
    valid = hn.valid[idx] if hn.valid is not None else None
    t = hn.type
    if t.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP):
        starts = (np.cumsum(hn.data) - hn.data).astype(np.int64)
        flat_idx = _slice_ranges(starts[idx], data.astype(np.int64))
        kids = [slice_host_nested(c, flat_idx) for c in hn.children]
        return HostNested(t, data, valid, hn.dictionary, kids)
    if t.kind == T.TypeKind.ROW:
        kids = [slice_host_nested(c, idx) for c in hn.children]
        return HostNested(t, data, valid, hn.dictionary, kids)
    return HostNested(t, data, valid, hn.dictionary, [])


# -- the device -> host copy ------------------------------------------------


def _tensors(col: Column, out: list) -> None:
    """Every tensor of a column tree, in a fixed walk order."""
    out.append(col.data)
    if col.valid is not None:
        out.append(col.valid)
    if isinstance(col, ArrayColumn):
        out.append(col.starts)
        _tensors(col.flat, out)
    elif isinstance(col, MapColumn):
        out.append(col.starts)
        _tensors(col.flat_keys, out)
        _tensors(col.flat_values, out)
    elif isinstance(col, RowColumn):
        for c in col.children:
            _tensors(c, out)


def _mirror(col: Column, host) -> Column:
    """The column tree with each tensor replaced by its host array
    (taken from the iterator `host` in `_tensors`' order)."""
    data = next(host)
    valid = next(host) if col.valid is not None else None
    if isinstance(col, ArrayColumn):
        starts = next(host)
        return dataclasses.replace(col, data=data, valid=valid, starts=starts,
                                   flat=_mirror(col.flat, host))
    if isinstance(col, MapColumn):
        starts = next(host)
        keys = _mirror(col.flat_keys, host)
        return dataclasses.replace(col, data=data, valid=valid, starts=starts,
                                   flat_keys=keys, flat_values=_mirror(col.flat_values, host))
    if isinstance(col, RowColumn):
        kids = [_mirror(c, host) for c in col.children]
        return dataclasses.replace(col, data=data, valid=valid, children=kids)
    return dataclasses.replace(col, data=data, valid=valid)


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of `tensors` (all on one device): on a CUDA device
    their bytes are packed into one buffer there and copied in ONE
    transfer; CPU tensors are read in place."""
    if not tensors:
        return []
    if tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    flat = [t.contiguous().view(torch.uint8).reshape(-1) for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        np_dt = np.dtype(str(t.dtype).replace("torch.", "")) if t.dtype != torch.bool \
            else np.dtype(np.bool_)
        out.append(buf[off: off + n].view(np_dt).reshape(tuple(t.shape)))
        off += n
    return out


def _compact_nested(col, idx: np.ndarray) -> HostNested:
    """Host mirror of a nested column -> HostNested keeping rows `idx`
    (recursively flattening only those rows' element slices)."""
    data = np.asarray(col.data)[idx]
    valid = np.asarray(col.valid)[idx] if col.valid is not None else None
    if isinstance(col, (ArrayColumn, MapColumn)):
        lengths = data.astype(np.int64)
        if valid is not None:
            lengths = np.where(valid, lengths, 0)
        starts = np.asarray(col.starts)[idx]
        flat_idx = _slice_ranges(starts, lengths)
        if isinstance(col, ArrayColumn):
            kids = [_compact_nested(col.flat, flat_idx)]
        else:
            kids = [
                _compact_nested(col.flat_keys, flat_idx),
                _compact_nested(col.flat_values, flat_idx),
            ]
        return HostNested(col.type, lengths.astype(np.int32), valid, None, kids)
    if isinstance(col, RowColumn):
        kids = [_compact_nested(c, idx) for c in col.children]
        return HostNested(col.type, data, valid, None, kids)
    dvals = col.dictionary.values if col.dictionary is not None else None
    return HostNested(col.type, _physical(col.type, data), valid, dvals, [])


def _physical(t: T.DataType, data: np.ndarray) -> np.ndarray:
    """A leaf's host array in its SQL type's physical dtype (the page
    boundary's carrier conversion)."""
    want = t.np_dtype
    return data if data.dtype == want else data.astype(want)


def _nested_to_device(hn: HostNested, capacity: int, device):
    """HostNested -> device column (padded to `capacity`)."""
    t = hn.type

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    def padded_valid():
        if hn.valid is None:
            return None
        v = np.zeros(capacity, dtype=bool)
        v[: len(hn.data)] = hn.valid
        return dev(v)

    if t.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP):
        n = len(hn.data)
        lengths = np.zeros(capacity, dtype=np.int32)
        lengths[:n] = hn.data
        starts = np.zeros(capacity, dtype=np.int32)
        starts[:n] = np.cumsum(hn.data) - hn.data
        total = int(hn.data.sum())
        child_cap = max(bucket_capacity(total), 16)
        if t.kind == T.TypeKind.ARRAY:
            return ArrayColumn(
                t, dev(lengths), padded_valid(), None, dev(starts),
                _nested_to_device(hn.children[0], child_cap, device),
            )
        return MapColumn(
            t, dev(lengths), padded_valid(), None, dev(starts),
            _nested_to_device(hn.children[0], child_cap, device),
            _nested_to_device(hn.children[1], child_cap, device),
        )
    if t.kind == T.TypeKind.ROW:
        presence = np.zeros(capacity, dtype=np.int8)
        presence[: len(hn.data)] = hn.data
        kids = [_nested_to_device(c, capacity, device) for c in hn.children]
        return RowColumn(t, dev(presence), padded_valid(), None, kids)
    d = Dictionary(hn.dictionary) if hn.dictionary is not None else None
    return Column.from_numpy(t, hn.data, hn.valid, d, capacity=capacity, device=device)


COMPRESS_MIN_BYTES = 1 << 13  # below this, compression costs more than it saves


# Dictionary objects of recently seen wire value tuples, by identity:
# the pages cut from one batch (a hash split, a broadcast's replicas)
# share their producer's value tuple, so each consumer page would
# otherwise sort and index the same values again. Each entry holds its
# tuple, so an id in the cache is never reused while the entry lives.
_DICT_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_DICT_CACHE_LOCK = threading.Lock()
_DICT_CACHE_MAX = 64


def _dictionary_of(dvals) -> Dictionary:
    key = id(dvals)
    with _DICT_CACHE_LOCK:
        hit = _DICT_CACHE.get(key)
        if hit is not None and hit[0] is dvals:
            _DICT_CACHE.move_to_end(key)
            return hit[1]
    d = Dictionary(dvals)
    with _DICT_CACHE_LOCK:
        _DICT_CACHE[key] = (dvals, d)
        while len(_DICT_CACHE) > _DICT_CACHE_MAX:
            _DICT_CACHE.popitem(last=False)
    return d


@dataclasses.dataclass
class Page:
    """Host-side compacted batch: the unit of exchange and of spill.

    `columns[i]` has exactly `row_count` entries (no capacity padding:
    dead rows never cross the wire)."""

    types: List[T.DataType]
    columns: List[np.ndarray]
    valids: List[Optional[np.ndarray]]
    dictionaries: List[Optional[Tuple[str, ...]]]
    row_count: int

    @property
    def width(self) -> int:
        return len(self.columns)

    def size_bytes(self) -> int:
        n = 0
        for c in self.columns:
            n += c.nbytes() if isinstance(c, HostNested) else c.nbytes
        for v in self.valids:
            if v is not None:
                n += v.nbytes
        return n

    @staticmethod
    def from_batch(batch: RelBatch) -> "Page":
        """Device batch -> compacted host page: one device->host copy
        (`to_host`), then the live rows of the flat columns through the
        native mask sweep; nested columns compact recursively."""
        from trino_tpu_torch import native

        tensors: list = []
        if batch.live is not None:
            tensors.append(batch.live)
        for c in batch.columns:
            _tensors(c, tensors)
        host_iter = iter(to_host(tensors))
        live = (
            next(host_iter).astype(bool) if batch.live is not None
            else np.ones(batch.capacity, dtype=bool)
        )
        host_cols = [_mirror(c, host_iter) for c in batch.columns]
        nested = [c.type.is_nested for c in host_cols]
        live_idx = np.nonzero(live)[0] if any(nested) else None
        flat: List[np.ndarray] = []
        valid_idx: List[Optional[int]] = []
        for c, nest in zip(host_cols, nested):
            if nest:
                continue
            flat.append(_physical(c.type, np.asarray(c.data)))
            if c.valid is not None:
                valid_idx.append(len(flat))
                flat.append(np.asarray(c.valid, dtype=np.bool_))
            else:
                valid_idx.append(None)
        compacted = native.mask_compact(flat, live)
        cols, valids, dicts, typs = [], [], [], []
        i = 0
        vi_iter = iter(valid_idx)
        for c, nest in zip(host_cols, nested):
            typs.append(c.type)
            if nest:
                cols.append(_compact_nested(c, live_idx))
                valids.append(None)  # validity lives inside the HostNested
                dicts.append(None)
                continue
            vi = next(vi_iter)
            cols.append(compacted[i])
            i += 1
            if vi is not None:
                valids.append(compacted[i])
                i += 1
            else:
                valids.append(None)
            dicts.append(c.dictionary.values if c.dictionary is not None else None)
        return Page(typs, cols, valids, dicts, int(live.sum()))

    def to_batch(self, capacity: Optional[int] = None, *, device) -> RelBatch:
        """Host page -> batch on `device`, padded back to a bucketed
        capacity (or `capacity`)."""
        cap = capacity if capacity is not None else bucket_capacity(self.row_count)
        out = []
        for t, data, valid, dvals in zip(
            self.types, self.columns, self.valids, self.dictionaries
        ):
            if isinstance(data, HostNested):
                out.append(_nested_to_device(data, cap, device))
                continue
            d = _dictionary_of(dvals) if dvals is not None else None
            # Dictionary values are sorted and deduplicated on
            # construction; re-encode the codes if that moved any
            if d is not None and d.values != tuple(dvals):
                remap = np.asarray([d.code(v) for v in dvals], dtype=np.int32)
                data = remap[data]
            out.append(Column.from_numpy(t, data, valid, d, capacity=cap, device=device))
        live = None
        if self.row_count != cap:
            lv = np.zeros(cap, dtype=bool)
            lv[: self.row_count] = True
            live = torch.from_numpy(lv).to(device)
        return RelBatch(out, live)


# --- self-describing binary page body (no pickle: bytes received from a
# worker's HTTP port must never reach an object deserializer — the
# reference's page wire is likewise a typed binary layout,
# PagesSerdeUtil.java:53; nested encodings per ArrayBlockEncoding /
# MapBlock / RowBlock). Layout, little-endian:
#   magic u32 'TPG2' | row_count u32 | width u16
#   per column (recursive; nested children are columns at their own
#   row counts — flattened elements for ARRAY/MAP, parallel fields
#   for ROW):
#     type descriptor: kind u8 | precision i16 (-1 none) | scale i16
#       | n_sub u8 | per sub: name_len u8 + utf8 name + descriptor
#     dtype_len u8 | dtype ascii  (numpy dtype str, e.g. '<i8')
#     flags u8 (1 = validity present, 2 = dictionary present)
#     [dict_count u32 | per value: len u32 + utf8]   (if dictionary)
#     n_rows u32 (this level)
#     data_nbytes u64 | raw per-row physical bytes (values / lengths /
#       entry counts / presence)
#     [n_rows validity bytes]                        (if validity)
#     n_children u8 | child columns...

_MAGIC = 0x54504732  # 'TPG2'
_KINDS = list(T.TypeKind)
_KIND_ID = {k: i for i, k in enumerate(_KINDS)}
_COL_HEAD = struct.Struct("<BhhB")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _enc_type(out: bytearray, t: T.DataType) -> None:
    p = -1 if t.precision is None else int(t.precision)
    s = -1 if t.scale is None else int(t.scale)
    if t.kind == T.TypeKind.ARRAY:
        subs = [(None, t.element)]
    elif t.kind == T.TypeKind.MAP:
        subs = [(None, t.key), (None, t.element)]
    elif t.kind == T.TypeKind.ROW:
        subs = list(t.row_fields)
    else:
        subs = []
    out += _COL_HEAD.pack(_KIND_ID[t.kind], p, s, len(subs))
    for name, st in subs:
        nb = (name or "").encode("utf-8")
        out += bytes([len(nb)]) + nb
        _enc_type(out, st)


def _dec_type(take) -> T.DataType:
    kind_id, p, s, n_sub = _COL_HEAD.unpack(take(_COL_HEAD.size))
    kind = _KINDS[kind_id]
    subs = []
    for _ in range(n_sub):
        (nl,) = take(1)
        name = bytes(take(nl)).decode("utf-8") or None
        subs.append((name, _dec_type(take)))
    if kind == T.TypeKind.ARRAY:
        return T.array_of(subs[0][1])
    if kind == T.TypeKind.MAP:
        return T.map_of(subs[0][1], subs[1][1])
    if kind == T.TypeKind.ROW:
        return T.DataType(kind, row_fields=tuple(subs))
    return T.DataType(kind, None if p < 0 else p, None if s < 0 else s)


def _enc_col(out: bytearray, t: T.DataType, data: np.ndarray,
             valid: Optional[np.ndarray],
             dvals: Optional[Tuple[str, ...]],
             children: List[HostNested]) -> None:
    _enc_type(out, t)
    ds = data.dtype.str.encode("ascii")
    out += bytes([len(ds)]) + ds
    flags = (1 if valid is not None else 0) | (2 if dvals is not None else 0)
    out += bytes([flags])
    if dvals is not None:
        out += _U32.pack(len(dvals))
        for v in dvals:
            vb = v.encode("utf-8")
            out += _U32.pack(len(vb)) + vb
    n_rows = int(data.shape[0])
    out += _U32.pack(n_rows)
    raw = np.ascontiguousarray(data).tobytes()
    out += _U64.pack(len(raw)) + raw
    if valid is not None:
        out += np.ascontiguousarray(valid, dtype=np.bool_).tobytes()
    out += bytes([len(children)])
    for c in children:
        _enc_col(out, c.type, c.data, c.valid, c.dictionary, c.children)


def _dec_col(take):
    """-> (type, data, valid, dvals, children: List[HostNested])."""
    t = _dec_type(take)
    (ds_len,) = take(1)
    dtype = np.dtype(bytes(take(ds_len)).decode("ascii"))
    (flags,) = take(1)
    dvals = None
    if flags & 2:
        (n_vals,) = _U32.unpack(take(4))
        vals = []
        for _ in range(n_vals):
            (vl,) = _U32.unpack(take(4))
            vals.append(bytes(take(vl)).decode("utf-8"))
        dvals = tuple(vals)
    (n_rows,) = _U32.unpack(take(4))
    (nbytes,) = _U64.unpack(take(8))
    data = np.frombuffer(take(nbytes), dtype=dtype).copy()
    if t.lanes == 2:  # long-decimal (n, 2) limb pairs flatten on wire
        data = data.reshape(-1, 2)
    if data.shape[0] != n_rows:
        raise ValueError("column length does not match row count")
    valid = None
    if flags & 1:
        valid = np.frombuffer(take(n_rows), dtype=np.bool_).copy()
    (n_children,) = take(1)
    children = []
    for _ in range(n_children):
        ct, cd, cv, cdv, cc = _dec_col(take)
        children.append(HostNested(ct, cd, cv, cdv, cc))
    # structural validation: a corrupt nested frame must fail loudly,
    # not decode into clamped gathers / silently-truncated slices
    if t.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP):
        want = int(data.astype(np.int64).sum()) if n_rows else 0
        for c in children:
            if c.data.shape[0] != want:
                raise ValueError(
                    "nested child length does not match sum of parent"
                    " lengths"
                )
    elif t.kind == T.TypeKind.ROW:
        for c in children:
            if c.data.shape[0] != n_rows:
                raise ValueError(
                    "row child length does not match parent row count"
                )
    return t, data, valid, dvals, children


def _encode_body(page: Page) -> bytes:
    out = bytearray()
    out += _U32.pack(_MAGIC)
    out += _U32.pack(page.row_count)
    out += _U16.pack(page.width)
    for t, col, valid, dvals in zip(
        page.types, page.columns, page.valids, page.dictionaries
    ):
        if isinstance(col, HostNested):
            _enc_col(out, col.type, col.data, col.valid, col.dictionary,
                     col.children)
        else:
            _enc_col(out, t, col, valid, dvals, [])
    return bytes(out)


def _decode_body(body) -> Page:
    mv = memoryview(body)
    off = 0

    def take(n):
        nonlocal off
        piece = mv[off : off + n]
        off += n
        return piece

    (magic,) = _U32.unpack(take(4))
    if magic != _MAGIC:
        raise ValueError("bad page magic")
    (rows,) = _U32.unpack(take(4))
    (width,) = _U16.unpack(take(2))
    types: List[T.DataType] = []
    cols: List = []
    valids: List[Optional[np.ndarray]] = []
    dicts: List[Optional[Tuple[str, ...]]] = []
    for _ in range(width):
        t, data, valid, dvals, children = _dec_col(take)
        if t.is_nested:
            if data.shape[0] != rows:
                raise ValueError("column length does not match row count")
            cols.append(HostNested(t, data, valid, dvals, children))
            valids.append(None)
            dicts.append(None)
        else:
            if data.shape[0] != rows:
                raise ValueError("column length does not match row count")
            cols.append(data)
            valids.append(valid)
            dicts.append(dvals)
        types.append(t)
    return Page(types, cols, valids, dicts, rows)


def serialize_page(page: Page, compress: Optional[bool] = None) -> bytes:
    body = _encode_body(page)
    if compress is None:
        compress = len(body) >= COMPRESS_MIN_BYTES
    if compress:
        packed = zlib.compress(body, 1)
        return _HEADER.pack(1, len(body)) + packed
    return _HEADER.pack(0, len(body)) + body


def deserialize_page(data: bytes) -> Page:
    codec, raw_len = _HEADER.unpack_from(data, 0)
    body = data[_HEADER.size :]
    if codec == 1:
        body = zlib.decompress(body)
        if len(body) != raw_len:
            raise ValueError("corrupt page frame")
    return _decode_body(body)


def serialize_batch(batch: RelBatch, compress: Optional[bool] = None) -> bytes:
    return serialize_page(Page.from_batch(batch), compress)


def deserialize_batch(data: bytes, device) -> RelBatch:
    return deserialize_page(data).to_batch(device=device)


def concat_pages(pages: Sequence[Page]) -> Page:
    """Merge wire pages into one (consumer-side consolidation). String
    columns are re-encoded onto a unified dictionary."""
    pages = [p for p in pages if p.row_count > 0] or list(pages[:1])
    if len(pages) == 1:
        return pages[0]
    width = pages[0].width
    types = pages[0].types
    cols, valids, dicts = [], [], []
    for i in range(width):
        dvals = [p.dictionaries[i] for p in pages]
        if any(d is not None for d in dvals):
            merged = Dictionary([v for d in dvals if d is not None for v in d])
            parts = []
            for p, d in zip(pages, dvals):
                remap = np.asarray(
                    [merged.code(v) for v in (d or ())], dtype=np.int32
                )
                c = p.columns[i]
                parts.append(remap[c] if len(remap) else c)
            cols.append(np.concatenate(parts))
            dicts.append(merged.values)
        else:
            cols.append(np.concatenate([p.columns[i] for p in pages]))
            dicts.append(None)
        if any(p.valids[i] is not None for p in pages):
            valids.append(
                np.concatenate(
                    [
                        p.valids[i]
                        if p.valids[i] is not None
                        else np.ones(p.row_count, dtype=bool)
                        for p in pages
                    ]
                )
            )
        else:
            valids.append(None)
    return Page(types, cols, valids, dicts, sum(p.row_count for p in pages))

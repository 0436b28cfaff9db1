"""Pure-python raw Snappy codec (the parquet SNAPPY page codec).

The format (google/snappy format_description.txt — a public spec, like
the XXH64/murmur3 implementations in expr/pyfns.py): a varint
uncompressed length, then tagged elements — literals (tag 00) and
back-references (tags 01/10/11 with 1/2/4-byte offsets). The
compressor is the standard greedy 4-byte-hash matcher; output is valid
Snappy any decoder accepts. Pages are small (row-group column chunks),
so pure python keeps the no-external-deps property of the parquet
codec without a native build."""

from __future__ import annotations


def _uvarint(data: bytes, pos: int):
    x = shift = 0
    while True:
        b = data[pos]
        pos += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, pos
        shift += 7


def _put_uvarint(x: int) -> bytes:
    out = bytearray()
    while x >= 0x80:
        out.append((x & 0x7F) | 0x80)
        x >>= 7
    out.append(x)
    return bytes(out)


def decompress(data: bytes) -> bytes:
    n, pos = _uvarint(data, 0)
    out = bytearray()
    ln = len(data)
    while pos < ln:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(
                    data[pos:pos + extra], "little"
                )
                pos += extra
            length += 1
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0:
            raise ValueError("snappy: zero copy offset")
        start = len(out) - offset
        if start < 0:
            raise ValueError("snappy: offset before stream start")
        if offset >= length:
            # non-overlapping: one slice copy
            out += out[start:start + length]
        else:
            # overlapping run: double a seed slice (byte-replication
            # semantics) instead of a per-byte python loop
            seed = bytes(out[start:])
            while len(seed) < length:
                seed = seed + seed
            out += seed[:length]
    if len(out) != n:
        raise ValueError(
            f"snappy: length mismatch ({len(out)} != {n})"
        )
    return bytes(out)


def _emit_literal(out: bytearray, data: bytes, start: int, end: int):
    length = end - start
    if length <= 0:
        return
    length -= 1
    if length < 60:
        out.append(length << 2)
    else:
        nbytes = (length.bit_length() + 7) // 8
        out.append(((59 + nbytes) << 2))
        out += length.to_bytes(nbytes, "little")
    out += data[start:end]


def _emit_copy(out: bytearray, offset: int, length: int):
    while length > 0:
        cur = min(length, 64)
        if cur < 4:
            # tags encode >= 4 (1-byte) or 1..64 (2-byte); short tails
            # use the 2-byte form
            out.append(((cur - 1) << 2) | 2)
            out += offset.to_bytes(2, "little")
        elif cur <= 11 and offset < 2048:
            out.append(
                ((offset >> 8) << 5) | ((cur - 4) << 2) | 1
            )
            out.append(offset & 0xFF)
        else:
            out.append(((cur - 1) << 2) | 2)
            out += offset.to_bytes(2, "little")
        length -= cur


def compress(data: bytes) -> bytes:
    n = len(data)
    out = bytearray(_put_uvarint(n))
    if n < 4:
        _emit_literal(out, data, 0, n)
        return bytes(out)
    table: dict = {}
    pos = 0
    lit_start = 0
    limit = n - 4
    while pos <= limit:
        key = data[pos:pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand <= 0xFFFF:
            # extend the match
            length = 4
            while (
                pos + length < n
                and data[cand + length] == data[pos + length]
                and length < 1 << 16
            ):
                length += 1
            _emit_literal(out, data, lit_start, pos)
            _emit_copy(out, pos - cand, length)
            pos += length
            lit_start = pos
        else:
            pos += 1
    _emit_literal(out, data, lit_start, n)
    return bytes(out)

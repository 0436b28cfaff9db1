"""Row hashing kernels.

Counterpart of trino_tpu/ops/hashing.py: a murmur3-style 32-bit
finalizer over 32-bit lanes, columns combined with a boost-style mix,
and a 64-bit variant built from two independently seeded streams. The
outputs are bit-equal to the reference (the group-by sort order and
connector bucketing depend on it).

Unsigned 32-bit values ride in int64 tensors holding [0, 2^32): torch
has no uint32 shifts, minimum or compares on the CPU, so every step
masks back to 32 bits. int64 multiplication wraps mod 2^64, which keeps
the low 32 bits of each product exact.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_NULL_LANE = 0xA5A5A5A5
_GOLDEN = 0x9E3779B9


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on [0, 2^32) values in int64."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x


def _to_lanes(data: torch.Tensor) -> tuple:
    """A column as one to four 32-bit lanes (int64 carriers), in the
    reference's lane order."""
    dt = data.dtype
    if data.dim() == 2:
        # long-decimal limb pairs: lo-limb lanes, then hi-limb lanes
        return (*_to_lanes(data[:, 1]), *_to_lanes(data[:, 0]))
    if dt.is_floating_point:
        data = torch.where(data == 0, torch.zeros_like(data), data)
    if dt == torch.float64:
        from trino_tpu_torch.ops.floatbits import f64_lanes

        return f64_lanes(data)
    if dt == torch.int64:
        return data & _M32, (data >> 32) & _M32
    if dt == torch.float32:
        return (data.contiguous().view(torch.int32).to(torch.int64) & _M32,)
    if dt == torch.bool:
        return (data.to(torch.int64),)
    return (data.to(torch.int32).to(torch.int64) & _M32,)


def hash32(
    columns: Sequence[torch.Tensor],
    valids: Optional[Sequence[Optional[torch.Tensor]]] = None,
    seed: int = 0,
) -> torch.Tensor:
    """Combined 32-bit hash over key columns (int64 tensor holding
    [0, 2^32)); NULL hashes distinctly."""
    first = columns[0]
    h = torch.full(
        first.shape[:1], (_GOLDEN + seed) & _M32, dtype=torch.int64,
        device=first.device,
    )
    for i, col in enumerate(columns):
        for lane in _to_lanes(col):
            v = lane
            if valids is not None and valids[i] is not None:
                v = torch.where(valids[i], v, torch.full_like(v, _NULL_LANE))
            mix = (
                _fmix32(v + (i + 1)) + _GOLDEN + ((h << 6) & _M32) + (h >> 2)
            ) & _M32
            h = h ^ mix
    return _fmix32(h)


def hash64(
    columns: Sequence[torch.Tensor],
    valids: Optional[Sequence[Optional[torch.Tensor]]] = None,
    seed: int = 0,
) -> torch.Tensor:
    """62-bit hash from two independently seeded 32-bit streams (the
    headroom above 2^62 leaves room for sort sentinels)."""
    lo = hash32(columns, valids, seed=seed)
    hi = hash32(columns, valids, seed=0x243F6A88 + seed)
    return ((hi & 0x3FFFFFFF) << 32) | lo


def _fmix32_np(x):
    """Host-side replica of `_fmix32` (numpy uint32, bit-for-bit)."""
    x = x.astype(np.uint32)
    x = x ^ (x >> 16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x = x ^ (x >> 13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x = x ^ (x >> 16)
    return x


def hash32_np(columns, valids=None, seed: int = 0):
    """Host-side replica of `hash32` for connector bucketing. Accepts
    int64 (integer-family keys) or uint32 (dictionary value hashes)
    lanes; bit-for-bit with `hash32`."""

    def lanes_of(col):
        if getattr(col, "ndim", 1) == 2:
            return (*lanes_of(col[:, 1]), *lanes_of(col[:, 0]))
        if col.dtype == np.uint32:
            return (col,)
        bits = col.astype(np.int64).view(np.uint64)
        lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (bits >> np.uint64(32)).astype(np.uint32)
        return lo, hi

    h = np.full(
        len(columns[0]), np.uint32((_GOLDEN + seed) & _M32), dtype=np.uint32
    )
    for i, col in enumerate(columns):
        for lane in lanes_of(np.asarray(col)):
            v = lane
            if valids is not None and valids[i] is not None:
                v = np.where(valids[i], v, np.uint32(_NULL_LANE))
            h = h ^ (
                (_fmix32_np((v + np.uint32(i + 1)).astype(np.uint32))
                 + np.uint32(_GOLDEN)
                 + (h << 6).astype(np.uint32)
                 + (h >> 2)).astype(np.uint32)
            )
    return _fmix32_np(h)


def partition_of(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Map a 32-bit hash (int64 carrier holding [0, 2^32)) to an int32
    partition id: a mask when the count is a power of two, else a
    modulo (bit-equal to `partition_of_np` and the reference's)."""
    if num_partitions & (num_partitions - 1) == 0:
        return (h & (num_partitions - 1)).to(torch.int32)
    return (h % num_partitions).to(torch.int32)


def partition_of_np(h, num_partitions: int):
    """Host-side map of a 32-bit hash (numpy uint32) to a partition id,
    as the reference's `partition_of` does on the device."""
    if num_partitions & (num_partitions - 1) == 0:
        return (h & np.uint32(num_partitions - 1)).astype(np.int32)
    return (h % np.uint32(num_partitions)).astype(np.int32)


def dictionary_code_hashes(values) -> np.ndarray:
    """Per-code value hash of a dictionary (crc32 of the string), so two
    columns with different dictionaries hash equal strings equally."""
    return np.asarray(
        [zlib.crc32(v.encode("utf-8")) for v in values], dtype=np.uint32
    )


def dictionary_lut(dictionary) -> Optional[np.ndarray]:
    """Code -> value hash table of a non-empty dictionary; None for an
    absent or empty one (an all-NULL column hashes its codes)."""
    if dictionary is None or len(dictionary) == 0:
        return None
    return dictionary_code_hashes(dictionary.values)


def canonical_hash_input(data: torch.Tensor, code_hashes: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """A column as the lane its SQL value hashes by: integer-like ->
    int64, floating -> float64, dictionary codes -> the per-value hash
    (`code_hashes` on the codes' device). Code hashes come back as int32
    carriers of their 32-bit pattern, so `hash32` reads one lane from
    them, as the reference reads its uint32 values."""
    if code_hashes is not None:
        idx = torch.clamp(data.to(torch.int64), 0, code_hashes.shape[0] - 1)
        return code_hashes[idx].to(torch.int32)
    if data.dtype.is_floating_point:
        return data.to(torch.float64)
    return data.to(torch.int64)

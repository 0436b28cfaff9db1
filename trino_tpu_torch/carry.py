"""Build the port's batches and join lookup sources from plain arrays.

Data plays the part weights play for a model: the two packages compute
on the same input when both receive the same numpy arrays. A test turns
a reference batch (or a reference join's LookupSource) into numpy arrays
and hands them here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import Column, Dictionary, RelBatch

# (type name, data, valid or None, dictionary values or None)
ColumnArrays = Tuple[str, np.ndarray, Optional[np.ndarray], Optional[Sequence[str]]]


def parse_type(name: str) -> T.DataType:
    """A flat SQL type from its printed name (str(DataType))."""
    name = name.strip().lower()
    if name.startswith("decimal("):
        p, s = name[len("decimal("):-1].split(",")
        return T.decimal(int(p), int(s))
    if name.startswith("varchar"):
        return T.VARCHAR
    if name.startswith("char("):
        return T.char(int(name[len("char("):-1]))
    for t in (T.BOOLEAN, T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT, T.REAL,
              T.DOUBLE, T.DATE, T.TIMESTAMP, T.INTERVAL_DAY, T.INTERVAL_YEAR):
        if name == str(t):
            return t
    raise ValueError(f"unsupported type name {name!r}")


def relbatch_from_arrays(columns: Sequence[ColumnArrays],
                         live: Optional[np.ndarray], device) -> RelBatch:
    """The port's RelBatch from plain arrays, on `device`."""
    cols = []
    for type_name, data, valid, dict_values in columns:
        t = parse_type(type_name)
        arr = np.array(data, dtype=t.np_dtype, order="C")  # a writable copy
        v = None if valid is None else torch.from_numpy(
            np.array(valid, dtype=bool, order="C")
        ).to(device)
        d = None if dict_values is None else Dictionary(dict_values)
        cols.append(Column(t, torch.from_numpy(arr).to(device), v, d))
    lv = None if live is None else torch.from_numpy(
        np.array(live, dtype=bool, order="C")
    ).to(device)
    return RelBatch(cols, lv)


def lookup_source_from_arrays(sorted_hash: np.ndarray, perm: np.ndarray,
                              key_cols: Sequence[np.ndarray],
                              key_valids: Sequence[np.ndarray],
                              build_live: np.ndarray, device):
    """The port's join LookupSource from plain arrays (the reference's
    uint32 sorted hashes widen into the port's int64 carriers)."""
    from trino_tpu_torch.ops.join import LookupSource

    def dev(x, dtype=None):
        return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(device)

    return LookupSource(
        dev(np.asarray(sorted_hash).astype(np.int64)),
        dev(perm, np.int32),
        [dev(k) for k in key_cols],
        [dev(v, bool) for v in key_valids],
        dev(build_live, bool),
    )

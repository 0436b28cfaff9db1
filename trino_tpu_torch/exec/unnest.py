"""UNNEST over ARRAY columns.

Counterpart of trino_tpu/exec/unnest.py (UnnestOperator.java). The
reference copies the lengths to the host and builds the (row, element)
indices there with np.repeat; here the expansion is built on the device
with the join's own machinery (ops/join.expand_runs): per row the zip
length (the longest of its arrays), its inclusive cumulative sum, the
owner row of every output slot from window_rank.run_owner, and the
element index from the owner's exclusive offset. Only the output total
crosses to the host, to size the output batch. The replicated columns
and the flat element gathers go through gather_kernels.take_flat where
the column is 1-D with 4- or 8-byte values; bool masks, narrow types and
limb pairs take index_select.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import ArrayColumn, Column, MapColumn, RelBatch, RowColumn
from trino_tpu_torch.exec.operators import Operator
from trino_tpu_torch.ops import gather_kernels as GK
from trino_tpu_torch.ops import join as J


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[clip(idx)] along dim 0: the flat-gather kernel where it applies."""
    if x.dim() == 1 and x.element_size() in (4, 8):
        return GK.take_flat(x, idx)
    pos = torch.clamp(idx.to(torch.int64), 0, x.shape[0] - 1)
    return x.index_select(0, pos)


def take_column(c: Column, idx: torch.Tensor, valid: Optional[torch.Tensor] = None) -> Column:
    """Rows `idx` (clipped) of a column, with `valid` ANDed into the
    validity; a nested column moves only its per-row views."""
    v = None if c.valid is None else _take(c.valid, idx)
    if valid is not None:
        v = valid if v is None else (v & valid)
    data = _take(c.data, idx)
    if isinstance(c, ArrayColumn):
        return ArrayColumn(c.type, data, v, c.dictionary, _take(c.starts, idx), c.flat)
    if isinstance(c, MapColumn):
        return MapColumn(c.type, data, v, c.dictionary, _take(c.starts, idx),
                         c.flat_keys, c.flat_values)
    if isinstance(c, RowColumn):
        return RowColumn(c.type, data, v, c.dictionary,
                         [take_column(k, idx, valid) for k in c.children])
    return Column(c.type, data, v, c.dictionary)


class UnnestOperator(Operator):
    """One batch in, one expanded batch out: the input columns repeated
    per element, then one element column per array (zipped to the
    longest array of the row, NULL-padded), then the 1-based ordinality
    when asked."""

    def __init__(self, array_channels, ordinality: bool, input_schema):
        self._channels = list(array_channels)
        self._ordinality = ordinality
        self._schema = input_schema
        self._out: Optional[RelBatch] = None

    def needs_input(self) -> bool:
        return self._out is None and not self._finishing

    def is_finished(self) -> bool:
        return self._finishing and self._out is None

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    def add_input(self, batch: RelBatch) -> None:
        arrays: List[ArrayColumn] = []
        for ch in self._channels:
            col = batch.columns[ch]
            if not isinstance(col, ArrayColumn):
                raise TypeError("UNNEST argument is not an ARRAY column")
            arrays.append(col)
        lengths = []
        for col in arrays:
            ln = col.data.to(torch.int32)
            if col.valid is not None:
                ln = torch.where(col.valid, ln, torch.zeros_like(ln))
            lengths.append(ln)
        # zip semantics: a row expands to the longest of its arrays
        per_row = lengths[0]
        for ln in lengths[1:]:
            per_row = torch.maximum(per_row, ln)
        per_row = torch.where(batch.live_mask(), per_row, torch.zeros_like(per_row))
        owner, elem, live, _ = J.expand_runs(per_row)
        out_cols = [take_column(c, owner) for c in batch.columns]
        for col, ln in zip(arrays, lengths):
            # zip padding: positions past this array's own length are NULL
            in_range = elem < _take(ln, owner)
            pos = _take(col.starts, owner) + elem
            out_cols.append(take_column(col.flat, pos, in_range))
        if self._ordinality:
            out_cols.append(Column(T.BIGINT, (elem + 1).to(torch.int64), None, None))
        self._out = RelBatch(out_cols, live)

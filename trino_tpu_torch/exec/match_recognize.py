"""MATCH_RECOGNIZE.

Counterpart of trino_tpu/exec/match_recognize.py (PatternRecognitionOperator
and Matcher.java's automaton over IrRowPattern). The work splits as in the
reference:

- On the device: the live rows are consolidated and ordered within their
  partitions (stable argsort passes, least significant key first, as
  np.lexsort orders), PREV/NEXT become shifted row gathers with a
  same-partition mask, and every DEFINE predicate runs through the
  expression binder over that extended batch. The masks cross to the
  host once, stacked, with the partition starts.
- On the host: the pattern automaton walks the per-variable bitmaps
  (greedy, leftmost-longest, with backtracking under a step budget; an
  empty match still makes a row). It records, per output row, the source
  row of each measure; the output columns are then gathered on the device.

The order is the reference's: the raw data of the ORDER BY keys (a NULL
sorts by its filler value; descending negates). Partition keys differ in
one place: the reference compares raw data, so a NULL key whose filler
equals a real key's value joins that key's partition; here a NULL key is
a partition of its own (ROADMAP §3). CLASSIFIER()'s dictionary, the
pattern's variables, is known at plan time (the reference plans none, so
a string comparison above it reads other codes; ROADMAP §3).

Supported subset (sql/analyzer.py): concatenation, alternation, *, +, ?,
{n,m}; ONE ROW PER MATCH; AFTER MATCH SKIP PAST LAST ROW / TO NEXT ROW;
measures FIRST/LAST(var.col), var.col, MATCH_NUMBER(), CLASSIFIER().
An operator's `stats` hold its run's host-clock split: device work (up
to the masks reaching the host), the automaton, the output gathers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from trino_tpu_torch.block import Column, Dictionary, RelBatch, bucket_capacity, concat_batches
from trino_tpu_torch.exec.operators import Operator, batch_inputs, empty_batch
from trino_tpu_torch.ops.sort import stable_argsort

_STEP_CAP = 10_000_000  # backtracking budget (pathological patterns)


class _Budget:
    __slots__ = ("left",)

    def __init__(self, n: int):
        self.left = n


def _match_here(node, masks: Dict[str, np.ndarray], pos: int, end: int,
                tags: List[str], budget: _Budget):
    """Generator of match end positions for `node` starting at `pos`
    (exclusive bound `end`), longest first (greedy). Appends the
    variable of each consumed row to `tags` and pops it on backtrack."""
    budget.left -= 1
    if budget.left <= 0:
        raise RuntimeError("MATCH_RECOGNIZE backtracking budget exceeded")
    kind = node[0]
    if kind == "var":
        name = node[1]
        if pos < end and masks[name][pos]:
            tags.append(name)
            yield pos + 1
            tags.pop()
        return
    if kind == "seq":
        parts = node[1]

        def seq_from(i: int, p: int):
            if i == len(parts):
                yield p
                return
            for q in _match_here(parts[i], masks, p, end, tags, budget):
                yield from seq_from(i + 1, q)

        yield from seq_from(0, pos)
        return
    if kind == "alt":
        for part in node[1]:
            yield from _match_here(part, masks, pos, end, tags, budget)
        return
    if kind == "opt":
        yield from _match_here(node[1], masks, pos, end, tags, budget)
        yield pos  # greedy: consume first, then empty
        return
    if kind in ("star", "plus"):
        inner = node[1]

        def repeat_from(p: int, count: int):
            # greedy: extend first (longest), then accept
            for q in _match_here(inner, masks, p, end, tags, budget):
                if q > p:  # no zero-width loop
                    yield from repeat_from(q, count + 1)
            if kind == "star" or count >= 1:
                yield p

        yield from repeat_from(pos, 0)
        return
    if kind == "rep":
        inner, lo, hi = node[1], node[2], node[3]

        def rep_from(p: int, count: int):
            if hi is not None and count == hi:
                yield p
                return
            for q in _match_here(inner, masks, p, end, tags, budget):
                if q > p:
                    yield from rep_from(q, count + 1)
            if count >= lo:
                yield p

        yield from rep_from(pos, 0)
        return
    raise ValueError(f"unknown pattern node {kind!r}")


def find_matches(pattern, masks: Dict[str, np.ndarray], start: int, end: int,
                 after_match: str) -> list:
    """Every match in [start, end) as (lo, hi, tags): greedy
    leftmost-longest per start position; AFTER MATCH SKIP sets where the
    next search starts."""
    out = []
    pos = start
    while pos < end:
        budget = _Budget(_STEP_CAP)
        tags: List[str] = []
        got = None
        for endpos in _match_here(pattern, masks, pos, end, tags, budget):
            # the generator's first yield is the match; an empty match
            # (endpos == pos) still makes a row (NULL measures, no tags)
            got = (pos, endpos, list(tags[: endpos - pos]))
            break
        if got is None:
            pos += 1
            continue
        out.append(got)
        if after_match == "next_row":
            pos = got[0] + 1
        else:  # past_last; an empty match must still advance
            pos = max(got[1], got[0] + 1)
    return out


class MatchRecognizeOperator(Operator):
    """Consolidate, order and evaluate the DEFINEs on the device; run the
    automaton on the host; gather one output batch on the device."""

    def __init__(self, spec, input_schema, define_fns, device):
        """spec: plan.MatchRecognizeNode; define_fns: [(var, fn)] where
        fn(cols, valids) over the extended columns -> (bool data, valid)."""
        self._spec = dataclasses.replace(spec, pattern=_normalize_pattern(spec.pattern))
        self._schema = list(input_schema)
        self._define_fns = define_fns
        self._device = device
        self._inputs: List[RelBatch] = []
        self._out: Optional[RelBatch] = None
        self.stats: dict = {}

    def add_input(self, batch: RelBatch) -> None:
        self._inputs.append(batch)

    def finish(self) -> None:
        if self._finishing:
            return
        self._finishing = True
        self._out = self._run()
        self._inputs = []

    def is_finished(self) -> bool:
        return self._finishing and self._out is None

    def get_output(self) -> Optional[RelBatch]:
        out, self._out = self._out, None
        return out

    # -- the work --
    def _ordered(self):
        """The live rows, front-packed and ordered within partitions, and
        each row's partition id (or None when there are no rows)."""
        spec = self._spec
        merged = concat_batches(self._inputs) if self._inputs else None
        if merged is None or merged.capacity == 0:
            return None, None
        rows = torch.nonzero(merged.live_mask()).reshape(-1)
        n = int(rows.shape[0])
        if n == 0:
            return None, None
        cols = [c.gather(rows) for c in merged.columns]
        # np.lexsort's key list: least significant first, each pass stable
        keys = []
        for k in reversed(spec.order_keys):
            d = cols[k.channel].data
            keys.append(-d if k.descending else d)
        part_keys = []
        for ch in spec.partition_channels:
            c = cols[ch]
            ok = c.valid_mask()
            d = torch.where(ok.reshape((-1,) + (1,) * (c.data.dim() - 1)), c.data,
                            torch.zeros((), dtype=c.data.dtype, device=c.data.device))
            part_keys.append((d, ok))
        for d, ok in reversed(part_keys):
            keys.append(ok)
            keys.append(d)
        order = torch.arange(n, device=rows.device)
        for key in keys:
            order = order[stable_argsort(key[order])]
        cols = [c.gather(order) for c in cols]
        change = torch.zeros(n, dtype=torch.bool, device=rows.device)
        for d, ok in part_keys:
            d, ok = d[order], ok[order]
            diff = d[1:] != d[:-1]
            if diff.dim() > 1:  # long-decimal limb pairs
                diff = diff.any(dim=1)
            change[1:] |= diff | (ok[1:] != ok[:-1])
        return cols, torch.cumsum(change.to(torch.int64), 0)

    def _extended(self, cols, part_id) -> list:
        """The columns plus one shifted copy per PREV/NEXT offset: row i
        reads row i - off of the same partition, else NULL."""
        n = part_id.shape[0]
        idx = torch.arange(n, device=part_id.device)
        out = list(cols)
        for ch, off in self._spec.shifts:
            src = torch.remainder(idx - off, n)
            same = (part_id[src] == part_id) & (idx - off >= 0) & (idx - off < n)
            out.append(cols[ch].gather(src, same))
        return out

    def _run(self) -> RelBatch:
        spec = self._spec
        t0 = time.perf_counter()
        cols, part_id = self._ordered()
        if cols is None:
            self.stats = dict(rows=0, matches=0, device_s=0.0, automaton_s=0.0, output_s=0.0)
            return empty_batch([(f.type, None) for f in spec.fields], self._device)
        n = int(part_id.shape[0])
        ext = RelBatch(self._extended(cols, part_id))
        ext_cols, ext_vs = batch_inputs(ext), [c.valid for c in ext.columns]
        stacked = []
        for _, fn in self._define_fns:
            mdata, mvalid = fn(ext_cols, ext_vs)
            m = mdata.to(torch.bool).expand(n)
            stacked.append(m if mvalid is None else (m & mvalid))
        starts_dev = torch.nonzero(part_id[1:] != part_id[:-1]).reshape(-1) + 1
        host = torch.stack(stacked).cpu().numpy() if stacked else np.zeros((0, n), bool)
        bounds = [0] + starts_dev.cpu().tolist() + [n]
        masks = {var: host[i] for i, (var, _) in enumerate(self._define_fns)}
        # a pattern variable with no DEFINE matches every row
        for var in _pattern_vars(spec.pattern):
            if var not in masks:
                masks[var] = np.ones(n, dtype=bool)
        t1 = time.perf_counter()
        cl_dict = classifier_dictionary(spec.pattern)
        # per output row: the source row of each partition key and
        # first/last measure (-1 = NULL), or the value of the others
        fields: List[list] = [[] for _ in spec.fields]
        n_part = len(spec.partition_channels)
        for b in range(len(bounds) - 1):
            match_no = 0  # MATCH_NUMBER() counts within the partition
            for mlo, mhi, tags in find_matches(spec.pattern, masks, bounds[b],
                                               bounds[b + 1], spec.after_match):
                match_no += 1
                for i in range(n_part):
                    fields[i].append(mlo)
                for j, m in enumerate(spec.measures):
                    fields[n_part + j].append(_measure(m, mlo, mhi, tags, match_no, cl_dict))
        t2 = time.perf_counter()
        out = self._build_output(cols, fields, cl_dict)
        self.stats = dict(rows=n, matches=len(fields[0]) if fields else 0,
                          device_s=t1 - t0, automaton_s=t2 - t1,
                          output_s=time.perf_counter() - t2)
        return out

    def _build_output(self, cols, fields, cl_dict) -> RelBatch:
        spec = self._spec
        n_out = len(fields[0]) if fields else 0
        cap = bucket_capacity(max(n_out, 1))
        dev = cols[0].data.device
        live = torch.arange(cap, device=dev) < n_out
        n_part = len(spec.partition_channels)
        channels = list(spec.partition_channels) + [m.channel for m in spec.measures]
        kinds = ["row"] * n_part + [
            "row" if m.kind in ("first", "last") else m.kind for m in spec.measures]
        out_cols = []
        for f, ch, kind, vals in zip(spec.fields, channels, kinds, fields):
            arr = np.zeros(cap, dtype=np.int64)
            arr[:n_out] = vals
            if kind == "row":
                pos = torch.from_numpy(arr).to(dev)
                g = cols[ch].gather(pos, (pos >= 0) & live)
                out_cols.append(g if f.type.is_nested else
                                Column(f.type, g.data, g.valid, g.dictionary))
                continue
            valid = torch.from_numpy(arr >= 0).to(dev) & live
            data = torch.from_numpy(np.maximum(arr, 0)).to(dev).to(f.type.dtype)
            dictionary = cl_dict if kind == "classifier" else None
            out_cols.append(Column(f.type, data, valid, dictionary))
        return RelBatch(out_cols, live)


def _measure(m, mlo: int, mhi: int, tags: List[str], match_no: int,
             cl_dict: Dictionary) -> int:
    """One measure of a match: a source row for first/last (-1 when the
    variable matched no row), the number for MATCH_NUMBER(), the code of
    the last row's variable for CLASSIFIER() (-1, NULL, for an empty
    match)."""
    if m.kind == "match_number":
        return match_no
    if m.kind == "classifier":
        return cl_dict.code(tags[-1]) if tags else -1
    if m.var is None:
        positions = range(mlo, mhi)
    else:
        positions = [mlo + i for i, t in enumerate(tags) if t == m.var]
    if not positions:
        return -1
    return positions[0] if m.kind == "first" else positions[-1]


def classifier_dictionary(pattern) -> Dictionary:
    """CLASSIFIER()'s values: the pattern's variables, lowercased."""
    return Dictionary(sorted(_pattern_vars(pattern)))


def _pattern_vars(node) -> set:
    kind = node[0]
    if kind == "var":
        return {node[1].lower()}
    if kind in ("seq", "alt"):
        out = set()
        for p in node[1]:
            out |= _pattern_vars(p)
        return out
    return _pattern_vars(node[1])


def _normalize_pattern(node):
    """Lowercase the variable names, as the analyzer lowercases the
    DEFINE keys (quoted mixed-case variables included)."""
    kind = node[0]
    if kind == "var":
        return ("var", node[1].lower())
    if kind in ("seq", "alt"):
        return (kind, [_normalize_pattern(p) for p in node[1]])
    if kind == "rep":
        return ("rep", _normalize_pattern(node[1]), node[2], node[3])
    return (kind, _normalize_pattern(node[1]))

"""Device-resident point-lookup tables with delta maintenance.

Counterpart of trino_tpu/resident/table.py. A `ResidentTable` pins the
PROBE side of a point lookup on the device: the key column as an int64
tensor padded to a capacity-ladder rung, plus a live mask. A probe is a
shape-stable program (mask, then the first PROBE_OUT_CAP match
positions at a fixed size), so a warm lookup moves no table bytes and
rebuilds nothing; its one device->host read is the match positions with
the match count, base and delta together. Result VALUES stay on the
host (result rows materialize there anyway), indexed by the match
positions. String keys encode through a host dictionary.

Writes ride an append-only delta at a low rung
(`resident_delta_max_rows`); a probe checks base and delta (the same
program at two rungs), and a compaction folds the delta into the base
at a ladder rung, so probe shapes stay on rungs already seen.

The reference's two programs are jitted XLA, and they become torch ops
here (ROADMAP's North star: a kernel only where a measurement asks for
one). torch has no `nonzero(size=, fill_value=)`: `_first_positions`
builds the fixed-size index from a cumulative sum and a scatter into a
tensor padded with the fill, so the result keeps its rung's shape. Both
programs are cached in PROGRAM_CACHE by capacity pair and device, shared
across tables, and register WarmupEntrys.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import bucket_capacity
from trino_tpu_torch.compile.cache import PROGRAM_CACHE
from trino_tpu_torch.compile.warmup import WarmupEntry, note_classes_warm
from trino_tpu_torch.analysis.witness import named_lock, named_rlock

# matches a probe returns before the fast lane declines (a key with more
# than 16 rows is not a point lookup worth pinning)
PROBE_OUT_CAP = 16

# WarmupEntry registry of the resident programs: bounded, observable
RESIDENT_WARMUP_ENTRIES: List[WarmupEntry] = []
_MAX_WARMUP_ENTRIES = 64
_warm_lock = named_lock("table._warm_lock")


def register_resident_warmup(entries: Sequence[WarmupEntry]) -> None:
    with _warm_lock:
        known = {(e.operator, e.capacities, e.out_dtypes, str(e.device))
                 for e in RESIDENT_WARMUP_ENTRIES}
        RESIDENT_WARMUP_ENTRIES.extend(
            e for e in entries
            if (e.operator, e.capacities, e.out_dtypes, str(e.device)) not in known
        )
        del RESIDENT_WARMUP_ENTRIES[:-_MAX_WARMUP_ENTRIES]


def resident_warmup_entries() -> List[WarmupEntry]:
    with _warm_lock:
        return list(RESIDENT_WARMUP_ENTRIES)


# -- programs (shared across tables, keyed by capacity class) ----------


def _first_positions(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=size, fill_value=fill)[0]: the positions
    of the first `size` True entries, ascending, padded with `fill`.
    Each True entry's rank is its inclusive cumulative count less one;
    the ranks below `size` scatter their positions, every other entry
    lands in a trash slot that is cut off."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]


def _probe_program(cap: int, out_cap: int, device):
    def build():
        def probe(keys: torch.Tensor, valid: torch.Tensor, q: int):
            match = valid & (keys == q)
            return _first_positions(match, out_cap, cap), torch.sum(match)

        return probe

    return PROGRAM_CACHE.get_or_create(("resident-probe", cap, out_cap, str(device)), build)


def _compact_program(base_cap: int, delta_cap: int, out_cap: int, device):
    """Densify-concat merge: the live base keys, then the live delta
    keys, in order, padded to `out_cap` (a rung sized to the live
    total)."""

    def build():
        def compact(bk, bv, dk, dv):
            keys = torch.cat([bk, dk])
            valid = torch.cat([bv, dv])
            total = keys.shape[0]
            idx = _first_positions(valid, out_cap, total)
            guarded = torch.cat([keys, torch.zeros(1, dtype=keys.dtype, device=keys.device)])
            new_keys = guarded[idx]
            new_valid = torch.arange(out_cap, device=keys.device) < torch.sum(valid)
            return new_keys, new_valid

        return compact

    return PROGRAM_CACHE.get_or_create(
        ("resident-compact", base_cap, delta_cap, out_cap, str(device)), build)


class _ProbeWarmer:
    """WarmupEntry.fn: ignores the dead batch it is handed and runs the
    probe at its recorded shapes on zeros."""

    def __init__(self, cap: int, out_cap: int, device):
        self.cap, self.out_cap, self.device = cap, out_cap, device

    def __call__(self, _batch) -> None:
        fn = _probe_program(self.cap, self.out_cap, self.device)
        fn(torch.zeros(self.cap, dtype=torch.int64, device=self.device),
           torch.zeros(self.cap, dtype=torch.bool, device=self.device), 0)


class _CompactWarmer:
    def __init__(self, base_cap: int, delta_cap: int, out_cap: int, device):
        self.base_cap, self.delta_cap, self.out_cap = base_cap, delta_cap, out_cap
        self.device = device

    def __call__(self, _batch) -> None:
        fn = _compact_program(self.base_cap, self.delta_cap, self.out_cap, self.device)
        z = lambda n, dt: torch.zeros(n, dtype=dt, device=self.device)  # noqa: E731
        fn(z(self.base_cap, torch.int64), z(self.base_cap, torch.bool),
           z(self.delta_cap, torch.int64), z(self.delta_cap, torch.bool))


def _probe_entry(cap: int, device) -> WarmupEntry:
    return WarmupEntry(
        operator="ResidentProbe", fn=_ProbeWarmer(cap, PROBE_OUT_CAP, device),
        in_schema=[(T.BIGINT, None)], out_dtypes=("int64",), capacities=(cap,),
        device=device,
    )


def _compact_entry(base_cap: int, delta_cap: int, out_cap: int, device) -> WarmupEntry:
    return WarmupEntry(
        operator="ResidentCompact",
        fn=_CompactWarmer(base_cap, delta_cap, out_cap, device),
        in_schema=[(T.BIGINT, None)], out_dtypes=(f"d{delta_cap}", f"o{out_cap}"),
        capacities=(base_cap,), device=device,
    )


# -- the table ---------------------------------------------------------


class ResidentTable:
    """One pinned point-lookup table: key column and live mask on the
    device, value rows on the host, plus an append-only delta at a low
    rung."""

    def __init__(self, key_col: str, names: List[str], types: List,
                 key_values: List, value_rows: List[list],
                 string_key: bool, delta_max_rows: int = 4096, device="cpu"):
        self.key_col = key_col
        self.names = list(names)
        self.types = list(types)
        self.string_key = bool(string_key)
        self.delta_max_rows = max(1, int(delta_max_rows))
        self.device = torch.device(device)
        # string keys encode through a host map; int keys are their own code
        self._code_of = {} if string_key else None
        codes, live = self._codes(key_values)
        self.base_cap = bucket_capacity(max(16, len(codes)))
        self.base_keys, self.base_valid = self._pinned(codes, live, self.base_cap)
        self.base_rows: List[list] = [list(r) for r in value_rows]
        self._base_mask: List[bool] = live
        self.delta_cap = bucket_capacity(max(16, self.delta_max_rows))
        self._delta_codes: List[int] = []
        self._delta_mask: List[bool] = []
        self.delta_rows: List[list] = []
        self._delta_keys: Optional[torch.Tensor] = None
        self._delta_valid: Optional[torch.Tensor] = None
        self._lock = named_rlock("ResidentTable._lock")
        register_resident_warmup(
            [_probe_entry(self.base_cap, self.device), _probe_entry(self.delta_cap, self.device)])
        # the build already paid a full scan: two dead probes here keep
        # the first warm lookup off any cold path
        _ProbeWarmer(self.base_cap, PROBE_OUT_CAP, self.device)(None)
        _ProbeWarmer(self.delta_cap, PROBE_OUT_CAP, self.device)(None)
        note_classes_warm([
            ("ResidentProbe", self.base_cap, ("int64",)),
            ("ResidentProbe", self.delta_cap, ("int64",)),
        ])

    # -- keys ----------------------------------------------------------
    def _codes(self, key_values: List) -> Tuple[List[int], List[bool]]:
        """Each key's code and whether it is live. A NULL key never
        equals a literal, so its row stays on the host but its slot is
        masked dead (code 0) and no probe returns it."""
        live = [k is not None for k in key_values]
        return [self._encode(k) if ok else 0 for k, ok in zip(key_values, live)], live

    def _pinned(self, codes: List[int], live: List[bool],
                cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The key tensor and live mask at rung `cap`, on the device."""
        pad = (0, cap - len(codes))
        keys = np.pad(np.asarray(codes, dtype=np.int64), pad)
        valid = np.pad(np.asarray(live, dtype=bool), pad)
        return torch.from_numpy(keys).to(self.device), torch.from_numpy(valid).to(self.device)

    def _encode(self, key, create: bool = True) -> Optional[int]:
        if self._code_of is None:
            return int(key)
        code = self._code_of.get(key)
        if code is None and create:
            code = len(self._code_of)
            self._code_of[key] = code
        return code

    @property
    def base_live(self) -> int:
        """Base rows whose key is live (not NULL)."""
        return sum(self._base_mask)

    @property
    def dtype_sig(self) -> Tuple[str, ...]:
        return ("str" if self.string_key else "int64",) + tuple(str(t) for t in self.types)

    @property
    def device_bytes(self) -> int:
        total = _nbytes(self.base_keys) + _nbytes(self.base_valid)
        if self._delta_keys is not None:
            total += _nbytes(self._delta_keys) + _nbytes(self._delta_valid)
        return int(total)

    # -- probe ---------------------------------------------------------
    def probe(self, key) -> Optional[List[list]]:
        """Every value row matching `key`, base order then delta order
        (append order: the oracle's scan order). None when the key's
        fanout passes PROBE_OUT_CAP (the caller declines)."""
        with self._lock:
            code = self._encode(key, create=False)
            if code is None:
                return []  # a string key never seen: provably no rows
            parts = [(self.base_keys, self.base_valid, self.base_cap, self.base_rows)]
            if self._delta_keys is not None:
                parts.append((self._delta_keys, self._delta_valid, self.delta_cap,
                               self.delta_rows))
            outs = []
            for keys, valid, cap, _ in parts:
                idx, n = _probe_program(cap, PROBE_OUT_CAP, self.device)(keys, valid, code)
                outs += [idx, n.view(1)]
            # the lookup's one device->host read: positions and counts
            host = torch.cat(outs).cpu().numpy()
            out: List[list] = []
            for i, (_, _, cap, rows) in enumerate(parts):
                seg = host[i * (PROBE_OUT_CAP + 1):(i + 1) * (PROBE_OUT_CAP + 1)]
                if int(seg[-1]) > PROBE_OUT_CAP:
                    return None
                for p in seg[:-1]:
                    if int(p) < cap and int(p) < len(rows):
                        out.append(list(rows[int(p)]))
            return out

    # -- delta maintenance --------------------------------------------
    def delta_room(self, n_rows: int) -> bool:
        with self._lock:
            return len(self.delta_rows) + n_rows <= self.delta_max_rows

    def append_delta(self, key_values: List, value_rows: List[list]) -> bool:
        """Append inserted rows to the delta side. False when out of
        delta room (the caller evicts; the next lookup rebuilds)."""
        with self._lock:
            if len(self.delta_rows) + len(key_values) > self.delta_max_rows:
                return False
            codes, live = self._codes(key_values)
            # the device tensors first: a failure leaves the table as it was
            keys, valid = self._pinned(self._delta_codes + codes, self._delta_mask + live,
                                       self.delta_cap)
            self._delta_codes.extend(codes)
            self._delta_mask.extend(live)
            self.delta_rows.extend(list(r) for r in value_rows)
            self._delta_keys, self._delta_valid = keys, valid
            return True

    @property
    def delta_count(self) -> int:
        with self._lock:
            return len(self.delta_rows)

    def wants_compaction(self) -> bool:
        with self._lock:
            return len(self.delta_rows) >= max(1, self.delta_max_rows // 2)

    def compact(self) -> None:
        """Fold the delta into the base at a rung sized to the live
        total, then warm the probe at the (possibly new) base rung.
        Rows whose key is NULL are dropped: no probe can return them."""
        with self._lock:
            if not self.delta_rows or self._delta_keys is None:
                return
            # host rows follow the program's order: the live base rows,
            # then the live delta rows
            merged = [list(r) for r, ok in zip(self.base_rows, self._base_mask) if ok]
            merged.extend(list(r) for r, ok in zip(self.delta_rows, self._delta_mask) if ok)
            live_total = len(merged)
            out_cap = bucket_capacity(max(16, live_total))
            old_cap = self.base_cap
            register_resident_warmup([
                _compact_entry(old_cap, self.delta_cap, out_cap, self.device),
                _probe_entry(out_cap, self.device),
            ])
            fn = _compact_program(old_cap, self.delta_cap, out_cap, self.device)
            new_keys, new_valid = fn(self.base_keys, self.base_valid,
                                     self._delta_keys, self._delta_valid)
            self.base_keys = new_keys
            self.base_valid = new_valid
            self.base_cap = out_cap
            self.base_rows = merged
            self._base_mask = [True] * live_total
            self._delta_codes = []
            self._delta_mask = []
            self.delta_rows = []
            self._delta_keys = None
            self._delta_valid = None
            _ProbeWarmer(self.base_cap, PROBE_OUT_CAP, self.device)(None)
            note_classes_warm([
                ("ResidentProbe", self.base_cap, ("int64",)),
                ("ResidentCompact", old_cap, (f"d{self.delta_cap}", f"o{out_cap}")),
            ])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()

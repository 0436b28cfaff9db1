"""Hash-join build/probe.

Counterpart of trino_tpu/ops/join.py (Trino's PagesIndex + PagesHash +
JoinProbe family, re-designed around sorting):

- Build (`LookupSource`): hash the build keys to 32 bits and sort the
  build rows by (hash, row). The sorted hashes and the permutation are
  the lookup structure; duplicate keys are adjacent runs.
- Probe: `sorted_run_bounds` places every probe hash among the sorted
  build hashes. The reference does it with two packed sorts, the cheap
  primitive on a TPU; here it is the pair of lower bounds
  lo = #{sorted < q} and hi = #{sorted < q + 1} from one launch of the
  bounds kernel (ops/window_rank.bounds: window heads searched in shared
  memory, the window in L2, hi galloped from lo). What paces it is the
  scattered reads of the sorted hashes inside each window (six a probe
  row against 1.5 M hashes), not the bytes it must move.
- Fan-out: count the matches, pick a bucketed output capacity on the
  host, then expand (probe_row, build_row) pairs; 32-bit hash collisions
  are culled by an exact key-equality verify on the pairs. Which probe
  row produced output j is a run-owner fill (ops/window_rank.run_owner:
  each row writes its own run, no search; bound by bytes), and the index
  gathers of the expansion run through the flat gather kernel
  (ops/gather_kernels.take_flat) on the card. `expand_runs` is the same
  fill over any per-row counts: UNNEST and the array functions lay out
  each row's elements with it.

The u32 hash domain rides in int64 tensors holding [0, 2^32): torch has
no uint32 shifts or compares on the CPU. Real hashes clamp to
_H_REAL_MAX so that the two sentinels own the top values: a probe with a
NULL key carries _NO_MATCH_HASH and finds nothing, a dead or NULL-keyed
build row carries _DEAD_BUILD_HASH, sorts last and is never found.
lo, counts, the permutation and the expanded pairs are bit-equal to the
reference's. SQL join-key semantics: NULL never matches NULL.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from trino_tpu_torch.block import bucket_capacity
from trino_tpu_torch.ops import gather_kernels as GK
from trino_tpu_torch.ops import window_rank as W
from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.hashing import hash32

_H_REAL_MAX = 0xFFFFFFFD
_NO_MATCH_HASH = 0xFFFFFFFE  # probes that must find nothing
_DEAD_BUILD_HASH = 0xFFFFFFFF  # dead build rows sort last


def sorted_run_bounds(sorted_arr: torch.Tensor, q: torch.Tensor):
    """For each query, the run [lo, hi) of equal values in a sorted
    array (DefaultPagesHash's probe): lo = #{sorted < q},
    hi = #{sorted <= q}. Integer values; q + 1 must not overflow the
    type (hashes and offsets do not by construction). int32 results."""
    n = q.shape[0]
    if sorted_arr.shape[0] == 0 or n == 0:
        z = torch.zeros(n, dtype=torch.int32, device=q.device)
        return z, z
    return W.bounds(q.to(sorted_arr.dtype), sorted_arr)


def _key_hash(keys, valids, usable, sentinel: int) -> torch.Tensor:
    """Clamped 32-bit key hash (int64 carrier); unusable rows get the
    sentinel."""
    if keys:
        h = torch.clamp(hash32(list(keys), list(valids)), max=_H_REAL_MAX)
    else:
        h = torch.zeros(usable.shape[0], dtype=torch.int64, device=usable.device)
    return torch.where(usable, h, torch.full_like(h, sentinel))


def _usable(valids, live):
    usable = live
    for v in valids:
        usable = usable & v
    return usable


@dataclasses.dataclass
class LookupSource:
    """Device-resident build side: sorted hashes + row permutation."""

    sorted_hash: torch.Tensor  # (B,) int64 in [0, 2^32), dead rows = 0xFFFFFFFF
    perm: torch.Tensor  # (B,) int32: build row index at each sorted position
    key_cols: List[torch.Tensor]  # original (unsorted) build key columns
    key_valids: List[torch.Tensor]
    build_live: torch.Tensor  # (B,) bool

    @property
    def build_capacity(self) -> int:
        return int(self.perm.shape[0])


def build_lookup(keys: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                 live: torch.Tensor) -> LookupSource:
    """Build phase (HashBuilderOperator): one sort of the packed
    (hash, row) words. The hash is offset by 2^31 before the shift so
    that the signed int64 order is the unsigned (hash, row) order."""
    usable = _usable(valids, live)
    h = _key_hash(keys, valids, usable, _DEAD_BUILD_HASH)
    n = h.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=h.device)
    packed = ((h - (1 << 31)) << 32) | rows
    sp, _ = torch.sort(packed)
    sorted_hash = (sp >> 32) + (1 << 31)
    perm = (sp & 0xFFFFFFFF).to(torch.int32)
    return LookupSource(sorted_hash, perm, list(keys), list(valids), usable)


def probe_counts(ls: LookupSource, probe_keys: Sequence[torch.Tensor],
                 probe_valids: Sequence[torch.Tensor], probe_live: torch.Tensor):
    """Phase 1: per-probe-row candidate run [lo, hi). Returns
    (lo, counts, total); `total` is a device scalar (callers defer
    reading it)."""
    usable = _usable(probe_valids, probe_live)
    ph = _key_hash(probe_keys, probe_valids, usable, _NO_MATCH_HASH)
    lo, hi = sorted_run_bounds(ls.sorted_hash, ph)
    counts = hi - lo
    return lo, counts, torch.sum(counts, dtype=torch.int64)


def expand_matches(ls: LookupSource, probe_keys, probe_valids, lo: torch.Tensor,
                   counts: torch.Tensor, out_capacity: int, verify: bool = True):
    """Phase 2: materialize candidate pairs and verify exact key
    equality (hash collisions) unless the caller verifies on its
    gathered pair columns (verify=False). Returns (probe_idx, build_idx,
    pair_live), each (out_capacity,); probe_idx is nondecreasing."""
    dev = counts.device
    off = torch.cumsum(counts, 0, dtype=torch.int32)  # inclusive
    total = off[-1] if counts.shape[0] else torch.zeros((), dtype=torch.int32, device=dev)
    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    # which probe row produced output j: row i owns [off[i-1], off[i])
    pi = W.run_owner(off, out_capacity)
    pi_c = torch.clamp(pi, 0, max(counts.shape[0] - 1, 0))
    # lo and start ride one packed int64 gather
    packed = (lo.to(torch.int64) << 31) | (off - counts).to(torch.int64)
    g = GK.take_flat(packed, pi_c)
    start = (g & ((1 << 31) - 1)).to(torch.int32)
    spos = (g >> 31).to(torch.int32) + (j - start)
    spos = torch.clamp(spos, 0, ls.perm.shape[0] - 1)
    bi = GK.take_flat(ls.perm, spos)
    ok = j < total
    if verify:
        for pk, pv, bk, bv in zip(probe_keys, probe_valids, ls.key_cols, ls.key_valids):
            a = take_clip(pk, pi_c)
            av = take_clip(pv, pi_c)
            b = take_clip(bk, bi)
            bvv = take_clip(bv, bi)
            eqd = a == b
            if eqd.dim() == 2:  # long-decimal limb pairs
                eqd = eqd.all(dim=-1)
            ok = ok & eqd & av & bvv
    return pi_c, bi, ok


def expand_runs(counts: torch.Tensor):
    """Row i repeated counts[i] times, row after row, in a bucketed
    capacity: (owner row, index within the row's run, slot live mask,
    total) per output slot; slots past the total belong to the last row
    and are dead. counts: 1-D int32, nonnegative. Only the total crosses
    to the host."""
    dev = counts.device
    off = torch.cumsum(counts, 0, dtype=torch.int32)  # inclusive
    total = int(off[-1]) if counts.shape[0] else 0
    cap = bucket_capacity(max(total, 1))
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    if not counts.shape[0]:
        zero = torch.zeros(cap, dtype=torch.int32, device=dev)
        return zero, zero, j < 0, 0
    owner = torch.clamp(W.run_owner(off, cap), 0, counts.shape[0] - 1)
    elem = j - GK.take_flat(off - counts, owner)
    return owner, elem, j < total, total


def probe_matched_flags(probe_capacity: int, pi, pair_live) -> torch.Tensor:
    """Per-probe-row 'has >= 1 verified match'."""
    z = torch.zeros(probe_capacity + 1, dtype=torch.bool, device=pi.device)
    idx = torch.where(pair_live, pi.to(torch.int64), probe_capacity)
    z[idx] = True
    return z[:probe_capacity]


def build_matched_flags(build_capacity: int, bi, pair_live, prior=None) -> torch.Tensor:
    """Build-side matched bitmap for RIGHT/FULL outer joins."""
    z = torch.zeros(build_capacity + 1, dtype=torch.bool, device=bi.device)
    if prior is not None:
        z[:build_capacity] = prior
    idx = torch.where(pair_live, bi.to(torch.int64), build_capacity)
    z[idx] = True
    return z[:build_capacity]

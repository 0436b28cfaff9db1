"""Join-project: aggregate an equi-join without expanding it.

Counterpart of trino_tpu/ops/mxu_join.py. For the high-fanout shape

    SELECT b.g..., SUM(p.x), COUNT(p.y), COUNT(*)
    FROM probe p JOIN build b ON p.k = b.k
    GROUP BY b.g...

every aggregate argument comes off the probe side and every group column
off the build side, so the pair sum factors through the key:

    result[g] = sum_j [j matched, group(j) = g] * S[kid(j)]
    S[k]      = sum over probe rows i with key(i) = k of f(i)

S is a grouped int64 sum per probe batch with the build key id as the
group: ops/mxu_groupby.grouped_sum, the hand-written CUDA kernel on the
card (the reference contracts a one-hot of the ids on the matrix unit).
No pair batch ever exists. The outer sum over build rows is a gather of
S[kid(j)] (at most |build| rows), and an ordinary HashAggregationOperator
does the final grouping.

Key ids are exact, not hash-trusting: build keys get dense ids by value
(one sort by (unusable, key, row)). The probe's lookup rides the join's
sorted-hash runs (ops/join.probe_counts, the bounds kernel on the card)
with a representative-key verify; when the build side holds a 32-bit
hash collision between distinct keys (found once at the build barrier by
comparing distinct-hash and distinct-key counts) runs are no longer
key-pure and the lookup takes an exact searchsorted over the sorted
distinct keys. Past the kernel's capacity or row limits (MAX_CAPACITY,
MAX_ROWS) the sums take the plain segment sum, with the same semantics;
the caller decides that by shape before anything launches.
"""

from __future__ import annotations

from typing import Sequence

import torch

from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops import mxu_groupby as M
from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.mxu_groupby import MAX_CAPACITY, MAX_ROWS

__all__ = [
    "MAX_CAPACITY",
    "MAX_ROWS",
    "build_key_analysis",
    "uses_kernel",
    "probe_page_sums",
    "finalize_partials",
]


def build_key_analysis(key, valid, live, sorted_hash, perm):
    """Dense key ids for the build side, plus the probe-lookup tables.

    Returns (kid, kid_by_pos, distinct_keys, n_distinct, hash_pure):

    - kid[j] in [0, n_distinct) for usable build rows (live, non-NULL
      key); the batch capacity B for the rest. Ids follow key order, so
      distinct_keys is sorted.
    - kid_by_pos[p]: kid of the build row at sorted-hash position p
      (LookupSource.perm order).
    - distinct_keys[k]: the key owning id k; tail slots hold the dtype
      max, so searchsorted order holds.
    - n_distinct, hash_pure: device scalars; hash_pure is True when every
      sorted-hash run holds exactly one distinct key.
    """
    B = key.shape[0]
    dev = key.device
    usable = live & valid
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort((~usable[order]).to(torch.int8), stable=True)]
    k_s = key[order]
    us = usable[order]
    same_prev = torch.zeros(B, dtype=torch.bool, device=dev)
    if B > 1:
        same_prev[1:] = (k_s[1:] == k_s[:-1]) & us[1:] & us[:-1]
    starts = us & ~same_prev
    kid_s = torch.where(us, torch.cumsum(starts.to(torch.int64), 0) - 1, B)
    kid = torch.empty(B, dtype=torch.int64, device=dev)
    kid[order] = kid_s
    n_distinct = torch.sum(starts.to(torch.int64))
    distinct_keys = torch.full((B,), torch.iinfo(key.dtype).max, dtype=key.dtype,
                               device=dev)
    # torch has no mode="drop": unusable rows (kid == B) are masked out
    distinct_keys[kid_s[us]] = k_s[us]
    kid_by_pos = take_clip(kid, perm)
    # distinct real hashes == distinct keys <=> runs are key-pure
    real = sorted_hash <= J._H_REAL_MAX
    h_start = torch.ones(sorted_hash.shape[0], dtype=torch.bool, device=dev)
    h_start[1:] = sorted_hash[1:] != sorted_hash[:-1]
    n_hash = torch.sum((real & h_start).to(torch.int64))
    return kid, kid_by_pos, distinct_keys, n_distinct, n_hash == n_distinct


def uses_kernel(capacity: int, probe_rows: int) -> bool:
    """Whether a probe batch's sums go through the grouped_sum kernel:
    decided by shape alone, as the reference routes its kernel."""
    return capacity <= MAX_CAPACITY and probe_rows <= MAX_ROWS


def probe_page_sums(ls, kid_by_pos, distinct_keys, n_distinct, probe_key,
                    probe_key_valid, probe_live, arg_data: Sequence, arg_valid: Sequence,
                    kinds: Sequence[str], capacity: int, use_kernel: bool,
                    hash_path: bool):
    """One probe batch's per-key sums.

    `kinds` is the aggregate layout; arg_data/arg_valid align with it
    (placeholders for count_star). Per kind the value columns are: sum ->
    (NULL-zeroed values, non-NULL indicator); count -> (non-NULL
    indicator); count_star -> none (the appended matched-row count serves
    it). Returns the per-kid int64 sums in that column order, the
    matched-row count last. `use_kernel` (uses_kernel) picks
    mxu_groupby.grouped_sum, which launches the CUDA kernel for CUDA
    tensors, over its plain segment sum.
    """
    if hash_path:
        lo, counts, _total = J.probe_counts(ls, [probe_key], [probe_key_valid],
                                            probe_live)
        pos = torch.clamp(lo.to(torch.int64), 0, ls.perm.shape[0] - 1)
        bi = take_clip(ls.perm, pos)
        rep = take_clip(ls.key_cols[0], bi)
        repv = take_clip(ls.key_valids[0], bi)
        kid = take_clip(kid_by_pos, pos)
        matched = (counts > 0) & (rep == probe_key) & repv
    else:
        q = probe_key.to(distinct_keys.dtype).contiguous()
        pos = torch.searchsorted(distinct_keys, q)
        kid = torch.clamp(pos, 0, distinct_keys.shape[0] - 1)
        matched = (pos < n_distinct) & (take_clip(distinct_keys, kid) == probe_key)
    matched = matched & probe_key_valid & probe_live
    cols = []
    for kind, d, v in zip(kinds, arg_data, arg_valid):
        if kind == "sum":
            cols.append(torch.where(v, d.to(torch.int64), 0))
            cols.append(v.to(torch.int64))
        elif kind == "count":
            cols.append(v.to(torch.int64))
        # count_star rides the appended matched-row count
    n = probe_key.shape[0]
    values = (torch.stack(cols) if cols
              else torch.zeros((0, n), dtype=torch.int64, device=probe_key.device))
    gid = torch.where(matched, kid, capacity).to(torch.int32)
    if use_kernel:
        return tuple(M.grouped_sum(gid, values, matched, capacity))
    return tuple(M.grouped_sum_reference(gid, values, matched, capacity))


def finalize_partials(kid, build_live, sums: Sequence[torch.Tensor],
                      kinds: Sequence[str]):
    """Expand the accumulated per-kid sums back onto build rows.

    A build row is live iff it is usable (kid < capacity), its batch row
    is live and at least one probe row matched its key. Returns (live,
    [(data, valid)] per aggregate): SUM is valid where some contribution
    was non-NULL (SUM over only NULLs is NULL); COUNT and COUNT(*) are
    always valid.
    """
    capacity = sums[-1].shape[0]
    kidc = torch.clamp(kid, 0, capacity - 1)
    cnt = take_clip(sums[-1], kidc)
    live = build_live & (kid < capacity) & (cnt > 0)
    always = torch.ones(kid.shape[0], dtype=torch.bool, device=kid.device)
    outs = []
    i = 0
    for kind in kinds:
        if kind == "sum":
            outs.append((take_clip(sums[i], kidc), take_clip(sums[i + 1], kidc) > 0))
            i += 2
        elif kind == "count":
            outs.append((take_clip(sums[i], kidc), always))
            i += 1
        else:  # count_star
            outs.append((cnt, always))
    return live, outs

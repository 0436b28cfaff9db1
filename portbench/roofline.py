"""Bytes and operations of the port's kernels, for a roofline share that a
later change reads from the device trace (not reported yet: the kernel
wrappers keep no count of launches a shape).

Frozen copies of chip_smoke.py's `flat_bytes`, `search_bytes` and `bound`
with the H100's published peaks: the yardstick stays here, where a change
to the program cannot move it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12


def bound(bytes_moved: int, int_ops: int) -> tuple:
    """(bound_ms, bound_by): bytes over the memory rate against 32-bit
    operations over the INT32 rate, the larger of the two."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_bytes(n: int, n_b: int, elem: int, steps: int) -> int:
    """Bytes of b that n searches of `steps` levels must read: one 32-byte
    sector a step, and no more than all of b."""
    return min(n_b * elem, n * steps * 32)


def flat_bytes(n: int, idx_bytes: int, n_table: int, elem: int, sectors: int) -> int:
    """Bytes a flat gather must move: each index read and each output
    written once, and the table sectors the indices touch, no more than
    the whole table."""
    return n * (idx_bytes + elem) + min(n_table * elem, 32 * sectors)

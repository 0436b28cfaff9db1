"""float64 key decomposition shared with the reference's hashing.

Counterpart of trino_tpu/ops/floatbits.py (`f64_lanes` only, the part
`ops/hashing` needs). The reference decomposes a double into four
uint32 lanes using only f32 bitcasts and exact power-of-two arithmetic;
the lanes feed the row hash, so the port computes the SAME lanes (a
plain f64 bitcast would hash differently and break group order parity
with the reference). Lanes ride in int64 carriers holding values in
[0, 2^32): torch has no unsigned 32-bit shifts or compares on the CPU.

Properties carried over: lexicographic (lane1..lane4) is a total order
of float64 with -0.0 == +0.0 and NaN canonical, injective over normal
doubles.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def _f32_lane(x32: torch.Tensor) -> torch.Tensor:
    """f32 -> order-preserving unsigned key in an int64 carrier."""
    bits = x32.contiguous().view(torch.int32).to(torch.int64) & _M32
    neg = (bits & _SIGN32) != 0
    return torch.where(neg, (~bits) & _M32, bits | _SIGN32)


def _resid_lane(x: torch.Tensor, a32: torch.Tensor) -> torch.Tensor:
    au = torch.abs(a32)
    inf = torch.full_like(au, float("inf"))
    ulp = (torch.nextafter(au, inf) - au).to(torch.float64)
    q = (x - a32.to(torch.float64)) / torch.clamp(ulp, min=1e-300)
    r = (q * float(1 << 30)).to(torch.int32).to(torch.int64) + (1 << 29)
    return r & _M32


def f64_lanes(x: torch.Tensor):
    """float64 -> (lane1..lane4), each an int64 tensor in [0, 2^32)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)  # -0.0 == +0.0
    nan = torch.isnan(x)
    zero = x == 0
    inf = torch.isinf(x)
    m = torch.abs(x)
    k = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for j in range(1, 6):
        k = k + (m >= 2.0 ** (216 * j - 90)).to(torch.int32)
        k = k - (m < 2.0 ** (-216 * (j - 1) - 90)).to(torch.int32)
    half_scales = torch.tensor(
        [2.0 ** (-108 * kk) for kk in range(-5, 6)],
        dtype=torch.float64, device=x.device,
    )
    s = half_scales[torch.clamp(k + 5, 0, 10).to(torch.int64)]
    xs = (x * s) * s
    a = xs.to(torch.float32)

    lane1 = _f32_lane(x.to(torch.float32))
    lane2 = torch.where(x > 0, 8 + k, 8 - k).to(torch.int64) & _M32
    lane3 = _f32_lane(a)
    lane4 = _resid_lane(xs, a)
    z = torch.zeros_like(lane2)
    for special in (zero, nan):
        lane2 = torch.where(special, z, lane2)
        lane3 = torch.where(special, z, lane3)
        lane4 = torch.where(special, z, lane4)
    hi = torch.full_like(lane2, _M32)
    pos_inf = inf & (x > 0)
    neg_inf = inf & (x < 0)
    lane2 = torch.where(pos_inf, hi, torch.where(neg_inf, z, lane2))
    lane3 = torch.where(pos_inf, hi, torch.where(neg_inf, z, lane3))
    lane4 = torch.where(pos_inf, hi, torch.where(neg_inf, z, lane4))
    return lane1, lane2, lane3, lane4


def f32_bits_ordered(x32: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving unsigned 32-bit key (int64 carrier)."""
    return _f32_lane(x32)

"""Int128 arithmetic over (hi, lo) int64 limb pairs.

Counterpart of trino_tpu/ops/int128.py — the carrier for
decimal(19..38). A long-decimal column is one (n, 2) int64 tensor
(column 0 = signed high limb, column 1 = low limb holding unsigned
bits); the functions here take and return separate (hi, lo) tensors.
value = hi * 2^64 + (lo as u64). Unsigned compares use the sign-flip
trick, and 64x64 -> 128 products decompose into 32-bit half-limbs so
every partial product is exact in int64's wrapping arithmetic. Results
are bit-equal to the reference.

Scalars may be python ints or tensors; python ints are lifted onto the
device of the tensor operand.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK32 = 0xFFFFFFFF
_U64_SIGN = -0x8000000000000000  # 1 << 63 as int64


def _t(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.int64, device=like.device)


def _u64_lt(a, b):
    """Unsigned < over int64 bit patterns."""
    return (a ^ _U64_SIGN) < (b ^ _U64_SIGN)


def from_i64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-extend an int64 into (hi, lo)."""
    x = x.to(torch.int64)
    return x >> 63, x


def add(ah, al, bh, bl):
    lo = al + bl
    carry = _u64_lt(lo, al).to(torch.int64)
    return ah + bh + carry, lo


def neg(h, lo):
    nh, nl = ~h, ~lo
    lo2 = nl + 1
    carry = (lo2 == 0).to(torch.int64)
    return nh + carry, lo2


def sub(ah, al, bh, bl):
    like = ah if isinstance(ah, torch.Tensor) else al
    nh, nl = neg(_t(bh, like), _t(bl, like))
    return add(ah, al, nh, nl)


def eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def lt(ah, al, bh, bl):
    """Signed 128-bit less-than."""
    return (ah < bh) | ((ah == bh) & _u64_lt(al, bl))


def sign(h, lo):
    """-1 / 0 / +1 as int64."""
    is_zero = (h == 0) & (lo == 0)
    one = torch.ones_like(h)
    return torch.where(is_zero, torch.zeros_like(h), torch.where(h < 0, -one, one))


def abs_(h, lo):
    nh, nl = neg(h, lo)
    negv = h < 0
    return torch.where(negv, nh, h), torch.where(negv, nl, lo)


def _umul64(a, b):
    """Unsigned 64x64 -> (hi, lo) via 32-bit half-limbs."""
    a0 = a & _MASK32
    a1 = (a >> 32) & _MASK32
    b0 = b & _MASK32
    b1 = (b >> 32) & _MASK32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = ((p00 >> 32) & _MASK32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | (mid << 32)
    hi = p11 + ((p01 >> 32) & _MASK32) + ((p10 >> 32) & _MASK32) + (mid >> 32)
    return hi, lo


def mul_i64(a: torch.Tensor, b: torch.Tensor):
    """Signed full 64x64 -> 128 product."""
    hi, lo = _umul64(a, b)
    z = torch.zeros_like(hi)
    hi = hi - torch.where(a < 0, b, z) - torch.where(b < 0, a, z)
    return hi, lo


def mul_128(ah, al, bh, bl):
    """Full 128x128 product mod 2^128."""
    ph, pl = _umul64(al, bl)
    cross = ah * bl + al * bh
    return ph + cross, pl


def mul_128_64(h, lo, m):
    """(hi, lo) * signed-64 m with |m| <= 2^62, result mod 2^128."""
    m = _t(m, lo)
    am = torch.abs(m)
    ph, pl = _umul64(lo, am)
    nh, nl = neg(ph, pl)
    m_neg = m < 0
    ph = torch.where(m_neg, nh, ph)
    pl = torch.where(m_neg, nl, pl)
    return ph + h * m, pl


def rescale_up(h, lo, k: int):
    """(hi, lo) * 10^k for 0 <= k <= 38."""
    if k == 0:
        return h, lo
    while k > 18:
        h, lo = mul_128_64(h, lo, 10 ** 18)
        k -= 18
    return mul_128_64(h, lo, 10 ** k)


def divmod_u128_u64(h, lo, d):
    """Unsigned 128 / unsigned-63-bit divisor -> (q_hi, q_lo, rem).
    Schoolbook over 32-bit digits with a float-seeded digit estimate
    and bounded exact correction, as in the reference."""
    d = _t(d, lo)
    digits = [
        (h >> 32) & _MASK32,
        h & _MASK32,
        (lo >> 32) & _MASK32,
        lo & _MASK32,
    ]
    zero = torch.zeros_like(h)
    q = []
    r = torch.zeros_like(h)
    df = d.to(torch.float64)
    for dig in digits:
        p_hi = r >> 32
        p_lo = (r << 32) | dig
        num = p_hi.to(torch.float64) * (2.0 ** 64) + torch.where(
            p_lo < 0,
            p_lo.to(torch.float64) + 2.0 ** 64,
            p_lo.to(torch.float64),
        )
        est = torch.clamp(torch.floor(num / df), 0.0, 2.0 ** 32).to(torch.int64)
        prod = _umul64(est, d)
        rem_h, rem_l = sub(p_hi, p_lo, prod[0], prod[1])
        for _ in range(4):
            over = rem_h < 0
            est = est - over.to(torch.int64)
            ah2, al2 = add(rem_h, rem_l, zero, d)
            rem_h = torch.where(over, ah2, rem_h)
            rem_l = torch.where(over, al2, rem_l)
        for _ in range(4):
            under = ~lt(rem_h, rem_l, zero, d)
            est = est + under.to(torch.int64)
            sh2, sl2 = sub(rem_h, rem_l, zero, d)
            rem_h = torch.where(under, sh2, rem_h)
            rem_l = torch.where(under, sl2, rem_l)
        q.append(est & _MASK32)
        r = rem_l
    qh = (q[0] << 32) | q[1]
    ql = (q[2] << 32) | q[3]
    return qh, ql, r


def div_round_i64(h, lo, d):
    """Signed (hi,lo) / signed nonzero int64 d, HALF_UP rounding."""
    d = _t(d, lo)
    ah, al = abs_(h, lo)
    ad = torch.abs(d)
    qh, ql, r = divmod_u128_u64(ah, al, ad)
    round_up = ~_u64_lt(r + r, ad)
    qh2, ql2 = add(qh, ql, torch.zeros_like(qh), round_up.to(torch.int64))
    negv = (sign(h, lo) * torch.sign(d)) < 0
    nh, nl = neg(qh2, ql2)
    return torch.where(negv, nh, qh2), torch.where(negv, nl, ql2)


def _u128_lt(ah, al, bh, bl):
    """Unsigned 128-bit less-than over limb pairs."""
    return _u64_lt(ah, bh) | ((ah == bh) & _u64_lt(al, bl))


def divmod_u128_u128(uh, ul, dh, dl):
    """Unsigned 128 / unsigned nonzero 128 -> (q_hi, q_lo, r_hi, r_lo):
    restoring bit-serial long division, 128 steps over the whole batch
    (the divisor-beyond-int64 path; divmod_u128_u64 stays the fast path
    for short divisors)."""
    zero = torch.zeros_like(uh)
    qh, ql, rh, rl = zero, zero, zero, zero
    for shift in range(127, -1, -1):
        bit = (uh >> (shift - 64)) & 1 if shift >= 64 else (ul >> shift) & 1
        rh = (rh << 1) | ((rl >> 63) & 1)
        rl = (rl << 1) | bit
        ge = ~_u128_lt(rh, rl, dh, dl)
        sh, sl = sub(rh, rl, dh, dl)
        rh = torch.where(ge, sh, rh)
        rl = torch.where(ge, sl, rl)
        qbit = ge.to(torch.int64)
        if shift >= 64:
            qh = qh | (qbit << (shift - 64))
        else:
            ql = ql | (qbit << shift)
    return qh, ql, rh, rl


def div_round_128(h, lo, dh, dl):
    """Signed 128 / signed nonzero 128, HALF_UP rounding (divisors
    beyond int64 included)."""
    ah, al = abs_(h, lo)
    bh_a, bl_a = abs_(dh, dl)
    qh, ql, rh, rl = divmod_u128_u128(ah, al, bh_a, bl_a)
    # round up when 2r >= d (r < d < 2^127, so 2r fits unsigned 128)
    r2h = (rh << 1) | ((rl >> 63) & 1)
    r2l = rl << 1
    round_up = ~_u128_lt(r2h, r2l, bh_a, bl_a)
    qh, ql = add(qh, ql, torch.zeros_like(qh), round_up.to(torch.int64))
    negv = (sign(h, lo) * sign(dh, dl)) < 0
    nh, nl = neg(qh, ql)
    return torch.where(negv, nh, qh), torch.where(negv, nl, ql)


def mod_128(h, lo, dh, dl):
    """Signed 128 % signed nonzero 128; the result takes the dividend's
    sign."""
    ah, al = abs_(h, lo)
    bh_a, bl_a = abs_(dh, dl)
    _, _, rh, rl = divmod_u128_u128(ah, al, bh_a, bl_a)
    nh, nl = neg(rh, rl)
    negv = h < 0
    return torch.where(negv, nh, rh), torch.where(negv, nl, rl)


def rescale_down_round(h, lo, k: int):
    """(hi, lo) / 10^k with HALF_UP rounding, 0 <= k <= 38."""
    if k == 0:
        return h, lo
    while k > 18:
        h, lo = div_round_i64(h, lo, 10 ** 18)
        k -= 18
    return div_round_i64(h, lo, 10 ** k)


def to_i64(h, lo):
    """(value mod 2^64) as int64 plus an in-range flag."""
    return lo, h == (lo >> 63)


def _const64(v: int) -> int:
    """A 64-bit pattern as a signed python int."""
    return v - (1 << 64) if v >= 1 << 63 else v


_BOUND = 10 ** 38
_BOUND_HI = _const64((_BOUND >> 64) & ((1 << 64) - 1))
_BOUND_LO = _const64(_BOUND & ((1 << 64) - 1))


def overflows_38(h, lo):
    """|value| >= 10^38."""
    ah, al = abs_(h, lo)
    ge = ~lt(ah, al, _BOUND_HI, _BOUND_LO)
    return ge | (ah < 0)


def to_python(h: int, lo: int) -> int:
    """(hi, lo) host ints -> python int value."""
    return (int(h) << 64) | (int(lo) & ((1 << 64) - 1))


def from_python(v: int) -> Tuple[int, int]:
    """python int -> (hi, lo) as int64-representable host ints."""
    lo = v & ((1 << 64) - 1)
    h = (v >> 64) & ((1 << 64) - 1)
    if lo >= 1 << 63:
        lo -= 1 << 64
    if h >= 1 << 63:
        h -= 1 << 64
    return h, lo

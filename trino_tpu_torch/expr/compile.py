"""Expression binder: typed IR -> eager torch closures.

Counterpart of trino_tpu/expr/compile.py (the PageFunctionCompiler
analogue). Binding happens once per pipeline against the input schema
(types + per-column string dictionaries); the result is a closure of
torch ops evaluated per batch on the batch's device. String logic
(LIKE, ordering, the string, regexp, hash, url and json functions)
resolves on the host against dictionary values, never per row: a
Python function maps the |dict| values once at bind time and the
device only remaps codes through the resulting table, which is copied
to each device once (`_Table`).

Value model: every expression evaluates to ``(data, valid)`` where
``valid=None`` means all-valid; SQL three-valued logic lives in the
and/or/not lowerings. Decimals are scaled int64 (precision <= 18) or
(n, 2) Int128 limb pairs (precision 19..38) through ops/int128.

Nested values (ARRAY, MAP, ROW) travel as whole Columns in the data
slot: the lambda functions, the array and map functions, split and
split_to_map, the navigation operators and the sketch readers bind as
in the reference, with one repair — filter, map_filter, array_remove,
array_sort, array_distinct and the per-row reductions read each row's
elements in row order through its lengths, so they stay right after a
join or sort has gathered the rows (ROADMAP §3).

Every scalar function of the reference's binder is bound here.
TIMESTAMP WITH TIME ZONE values are packed int64 (instant millis << 12 |
zone id, ops/tz.py): comparisons compare instants only, and the
functions over them read the zone's offset on the device.
"""

from __future__ import annotations

import base64 as _b64
import dataclasses
import datetime as _dt
import hashlib as _hashlib
import hmac as _hmac
import json as _json
import math
import os
import re as _re
import struct as _struct
import types
import unicodedata
import zlib as _zlib
from typing import Callable, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, quote, unquote, urlsplit

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import (
    ArrayColumn,
    Column,
    Dictionary,
    MapColumn,
    RowColumn,
    RuntimeDictionary,
    _concat_columns,
)
from trino_tpu_torch.expr import functions as F
from trino_tpu_torch.expr import pyfns
from trino_tpu_torch.expr.ir import (
    Call, Case, Cast, Expr, InList, InputRef, LambdaVar, Literal,
)
from trino_tpu_torch.ops import int128 as I128
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops import tz as TZ
from trino_tpu_torch.ops.gather import take_clip
from trino_tpu_torch.ops.sort import _order_value
from trino_tpu_torch.ops.floatbits import f32_bits_ordered
from trino_tpu_torch.ops.hashing import (
    canonical_hash_input, dictionary_code_hashes, dictionary_lut, hash64,
)

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]
EvalFn = Callable[[List[torch.Tensor], List[Optional[torch.Tensor]]], Value]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): |x|^(1/3) with its sign, refined
    by one Newton step so exact cubes come out exact."""
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    ok = torch.isfinite(y) & (y != 0)
    safe = torch.where(ok, y, torch.ones_like(y))
    return torch.where(ok, safe - (safe * safe * safe - x) / (3.0 * safe * safe), y)


# double -> double elementwise library (MathFunctions analogues)
_UNARY_DOUBLE_FNS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "cbrt": _cbrt,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "expm1": torch.expm1, "log1p": torch.log1p,
}

_MICROS_PER_DAY = 86400 * 1000 * 1000
# sub-day date_trunc/date_add/date_diff units (TIMESTAMP is epoch micros)
_MICROS_PER_UNIT = {
    "hour": 3600 * 1000 * 1000,
    "minute": 60 * 1000 * 1000,
    "second": 1000 * 1000,
    "millisecond": 1000,
}

# the TIMESTAMP WITH TIME ZONE expressions the analyzer emits
_TSTZ_FNS = (
    "at_timezone_id", "ts_to_tstz", "tstz_to_ts", "parse_tstz",
    "tstz_shift", "tstz_timezone_hour", "tstz_timezone_minute",
    "tstz_to_instant_ts", "tstz_rewall",
)


@dataclasses.dataclass
class Bound:
    """A bound expression: closure + static result metadata.
    ``const_value`` is set only for bound literals."""

    type: T.DataType
    fn: EvalFn
    dictionary: Optional[Dictionary] = None
    const_value: object = None
    is_const: bool = False
    input_ref: Optional[int] = None


def scale_decimal_value(v, t: T.DataType) -> int:
    """Python value -> scaled int payload, rounding half away from zero;
    integers scale exactly."""
    sf = T.decimal_scale_factor(t)
    if isinstance(v, int) and not isinstance(v, bool):
        return v * sf
    import decimal as _d

    if isinstance(v, _d.Decimal):
        return int((v * sf).to_integral_value(rounding=_d.ROUND_HALF_UP))
    x = v * sf
    return int(math.floor(abs(x) + 0.5)) * (1 if x >= 0 else -1)


def merge_valid(*valids: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for v in valids:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _ref(cols) -> torch.Tensor:
    """A tensor with the batch's row count (a nested input's lengths)."""
    if not cols:
        return torch.zeros(1)
    return cols[0].data if isinstance(cols[0], Column) else cols[0]


def _const(shape_src, value, dtype) -> torch.Tensor:
    if isinstance(shape_src, Column):
        shape_src = shape_src.data
    return torch.full(
        (shape_src.shape[0],), value, dtype=dtype, device=shape_src.device
    )


def _phys_const(shape_src, t: T.DataType, value128=(0, 0)):
    """Constant tensor in t's physical shape."""
    if isinstance(shape_src, Column):
        shape_src = shape_src.data
    n = shape_src.shape[0]
    if t.lanes == 2:
        return torch.tensor(
            value128, dtype=torch.int64, device=shape_src.device
        ).expand(n, 2)
    return torch.full((n,), value128[1], dtype=t.dtype, device=shape_src.device)


def _split2(d):
    return d[:, 0], d[:, 1]


def _join2(h, lo):
    return torch.stack([h, lo], dim=-1)


def _lift128(d, t: T.DataType):
    """Scaled int64 decimal or integer -> (hi, lo) limbs, same scale."""
    if t.is_long_decimal:
        return _split2(d)
    return I128.from_i64(d.to(torch.int64))


def _f64_of_decimal(d, t: T.DataType):
    """Decimal physical -> float64 value."""
    sf = T.decimal_scale_factor(t)
    if t.is_long_decimal:
        h, lo = _split2(d)
        lof = lo.to(torch.float64)
        u = torch.where(lo < 0, lof + 2.0 ** 64, lof)
        return (h.to(torch.float64) * 2.0 ** 64 + u) / sf
    return d.to(torch.float64) / sf


def _where_lanes(cond, a, b):
    """torch.where broadcasting the condition over 2-lane decimals."""
    if a.dim() == 2 or b.dim() == 2:
        cond = cond[:, None]
    return torch.where(cond, a, b)


def _with_valid(col: Column, valid) -> Column:
    return col if valid is None else dataclasses.replace(col, valid=valid)


def _null_like(col: Column) -> Column:
    """A column of NULLs laid out as `col` (its views, flats and
    dictionaries), as many rows."""
    zeros = torch.zeros(col.capacity, dtype=torch.int64, device=col.device)
    return col.gather(zeros, zeros.to(torch.bool))


def _nested_select(take, a: Column, b: Column) -> Column:
    """Per row, `a`'s value where `take`, else `b`'s (nested columns of
    one type: both are laid end to end and the rows' views gathered)."""
    both = _concat_columns([a, b])
    idx = torch.arange(take.shape[0], device=take.device)
    return both.gather(torch.where(take, idx, idx + a.capacity))


class _Table:
    """A lookup table built on the host at bind time. Each device it is
    read on gets its own copy once, kept for the Bound's lifetime, so a
    1.5 M-entry dictionary remap crosses to the card once, not once a
    batch."""

    __slots__ = ("host", "_placed")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self._placed = {}

    @property
    def shape(self):
        return self.host.shape

    def on(self, device) -> torch.Tensor:
        t = self._placed.get(device)
        if t is None:
            t = self._placed[device] = self.host.to(device)
        return t


def _table(values, dtype) -> _Table:
    return _Table(torch.tensor(np.asarray(values), dtype=dtype))


def _lookup(table: _Table, codes: torch.Tensor) -> torch.Tensor:
    """table[clip(codes)] from the table's copy on the codes' device."""
    idx = torch.clamp(codes.to(torch.int64), 0, max(table.shape[0] - 1, 0))
    return table.on(codes.device)[idx]


def _nested_valid(c: Column, v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The validity of a nested value: its Column's own AND the pair's."""
    return merge_valid(c.valid, v)


def _dict_code_const(probe: Bound, dictionary, elem_type):
    """A constant search value in the elements' physical form: its code
    in the element dictionary (an absent string matches nothing), a
    decimal scaled. Only constants are searched for."""
    if not probe.is_const or probe.const_value is None:
        raise NotImplementedError("array/map search functions take a constant search value")
    if dictionary is not None:
        code = dictionary.code(probe.const_value)
        return code if code >= 0 else -2
    if elem_type.is_decimal:
        if elem_type.is_long_decimal:
            raise _unsupported("array/map search over decimal(>18) elements")
        return scale_decimal_value(probe.const_value, elem_type)
    return probe.const_value


def minmax_like(dtype: torch.dtype, is_min: bool):
    """The identity of a min (max) over `dtype`."""
    if dtype.is_floating_point:
        return math.inf if is_min else -math.inf
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _unsupported(name: str):
    """What neither package binds: trino_tpu raises on the same input."""
    return NotImplementedError(f"{name}: not supported (trino_tpu raises here too)")


def _format_cast_text(v, src_type: T.DataType):
    """SQL text form for cast-to-varchar constant folding."""
    if v is None:
        return None
    if src_type.kind == T.TypeKind.BOOLEAN:
        return "true" if v else "false"
    if src_type.is_decimal:
        s = src_type.scale or 0
        return f"{v:.{s}f}" if s else str(int(v))
    if src_type.kind == T.TypeKind.TIMESTAMP_TZ:
        return TZ.format_tstz(int(v))
    return str(v)


def _try_decode(fn):
    """bytes-producing thunk -> utf-8 varchar carrier, NULL where the
    text does not decode (binascii.Error is a ValueError)."""
    try:
        return fn().decode("utf-8", "replace")
    except ValueError:
        return None


def _py_soundex(s: str) -> str:
    """American Soundex (StringFunctions.soundex)."""
    codes = {
        **dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
        **dict.fromkeys("DT", "3"), "L": "4",
        **dict.fromkeys("MN", "5"), "R": "6",
    }
    u = [c for c in s.upper() if c.isalpha()]
    if not u:
        return ""
    out = [u[0]]
    prev = codes.get(u[0], "")
    for c in u[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out.append(code)
        if c not in "HW":
            prev = code
    return ("".join(out) + "000")[:4]


# at most this many Lentz steps of the incomplete beta's continued
# fraction; it converges in O(sqrt(max(a, b))) steps, and the loop
# stops once every lane has
_BETACF_MAX_STEPS = 1000


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b) (modified Lentz)."""
    tiny = 1e-300

    def nz(t):
        return torch.where(torch.abs(t) < tiny, torch.full_like(t, tiny), t)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / nz(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETACF_MAX_STEPS + 1):
        m2 = 2.0 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 / nz(1.0 + aa * d)
            c = nz(1.0 + aa / c)
            step = d * c
            h = h * step
        if m % 8 == 0 and not bool(
                torch.any(torch.isfinite(step) & (torch.abs(step - 1.0) > 1e-15))):
            break
    return h


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b) in float64 torch ops (torch
    has no betainc; jax.scipy.special.betainc is the reference's)."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    xs = torch.clamp(x, 0.0, 1.0)
    lbt = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
           + a * torch.log(xs) + b * torch.log1p(-xs))
    bt = torch.exp(lbt)
    direct = xs < (a + 1.0) / (a + b + 2.0)
    # evaluate the fraction where it converges fast, mirror elsewhere
    aa = torch.where(direct, a, b)
    bb = torch.where(direct, b, a)
    xx = torch.where(direct, xs, 1.0 - xs)
    frac = bt * _betacf(aa, bb, xx) / aa
    out = torch.where(direct, frac, 1.0 - frac)
    out = torch.where(xs <= 0.0, torch.zeros_like(out), out)
    out = torch.where(xs >= 1.0, torch.ones_like(out), out)
    bad = (a <= 0) | (b <= 0) | torch.isnan(x) | (x < 0) | (x > 1)
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def _betaincinv(a, b, p):
    """Beta quantile by a fixed 64-step bisection on betainc, as the
    reference does where jax.scipy.special has no betaincinv."""
    lo = torch.zeros_like(p)
    hi = torch.ones_like(p)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        below = betainc(a, b, mid) < p
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    x = 0.5 * (lo + hi)
    bad = (p < 0) | (p > 1) | (a <= 0) | (b <= 0)
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _make_prob_fns():
    """Probability/statistics scalar family (MathFunctions *_cdf,
    wilson_interval_*): plain float64 formulas by name."""
    gammainc, gammaincc = torch.special.gammainc, torch.special.gammaincc

    def binomial_cdf(n, p, k):
        kf = torch.floor(k)
        mid = betainc(n - kf, kf + 1.0, 1.0 - p)
        return torch.where(kf >= n, torch.ones_like(mid),
                           torch.where(kf < 0, torch.zeros_like(mid), mid))

    def wilson(s, n, z, sign):
        p = s / n
        z2 = z * z
        center = p + z2 / (2 * n)
        half = z * torch.sqrt(p * (1 - p) / n + z2 / (4 * n * n))
        return (center + sign * half) / (1 + z2 / n)

    def laplace(m, b, x):
        return torch.where(x < m, 0.5 * torch.exp((x - m) / b),
                           1.0 - 0.5 * torch.exp(-(x - m) / b))

    def weibull(a, b, x):
        out = 1.0 - torch.exp(-((x / b) ** a))
        return torch.where(x <= 0, torch.zeros_like(out), out)

    return {
        "cauchy_cdf": lambda m, s, x: 0.5 + torch.atan2(x - m, s) / math.pi,
        "chi_squared_cdf": lambda df, x: gammainc(df / 2.0, x / 2.0),
        "gamma_cdf": lambda sh, sc, x: gammainc(sh, x / sc),
        "poisson_cdf": lambda lam, k: gammaincc(torch.floor(k) + 1.0, lam),
        "beta_cdf": betainc,
        "f_cdf": lambda d1, d2, x: betainc(d1 / 2.0, d2 / 2.0, d1 * x / (d1 * x + d2)),
        "binomial_cdf": binomial_cdf,
        "laplace_cdf": laplace,
        "logistic_cdf": lambda a, b, x: 1.0 / (1.0 + torch.exp(-(x - a) / b)),
        "weibull_cdf": weibull,
        "inverse_beta_cdf": _betaincinv,
        "wilson_interval_lower": lambda s, n, z: wilson(s, n, z, -1.0),
        "wilson_interval_upper": lambda s, n, z: wilson(s, n, z, 1.0),
    }


_PROB_FNS = _make_prob_fns()


def _literal(e: Call, i: int, what: str) -> Literal:
    """The constant argument `i` of a call; both packages refuse a
    column there (the reference asserts)."""
    x = e.args[i]
    if not isinstance(x, Literal):
        raise _unsupported(f"{e.name}() with a non-constant {what}")
    return x


def _as_f64(b: Bound, d: torch.Tensor) -> torch.Tensor:
    """A numeric argument's physical data as doubles (decimals
    descaled, long decimals through their limbs)."""
    if b.type.is_decimal:
        return _f64_of_decimal(d, b.type)
    return d.to(torch.float64)


def _to_int(x: torch.Tensor, dtype) -> torch.Tensor:
    """Doubles to integers as XLA converts them, which the reference's
    astype inherits: NaN is 0 and values out of range saturate (torch
    leaves both undefined)."""
    info = torch.iinfo(dtype)
    hi, lo = x >= float(info.max), x < float(info.min)
    out = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x).to(dtype)
    out = torch.where(hi, torch.full_like(out, info.max), out)
    return torch.where(lo, torch.full_like(out, info.min), out)


def _sign(d: torch.Tensor) -> torch.Tensor:
    """sign with NaN and -0.0 kept (torch.sign maps both to 0)."""
    if not d.dtype.is_floating_point:
        return torch.sign(d)
    return torch.where((d == 0) | torch.isnan(d), d, torch.sign(d))


# shifts on the 64-bit pattern with XLA's semantics, which the reference
# inherits: a shift by a count outside [0, 63] leaves 0 (or, for the
# arithmetic right shift, the sign)
def _shift_count(s: torch.Tensor):
    oob = (s < 0) | (s > 63)
    return oob, torch.where(oob, torch.zeros_like(s), s)


def _shift_left(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    oob, k = _shift_count(s)
    return torch.where(oob, torch.zeros_like(x), x << k)


def _shift_right_logical(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Zero-filling right shift (torch has no uint64 shift on the CPU):
    an arithmetic shift with the sign-filled top k bits masked off."""
    oob, k = _shift_count(s)
    keep = ~((torch.full_like(x, -1) << (63 - k)) << 1)
    return torch.where(oob, torch.zeros_like(x), (x >> k) & keep)


def _shift_right_arithmetic(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    oob, k = _shift_count(s)
    return torch.where(oob, torch.where(x < 0, -1, 0).to(x.dtype), x >> k)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64's 64-bit pattern (SWAR; torch has no
    popcount). Every arithmetic shift here is masked to the bits a
    logical shift would keep."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _replacement_segments(t: str) -> list:
    """A regexp_replace template parsed into literal text and group
    numbers: $N is group N, \\$ a dollar, \\\\ a backslash."""
    segs: list = []
    buf: List[str] = []
    i = 0
    while i < len(t):
        c = t[i]
        if c == "\\" and i + 1 < len(t):
            buf.append(t[i + 1])
            i += 2
        elif c == "$" and i + 1 < len(t) and t[i + 1].isdigit():
            j = i + 1
            while j < len(t) and t[j].isdigit():
                j += 1
            if buf:
                segs.append("".join(buf))
                buf = []
            segs.append(int(t[i + 1:j]))
            i = j
        else:
            buf.append(c)
            i += 1
    if buf:
        segs.append("".join(buf))
    return segs


def _levenshtein(s: str, t: str) -> int:
    if len(s) < len(t):
        s, t = t, s
    prev = list(range(len(t) + 1))
    for i, cs in enumerate(s):
        cur = [i + 1]
        for j, ct in enumerate(t):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (cs != ct)))
        prev = cur
    return prev[-1]


def _luhn(s: str) -> bool:
    if not s or not s.isdigit():
        return False
    total = 0
    for i, ch in enumerate(reversed(s)):
        d = ord(ch) - 48
        if i % 2 == 1:
            d *= 2
            if d > 9:
                d -= 9
        total += d
    return total % 10 == 0


_MISS = object()


def _json_loads(s: str, keep_tokens: bool = False):
    """Parsed JSON, or _MISS for text that is not JSON. keep_tokens
    parses numbers as their literal text, so 7.0 renders as written."""
    try:
        if keep_tokens:
            return _json.loads(s, parse_float=str, parse_int=str)
        return _json.loads(s)
    except (ValueError, TypeError):
        return _MISS


def _json_nav(s: str, path: str, keep_tokens: bool = False):
    """The node a $.a.b[0] JSONPath names, or _MISS on any miss."""
    v = _json_loads(s, keep_tokens)
    if v is _MISS or not path.startswith("$"):
        return _MISS
    i = 1
    while i < len(path):
        if path[i] == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            key = path[i + 1:j]
            if not isinstance(v, dict) or key not in v:
                return _MISS
            v = v[key]
            i = j
        elif path[i] == "[":
            j = path.index("]", i)
            try:
                idx = int(path[i + 1:j])
            except ValueError:
                return _MISS
            if not isinstance(v, list) or not (-len(v) <= idx < len(v)):
                return _MISS
            v = v[idx]
            i = j + 1
        else:
            return _MISS
    return v


class ExprBinder:
    """Binds IR against an input schema. One instance per pipeline."""

    def __init__(self, input_types: Sequence[T.DataType],
                 input_dicts: Sequence[Optional[Dictionary]]):
        self.input_types = list(input_types)
        self.input_dicts = list(input_dicts)

    # ---- dispatch ----
    def bind(self, e: Expr) -> Bound:
        if isinstance(e, InputRef):
            return self._bind_input(e)
        if isinstance(e, Literal):
            return self._bind_literal(e)
        if isinstance(e, Cast):
            return self._bind_cast(e)
        if isinstance(e, Case):
            return self._bind_case(e)
        if isinstance(e, InList):
            return self._bind_in(e)
        if isinstance(e, Call):
            return self._bind_call(e)
        raise NotImplementedError(f"cannot bind {e!r}")

    # ---- leaves ----
    def _bind_input(self, e: InputRef) -> Bound:
        i = e.index
        return Bound(
            self.input_types[i],
            lambda cols, valids, i=i: (cols[i], valids[i]),
            self.input_dicts[i],
            input_ref=i,
        )

    def _bind_literal(self, e: Literal) -> Bound:
        t = e.type
        if e.value is None:
            def fn(cols, valids):
                ref = _ref(cols)
                return _phys_const(ref, t), _const(ref, False, torch.bool)
            return Bound(t, fn)
        if t.is_array and isinstance(e.value, tuple):
            return self._bind_array_literal(e)
        if t.is_nested:
            raise _unsupported(f"{t} literal")
        if t.is_string:
            d = Dictionary([e.value])

            def sfn(cols, valids):
                return _const(_ref(cols), 0, torch.int32), None
            return Bound(t, sfn, d, const_value=e.value, is_const=True)
        v = e.value
        if t.is_decimal:
            v = scale_decimal_value(v, t)
            if t.is_long_decimal:
                pair = I128.from_python(v)

                def lfn(cols, valids, pair=pair):
                    return _phys_const(_ref(cols), t, pair), None
                return Bound(t, lfn, const_value=e.value, is_const=True)

        def vfn(cols, valids, v=v):
            return _const(_ref(cols), v, t.dtype), None
        return Bound(t, vfn, const_value=e.value, is_const=True)

    def _bind_array_literal(self, e: Literal) -> Bound:
        """A constant ARRAY[...]: one flat slice per row (the values
        tiled), so every consumer sees the canonical layout."""
        t = e.type
        k = len(e.value)
        reps = max(k, 1)
        proto = Column.from_pylist(t.element, list(e.value) or [None], capacity=reps)

        def afn(cols, valids):
            ref = _ref(cols)
            n, dev = ref.shape[0], ref.device
            data = proto.data.to(dev)
            flat = Column(t.element, data.repeat((n,) + (1,) * (data.dim() - 1)),
                          None if proto.valid is None else proto.valid.to(dev).repeat(n),
                          proto.dictionary)
            idx = torch.arange(n, dtype=torch.int32, device=dev)
            return ArrayColumn(t, torch.full_like(idx, k), None, None, idx * reps, flat), None
        return Bound(t, afn, proto.dictionary, const_value=e.value, is_const=True)

    def _bind_tstz(self, name: str, e: Call, args) -> Bound:
        """TIMESTAMP WITH TIME ZONE over the packed int64 (instant millis
        << 12 | zone id, ops/tz.py). A constant zone reads its own
        transitions; a zone per row reads the flat table of every
        zone's. Shifts are arithmetic and divisions floored: instants
        before 1970 are negative."""
        shift, mask = TZ.MILLIS_SHIFT, TZ.ZONE_MASK

        def const_int(b: Bound, what: str) -> int:
            if not b.is_const or b.const_value is None:
                raise NotImplementedError(f"{name}() {what} must be constant")
            return int(b.const_value)

        def wall_millis(micros: torch.Tensor) -> torch.Tensor:
            return torch.div(micros.to(torch.int64), 1000, rounding_mode="floor")

        if name == "at_timezone_id":
            a, z = args
            zid = const_int(z, "zone")

            def atfn(cols, valids):
                d, v = a.fn(cols, valids)
                return (d & ~mask) | zid, v
            return Bound(e.type, atfn)
        if name == "tstz_shift":
            a, ms = args

            def shfn(cols, valids):
                d, v = a.fn(cols, valids)
                mdata, mv = ms.fn(cols, valids)
                return d + (mdata.to(torch.int64) << shift), merge_valid(v, mv)
            return Bound(e.type, shfn)
        if name == "tstz_to_instant_ts":
            (a,) = args

            def instfn(cols, valids):
                d, v = a.fn(cols, valids)
                return (d >> shift) * 1000, v
            return Bound(e.type, instfn)
        if name == "tstz_rewall":
            wall, orig = args

            def rwfn(cols, valids):
                w, wv = wall.fn(cols, valids)
                o, ov = orig.fn(cols, valids)
                zids = (o & mask).to(torch.int32)
                inst = TZ.wall_to_instant_rowwise(wall_millis(w), zids)
                return (inst << shift) | zids.to(torch.int64), merge_valid(wv, ov)
            return Bound(e.type, rwfn)
        if name == "ts_to_tstz":
            a, z = args
            zid = const_int(z, "zone")

            def ttfn(cols, valids):
                d, v = a.fn(cols, valids)
                inst = TZ.wall_to_instant_millis(wall_millis(d), zid)
                return (inst << shift) | zid, v
            return Bound(e.type, ttfn)
        if name == "tstz_to_ts":
            (a,) = args

            def ftfn(cols, valids):
                d, v = a.fn(cols, valids)
                ms = d >> shift
                off = TZ.offset_millis_rowwise(ms, (d & mask).to(torch.int32))
                return (ms + off) * 1000, v
            return Bound(e.type, ftfn)
        if name == "parse_tstz":
            a, z = args
            zone = TZ.zone_name(const_int(z, "zone"))
            return self._bind_dict_table_nullable(
                a, e.type, lambda s: TZ.parse_tstz(s, zone), torch.int64)
        # tstz_timezone_hour / _minute: the signed offset's components
        (a,) = args
        hour = name == "tstz_timezone_hour"

        def tzfn(cols, valids):
            d, v = a.fn(cols, valids)
            off = TZ.offset_millis_rowwise(d >> shift, (d & mask).to(torch.int32))
            mag = torch.abs(off)
            part = mag // 3_600_000 if hour else (mag % 3_600_000) // 60_000
            return torch.sign(off) * part, v
        return Bound(T.BIGINT, tzfn)

    # ---- cast ----
    def _bind_cast(self, e: Cast) -> Bound:
        a = self.bind(e.arg)
        out = self._bind_cast_from(e, a)
        if a.is_const:
            out.is_const = True
            out.const_value = a.const_value
        return out

    def _bind_cast_from(self, e, a: Bound) -> Bound:
        src, dst = a.type, e.type
        if src == dst or (src.is_string and dst.is_string):
            return Bound(dst, a.fn, a.dictionary)
        if src.kind == T.TypeKind.UNKNOWN:
            def nfn(cols, valids, afn=a.fn):
                d, _ = afn(cols, valids)
                return _phys_const(d, dst), _const(d, False, torch.bool)
            return Bound(dst, nfn)
        if src.is_decimal and dst.is_decimal:
            return self._rescaled(a, src.scale or 0, dst.scale or 0, dst)
        if src.is_decimal and dst.is_integerlike:
            if src.is_long_decimal:
                k = src.scale or 0

                def dlifn(cols, valids, afn=a.fn):
                    d, v = afn(cols, valids)
                    h, lo = I128.rescale_down_round(*_split2(d), k)
                    x, ok = I128.to_i64(h, lo)
                    return x.to(dst.dtype), ok if v is None else (v & ok)
                return Bound(dst, dlifn)
            sf = T.decimal_scale_factor(src)

            def difn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                q = F.div_round_half_away(d, _const(d, sf, d.dtype))
                return q.to(dst.dtype), v
            return Bound(dst, difn)
        if src.is_decimal and dst.is_floating:
            def dffn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return _f64_of_decimal(d, src).to(dst.dtype), v
            return Bound(dst, dffn)
        if src.is_integerlike and dst.is_decimal:
            if dst.is_long_decimal:
                k = dst.scale or 0

                def ilfn(cols, valids, afn=a.fn):
                    d, v = afn(cols, valids)
                    h, lo = I128.rescale_up(*I128.from_i64(d.to(torch.int64)), k)
                    return _join2(h, lo), v
                return Bound(dst, ilfn)
            sf = T.decimal_scale_factor(dst)

            def idfn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return d.to(dst.dtype) * sf, v
            return Bound(dst, idfn)
        if src.is_floating and dst.is_decimal:
            sf = T.decimal_scale_factor(dst)
            if dst.is_long_decimal:
                def flfn(cols, valids, afn=a.fn):
                    d, v = afn(cols, valids)
                    x = F.round_half_away(d.to(torch.float64) * sf)
                    h = torch.floor(x / 2.0 ** 64)
                    lo_f = x - h * 2.0 ** 64
                    lo = torch.where(
                        lo_f >= 2.0 ** 63, lo_f - 2.0 ** 64, lo_f
                    ).to(torch.int64)
                    return _join2(h.to(torch.int64), lo), v
                return Bound(dst, flfn)

            def fdfn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return F.round_half_away(d * sf).to(dst.dtype), v
            return Bound(dst, fdfn)
        if src.kind == T.TypeKind.TIMESTAMP and dst.kind == T.TypeKind.DATE:
            def tdfn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                days = torch.div(
                    d.to(torch.int64), _MICROS_PER_DAY, rounding_mode="floor"
                )
                return days.to(torch.int32), v
            return Bound(dst, tdfn)
        if src.kind == T.TypeKind.DATE and dst.kind == T.TypeKind.TIMESTAMP:
            def dtfn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return d.to(torch.int64) * _MICROS_PER_DAY, v
            return Bound(dst, dtfn)
        if (src.is_integerlike or src.kind == T.TypeKind.BOOLEAN) and (
            dst.is_integerlike or dst.is_floating
        ):
            def iifn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return d.to(dst.dtype), v
            return Bound(dst, iifn)
        if src.is_floating and (dst.is_integerlike or dst.is_floating):
            def fifn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                if dst.is_integerlike:
                    d = F.round_half_away(d)
                return d.to(dst.dtype), v
            return Bound(dst, fifn)
        if src.is_nested or dst.is_nested:
            raise _unsupported(f"cast {src} -> {dst}")
        if dst.is_string:
            bound = self._bind_cast_to_varchar(a, src, dst)
            if bound is not None:
                return bound
        if src.is_string:
            bound = self._bind_cast_from_varchar(a, dst)
            if bound is not None:
                return bound
        raise NotImplementedError(f"cast {src} -> {dst}")

    # int->varchar enumerates this value domain as a static dictionary;
    # values outside it become NULL (the reference's documented deviation)
    _SMALL_INT_CAST_RANGE = (0, 4096)

    def _bind_cast_to_varchar(self, a: Bound, src, dst) -> Optional[Bound]:
        """Constants fold through their SQL text; integers enumerate a
        small value domain; anything else has no static dictionary."""
        if a.is_const:
            text = _format_cast_text(a.const_value, src)
            d = Dictionary([text] if text is not None else [])

            def cfn(cols, valids):
                ref = _ref(cols)
                if text is None:
                    return _const(ref, 0, torch.int32), _const(ref, False, torch.bool)
                return _const(ref, 0, torch.int32), None
            return Bound(dst, cfn, d, const_value=text, is_const=True)
        if not src.is_integerlike:
            return None
        lo, hi = self._SMALL_INT_CAST_RANGE
        d = Dictionary([str(i) for i in range(lo, hi)])
        codes = _table([d.code(str(i)) for i in range(lo, hi)], torch.int32)

        def sfn(cols, valids, afn=a.fn):
            data, v = afn(cols, valids)
            in_range = (data >= lo) & (data < hi)
            out = _lookup(codes, data.to(torch.int64) - lo)
            return out, in_range if v is None else (v & in_range)
        return Bound(dst, sfn, d)

    def _bind_cast_from_varchar(self, a: Bound, dst) -> Optional[Bound]:
        """varchar -> DATE, TIMESTAMP or DECIMAL: each dictionary value
        parsed once on the host; text that does not parse is NULL (the
        reference's divergence from Trino, which raises)."""
        if dst.kind == T.TypeKind.DATE:
            def d_of(s):
                try:
                    return (_dt.date.fromisoformat(s.strip()) - F.EPOCH).days
                except ValueError:
                    return None
            return self._bind_dict_table_nullable(a, dst, d_of, dst.dtype)
        if dst.kind == T.TypeKind.TIMESTAMP:
            return self._bind_dict_table_nullable(a, dst, pyfns.iso_to_micros, torch.int64)
        if not dst.is_decimal:
            return None
        from decimal import ROUND_HALF_UP, Decimal, InvalidOperation

        def parse(txt):
            try:
                v = Decimal(txt) * (10 ** (dst.scale or 0))
                return int(v.to_integral_value(rounding=ROUND_HALF_UP))
            except (InvalidOperation, ValueError):
                return None

        if a.is_const:
            sv = parse(str(a.const_value))
            if sv is None:
                def nullfn(cols, valids):
                    ref = _ref(cols)
                    return _phys_const(ref, dst), _const(ref, False, torch.bool)
                return Bound(dst, nullfn)
            pair = I128.from_python(sv) if dst.is_long_decimal else (0, sv)

            def scfn(cols, valids):
                return _phys_const(_ref(cols), dst, pair), None
            return Bound(dst, scfn, const_value=a.const_value, is_const=True)
        if a.dictionary is None:
            return None
        parsed = [parse(v) for v in a.dictionary.values]
        ok_tab = _table([p is not None for p in parsed] or [False], torch.bool)
        if dst.is_long_decimal:
            tab = _table([I128.from_python(p if p is not None else 0) for p in parsed]
                         or [(0, 0)], torch.int64)
        else:
            tab = _table([p if p is not None else 0 for p in parsed] or [0], torch.int64)

        def dfn(cols, valids, afn=a.fn):
            d, v = afn(cols, valids)
            okv = _lookup(ok_tab, d)
            return _lookup(tab, d), okv if v is None else (v & okv)
        return Bound(dst, dfn)

    def _rescaled(self, a: Bound, sfrom: int, sto: int, out_type: T.DataType) -> Bound:
        if a.type.is_long_decimal or out_type.is_long_decimal:
            atype = a.type

            def lfn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                h, lo = _lift128(d, atype)
                if sto > sfrom:
                    # scale-up can wrap mod 2^128: those rows go NULL
                    lim_h, lim_l = I128.from_python(
                        (2 ** 127 - 1) // 10 ** (sto - sfrom)
                    )
                    ah_, al_ = I128.abs_(h, lo)
                    ok = I128.lt(ah_, al_, lim_h, lim_l)
                    v = ok if v is None else (v & ok)
                    h, lo = I128.rescale_up(h, lo, sto - sfrom)
                elif sfrom > sto:
                    h, lo = I128.rescale_down_round(h, lo, sfrom - sto)
                if out_type.is_long_decimal:
                    return _join2(h, lo), v
                x, ok = I128.to_i64(h, lo)
                return x, ok if v is None else (v & ok)
            return Bound(out_type, lfn)
        if sfrom == sto:
            return Bound(out_type, a.fn)
        if sto > sfrom:
            m = 10 ** (sto - sfrom)

            def up(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return d * m, v
            return Bound(out_type, up)
        m = 10 ** (sfrom - sto)

        def down(cols, valids, afn=a.fn):
            d, v = afn(cols, valids)
            return F.div_round_half_away(d, _const(d, m, d.dtype)), v
        return Bound(out_type, down)

    def _coerce_bound(self, b: Bound, out_t: T.DataType) -> Bound:
        """Coerce a bound expression to a target type via the casts."""
        if b.type == out_t:
            return b
        return self._bind_cast_from(types.SimpleNamespace(type=out_t), b)

    def _remap_to(self, b: Bound, target: Dictionary) -> Bound:
        if b.dictionary is None or b.dictionary == target:
            return Bound(b.type, b.fn, target)
        remap = _table(
            [target.code(v) for v in b.dictionary.values], torch.int32
        )

        def fn(cols, valids, bfn=b.fn):
            d, v = bfn(cols, valids)
            return _lookup(remap, d), v
        return Bound(b.type, fn, target)

    # ---- CASE ----
    def _bind_case(self, e: Case) -> Bound:
        conds = [self.bind(c) for c in e.conds]
        self._in_branch = getattr(self, "_in_branch", 0) + 1
        try:
            results = [self.bind(r) for r in e.results]
            default = self.bind(e.default) if e.default is not None else None
        finally:
            self._in_branch -= 1
        if e.type.is_nested:
            return self._nested_choice(e.type, conds, results, default)
        out_dict = None
        if e.type.is_string:
            merged = None
            for r in results + ([default] if default is not None else []):
                if r.dictionary is not None:
                    merged = (
                        r.dictionary if merged is None
                        else Dictionary.unify(merged, r.dictionary)[0]
                    )
            out_dict = merged
            results = [self._remap_to(r, out_dict) for r in results]
            if default is not None:
                default = self._remap_to(default, out_dict)
        elif e.type.is_decimal:
            results = [self._coerce_bound(r, e.type) for r in results]
            if default is not None:
                default = self._coerce_bound(default, e.type)
        out_t = e.type

        def fn(cols, valids):
            if default is not None:
                data, valid = default.fn(cols, valids)
                data = data.to(out_t.dtype)
            else:
                ref, _ = conds[0].fn(cols, valids)
                data = _phys_const(ref, out_t)
                valid = _const(ref, False, torch.bool)
            for cb, rb in reversed(list(zip(conds, results))):
                cd, cv = cb.fn(cols, valids)
                take = cd if cv is None else (cd & cv)
                rd, rv = rb.fn(cols, valids)
                data = _where_lanes(take, rd.to(out_t.dtype), data)
                rvv = rv if rv is not None else _const(rd, True, torch.bool)
                vv = valid if valid is not None else _const(rd, True, torch.bool)
                valid = torch.where(take, rvv, vv)
            return data, valid

        return Bound(out_t, fn, out_dict)

    def _nested_choice(self, out_t: T.DataType, conds, results, default) -> Bound:
        """CASE over ARRAY, MAP or ROW values: per row the first result
        whose condition holds, else the default (NULL without one). The
        branches of an array of strings are remapped onto one merged
        element dictionary first."""
        branches = results + ([default] if default is not None else [])
        out_dict = None
        if out_t.is_array and out_t.element.is_string:
            for b in branches:
                if b.dictionary is not None:
                    out_dict = (b.dictionary if out_dict is None
                                else Dictionary.unify(out_dict, b.dictionary)[0])
            branches = [self._remap_elements_to(b, out_dict) for b in branches]
            results = branches[:len(results)]
            default = branches[len(results)] if default is not None else None

        def fn(cols, valids):
            # a NULL branch (an untyped NULL, or no ELSE) takes the layout
            # of a typed one
            got = [None if b is None or b.type.kind == T.TypeKind.UNKNOWN
                   else _with_valid(*b.fn(cols, valids)) for b in results + [default]]
            null = _null_like(next(c for c in got if c is not None))
            col = got[-1] if got[-1] is not None else null
            for cb, rc in reversed(list(zip(conds, got[:-1]))):
                cd, cv = cb.fn(cols, valids)
                take = cd if cv is None else (cd & cv)
                col = _nested_select(take, null if rc is None else rc, col)
            return col, col.valid
        return Bound(out_t, fn, out_dict)

    def _remap_elements_to(self, b: Bound, target: Optional[Dictionary]) -> Bound:
        """An array-of-strings Bound with its elements' codes moved onto
        `target`."""
        if target is None or b.dictionary is None or b.dictionary == target:
            return Bound(b.type, b.fn, target)
        remap = _table([target.code(v) for v in b.dictionary.values], torch.int32)

        def fn(cols, valids, bfn=b.fn):
            d, v = bfn(cols, valids)
            flat = d.flat
            return dataclasses.replace(d, flat=Column(
                flat.type, _lookup(remap, flat.data), flat.valid, target)), v
        return Bound(b.type, fn, target)

    # ---- IN list ----
    def _bind_in(self, e: InList) -> Bound:
        v = self.bind(e.value)
        has_null_option = any(o.value is None for o in e.options)
        if v.type.is_string:
            codes = [v.dictionary.code(o.value) for o in e.options
                     if o.value is not None]
            opts = _table([c for c in codes if c >= 0], torch.int32)
        elif v.type.is_long_decimal:
            raise _unsupported("IN over decimal(>18)")
        else:
            opts = _table(
                [scale_decimal_value(o.value, v.type) if v.type.is_decimal
                 else o.value for o in e.options if o.value is not None],
                v.type.dtype,
            )

        def fn(cols, valids):
            d, val = v.fn(cols, valids)
            if opts.shape[0] == 0:
                hit = _const(d, False, torch.bool)
            else:
                hit = (d[:, None] == opts.on(d.device)[None, :]).any(dim=1)
            if has_null_option:
                val = hit if val is None else (val & hit)
            return hit, val
        return Bound(T.BOOLEAN, fn)

    # ---- calls ----
    def _bind_call(self, e: Call) -> Bound:
        name = e.name
        if name in self._LAMBDA_FNS:
            return self._bind_lambda_fn(e)
        if name in self._ARRAY_FNS:
            args = [self.bind(a) for a in e.args]
            if name in ("split", "regexp_split", "regexp_extract_all"):
                return self._bind_split(e, args)
            return self._bind_array_fn(e, args)
        if name in ("and", "or"):
            return self._bind_logical(e)
        args = [self.bind(a) for a in e.args]
        if name == "not":
            (a,) = args

            def notfn(cols, valids):
                d, v = a.fn(cols, valids)
                return ~d, v
            return Bound(T.BOOLEAN, notfn)
        if name == "is_null":
            (a,) = args

            def infn(cols, valids):
                d, v = a.fn(cols, valids)
                if v is None:
                    return _const(d, False, torch.bool), None
                return ~v, None
            return Bound(T.BOOLEAN, infn)
        if name == "coalesce":
            return self._bind_coalesce(e, args)
        if name in ("eq", "ne", "lt", "le", "gt", "ge"):
            return self._bind_comparison(name, args)
        if name in ("add", "sub", "mul", "div", "mod"):
            return self._bind_arith(name, e.type, args)
        if name in _TSTZ_FNS:
            return self._bind_tstz(name, e, args)
        if name == "negate":
            (a,) = args
            if a.type.is_long_decimal:
                def neg128(cols, valids):
                    d, v = a.fn(cols, valids)
                    return _join2(*I128.neg(*_split2(d))), v
                return Bound(e.type, neg128)

            def negfn(cols, valids):
                d, v = a.fn(cols, valids)
                return -d, v
            return Bound(e.type, negfn, a.dictionary)
        if name in ("extract_year", "extract_month", "extract_day"):
            (a,) = args
            part = {"extract_year": F.extract_year,
                    "extract_month": F.extract_month,
                    "extract_day": F.extract_day}[name]

            def exfn(cols, valids):
                d, v = a.fn(cols, valids)
                return part(self._to_days(a, d)).to(torch.int64), v
            return Bound(T.BIGINT, exfn)
        if name == "like":
            return self._bind_like(e, args)
        if name in ("substr", "substring"):
            return self._bind_dict_transform(
                args[0], e,
                lambda s: self._py_substr(s, e.args[1], e.args[2] if len(e.args) > 2 else None),
            )
        if name in ("upper", "lower"):
            return self._bind_dict_transform(
                args[0], e, str.upper if name == "upper" else str.lower)
        if name in ("trim", "ltrim", "rtrim", "reverse"):
            pyf = {"trim": str.strip, "ltrim": str.lstrip,
                   "rtrim": str.rstrip, "reverse": lambda s: s[::-1]}[name]
            return self._bind_dict_transform(args[0], e, pyf)
        if name == "replace":
            frm = _literal(e, 1, "search")
            to = _literal(e, 2, "replacement") if len(e.args) > 2 else Literal("", T.VARCHAR)
            return self._bind_dict_transform(
                args[0], e, lambda s: s.replace(frm.value, to.value))
        if name == "length":
            return self._bind_dict_table(args[0], T.BIGINT, len, torch.int64)
        if name == "starts_with":
            prefix = _literal(e, 1, "prefix")
            return self._bind_dict_table(
                args[0], T.BOOLEAN, lambda v: v.startswith(prefix.value), torch.bool)
        if name == "concat":
            return self._bind_concat(e, args)
        if name == "nullif":
            return self._bind_nullif(e, args)
        if name in ("greatest", "least"):
            return self._bind_greatest_least(name, e, args)
        if name == "abs":
            (a,) = args
            if a.type.is_long_decimal:
                def abs128(cols, valids):
                    d, v = a.fn(cols, valids)
                    return _join2(*I128.abs_(*_split2(d))), v
                return Bound(e.type, abs128)

            def absfn(cols, valids):
                d, v = a.fn(cols, valids)
                return torch.abs(d), v
            return Bound(e.type, absfn)
        if name == "round":
            return self._bind_round(e, args)
        if name in ("hll_bucket", "hll_rho", "hll_weight", "hll_weight_rho",
                    "hll_estimate", "pctl_bucket"):
            return self._bind_sketch(name, e, args)
        for family in (self._bind_nested, self._bind_math, self._bind_bitwise,
                       self._bind_date, self._bind_string_breadth,
                       self._bind_registry_scalar):
            bound = family(name, e, args)
            if bound is not None:
                return bound
        raise NotImplementedError(f"scalar function {name}")

    # ---- math (MathFunctions analogues) ----
    def _bind_math(self, name: str, e: Call, args) -> Optional[Bound]:
        """Double-valued math: numeric arguments arrive in their physical
        form and are read as doubles first (a decimal descaled)."""
        if name in ("e", "pi", "nan", "infinity"):
            val = {"e": math.e, "pi": math.pi, "nan": float("nan"),
                   "infinity": float("inf")}[name]

            def cfn(cols, valids):
                return _const(_ref(cols), val, torch.float64), None
            return Bound(T.DOUBLE, cfn, const_value=val, is_const=True)
        if name == "rand":
            return self._bind_rand(args)
        if name in ("power", "atan2", "log"):
            a, b = args

            def bifn(cols, valids):
                da, va = a.fn(cols, valids)
                db, vb = b.fn(cols, valids)
                x, y = _as_f64(a, da), _as_f64(b, db)
                if name == "power":
                    out = torch.pow(x, y)
                elif name == "atan2":
                    out = torch.atan2(x, y)
                else:  # log(base, x)
                    out = torch.log(y) / torch.log(x)
                return out, merge_valid(va, vb)
            return Bound(T.DOUBLE, bifn)
        if name in ("log2", "log10"):
            a = args[0]
            lbase = math.log(2.0 if name == "log2" else 10.0)

            def lgfn(cols, valids):
                d, v = a.fn(cols, valids)
                return torch.log(_as_f64(a, d)) / lbase, v
            return Bound(T.DOUBLE, lgfn)
        if name == "sign":
            (a,) = args
            if a.type.is_long_decimal:
                raise _unsupported("sign over decimal(>18)")

            def sgfn(cols, valids):
                d, v = a.fn(cols, valids)
                out = _sign(d)
                if out.dtype.is_floating_point and not e.type.is_floating:
                    return _to_int(out, e.type.dtype), v
                return out.to(e.type.dtype), v
            return Bound(e.type, sgfn)
        if name == "cot":
            a = args[0]

            def cotfn(cols, valids):
                d, v = a.fn(cols, valids)
                return 1.0 / torch.tan(_as_f64(a, d)), v
            return Bound(T.DOUBLE, cotfn)
        if name in _PROB_FNS:
            pf = _PROB_FNS[name]

            def probfn(cols, valids):
                outs = [x.fn(cols, valids) for x in args]
                ds = [_as_f64(x, o[0]) for x, o in zip(args, outs)]
                return pf(*ds), merge_valid(*[o[1] for o in outs])
            return Bound(T.DOUBLE, probfn)
        if name == "width_bucket":
            lits = [x.const_value if x.is_const else None for x in args]
            if lits[1] is not None and lits[2] is not None \
                    and float(lits[1]) == float(lits[2]):
                raise ValueError("width_bucket bounds cannot equal each other")
            if lits[3] is not None and int(lits[3]) <= 0:
                raise ValueError("width_bucket bucketCount must be greater than 0")

            def wbfn(cols, valids):
                outs = [x.fn(cols, valids) for x in args]
                x, lo, hi, nb = (_as_f64(b, o[0]) for b, o in zip(args, outs))
                # frac clamps serve both bound orientations (reversed
                # bounds are descending buckets)
                frac = (x - lo) / (hi - lo)
                b = torch.floor(frac * nb) + 1
                b = torch.where(frac < 0, torch.zeros_like(b), b)
                b = torch.where(frac >= 1, nb + 1, b)
                return _to_int(b, torch.int64), merge_valid(*[o[1] for o in outs])
            return Bound(T.BIGINT, wbfn)
        if name in ("normal_cdf", "inverse_normal_cdf"):
            def ncfn(cols, valids):
                outs = [x.fn(cols, valids) for x in args]
                m, s, x = (_as_f64(b, o[0]) for b, o in zip(args, outs))
                if name == "normal_cdf":
                    out = 0.5 * (1.0 + torch.special.erf((x - m) / (s * math.sqrt(2.0))))
                else:
                    out = m + s * math.sqrt(2.0) * torch.special.erfinv(2.0 * x - 1.0)
                return out, merge_valid(*[o[1] for o in outs])
            return Bound(T.DOUBLE, ncfn)
        if name in ("sqrt", "ln", "exp", "floor", "ceil"):
            a = args[0]
            jf = {"sqrt": F.sqrt_exact, "ln": torch.log, "exp": torch.exp,
                  "floor": torch.floor, "ceil": torch.ceil}[name]

            def mfn(cols, valids):
                d, v = a.fn(cols, valids)
                return jf(_as_f64(a, d)), v
            out = Bound(T.DOUBLE, mfn)
            if e.type.is_decimal:
                return self._coerce_bound(out, e.type)
            if e.type.is_integerlike:
                def ifn(cols, valids):
                    d, v = mfn(cols, valids)
                    return _to_int(d, e.type.dtype), v
                return Bound(e.type, ifn)
            return out
        if name in _UNARY_DOUBLE_FNS:
            a = args[0]
            jf = _UNARY_DOUBLE_FNS[name]

            def udfn(cols, valids):
                d, v = a.fn(cols, valids)
                return jf(_as_f64(a, d)), v
            return Bound(T.DOUBLE, udfn)
        if name in ("is_nan", "is_infinite", "is_finite"):
            (a,) = args
            jf = {"is_nan": torch.isnan, "is_infinite": torch.isinf,
                  "is_finite": torch.isfinite}[name]

            def ckfn(cols, valids):
                d, v = a.fn(cols, valids)
                return jf(_as_f64(a, d)), v
            return Bound(T.BOOLEAN, ckfn)
        if name == "truncate":
            return self._bind_truncate(e, args)
        return None

    def _bind_rand(self, args) -> Bound:
        """rand() / rand(n) / rand(lo, hi): uniform draws from a
        torch.Generator per device, seeded once per bind from the OS, so
        every batch draws new values (the reference folds the batch's
        content into a JAX key; the draws cannot equal it)."""
        seed = int.from_bytes(os.urandom(8), "little") & ((1 << 63) - 1)
        gens: dict = {}

        def rndfn(cols, valids):
            ref = _ref(cols)
            gen = gens.get(ref.device)
            if gen is None:
                gen = gens[ref.device] = torch.Generator(device=ref.device)
                gen.manual_seed(seed)
            u = torch.rand(ref.shape[0], generator=gen, dtype=torch.float64,
                           device=ref.device)
            if not args:
                return u, None
            vs = [b.fn(cols, valids) for b in args]
            v = merge_valid(*[x[1] for x in vs])
            if len(vs) == 1:
                return torch.floor(u * vs[0][0].to(torch.float64)).to(torch.int64), v
            lo = vs[0][0].to(torch.float64)
            hi = vs[1][0].to(torch.float64)
            return (lo + torch.floor(u * (hi - lo))).to(torch.int64), v
        return Bound(T.DOUBLE if not args else T.BIGINT, rndfn)

    def _bind_truncate(self, e: Call, args) -> Bound:
        """truncate(x[, d]): toward zero; a decimal keeps its scale."""
        a = args[0]
        ndig = 0
        if len(args) > 1:
            if not args[1].is_const:
                raise _unsupported("truncate() with a non-constant scale")
            ndig = int(args[1].const_value)
        if a.type.is_long_decimal:
            raise _unsupported("truncate over decimal(>18)")
        if a.type.is_decimal:
            s = a.type.scale or 0
            if ndig >= s:
                return Bound(e.type, a.fn)
            m = 10 ** (s - ndig)

            def tdfn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return F.div_trunc(d, _const(d, m, d.dtype)) * m, v
            return Bound(e.type, tdfn)
        sf = 10.0 ** ndig

        def trfn(cols, valids, afn=a.fn):
            d, v = afn(cols, valids)
            x = d.to(torch.float64) * sf
            return _sign(x) * torch.floor(torch.abs(x)) / sf, v
        return Bound(T.DOUBLE, trfn)

    # ---- bitwise (BitwiseFunctions analogues) on the 64-bit pattern ----
    def _bind_bitwise(self, name: str, e: Call, args) -> Optional[Bound]:
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_left_shift", "bitwise_right_shift",
                    "bitwise_right_shift_arithmetic"):
            a, b = args
            op = {"bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
                  "bitwise_xor": torch.bitwise_xor, "bitwise_left_shift": _shift_left,
                  "bitwise_right_shift": _shift_right_logical,
                  "bitwise_right_shift_arithmetic": _shift_right_arithmetic}[name]

            def bwfn(cols, valids):
                x, xv = a.fn(cols, valids)
                s, sv = b.fn(cols, valids)
                return op(x.to(torch.int64), s.to(torch.int64)), merge_valid(xv, sv)
            return Bound(T.BIGINT, bwfn)
        if name == "bitwise_not":
            (a,) = args

            def bnfn(cols, valids):
                d, v = a.fn(cols, valids)
                return torch.bitwise_not(d.to(torch.int64)), v
            return Bound(T.BIGINT, bnfn)
        if name == "bit_count":
            a = args[0]
            bits = 64
            if len(e.args) > 1 and isinstance(e.args[1], Literal):
                bits = int(e.args[1].value)

            def bcfn(cols, valids):
                d, v = a.fn(cols, valids)
                x = d.to(torch.int64)
                if bits < 64:  # count within the low `bits` only
                    x = x & ((1 << bits) - 1)
                return _popcount64(x), v
            return Bound(T.BIGINT, bcfn)
        return None

    # ---- date and time (DateTimeFunctions analogues) ----
    @staticmethod
    def _to_days(a: Bound, data: torch.Tensor) -> torch.Tensor:
        """DATE (epoch days) or TIMESTAMP (epoch micros) -> epoch days."""
        if a.type.kind == T.TypeKind.TIMESTAMP:
            return torch.div(data, _MICROS_PER_DAY, rounding_mode="floor")
        return data

    def _bind_date(self, name: str, e: Call, args) -> Optional[Bound]:
        if name in ("quarter", "week", "day_of_week", "day_of_year", "year_of_week"):
            a = args[0]
            part = {"quarter": lambda d: torch.div(F.extract_month(d) - 1, 3,
                                                   rounding_mode="floor") + 1,
                    "week": F.week_of_year, "day_of_week": F.day_of_week,
                    "day_of_year": F.day_of_year, "year_of_week": F.year_of_week}[name]

            def dpfn(cols, valids):
                d, v = a.fn(cols, valids)
                return part(self._to_days(a, d)).to(torch.int64), v
            return Bound(T.BIGINT, dpfn)
        if name == "date_trunc":
            u = _literal(e, 0, "unit").value.lower()
            a = args[1]
            if a.type.kind == T.TypeKind.TIMESTAMP:
                def ttfn(cols, valids):
                    d, v = a.fn(cols, valids)
                    if u in _MICROS_PER_UNIT:
                        q = _MICROS_PER_UNIT[u]
                        return torch.div(d, q, rounding_mode="floor") * q, v
                    days = F.date_trunc_days(u, self._to_days(a, d))
                    return days.to(torch.int64) * _MICROS_PER_DAY, v
                return Bound(T.TIMESTAMP, ttfn)

            def tdfn(cols, valids):
                d, v = a.fn(cols, valids)
                return F.date_trunc_days(u, d).to(a.type.dtype), v
            return Bound(a.type, tdfn)
        if name == "date_add":
            u = _literal(e, 0, "unit").value.lower()
            nb, a = args[1], args[2]
            if a.type.kind == T.TypeKind.TIMESTAMP:
                def tafn(cols, valids):
                    d, v = a.fn(cols, valids)
                    n, vn = nb.fn(cols, valids)
                    if u in _MICROS_PER_UNIT:
                        out = d + n.to(torch.int64) * _MICROS_PER_UNIT[u]
                    else:
                        rem = torch.remainder(d, _MICROS_PER_DAY)
                        days = F.date_add_days(u, n, self._to_days(a, d))
                        out = days.to(torch.int64) * _MICROS_PER_DAY + rem
                    return out, merge_valid(v, vn)
                return Bound(T.TIMESTAMP, tafn)

            def dafn(cols, valids):
                d, v = a.fn(cols, valids)
                n, vn = nb.fn(cols, valids)
                return F.date_add_days(u, n, d).to(a.type.dtype), merge_valid(v, vn)
            return Bound(a.type, dafn)
        if name == "date_diff":
            u = _literal(e, 0, "unit").value.lower()
            a, b = args[1], args[2]
            if u in _MICROS_PER_UNIT and a.type.kind != T.TypeKind.TIMESTAMP:
                raise _unsupported(f"date_diff('{u}') over {a.type}")

            def ddfn(cols, valids):
                da, va = a.fn(cols, valids)
                db, vb = b.fn(cols, valids)
                if u in _MICROS_PER_UNIT:
                    out = F.div_trunc(db - da, _const(da, _MICROS_PER_UNIT[u], torch.int64))
                else:
                    out = F.date_diff_days(u, self._to_days(a, da), self._to_days(b, db))
                return out.to(torch.int64), merge_valid(va, vb)
            return Bound(T.BIGINT, ddfn)
        if name == "last_day_of_month":
            a = args[0]

            def ldfn(cols, valids):
                d, v = a.fn(cols, valids)
                return F.last_day_of_month_days(self._to_days(a, d)).to(T.DATE.dtype), v
            return Bound(T.DATE, ldfn)
        if name in ("hour", "minute", "second", "millisecond"):
            a = args[0]
            div = {"hour": (3600 * 10 ** 6, 24), "minute": (60 * 10 ** 6, 60),
                   "second": (10 ** 6, 60), "millisecond": (1000, 1000)}[name]

            def tmfn(cols, valids):
                d, v = a.fn(cols, valids)
                if a.type.kind == T.TypeKind.TIMESTAMP:
                    us = torch.remainder(d.to(torch.int64), _MICROS_PER_DAY)
                else:  # a DATE has no time of day
                    us = torch.zeros_like(d, dtype=torch.int64)
                return torch.remainder(torch.div(us, div[0], rounding_mode="floor"),
                                       div[1]), v
            return Bound(T.BIGINT, tmfn)
        if name == "from_unixtime_nanos":
            a = args[0]

            def funfn(cols, valids):
                d, v = a.fn(cols, valids)
                # floor: -1 ns is microsecond -1
                return torch.div(d.to(torch.int64), 1000, rounding_mode="floor"), v
            return Bound(T.TIMESTAMP, funfn)
        if name in ("timezone_hour", "timezone_minute"):
            # a TIMESTAMP (no zone) is a UTC wall clock: offset 0
            a = args[0]

            def tzfn(cols, valids):
                d, v = a.fn(cols, valids)
                return torch.zeros(d.shape[:1], dtype=torch.int64, device=d.device), v
            return Bound(T.BIGINT, tzfn)
        if name == "from_unixtime":
            a = args[0]

            def fufn(cols, valids):
                d, v = a.fn(cols, valids)
                # round half to even to the microsecond (rint), so a
                # negative fractional epoch rounds to the nearest one
                return _to_int(torch.round(_as_f64(a, d) * 1e6), torch.int64), v
            return Bound(T.TIMESTAMP, fufn)
        if name == "to_unixtime":
            a = args[0]

            def tufn(cols, valids):
                d, v = a.fn(cols, valids)
                us = d.to(torch.float64)
                if a.type.kind == T.TypeKind.DATE:
                    return us * 86400.0, v
                return us / 1e6, v
            return Bound(T.DOUBLE, tufn)
        if name == "date_parse":
            fmt = e.args[1].value if len(e.args) > 1 else "%Y-%m-%d"
            # MySQL-style tokens -> strptime (the subset that maps 1:1)
            py = fmt.replace("%i", "%M").replace("%s", "%S")

            def dpfn(s):
                try:
                    dt = _dt.datetime.strptime(s, py)
                except ValueError:
                    return None
                return int((dt - _dt.datetime(1970, 1, 1)).total_seconds() * 1e6)
            return self._bind_dict_table_nullable(args[0], T.TIMESTAMP, dpfn, torch.int64)
        if name == "from_iso8601_date":
            return self._bind_dict_table(
                args[0], T.DATE,
                lambda s: (_dt.date.fromisoformat(s) - F.EPOCH).days, T.DATE.dtype)
        if name in ("from_iso8601_timestamp", "from_iso8601_timestamp_nanos"):
            trim = name.endswith("nanos")
            return self._bind_dict_table_nullable(
                args[0], T.TIMESTAMP, lambda s: pyfns.iso_to_micros(s, trim_nanos=trim),
                torch.int64)
        if name in ("parse_datetime", "to_timestamp", "to_date"):
            fmt = _literal(e, 1, "format")
            out_t = T.DATE if name == "to_date" else T.TIMESTAMP
            if fmt.value is None:
                return self._null_of(args[0], out_t)
            py = (pyfns.joda_to_strptime(fmt.value) if name == "parse_datetime"
                  else pyfns.oracle_to_strptime(fmt.value))

            def pdfn(s):
                try:
                    dt = _dt.datetime.strptime(s, py)
                except ValueError:
                    return None  # the reference's NULL divergence (Trino raises)
                if name == "to_date":
                    return (dt.date() - F.EPOCH).days
                return pyfns.dt_to_micros(dt)
            return self._bind_dict_table_nullable(args[0], out_t, pdfn, out_t.dtype)
        return None

    # ---- string and regexp functions over dictionary values ----
    def _bind_string_breadth(self, name: str, e: Call, args) -> Optional[Bound]:
        """Each is a Python function over the dictionary's values on the
        host, then a code remap (or table lookup) on the device."""
        if name in ("strpos", "strrpos", "index"):
            sub = _literal(e, 1, "substring")
            if sub.value is None:
                return self._null_of(args[0], T.BIGINT)
            t = sub.value
            finder = (lambda s: s.rfind(t) + 1) if name == "strrpos" \
                else (lambda s: s.find(t) + 1)
            return self._bind_dict_table(args[0], T.BIGINT, finder, torch.int64)
        if name == "ends_with":
            suffix = _literal(e, 1, "suffix")
            return self._bind_dict_table(
                args[0], T.BOOLEAN, lambda s: s.endswith(suffix.value), torch.bool)
        if name == "codepoint":
            # the empty string has no code point: NULL (Trino raises)
            return self._bind_dict_table_nullable(
                args[0], T.BIGINT, lambda s: ord(s[0]) if s else None, torch.int64)
        if name == "split_part":
            delim, idx = _literal(e, 1, "delimiter"), _literal(e, 2, "index")
            n = int(idx.value)
            if n < 1:
                raise _unsupported("split_part() with an index below 1")

            def sp(s: str) -> str:
                parts = s.split(delim.value)
                return parts[n - 1] if n <= len(parts) else ""
            return self._bind_dict_transform(args[0], e, sp)
        if name in ("lpad", "rpad"):
            size = _literal(e, 1, "size")
            pad = _literal(e, 2, "padstring") if len(e.args) > 2 else Literal(" ", T.VARCHAR)
            width, fill = int(size.value), pad.value or " "

            def padfn(s: str) -> str:
                if len(s) >= width:
                    return s[:width]
                need = width - len(s)
                padding = (fill * need)[:need]
                return padding + s if name == "lpad" else s + padding
            return self._bind_dict_transform(args[0], e, padfn)
        if name == "translate":
            frm, to = _literal(e, 1, "from"), _literal(e, 2, "to")
            table: dict = {}
            for i, c in enumerate(frm.value):
                if c not in table:
                    table[c] = to.value[i] if i < len(to.value) else None

            def trl(s: str) -> str:
                return "".join(table.get(c, c) for c in s if table.get(c, c) is not None)
            return self._bind_dict_transform(args[0], e, trl)
        if name in ("regexp_like", "regexp_count", "regexp_position"):
            rx = _re.compile(_literal(e, 1, "pattern").value)
            if name == "regexp_like":
                return self._bind_dict_table(
                    args[0], T.BOOLEAN, lambda s: rx.search(s) is not None, torch.bool)
            if name == "regexp_count":
                return self._bind_dict_table(
                    args[0], T.BIGINT, lambda s: sum(1 for _ in rx.finditer(s)),
                    torch.int64)

            def rpfn(s):
                m = rx.search(s)
                return m.start() + 1 if m else -1
            return self._bind_dict_table(args[0], T.BIGINT, rpfn, torch.int64)
        if name == "regexp_extract":
            rx = _re.compile(_literal(e, 1, "pattern").value)
            group = int(_literal(e, 2, "group").value) if len(e.args) > 2 else 0

            def rex(s):  # NULL where nothing (or no such group) matches
                m = rx.search(s)
                if m is None or (group and m.group(group) is None):
                    return None
                return m.group(group)
            return self._bind_dict_transform_nullable(args[0], e, rex)
        if name == "regexp_replace":
            rx = _re.compile(_literal(e, 1, "pattern").value)
            rep = _literal(e, 2, "replacement") if len(e.args) > 2 else Literal("", T.VARCHAR)
            segs = _replacement_segments(rep.value)

            def rrepl(m):
                return "".join(s if isinstance(s, str) else (m.group(s) or "")
                               for s in segs)
            return self._bind_dict_transform(args[0], e, lambda s: rx.sub(rrepl, s))
        if name in ("soundex", "normalize"):
            pyf = _py_soundex if name == "soundex" \
                else (lambda s: unicodedata.normalize("NFC", s))
            return self._bind_dict_transform(args[0], e, pyf)
        if name in ("levenshtein_distance", "hamming_distance"):
            t = _literal(e, 1, "second argument").value
            if name == "hamming_distance":
                # NULL for a value of another length, which the query may
                # never select (Trino raises per row)
                return self._bind_dict_table_nullable(
                    args[0], T.BIGINT,
                    lambda s: sum(x != y for x, y in zip(s, t)) if len(s) == len(t) else None,
                    torch.int64)
            return self._bind_dict_table(
                args[0], T.BIGINT, lambda s: _levenshtein(s, t), torch.int64)
        if name == "luhn_check":
            return self._bind_dict_table(args[0], T.BOOLEAN, _luhn, torch.bool)
        if name == "word_stem":
            return self._bind_dict_transform(args[0], e, pyfns.porter_stem)
        if name == "char2hexint":
            return self._bind_dict_transform(
                args[0], e, lambda s: s.encode("utf-16-be").hex().upper())
        if name == "from_base":
            radix = _literal(e, 1, "radix")
            if radix.value is None:
                return self._null_of(args[0], T.BIGINT)
            r = int(radix.value)
            if not 2 <= r <= 36:
                raise ValueError("from_base() radix must be in [2, 36]")

            def fb(s):
                try:
                    return int(s, r)
                except ValueError:
                    return None  # the reference's NULL divergence (Trino raises)
            return self._bind_dict_table_nullable(args[0], T.BIGINT, fb, torch.int64)
        if name in ("to_utf8", "from_utf8"):
            # the varbinary carrier is utf-8-decoded varchar, so both
            # directions normalize through encode/decode
            return self._bind_dict_transform(
                args[0], e, lambda s: s.encode("utf-8").decode("utf-8", "replace"))
        return None

    # ---- hashing, encodings, url and json (expr/registry.py breadth) ----
    def _bind_registry_scalar(self, name: str, e: Call, args) -> Optional[Bound]:
        if name in ("md5", "sha1", "sha256", "sha512"):
            return self._bind_dict_transform(
                args[0], e, lambda s: _hashlib.new(name, s.encode()).hexdigest())
        if name in ("hmac_md5", "hmac_sha1", "hmac_sha256", "hmac_sha512"):
            key = _literal(e, 1, "key")
            if key.value is None:
                return self._null_of(args[0], e.type)
            k, algo = key.value.encode(), name[5:]
            return self._bind_dict_transform(
                args[0], e, lambda s: _hmac.new(k, s.encode(), algo).hexdigest())
        if name == "xxhash64":
            return self._bind_dict_transform(
                args[0], e, lambda s: format(pyfns.xxhash64(s.encode()), "016x"))
        if name == "murmur3":
            return self._bind_dict_transform(
                args[0], e, lambda s: pyfns.murmur3_x64_128(s.encode()).hex())
        if name == "crc32":
            return self._bind_dict_table(
                args[0], T.BIGINT, lambda s: _zlib.crc32(s.encode()), torch.int64)
        codecs = {
            "to_hex": lambda s: s.encode().hex().upper(),
            "from_hex": lambda s: bytes.fromhex(s).decode("utf-8", "replace"),
            "to_base64": lambda s: _b64.b64encode(s.encode()).decode(),
            "from_base64": lambda s: _b64.b64decode(s.encode()).decode("utf-8", "replace"),
            "to_base32": lambda s: _b64.b32encode(s.encode()).decode(),
            "to_base64url": lambda s: _b64.urlsafe_b64encode(s.encode()).decode(),
        }
        if name in codecs:
            return self._bind_dict_transform(args[0], e, codecs[name])
        if name in ("from_base32", "from_base64url"):
            dec = _b64.b32decode if name == "from_base32" else _b64.urlsafe_b64decode
            return self._bind_dict_transform_nullable(
                args[0], e, lambda s: _try_decode(lambda: dec(s.encode())))
        if name in ("from_big_endian_32", "from_big_endian_64"):
            want = 4 if name.endswith("32") else 8

            def befn(s):
                b = s.encode()
                # a wrong width is NULL (the reference's divergence: Trino raises)
                return int.from_bytes(b, "big", signed=True) if len(b) == want else None
            return self._bind_dict_table_nullable(args[0], T.BIGINT, befn, torch.int64)
        if name in ("from_ieee754_32", "from_ieee754_64"):
            want, code = (4, ">f") if name.endswith("32") else (8, ">d")

            def ieeefn(s):
                b = s.encode()
                return _struct.unpack(code, b)[0] if len(b) == want else None
            return self._bind_dict_table_nullable(args[0], T.DOUBLE, ieeefn, torch.float64)
        if name == "checksum_hash":
            return self._bind_checksum_hash(args[0])
        if name.startswith("url_"):
            return self._bind_url_fn(name, e, args)
        if name in ("json_extract_scalar", "json_array_length", "json_size"):
            return self._bind_json_fn(name, e, args)
        if name in ("json_extract", "json_format", "json_parse",
                    "is_json_scalar", "json_array_contains", "json_array_get"):
            return self._bind_json_breadth(name, e, args)
        return None

    def _bind_checksum_hash(self, a: Bound) -> Bound:
        """Per-row 62-bit value hash for checksum(): a string hashes its
        value, and NULL hashes to a constant lane, never NULL itself, so
        the sum counts every row (ChecksumAggregationFunction)."""
        lut = dictionary_lut(a.dictionary)
        lut_t = None if lut is None else _Table(torch.from_numpy(lut.astype(np.int64)))

        def ckfn(cols, valids):
            d, v = a.fn(cols, valids)
            if lut_t is not None:
                d = canonical_hash_input(d, lut_t.on(d.device))
            return hash64([d], [v]), None
        return Bound(T.BIGINT, ckfn)

    def _bind_url_fn(self, name: str, e: Call, args) -> Bound:
        if name == "url_encode":
            return self._bind_dict_transform(args[0], e, lambda s: quote(s, safe=""))
        if name == "url_decode":
            return self._bind_dict_transform(args[0], e, unquote)
        if name == "url_extract_parameter":
            p = _literal(e, 1, "name").value

            def param(s):
                try:
                    vals = parse_qs(urlsplit(s).query, keep_blank_values=True).get(p)
                except ValueError:
                    return None
                return vals[0] if vals else None
            return self._bind_dict_transform_nullable(args[0], e, param)

        def part(s):
            try:
                u = urlsplit(s)
                if name == "url_extract_port":
                    return u.port  # ValueError on ':abc' ports
            except ValueError:
                return None
            if name == "url_extract_protocol":
                return u.scheme or None
            if name == "url_extract_host":
                return u.hostname
            if name == "url_extract_path":
                return u.path
            if name == "url_extract_query":
                return u.query if "?" in s else None
            if name == "url_extract_fragment":
                return u.fragment if "#" in s else None
            return None

        if name == "url_extract_port":
            return self._bind_dict_table_nullable(args[0], T.BIGINT, part, torch.int64)
        return self._bind_dict_transform_nullable(args[0], e, part)

    def _bind_json_fn(self, name: str, e: Call, args) -> Bound:
        """json_extract_scalar, json_array_length and json_size over the
        JSON text of each dictionary value (JsonFunctions' lenient
        semantics: NULL on any miss)."""
        if name == "json_array_length":
            def jal(s):
                v = _json_loads(s)
                return len(v) if isinstance(v, list) else None
            return self._bind_dict_table_nullable(args[0], T.BIGINT, jal, torch.int64)
        path = _literal(e, 1, "path").value
        if name == "json_size":
            def jsz(s):
                v = _json_nav(s, path)
                if v is _MISS:
                    return None
                return len(v) if isinstance(v, (dict, list)) else 0
            return self._bind_dict_table_nullable(args[0], T.BIGINT, jsz, torch.int64)

        def jes(s):
            v = _json_nav(s, path, keep_tokens=True)
            if v is _MISS or v is None or isinstance(v, (dict, list)):
                return None
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)  # numbers are their literal tokens
        return self._bind_dict_transform_nullable(args[0], e, jes)

    def _bind_json_breadth(self, name: str, e: Call, args) -> Bound:
        """json_extract (JSON text out), json_format/json_parse,
        is_json_scalar, json_array_contains and json_array_get."""
        if name == "is_json_scalar":
            def ijs(s):
                v = _json_loads(s)
                return None if v is _MISS else not isinstance(v, (dict, list))
            return self._bind_dict_table_nullable(args[0], T.BOOLEAN, ijs, torch.bool)
        if name in ("json_format", "json_parse"):
            # both canonicalize the document text; invalid text is NULL
            def jfmt(s):
                v = _json_loads(s)
                return None if v is _MISS else _json.dumps(v, separators=(",", ":"))
            return self._bind_dict_transform_nullable(args[0], e, jfmt)
        if name == "json_array_contains":
            want = _literal(e, 1, "value").value

            def jac(s):
                v = _json_loads(s)
                if not isinstance(v, list):
                    return None
                return any(
                    type(x) is type(want) and x == want if isinstance(want, bool)
                    else (not isinstance(x, bool) and x == want)
                    for x in v)
            return self._bind_dict_table_nullable(args[0], T.BOOLEAN, jac, torch.bool)
        if name == "json_array_get":
            i = int(_literal(e, 1, "index").value)

            def jag(s):
                v = _json_loads(s)
                if not isinstance(v, list) or not (-len(v) <= i < len(v)):
                    return None
                return _json.dumps(v[i], separators=(",", ":"))
            return self._bind_dict_transform_nullable(args[0], e, jag)
        # json_extract: the JSON text of the node the path names
        path = _literal(e, 1, "path").value

        def jex(s):
            v = _json_nav(s, path)
            return None if v is _MISS else _json.dumps(v, separators=(",", ":"))
        return self._bind_dict_transform_nullable(args[0], e, jex)

    def _bind_dict_transform_nullable(self, a: Bound, e, pyfn) -> Bound:
        """_bind_dict_transform where pyfn may return None -> NULL: the
        validity is a second per-code table ANDed into the mask."""
        if a.dictionary is None or len(a.dictionary) == 0:
            return self._null_of(a, e.type)
        transformed = [pyfn(v) for v in a.dictionary.values]
        texts = [t if t is not None else "" for t in transformed]
        new_dict = Dictionary(texts)
        remap = _table([new_dict.code(t) for t in texts], torch.int32)
        valid_tbl = _table([t is not None for t in transformed], torch.bool)

        def fn(cols, valids):
            d, v = a.fn(cols, valids)
            ok = _lookup(valid_tbl, d)
            return _lookup(remap, d), ok if v is None else (v & ok)
        return Bound(e.type, fn, new_dict)

    def _bind_dict_table_nullable(self, a: Bound, out_type, pyfn, dtype) -> Bound:
        """_bind_dict_table where pyfn may return None -> NULL."""
        if a.dictionary is None or len(a.dictionary) == 0:
            return self._null_of(a, out_type)
        results = [pyfn(v) for v in a.dictionary.values]
        table = _table([r if r is not None else 0 for r in results], dtype)
        valid_tbl = _table([r is not None for r in results], torch.bool)

        def fn(cols, valids):
            d, v = a.fn(cols, valids)
            ok = _lookup(valid_tbl, d)
            return _lookup(table, d), ok if v is None else (v & ok)
        return Bound(out_type, fn)

    # ---- sketch primitives of the approx_distinct/percentile rewrites ----
    def _bind_sketch(self, name: str, e: Call, args) -> Bound:
        """The expressions sql/optimizer's RewriteApproxDistinct and
        RewriteApproxPercentile emit, bit-equal to the reference:
        hll_bucket/hll_rho/hll_weight split a value's 62-bit hash into
        an HLL register (low 11 bits), its leading-zero rank rho in the
        next 51 bits, and 2^-rho; hll_weight_rho weighs a merged register
        and hll_estimate finalizes; pctl_bucket is the quantile-sketch
        bucket of a value."""
        if name in ("hll_bucket", "hll_rho", "hll_weight"):
            (a,) = args
            # strings hash their dictionary VALUE, so batches with other
            # dictionaries agree
            vh = None
            if a.dictionary is not None and len(a.dictionary) > 0:
                vh = _Table(torch.from_numpy(
                    dictionary_code_hashes(a.dictionary.values).astype(np.int64)))

            def hllfn(cols, valids):
                d, v = a.fn(cols, valids)
                basis = d if vh is None else _lookup(vh, d)
                h = hash64([basis], [v])
                if name == "hll_bucket":
                    return h & 2047, v
                w51 = (h >> 11).to(torch.float64)
                rho = torch.where(
                    w51 > 0,
                    51 - torch.floor(torch.log2(torch.clamp(w51, min=1.0))).to(torch.int64),
                    _const(h, 52, torch.int64),
                )
                if name == "hll_rho":
                    return rho, v
                return torch.exp2(-rho.to(torch.float64)), v
            return Bound(e.type, hllfn)
        if name == "pctl_bucket":
            (a,) = args

            def pbfn(cols, valids):
                d, v = a.fn(cols, valids)
                enc = f32_bits_ordered(d.to(torch.float64).to(torch.float32))
                return enc >> 14, v
            return Bound(T.BIGINT, pbfn)
        if name == "hll_weight_rho":
            # (merged max-rho, bucket) -> register weight 2^-rho; the
            # NULL-bucket group (all-NULL inputs) weighs 0
            r, b = args

            def hwfn(cols, valids):
                rd, rv = r.fn(cols, valids)
                _, bv = b.fn(cols, valids)
                ok = merge_valid(rv, bv)
                w = torch.exp2(-rd.to(torch.float64))
                if ok is not None:
                    w = torch.where(ok, w, _const(w, 0.0, torch.float64))
                return w, None
            return Bound(T.DOUBLE, hwfn)
        # hll_estimate: raw = alpha_m * m^2 / (sum_w + zero registers),
        # linear counting in the small range
        m = 2048.0
        alpha = 0.7213 / (1.0 + 1.079 / m)
        sw, cnt = args

        def hefn(cols, valids):
            s, sv = sw.fn(cols, valids)
            c, cv = cnt.fn(cols, valids)
            zeros = m - c.to(torch.float64)
            raw = alpha * m * m / (s.to(torch.float64) + zeros)
            small = (raw <= 2.5 * m) & (zeros > 0)
            est = torch.where(
                small, m * torch.log(m / torch.clamp(zeros, min=1.0)), raw
            )
            out = torch.round(est).to(torch.int64)
            ok = merge_valid(sv, cv)  # NULL states estimate 0
            if ok is not None:
                out = torch.where(ok, out, _const(out, 0, torch.int64))
            return out, None
        return Bound(e.type, hefn)

    # ---- string functions on dictionary columns ----
    @staticmethod
    def _py_substr(s: str, start_lit: Expr, len_lit: Optional[Expr]) -> str:
        """Trino substr: 1-based; a negative start counts from the end; a
        start of 0 yields the empty string (StringFunctions.substr)."""
        start = int(start_lit.value)
        n = int(len_lit.value) if len_lit is not None else None
        if start == 0:
            return ""
        begin = start - 1 if start > 0 else max(len(s) + start, 0)
        if start < 0 and len(s) + start < 0:
            return ""
        end = len(s) if n is None else begin + max(n, 0)
        return s[begin:end]

    def _null_of(self, ref: Bound, out_type: T.DataType) -> Bound:
        """An all-NULL result of `out_type` (a string function over an
        input with no dictionary values, e.g. a NULL literal)."""
        if isinstance(ref.dictionary, RuntimeDictionary):
            raise NotImplementedError(
                "expressions over execution-time dictionary strings (listagg"
                " output) are not supported")

        def fn(cols, valids, rfn=ref.fn):
            d, _ = rfn(cols, valids)
            return _phys_const(d, out_type), _const(d, False, torch.bool)
        return Bound(out_type, fn, Dictionary([]) if out_type.is_string else None)

    def _bind_dict_transform(self, a: Bound, e: Call, pyfn) -> Bound:
        """String function on a dictionary column: transform the |dict|
        values on the host, remap the codes on the device
        (DictionaryAwarePageProjection analogue). The new dictionary is
        sorted, so several values may map to one code."""
        if a.dictionary is None or len(a.dictionary) == 0:  # NULL-only input
            return self._null_of(a, e.type)
        transformed = [pyfn(v) for v in a.dictionary.values]
        new_dict = Dictionary(transformed)
        remap = _table([new_dict.code(t) for t in transformed], torch.int32)

        def fn(cols, valids):
            d, v = a.fn(cols, valids)
            return _lookup(remap, d), v
        return Bound(e.type, fn, new_dict)

    def _bind_dict_table(self, a: Bound, out_type: T.DataType, pyfn, dtype) -> Bound:
        """A non-string function of a string: one table entry per
        dictionary value, looked up by code."""
        if a.dictionary is None or len(a.dictionary) == 0:
            return self._null_of(a, out_type)
        table = _table([pyfn(v) for v in a.dictionary.values], dtype)

        def fn(cols, valids):
            d, v = a.fn(cols, valids)
            return _lookup(table, d), v
        return Bound(out_type, fn)

    def _bind_concat(self, e: Call, args) -> Bound:
        """String concatenation on dictionary columns. A constant operand
        folds into a dictionary transform; two dictionary operands build
        the pairwise dictionary (bounded) with codes ca * |B| + cb."""
        if len(args) > 2:
            # left-fold longer chains into pairwise concats
            acc = args[0]
            for i in range(1, len(args)):
                pair = Call("concat", (e.args[0], e.args[i]), T.VARCHAR)
                acc = self._bind_concat(pair, [acc, args[i]])
            return acc
        a, b = args
        if b.is_const:
            suffix = b.const_value or ""
            return self._bind_dict_transform(a, e, lambda s: s + suffix)
        if a.is_const:
            prefix = a.const_value or ""
            return self._bind_dict_transform(b, e, lambda s: prefix + s)
        if a.dictionary is None or b.dictionary is None:
            return self._null_of(a, T.VARCHAR)
        da, db = a.dictionary, b.dictionary
        if len(da) * len(db) > 1 << 18:
            raise NotImplementedError("concat of two high-cardinality string columns")
        pairs = [x + y for x in da.values for y in db.values]
        new_dict = Dictionary(pairs)
        remap = _table([new_dict.code(p) for p in pairs], torch.int32)
        nb = len(db)

        def fn(cols, valids):
            dca, va = a.fn(cols, valids)
            dcb, vb = b.fn(cols, valids)
            ca = torch.clamp(dca.to(torch.int64), 0, len(da) - 1)
            cb = torch.clamp(dcb.to(torch.int64), 0, nb - 1)
            return _lookup(remap, ca * nb + cb), merge_valid(va, vb)
        return Bound(T.VARCHAR, fn, new_dict)

    def _bind_nullif(self, e: Call, args) -> Bound:
        """nullif(a, b): a, NULL where a = b. Equality goes through the
        comparison binder, so dictionaries unify and decimals rescale;
        the result keeps a's representation."""
        a, b = args
        eqb = self._bind_comparison("eq", [a, b])

        def fn(cols, valids):
            da, va = a.fn(cols, valids)
            de, ve = eqb.fn(cols, valids)
            eq = de if ve is None else (de & ve)
            v = va if va is not None else _const(da, True, torch.bool)
            return da, v & ~eq
        return Bound(e.type, fn, a.dictionary)

    def _bind_greatest_least(self, name: str, e: Call, args) -> Bound:
        """greatest/least; any NULL argument makes the result NULL.
        Strings compare as codes of one unified (sorted) dictionary."""
        pick = torch.maximum if name == "greatest" else torch.minimum
        out_dict = None
        if e.type.is_string:
            merged = None
            for a in args:
                if a.dictionary is not None:
                    merged = (a.dictionary if merged is None
                              else Dictionary.unify(merged, a.dictionary)[0])
            if merged is None:
                return self._null_of(args[0], e.type)
            args = [self._remap_to(a, merged) for a in args]
            out_dict = merged
        elif e.type.is_long_decimal:
            return self._bind_greatest_least128(name, e, args)
        out_t = e.type

        def fn(cols, valids):
            data, valid = args[0].fn(cols, valids)
            data = data.to(out_t.dtype)
            for a in args[1:]:
                d, v = a.fn(cols, valids)
                data = pick(data, d.to(out_t.dtype))
                valid = merge_valid(valid, v)
            return data, valid
        return Bound(out_t, fn, out_dict)

    def _bind_greatest_least128(self, name: str, e: Call, args) -> Bound:
        """greatest/least over decimal(>18): each argument at the
        result's scale, compared as signed 128-bit limb pairs."""
        args = [self._coerce_bound(a, e.type) for a in args]

        def fn(cols, valids):
            data, valid = args[0].fn(cols, valids)
            for a in args[1:]:
                d, v = a.fn(cols, valids)
                h, lo = _split2(data)
                bh, bl = _split2(d)
                take = I128.lt(h, lo, bh, bl) if name == "greatest" \
                    else I128.lt(bh, bl, h, lo)
                data = _where_lanes(take, d, data)
                valid = merge_valid(valid, v)
            return data, valid
        return Bound(e.type, fn)

    def _bind_round(self, e: Call, args) -> Bound:
        """round(x[, d]): half away from zero; a decimal keeps its scale."""
        a = args[0]
        if len(args) > 1:
            if not args[1].is_const:
                raise _unsupported("round() with a non-constant scale")
            ndig = int(args[1].const_value)
        else:
            ndig = 0
        if a.type.is_long_decimal:
            # the reference cannot broadcast its limb pairs here and
            # raises; the port rounds half away from zero in 128 bits
            s = a.type.scale or 0
            if ndig >= s:
                return Bound(e.type, a.fn)
            k = s - ndig

            def r128(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                h, lo = I128.rescale_down_round(*_split2(d), k)
                return _join2(*I128.rescale_up(h, lo, k)), v
            return Bound(e.type, r128)
        if a.type.is_decimal:
            s = a.type.scale or 0
            if ndig >= s:
                return Bound(e.type, a.fn)
            m = 10 ** (s - ndig)

            def rdfn(cols, valids, afn=a.fn):
                d, v = afn(cols, valids)
                return F.div_round_half_away(d, _const(d, m, d.dtype)) * m, v
            return Bound(e.type, rdfn)
        sf = 10.0 ** ndig

        def rfn(cols, valids, afn=a.fn):
            d, v = afn(cols, valids)
            out = F.round_half_away(d.to(torch.float64) * sf) / sf
            if e.type.is_integerlike:
                out = out.to(e.type.dtype)
            return out, v
        return Bound(e.type, rfn)

    def _bind_like(self, e: Call, args) -> Bound:
        """LIKE over a dictionary column: one host match per value. An
        operand with no dictionary (a number) is NULL, as in the
        reference."""
        a = args[0]
        if a.dictionary is None or len(a.dictionary) == 0:
            return self._null_of(a, T.BOOLEAN)
        pattern = _literal(e, 1, "pattern")
        escape = e.args[2].value if len(e.args) > 2 else None
        table = _Table(torch.from_numpy(
            F.dictionary_like_table(a.dictionary, pattern.value, escape)))

        def fn(cols, valids):
            d, v = a.fn(cols, valids)
            return _lookup(table, d), v
        return Bound(T.BOOLEAN, fn)

    def _bind_coalesce(self, e: Call, args) -> Bound:
        if e.type.is_nested:
            # the first non-NULL argument: a CASE over their validities
            known = [a for a in args if a.type.kind != T.TypeKind.UNKNOWN]

            def valid_of(a: Bound) -> Bound:
                def fn(cols, valids, afn=a.fn):
                    _, v = afn(cols, valids)
                    return (_const(_ref(cols), True, torch.bool) if v is None else v), None
                return Bound(T.BOOLEAN, fn)
            return self._nested_choice(e.type, [valid_of(a) for a in known[:-1]],
                                       known[:-1], known[-1])
        out_dict = None
        if e.type.is_string:
            merged = None
            for a in args:
                if a.dictionary is not None:
                    merged = a.dictionary if merged is None else Dictionary.unify(
                        merged, a.dictionary)[0]
            out_dict = merged
            args = [self._remap_to(a, out_dict) for a in args]
        elif e.type.is_decimal:
            # each argument at the result's scale (the reference keeps
            # each argument's own scale: ROADMAP §3)
            args = [self._coerce_bound(a, e.type) for a in args]

        def fn(cols, valids):
            data, valid = args[-1].fn(cols, valids)
            data = data.to(e.type.dtype)
            for a in reversed(args[:-1]):
                d, v = a.fn(cols, valids)
                if v is None:
                    data, valid = d.to(e.type.dtype), None
                    continue
                data = _where_lanes(v, d.to(e.type.dtype), data)
                vv = valid if valid is not None else _const(d, True, torch.bool)
                valid = v | vv
            return data, valid
        return Bound(e.type, fn, out_dict)

    # ---- 3VL and/or ----
    def _bind_logical(self, e: Call) -> Bound:
        args = [self.bind(a) for a in e.args]
        is_and = e.name == "and"

        def fn(cols, valids):
            datas, vals = [], []
            for a in args:
                d, v = a.fn(cols, valids)
                datas.append(d)
                vals.append(v)
            data = None
            if is_and:
                for d, v in zip(datas, vals):
                    lane = d if v is None else (d | ~v)
                    data = lane if data is None else (data & lane)
                valid = merge_valid(*vals)
                if valid is not None:
                    for d, v in zip(datas, vals):
                        valid = valid | ((~d) if v is None else (v & ~d))
            else:
                for d, v in zip(datas, vals):
                    lane = d if v is None else (d & v)
                    data = lane if data is None else (data | lane)
                valid = merge_valid(*vals)
                if valid is not None:
                    for d, v in zip(datas, vals):
                        valid = valid | (d if v is None else (v & d))
            return data, valid
        return Bound(T.BOOLEAN, fn)

    # ---- comparisons ----
    _CMP = {
        "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
        "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    }

    def _bind_decimal128_comparison(self, op: str, a: Bound, b: Bound) -> Bound:
        """Compare with at least one Int128 decimal: both sides lift to
        limb pairs at the common scale; rows whose rescale would wrap
        compare as float64 (the reference's documented corner)."""
        sa = (a.type.scale or 0) if a.type.is_decimal else 0
        sb = (b.type.scale or 0) if b.type.is_decimal else 0
        sc = max(sa, sb)
        at, bt = a.type, b.type

        def fn(cols, valids):
            ad, av = a.fn(cols, valids)
            bd, bv = b.fn(cols, valids)
            ah, al = _lift128(ad, at)
            bh, bl = _lift128(bd, bt)
            wrap = torch.zeros(ah.shape, dtype=torch.bool, device=ah.device)
            for side, s in (("a", sa), ("b", sb)):
                if s >= sc:
                    continue
                lh, ll = I128.from_python((2 ** 127 - 1) // 10 ** (sc - s))
                if side == "a":
                    xh, xl = I128.abs_(ah, al)
                    ah, al = I128.rescale_up(ah, al, sc - s)
                else:
                    xh, xl = I128.abs_(bh, bl)
                    bh, bl = I128.rescale_up(bh, bl, sc - s)
                wrap = wrap | ~I128.lt(xh, xl, lh, ll)
            eqv = I128.eq(ah, al, bh, bl)
            ltv = I128.lt(ah, al, bh, bl)
            fa = _f64_of_decimal(ad, at) if at.is_decimal else ad.to(torch.float64)
            fb = _f64_of_decimal(bd, bt) if bt.is_decimal else bd.to(torch.float64)
            eqv = torch.where(wrap, fa == fb, eqv)
            ltv = torch.where(wrap, fa < fb, ltv)
            out = {
                "eq": eqv, "ne": ~eqv, "lt": ltv, "le": ltv | eqv,
                "gt": ~(ltv | eqv), "ge": ~ltv,
            }[op]
            return out, merge_valid(av, bv)

        return Bound(T.BOOLEAN, fn)

    def _bind_comparison(self, op: str, args) -> Bound:
        a, b = args
        if a.type.is_string or b.type.is_string:
            return self._bind_string_comparison(op, a, b)
        if a.type.kind == T.TypeKind.TIMESTAMP_TZ and a.type == b.type:
            # compare instants only: one instant named in two zones is
            # equal (the zone bits must not break the tie)
            def strip(x: Bound) -> Bound:
                def sfn(cols, valids, xfn=x.fn):
                    d, v = xfn(cols, valids)
                    return d >> TZ.MILLIS_SHIFT, v
                return Bound(T.BIGINT, sfn)
            a, b = strip(a), strip(b)
        if (a.type.is_long_decimal or b.type.is_long_decimal) and not (
            a.type.is_floating or b.type.is_floating
        ):
            return self._bind_decimal128_comparison(op, a, b)
        if a.type.is_decimal or b.type.is_decimal:
            if a.type.is_floating or b.type.is_floating:
                def to_double(x: Bound) -> Bound:
                    if not x.type.is_decimal:
                        return x
                    xt = x.type

                    def dn(cols, valids, xfn=x.fn):
                        d, v = xfn(cols, valids)
                        return _f64_of_decimal(d, xt), v
                    return Bound(T.DOUBLE, dn)
                a, b = to_double(a), to_double(b)
            else:
                sc = max((a.type.scale or 0) if a.type.is_decimal else 0,
                         (b.type.scale or 0) if b.type.is_decimal else 0)

                def to_scale(x: Bound) -> Bound:
                    if x.type.is_decimal:
                        return self._rescaled(
                            x, x.type.scale or 0, sc, T.decimal(18, sc)
                        )
                    if x.type.is_integerlike:
                        m = 10 ** sc

                        def up(cols, valids, xfn=x.fn):
                            d, v = xfn(cols, valids)
                            return d.to(torch.int64) * m, v
                        return Bound(T.decimal(18, sc), up)
                    return x
                a, b = to_scale(a), to_scale(b)
        cmp = self._CMP[op]

        def fn(cols, valids):
            ad, av = a.fn(cols, valids)
            bd, bv = b.fn(cols, valids)
            if ad.dtype != bd.dtype:
                ct = torch.promote_types(ad.dtype, bd.dtype)
                ad, bd = ad.to(ct), bd.to(ct)
            return cmp(ad, bd), merge_valid(av, bv)
        return Bound(T.BOOLEAN, fn)

    def _bind_string_comparison(self, op: str, a: Bound, b: Bound) -> Bound:
        """String comparison on dictionary codes (sorted dictionaries:
        code order == lexical order); a constant compares through its
        bisect position even when absent."""
        if isinstance(a.dictionary, RuntimeDictionary) or isinstance(
            b.dictionary, RuntimeDictionary
        ):
            raise NotImplementedError(
                "string comparison over an execution-time dictionary "
                "(listagg output) is not supported")
        flip = {"lt": "gt", "gt": "lt", "le": "ge", "ge": "le",
                "eq": "eq", "ne": "ne"}
        for lit, col, effective in ((b, a, op), (a, b, flip[op])):
            if not lit.is_const or col.is_const or col.dictionary is None:
                continue
            d = col.dictionary
            code = d.code(lit.const_value)
            if code >= 0:
                cmp = self._CMP[effective]

                def pfn(cols, valids, colb=col, code=code, cmp=cmp):
                    cd, cv = colb.fn(cols, valids)
                    return cmp(cd, code), cv
                return Bound(T.BOOLEAN, pfn)
            if effective == "eq":
                return self._const_bool(col, False)
            if effective == "ne":
                return self._const_bool(col, True)
            lb = d.code_lower_bound(lit.const_value)
            ge_side = effective in ("gt", "ge")

            def bfn(cols, valids, colb=col, lb=lb, ge_side=ge_side):
                cd, cv = colb.fn(cols, valids)
                return (cd >= lb) if ge_side else (cd < lb), cv
            return Bound(T.BOOLEAN, bfn)
        da, db = a.dictionary, b.dictionary
        if da is not None and db is not None and da != db:
            merged, _, _ = Dictionary.unify(da, db)
            a = self._remap_to(a, merged)
            b = self._remap_to(b, merged)
        cmp = self._CMP[op]

        def fn(cols, valids):
            ad, av = a.fn(cols, valids)
            bd, bv = b.fn(cols, valids)
            return cmp(ad, bd), merge_valid(av, bv)
        return Bound(T.BOOLEAN, fn)

    @staticmethod
    def _const_bool(ref: Bound, value: bool) -> Bound:
        def fn(cols, valids):
            d, v = ref.fn(cols, valids)
            return _const(d, value, torch.bool), v
        return Bound(T.BOOLEAN, fn)

    # ---- arithmetic ----
    def _bind_arith(self, op: str, out_type: T.DataType, args) -> Bound:
        a, b = args
        if out_type.is_decimal or a.type.is_decimal or b.type.is_decimal:
            return self._bind_decimal_arith(op, out_type, a, b)
        if op in ("div", "mod") and b.is_const and b.const_value == 0 \
                and not out_type.is_floating \
                and not getattr(self, "_in_branch", 0):
            raise ValueError("Division by zero")

        def fn(cols, valids):
            ad, av = a.fn(cols, valids)
            bd, bv = b.fn(cols, valids)
            valid = merge_valid(av, bv)
            ad = ad.to(out_type.dtype)
            bd = bd.to(out_type.dtype)
            if op == "div":
                if out_type.is_floating:
                    return ad / bd, valid
                zero = bd == 0
                nv = valid if valid is not None else _const(ad, True, torch.bool)
                return F.div_trunc(ad, bd), torch.where(zero, False, nv)
            if op == "mod":
                zero = bd == 0
                safe = torch.where(zero, torch.ones_like(bd), bd)
                if out_type.is_floating:
                    d = torch.fmod(ad, safe)
                else:
                    d = torch.sign(ad) * torch.remainder(torch.abs(ad), torch.abs(safe))
                nv = valid if valid is not None else _const(ad, True, torch.bool)
                return d, torch.where(zero, False, nv)
            if op == "add":
                return ad + bd, valid
            if op == "sub":
                return ad - bd, valid
            return ad * bd, valid
        return Bound(out_type, fn)

    def _bind_decimal_arith(self, op: str, out_type: T.DataType,
                            a: Bound, b: Bound) -> Bound:
        if op in ("div", "mod") and b.is_const and b.const_value == 0 \
                and not getattr(self, "_in_branch", 0):
            raise ValueError("Division by zero")
        sa = (a.type.scale or 0) if a.type.is_decimal else 0
        sb = (b.type.scale or 0) if b.type.is_decimal else 0
        so = out_type.scale or 0

        if a.type.is_floating or b.type.is_floating or out_type.is_floating:
            def ffn(cols, valids):
                ad, av = a.fn(cols, valids)
                bd, bv = b.fn(cols, valids)
                if a.type.is_decimal:
                    ad = _f64_of_decimal(ad, a.type)
                if b.type.is_decimal:
                    bd = _f64_of_decimal(bd, b.type)
                ad, bd = ad.to(torch.float64), bd.to(torch.float64)
                valid = merge_valid(av, bv)
                if op == "div":
                    return ad / bd, valid
                if op == "add":
                    return ad + bd, valid
                if op == "sub":
                    return ad - bd, valid
                if op == "mul":
                    return ad * bd, valid
                raise _unsupported(f"double {op} through decimal")
            return Bound(out_type, ffn)

        if a.type.is_long_decimal or b.type.is_long_decimal \
                or out_type.is_long_decimal:
            return self._bind_decimal128_arith(op, out_type, a, b, sa, sb, so)

        for x in (a, b):
            if not (x.type.is_decimal or x.type.is_integerlike):
                raise NotImplementedError(f"decimal arith with {x.type}")

        def rescale(d, cs):
            if cs == so:
                return d
            if so > cs:
                return d * (10 ** (so - cs))
            return F.div_round_half_away(d, _const(d, 10 ** (cs - so), torch.int64))

        def fn(cols, valids):
            ad, av = a.fn(cols, valids)
            bd, bv = b.fn(cols, valids)
            ad = ad.to(torch.int64)
            bd = bd.to(torch.int64)
            valid = merge_valid(av, bv)
            if op in ("add", "sub", "mod"):
                cs = max(sa, sb)
                if sa < cs:
                    ad = ad * (10 ** (cs - sa))
                if sb < cs:
                    bd = bd * (10 ** (cs - sb))
                if op == "add":
                    return rescale(ad + bd, cs), valid
                if op == "sub":
                    return rescale(ad - bd, cs), valid
                zero = bd == 0
                safe = torch.where(zero, torch.ones_like(bd), bd)
                d = torch.sign(ad) * torch.remainder(torch.abs(ad), torch.abs(safe))
                nv = valid if valid is not None else _const(ad, True, torch.bool)
                return d, torch.where(zero, False, nv)
            if op == "mul":
                return rescale(ad * bd, sa + sb), valid
            if op == "div":
                shift = sb + so - sa
                num = ad * (10 ** shift) if shift >= 0 else F.div_round_half_away(
                    ad, _const(ad, 10 ** (-shift), torch.int64))
                zero = bd == 0
                d = F.div_round_half_away(num, torch.where(zero, torch.ones_like(bd), bd))
                nv = valid if valid is not None else _const(ad, True, torch.bool)
                return torch.where(zero, torch.zeros_like(d), d), torch.where(zero, False, nv)
            raise NotImplementedError(op)
        return Bound(out_type, fn)

    def _bind_decimal128_arith(self, op: str, out_type: T.DataType,
                               a: Bound, b: Bound, sa: int, sb: int,
                               so: int) -> Bound:
        """Int128-carried decimal arithmetic. A result past 38 digits
        yields NULL (the reference's overflow contract)."""
        at, bt = a.type, b.type
        long_divisor = bt.is_long_decimal

        def out128(h, lo, valid):
            ovf = I128.overflows_38(h, lo)
            valid = ~ovf if valid is None else (valid & ~ovf)
            if out_type.is_long_decimal:
                return _join2(h, lo), valid
            x, ok = I128.to_i64(h, lo)
            return x, valid & ok

        def fn(cols, valids):
            ad, av = a.fn(cols, valids)
            bd, bv = b.fn(cols, valids)
            valid = merge_valid(av, bv)
            ah, al = _lift128(ad, at)
            bh, bl = _lift128(bd, bt)
            if op in ("add", "sub"):
                cs = max(sa, sb)
                if sa < cs:
                    ah, al = I128.rescale_up(ah, al, cs - sa)
                if sb < cs:
                    bh, bl = I128.rescale_up(bh, bl, cs - sb)
                h, lo = (I128.add(ah, al, bh, bl) if op == "add"
                         else I128.sub(ah, al, bh, bl))
                if so > cs:
                    h, lo = I128.rescale_up(h, lo, so - cs)
                elif cs > so:
                    h, lo = I128.rescale_down_round(h, lo, cs - so)
                return out128(h, lo, valid)
            if op == "mul":
                h, lo = I128.mul_128(ah, al, bh, bl)
                cs = sa + sb
                if so > cs:
                    h, lo = I128.rescale_up(h, lo, so - cs)
                elif cs > so:
                    h, lo = I128.rescale_down_round(h, lo, cs - so)
                return out128(h, lo, valid)
            zero = (bh == 0) & (bl == 0)
            bad = zero
            d64, _ = I128.to_i64(bh, bl)
            if op == "div":
                rf = sb + so - sa
                lim_h, lim_l = I128.from_python((2 ** 127 - 1) // 10 ** rf)
                aah, aal = I128.abs_(ah, al)
                bad = bad | ~I128.lt(aah, aal, lim_h, lim_l)
                nh, nl = I128.rescale_up(ah, al, rf)
                if long_divisor:
                    # full 128/128 division: any nonzero divisor
                    sdh = torch.where(bad, torch.zeros_like(bh), bh)
                    sdl = torch.where(bad, torch.ones_like(bl), bl)
                    h, lo = I128.div_round_128(nh, nl, sdh, sdl)
                else:
                    safe = torch.where(bad, torch.ones_like(d64), d64)
                    h, lo = I128.div_round_i64(nh, nl, safe)
            elif long_divisor or (bt.precision or 18) + (max(sa, sb) - sb) > 18:
                # divisor rescaled to the common scale in 128-bit limbs,
                # guarding the 128-bit wrap like the dividend rescale
                cs = max(sa, sb)
                if sa < cs:
                    ah, al = I128.rescale_up(ah, al, cs - sa)
                lim_h, lim_l = I128.from_python((2 ** 127 - 1) // 10 ** (cs - sb))
                bah, bal = I128.abs_(bh, bl)
                bad = bad | ~I128.lt(bah, bal, lim_h, lim_l)
                sdh = torch.where(bad, torch.zeros_like(bh), bh)
                sdl = torch.where(bad, torch.ones_like(bl), bl)
                sdh, sdl = I128.rescale_up(sdh, sdl, cs - sb)
                h, lo = I128.mod_128(ah, al, sdh, sdl)
            else:
                cs = max(sa, sb)
                if sa < cs:
                    ah, al = I128.rescale_up(ah, al, cs - sa)
                safe = torch.where(bad, torch.ones_like(d64), d64) * (10 ** (cs - sb))
                pa_h, pa_l = I128.abs_(ah, al)
                _, _, r = I128.divmod_u128_u64(pa_h, pa_l, torch.abs(safe))
                sgn = I128.sign(ah, al)
                h, lo = I128.mul_128_64(r * 0, r, sgn)
            d, valid2 = out128(h, lo, valid)
            nv = valid2 if valid2 is not None else _const(ad, True, torch.bool)
            return d, torch.where(bad, False, nv)

        return Bound(out_type, fn)


    # ---- nested values: ARRAY / MAP / ROW ----
    # A nested input arrives as its whole Column in `cols`
    # (operators.batch_inputs) and a nested result is a whole Column in
    # the data slot of the (data, valid) pair. An ARRAY Bound's dictionary
    # is its elements' where bind time knows it (split's, an input's),
    # so UNNEST's element column keeps it. The compactions (filter,
    # map_filter, array_remove, array_distinct) and the per-row
    # reductions read each row's elements in row order through the
    # lengths (ops/join.expand_runs), never through a search over
    # `starts`: after a join, sort or TopN has gathered the rows, their
    # slices of the shared flat child are out of order and may repeat.

    _LAMBDA_FNS = (
        "transform", "filter", "any_match", "all_match", "none_match",
        "transform_values", "transform_keys", "map_filter",
    )
    _ARRAY_FNS = (
        "slice", "trim_array", "repeat", "array_sort", "array_distinct",
        "array_position", "array_remove", "array_contains",
        "array_min_col", "array_max_col", "map_contains_key", "split",
        "regexp_split", "regexp_extract_all",
    )

    @staticmethod
    def _lambda_body_ir(body):
        """The lambda body with its LambdaVar leaves turned into
        InputRefs, so it binds as an ordinary expression over the flat
        element column(s)."""
        def sub(x):
            if isinstance(x, LambdaVar):
                return InputRef(x.index, x.type)
            if isinstance(x, Call):
                return Call(x.name, tuple(sub(a) for a in x.args), x.type)
            if isinstance(x, Cast):
                return Cast(sub(x.arg), x.type)
            if isinstance(x, Case):
                return Case(tuple(sub(c) for c in x.conds), tuple(sub(r) for r in x.results),
                            None if x.default is None else sub(x.default), x.type)
            if isinstance(x, InList):
                return InList(sub(x.value), x.options)
            return x  # Literal / InputRef
        return sub(body)

    @staticmethod
    def _seg_counts(flags, starts, lengths):
        """Per row, the true flags inside [start, start + len) of the
        flat column (a cumulative-sum difference: right for any layout)."""
        f = flags.to(torch.int32)
        ce = torch.cumsum(f, 0, dtype=torch.int32)
        exc = ce - f
        n = flags.shape[0]
        ends = torch.clamp(starts + lengths - 1, 0, max(n - 1, 0))
        s = torch.clamp(starts, 0, max(n - 1, 0))
        cnt = take_clip(ce, ends) - take_clip(exc, s)
        return torch.where(lengths > 0, cnt, torch.zeros_like(cnt))

    @staticmethod
    def _flat_rowids(starts, lengths):
        """Every row's elements in row order: (owner row, index within
        the row, flat position, slot live) per slot of a bucketed
        capacity. The owner comes from the lengths (a run-owner fill), so
        the layout of `starts` does not matter."""
        owner, elem, ok, _ = J.expand_runs(lengths.to(torch.int32))
        return owner, elem, take_clip(starts, owner) + elem, ok

    def _compact(self, c, keep, out_t):
        """Each row's elements whose flat `keep` flag is set, in their
        order, rows laid out one after another: an ArrayColumn, or a
        MapColumn whose keys and values move together."""
        lengths = c.data.to(torch.int32)
        _, _, fpos, ok = self._flat_rowids(c.starts, lengths)
        k = take_clip(keep, fpos) & ok
        excl = torch.cumsum(lengths, 0, dtype=torch.int32) - lengths
        cnt = self._seg_counts(k, excl, lengths)
        src = take_clip(fpos, torch.argsort((~k).to(torch.int8), stable=True))
        new_starts = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
        if isinstance(c, MapColumn):
            return MapColumn(out_t, cnt, c.valid, None, new_starts,
                             c.flat_keys.gather(src), c.flat_values.gather(src))
        return ArrayColumn(out_t, cnt, c.valid, None, new_starts, c.flat.gather(src))

    def _bind_lambda_fn(self, e: Call) -> Bound:
        name = e.name
        coll_b = self.bind(e.args[0])
        body_ir = self._lambda_body_ir(e.args[1].body)
        out_t = e.type

        def body_over(flat_cols):
            """Bind and evaluate the body over the flat element Columns
            (their dictionaries are the batch's)."""
            b = ExprBinder([c.type for c in flat_cols],
                           [c.dictionary for c in flat_cols]).bind(body_ir)
            d, v = b.fn([c if c.type.is_nested else c.data for c in flat_cols],
                        [c.valid for c in flat_cols])
            if isinstance(d, Column):
                return d
            return Column(b.type, d, v, b.dictionary)

        def fn(cols, valids):
            c, cv = coll_b.fn(cols, valids)
            if name in ("transform", "filter", "any_match", "all_match", "none_match"):
                flat = [c.flat]
            else:
                flat = [c.flat_keys, c.flat_values]
            out = body_over(flat)
            lengths, starts = c.data, c.starts
            if name == "transform":
                return ArrayColumn(out_t, lengths, c.valid, None, starts, out), cv
            if name == "transform_values":
                return MapColumn(out_t, lengths, c.valid, None, starts, c.flat_keys, out), cv
            if name == "transform_keys":
                return MapColumn(out_t, lengths, c.valid, None, starts, out, c.flat_values), cv
            keep = out.data if out.valid is None else (out.data & out.valid)
            if name in ("filter", "map_filter"):
                return self._compact(c, keep, out_t), cv
            cnt = self._seg_counts(keep, starts, lengths)
            valid = _nested_valid(c, cv)
            if name == "any_match":
                return cnt > 0, valid
            if name == "none_match":
                return cnt == 0, valid
            return cnt == lengths, valid  # all_match

        dictionary = coll_b.dictionary if name == "filter" else None
        return Bound(out_t, fn, dictionary)

    def _bind_array_fn(self, e: Call, args) -> Bound:
        name = e.name
        out_t = e.type
        a = args[0]

        def fn(cols, valids):
            c, cv = a.fn(cols, valids)
            if name == "repeat":
                # repeat(x, n): the row's scalar value n times
                n_rep = int(args[1].const_value)
                rows = c.shape[0]
                flat = Column(out_t.element, torch.repeat_interleave(c, n_rep, 0),
                              None if cv is None else torch.repeat_interleave(cv, n_rep),
                              a.dictionary)
                idx = torch.arange(rows, dtype=torch.int32, device=c.device)
                return ArrayColumn(out_t, torch.full_like(idx, n_rep), None, None,
                                   idx * n_rep, flat), None
            lengths, starts = c.data, c.starts
            if name == "slice":
                sd, sv = args[1].fn(cols, valids)
                ld, lv = args[2].fn(cols, valids)
                sd = sd.to(torch.int32)
                ld = torch.clamp(ld.to(torch.int32), min=0)
                off = torch.where(sd > 0, sd - 1, lengths + sd)
                off = torch.minimum(torch.clamp(off, min=0), lengths)
                new_len = torch.minimum(ld, lengths - off)
                return (ArrayColumn(out_t, new_len, c.valid, None, starts + off, c.flat),
                        merge_valid(cv, sv, lv))
            if name == "trim_array":
                nd, nv = args[1].fn(cols, valids)
                new_len = torch.minimum(
                    torch.clamp(lengths - nd.to(torch.int32), min=0), lengths)
                return (ArrayColumn(out_t, new_len, c.valid, None, starts, c.flat),
                        merge_valid(cv, nv))
            flat = c.flat_keys if name == "map_contains_key" else c.flat
            if name in ("map_contains_key", "array_contains", "array_position",
                        "array_remove"):
                pd = _dict_code_const(args[1], flat.dictionary, flat.type)
                match = flat.data == pd
                if flat.valid is not None:
                    match = match & flat.valid
            if name in ("map_contains_key", "array_contains"):
                return self._seg_counts(match, starts, lengths) > 0, _nested_valid(c, cv)
            if name == "array_remove":
                return self._compact(c, ~match, out_t), cv  # NULL elements stay
            owner, elem, fpos, ok = self._flat_rowids(starts, lengths)
            cap = lengths.shape[0]
            if name in ("array_min_col", "array_max_col"):
                is_min = name == "array_min_col"
                vals = take_clip(flat.data, fpos)
                wide = vals.to(torch.int8) if vals.dtype == torch.bool else vals
                big = minmax_like(wide.dtype, is_min)
                w = flat.valid_mask()
                contrib = torch.where(ok & take_clip(w, fpos), wide,
                                      torch.full_like(wide, big))
                out = torch.full((cap,), big, dtype=wide.dtype, device=wide.device)
                out = out.scatter_reduce(0, owner.to(torch.int64), contrib,
                                         "amin" if is_min else "amax")
                has = self._seg_counts(w, starts, lengths) > 0
                return out.to(vals.dtype), merge_valid(has, _nested_valid(c, cv))
            if name == "array_position":
                none = 1 << 30
                score = torch.where(ok & take_clip(match, fpos), elem,
                                    torch.full_like(elem, none))
                first = torch.full((cap,), none, dtype=torch.int32, device=elem.device)
                first = first.scatter_reduce(0, owner.to(torch.int64), score, "amin")
                out = torch.where(first < none, first.to(torch.int64) + 1,
                                  torch.zeros_like(first, dtype=torch.int64))
                return out, _nested_valid(c, cv)
            # array_sort / array_distinct: a stable sort of each row's
            # elements by value (NULLs by their payload and ties in
            # element order, as the reference sorts them)
            vals = take_clip(flat.data, fpos)
            ov = _order_value(vals if vals.dim() == 1 else vals[:, 0], False)
            row = torch.where(ok, owner, torch.full_like(owner, cap))
            perm = torch.argsort(ov, stable=True)
            perm = take_clip(perm, torch.argsort(take_clip(row, perm), stable=True))
            excl = torch.cumsum(lengths.to(torch.int32), 0, dtype=torch.int32) - lengths
            sorted_c = ArrayColumn(out_t, lengths, c.valid, None, excl.to(torch.int32),
                                   flat.gather(take_clip(fpos, perm)))
            if name == "array_sort":
                return sorted_c, cv
            # array_distinct: the first of each run of equal values (the
            # sorted order; Trino keeps the first occurrence's order)
            sval, srow = take_clip(ov, perm), take_clip(row, perm)
            first = torch.ones_like(sval, dtype=torch.bool)
            first[1:] = (sval[1:] != sval[:-1]) | (srow[1:] != srow[:-1])
            return self._compact(sorted_c, first, out_t), cv

        # an array result keeps its elements' dictionary
        return Bound(out_t, fn, a.dictionary if out_t.is_array else None)

    def _bind_split(self, e: Call, args) -> Bound:
        """split(string, delimiter) and the regexp splitters: a
        per-dictionary-value function to a list of strings. Each row owns
        a W-wide slot of the flat column (W = the most parts of any
        dictionary value) and its true length; the parts' dictionary is
        made here, once, and is the Bound's."""
        a, delim = args[0], args[1]
        if not delim.is_const:
            raise NotImplementedError(f"{e.name}() pattern must be a constant")
        sep = str(delim.const_value)
        values = a.dictionary.values if a.dictionary else ()
        if e.name == "regexp_split":
            rx = _re.compile(sep)
            parts_per_code = [rx.split(v) for v in values]
        elif e.name == "regexp_extract_all":
            rx = _re.compile(sep)
            group = int(_literal(e, 2, "group").value) if len(e.args) > 2 else 0
            parts_per_code = [[m.group(group) or "" for m in rx.finditer(v)] for v in values]
        else:
            parts_per_code = [v.split(sep) if sep else [v] for v in values]
        width = max(max((len(p) for p in parts_per_code), default=1), 1)
        out_dict = Dictionary(sorted({p for parts in parts_per_code for p in parts}) or [""])
        table = np.zeros((max(len(values), 1), width), dtype=np.int32)
        lens = np.zeros(max(len(values), 1), dtype=np.int32)
        for c, parts in enumerate(parts_per_code):
            lens[c] = len(parts)
            table[c, :len(parts)] = [out_dict.code(p) for p in parts]
        table_t, lens_t = _table(table, torch.int32), _table(lens, torch.int32)
        out_t = e.type

        def fn(cols, valids):
            d, v = a.fn(cols, valids)
            rows = d.shape[0]
            flat = Column(T.VARCHAR, _lookup(table_t, d).reshape(-1), None, out_dict)
            starts = torch.arange(rows, dtype=torch.int32, device=d.device) * width
            return ArrayColumn(out_t, _lookup(lens_t, d), v, None, starts, flat), v
        return Bound(out_t, fn, out_dict)

    def _bind_nested_op(self, name: str, e: Call, args) -> Bound:
        """MAP/ROW/ARRAY navigation (MapSubscript, RowFieldReference and
        the block accessors): subscripts and row fields return plain
        (data, valid) pairs for flat values, whole Columns for string and
        nested ones (their dictionary, starts and children are batch
        data); map_keys, map_values and row_pack return Columns."""
        out_t = e.type
        if name == "row_pack":
            def packfn(cols, valids):
                built = []
                for b in args:
                    d, v = b.fn(cols, valids)
                    built.append(d if isinstance(d, Column) else Column(b.type, d, v, b.dictionary))
                ref = built[0].data
                presence = torch.ones(ref.shape[0], dtype=torch.int8, device=ref.device)
                return RowColumn(out_t, presence, None, None, built), None
            return Bound(out_t, packfn)
        a = args[0]
        as_column = out_t.is_string or out_t.is_nested
        if name == "row_field":
            fi = int(args[1].const_value)

            def rffn(cols, valids):
                d, v = a.fn(cols, valids)
                child = d.children[fi]
                valid = merge_valid(child.valid, d.valid if v is None else v)
                if as_column:
                    return child.with_data(child.data, valid), None
                return child.data, valid
            return Bound(out_t, rffn)
        if name in ("map_keys", "map_values"):
            def mkfn(cols, valids):
                d, v = a.fn(cols, valids)
                flat = d.flat_keys if name == "map_keys" else d.flat_values
                return ArrayColumn(out_t, d.data, d.valid if v is None else v, None,
                                   d.starts, flat), None
            return Bound(out_t, mkfn)
        k = args[1]
        if name == "array_subscript":
            def asfn(cols, valids):
                d, v = a.fn(cols, valids)
                kd, kv = k.fn(cols, valids)
                lengths = d.data.to(torch.int64)
                idx = kd.to(torch.int64)
                # 1-based; a negative index counts from the end (element_at)
                eff = torch.where(idx > 0, idx - 1, lengths + idx)
                ok = (eff >= 0) & (eff < lengths)
                pos = d.starts.to(torch.int64) + torch.where(ok, eff, torch.zeros_like(eff))
                # gather through the child column: nested elements and
                # dictionaries stay whole
                out = d.flat.gather(pos, merge_valid(ok, d.valid, v, kv))
                return (out, None) if as_column else (out.data, out.valid)
            return Bound(out_t, asfn)

        def msfn(cols, valids):
            d, v = a.fn(cols, valids)
            lengths = d.data.to(torch.int32)
            fk, fv = d.flat_keys, d.flat_values
            kd, kv = k.fn(cols, valids)
            kdict = k.dictionary
            if isinstance(kd, Column):
                kdict = kd.dictionary if kd.dictionary is not None else kdict
                kv = kd.valid if kv is None else kv
                kd = kd.data
            if fk.dictionary is not None and k.is_const:
                target = torch.full_like(lengths, fk.dictionary.code(k.const_value))
            elif fk.dictionary is not None and kdict is not None:
                remap = torch.tensor([fk.dictionary.code(x) for x in kdict.values] or [-1],
                                     dtype=torch.int32, device=kd.device)
                target = take_clip(remap, kd)
            elif fk.dictionary is not None:
                # codes of two different dictionaries must not be compared
                raise NotImplementedError(
                    "map subscript with a computed string key (no plan-time"
                    " dictionary) is not supported; use a constant key or a"
                    " string column")
            else:
                target = kd.to(fk.data.dtype)
            # the first matching entry of each row, one entry position a
            # step; the value is gathered through the child column
            found = torch.zeros_like(lengths, dtype=torch.bool)
            pos = torch.zeros_like(lengths, dtype=torch.int64)
            kvalid = fk.valid_mask()
            steps = int(lengths.max()) if lengths.numel() else 0
            for i in range(steps):
                slot = torch.clamp(d.starts.to(torch.int64) + i, 0, max(fk.capacity - 1, 0))
                hit = ((i < lengths) & kvalid[slot] & (fk.data[slot] == target) & ~found)
                found = found | hit
                pos = torch.where(hit, slot, pos)
            out = fv.gather(pos, merge_valid(found, d.valid, v, kv))
            return (out, None) if as_column else (out.data, out.valid)
        return Bound(out_t, msfn)

    def _bind_nested(self, name: str, e: Call, args) -> Optional[Bound]:
        """cardinality, the navigation operators, split_to_map and the
        sketch readers (their argument is a serialized sketch)."""
        if name == "array_length":
            # ArrayColumn/MapColumn.data IS the per-row length
            a = args[0]

            def alfn(cols, valids):
                d, v = a.fn(cols, valids)
                if isinstance(d, Column):
                    d, v = d.data, _nested_valid(d, v)
                return d.to(torch.int64), v
            return Bound(T.BIGINT, alfn)
        if name in ("map_subscript", "array_subscript", "map_keys", "map_values",
                    "row_field", "row_pack"):
            return self._bind_nested_op(name, e, args)
        if name == "hll_cardinality":
            return self._bind_dict_table_nullable(args[0], T.BIGINT, pyfns.hll_cardinality,
                                                  torch.int64)
        if name in ("value_at_quantile", "quantile_at_value"):
            q = _literal(e, 1, "quantile")
            if q.value is None:
                return self._null_of(args[0], T.DOUBLE)
            qv = float(q.value)
            pyf = (pyfns.tdigest_value_at_quantile if name == "value_at_quantile"
                   else pyfns.tdigest_quantile_at_value)
            return self._bind_dict_table_nullable(
                args[0], T.DOUBLE, lambda s: pyf(s, qv), torch.float64)
        if name == "values_at_quantiles":
            return self._bind_values_at_quantiles(e, args[0])
        if name == "split_to_map":
            return self._bind_split_to_map(e, args)
        return None

    def _bind_values_at_quantiles(self, e: Call, a: Bound) -> Bound:
        """One array(double) per row, from a per-dictionary-value table."""
        fracs = [float(x) for x in (_literal(e, 1, "fractions").value or ())]
        values = a.dictionary.values if a.dictionary else ()
        width = max(len(fracs), 1)
        table = np.zeros((max(len(values), 1), width), dtype=np.float64)
        okm = np.zeros((max(len(values), 1), width), dtype=bool)
        for c, dv in enumerate(values):
            for j, q in enumerate(fracs):
                rv = pyfns.tdigest_value_at_quantile(dv, q)
                if rv is not None:
                    table[c, j] = rv
                    okm[c, j] = True
        table_t, ok_t = _table(table, torch.float64), _table(okm, torch.bool)
        out_t = e.type

        def vqfn(cols, valids):
            d, v = a.fn(cols, valids)
            rows = d.shape[0]
            flat = Column(T.DOUBLE, _lookup(table_t, d).reshape(-1),
                          _lookup(ok_t, d).reshape(-1), None)
            idx = torch.arange(rows, dtype=torch.int32, device=d.device)
            return ArrayColumn(out_t, torch.full_like(idx, len(fracs)), v, None,
                               idx * width, flat), v
        return Bound(out_t, vqfn)

    def _bind_split_to_map(self, e: Call, args) -> Bound:
        """split_to_map(text, entry delimiter, key delimiter): a
        per-dictionary-value table of W-wide key and value rows. A value
        with a repeated key is NULL (the reference raises when it reaches
        such a row; raising at bind time would fail rows the query never
        reads)."""
        a = args[0]
        for i in (1, 2):
            if not args[i].is_const:
                raise NotImplementedError("split_to_map() delimiters must be constants")
        ed, kd = str(args[1].const_value), str(args[2].const_value)
        values = a.dictionary.values if a.dictionary else ()
        per_code = []
        for v in values:
            pairs = [entry.partition(kd)[::2] for entry in (v.split(ed) if v else ())
                     if entry]
            per_code.append(None if len({k for k, _ in pairs}) != len(pairs) else pairs)
        width = max((len(p) for p in per_code if p is not None), default=1)
        key_dict = Dictionary(sorted({k for ps in per_code if ps for k, _ in ps}) or [""])
        val_dict = Dictionary(sorted({x for ps in per_code if ps for _, x in ps}) or [""])
        rows_n = max(len(values), 1)
        kt = np.zeros((rows_n, width), dtype=np.int32)
        vt = np.zeros((rows_n, width), dtype=np.int32)
        lens = np.zeros(rows_n, dtype=np.int32)
        okc = np.ones(rows_n, dtype=bool)
        for c, ps in enumerate(per_code):
            if ps is None:
                okc[c] = False
                continue
            lens[c] = len(ps)
            for j, (k, x) in enumerate(ps):
                kt[c, j], vt[c, j] = key_dict.code(k), val_dict.code(x)
        kt_t, vt_t = _table(kt, torch.int32), _table(vt, torch.int32)
        lens_t, ok_t = _table(lens, torch.int32), _table(okc, torch.bool)
        out_t = e.type

        def smfn(cols, valids):
            d, v = a.fn(cols, valids)
            rows = d.shape[0]
            row_ok = _lookup(ok_t, d)
            vv = row_ok if v is None else (v & row_ok)
            starts = torch.arange(rows, dtype=torch.int32, device=d.device) * width
            return MapColumn(
                out_t, _lookup(lens_t, d), vv, None, starts,
                Column(T.VARCHAR, _lookup(kt_t, d).reshape(-1), None, key_dict),
                Column(T.VARCHAR, _lookup(vt_t, d).reshape(-1), None, val_dict)), vv
        return Bound(out_t, smfn)

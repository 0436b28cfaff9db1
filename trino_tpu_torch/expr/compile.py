"""Expression binder: typed IR -> eager torch closures.

Counterpart of trino_tpu/expr/compile.py (the PageFunctionCompiler
analogue). Binding happens once per pipeline against the input schema
(types + per-column string dictionaries); the result is a closure of
torch ops evaluated per batch on the batch's device. String logic
(LIKE, ordering) resolves on the host against dictionary values, never
per row.

Value model: every expression evaluates to ``(data, valid)`` where
``valid=None`` means all-valid; SQL three-valued logic lives in the
and/or/not lowerings. Decimals are scaled int64 (precision <= 18) or
(n, 2) Int128 limb pairs (precision 19..38) through ops/int128.

Ported so far: column references, literals, numeric/decimal/date
casts, CASE, IN, COALESCE, IS NULL, NOT, AND/OR, comparisons (numeric,
decimal incl. Int128, string codes), arithmetic (integer, double,
short and long decimal — add/sub/mul/div/mod, decimal(>18) divisors
included),
negation, EXTRACT(YEAR/MONTH/DAY), LIKE, abs, round, nullif,
greatest/least, and the dictionary string functions substr/substring,
upper, lower, length, trim/ltrim/rtrim, reverse, replace, starts_with
and concat (each a host transform of the dictionary plus a code remap
on the device), and the sketch primitives of the optimizer's approx
rewrites (hll_bucket, hll_rho, hll_weight, hll_weight_rho,
hll_estimate, pctl_bucket). Every other function (date arithmetic,
math beyond abs/round, regexp, json, url, time zones, lambdas, arrays
and maps, hashing, casts to and from varchar) raises
NotImplementedError naming itself (ROADMAP §1 item 3).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import Dictionary, RuntimeDictionary
from trino_tpu_torch.expr import functions as F
from trino_tpu_torch.expr.ir import Call, Case, Cast, Expr, InList, InputRef, Literal
from trino_tpu_torch.ops import int128 as I128
from trino_tpu_torch.ops.floatbits import f32_bits_ordered
from trino_tpu_torch.ops.hashing import dictionary_code_hashes, hash64

Value = Tuple[torch.Tensor, Optional[torch.Tensor]]
EvalFn = Callable[[List[torch.Tensor], List[Optional[torch.Tensor]]], Value]

_MICROS_PER_DAY = 86400 * 1000 * 1000


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
    return cols[0] if cols else torch.zeros(1)


def _const(shape_src: torch.Tensor, value, dtype) -> torch.Tensor:
    return torch.full(
        (shape_src.shape[0],), value, dtype=dtype, device=shape_src.device
    )


def _phys_const(shape_src: torch.Tensor, t: T.DataType, value128=(0, 0)):
    """Constant tensor in t's physical shape."""
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


def _table(values, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(values), dtype=dtype)


def _lookup(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table[clip(codes)] with the host-built table moved beside codes."""
    idx = torch.clamp(codes.to(torch.int64), 0, max(table.shape[0] - 1, 0))
    return table.to(codes.device)[idx]


def _not_ported(name: str):
    return NotImplementedError(
        f"{name}: not ported to trino_tpu_torch yet (ROADMAP §1 item 3)"
    )


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
        raise _not_ported(type(e).__name__)

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
        if t.is_nested:
            raise _not_ported(f"{t} literal")
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
        raise _not_ported(f"cast {src} -> {dst}")

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

    # ---- IN list ----
    def _bind_in(self, e: InList) -> Bound:
        v = self.bind(e.value)
        has_null_option = any(o.value is None for o in e.options)
        if v.type.is_string:
            codes = [v.dictionary.code(o.value) for o in e.options
                     if o.value is not None]
            opts = _table([c for c in codes if c >= 0], torch.int32)
        elif v.type.is_long_decimal:
            raise _not_ported("IN over decimal(>18)")
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
                hit = (d[:, None] == opts.to(d.device)[None, :]).any(dim=1)
            if has_null_option:
                val = hit if val is None else (val & hit)
            return hit, val
        return Bound(T.BOOLEAN, fn)

    # ---- calls ----
    def _bind_call(self, e: Call) -> Bound:
        name = e.name
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
                days = d
                if a.type.kind == T.TypeKind.TIMESTAMP:
                    days = torch.div(d, _MICROS_PER_DAY, rounding_mode="floor")
                return part(days).to(torch.int64), v
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
            frm = e.args[1]
            to = e.args[2] if len(e.args) > 2 else Literal("", T.VARCHAR)
            if not (isinstance(frm, Literal) and isinstance(to, Literal)):
                raise _not_ported("replace() with a non-constant search or replacement")
            return self._bind_dict_transform(
                args[0], e, lambda s: s.replace(frm.value, to.value))
        if name == "length":
            return self._bind_dict_table(args[0], T.BIGINT, len, torch.int64)
        if name == "starts_with":
            prefix = e.args[1]
            if not isinstance(prefix, Literal):
                raise _not_ported("starts_with() with a non-constant prefix")
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
        raise _not_ported(f"function {name}")

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
                vh = torch.from_numpy(
                    dictionary_code_hashes(a.dictionary.values).astype(np.int64)
                )

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
            raise _not_ported("string functions over an execution-time dictionary")

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
            raise _not_ported(f"{name} over decimal(>18)")
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

    def _bind_round(self, e: Call, args) -> Bound:
        """round(x[, d]): half away from zero; a decimal keeps its scale."""
        a = args[0]
        if len(args) > 1:
            if not args[1].is_const:
                raise _not_ported("round() with a non-constant scale")
            ndig = int(args[1].const_value)
        else:
            ndig = 0
        if a.type.is_long_decimal:
            raise _not_ported("round over decimal(>18)")
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
        a = args[0]
        pattern = e.args[1]
        if a.dictionary is None or len(a.dictionary) == 0 or not isinstance(
            pattern, Literal
        ):
            raise _not_ported("LIKE over a non-dictionary operand")
        escape = e.args[2].value if len(e.args) > 2 else None
        table = torch.from_numpy(
            F.dictionary_like_table(a.dictionary, pattern.value, escape)
        )

        def fn(cols, valids):
            d, v = a.fn(cols, valids)
            return _lookup(table, d), v
        return Bound(T.BOOLEAN, fn)

    def _bind_coalesce(self, e: Call, args) -> Bound:
        out_dict = None
        if e.type.is_string:
            merged = None
            for a in args:
                if a.dictionary is not None:
                    merged = a.dictionary if merged is None else Dictionary.unify(
                        merged, a.dictionary)[0]
            out_dict = merged
            args = [self._remap_to(a, out_dict) for a in args]
        elif e.type.is_long_decimal:
            raise _not_ported("coalesce over decimal(>18)")

        def fn(cols, valids):
            data, valid = args[-1].fn(cols, valids)
            data = data.to(e.type.dtype)
            for a in reversed(args[:-1]):
                d, v = a.fn(cols, valids)
                if v is None:
                    data, valid = d.to(e.type.dtype), None
                    continue
                data = torch.where(v, d.to(e.type.dtype), data)
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
        if a.type.kind == T.TypeKind.TIMESTAMP_TZ:
            raise _not_ported("TIMESTAMP WITH TIME ZONE comparison")
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
            raise _not_ported("string comparison over an execution-time dictionary")
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
                raise _not_ported(f"double {op} through decimal")
            return Bound(out_type, ffn)

        if a.type.is_long_decimal or b.type.is_long_decimal \
                or out_type.is_long_decimal:
            return self._bind_decimal128_arith(op, out_type, a, b, sa, sb, so)

        for x in (a, b):
            if not (x.type.is_decimal or x.type.is_integerlike):
                raise _not_ported(f"decimal arith with {x.type}")

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
            raise _not_ported(f"decimal {op}")
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


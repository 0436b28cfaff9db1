"""Vectorized scalar helpers used by the expression compiler.

Counterpart of trino_tpu/expr/functions.py: the civil calendar and
the date arithmetic built on it, integer division with SQL rounding,
LIKE patterns over dictionary values and sqrt with integer-root
snapping. Every division of a possibly negative value floors
(torch.div(..., rounding_mode="floor")), as the reference's // does.
"""

from __future__ import annotations

import datetime
import re

import numpy as np
import torch

EPOCH = datetime.date(1970, 1, 1)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def date_to_days(d: datetime.date) -> int:
    return (d - EPOCH).days


def days_to_date(days: int) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(days))


def add_months_scalar(d: datetime.date, months: int) -> datetime.date:
    """Host-side date + INTERVAL YEAR/MONTH (constant folding path)."""
    y = d.year + (d.month - 1 + months) // 12
    m = (d.month - 1 + months) % 12 + 1
    # clamp the day like SQL (Jan 31 + 1 month = Feb 28/29)
    last = (
        datetime.date(y + (m == 12), m % 12 + 1, 1) - datetime.timedelta(days=1)
    ).day
    return datetime.date(y, m, min(d.day, last))


def civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day) (Hinnant's
    civil_from_days with floor division)."""
    z = days.to(torch.int32) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(
        doe - torch.div(doe, 1460, rounding_mode="floor")
        + torch.div(doe, 36524, rounding_mode="floor")
        - torch.div(doe, 146096, rounding_mode="floor"),
        365, rounding_mode="floor",
    )
    y = yoe + era * 400
    doy = doe - (
        365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
        - torch.div(yoe, 100, rounding_mode="floor")
    )
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    year = torch.where(m <= 2, y + 1, y)
    return year, m, d


def extract_year(days):
    return civil_from_days(days)[0]


def extract_month(days):
    return civil_from_days(days)[1]


def extract_day(days):
    return civil_from_days(days)[2]


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Float rounding half away from zero (not banker's rounding)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _sign_of_quotient(num, den_safe):
    one = torch.ones((), dtype=num.dtype, device=num.device)
    return torch.where((num < 0) ^ (den_safe < 0), -one, one)


def div_trunc(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Integer division truncating toward zero (SQL), not floor."""
    den_safe = torch.where(den == 0, torch.ones_like(den), den)
    return _sign_of_quotient(num, den_safe) * torch.div(
        torch.abs(num), torch.abs(den_safe), rounding_mode="floor"
    )


def div_round_half_away(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Integer divide rounding half away from zero (decimal division
    rounding). Division by zero yields 0; the caller makes it NULL."""
    den_safe = torch.where(den == 0, torch.ones_like(den), den)
    ad = torch.abs(den_safe)
    q = torch.div(
        torch.abs(num) + torch.div(ad, 2, rounding_mode="floor"), ad,
        rounding_mode="floor",
    )
    return _sign_of_quotient(num, den_safe) * q


def like_to_regex(pattern: str, escape: str | None = None) -> "re.Pattern":
    """SQL LIKE pattern -> anchored python regex (evaluated over
    dictionary values only, never per row)."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def dictionary_like_table(dictionary, pattern: str, escape=None) -> np.ndarray:
    rx = like_to_regex(pattern, escape)
    return np.asarray([rx.match(v) is not None for v in dictionary.values], dtype=bool)


# -- civil-calendar composition and date arithmetic (date_trunc,
# date_add, date_diff, week, quarter, ...), int32 like the reference --


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days since 1970-01-01 (Hinnant's
    days_from_civil with floor division)."""
    y = y.to(torch.int32) - (m <= 2).to(torch.int32)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


_MONTH_LENGTHS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def days_in_month(y: torch.Tensor, m: torch.Tensor):
    """Length of month m in year y."""
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) | (
        torch.remainder(y, 400) == 0)
    lengths = torch.tensor(_MONTH_LENGTHS, dtype=torch.int32, device=m.device)
    base = lengths[torch.clamp(m - 1, 0, 11).to(torch.int64)]
    return torch.where((m == 2) & leap, torch.full_like(base, 29), base)


def day_of_week(days: torch.Tensor):
    """ISO day-of-week: Monday=1..Sunday=7 (1970-01-01 was a Thursday)."""
    return torch.remainder(days.to(torch.int32) + 3, 7) + 1


def day_of_year(days: torch.Tensor):
    y, _, _ = civil_from_days(days)
    jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return days.to(torch.int32) - jan1 + 1


def week_of_year(days: torch.Tensor):
    """ISO-8601 week number: the week holding this date's Thursday."""
    days = days.to(torch.int32)
    thursday = days - (day_of_week(days) - 4)
    y, _, _ = civil_from_days(thursday)
    jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return _fdiv(thursday - jan1, 7) + 1


def year_of_week(days: torch.Tensor):
    """ISO week-numbering year: the calendar year of this date's
    Thursday."""
    days = days.to(torch.int32)
    thursday = days - (day_of_week(days) - 4)
    return civil_from_days(thursday)[0]


def date_trunc_days(unit: str, days: torch.Tensor):
    """date_trunc on epoch-day values (DATE resolution units)."""
    days = days.to(torch.int32)
    if unit == "day":
        return days
    if unit == "week":  # ISO week start: Monday
        return days - (day_of_week(days) - 1)
    y, m, d = civil_from_days(days)
    one = torch.ones_like(y)
    if unit == "month":
        return days_from_civil(y, m, one)
    if unit == "quarter":
        return days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    if unit == "year":
        return days_from_civil(y, one, one)
    raise ValueError(f"unsupported date_trunc unit {unit!r}")


def add_months_vec(days: torch.Tensor, n: torch.Tensor):
    """date + n months with SQL end-of-month clamping."""
    y, m, d = civil_from_days(days)
    total = y * 12 + (m - 1) + n.to(torch.int32)
    ny = _fdiv(total, 12)
    nm = torch.remainder(total, 12) + 1
    nd = torch.minimum(d, days_in_month(ny, nm))
    return days_from_civil(ny, nm, nd)


def date_add_days(unit: str, n: torch.Tensor, days: torch.Tensor):
    n = n.to(torch.int32)
    days = days.to(torch.int32)
    if unit == "day":
        return days + n
    if unit == "week":
        return days + 7 * n
    if unit == "month":
        return add_months_vec(days, n)
    if unit == "quarter":
        return add_months_vec(days, 3 * n)
    if unit == "year":
        return add_months_vec(days, 12 * n)
    raise ValueError(f"unsupported date_add unit {unit!r}")


def date_diff_days(unit: str, a: torch.Tensor, b: torch.Tensor):
    """date_diff(unit, a, b): signed count of unit boundaries from a to
    b (b - a); month and year counts are full months elapsed."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    if unit == "day":
        return b - a
    if unit == "week":
        return div_trunc(b - a, torch.full_like(b, 7))
    if unit in ("month", "quarter", "year"):
        ya, ma, da = civil_from_days(a)
        yb, mb, db = civil_from_days(b)
        months = (yb * 12 + mb) - (ya * 12 + ma)
        # back off one month where the day of month is not yet reached
        months = months - ((months > 0) & (db < da)).to(months.dtype) \
            + ((months < 0) & (db > da)).to(months.dtype)
        if unit == "month":
            return months
        if unit == "quarter":
            return div_trunc(months, torch.full_like(months, 3))
        return div_trunc(months, torch.full_like(months, 12))
    raise ValueError(f"unsupported date_diff unit {unit!r}")


def last_day_of_month_days(days: torch.Tensor):
    y, m, _ = civil_from_days(days)
    return days_from_civil(y, m, days_in_month(y, m))


def sqrt_exact(x: torch.Tensor) -> torch.Tensor:
    """sqrt snapped to the integer root where that root is exact (the
    reference's contract: floor/truncate of sqrt(49) must be 7)."""
    y = torch.sqrt(x)
    yr = round_half_away(y)
    return torch.where(yr * yr == x, yr, y)

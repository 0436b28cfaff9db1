"""What every plain reference shares: the tables on a device, decimal
arithmetic at one of two precisions, grouping and ORDER BY ... LIMIT.

`Ctx(tables, device, precision)`: with precision "exact", decimal columns
are int64 units at their scale and every sum is exact, as the SQL types
state; with "float64" (the control) they are float64 values and the
arithmetic is done in float64. Filters read exact units in both, so the
two differ only in the arithmetic. `ctx.out(x, scale)` gives a value in
the form the statement protocol returns a decimal: the float nearest the
exact decimal.
"""

from __future__ import annotations

import dataclasses
import datetime
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.data import Table, decimal_scale

_EPOCH = datetime.date(1970, 1, 1)


def day(text: str) -> int:
    """'YYYY-MM-DD' as days since 1970-01-01."""
    return (datetime.date.fromisoformat(text) - _EPOCH).days


def plus_year(text: str) -> int:
    d = datetime.date.fromisoformat(text)
    return (d.replace(year=d.year + 1) - _EPOCH).days


def units(text: str, scale: int) -> int:
    """A decimal literal as int units at `scale` (exact)."""
    f = Fraction(text) * 10 ** scale
    if f.denominator != 1:
        raise ValueError(f"{text} has more than {scale} decimals")
    return int(f)


@dataclasses.dataclass
class Answer:
    """A statement's full answer: its rows in ORDER BY order (past the
    LIMIT, every row tied with the last one kept), the positions of the
    ORDER BY columns, the LIMIT and the row count before it."""

    rows: List[list]
    key_cols: Tuple[int, ...]
    limit: Optional[int]
    total: int


class Ctx:
    def __init__(self, tables: Dict[str, Table], device, precision: str = "exact"):
        if precision not in ("exact", "float64"):
            raise ValueError(precision)
        self.tables = tables
        self.device = torch.device(device)
        self.precision = precision
        self._cols: Dict[Tuple[str, str], torch.Tensor] = {}
        self._lookups: Dict[Tuple[str, str], torch.Tensor] = {}

    @property
    def exact(self) -> bool:
        return self.precision == "exact"

    def col(self, table: str, name: str) -> torch.Tensor:
        """The column as stored (decimal units, day numbers, string codes)."""
        key = (table, name)
        t = self._cols.get(key)
        if t is None:
            t = torch.from_numpy(self.tables[table].arrays[name]).to(self.device)
            self._cols[key] = t
        return t

    def dec(self, table: str, name: str) -> torch.Tensor:
        """A decimal column for arithmetic at this context's precision."""
        t = self.col(table, name)
        if self.exact:
            return t
        scale = decimal_scale(dict(self.tables[table].columns)[name])
        return t.to(torch.float64) / float(10 ** scale)

    def one(self, scale: int):
        """1 as a decimal of `scale` at this precision."""
        return 10 ** scale if self.exact else 1.0

    def zeros(self, n: int) -> torch.Tensor:
        dt = torch.int64 if self.exact else torch.float64
        return torch.zeros(n, dtype=dt, device=self.device)

    def out(self, x, scale: int) -> Optional[float]:
        """A decimal result as the protocol returns it: exact units / 10**scale
        rounded once to the nearest float; the control's float64 as is."""
        if x is None:
            return None
        if self.exact:
            return int(x) / 10 ** scale
        return float(x)

    def avg(self, total, count: int, scale: int) -> Optional[float]:
        """avg of a decimal: the exact mean rounded half away from zero to
        the input's scale (the SQL type of avg(decimal(p, s)))."""
        if count == 0:
            return None
        if not self.exact:
            return float(total) / count
        t = int(total)
        q, r = divmod(abs(t), count)
        if 2 * r >= count:
            q += 1
        return (q if t >= 0 else -q) / 10 ** scale

    def string(self, table: str, name: str, code: int) -> str:
        return self.tables[table].dictionaries[name][int(code)]

    def code(self, table: str, name: str, value: str) -> int:
        """The code of `value` in a string column (-1 when absent)."""
        vals = self.tables[table].dictionaries[name]
        try:
            return vals.index(value)
        except ValueError:
            return -1

    def lookup(self, table: str, key: str) -> torch.Tensor:
        """key value -> row index (-1 where no row has it), for an
        integer key column with no duplicates."""
        k = (table, key)
        t = self._lookups.get(k)
        if t is None:
            keys = self.col(table, key)
            t = torch.full((int(keys.max()) + 2,), -1, dtype=torch.int64,
                           device=self.device)
            t[keys] = torch.arange(keys.numel(), dtype=torch.int64, device=self.device)
            self._lookups[k] = t
        return t


def group_sums(key: torch.Tensor, values: Sequence[torch.Tensor]):
    """Distinct keys (ascending), the sum of each value tensor a key and the
    row count a key."""
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = [torch.zeros(uniq.numel(), dtype=v.dtype, device=v.device).index_add_(0, inv, v)
            for v in values]
    counts = torch.bincount(inv, minlength=uniq.numel())
    return uniq, sums, counts


def order_limit(cols: Sequence[Tuple[torch.Tensor, bool]], limit: Optional[int]) -> List[int]:
    """Row positions in ORDER BY order of (column, descending) pairs; past
    `limit`, the rows tied with the last one are kept."""
    n = cols[0][0].numel() if cols else 0
    if n == 0:
        return []
    dev = cols[0][0].device
    perm = torch.arange(n, device=dev)
    for t, desc in reversed(cols):
        perm = perm[torch.sort(t[perm], descending=desc, stable=True).indices]
    if limit is None or n <= limit:
        return perm.tolist()
    head = perm[:limit].tolist()
    last = [t[perm[limit - 1]].item() for t, _ in cols]
    i = limit
    while i < n and [t[perm[i]].item() for t, _ in cols] == last:
        head.append(int(perm[i]))
        i += 1
    return head

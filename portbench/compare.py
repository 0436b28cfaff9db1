"""Judge a statement's rows against its reference Answer.

Rows are compared in ORDER BY order. Where the reference has rows tied on
every ORDER BY column, any of them may stand at a tied position (the SQL
order among them is unspecified), and past the LIMIT only the tied rows
may stand in for one another. Every cell is compared exactly: integers,
strings and day numbers as they are, a decimal as the float nearest its
exact value, which is what the statement protocol returns for it.

`mismatched_cells` counts the cells that differ, and every cell of a row
that is missing or extra.
"""

from __future__ import annotations

from typing import List, Optional

from portbench.reference.common import Answer


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, bool) or isinstance(b, bool):
        return a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


def _cells_off(row: list, want: list) -> int:
    if len(row) != len(want):
        return max(len(row), len(want))
    return sum(not _same(a, b) for a, b in zip(row, want))


def mismatched_cells(rows: Optional[List[list]], ans: Answer) -> int:
    """Cells of `rows` (None: the statement gave no answer) that differ
    from the reference answer."""
    expect_n = ans.total if ans.limit is None else min(ans.limit, ans.total)
    width = len(ans.rows[0]) if ans.rows else 0
    if rows is None:
        return max(expect_n * width, 1)
    off = abs(len(rows) - expect_n) * max(width, 1)
    # the tie group of every reference position: rows equal on the keys
    keys = [tuple(r[c] for c in ans.key_cols) for r in ans.rows]
    used = [False] * len(ans.rows)
    for i, row in enumerate(rows[:expect_n]):
        group = [j for j in range(len(ans.rows)) if keys[j] == keys[i]] if ans.key_cols \
            else list(range(len(ans.rows)))
        best, best_off = None, None
        for j in group:
            if used[j]:
                continue
            o = _cells_off(row, ans.rows[j])
            if best_off is None or o < best_off:
                best, best_off = j, o
                if o == 0:
                    break
        if best is None:
            off += len(row)
            continue
        used[best] = True
        off += best_off
    return off

"""TPC-H Q12: late lines of two ship modes by their order's priority."""

import torch

from portbench.reference.common import Answer, day, plus_year


def run(ctx, p) -> Answer:
    lo, hi = day(p["DATE"]), plus_year(p["DATE"])
    modes = sorted({ctx.code("lineitem", "l_shipmode", p["SHIPMODE1"]),
                    ctx.code("lineitem", "l_shipmode", p["SHIPMODE2"])})
    mode = ctx.col("lineitem", "l_shipmode")
    ship, commit, receipt = (ctx.col("lineitem", c) for c in
                             ("l_shipdate", "l_commitdate", "l_receiptdate"))
    m = (torch.isin(mode, torch.tensor(modes, dtype=mode.dtype, device=ctx.device))
         & (commit < receipt) & (ship < commit) & (receipt >= lo) & (receipt < hi))
    orow = ctx.lookup("orders", "o_orderkey")[ctx.col("lineitem", "l_orderkey")[m]]
    prio = ctx.col("orders", "o_orderpriority")[orow]
    urgent = ctx.code("orders", "o_orderpriority", "1-URGENT")
    high_c = ctx.code("orders", "o_orderpriority", "2-HIGH")
    high = ((prio == urgent) | (prio == high_c)).to(torch.int64)
    mm = mode[m].to(torch.int64)
    rows = []
    for code in modes:
        sel = mm == code
        n = int(sel.sum())
        if n:
            h = int(high[sel].sum())
            rows.append([ctx.string("lineitem", "l_shipmode", code), h, n - h])
    return Answer(rows, (0,), None, len(rows))

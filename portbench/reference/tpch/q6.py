"""TPC-H Q6: forecasting revenue change over a year's discounted small lines."""

from portbench.reference.common import Answer, day, plus_year, units


def run(ctx, p) -> Answer:
    lo, hi = day(p["DATE"]), plus_year(p["DATE"])
    disc = units(p["DISCOUNT"], 2)
    ship = ctx.col("lineitem", "l_shipdate")
    d = ctx.col("lineitem", "l_discount")
    m = ((ship >= lo) & (ship < hi) & (d >= disc - 1) & (d <= disc + 1)
         & (ctx.col("lineitem", "l_quantity") < units(p["QUANTITY"], 2)))
    n = int(m.sum())
    rev = (ctx.dec("lineitem", "l_extendedprice")[m] * ctx.dec("lineitem", "l_discount")[m]).sum()
    return Answer([[ctx.out(rev.item(), 4) if n else None]], (), None, 1)

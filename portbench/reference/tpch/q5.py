"""TPC-H Q5: local supplier volume of one region's nations over a year."""

import torch

from portbench.reference.common import Answer, day, order_limit, plus_year


def run(ctx, p) -> Answer:
    lo, hi = day(p["DATE"]), plus_year(p["DATE"])
    rk = ctx.col("region", "r_regionkey")[
        ctx.col("region", "r_name") == ctx.code("region", "r_name", p["REGION"])]
    nation_ok = torch.isin(ctx.col("nation", "n_regionkey"), rk)  # row = nationkey
    odate = ctx.col("orders", "o_orderdate")
    order_ok = (odate >= lo) & (odate < hi)
    orow = ctx.lookup("orders", "o_orderkey")[ctx.col("lineitem", "l_orderkey")]
    c_nat = ctx.col("customer", "c_nationkey")[ctx.col("orders", "o_custkey")[orow] - 1]
    s_nat = ctx.col("supplier", "s_nationkey")[ctx.col("lineitem", "l_suppkey") - 1]
    m = order_ok[orow] & (c_nat == s_nat) & nation_ok[s_nat]
    rev = ctx.dec("lineitem", "l_extendedprice")[m] * (
        ctx.one(2) - ctx.dec("lineitem", "l_discount")[m])
    nat = s_nat[m]
    total = ctx.zeros(25).index_add_(0, nat, rev)
    counts = torch.bincount(nat, minlength=25)
    groups = torch.nonzero(counts).flatten()
    order = order_limit([(total[groups], True)], None)
    names = ctx.col("nation", "n_name")
    rows = [[ctx.string("nation", "n_name", names[groups[i]]),
             ctx.out(total[groups[i]].item(), 4)] for i in order]
    return Answer(rows, (1,), None, len(rows))

"""TPC-H Q3: shipping priority, the 10 unshipped orders of most revenue."""

import torch

from portbench.reference.common import Answer, day, order_limit


def run(ctx, p) -> Answer:
    d = day(p["DATE"])
    seg = ctx.code("customer", "c_mktsegment", p["SEGMENT"])
    cust_ok = ctx.col("customer", "c_mktsegment") == seg  # row = custkey - 1
    order_ok = (cust_ok[ctx.col("orders", "o_custkey") - 1]
                & (ctx.col("orders", "o_orderdate") < d))
    orow = ctx.lookup("orders", "o_orderkey")[ctx.col("lineitem", "l_orderkey")]
    m = (ctx.col("lineitem", "l_shipdate") > d) & order_ok[orow]
    rev = ctx.dec("lineitem", "l_extendedprice")[m] * (
        ctx.one(2) - ctx.dec("lineitem", "l_discount")[m])  # scale 4
    rows_of = orow[m]
    n_orders = ctx.col("orders", "o_orderkey").numel()
    total = ctx.zeros(n_orders).index_add_(0, rows_of, rev)
    hit = torch.zeros(n_orders, dtype=torch.bool, device=ctx.device)
    hit[rows_of] = True
    groups = torch.nonzero(hit).flatten()
    revenue = total[groups]
    odate = ctx.col("orders", "o_orderdate")[groups]
    order = order_limit([(revenue, True), (odate, False)], 10)
    okey = ctx.col("orders", "o_orderkey")[groups]
    prio = ctx.col("orders", "o_shippriority")[groups]
    rows = [[int(okey[i]), ctx.out(revenue[i].item(), 4), int(odate[i]), int(prio[i])]
            for i in order]
    return Answer(rows, (1, 2), 10, int(groups.numel()))

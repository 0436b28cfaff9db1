"""TPC-H Q18: large volume customers, orders of more than QUANTITY units."""

import torch

from portbench.reference.common import Answer, order_limit, units


def run(ctx, p) -> Answer:
    orow = ctx.lookup("orders", "o_orderkey")[ctx.col("lineitem", "l_orderkey")]
    n_orders = ctx.col("orders", "o_orderkey").numel()
    qty = ctx.dec("lineitem", "l_quantity")
    sums = ctx.zeros(n_orders).index_add_(0, orow, qty)
    exact = torch.zeros(n_orders, dtype=torch.int64, device=ctx.device).index_add_(
        0, orow, ctx.col("lineitem", "l_quantity"))
    big = torch.nonzero(exact > units(str(p["QUANTITY"]), 2)).flatten()
    price = ctx.col("orders", "o_totalprice")[big]
    odate = ctx.col("orders", "o_orderdate")[big]
    order = order_limit([(price, True), (odate, False)], 100)
    cust = ctx.col("orders", "o_custkey")[big]
    okey = ctx.col("orders", "o_orderkey")[big]
    name = ctx.col("customer", "c_name")
    rows = [[ctx.string("customer", "c_name", name[cust[i] - 1]), int(cust[i]), int(okey[i]),
             int(odate[i]), int(price[i]) / 100, ctx.out(sums[big[i]].item(), 2)]
            for i in order]
    return Answer(rows, (4, 3), 100, int(big.numel()))

"""TPC-H Q1: pricing summary over lineitem shipped by 1998-12-01 - DELTA days."""

import torch

from portbench.reference.common import Answer, day


def run(ctx, p) -> Answer:
    cutoff = day("1998-12-01") - int(p["DELTA"])
    m = ctx.col("lineitem", "l_shipdate") <= cutoff
    g = (ctx.col("lineitem", "l_returnflag").to(torch.int64) * 2
         + ctx.col("lineitem", "l_linestatus").to(torch.int64))[m]
    qty, ext, disc, tax = (ctx.dec("lineitem", c)[m] for c in
                           ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = ext * (ctx.one(2) - disc)  # scale 4
    charge = disc_price * (ctx.one(2) + tax)  # scale 6
    sums = [ctx.zeros(6).index_add_(0, g, v) for v in (qty, ext, disc_price, charge, disc)]
    counts = torch.bincount(g, minlength=6).tolist()
    rows = []
    for k in range(6):  # flag and status codes in their strings' order
        c = counts[k]
        if c == 0:
            continue
        s = [x[k].item() for x in sums]
        rows.append([ctx.string("lineitem", "l_returnflag", k // 2),
                     ctx.string("lineitem", "l_linestatus", k % 2),
                     ctx.out(s[0], 2), ctx.out(s[1], 2), ctx.out(s[2], 4), ctx.out(s[3], 6),
                     ctx.avg(s[0], c, 2), ctx.avg(s[1], c, 2), ctx.avg(s[4], c, 2), c])
    return Answer(rows, (0, 1), None, len(rows))

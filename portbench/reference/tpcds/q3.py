"""TPC-DS query3: one manufacturer's brands' sales in one month of every year."""

from portbench.reference.common import Answer, group_sums, order_limit
from portbench.reference.tpcds._star import brand_of, sales


def run(ctx, p) -> Answer:
    item_ok = ctx.col("item", "i_manufact_id") == int(p["MANUFACT"])
    date_ok = ctx.col("date_dim", "d_moy") == int(p["MONTH"])
    item, date, price = sales(ctx, item_ok, date_ok)
    brand_id, brand = brand_of(ctx, item)
    year = ctx.col("date_dim", "d_year")[date]
    key = year * 100_000_000 + brand_id
    uniq, (total,), _ = group_sums(key, [price])
    g_year, g_brand = uniq // 100_000_000, uniq % 100_000_000
    order = order_limit([(g_year, False), (total, True), (g_brand, False)], 100)
    code = {int(b): int(c) for b, c in zip(brand_id.tolist(), brand.tolist())}
    rows = [[int(g_year[i]), int(g_brand[i]),
             ctx.string("item", "i_brand", code[int(g_brand[i])]),
             ctx.out(total[i].item(), 2)] for i in order]
    return Answer(rows, (0, 3, 1), 100, int(uniq.numel()))

"""TPC-DS query55: one manager's brand sales in one month."""

from portbench.reference.common import Answer, group_sums, order_limit
from portbench.reference.tpcds._star import brand_of, sales


def run(ctx, p) -> Answer:
    item_ok = ctx.col("item", "i_manager_id") == int(p["MANAGER"])
    date_ok = (ctx.col("date_dim", "d_moy") == int(p["MONTH"])) & (
        ctx.col("date_dim", "d_year") == int(p["YEAR"]))
    item, _, price = sales(ctx, item_ok, date_ok)
    brand_id, brand = brand_of(ctx, item)
    uniq, (total,), _ = group_sums(brand_id, [price])
    order = order_limit([(total, True), (uniq, False)], 100)
    code = {int(b): int(c) for b, c in zip(brand_id.tolist(), brand.tolist())}
    rows = [[int(uniq[i]), ctx.string("item", "i_brand", code[int(uniq[i])]),
             ctx.out(total[i].item(), 2)] for i in order]
    return Answer(rows, (2, 0), 100, int(uniq.numel()))

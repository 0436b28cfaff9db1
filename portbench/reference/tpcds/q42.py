"""TPC-DS query42: manager 1's category sales in one month."""

from portbench.reference.common import Answer, group_sums, order_limit
from portbench.reference.tpcds._star import sales


def run(ctx, p) -> Answer:
    year = int(p["YEAR"])
    item_ok = ctx.col("item", "i_manager_id") == 1
    date_ok = (ctx.col("date_dim", "d_moy") == int(p["MONTH"])) & (
        ctx.col("date_dim", "d_year") == year)
    item, _, price = sales(ctx, item_ok, date_ok)
    cat = ctx.col("item", "i_category_id")[item]
    uniq, (total,), _ = group_sums(cat, [price])
    order = order_limit([(total, True), (uniq, False)], 100)
    rows = [[year, int(uniq[i]), ctx.string("item", "i_category", int(uniq[i]) - 1),
             ctx.out(total[i].item(), 2)] for i in order]
    return Answer(rows, (3, 0, 1, 2), 100, int(uniq.numel()))

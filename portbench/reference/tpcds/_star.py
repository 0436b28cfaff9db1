"""The store_sales star shared by the templates: qualifying items and
dates, and the sales rows that join both."""

import torch

from portbench.gen.tpcds import DATE_SK0


def sales(ctx, item_ok: torch.Tensor, date_ok: torch.Tensor):
    """(item row, date row, ext_sales_price) of the sales whose item and
    date qualify; item_ok is indexed by item row, date_ok by date row."""
    item = ctx.col("store_sales", "ss_item_sk") - 1
    date = ctx.col("store_sales", "ss_sold_date_sk") - DATE_SK0
    m = item_ok[item] & date_ok[date]
    return item[m], date[m], ctx.dec("store_sales", "ss_ext_sales_price")[m]


def brand_of(ctx, item_rows: torch.Tensor):
    """(i_brand_id, i_brand code) of item rows."""
    return (ctx.col("item", "i_brand_id")[item_rows], ctx.col("item", "i_brand")[item_rows])

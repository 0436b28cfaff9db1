"""TPC-DS store_sales star (Standard Specification v3.2.0) drawn on the
device from a seed (the configuration's `data_seed`) with one
torch.Generator.

date_dim is the spec's calendar (d_date_sk 2,415,022 is 1900-01-02... as
dsdgen numbers it: 73,049 days from 1900-01-02). item, store and
store_sales take the spec's row counts and value ranges, drawn uniformly
(dsdgen's seasonal and skewed distributions are not reproduced). A
brand's name is a function of its id, so `group by i_brand, i_brand_id`
has one name an id. Only the columns the store_sales templates read, and
the keys, are generated.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.data import Table, host, torch_generator

DATE_SK0 = 2_415_022  # d_date_sk of 1900-01-02
DATE_ROWS = 73_049
DAY0 = -25_566  # 1900-01-02, days since 1970-01-01
SOLD_SK_LO, SOLD_SK_HI = 2_450_816, 2_452_642  # 1998-01-02 .. 2003-01-02

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women"]
CLASSES = 16  # classes a category
BRANDS = 10  # brands a class
_SYL = ["able", "anti", "bar", "cally", "eing", "ese", "n st", "ought", "pri", "ation",
        "amalg", "edu pack", "export", "import", "scholar", "univ"]
STORE_NAMES = ["able", "anti", "bar", "cally", "eing", "ese", "ought", "pri", "ation", "n st"]

DEC = "decimal(7,2)"


def sizes(sf: float) -> dict:
    def scaled(base):
        return max(1, int(round(base * sf)))

    # item and store follow the spec's table of row counts at SF10
    # (102,000 and 102); store_sales 2,880,000 a scale factor
    return {"item": scaled(10_200), "store": max(1, int(round(10.2 * sf))),
            "store_sales": scaled(2_880_000)}


def brand_name(brand_id: int) -> str:
    cat, rest = divmod(brand_id, 1_000_000)
    cls, idx = divmod(rest, 1_000)
    return f"{_SYL[cls - 1]}{CATEGORIES[cat - 1].lower()} #{idx}"


def _calendar():
    days = np.arange(DAY0, DAY0 + DATE_ROWS, dtype=np.int64)
    d = days.astype("datetime64[D]")
    year = d.astype("datetime64[Y]").astype(np.int64) + 1970
    month = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return days, year, month, dom


def generate(sf: float, seed: int, device) -> dict:
    g = torch_generator(seed, device)
    n = sizes(sf)
    i64 = torch.int64

    def rint(lo, hi, count):
        return torch.randint(lo, hi + 1, (count,), generator=g, device=device, dtype=i64)

    out = {}
    days, year, month, dom = _calendar()
    out["date_dim"] = Table(
        [("d_date_sk", "bigint"), ("d_date", "date"), ("d_year", "bigint"),
         ("d_moy", "bigint"), ("d_dom", "bigint")],
        {"d_date_sk": DATE_SK0 + np.arange(DATE_ROWS, dtype=np.int64),
         "d_date": days.astype(np.int32), "d_year": year, "d_moy": month, "d_dom": dom},
        {})

    ni = n["item"]
    cat = rint(1, len(CATEGORIES), ni)
    cls = rint(1, CLASSES, ni)
    idx = rint(1, BRANDS, ni)
    brand_id = cat * 1_000_000 + cls * 1_000 + idx
    all_ids = sorted(c * 1_000_000 + k * 1_000 + b for c in range(1, len(CATEGORIES) + 1)
                     for k in range(1, CLASSES + 1) for b in range(1, BRANDS + 1))
    names = sorted(brand_name(b) for b in all_ids)
    code_of = np.zeros(all_ids[-1] + 1, dtype=np.int32)
    for b in all_ids:
        code_of[b] = names.index(brand_name(b))
    out["item"] = Table(
        [("i_item_sk", "bigint"), ("i_brand_id", "bigint"), ("i_brand", "varchar"),
         ("i_category_id", "bigint"), ("i_category", "varchar"),
         ("i_manufact_id", "bigint"), ("i_manager_id", "bigint")],
        {"i_item_sk": np.arange(1, ni + 1, dtype=np.int64),
         "i_brand_id": host(brand_id),
         "i_brand": code_of[host(brand_id)],
         "i_category_id": host(cat),
         "i_category": host(cat - 1).astype(np.int32),
         "i_manufact_id": host(rint(1, 1_000, ni)),
         "i_manager_id": host(rint(1, 100, ni))},
        {"i_brand": names, "i_category": list(CATEGORIES)})

    nst = n["store"]
    store_ids = [f"AAAAAAAA{k:08d}" for k in range(1, nst + 1)]
    out["store"] = Table(
        [("s_store_sk", "bigint"), ("s_store_id", "varchar"), ("s_store_name", "varchar"),
         ("s_gmt_offset", "decimal(5,2)")],
        {"s_store_sk": np.arange(1, nst + 1, dtype=np.int64),
         "s_store_id": np.arange(nst, dtype=np.int32),
         "s_store_name": host(rint(0, len(STORE_NAMES) - 1, nst)).astype(np.int32),
         "s_gmt_offset": host(rint(-6, -5, nst)) * 100},
        {"s_store_id": store_ids, "s_store_name": sorted(STORE_NAMES)})

    nss = n["store_sales"]
    quantity = rint(1, 100, nss)
    price = rint(0, 20_000, nss)  # ss_sales_price, cents
    out["store_sales"] = Table(
        [("ss_sold_date_sk", "bigint"), ("ss_item_sk", "bigint"),
         ("ss_ext_sales_price", DEC)],
        {"ss_sold_date_sk": host(rint(SOLD_SK_LO, SOLD_SK_HI, nss)),
         "ss_item_sk": host(rint(1, ni, nss)),
         "ss_ext_sales_price": host(quantity * price)},
        {})
    return out

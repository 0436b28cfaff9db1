"""TPC-H tables (Standard Specification rev. 3.0.1, clause 4.2.3) drawn on
the device from a seed (the configuration's `data_seed`) with one
torch.Generator.

The spec's ranges and rules, not dbgen's byte stream: sparse order keys
(8 of every 32), customers whose key is a multiple of 3 place no order,
1-7 lines an order, the supplier of a line from its part by the spec's
formula, the part's retail price from its key, the dates, flags and
statuses from the order date and CURRENTDATE, and o_totalprice and
o_orderstatus from the order's lines. part and partsupp are not
generated, nor any free-text column (comments, addresses, phones).
"""

from __future__ import annotations

import datetime

import torch

from portbench.data import Table, host, torch_generator

_EPOCH = datetime.date(1970, 1, 1)


def _day(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = _day(1992, 1, 1)
ENDDATE = _day(1998, 12, 31)
CURRENTDATE = _day(1995, 6, 17)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey), key = position
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]

DEC = "decimal(12,2)"


def sizes(sf: float) -> dict:
    def scaled(base):
        return max(1, int(round(base * sf)))

    return {"supplier": scaled(10_000), "customer": scaled(150_000),
            "orders": scaled(1_500_000), "part": scaled(200_000),
            "clerks": scaled(1_000)}


def _keys_name(prefix: str, n: int):
    """'Prefix#000000001'..: zero-padded, so sorted order is key order and
    key k has code k - 1."""
    return [f"{prefix}#{k:09d}" for k in range(1, n + 1)]


def generate(sf: float, seed: int, device) -> dict:
    g = torch_generator(seed, device)
    n = sizes(sf)
    i64 = torch.int64

    def rint(lo, hi, count):  # uniform integers in [lo, hi]
        return torch.randint(lo, hi + 1, (count,), generator=g, device=device, dtype=i64)

    out = {}
    out["region"] = Table(
        [("r_regionkey", "bigint"), ("r_name", "varchar")],
        {"r_regionkey": host(torch.arange(5, dtype=i64)),
         "r_name": host(torch.arange(5, dtype=torch.int32))},
        {"r_name": list(REGIONS)})
    names = sorted(nm for nm, _ in NATIONS)
    out["nation"] = Table(
        [("n_nationkey", "bigint"), ("n_name", "varchar"), ("n_regionkey", "bigint")],
        {"n_nationkey": host(torch.arange(25, dtype=i64)),
         "n_name": host(torch.tensor([names.index(nm) for nm, _ in NATIONS],
                                     dtype=torch.int32)),
         "n_regionkey": host(torch.tensor([r for _, r in NATIONS], dtype=i64))},
        {"n_name": names})

    ns = n["supplier"]
    out["supplier"] = Table(
        [("s_suppkey", "bigint"), ("s_name", "varchar"), ("s_nationkey", "bigint"),
         ("s_acctbal", DEC)],
        {"s_suppkey": host(torch.arange(1, ns + 1, dtype=i64)),
         "s_name": host(torch.arange(ns, dtype=torch.int32)),
         "s_nationkey": host(rint(0, 24, ns)),
         "s_acctbal": host(rint(-99_999, 999_999, ns))},
        {"s_name": _keys_name("Supplier", ns)})

    nc = n["customer"]
    out["customer"] = Table(
        [("c_custkey", "bigint"), ("c_name", "varchar"), ("c_nationkey", "bigint"),
         ("c_acctbal", DEC), ("c_mktsegment", "varchar")],
        {"c_custkey": host(torch.arange(1, nc + 1, dtype=i64)),
         "c_name": host(torch.arange(nc, dtype=torch.int32)),
         "c_nationkey": host(rint(0, 24, nc)),
         "c_acctbal": host(rint(-99_999, 999_999, nc)),
         "c_mktsegment": host(rint(0, 4, nc).to(torch.int32))},
        {"c_name": _keys_name("Customer", nc), "c_mktsegment": list(SEGMENTS)})

    no = n["orders"]
    idx = torch.arange(no, dtype=i64, device=device)
    orderkey = (idx // 8) * 32 + idx % 8 + 1
    # customers whose key is not a multiple of 3: the r-th is (r//2)*3 + r%2 + 1
    r = rint(0, nc - nc // 3 - 1, no)
    custkey = (r // 2) * 3 + r % 2 + 1
    orderdate = rint(STARTDATE, ENDDATE - 151, no)
    priority = rint(0, 4, no)
    clerk = rint(0, n["clerks"] - 1, no)

    nlines = rint(1, 7, no)
    line_order = torch.repeat_interleave(idx, nlines)
    nl = int(line_order.numel())
    starts = torch.cumsum(nlines, 0) - nlines
    linenumber = torch.arange(nl, dtype=i64, device=device) - starts[line_order] + 1
    partkey = rint(1, n["part"], nl)
    supp_i = rint(0, 3, nl)
    s = ns
    suppkey = (partkey + supp_i * (s // 4 + (partkey - 1) // s)) % s + 1
    quantity = rint(1, 50, nl)
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)  # cents
    extprice = quantity * retail
    discount = rint(0, 10, nl)
    tax = rint(0, 8, nl)
    odate = orderdate[line_order]
    shipdate = odate + rint(1, 121, nl)
    commitdate = odate + rint(30, 90, nl)
    receiptdate = shipdate + rint(1, 30, nl)
    ra = rint(0, 1, nl)  # A or R where the line was received
    returnflag = torch.where(receiptdate <= CURRENTDATE, ra * 2, torch.ones_like(ra))
    linestatus = (shipdate > CURRENTDATE).to(i64)  # F=0, O=1
    shipinstruct = rint(0, 3, nl)
    shipmode = rint(0, 6, nl)

    charge = extprice * (100 + tax) * (100 - discount)  # scale 6
    total = torch.zeros(no, dtype=i64, device=device).index_add_(0, line_order, charge)
    totalprice = torch.div(total + 5_000, 10_000, rounding_mode="floor")
    n_open = torch.zeros(no, dtype=i64, device=device).index_add_(0, line_order, linestatus)
    status = torch.where(n_open == 0, 0, torch.where(n_open == nlines, 1, 2))  # F, O, P

    i32 = torch.int32
    out["orders"] = Table(
        [("o_orderkey", "bigint"), ("o_custkey", "bigint"), ("o_orderstatus", "varchar"),
         ("o_totalprice", DEC), ("o_orderdate", "date"), ("o_orderpriority", "varchar"),
         ("o_clerk", "varchar"), ("o_shippriority", "bigint")],
        {"o_orderkey": host(orderkey), "o_custkey": host(custkey),
         "o_orderstatus": host(status.to(i32)), "o_totalprice": host(totalprice),
         "o_orderdate": host(orderdate.to(i32)), "o_orderpriority": host(priority.to(i32)),
         "o_clerk": host(clerk.to(i32)),
         "o_shippriority": host(torch.zeros(no, dtype=i64))},
        {"o_orderstatus": ["F", "O", "P"], "o_orderpriority": list(PRIORITIES),
         "o_clerk": _keys_name("Clerk", n["clerks"])})
    out["lineitem"] = Table(
        [("l_orderkey", "bigint"), ("l_partkey", "bigint"), ("l_suppkey", "bigint"),
         ("l_linenumber", "bigint"), ("l_quantity", DEC), ("l_extendedprice", DEC),
         ("l_discount", DEC), ("l_tax", DEC), ("l_returnflag", "varchar"),
         ("l_linestatus", "varchar"), ("l_shipdate", "date"), ("l_commitdate", "date"),
         ("l_receiptdate", "date"), ("l_shipinstruct", "varchar"),
         ("l_shipmode", "varchar")],
        {"l_orderkey": host(orderkey[line_order]), "l_partkey": host(partkey),
         "l_suppkey": host(suppkey), "l_linenumber": host(linenumber),
         "l_quantity": host(quantity * 100), "l_extendedprice": host(extprice),
         "l_discount": host(discount), "l_tax": host(tax),
         "l_returnflag": host(returnflag.to(i32)), "l_linestatus": host(linestatus.to(i32)),
         "l_shipdate": host(shipdate.to(i32)), "l_commitdate": host(commitdate.to(i32)),
         "l_receiptdate": host(receiptdate.to(i32)),
         "l_shipinstruct": host(shipinstruct.to(i32)), "l_shipmode": host(shipmode.to(i32))},
        {"l_returnflag": ["A", "N", "R"], "l_linestatus": ["F", "O"],
         "l_shipinstruct": list(SHIPINSTRUCT), "l_shipmode": list(SHIPMODES)})
    return out

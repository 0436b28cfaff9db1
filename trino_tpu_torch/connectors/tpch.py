"""TPC-H generator connector.

Analogue of plugin/trino-tpch (TpchConnectorFactory.java,
TpchNodePartitioningProvider.java — SURVEY.md §2.12): a deterministic,
in-memory TPC-H data generator exposed through the connector SPI, the
fixture source for correctness tests and benchmarks.

Not a port of dbgen: generation is *counter-based* — every cell is a
pure function ``f(seed, table, column, key)`` via splitmix64, so any
split of any column materializes independently, in vectorized numpy,
with no generator state. This is what makes splits retryable (FTE) and
lets column pruning skip work entirely. Schema, row counts, key
relationships (sparse order keys, the partsupp supplier spread, the
1/3-of-customers-have-no-orders rule) and value distributions follow
the TPC-H spec structure so query selectivities look right; text is
drawn from bounded pools, which keeps string dictionaries table-stable
(see spi.py) without materializing millions of distinct comments.

Schemas: tiny (sf 0.01), sf1, sf10, sf100, plus sf<float> on demand.
"""

from __future__ import annotations

import datetime
import hashlib
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import Column, Dictionary, RelBatch, bucket_capacity
from trino_tpu_torch.connectors.spi import (
    ColumnMetadata,
    Connector,
    ConnectorMetadata,
    ConnectorPageSource,
    ConnectorSplitManager,
    Split,
    TableHandle,
    TableMetadata,
    TableStatistics,
)

# ---------------------------------------------------------------------------
# counter-based uniform randomness
# ---------------------------------------------------------------------------

_U = np.uint64


@lru_cache(maxsize=4096)
def _stable_seed(*parts) -> int:
    """Process-independent seed (python's hash() is randomized per run)."""
    h = hashlib.sha256("|".join(map(str, parts)).encode()).digest()
    return int.from_bytes(h[:8], "little")


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _U(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = ((x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x = ((x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> _U(31))


def _stream(table: str, column: str, keys: np.ndarray, salt: int = 0) -> np.ndarray:
    """u64 uniform stream, deterministic per (table, column, salt, key)."""
    seed = _U(_stable_seed(table, column, salt, "tpch-tpu-v1"))
    return _splitmix64(keys.astype(np.uint64) ^ seed)


def _uniform(table, column, keys, lo: int, hi: int, salt: int = 0) -> np.ndarray:
    """uniform integers in [lo, hi] inclusive (dbgen's random(lo,hi))."""
    u = _stream(table, column, keys, salt)
    span = _U(hi - lo + 1)
    return (lo + (u % span).astype(np.int64)).astype(np.int64)


# ---------------------------------------------------------------------------
# calendar constants
# ---------------------------------------------------------------------------

_EPOCH = datetime.date(1970, 1, 1)


def _d(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = _d(1992, 1, 1)
ENDDATE = _d(1998, 12, 31)
CURRENTDATE = _d(1995, 6, 17)
ORDER_DATE_MAX = ENDDATE - 151  # 1998-08-02, per spec


# ---------------------------------------------------------------------------
# fixed vocabularies (spec lists, small dictionaries)
# ---------------------------------------------------------------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

NATIONS = [  # (name, regionkey) — spec's 25 nations
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
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]

TYPE_SYLL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_SYLL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYLL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange", "orchid",
    "pale", "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]

_FILLER = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "deposits",
    "packages", "requests", "accounts", "instructions", "foxes", "pinto",
    "beans", "ideas", "theodolites", "dependencies", "excuses", "platelets",
    "asymptotes", "courts", "dolphins", "multipliers", "sauternes", "warhorses",
    "sheaves", "pearls", "wake", "sleep", "nag", "haggle", "bold", "final",
    "ironic", "pending", "regular", "express", "unusual", "even", "silent",
    "daring", "about", "above", "according", "across", "after", "against",
]


def _make_comment_pool(name: str, size: int, inject: Optional[Tuple[str, str]],
                       inject_fraction: float) -> List[str]:
    """Bounded pool of comment strings; a fraction contain the two
    injected words in order with filler between (for LIKE '%a%b%')."""
    rng = np.random.default_rng(_stable_seed(name, "pool", "tpch-tpu-v1") % (2**32))
    pool = []
    n_inject = int(size * inject_fraction)
    for i in range(size):
        k = int(rng.integers(4, 9))
        words = [_FILLER[int(rng.integers(0, len(_FILLER)))] for _ in range(k)]
        if inject is not None and i < n_inject:
            words[1] = inject[0]
            words[k - 2] = inject[1]
        pool.append(" ".join(words))
    return pool


@lru_cache(maxsize=None)
def _comment_dict(kind: str) -> Dictionary:
    if kind == "order":  # Q13: '%special%requests%'
        return Dictionary(_make_comment_pool("order", 3000, ("special", "requests"), 0.02))
    if kind == "supplier":  # Q16: '%Customer%Complaints%'
        return Dictionary(_make_comment_pool("supplier", 1500, ("Customer", "Complaints"), 0.01))
    return Dictionary(_make_comment_pool(kind, 2000, None, 0.0))


@lru_cache(maxsize=None)
def _address_pool(kind: str, size: int = 20000) -> Dictionary:
    rng = np.random.default_rng(_stable_seed(kind, "addr", "tpch-tpu-v1") % (2**32))
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,"))
    vals = []
    for _ in range(size):
        k = int(rng.integers(10, 25))
        vals.append("".join(alphabet[rng.integers(0, len(alphabet), k)]))
    return Dictionary(vals)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

_DEC = T.decimal(12, 2)

TABLES: Dict[str, List[Tuple[str, T.DataType]]] = {
    "region": [
        ("r_regionkey", T.BIGINT), ("r_name", T.VARCHAR), ("r_comment", T.VARCHAR)],
    "nation": [
        ("n_nationkey", T.BIGINT), ("n_name", T.VARCHAR),
        ("n_regionkey", T.BIGINT), ("n_comment", T.VARCHAR)],
    "supplier": [
        ("s_suppkey", T.BIGINT), ("s_name", T.VARCHAR), ("s_address", T.VARCHAR),
        ("s_nationkey", T.BIGINT), ("s_phone", T.VARCHAR), ("s_acctbal", _DEC),
        ("s_comment", T.VARCHAR)],
    "part": [
        ("p_partkey", T.BIGINT), ("p_name", T.VARCHAR), ("p_mfgr", T.VARCHAR),
        ("p_brand", T.VARCHAR), ("p_type", T.VARCHAR), ("p_size", T.BIGINT),
        ("p_container", T.VARCHAR), ("p_retailprice", _DEC), ("p_comment", T.VARCHAR)],
    "partsupp": [
        ("ps_partkey", T.BIGINT), ("ps_suppkey", T.BIGINT),
        ("ps_availqty", T.BIGINT), ("ps_supplycost", _DEC), ("ps_comment", T.VARCHAR)],
    "customer": [
        ("c_custkey", T.BIGINT), ("c_name", T.VARCHAR), ("c_address", T.VARCHAR),
        ("c_nationkey", T.BIGINT), ("c_phone", T.VARCHAR), ("c_acctbal", _DEC),
        ("c_mktsegment", T.VARCHAR), ("c_comment", T.VARCHAR)],
    "orders": [
        ("o_orderkey", T.BIGINT), ("o_custkey", T.BIGINT), ("o_orderstatus", T.VARCHAR),
        ("o_totalprice", _DEC), ("o_orderdate", T.DATE), ("o_orderpriority", T.VARCHAR),
        ("o_clerk", T.VARCHAR), ("o_shippriority", T.BIGINT), ("o_comment", T.VARCHAR)],
    "lineitem": [
        ("l_orderkey", T.BIGINT), ("l_partkey", T.BIGINT), ("l_suppkey", T.BIGINT),
        ("l_linenumber", T.BIGINT), ("l_quantity", _DEC), ("l_extendedprice", _DEC),
        ("l_discount", _DEC), ("l_tax", _DEC), ("l_returnflag", T.VARCHAR),
        ("l_linestatus", T.VARCHAR), ("l_shipdate", T.DATE), ("l_commitdate", T.DATE),
        ("l_receiptdate", T.DATE), ("l_shipinstruct", T.VARCHAR),
        ("l_shipmode", T.VARCHAR), ("l_comment", T.VARCHAR)],
}


def _scaled(base: int, sf: float) -> int:
    return max(1, int(round(base * sf)))


def base_row_count(table: str, sf: float) -> int:
    """Rows before lineitem expansion (for lineitem: ORDER count)."""
    return {
        "region": 5,
        "nation": 25,
        "supplier": _scaled(10_000, sf),
        "part": _scaled(200_000, sf),
        "partsupp": _scaled(200_000, sf) * 4,
        "customer": _scaled(150_000, sf),
        "orders": _scaled(1_500_000, sf),
        "lineitem": _scaled(1_500_000, sf),
    }[table]


def _n_customers(sf):
    return _scaled(150_000, sf)


def _n_parts(sf):
    return _scaled(200_000, sf)


def _n_suppliers(sf):
    return _scaled(10_000, sf)


def _n_orders(sf):
    return _scaled(1_500_000, sf)


def _n_clerks(sf):
    return max(1, _scaled(1_000, sf))


# sparse order keys: 8 used keys per 32-key block (spec's mk_sparse)
def order_index_to_key(idx: np.ndarray) -> np.ndarray:
    i = idx.astype(np.int64)
    return ((i >> 3) << 5) + (i & 7) + 1


def _line_counts(order_idx: np.ndarray) -> np.ndarray:
    """lines per order, 1..7, deterministic on order index."""
    return _uniform("lineitem", "count", order_idx, 1, 7)


@lru_cache(maxsize=8)
def lineitem_row_count(sf: float) -> int:
    n = _n_orders(sf)
    total = 0
    step = 4_000_000
    for a in range(0, n, step):
        idx = np.arange(a, min(a + step, n), dtype=np.int64)
        total += int(_line_counts(idx).sum())
    return total


# ---------------------------------------------------------------------------
# per-order lineitem economics (shared by orders.o_totalprice and lineitem)
# ---------------------------------------------------------------------------


def _retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    pk = partkey.astype(np.int64)
    return 90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)


def _line_fields(order_idx: np.ndarray, line_no: np.ndarray, sf: float):
    """Per-(order, line) deterministic economics; keys mix both."""
    k = order_idx.astype(np.int64) * 8 + line_no.astype(np.int64)
    qty = _uniform("lineitem", "qty", k, 1, 50)
    partkey = _uniform("lineitem", "part", k, 1, _n_parts(sf))
    disc = _uniform("lineitem", "disc", k, 0, 10)  # percent
    tax = _uniform("lineitem", "tax", k, 0, 8)  # percent
    eprice = qty * _retail_price_cents(partkey)  # cents (scale 2)
    return qty, partkey, disc, tax, eprice


def _order_total_cents(order_idx: np.ndarray, sf: float) -> np.ndarray:
    """o_totalprice = sum over lines of eprice*(1+tax)*(1-disc), rounded
    per line to cents like the spec's per-line money rounding."""
    counts = _line_counts(order_idx)
    total = np.zeros(len(order_idx), dtype=np.int64)
    for ln in range(1, 8):
        mask = counts >= ln
        if not mask.any():
            continue
        qty, pk, disc, tax, ep = _line_fields(order_idx, np.full(len(order_idx), ln), sf)
        # cents * pct * pct / 10000, round half away from zero
        x = ep * (100 - disc) * (100 + tax)
        line_total = np.sign(x) * ((np.abs(x) + 5000) // 10000)
        total += np.where(mask, line_total, 0)
    return total


def _ps_suppkey(partkey: np.ndarray, j: np.ndarray, sf: float) -> np.ndarray:
    """partsupp supplier spread (spec formula): the j-th supplier of part
    p is (p + j*(S/4 + (p-1)/S)) mod S + 1 — guarantees lineitem's
    (partkey, suppkey) pairs exist in partsupp."""
    S = _n_suppliers(sf)
    pk = partkey.astype(np.int64)
    return (pk + j * (S // 4 + (pk - 1) // S)) % S + 1


# ---------------------------------------------------------------------------
# string columns: dictionaries + code computation
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _format_dict(prefix: str, n: int) -> Dictionary:
    """'Prefix#%09d' dictionaries — zero-padding makes lexical order equal
    numeric order, so code == key - 1 without a search."""
    return Dictionary([f"{prefix}#{i:09d}" for i in range(1, n + 1)])


@lru_cache(maxsize=None)
def _phone_data(kind: str, n: int) -> Tuple[Dictionary, np.ndarray]:
    """Phones 'CC-xxx-xxx-xxxx', CC = 10 + nationkey (spec format).
    Returns (dictionary, lut) with lut[key-1] = code."""
    keys = np.arange(1, n + 1, dtype=np.int64)
    nat = _uniform(kind, "nationkey", keys, 0, 24)
    a = _uniform(kind, "ph1", keys, 100, 999)
    b = _uniform(kind, "ph2", keys, 100, 999)
    c = _uniform(kind, "ph3", keys, 1000, 9999)
    vals = [f"{10 + int(nk)}-{int(x)}-{int(y)}-{int(z)}"
            for nk, x, y, z in zip(nat, a, b, c)]
    d = Dictionary(vals)
    lut = np.asarray([d.code(v) for v in vals], dtype=np.int32)
    return d, lut


@lru_cache(maxsize=None)
def _part_name_pool(size: int = 5000) -> Dictionary:
    rng = np.random.default_rng(_stable_seed("pname", "tpch-tpu-v1") % (2**32))
    vals = []
    for _ in range(size):
        idx = rng.choice(len(COLORS), size=5, replace=False)
        vals.append(" ".join(COLORS[i] for i in idx))
    return Dictionary(vals)


@lru_cache(maxsize=None)
def _small_dict(name: str) -> Dictionary:
    return {
        "regions": Dictionary(REGIONS),
        "nations": Dictionary([n for n, _ in NATIONS]),
        "segments": Dictionary(SEGMENTS),
        "priorities": Dictionary(PRIORITIES),
        "shipmodes": Dictionary(SHIPMODES),
        "shipinstruct": Dictionary(SHIPINSTRUCT),
        "types": Dictionary([f"{a} {b} {c}" for a in TYPE_SYLL1 for b in TYPE_SYLL2 for c in TYPE_SYLL3]),
        "containers": Dictionary([f"{a} {b}" for a in CONTAINER_SYLL1 for b in CONTAINER_SYLL2]),
        "brands": Dictionary([f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]),
        "mfgrs": Dictionary([f"Manufacturer#{m}" for m in range(1, 6)]),
        "orderstatus": Dictionary(["F", "O", "P"]),
        "returnflag": Dictionary(["A", "N", "R"]),
        "linestatus": Dictionary(["F", "O"]),
    }[name]


def _pool_codes(d: Dictionary, stream: np.ndarray) -> np.ndarray:
    """Uniform codes over a pooled dictionary: the pool is random anyway,
    so indexing the *sorted* values uniformly is an equivalent draw."""
    return (stream % _U(len(d.values))).astype(np.int32)


# ---------------------------------------------------------------------------
# column generators: (sf, row_keys) -> (np data, Dictionary | None)
# row_keys is the 1-based primary index of the base table
# ---------------------------------------------------------------------------


def _gen_customer(col: str, keys: np.ndarray, sf: float):
    n = _n_customers(sf)
    if col == "c_custkey":
        return keys, None
    if col == "c_name":
        d = _format_dict("Customer", n)
        return (keys - 1).astype(np.int32), d
    if col == "c_address":
        d = _address_pool("customer")
        return _pool_codes(d, _stream("customer", "addr", keys)), d
    if col == "c_nationkey":
        return _uniform("customer", "nationkey", keys, 0, 24), None
    if col == "c_phone":
        d, lut = _phone_data("customer", n)
        return lut[keys - 1], d
    if col == "c_acctbal":
        return _uniform("customer", "acctbal", keys, -99999, 999999), None
    if col == "c_mktsegment":
        d = _small_dict("segments")
        idx = _uniform("customer", "segment", keys, 0, 4)
        lut = np.asarray([d.code(s) for s in SEGMENTS], dtype=np.int32)
        return lut[idx], d
    if col == "c_comment":
        d = _comment_dict("customer")
        return _pool_codes(d, _stream("customer", "comment", keys)), d
    raise KeyError(col)


def _gen_supplier(col: str, keys: np.ndarray, sf: float):
    n = _n_suppliers(sf)
    if col == "s_suppkey":
        return keys, None
    if col == "s_name":
        return (keys - 1).astype(np.int32), _format_dict("Supplier", n)
    if col == "s_address":
        d = _address_pool("supplier")
        return _pool_codes(d, _stream("supplier", "addr", keys)), d
    if col == "s_nationkey":
        return _uniform("supplier", "nationkey", keys, 0, 24), None
    if col == "s_phone":
        d, lut = _phone_data("supplier", n)
        return lut[keys - 1], d
    if col == "s_acctbal":
        return _uniform("supplier", "acctbal", keys, -99999, 999999), None
    if col == "s_comment":
        d = _comment_dict("supplier")
        return _pool_codes(d, _stream("supplier", "comment", keys)), d
    raise KeyError(col)


def _gen_part(col: str, keys: np.ndarray, sf: float):
    if col == "p_partkey":
        return keys, None
    if col == "p_name":
        d = _part_name_pool()
        return _pool_codes(d, _stream("part", "name", keys)), d
    if col == "p_mfgr":
        d = _small_dict("mfgrs")
        m = _uniform("part", "mfgr", keys, 1, 5)
        lut = np.asarray([d.code(f"Manufacturer#{i}") for i in range(1, 6)], dtype=np.int32)
        return lut[m - 1], d
    if col == "p_brand":
        d = _small_dict("brands")
        m = _uniform("part", "mfgr", keys, 1, 5)  # brand M = mfgr M (spec)
        n2 = _uniform("part", "brandn", keys, 1, 5)
        lut = np.asarray(
            [[d.code(f"Brand#{m_}{n_}") for n_ in range(1, 6)] for m_ in range(1, 6)],
            dtype=np.int32,
        )
        return lut[m - 1, n2 - 1], d
    if col == "p_type":
        d = _small_dict("types")
        idx = _uniform("part", "type", keys, 0, 149)
        vals = [f"{a} {b} {c}" for a in TYPE_SYLL1 for b in TYPE_SYLL2 for c in TYPE_SYLL3]
        lut = np.asarray([d.code(v) for v in vals], dtype=np.int32)
        return lut[idx], d
    if col == "p_size":
        return _uniform("part", "size", keys, 1, 50), None
    if col == "p_container":
        d = _small_dict("containers")
        idx = _uniform("part", "container", keys, 0, 39)
        vals = [f"{a} {b}" for a in CONTAINER_SYLL1 for b in CONTAINER_SYLL2]
        lut = np.asarray([d.code(v) for v in vals], dtype=np.int32)
        return lut[idx], d
    if col == "p_retailprice":
        return _retail_price_cents(keys), None
    if col == "p_comment":
        d = _comment_dict("part")
        return _pool_codes(d, _stream("part", "comment", keys)), d
    raise KeyError(col)


def _gen_partsupp(col: str, keys: np.ndarray, sf: float):
    # keys are 1-based partsupp row numbers; 4 suppliers per part
    i = keys - 1
    partkey = i // 4 + 1
    j = i % 4
    if col == "ps_partkey":
        return partkey, None
    if col == "ps_suppkey":
        return _ps_suppkey(partkey, j, sf), None
    if col == "ps_availqty":
        return _uniform("partsupp", "availqty", keys, 1, 9999), None
    if col == "ps_supplycost":
        return _uniform("partsupp", "supplycost", keys, 100, 100000), None
    if col == "ps_comment":
        d = _comment_dict("partsupp")
        return _pool_codes(d, _stream("partsupp", "comment", keys)), d
    raise KeyError(col)


def _custkey_for_order(order_idx: np.ndarray, sf: float) -> np.ndarray:
    """Orders reference only customers whose key is not divisible by 3
    (spec: one third of customers have no orders)."""
    n_cust = _n_customers(sf)
    n_usable = n_cust - n_cust // 3
    j = _uniform("orders", "cust", order_idx, 1, max(n_usable, 1))
    return j + (j - 1) // 2  # j-th positive integer not divisible by 3


def _order_status(order_idx: np.ndarray, sf: float) -> np.ndarray:
    """F if all lines shipped before CURRENTDATE, O if none, else P —
    derived from the same line fields lineitem generates."""
    counts = _line_counts(order_idx)
    odate = _uniform("orders", "date", order_idx, STARTDATE, ORDER_DATE_MAX)
    any_f = np.zeros(len(order_idx), dtype=bool)
    any_o = np.zeros(len(order_idx), dtype=bool)
    for ln in range(1, 8):
        mask = counts >= ln
        k = order_idx.astype(np.int64) * 8 + ln
        ship = odate + _uniform("lineitem", "shipdays", k, 1, 121)
        f = ship <= CURRENTDATE
        any_f |= mask & f
        any_o |= mask & ~f
    return np.where(any_f & any_o, 2, np.where(any_f, 0, 1))  # P, F, O codes below


def _gen_orders(col: str, keys: np.ndarray, sf: float):
    order_idx = keys - 1  # 0-based order index
    if col == "o_orderkey":
        return order_index_to_key(order_idx), None
    if col == "o_custkey":
        return _custkey_for_order(order_idx, sf), None
    if col == "o_orderstatus":
        d = _small_dict("orderstatus")
        st = _order_status(order_idx, sf)  # 0=F 1=O 2=P
        lut = np.asarray([d.code("F"), d.code("O"), d.code("P")], dtype=np.int32)
        return lut[st], d
    if col == "o_totalprice":
        return _order_total_cents(order_idx, sf), None
    if col == "o_orderdate":
        return _uniform("orders", "date", order_idx, STARTDATE, ORDER_DATE_MAX).astype(np.int32), None
    if col == "o_orderpriority":
        d = _small_dict("priorities")
        idx = _uniform("orders", "priority", order_idx, 0, 4)
        lut = np.asarray([d.code(p) for p in PRIORITIES], dtype=np.int32)
        return lut[idx], d
    if col == "o_clerk":
        d = _format_dict("Clerk", _n_clerks(sf))
        c = _uniform("orders", "clerk", order_idx, 1, _n_clerks(sf))
        return (c - 1).astype(np.int32), d
    if col == "o_shippriority":
        return np.zeros(len(keys), dtype=np.int64), None
    if col == "o_comment":
        d = _comment_dict("order")
        return _pool_codes(d, _stream("orders", "comment", order_idx)), d
    raise KeyError(col)


def _lineitem_rows(order_lo: int, order_hi: int, sf: float):
    """Expand orders [lo, hi) into (order_idx, line_no) row arrays."""
    order_idx = np.arange(order_lo, order_hi, dtype=np.int64)
    counts = _line_counts(order_idx)
    oi = np.repeat(order_idx, counts)
    # line numbers 1..count within each order, without a per-order loop:
    # each row's position minus its order's first position, plus one
    first = np.cumsum(counts) - counts
    ln = np.arange(len(oi), dtype=np.int64) - np.repeat(first, counts) + 1
    return oi, ln.astype(np.int64)


def _gen_lineitem(col: str, oi: np.ndarray, ln: np.ndarray, sf: float):
    k = oi * 8 + ln
    odate = _uniform("orders", "date", oi, STARTDATE, ORDER_DATE_MAX)
    if col == "l_orderkey":
        return order_index_to_key(oi), None
    if col == "l_linenumber":
        return ln, None
    if col in ("l_partkey", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        qty, pk, disc, tax, ep = _line_fields(oi, ln, sf)
        if col == "l_partkey":
            return pk, None
        if col == "l_suppkey":
            j = _uniform("lineitem", "suppj", k, 0, 3)
            return _ps_suppkey(pk, j, sf), None
        if col == "l_quantity":
            return qty * 100, None  # decimal(12,2)
        if col == "l_extendedprice":
            return ep, None
        if col == "l_discount":
            return disc, None  # pct == scale-2 cents of 0.xx
        if col == "l_tax":
            return tax, None
    if col == "l_shipdate":
        return (odate + _uniform("lineitem", "shipdays", k, 1, 121)).astype(np.int32), None
    if col == "l_commitdate":
        return (odate + _uniform("lineitem", "commitdays", k, 30, 90)).astype(np.int32), None
    if col == "l_receiptdate":
        ship = odate + _uniform("lineitem", "shipdays", k, 1, 121)
        return (ship + _uniform("lineitem", "receiptdays", k, 1, 30)).astype(np.int32), None
    if col == "l_returnflag":
        d = _small_dict("returnflag")
        ship = odate + _uniform("lineitem", "shipdays", k, 1, 121)
        receipt = ship + _uniform("lineitem", "receiptdays", k, 1, 30)
        r = _uniform("lineitem", "rflag", k, 0, 1)
        lut_ar = np.asarray([d.code("A"), d.code("R")], dtype=np.int32)
        code_n = d.code("N")
        return np.where(receipt <= CURRENTDATE, lut_ar[r], code_n).astype(np.int32), d
    if col == "l_linestatus":
        d = _small_dict("linestatus")
        ship = odate + _uniform("lineitem", "shipdays", k, 1, 121)
        return np.where(ship > CURRENTDATE, d.code("O"), d.code("F")).astype(np.int32), d
    if col == "l_shipinstruct":
        d = _small_dict("shipinstruct")
        idx = _uniform("lineitem", "instruct", k, 0, 3)
        lut = np.asarray([d.code(s) for s in SHIPINSTRUCT], dtype=np.int32)
        return lut[idx], d
    if col == "l_shipmode":
        d = _small_dict("shipmodes")
        idx = _uniform("lineitem", "mode", k, 0, 6)
        lut = np.asarray([d.code(s) for s in SHIPMODES], dtype=np.int32)
        return lut[idx], d
    if col == "l_comment":
        d = _comment_dict("lineitem")
        return _pool_codes(d, _stream("lineitem", "comment", k)), d
    raise KeyError(col)


def _gen_small(table: str, col: str, keys: np.ndarray, sf: float):
    if table == "region":
        if col == "r_regionkey":
            return keys - 1, None
        if col == "r_name":
            d = _small_dict("regions")
            lut = np.asarray([d.code(r) for r in REGIONS], dtype=np.int32)
            return lut[keys - 1], d
        if col == "r_comment":
            d = _comment_dict("region")
            return _pool_codes(d, _stream("region", "comment", keys)), d
    if table == "nation":
        if col == "n_nationkey":
            return keys - 1, None
        if col == "n_name":
            d = _small_dict("nations")
            lut = np.asarray([d.code(n) for n, _ in NATIONS], dtype=np.int32)
            return lut[keys - 1], d
        if col == "n_regionkey":
            rk = np.asarray([r for _, r in NATIONS], dtype=np.int64)
            return rk[keys - 1], None
        if col == "n_comment":
            d = _comment_dict("nation")
            return _pool_codes(d, _stream("nation", "comment", keys)), d
    raise KeyError(f"{table}.{col}")


_GEN = {
    "customer": _gen_customer,
    "supplier": _gen_supplier,
    "part": _gen_part,
    "partsupp": _gen_partsupp,
    "orders": _gen_orders,
}


def generate_column(table: str, col: str, sf: float, lo: int, hi: int):
    """Generate rows [lo, hi) of a column (for lineitem: ORDER range).
    Returns (np_data, Dictionary | None)."""
    if table == "lineitem":
        oi, ln = _lineitem_rows(lo, hi, sf)
        return _gen_lineitem(col, oi, ln, sf)
    keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
    if table in ("region", "nation"):
        return _gen_small(table, col, keys, sf)
    return _GEN[table](col, keys, sf)


# ---------------------------------------------------------------------------
# connector SPI implementation
# ---------------------------------------------------------------------------

SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0}


def _schema_sf(schema: str) -> Optional[float]:
    if schema in SCHEMAS:
        return SCHEMAS[schema]
    if schema.startswith("sf"):
        try:
            return float(schema[2:])
        except ValueError:
            return None
    return None


class TpchMetadata(ConnectorMetadata):
    def list_schemas(self) -> List[str]:
        return list(SCHEMAS)

    def list_tables(self, schema: str) -> List[str]:
        return list(TABLES) if _schema_sf(schema) is not None else []

    def get_table_handle(self, schema: str, table: str) -> Optional[TableHandle]:
        sf = _schema_sf(schema)
        if sf is None or table not in TABLES:
            return None
        return TableHandle("tpch", schema, table, payload=sf)

    def get_table_metadata(self, handle: TableHandle) -> TableMetadata:
        cols = tuple(ColumnMetadata(n, t) for n, t in TABLES[handle.table])
        return TableMetadata(handle.schema, handle.table, cols)

    def column_dictionary(self, handle: TableHandle, column: str) -> Optional[Dictionary]:
        typ = dict(TABLES[handle.table])[column]
        if not typ.is_string:
            return None
        # dictionaries are table-stable: probe one row
        lo_hi = (0, 1)
        _, d = generate_column(handle.table, column, handle.payload, *lo_hi)
        return d

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        sf = handle.payload
        if handle.table == "lineitem":
            rows = float(lineitem_row_count(sf))
        else:
            rows = float(base_row_count(handle.table, sf))
        return TableStatistics(
            row_count=rows, columns=_column_statistics(handle.table, sf, rows)
        )

    def apply_filter(self, handle: TableHandle, constraints):
        """Accept every numeric/temporal constraint: the page source
        generates the constrained columns alongside the requested ones
        and compacts each chunk exactly (full enforcement), so the
        engine never sees a violating row."""
        from trino_tpu_torch.connectors.pushdown import (
            merge_handle_constraints,
            split_supported,
        )

        types = dict(TABLES[handle.table])
        accepted, residual = split_supported(constraints, types.get)
        if not accepted:
            return None
        return merge_handle_constraints(handle, accepted), tuple(residual)

    def apply_projection(self, handle: TableHandle, columns) -> TableHandle:
        # the generator already materializes only the requested columns
        # per batches() call; accepting records the narrowed scan
        return handle


def _days(y: int, m: int, d: int) -> int:
    import datetime

    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _column_statistics(table: str, sf: float, rows: float):
    """Analytic per-column (ndv, null_fraction, low, high) for the CBO —
    the spec's value domains, like the reference's TpchMetadata statistic
    tables (plugin/trino-tpch ... StatisticsEstimator). Dates are epoch
    days; decimals raw values."""
    nc, np_, ns, no = _n_customers(sf), _n_parts(sf), _n_suppliers(sf), _n_orders(sf)
    d92, d98 = _days(1992, 1, 1), _days(1998, 12, 31)
    stats = {
        "region": {
            "r_regionkey": (5, 0.0, 0, 4),
            "r_name": (5, 0.0, None, None),
        },
        "nation": {
            "n_nationkey": (25, 0.0, 0, 24),
            "n_regionkey": (5, 0.0, 0, 4),
            "n_name": (25, 0.0, None, None),
        },
        "supplier": {
            "s_suppkey": (ns, 0.0, 1, ns),
            "s_nationkey": (25, 0.0, 0, 24),
            "s_acctbal": (ns, 0.0, -999.99, 9999.99),
        },
        "customer": {
            "c_custkey": (nc, 0.0, 1, nc),
            "c_nationkey": (25, 0.0, 0, 24),
            "c_mktsegment": (5, 0.0, None, None),
            "c_acctbal": (nc, 0.0, -999.99, 9999.99),
        },
        "part": {
            "p_partkey": (np_, 0.0, 1, np_),
            "p_size": (50, 0.0, 1, 50),
            "p_brand": (25, 0.0, None, None),
            "p_mfgr": (5, 0.0, None, None),
            "p_type": (150, 0.0, None, None),
            "p_retailprice": (np_ // 10 or 1, 0.0, 900.0, 2100.0),
        },
        "partsupp": {
            "ps_partkey": (np_, 0.0, 1, np_),
            "ps_suppkey": (ns, 0.0, 1, ns),
            "ps_availqty": (9999, 0.0, 1, 9999),
            "ps_supplycost": (1000, 0.0, 1.0, 1000.0),
        },
        "orders": {
            "o_orderkey": (no, 0.0, 1, (no >> 3 << 5) + 8),
            "o_custkey": (max(nc * 2 // 3, 1), 0.0, 1, nc),
            "o_orderdate": (2406, 0.0, d92, _days(1998, 8, 2)),
            "o_orderstatus": (3, 0.0, None, None),
            "o_orderpriority": (5, 0.0, None, None),
            "o_totalprice": (rows * 0.9, 0.0, 850.0, 560000.0),
        },
        "lineitem": {
            "l_orderkey": (no, 0.0, 1, (no >> 3 << 5) + 8),
            "l_partkey": (np_, 0.0, 1, np_),
            "l_suppkey": (ns, 0.0, 1, ns),
            "l_linenumber": (7, 0.0, 1, 7),
            "l_quantity": (50, 0.0, 1, 50),
            "l_discount": (11, 0.0, 0.0, 0.10),
            "l_tax": (9, 0.0, 0.0, 0.08),
            "l_returnflag": (3, 0.0, None, None),
            "l_linestatus": (2, 0.0, None, None),
            "l_shipdate": (2526, 0.0, d92 + 1, d98),
            "l_commitdate": (2466, 0.0, d92 + 30, d98 - 30),
            "l_receiptdate": (2554, 0.0, d92 + 2, d98 + 30),
            "l_extendedprice": (rows * 0.5, 0.0, 900.0, 105000.0),
        },
    }
    return {
        k: (float(ndv), nf, lo, hi)
        for k, (ndv, nf, lo, hi) in stats.get(table, {}).items()
    }


class TpchSplitManager(ConnectorSplitManager):
    def get_splits(self, handle: TableHandle, target_split_count: int) -> List[Split]:
        base = base_row_count(handle.table, handle.payload)
        n = max(1, min(target_split_count, base))
        per = -(-base // n)
        out = []
        for s, a in enumerate(range(0, base, per)):
            out.append(Split(handle, s, (a, min(a + per, base))))
        return out


class TpchPageSource(ConnectorPageSource):
    def batches(self, split: Split, columns: Sequence[str], batch_rows: int,
                device="cpu", stabilizer=None) -> Iterator[RelBatch]:
        """Generated rows of one split in chunks of `batch_rows` source
        rows, as batches on `device`. With a `stabilizer` a chunk's
        capacity is the ladder rung of its row span before pushdown
        pruning; without, the bucket of its surviving rows."""
        table = split.table.table
        sf = split.table.payload
        cs = getattr(split.table, "constraints", ())
        lo, hi = split.row_range
        types = dict(TABLES[table])
        step = batch_rows
        for a in range(lo, hi, step):
            b = min(a + step, hi)
            gen = {}
            nrows = None
            for name in columns:
                data, d = generate_column(table, name, sf, a, b)
                gen[name] = (np.asarray(data), d)
                nrows = len(data)
            span = nrows  # pre-pruning chunk size (shape stabilization)
            keep = None
            if cs:
                # pushed-down predicate: generate the constrained
                # columns for this chunk too (surviving-columns-only
                # projection still holds — they are dropped after the
                # mask) and compact exactly
                from trino_tpu_torch.connectors.pushdown import constraint_mask

                def _coldata(nm, _a=a, _b=b, _gen=gen):
                    if nm in _gen:
                        return _gen[nm][0], None
                    data, _ = generate_column(table, nm, sf, _a, _b)
                    return np.asarray(data), None

                mask = constraint_mask(cs, _coldata)
                keep = np.nonzero(mask)[0]
                if span is None:  # count(*) over a constrained scan
                    span = len(mask)
                nrows = len(keep)
            if nrows is None:  # no columns requested (count(*) scans)
                oi_count = b - a
                if table == "lineitem":
                    oi, _ = _lineitem_rows(a, b, sf)
                    oi_count = len(oi)
                nrows = oi_count
                span = nrows
            # stabilized scans pad to the class of the chunk's
            # pre-pruning span, so pruning never mints a smaller class
            if stabilizer is not None:
                cap = stabilizer.chunk_capacity(span)
            else:
                cap = bucket_capacity(nrows)
            cols = []
            for name in columns:
                data, d = gen[name]
                if keep is not None:
                    data = data[keep]
                typ = types[name]
                arr = np.zeros(cap, dtype=typ.np_dtype)
                arr[:nrows] = data
                cols.append(Column(typ, torch.from_numpy(arr).to(device), None, d))
            live = None
            if nrows != cap:
                lv = np.zeros(cap, dtype=bool)
                lv[:nrows] = True
                live = torch.from_numpy(lv).to(device)
            yield RelBatch(cols, live)


def create_tpch_connector() -> Connector:
    return Connector(
        "tpch",
        TpchMetadata(),
        TpchSplitManager(),
        TpchPageSource(),
    )

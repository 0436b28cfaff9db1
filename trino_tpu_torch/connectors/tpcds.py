"""TPC-DS connector: deterministic in-memory generator.

Counterpart of trino_tpu/connectors/tpcds.py, whose generation it
copies: every (table, column, sf, row range) yields the same numpy
arrays and dictionaries as the reference; only the batches' tensors are
torch, placed on the runner's device.

Analogue of plugin/trino-tpcds (1.7k LoC — the second benchmark fixture
the reference ships, SURVEY.md §2.12). Covers the star-schema core that
the classic reporting queries touch (q3/q42/q52/q55 family): store_sales
fact plus date_dim/item/store/customer/promotion dimensions, generated
with the same splitmix64 column-hash discipline as the TPC-H connector
(byte-identical data for any (sf, row range) request, so the sqlite
oracle can load the very same rows)."""

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

_U = np.uint64


def _stable_seed(*parts) -> int:
    h = hashlib.sha256("|".join(map(str, parts)).encode()).digest()
    return int.from_bytes(h[:8], "little")


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _U(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = ((x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x = ((x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> _U(31))


def _uniform(table, column, keys, lo: int, hi: int) -> np.ndarray:
    seed = _U(_stable_seed(table, column, "tpcds-tpu-v1"))
    u = _splitmix64(keys.astype(np.uint64) ^ seed)
    return (lo + (u % _U(hi - lo + 1)).astype(np.int64)).astype(np.int64)


_EPOCH = datetime.date(1970, 1, 1)


def _d(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


# date_dim covers 1998-01-01 .. 2002-12-31; official Julian-style sks
DATE_START = _d(1998, 1, 1)
DATE_ROWS = _d(2002, 12, 31) - DATE_START + 1
DATE_SK0 = 2450815  # first sk

CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Music",
              "Shoes", "Sports", "Women", "Men", "Children"]
DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]
STATES = ["TN", "CA", "TX", "WA", "OH", "GA", "NY", "IL"]
BRAND_PER_CAT = 50

_DEC = T.decimal(7, 2)

TABLES: Dict[str, List[Tuple[str, T.DataType]]] = {
    "date_dim": [
        ("d_date_sk", T.BIGINT), ("d_date", T.DATE), ("d_year", T.BIGINT),
        ("d_moy", T.BIGINT), ("d_dom", T.BIGINT), ("d_qoy", T.BIGINT),
        ("d_week_seq", T.BIGINT), ("d_month_seq", T.BIGINT),
        ("d_day_name", T.VARCHAR)],
    "time_dim": [
        ("t_time_sk", T.BIGINT), ("t_hour", T.BIGINT),
        ("t_minute", T.BIGINT)],
    "item": [
        ("i_item_sk", T.BIGINT), ("i_item_id", T.VARCHAR),
        ("i_item_desc", T.VARCHAR),
        ("i_brand_id", T.BIGINT), ("i_brand", T.VARCHAR),
        ("i_class", T.VARCHAR),
        ("i_category_id", T.BIGINT), ("i_category", T.VARCHAR),
        ("i_manufact_id", T.BIGINT), ("i_manager_id", T.BIGINT),
        ("i_current_price", _DEC)],
    "store": [
        ("s_store_sk", T.BIGINT), ("s_store_id", T.VARCHAR),
        ("s_store_name", T.VARCHAR), ("s_state", T.VARCHAR),
        ("s_gmt_offset", _DEC)],
    "warehouse": [
        ("w_warehouse_sk", T.BIGINT), ("w_warehouse_name", T.VARCHAR)],
    "customer": [
        ("c_customer_sk", T.BIGINT), ("c_customer_id", T.VARCHAR),
        ("c_first_name", T.VARCHAR), ("c_last_name", T.VARCHAR),
        ("c_birth_year", T.BIGINT)],
    "customer_demographics": [
        ("cd_demo_sk", T.BIGINT), ("cd_gender", T.VARCHAR),
        ("cd_marital_status", T.VARCHAR),
        ("cd_education_status", T.VARCHAR)],
    "household_demographics": [
        ("hd_demo_sk", T.BIGINT), ("hd_buy_potential", T.VARCHAR),
        ("hd_dep_count", T.BIGINT), ("hd_vehicle_count", T.BIGINT)],
    "promotion": [
        ("p_promo_sk", T.BIGINT), ("p_promo_id", T.VARCHAR),
        ("p_channel_email", T.VARCHAR), ("p_channel_event", T.VARCHAR)],
    "store_sales": [
        ("ss_sold_date_sk", T.BIGINT), ("ss_sold_time_sk", T.BIGINT),
        ("ss_item_sk", T.BIGINT),
        ("ss_customer_sk", T.BIGINT), ("ss_cdemo_sk", T.BIGINT),
        ("ss_hdemo_sk", T.BIGINT), ("ss_store_sk", T.BIGINT),
        ("ss_promo_sk", T.BIGINT), ("ss_quantity", T.BIGINT),
        ("ss_list_price", _DEC), ("ss_coupon_amt", _DEC),
        ("ss_sales_price", _DEC), ("ss_ext_sales_price", _DEC),
        ("ss_net_profit", _DEC)],
    "catalog_sales": [
        ("cs_sold_date_sk", T.BIGINT), ("cs_ship_date_sk", T.BIGINT),
        ("cs_bill_cdemo_sk", T.BIGINT), ("cs_bill_hdemo_sk", T.BIGINT),
        ("cs_item_sk", T.BIGINT), ("cs_promo_sk", T.BIGINT),
        ("cs_order_number", T.BIGINT), ("cs_quantity", T.BIGINT),
        ("cs_list_price", _DEC), ("cs_sales_price", _DEC)],
    "catalog_returns": [
        ("cr_item_sk", T.BIGINT), ("cr_order_number", T.BIGINT),
        ("cr_return_quantity", T.BIGINT)],
    "inventory": [
        ("inv_date_sk", T.BIGINT), ("inv_item_sk", T.BIGINT),
        ("inv_warehouse_sk", T.BIGINT),
        ("inv_quantity_on_hand", T.BIGINT)],
}


def _scaled(base: int, sf: float) -> int:
    return max(1, int(round(base * sf)))


# weekly inventory snapshots (the official generator's cadence)
INV_WEEKS = DATE_ROWS // 7


def _n_warehouses(sf: float) -> int:
    return max(1, int(round(5 * sf ** 0.5)))


def row_count(table: str, sf: float) -> int:
    return {
        "date_dim": DATE_ROWS,
        "time_dim": 86_400 // 60,  # one row per minute of day
        "item": _scaled(18_000, sf),
        "store": max(1, int(round(12 * sf ** 0.5))),
        "warehouse": _n_warehouses(sf),
        "customer": _scaled(100_000, sf),
        "customer_demographics": 1920,  # fixed-size cross of demographics
        "household_demographics": 720,
        "promotion": _scaled(300, sf),
        "store_sales": _scaled(2_880_000, sf),
        "catalog_sales": _scaled(1_440_000, sf),
        "catalog_returns": _scaled(144_000, sf),
        # weekly snapshot of every (item, warehouse) pair
        "inventory": _scaled(18_000, sf) * _n_warehouses(sf) * INV_WEEKS,
    }[table]


@lru_cache(maxsize=None)
def _brand_dict() -> Dictionary:
    return Dictionary(
        [f"{c}brand #{i}" for c in CATEGORIES for i in range(1, BRAND_PER_CAT + 1)]
    )


@lru_cache(maxsize=None)
def _id_dict(table: str, prefix: str, width: int, n: int) -> Dictionary:
    return Dictionary([f"{prefix}{i:0{width}d}" for i in range(n + 1)])


@lru_cache(maxsize=None)
def _name_dict(kind: str, n: int) -> Dictionary:
    rng = np.random.default_rng(_stable_seed(kind, "names") % (2**32))
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vals = []
    for _ in range(n):
        k = int(rng.integers(4, 10))
        s = "".join(letters[rng.integers(0, 26, k)])
        vals.append(s.capitalize())
    return Dictionary(vals)


def generate_column(table: str, col: str, sf: float, lo: int, hi: int):
    """Rows [lo, hi) of one column -> (np data, Dictionary|None)."""
    keys = np.arange(lo, hi, dtype=np.int64)
    n = len(keys)
    if table == "date_dim":
        days = DATE_START + keys
        if col == "d_date_sk":
            return DATE_SK0 + keys, None
        if col == "d_date":
            return days.astype(np.int32), None
        if col == "d_week_seq":
            # Monday-aligned consecutive week numbers (1970-01-05 was a
            # Monday, so days-since-epoch+3 is week-stable)
            return ((days + 3) // 7).astype(np.int64), None
        dates = [(_EPOCH + datetime.timedelta(days=int(x))) for x in days]
        if col == "d_year":
            return np.asarray([d.year for d in dates], dtype=np.int64), None
        if col == "d_moy":
            return np.asarray([d.month for d in dates], dtype=np.int64), None
        if col == "d_dom":
            return np.asarray([d.day for d in dates], dtype=np.int64), None
        if col == "d_qoy":
            return np.asarray([(d.month - 1) // 3 + 1 for d in dates], dtype=np.int64), None
        if col == "d_month_seq":
            # months since 1900-01 (the official sequence's epoch)
            return np.asarray(
                [(d.year - 1900) * 12 + d.month - 1 for d in dates],
                dtype=np.int64,
            ), None
        if col == "d_day_name":
            d = Dictionary(DAY_NAMES)
            return d.encode([DAY_NAMES[x.weekday()] for x in dates]), d
    if table == "time_dim":
        if col == "t_time_sk":
            return keys + 1, None
        if col == "t_hour":
            return keys // 60, None
        if col == "t_minute":
            return keys % 60, None
    if table == "warehouse":
        if col == "w_warehouse_sk":
            return keys + 1, None
        if col == "w_warehouse_name":
            d = _name_dict("warehouse", 32)
            return _uniform(table, col, keys, 0, len(d) - 1).astype(np.int32), d
    if table == "customer_demographics":
        if col == "cd_demo_sk":
            return keys + 1, None
        if col == "cd_gender":
            d = Dictionary(["M", "F"])
            return (keys % 2).astype(np.int32), d
        if col == "cd_marital_status":
            vals = ["M", "S", "D", "W", "U"]
            d = Dictionary(vals)
            return d.encode([vals[int(k) // 2 % 5] for k in keys]), d
        if col == "cd_education_status":
            vals = ["Primary", "Secondary", "College", "2 yr Degree",
                    "4 yr Degree", "Advanced Degree", "Unknown"]
            d = Dictionary(vals)
            return d.encode([vals[int(k) // 10 % 7] for k in keys]), d
    if table == "household_demographics":
        if col == "hd_demo_sk":
            return keys + 1, None
        if col == "hd_buy_potential":
            vals = ["0-500", "501-1000", "1001-5000", "5001-10000",
                    ">10000", "Unknown"]
            d = Dictionary(vals)
            return d.encode([vals[int(k) % 6] for k in keys]), d
        if col == "hd_dep_count":
            return (keys % 10).astype(np.int64), None
        if col == "hd_vehicle_count":
            return (keys % 5).astype(np.int64), None
    if table == "catalog_sales":
        if col == "cs_sold_date_sk":
            return DATE_SK0 + _uniform(table, col, keys, 0, DATE_ROWS - 8), None
        if col == "cs_ship_date_sk":
            sold = _uniform(table, "cs_sold_date_sk", keys, 0, DATE_ROWS - 8)
            lag = _uniform(table, "cs_ship_lag", keys, 1, 7)
            return DATE_SK0 + sold + lag, None
        if col == "cs_bill_cdemo_sk":
            return _uniform(table, col, keys, 1, row_count("customer_demographics", sf)), None
        if col == "cs_bill_hdemo_sk":
            return _uniform(table, col, keys, 1, row_count("household_demographics", sf)), None
        if col == "cs_item_sk":
            return _uniform(table, col, keys, 1, row_count("item", sf)), None
        if col == "cs_promo_sk":
            return _uniform(table, col, keys, 1, row_count("promotion", sf)), None
        if col == "cs_order_number":
            return keys // 4 + 1, None  # ~4 lines per order
        if col == "cs_quantity":
            return _uniform(table, col, keys, 1, 100), None
        if col == "cs_list_price":
            return _uniform(table, col, keys, 100, 30000), None
        if col == "cs_sales_price":
            return _uniform(table, col, keys, 10, 30000), None
    if table == "catalog_returns":
        # returns reference a deterministic subset of catalog_sales lines
        sale_rows = row_count("catalog_sales", sf)
        src = _uniform(table, "cr_source_row", keys, 0, max(sale_rows - 1, 0))
        if col == "cr_item_sk":
            return _uniform("catalog_sales", "cs_item_sk", src, 1, row_count("item", sf)), None
        if col == "cr_order_number":
            return src // 4 + 1, None
        if col == "cr_return_quantity":
            return _uniform(table, col, keys, 1, 20), None
    if table == "inventory":
        n_items = row_count("item", sf)
        n_wh = _n_warehouses(sf)
        week = keys // (n_items * n_wh)
        rem = keys % (n_items * n_wh)
        if col == "inv_date_sk":
            # Monday of week `week` within the date_dim range
            first_monday = (7 - ((DATE_START + 3) % 7)) % 7
            return DATE_SK0 + first_monday + week * 7, None
        if col == "inv_item_sk":
            return rem // n_wh + 1, None
        if col == "inv_warehouse_sk":
            return rem % n_wh + 1, None
        if col == "inv_quantity_on_hand":
            return _uniform(table, col, keys, 0, 1000), None
    if table == "item":
        if col == "i_item_sk":
            return keys + 1, None
        if col == "i_item_id":
            d = _id_dict("item", "AAAAAAAA", 8, row_count("item", sf))
            return d.encode([f"AAAAAAAA{int(k):08d}" for k in keys]), d
        cat_id = _uniform(table, "i_category_id", keys, 1, len(CATEGORIES))
        if col == "i_category_id":
            return cat_id, None
        if col == "i_category":
            d = Dictionary(CATEGORIES)
            return d.encode([CATEGORIES[int(c) - 1] for c in cat_id]), d
        brand_no = _uniform(table, "i_brand", keys, 1, BRAND_PER_CAT)
        if col == "i_brand_id":
            return cat_id * 1000 + brand_no, None
        if col == "i_brand":
            d = _brand_dict()
            return d.encode(
                [
                    f"{CATEGORIES[int(c) - 1]}brand #{int(b)}"
                    for c, b in zip(cat_id, brand_no)
                ]
            ), d
        if col == "i_manufact_id":
            return _uniform(table, col, keys, 1, 1000), None
        if col == "i_manager_id":
            return _uniform(table, col, keys, 1, 100), None
        if col == "i_item_desc":
            d = _name_dict("item_desc", 2000)
            return _uniform(table, col, keys, 0, len(d) - 1).astype(np.int32), d
        if col == "i_class":
            vals = [f"class{j:02d}" for j in range(16)]
            d = Dictionary(vals)
            return d.encode(
                [vals[int(x)] for x in _uniform(table, col, keys, 0, 15)]
            ), d
        if col == "i_current_price":
            return _uniform(table, col, keys, 99, 9999), None
    if table == "store":
        if col == "s_store_sk":
            return keys + 1, None
        if col == "s_store_id":
            d = _id_dict("store", "AAAAAAAA", 4, row_count("store", sf))
            return d.encode([f"AAAAAAAA{int(k):04d}" for k in keys]), d
        if col == "s_store_name":
            d = _name_dict("store", 64)
            return _uniform(table, col, keys, 0, len(d) - 1).astype(np.int32), d
        if col == "s_state":
            d = Dictionary(STATES)
            return d.encode(
                [STATES[int(x)] for x in _uniform(table, col, keys, 0, len(STATES) - 1)]
            ), d
        if col == "s_gmt_offset":
            return np.full(n, -500, dtype=np.int64), None  # -5.00
    if table == "customer":
        if col == "c_customer_sk":
            return keys + 1, None
        if col == "c_customer_id":
            # table-stable dictionary (plan-time binding sees the same
            # dictionary every batch)
            d = _id_dict("customer", "CUST", 10, row_count("customer", sf))
            return d.encode([f"CUST{int(k):010d}" for k in keys]), d
        if col in ("c_first_name", "c_last_name"):
            d = _name_dict(col, 1000)
            return _uniform(table, col, keys, 0, len(d) - 1).astype(np.int32), d
        if col == "c_birth_year":
            return _uniform(table, col, keys, 1930, 1995), None
    if table == "promotion":
        if col == "p_promo_sk":
            return keys + 1, None
        if col == "p_promo_id":
            d = _id_dict("promotion", "PROMO", 6, row_count("promotion", sf))
            return d.encode([f"PROMO{int(k):06d}" for k in keys]), d
        if col in ("p_channel_email", "p_channel_event"):
            d = Dictionary(["N", "Y"])
            return _uniform(table, col, keys, 0, 1).astype(np.int32), d
    if table == "store_sales":
        if col == "ss_sold_date_sk":
            return DATE_SK0 + _uniform(table, col, keys, 0, DATE_ROWS - 1), None
        if col == "ss_sold_time_sk":
            return _uniform(table, col, keys, 1, row_count("time_dim", sf)), None
        if col == "ss_item_sk":
            return _uniform(table, col, keys, 1, row_count("item", sf)), None
        if col == "ss_customer_sk":
            return _uniform(table, col, keys, 1, row_count("customer", sf)), None
        if col == "ss_cdemo_sk":
            return _uniform(table, col, keys, 1, row_count("customer_demographics", sf)), None
        if col == "ss_hdemo_sk":
            return _uniform(table, col, keys, 1, row_count("household_demographics", sf)), None
        if col == "ss_store_sk":
            return _uniform(table, col, keys, 1, row_count("store", sf)), None
        if col == "ss_promo_sk":
            return _uniform(table, col, keys, 1, row_count("promotion", sf)), None
        if col == "ss_quantity":
            return _uniform(table, col, keys, 1, 100), None
        if col == "ss_list_price":
            return _uniform(table, col, keys, 100, 30000), None
        if col == "ss_coupon_amt":
            amt = _uniform(table, col, keys, 0, 5000)
            return np.where(amt < 4000, 0, amt), None
        if col == "ss_sales_price":
            return _uniform(table, col, keys, 10, 20000), None
        if col == "ss_ext_sales_price":
            price = _uniform(table, "ss_sales_price", keys, 10, 20000)
            qty = _uniform(table, "ss_quantity", keys, 1, 100)
            return price * qty, None
        if col == "ss_net_profit":
            return _uniform(table, col, keys, -100000, 150000), None
    raise KeyError(f"{table}.{col}")


# ---------------------------------------------------------------------------
# connector SPI
# ---------------------------------------------------------------------------

SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0}


def _schema_sf(schema: str) -> Optional[float]:
    if schema in SCHEMAS:
        return SCHEMAS[schema]
    if schema.startswith("sf"):
        try:
            return float(schema[2:])
        except ValueError:
            return None
    return None


class TpcdsMetadata(ConnectorMetadata):
    def list_schemas(self) -> List[str]:
        return sorted(SCHEMAS)

    def list_tables(self, schema: str) -> List[str]:
        return sorted(TABLES)

    def get_table_handle(self, schema: str, table: str) -> Optional[TableHandle]:
        sf = _schema_sf(schema)
        if sf is None or table not in TABLES:
            return None
        return TableHandle("tpcds", schema, table, payload=sf)

    def get_table_metadata(self, handle: TableHandle) -> TableMetadata:
        cols = tuple(ColumnMetadata(n, t) for n, t in TABLES[handle.table])
        return TableMetadata(handle.schema, handle.table, cols)

    def column_dictionary(self, handle: TableHandle, column: str) -> Optional[Dictionary]:
        typ = dict(TABLES[handle.table])[column]
        if not typ.is_string:
            return None
        _, d = generate_column(handle.table, column, handle.payload, 0, 1)
        return d

    def get_table_statistics(self, handle: TableHandle) -> TableStatistics:
        sf = handle.payload
        rows = float(row_count(handle.table, sf))
        cols = {}
        key_col = {
            "date_dim": "d_date_sk", "item": "i_item_sk", "store": "s_store_sk",
            "customer": "c_customer_sk", "promotion": "p_promo_sk",
            "warehouse": "w_warehouse_sk", "time_dim": "t_time_sk",
            "customer_demographics": "cd_demo_sk",
            "household_demographics": "hd_demo_sk",
        }.get(handle.table)
        if key_col:
            cols[key_col] = (rows, 0.0, 1.0, rows)
        if handle.table == "store_sales":
            cols = {
                "ss_sold_date_sk": (float(DATE_ROWS), 0.0, DATE_SK0, DATE_SK0 + DATE_ROWS - 1),
                "ss_item_sk": (float(row_count("item", sf)), 0.0, 1, row_count("item", sf)),
                "ss_customer_sk": (float(row_count("customer", sf)), 0.0, 1, row_count("customer", sf)),
                "ss_store_sk": (float(row_count("store", sf)), 0.0, 1, row_count("store", sf)),
                "ss_quantity": (100.0, 0.0, 1, 100),
            }
        elif handle.table == "date_dim":
            cols["d_year"] = (5.0, 0.0, 1998, 2002)
            cols["d_moy"] = (12.0, 0.0, 1, 12)
        return TableStatistics(row_count=rows, columns=cols)


class TpcdsSplitManager(ConnectorSplitManager):
    def get_splits(self, handle: TableHandle, target_split_count: int) -> List[Split]:
        base = row_count(handle.table, handle.payload)
        n = max(1, min(target_split_count, base))
        per = -(-base // n)
        return [
            Split(handle, s, (a, min(a + per, base)))
            for s, a in enumerate(range(0, base, per))
        ]


class TpcdsPageSource(ConnectorPageSource):
    def batches(self, split: Split, columns: Sequence[str], batch_rows: int,
                device="cpu") -> Iterator[RelBatch]:
        """Generated rows of one split in chunks of `batch_rows`, as
        batches on `device`."""
        table = split.table.table
        sf = split.table.payload
        lo, hi = split.row_range
        types = dict(TABLES[table])
        for a in range(lo, hi, batch_rows):
            b = min(a + batch_rows, hi)
            cap = bucket_capacity(b - a)
            cols = []
            for name in columns:
                data, d = generate_column(table, name, sf, a, b)
                cols.append(Column.from_numpy(
                    types[name], data, None, d, capacity=cap, device=device
                ))
            live = None
            if (b - a) != cap:
                lv = np.zeros(cap, dtype=bool)
                lv[: b - a] = True
                live = torch.from_numpy(lv).to(device)
            yield RelBatch(cols, live)


def create_tpcds_connector() -> Connector:
    return Connector(
        name="tpcds",
        metadata=TpcdsMetadata(),
        split_manager=TpcdsSplitManager(),
        page_source=TpcdsPageSource(),
    )

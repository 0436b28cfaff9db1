"""On-card smoke test of trino_tpu_torch: build, check and drive the port.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. identity  — the card's name and power limit (nvidia-smi) and the
                 torch device name.
  2. build     — nvcc builds every kernel from csrc/, one process per
                 source, all started together.
  3. kernel    — each kernel against its plain PyTorch version on the
                 card, bit-exact, at the explorers' shapes and at edge
                 shapes (take_flat at its layout's edges: ragged chunks,
                 offset views, int32 and int64 indices); kernel, plain
                 and one-library-call times beside the bound.
  4. main      — LocalQueryRunner(device="cuda") answers, at sf1 and
                 cold, TPC-H Q1, Q6, the bounded-domain GROUP BY (Q-MXU),
                 the joins Q3, Q18, Q16 (count distinct) and Q22
                 (substring, anti join), the window query Q-WIN and the
                 join-project Q-MXJ (mxu_join_enabled) with its mxu-off
                 twin; kernel launch counts are read per query (each join
                 run launches the bounds kernel once per probe batch and
                 no searched rank, Q3/Q18 also the run-owner fill and the
                 flat gather; Q1/Q6/Q-MXU launch no join kernel; Q-MXJ
                 launches grouped_sum at least once per lineitem batch and
                 expands no pair); Q-MXU rolled up over (shipmode,
                 shipinstruct) must equal Q1, Q18 must agree with the
                 join-free group-by of lineitem, Q-WIN's count, running
                 sum and row numbers must equal count(distinct o_custkey),
                 sum(o_totalprice) and count(*) of orders exactly, and
                 Q-MXJ's rows must equal its twin's. Then the holistic
                 and sketch aggregates over orders (approx_distinct with
                 min_by/max_by equal to count(distinct) and carrying the
                 extreme prices, the pctl_merge medians within their
                 bucket of the exact ones, the HLL estimate within 3
                 standard errors); TPC-DS at sf1 (the fact tables' counts
                 equal row_count, the nine templates other than q72, each
                 launching bounds once per probe batch) and q72 at
                 Q72_SCHEMA with its peak device memory and widest join;
                 and bench.py's wide-string GROUP BY (2^21 rows, memory
                 connector) equal to numpy's own group-by. The scalar
                 functions at sf1 over orders and customer (FN_QUERIES):
                 date_trunc/quarter grouped by month equal to extract's
                 grouping, three date round trips over every order,
                 regexp_like equal to LIKE, the regexp_count/strpos/
                 split_part sums equal to numpy over the generated
                 columns, a customer-orders join filtered by regexp_like
                 and grouped by bitwise_and equal to its substr and % 16
                 twin (bounds once per probe batch, take_flat; the build's
                 keys are unique, so no run-owner fill), md5/xxhash64/lpad
                 equal to hashlib and pyfns, ln/sqrt/geometric_mean
                 within 1e-9 of numpy, entropy and checksum equal to the
                 CPU's; the kernels each launched are listed. Every
                 take_flat launch of the phase is timed on the card
                 (LaunchTimer), summed per family: TPC-H, functions,
                 TPC-DS, q72.
  5. nested    — the nested types at sf1, each query cold once with its
                 scan_s, rest_s and launches: the word count (split,
                 UNNEST, GROUP BY) whose counts sum to
                 sum(cardinality(split)); array_agg per customer then
                 UNNEST WITH ORDINALITY, equal to count(*), sum(o_orderkey)
                 and the most orders of a customer; filter/transform/
                 any_match over split against the word count and LIKE;
                 histogram and map_agg whose counts sum to count(*); the
                 arrays of a join's build side filtered, equal to the
                 join-free twin (bounds launched); and UNNEST ... GROUP BY
                 over a 2^20-row memory table equal to numpy. UNNEST
                 launches run_owner and take_flat; this phase's counts are
                 kept apart from phase main's (`nested_launches`). Then
                 the card against the CPU on every nested SQL case at tiny
                 (NEST_MEMORY_SQL) and the nested queries at tiny and
                 sf0.1.
  6. zones     — TIMESTAMP WITH TIME ZONE and MATCH_RECOGNIZE at sf1,
                 each query cold once with its scan_s, rest_s and
                 launches, after the count of the machine's TZif zones
                 (zone ids follow the host's zone files): the orders'
                 dates as New York midnights grouped by timezone_hour,
                 equal to Python zoneinfo's counts (TZ_DST); the same
                 instants shown in two zones grouped by value, as many
                 groups as count(distinct o_orderdate) (TZ_MIXED); their
                 date_trunc('day') in each row's own zone (TZ_TRUNC) and
                 their join to a memory table of the days as UTC instants,
                 1,500,000 rows with bounds once per probe batch (TZ_JOIN);
                 the V-shape over each customer's orders (MR_ORDERS, its
                 rest_s split into device work and the host automaton),
                 PATTERN (a) counting every order and numbering up to the
                 most orders of a customer (MR_ALL), and SKIP TO NEXT ROW
                 with up{2,4} (MR_NEXT). MR_ORDERS, MR_NEXT and TZ_TRUNC
                 also on the CPU at sf1, rows equal; then
                 ops.tz.offset_millis_rowwise on one 1,048,576-row batch
                 over every zone id, CUDA events and the card's peak
                 memory around it, equal to the CPU's.
  7. write     — the write side at sf1 on a memory catalog `w` beside
                 tpch, each statement cold once with its wall, scan_s,
                 sink_s (host time in the page sink, the copy from the card
                 included), launches and the card's peak memory
                 (write_identities): CREATE TABLE AS of orders returns
                 1,500,000 and its count and sums equal tpch's; INSERT ...
                 SELECT ... GROUP BY returns the distinct customers and its
                 counts sum to 1,500,000; UPDATE and DELETE return the
                 source's counts under their predicates and the table
                 follows; MERGE over a quarter of the orders updates the
                 rest and re-inserts the deleted ones (bounds once per probe
                 batch, take_flat); a ROLLBACK keeps w.s.cust's count, a
                 COMMIT doubles it, a write in a READ ONLY transaction
                 raises TransactionError; a GROUP BY over the written
                 table (grouped_sum) sums to the final count; DROP TABLE,
                 and a later SELECT raises. The bytes of cached batches
                 before and after each write are printed. This phase's
                 counts are kept apart (`write_launches`).
  8. statements — the statement surface at sf1 on the card, each step
                 with plan_s (host time from parse to a physical plan, or
                 to the plan-cache lookup on a hit), run_s, the cache's
                 hits and misses and its launches (statement_identities):
                 a bounded GROUP BY over orders PREPAREd with a date
                 parameter, EXECUTEd twice with one date (a miss, then a
                 hit: equal rows, grouped_sum on both, counts summing to
                 count(*) under the predicate) and once with another (a
                 miss); an orders-customer join PREPAREd with a
                 c_mktsegment parameter, EXECUTEd twice (the hit's rows
                 equal the unprepared text's; bounds once per probe batch
                 and take_flat on each run, and a hit launches what its
                 miss did), then after SET SESSION
                 enable_dynamic_filtering = false (a miss, equal rows);
                 EXPLAIN of Q3 and SHOW SESSION/SCHEMAS/TABLES/COLUMNS/
                 FUNCTIONS equal to the CPU runner's; a runner whose
                 FileBasedAccessControl denies customer to its user raises
                 AccessDeniedError on the join, on a miss and on a hit
                 cached under an allowed identity, and still runs the
                 GROUP BY; a memory table made by CTAS from orders, whose
                 prepared GROUP BY hits, misses after an INSERT and counts
                 the new rows, while the tpch plan stays a hit; EXPLAIN of
                 Q3 under plan_validation = 'rules'. This phase's counts
                 are kept apart (`statements_launches`).
  9. files     — the file connectors at sf1 on the card (file_identities),
                 in a temporary directory removed at the end, each step
                 with its wall, parse_s (host time parsing files), scan_s
                 (host time in the page source), sink_s (in the file
                 sinks), bytes_scanned and launches: CTAS of orders (all 9
                 columns) and customer into a parquet catalog and of
                 customer into a CSV catalog, each returning its row
                 count; the parquet orders' first parse and its totals
                 equal to tpch's; a cold catalog on the same files pruned
                 to o_orderkey < 60000, fewer page bytes than the full
                 parse and tpch's totals; the bounded GROUP BY (grouped_sum)
                 and the orders-customer join (bounds once per probe batch,
                 take_flat) over the parquet tables, the join again with
                 the CSV customer as its build side, and a join whose 63
                 customers fold into the parquet probe's splits as an
                 IN-list dynamic filter, each equal to its twin over tpch;
                 an INSERT ... SELECT of about 1 % of the orders adds one
                 part, and the table's count and sum grow by the source's;
                 a CTAS into blackhole returns its count and a SELECT from
                 it no rows; DROP TABLE of the CSV customer removes its
                 files. Every file batch lies on the card. This phase's
                 counts are kept apart (`files_launches`).
 10. spill     — the memory pool, spill and the grace hash join at sf1
                 over orders and customer (spill_identities), on a runner
                 whose pool is 1/SPILL_POOL_FRACTION of one orders batch's
                 device bytes (printed) and on its twin with no pool, both
                 at SPILL_BATCH_ROWS rows a batch: GROUP BY o_custkey (the
                 sort route), GROUP BY o_clerk (the grouped-sum route), a
                 full ORDER BY of orders, and tests/test_memory.py's four
                 JOIN_QS shapes over orders and customer (inner join under
                 a GROUP BY, left, semi, anti), each row-equal to its twin,
                 each spilling, each join finishing partition by partition
                 and launching the bounds kernel; each with both
                 walls, spilled bytes, spill files, grace partitions and
                 launches; EXPLAIN ANALYZE of the inner join, its operators'
                 in=/out= rows equal to the twin's. Then every orders batch
                 through the page serde: bytes equal to the CPU port's for
                 the same rows, read back onto the card equal, its one
                 device->host copy timed. The pooled runs' launches are
                 kept apart (`spill_launches`).
 11. distributed — the distributed runner at sf1 on the card
                 (distributed_identities): DIST_WORKERS in-process workers
                 and hash partitions, the page exchange, beside its
                 LocalQueryRunner twin over the same connector, each
                 statement with both walls, its rows, rows_shuffled, the
                 host time of the exchange's page copies (page_out_s:
                 Page.from_batch and the hash split; page_in_s:
                 Page.to_batch) and its launches: GROUP BY o_clerk
                 (partial on the grouped-sum route, hash exchange, final),
                 GROUP BY o_custkey (the sort route), customer join orders
                 under GROUP BY c_mktsegment (both inputs repartitioned:
                 bounds, take_flat), supplier join nation (nation
                 broadcast), ORDER BY o_totalprice DESC LIMIT 10 and a full
                 ORDER BY o_orderkey (the merging gather), count(*), and
                 EXPLAIN and EXPLAIN ANALYZE of the join (every order read
                 by 4 tasks), each row-equal to its twin with no task left
                 behind. Then the 22 TPC-H queries at tiny through the
                 distributed runner on the card and on the CPU, equal
                 within tests/oracle.py's tolerances. Its launches count
                 apart (`distributed_launches`).
 12. wire      — the wire and the front door on the card: phase
                 distributed's GROUP BY o_clerk and customer join orders
                 at sf1 through WIRE_WORKERS WorkerServers on 127.0.0.1
                 (each a Worker(device=None), internal auth on through
                 TRINO_TPU_INTERNAL_SECRET) beside their in-process twin
                 (the same count of in-process workers), row-equal, with
                 both walls and the bytes pulled over HTTP; then
                 retry_policy="task" with every task's first attempt
                 killed at "start" and at "mid" over WIRE_FTE_SHAPES at
                 tiny, row-equal to the run without failures, with the
                 retries and the spool's bytes and seconds; then a
                 CoordinatorServer over LocalQueryRunner(device=None):
                 TPC-H Q1, Q3 and Q18 at tiny through the port's Client
                 and DB-API equal runner.execute, and `python -m
                 trino_tpu_torch.cli --server` prints Q1's rows.
                 grouped_sum, bounds and take_flat must each launch in
                 the phase; its launches count apart (`wire_launches`).
 13. explore   — both explorer entry points (trino_tpu_torch.explore),
                 each output held against its plain version.
 14. parity    — the queries, and the window and set-operation queries
                 of tests/test_window.py, at tpch.tiny, and the joins and
                 Q16, Q22, Q-WIN, Q-MXJ and the holistic and sketch
                 queries at sf0.1, on the card and on the CPU must be
                 row-equal; so must the ten TPC-DS templates at tiny, the
                 nine other than q72 at sf0.1, a listagg over nation and
                 the wide-string GROUP BY at 2^16 rows (also equal to
                 numpy's). So must every case of tests/test_functions.py's
                 five lists at tiny and the functions queries at sf0.1
                 (doubles within 1e-12 relative, `rows_close`); so must
                 every case of tests/test_timestamptz.py (TSTZ_SQL; now()
                 by its zone) and tests/test_match_recognize.py (MR_SQL,
                 with the NULL-key cases MR_NULL_SQL) at tiny, and phase
                 zones' queries at tiny and sf0.1; so must phase write's
                 statements at tiny and sf0.1 and every script of the
                 write corpus (WRITE_SCRIPTS) at tiny, statement by
                 statement (the same error where one raises), with every
                 written table read back equal; so must phase statements'
                 steps at tiny and sf0.1, phase files' steps at tiny
                 and sf0.1 (their bytes_scanned too), and
                 tests/test_memory.py's queries at tiny under their pools
                 (MEMORY_QS).
 15. summary   — each kind of join-path call (the probe's bounds, the
                 expansion's run owners, the flat gather) timed on the
                 largest arguments the main path gave it, and on the
                 TPC-H's, the TPC-DS templates', q72's and phase nested's
                 own largest; grouped_sum on each main-path shape (Q-MXU,
                 Q-MXJ, the wide-string batch); a `kernels` JSON line (each
                 entry with its launches in phases nested, zones, write,
                 statements, files, spill, distributed and wire beside the main
                 path's; take_flat's entry with its summed
                 main-path time per family, and each of its
                 records with the table sectors its indices touch, which
                 its bound counts), the card line, then the result line
                 {"ok": true, "device": {...}} last.

`--phases` picks a subset (comma-separated) for a quick check.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM: device memory rate (NVIDIA data sheet), and the INT32 issue
# rate outside the tensor cores: 64 INT32 lanes per SM per clock (Hopper
# architecture whitepaper) x 132 SMs x 1.98 GHz boost. An int64 add
# counts as two 32-bit ops.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

Q_MXU = """select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       count(*) as count_order
from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
order by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct"""

Q1 = """select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""

Q6 = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.06 - 0.01 and 0.06 + 0.01
  and l_quantity < 24"""

Q3 = """select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10"""

Q18 = """select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
        select l_orderkey
        from lineitem
        group by l_orderkey
        having sum(l_quantity) > 300)
  and c_custkey = o_custkey
  and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100"""

# Q18's answer by the join-free route: every order's total quantity
Q18_CHECK = """select l_orderkey, sum(l_quantity) from lineitem
group by 1 having sum(l_quantity) > 300"""

Q16 = """select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
        select s_suppkey from supplier
        where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size"""

Q22 = """select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (
    select substring(c_phone, 1, 2) as cntrycode, c_acctbal
    from customer
    where substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17')
      and c_acctbal > (
            select avg(c_acctbal)
            from customer
            where c_acctbal > 0.00
              and substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17'))
      and not exists (select * from orders where o_custkey = c_custkey)
) as custsale
group by cntrycode
order by cntrycode"""

# one window spec over every order: the last row of each customer's
# partition holds its order count and its total
Q_WIN = """select count(*), sum(run), sum(rn) from (
  select row_number() over (partition by o_custkey order by o_orderkey) as rn,
         sum(o_totalprice) over (partition by o_custkey order by o_orderkey
             rows between unbounded preceding and current row) as run,
         lead(o_orderkey) over (partition by o_custkey order by o_orderkey) as nxt
  from orders) t
where nxt is null"""
Q_WIN_CUSTOMERS = "select count(distinct o_custkey) from orders"
Q_WIN_TOTALS = "select sum(o_totalprice), count(*) from orders"

# a star join of lineitem with a small filtered dimension (about 800
# parts at sf1): the join-project route under mxu_join_enabled
Q_MXJ = """select p_brand, count(*), count(l_suppkey), sum(l_linenumber)
from lineitem join part on l_partkey = p_partkey
where p_size = 15 and p_type like '%BRASS'
group by p_brand order by p_brand"""

# copies of tests/test_window.py's WINDOW_QUERIES and SET_QUERIES (the
# tests import JAX; a test holds these copies equal to them)
WINDOW_QUERIES = [
    "select n_regionkey, n_name, row_number() over (partition by n_regionkey order by n_name) rn"
    " from nation order by n_regionkey, n_name",
    "select n_regionkey, n_name,"
    " rank() over (partition by n_regionkey order by substr(n_name,1,1)) r,"
    " dense_rank() over (partition by n_regionkey order by substr(n_name,1,1)) dr"
    " from nation order by n_regionkey, n_name",
    "select n_regionkey, n_name, ntile(3) over (partition by n_regionkey order by n_name) b"
    " from nation order by n_regionkey, n_name",
    "select s_nationkey, s_name, sum(s_acctbal) over (partition by s_nationkey) tot,"
    " count(*) over (partition by s_nationkey) c"
    " from supplier order by s_nationkey, s_name",
    "select o_orderkey, avg(o_totalprice) over (partition by o_orderpriority) a"
    " from orders where o_orderkey < 100 order by o_orderkey",
    "select s_nationkey, s_name, s_acctbal, sum(s_acctbal) over"
    " (partition by s_nationkey order by s_name rows between unbounded preceding and current row) run"
    " from supplier order by s_nationkey, s_name",
    "select s_name, min(s_acctbal) over"
    " (order by s_suppkey rows between unbounded preceding and current row) m"
    " from supplier order by s_suppkey",
    "select o_custkey, o_orderkey, sum(o_orderkey) over"
    " (partition by o_custkey order by o_orderdate) s"
    " from orders where o_custkey < 30 order by o_custkey, o_orderkey",
    "select o_custkey, o_orderkey, lag(o_orderkey) over (partition by o_custkey order by o_orderkey) prev,"
    " lead(o_orderkey, 2) over (partition by o_custkey order by o_orderkey) nxt2"
    " from orders where o_custkey < 20 order by o_custkey, o_orderkey",
    "select n_name, first_value(n_name) over (partition by n_regionkey order by n_name) f,"
    " last_value(n_name) over (partition by n_regionkey) l"
    " from nation order by n_name",
    "select n_regionkey, count(*) c, rank() over (order by count(*) desc) r"
    " from nation group by n_regionkey order by r, n_regionkey",
]
SET_QUERIES = [
    "select c_custkey from customer where c_custkey < 100 intersect"
    " select o_custkey from orders order by 1",
    "select c_custkey from customer where c_custkey < 100 except"
    " select o_custkey from orders order by c_custkey limit 5",
    "select n_regionkey from nation intersect select r_regionkey from region order by 1 desc",
    "select o_orderstatus from orders except select 'O' order by 1",
    "select c_mktsegment from customer intersect select 'BUILDING'",
    "select n_name from nation where n_regionkey = 0 union"
    " select n_name from nation where n_regionkey = 1 order by 1 limit 4",
]

# copies of tests/test_tpcds.py's QUERIES (TPC-DS templates) and the set
# that must select rows at tiny scale (a test holds them equal)
TPCDS_QUERIES = {
    "q3": """
    select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
           sum(ss_ext_sales_price) sum_agg
    from date_dim dt, store_sales, item
    where dt.d_date_sk = store_sales.ss_sold_date_sk
      and store_sales.ss_item_sk = item.i_item_sk
      and item.i_manufact_id = 436
      and dt.d_moy = 12
    group by dt.d_year, item.i_brand, item.i_brand_id
    order by dt.d_year, sum_agg desc, brand_id
    limit 100
    """,
    "q7": """
    select i_item_id,
           avg(ss_quantity) agg1, avg(ss_list_price) agg2,
           avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
    from store_sales, customer_demographics, date_dim, item, promotion
    where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
      and ss_cdemo_sk = cd_demo_sk and ss_promo_sk = p_promo_sk
      and cd_gender = 'M' and cd_marital_status = 'S'
      and cd_education_status = 'College'
      and (p_channel_email = 'N' or p_channel_event = 'N')
      and d_year = 2000
    group by i_item_id
    order by i_item_id
    limit 100
    """,
    "q42": """
    select dt.d_year, item.i_category_id, item.i_category,
           sum(ss_ext_sales_price)
    from date_dim dt, store_sales, item
    where dt.d_date_sk = store_sales.ss_sold_date_sk
      and store_sales.ss_item_sk = item.i_item_sk
      and item.i_manager_id = 1
      and dt.d_moy = 11 and dt.d_year = 2000
    group by dt.d_year, item.i_category_id, item.i_category
    order by sum(ss_ext_sales_price) desc, dt.d_year,
             item.i_category_id, item.i_category
    limit 100
    """,
    "q43": """
    select s_store_name, s_store_id,
      sum(case when (d_day_name = 'Sunday') then ss_sales_price else null end) sun_sales,
      sum(case when (d_day_name = 'Monday') then ss_sales_price else null end) mon_sales,
      sum(case when (d_day_name = 'Tuesday') then ss_sales_price else null end) tue_sales,
      sum(case when (d_day_name = 'Wednesday') then ss_sales_price else null end) wed_sales,
      sum(case when (d_day_name = 'Thursday') then ss_sales_price else null end) thu_sales,
      sum(case when (d_day_name = 'Friday') then ss_sales_price else null end) fri_sales,
      sum(case when (d_day_name = 'Saturday') then ss_sales_price else null end) sat_sales
    from date_dim, store_sales, store
    where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
      and s_gmt_offset = -5 and d_year = 2000
    group by s_store_name, s_store_id
    order by s_store_name, s_store_id, sun_sales, mon_sales, tue_sales,
             wed_sales, thu_sales, fri_sales, sat_sales
    limit 100
    """,
    "q52": """
    select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
           sum(ss_ext_sales_price) ext_price
    from date_dim dt, store_sales, item
    where dt.d_date_sk = store_sales.ss_sold_date_sk
      and store_sales.ss_item_sk = item.i_item_sk
      and item.i_manager_id = 1
      and dt.d_moy = 11 and dt.d_year = 2000
    group by dt.d_year, item.i_brand, item.i_brand_id
    order by dt.d_year, ext_price desc, brand_id
    limit 100
    """,
    "q55": """
    select i_brand_id brand_id, i_brand brand,
           sum(ss_ext_sales_price) ext_price
    from date_dim, store_sales, item
    where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
      and i_manager_id = 28 and d_moy = 11 and d_year = 1999
    group by i_brand, i_brand_id
    order by ext_price desc, brand_id
    limit 100
    """,
    "q65": """
    select s_store_name, i_item_desc, sc.revenue, i_current_price
    from store, item,
         (select ss_store_sk, avg(revenue) as ave
          from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
                from store_sales, date_dim
                where ss_sold_date_sk = d_date_sk
                  and d_month_seq between 1176 and 1176 + 11
                group by ss_store_sk, ss_item_sk) sa
          group by ss_store_sk) sb,
         (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
          from store_sales, date_dim
          where ss_sold_date_sk = d_date_sk
            and d_month_seq between 1176 and 1176 + 11
          group by ss_store_sk, ss_item_sk) sc
    where sb.ss_store_sk = sc.ss_store_sk
      and sc.revenue <= 0.1 * sb.ave
      and s_store_sk = sc.ss_store_sk
      and i_item_sk = sc.ss_item_sk
    order by s_store_name, i_item_desc, sc.revenue
    limit 100
    """,
    "q72": """
    select i_item_desc, w_warehouse_name, d1.d_week_seq,
      sum(case when p_promo_sk is null then 1 else 0 end) no_promo,
      sum(case when p_promo_sk is not null then 1 else 0 end) promo,
      count(*) total_cnt
    from catalog_sales
    join inventory on (cs_item_sk = inv_item_sk)
    join warehouse on (w_warehouse_sk = inv_warehouse_sk)
    join item on (i_item_sk = cs_item_sk)
    join customer_demographics on (cs_bill_cdemo_sk = cd_demo_sk)
    join household_demographics on (cs_bill_hdemo_sk = hd_demo_sk)
    join date_dim d1 on (cs_sold_date_sk = d1.d_date_sk)
    join date_dim d2 on (inv_date_sk = d2.d_date_sk)
    join date_dim d3 on (cs_ship_date_sk = d3.d_date_sk)
    left outer join promotion on (cs_promo_sk = p_promo_sk)
    left outer join catalog_returns on (cr_item_sk = cs_item_sk
                                        and cr_order_number = cs_order_number)
    where d1.d_week_seq = d2.d_week_seq
      and inv_quantity_on_hand < cs_quantity
      and d3.d_date > d1.d_date + 5
      and hd_buy_potential = '>10000'
      and d1.d_year = 1999
      and cd_marital_status = 'D'
    group by i_item_desc, w_warehouse_name, d1.d_week_seq
    order by total_cnt desc, i_item_desc, w_warehouse_name, d1.d_week_seq
    limit 100
    """,
    "q82": """
    select i_item_id, i_item_desc, i_current_price
    from item, inventory, date_dim, store_sales
    where i_current_price between 30 and 30 + 30
      and inv_item_sk = i_item_sk
      and d_date_sk = inv_date_sk
      and d_date between date '2002-05-30' and date '2002-07-29'
      and i_manufact_id in (437, 129, 727, 663)
      and inv_quantity_on_hand between 100 and 500
      and ss_item_sk = i_item_sk
    group by i_item_id, i_item_desc, i_current_price
    order by i_item_id
    limit 100
    """,
    "q96": """
    select count(*)
    from store_sales, household_demographics, time_dim, store
    where ss_sold_time_sk = time_dim.t_time_sk
      and ss_hdemo_sk = household_demographics.hd_demo_sk
      and ss_store_sk = s_store_sk
      and time_dim.t_hour = 20
      and time_dim.t_minute >= 30
      and household_demographics.hd_dep_count = 7
      and store.s_store_name = 'ese'
    """,
}
TPCDS_NONEMPTY = {"q3", "q42", "q43", "q52", "q55", "q7", "q72", "q82"}

# q72 on the card: the reference's plan keeps q72's whole WHERE clause
# above its two left joins, so the bottom join catalog_sales x inventory
# on item expands sum over items of cs(item) * inv(item) pairs (3.7 M at
# tiny, 18.7 M at sf0.05, 74.9 M at sf0.1, 1.87 G at sf1) and each of
# the five inner joins above carries every pair. The largest scale that
# completes on one 80 GB card is taken; the port keeps the plan.
Q72_SCHEMA = "sf0.05"

# the holistic and sketch aggregates over orders: min_by/max_by with
# approx_distinct take the holistic path (exact); a grouped
# approx_percentile alone the mergeable pctl_merge plan; a lone
# approx_distinct the HLL plan
Q_HOLISTIC = """select approx_distinct(o_custkey), min_by(o_orderkey, o_totalprice),
       max_by(o_orderkey, o_totalprice) from orders"""
Q_HOLISTIC_EXTREMES = "select min(o_totalprice), max(o_totalprice) from orders"
Q_PCTL = """select o_orderpriority, approx_percentile(o_totalprice, 0.5) from orders
group by o_orderpriority order by o_orderpriority"""
# the same percentile on the holistic path (exact, nearest rank): the
# pctl_merge plan's buckets are 2^-9 wide
Q_PCTL_EXACT = """select o_orderpriority, approx_percentile(o_totalprice, 0.5),
       min_by(o_orderkey, o_orderkey) from orders
group by o_orderpriority order by o_orderpriority"""
Q_HLL = "select approx_distinct(o_custkey) from orders"
Q_LISTAGG = """select r_name, listagg(n_name, ',') from nation join region
on n_regionkey = r_regionkey group by r_name order by r_name"""

# BASELINE config 5 (bench.py WIDESTR): a 64-character dictionary string
# of 512 values with zipf(1.3) skew and a bigint, over the memory
# connector
WIDESTR = """select s, count(*) as cnt, sum(v) as total from widestr
group by s order by cnt desc, s limit 10"""
WIDESTR_ROWS = 1 << 21
WIDESTR_GROUPS = 512
WIDESTR_WIDTH = 64

# The scalar functions (phase main at sf1 over orders and customer; phase
# parity at sf0.1). Each is held to an exact identity against functions
# the port had before, or to numpy, hashlib or the port's own pyfns over
# the generated columns on the host.
FN_MONTHS = """select date_trunc('month', o_orderdate), quarter(o_orderdate), count(*),
       sum(o_totalprice) from orders group by 1, 2 order by 1"""
FN_MONTHS_CHECK = """select extract(year from o_orderdate), extract(month from o_orderdate),
       count(*), sum(o_totalprice) from orders group by 1, 2 order by 1, 2"""
FN_ROUND_TRIPS = """select
    sum(case when date_diff('day', o_orderdate, date_add('day', 45, o_orderdate)) = 45
        then 1 else 0 end),
    sum(case when date_add('month', -1, date_add('month', 1,
        date_trunc('month', o_orderdate))) = date_trunc('month', o_orderdate)
        then 1 else 0 end),
    sum(case when day_of_week(o_orderdate) between 1 and 7 then 1 else 0 end),
    count(*)
from orders"""
FN_REGEXP = "select count(*) from orders where regexp_like(o_comment, 'special.*requests')"
FN_REGEXP_LIKE = "select count(*) from orders where o_comment like '%special%requests%'"
FN_STRINGS = """select sum(regexp_count(o_comment, 'e')), sum(strpos(o_comment, 'the')),
       sum(cast(split_part(o_clerk, '#', 2) as decimal(12, 0))) from orders"""
FN_JOIN = """select c_mktsegment, bitwise_and(c_custkey, 15), count(*), sum(o_totalprice)
from customer join orders on c_custkey = o_custkey
where regexp_like(c_phone, '^1[0-9]-')
group by 1, 2 order by 1, 2"""
# TPC-H phones are 'CC-...' with a two-digit country code, so the
# pattern and the substr test select the same customers
FN_JOIN_TWIN = """select c_mktsegment, c_custkey % 16, count(*), sum(o_totalprice)
from customer join orders on c_custkey = o_custkey
where substr(c_phone, 1, 1) = '1' and substr(c_phone, 3, 1) = '-'
group by 1, 2 order by 1, 2"""
FN_HASH = """select c_custkey, c_name, md5(to_utf8(c_name)), xxhash64(to_utf8(c_name)),
       lpad(cast(c_custkey as varchar), 12, '0') from customer"""
FN_MATH = """select sum(ln(o_totalprice)), sum(sqrt(o_totalprice)),
       geometric_mean(o_totalprice) from orders"""
FN_AGG = """select entropy(o_custkey % 100), checksum(o_comment), checksum(o_totalprice),
       checksum(o_orderdate) from orders"""
FN_QUERIES = (("fn_months", FN_MONTHS), ("fn_months_check", FN_MONTHS_CHECK),
              ("fn_round_trips", FN_ROUND_TRIPS), ("fn_regexp", FN_REGEXP),
              ("fn_regexp_like", FN_REGEXP_LIKE), ("fn_strings", FN_STRINGS),
              ("fn_join", FN_JOIN), ("fn_join_twin", FN_JOIN_TWIN), ("fn_hash", FN_HASH),
              ("fn_math", FN_MATH), ("fn_agg", FN_AGG))
# int -> varchar enumerates [0, 4096) and is NULL outside it (the
# reference's static-dictionary cast, which the port keeps)
SMALL_INT_CAST = 4096

# The nested types (phase nested: at sf1, then card against CPU at tiny
# and sf0.1):
# split and UNNEST, array_agg with UNNEST WITH ORDINALITY, the lambda
# functions, histogram and map_agg, arrays carried through a join, and
# UNNEST over a memory table's array(bigint) column. Each is held to an
# identity against queries without arrays, or to numpy.
NEST_WORDS = """select w, count(*) c from (select split(o_comment, ' ') ws from orders) o
cross join unnest(o.ws) as t(w) group by w order by c desc, w"""
NEST_WORDS_TOTAL = "select sum(cardinality(split(o_comment, ' '))) from orders"
NEST_AGG_UNNEST = """select count(*), sum(k), max(i) from (select o_custkey,
array_agg(o_orderkey) a from orders group by o_custkey) x
cross join unnest(x.a) with ordinality as t(k, i)"""
NEST_AGG_CHECK = """select count(*), sum(o_orderkey), max(n) from orders,
(select max(c) n from (select count(*) c from orders group by o_custkey))"""
NEST_LAMBDA = """select sum(cardinality(filter(split(o_comment, ' '), x -> length(x) > 5))),
sum(cardinality(transform(split(o_comment, ' '), x -> length(x)))),
sum(case when any_match(split(o_comment, ' '), x -> x = 'special') then 1 else 0 end)
from orders"""
NEST_LAMBDA_LIKE = """select count(*) from orders
where ' ' || o_comment || ' ' like '% special %'"""
NEST_MAPS = """select o_orderpriority, histogram(o_orderstatus),
map_agg(o_orderstatus, o_orderkey), count(*) from orders
group by o_orderpriority order by 1"""
# customer's arrays ride the join's build side, so the expansion gathers
# them out of row order and repeats them (a customer has many orders)
# before filter reads them; the twin filters before the join
NEST_JOIN = """select o.o_orderkey, o.o_custkey, filter(s.a, x -> length(x) > 4)
from orders o join (select c_custkey k, split(c_comment, ' ') a from customer) s
on o.o_custkey = s.k where o.o_orderkey < {cut} order by 1"""
NEST_JOIN_TWIN = """select o.o_orderkey, o.o_custkey, s.f from orders o join
(select c_custkey k, filter(split(c_comment, ' '), x -> length(x) > 4) f from customer) s
on o.o_custkey = s.k where o.o_orderkey < {cut} order by 1"""
NEST_JOIN_CUT = {"tiny": 40, "sf0.1": 6000, "sf1": 60000}
NEST_MEMORY = """select tag, count(*) from tagged cross join unnest(tags) as u(tag)
group by tag order by tag"""
NEST_MEMORY_ROWS = 1 << 20
NEST_MEMORY_TAGS = 1000  # tag values in [0, 1000), 0 to 8 of them a row



# The nested SQL cases over the memory tables of the reference's tests
# (tests/test_torch_nested.py holds the port to trino_tpu on them; phase
# nested holds the card to the CPU).
def nest_type(mod, name: str):
    """A type of `mod` (either package's types module) from its name."""
    s = name.strip()
    if s.startswith("array("):
        return mod.array_of(nest_type(mod, s[6:-1]))
    if s.startswith("map("):
        k, v = s[4:-1].split(",", 1)
        return mod.map_of(nest_type(mod, k), nest_type(mod, v))
    if s.startswith("row("):
        fields = [f.strip().split(" ", 1) for f in s[4:-1].split(",")]
        return mod.row_of(*[(n, nest_type(mod, t)) for n, t in fields])
    return getattr(mod, s.upper())


def nest_tables() -> dict:
    """{schema: {table: [(column, type name, values)]}} of the reference
    tests' tables (values: numpy arrays or python lists)."""
    import random

    import numpy as np

    rng = np.random.default_rng(0)  # tests/test_sketches_r4.py's
    sk_g = rng.integers(0, 3, 5000).astype(np.int64)
    sk_v = rng.integers(0, 1000, 5000).astype(np.int64)
    rnd = random.Random(7)  # tests/test_function_breadth_r5.py's qd table
    qd = [(i % 3, rnd.gauss(100, 25)) for i in range(600)]
    return {
        # tests/test_array_columns.py's runner fixture
        "tags": {"orders_tags": [
            ("id", "bigint", np.array([1, 2, 3, 4], np.int64)),
            ("name", "varchar", ["ann", "bob", "cid", "dee"]),
            ("tags", "array(varchar)", [["red", "blue"], ["green"], [], ["red", "green", "blue"]]),
            ("scores", "array(bigint)", [[10, 20], [30], [], [1, 2, 3]])],
            # test_unnest_empty_table, test_unnest_nested_arrays
            "empty": [("id", "bigint", np.zeros(0, np.int64)), ("arr", "array(bigint)", [])],
            "nested": [("id", "bigint", np.array([1, 2], np.int64)),
                       ("nest", "array(array(bigint))", [[[1, 2], [3]], [[4]]])]},
        # tests/test_nested_types.py's runner fixture and its inline tables
        "nest": {"t": [
            ("id", "bigint", np.array([1, 2, 3], np.int64)),
            ("m", "map(varchar, bigint)", [{"a": 10, "b": 20}, {"a": 30}, None]),
            ("r", "row(x bigint, y varchar)", [(7, "p"), (8, "q"), None])],
            "arr": [("a", "array(bigint)", [[10, 20, 30], [40], None, []])],
            "nn": [("aa", "array(array(bigint))", [[[1, 2], [3]], [[4, 5, 6]]]),
                   ("ma", "map(varchar, array(bigint))", [{"p": [7, 8]}, {"q": [9]}])],
            "fa2": [("x", "bigint", np.array([1, 2], np.int64)),
                    ("t", "array(bigint)", [[10], [20, 21]])],
            "fb2": [("y", "bigint", np.array([2, 3], np.int64))]},
        # tests/test_aggregates_r4.py's fixture (k's NULL from its valids)
        "agg": {"t": [
            ("g", "bigint", np.array([1, 1, 1, 2, 2, 3], np.int64)),
            ("k", "varchar", ["a", "b", "a", "c", "c", None]),
            ("v", "bigint", np.array([10, 20, 30, 40, 50, 60], np.int64))]},
        # tests/test_sketches_r4.py's fixture
        "sk": {"t": [("g", "bigint", sk_g), ("v", "bigint", sk_v)]},
        # tests/test_function_breadth_r5.py's CREATE TABLE + INSERT tables
        "r5": {"qd": [("g", "bigint", np.array([g for g, _ in qd], np.int64)),
                      ("x", "double", np.array([x for _, x in qd]))],
               "sm": [("txt", "varchar", ["a=1,b=2", "k=v", ""])]},
    }


def nest_load(conn, mod, column_metadata, schema: str) -> None:
    """nest_tables()[schema] into a memory connector of either package
    (`mod` its types module, `column_metadata` its ColumnMetadata)."""
    import numpy as np

    for name, cols in nest_tables()[schema].items():
        valids = [np.array([v is not None for v in vals], bool)
                  if t == "varchar" and any(v is None for v in vals) else None
                  for _, t, vals in cols]
        conn.load_table(schema, name,
                        [column_metadata(c, nest_type(mod, t)) for c, t, _ in cols],
                        [list(v) if isinstance(v, list) else v.copy() for _, _, v in cols],
                        valids=valids)


def nest_runner(schema: str, device: str):
    """The port's runner over nest_tables()[schema]."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.spi import ColumnMetadata
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    conn = create_memory_connector()
    nest_load(conn, T, ColumnMetadata, schema)
    r = LocalQueryRunner(Session(catalog="memory", schema=schema), device=device)
    r.register_catalog("memory", conn)
    return r


NEST_MEMORY_SQL = [
    # tests/test_array_columns.py: test_cardinality_on_column,
    # test_unnest_array_column, test_unnest_empty_arrays_produce_no_rows,
    # test_unnest_with_ordinality, test_unnest_multi_array_zip,
    # test_unnest_aggregation, test_unnest_filter_on_source,
    # test_constant_unnest_still_works, test_select_array_column_directly,
    # test_unnest_empty_table, test_unnest_nested_arrays
    ("tags", "select id, cardinality(tags) from orders_tags order by id"),
    ("tags", "select id, t from orders_tags, UNNEST(tags) as u(t) order by id, t"),
    ("tags", "select count(*) from orders_tags, UNNEST(scores) as u(s) where id = 3"),
    ("tags", "select id, s, o from orders_tags, UNNEST(scores) WITH ORDINALITY as u(s, o)"
             " where id = 4 order by o"),
    ("tags", "select id, t, s from orders_tags, UNNEST(tags, scores) as u(t, s)"
             " where id = 1 order by s"),
    ("tags", "select t, count(*) c from orders_tags, UNNEST(tags) as u(t) group by t"
             " order by t"),
    ("tags", "select name, s from orders_tags, UNNEST(scores) as u(s) where id >= 2"
             " and s > 1 order by s"),
    ("tags", "select * from UNNEST(ARRAY[7, 8]) as u(v) order by v"),
    ("tags", "select id, scores from orders_tags order by id"),
    ("tags", "select id, x from empty, UNNEST(arr) as u(x)"),
    ("tags", "select id, x from nested, UNNEST(nest) as u(x) order by id"),
    # the lambda and array functions over the same table
    ("tags", "select id, filter(tags, x -> x <> 'red'), transform(scores, x -> x * 2),"
             " any_match(scores, x -> x > 15), all_match(scores, x -> x > 15),"
             " none_match(tags, x -> x = 'green') from orders_tags order by id"),
    ("tags", "select id, array_sort(tags), array_distinct(tags), array_position(scores, 30),"
             " array_remove(tags, 'red'), contains(tags, 'red'), array_min(scores),"
             " array_max(scores) from orders_tags order by id"),
    ("tags", "select id, slice(scores, 1, 1), element_at(scores, -1), scores[1],"
             " trim_array(scores, 1), repeat(name, 2) from orders_tags order by id"),
    ("tags", "select name, filter(tags, x -> x <> 'blue') from orders_tags order by name desc"),
    # tests/test_nested_types.py: test_map_cardinality_and_subscript,
    # test_map_subscript_in_where, test_row_field_access,
    # test_map_keys_values, test_row_constructor,
    # test_array_subscript_column, test_nested_subscript_of_nested
    ("nest", "select id, cardinality(m), m['a'], element_at(m, 'b') from t"),
    ("nest", "select id from t where m['a'] = 30"),
    ("nest", "select id, r.x, r.y from t"),
    ("nest", "select map_keys(m), map_values(m) from t"),
    ("nest", "select row(id, 5) from t"),
    ("nest", "select a[1], a[3], element_at(a, -1) from arr"),
    ("nest", "select aa[1], aa[2] from nn"),
    ("nest", "select ma['p'], ma['q'] from nn"),
    ("nest", "select id, transform_values(m, (k, v) -> v + 1), map_filter(m, (k, v) -> v > 15),"
             " transform_keys(m, (k, v) -> upper(k)) from t order by id"),
    # tests/test_aggregates_r4.py: TestCollectAggregates
    ("agg", "select g, array_agg(v) from t group by g order by g"),
    ("agg", "select array_agg(k) from t where g = 3"),
    ("agg", "select array_agg(v) from t where g > 99"),
    ("agg", "select g, map_agg(k, v) from t group by g order by g"),
    ("agg", "select g, multimap_agg(k, v) from t group by g order by g"),
    ("agg", "select histogram(k) from t"),
    ("agg", "select map_union(m) from (select map_agg(k, v) m from t group by g)"),
    ("agg", "select numeric_histogram(2, v) from t"),
    ("agg", "select approx_most_frequent(1, k, 10) from t"),
    ("agg", "select g, bitwise_or_agg(v), bitwise_and_agg(v), bitwise_xor_agg(v) from t"
            " group by g order by g"),
    # tests/test_sketches_r4.py: TestHyperLogLog, TestTDigest,
    # TestRegexpArrays, TestMiscBreadth (the array cases)
    ("sk", "select g, cardinality(approx_set(v)) from t group by g order by g"),
    ("sk", "select cardinality(merge(s)) from (select approx_set(v) s from t group by g)"),
    ("sk", "select cardinality(empty_approx_set())"),
    ("sk", "select approx_set(v) from t"),
    ("sk", "select value_at_quantile(tdigest_agg(v), 0.5) from t"),
    ("sk", "select value_at_quantile(tdigest_agg(v), 0.99) from t"),
    ("sk", "select value_at_quantile(merge(d), 0.5) from (select tdigest_agg(v) d from t"
           " group by g)"),
    ("sk", "select quantile_at_value(tdigest_agg(v), 500.0) from t"),
    ("sk", "select regexp_split('a1b22c', '[0-9]+')"),
    ("sk", "select regexp_extract_all('a1b22c333', '[0-9]+')"),
    ("sk", "select regexp_extract_all('a1b2', '([a-z])[0-9]', 1)"),
    ("sk", "select cardinality(regexp_extract_all('xyz', '[0-9]'))"),
    ("sk", "select contains_sequence(array[1,2,3,4], array[2,3]),"
           " contains_sequence(array[1,2,3,4], array[2,4])"),
    ("sk", "select array_sort(shuffle(array[3,1,2]))"),
    ("sk", "select reverse(array[1,2,3]), concat(array[1,2], array[3])"),
    # tests/test_function_breadth_r5.py: TestQdigest, TestSplitToMap
    ("r5", "select g, value_at_quantile(qdigest_agg(x), 0.5) from qd group by g order by g"),
    ("r5", "select g, values_at_quantiles(qdigest_agg(x), array[0.1, 0.5, 0.9]) from qd"
           " group by g order by g"),
    ("r5", "select value_at_quantile(qdigest_agg(g), 0.99) from qd"),
    ("r5", "select quantile_at_value(qdigest_agg(x), 100.0) from qd"),
    ("r5", "select split_to_map(txt, ',', '=') from sm"),
    ("r5", "select element_at(split_to_map(txt, ',', '='), 'a'),"
           " cardinality(split_to_map(txt, ',', '=')) from sm order by 2"),
]


# ---- phase zones: TIMESTAMP WITH TIME ZONE and MATCH_RECOGNIZE ------------

TZ_NY = "America/New_York"  # tests/test_timestamptz.py's NY
# each order's date as midnight in New York, and the same instants shown
# in two zones by o_orderkey % 2 (a UNION ALL: CASE and COALESCE over
# TIMESTAMP WITH TIME ZONE type as bigint in the reference, ROADMAP §3)
TZ_MIDNIGHT = f"with_timezone(cast(o_orderdate as timestamp), '{TZ_NY}')"
TZ_MIXED_SRC = (f"(select {TZ_MIDNIGHT} at time zone 'Asia/Tokyo' t from orders"
                f" where o_orderkey % 2 = 0 union all"
                f" select {TZ_MIDNIGHT} t from orders where o_orderkey % 2 = 1)")
TZ_DST = f"""select extract(timezone_hour from ts) h, count(*) from
(select {TZ_MIDNIGHT} ts from orders) group by 1 order by 1"""
TZ_MIXED = f"""select count(*), sum(c) from
(select t, count(*) c from {TZ_MIXED_SRC} m group by t)"""
TZ_MIXED_CHECK = "select count(distinct o_orderdate) from orders"
TZ_TRUNC = f"""select date_trunc('day', t) d, count(*) from {TZ_MIXED_SRC} m
group by 1 order by 1"""
TZ_JOIN = f"""select count(*) from {TZ_MIXED_SRC} o join memory.zones.days d on o.t = d.d"""
TZ_ROWWISE_ROWS = 1 << 20  # one orders batch

MR_ORDERS = """select * from orders MATCH_RECOGNIZE (
  PARTITION BY o_custkey ORDER BY o_orderdate, o_orderkey
  MEASURES first(down.o_orderdate) as start_date, last(down.o_totalprice) as bottom,
           last(up.o_orderkey) as end_key, match_number() as mno, classifier() as cl
  ONE ROW PER MATCH AFTER MATCH SKIP PAST LAST ROW
  PATTERN (down+ up+)
  DEFINE down AS o_totalprice < PREV(o_totalprice),
         up AS o_totalprice > PREV(o_totalprice)
) order by o_custkey, mno"""
MR_ALL = """select count(*), max(mno) from orders MATCH_RECOGNIZE (
  PARTITION BY o_custkey ORDER BY o_orderdate, o_orderkey
  MEASURES match_number() as mno
  ONE ROW PER MATCH
  PATTERN (a) DEFINE a AS true)"""
MR_ALL_CHECK = """select sum(c), max(c) from
(select o_custkey, count(*) c from orders group by o_custkey)"""
MR_NEXT = """select * from orders MATCH_RECOGNIZE (
  PARTITION BY o_custkey ORDER BY o_orderdate, o_orderkey
  MEASURES first(up.o_orderkey) as k0, last(up.o_orderkey) as k1, match_number() as mno
  ONE ROW PER MATCH AFTER MATCH SKIP TO NEXT ROW
  PATTERN (up{2,4})
  DEFINE up AS o_totalprice > PREV(o_totalprice)
) order by o_custkey, mno"""
ZONE_QUERIES = (("tz_dst", TZ_DST), ("tz_mixed", TZ_MIXED), ("tz_mixed_check", TZ_MIXED_CHECK),
                ("tz_trunc", TZ_TRUNC), ("tz_join", TZ_JOIN), ("mr_orders", MR_ORDERS),
                ("mr_all", MR_ALL), ("mr_all_check", MR_ALL_CHECK), ("mr_next", MR_NEXT))

TSTZ_TABLES = {
    # tests/test_timestamptz.py: TestEngineIntegration.rt (schema t)
    "t": {"ev": (("ts", "v"), [(f"2024-03-10 01:59:00 {TZ_NY}", 1),
                               (f"2024-03-10 03:00:00 {TZ_NY}", 2),
                               (f"2024-03-10 03:00:00 {TZ_NY}", 3), (None, 4)])},
    # TestMixedZoneKeys.rz, and test_join_matches_across_zones's mu
    "z": {"mz": (("ts", "v"), [("2024-03-10 01:59:00 America/New_York", 1),
                               ("2024-03-10 06:59:00 UTC", 2),
                               ("2024-03-10 07:59:00 UTC", 5)]),
          "mu": (("ts", "w"), [("2024-03-10 06:59:00 UTC", 77)])},
}
TSTZ_SESSION_ZONE = {"t": TZ_NY, "z": "UTC"}

TSTZ_SQL = [
    # tests/test_timestamptz.py: TestLiteralsAndCasts
    ("t", f"select timestamp '2024-07-04 12:30:15.250 {TZ_NY}'"),
    ("t", "select cast(timestamp '2024-07-04 16:30:00 UTC' as timestamp)"),
    ("t", "select cast(timestamp '2024-07-04 12:30:00 -04:00' as timestamp)"),
    ("t", "select cast('2024-01-15 12:00:00' as timestamp with time zone)"),
    ("t", "select cast(cast(timestamp '2024-03-10 03:00:00' as timestamp "
          "with time zone) as timestamp) "),
    ("t", "select cast(timestamp '2024-01-15 23:30:00 -05:00' as date)"),
    # TestAtTimeZone
    ("t", "select timestamp '2024-07-04 12:00:00 UTC' at time zone 'Asia/Tokyo'"),
    ("t", "select at_timezone(timestamp '2024-07-04 12:00:00 UTC', '+05:30')"),
    ("t", "select with_timezone(timestamp '2024-07-04 12:00:00', 'Asia/Tokyo')"),
    # TestExtract
    ("t", "select extract(year from ts), extract(month from ts), "
          "extract(day from ts), extract(hour from ts), "
          "extract(minute from ts) from (select timestamp "
          "'2024-12-31 23:45:00 -05:00' as ts)"),
    ("t", "select extract(timezone_hour from ts), "
          "extract(timezone_minute from ts) from (select timestamp "
          "'2024-06-01 00:00:00 +05:30' as ts)"),
    ("t", "select extract(timezone_hour from ts) from (select "
          f"timestamp '2024-01-15 12:00:00 {TZ_NY}' as ts)"),
    # TestArithmetic
    ("t", f"select timestamp '2024-03-09 12:00:00 {TZ_NY}' + interval '1' day"),
    ("t", f"select timestamp '2024-11-03 01:30:00 {TZ_NY}' - interval '2' hour"),
    ("t", "select timestamp '2024-01-01 00:00:00 UTC' < "
          "timestamp '2024-01-01 00:00:01 UTC'"),
    # TestEngineIntegration (table ev)
    ("t", "select ts, count(*) from ev group by ts order by ts"),
    ("t", f"select count(*) from ev where ts >= timestamp '2024-03-10 03:00:00 {TZ_NY}'"),
    ("t", "select min(ts), max(ts) from ev"),
    ("t", "select current_timezone()"),
    # TestCoercionAndFunctions
    ("t", "select timestamp '2024-07-04 08:00:00' = timestamp '2024-07-04 12:00:00 UTC'"),
    ("t", "select timestamp '2024-07-04 07:59:00' < timestamp '2024-07-04 12:00:00 UTC'"),
    ("t", "select timestamp '2024-07-04 12:00:00 UTC' "
          "at time zone 'Asia/Tokyo' + interval '1' hour"),
    ("t", "select date_trunc('day', timestamp '2024-07-04 01:30:00 Asia/Tokyo')"),
    ("t", f"select date_add('hour', 3, timestamp '2024-03-10 00:30:00 {TZ_NY}')"),
    ("t", f"select date_add('day', 1, timestamp '2024-03-09 12:00:00 {TZ_NY}')"),
    ("t", f"select date_diff('hour', timestamp '2024-03-10 00:00:00 {TZ_NY}', "
          f"timestamp '2024-03-11 00:00:00 {TZ_NY}')"),
    ("t", "select year(ts), month(ts), hour(ts) from (select "
          "timestamp '2024-12-31 23:00:00 -05:00' as ts)"),
    # TestMixedZoneKeys (tables mz, mu)
    ("z", "select ts, sum(v) from mz group by ts order by 2"),
    ("z", "select count(distinct ts) from mz"),
    ("z", "select distinct ts from mz order by ts"),  # ordered here to compare rows
    ("z", "select mz.v, mu.w from mz join mu on mz.ts = mu.ts order by 1"),
    ("z", "select v from mz where ts in (select ts from mu) order by 1"),
    ("z", "select v, count(*) over (partition by ts) c, "
          "sum(v) over (partition by ts) s from mz order by v"),
    ("z", "select v, row_number() over (partition by ts order by v) r from mz order by v"),
]
# test_now_is_tstz: now() reads the clock, so only its zone is compared
TSTZ_NOW = "select now()"

MR_STOCK = [  # tests/test_match_recognize.py's runner fixture
    ("a", 1, 90), ("a", 2, 80), ("a", 3, 70), ("a", 4, 85), ("a", 5, 95), ("a", 6, 60),
    ("a", 7, 50), ("a", 8, 80), ("b", 1, 20), ("b", 2, 10), ("b", 3, 30), ("b", 4, 40)]
# NULL keys: a NULL symbol (code 0, the same data as 'a') and a NULL day
# (data 0) in the stock rows
MR_STOCK_NULLS = MR_STOCK + [(None, 1, 5), (None, 2, 3), ("b", None, 25)]
# edge inputs: one row, no row
MR_EDGE_TABLES = (("stock_one", [("a", 5, 95)]), ("stock_none", []))

MR_V = """
select * from stock MATCH_RECOGNIZE (
  PARTITION BY symbol
  ORDER BY day
  MEASURES
    first(down.day) as start_day,
    last(down.price) as bottom_price,
    last(up.day) as end_day,
    match_number() as mno
  ONE ROW PER MATCH
  AFTER MATCH SKIP PAST LAST ROW
  PATTERN (down+ up+)
  DEFINE
    down AS price < PREV(price),
    up AS price > PREV(price)
)
order by symbol, start_day
"""

MR_SQL = [
    # tests/test_match_recognize.py: test_v_shape
    MR_V,
    # test_skip_to_next_row
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES first(down.day) as d, match_number() as m
      ONE ROW PER MATCH
      AFTER MATCH SKIP TO NEXT ROW
      PATTERN (down down)
      DEFINE down AS price < PREV(price)
    ) where symbol = 'a' order by d""",
    # test_alternation_and_classifier
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES classifier() as which, first(up.day) as ud,
               first(down.day) as dd
      ONE ROW PER MATCH
      PATTERN (up | down)
      DEFINE up AS price > PREV(price),
             down AS price < PREV(price)
    ) where symbol = 'b' order by coalesce(ud, dd)""",
    # test_optional_and_repetition
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES first(down.day) as s, last(down.day) as e
      ONE ROW PER MATCH
      PATTERN (down{2})
      DEFINE down AS price < PREV(price)
    ) order by symbol, s""",
    # test_undefined_variable_matches_all
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES first(down.day) as s, last(b.day) as nxt
      ONE ROW PER MATCH
      PATTERN (down b)
      DEFINE down AS price < PREV(price)
    ) where symbol = 'b' order by s""",
    # test_partition_boundary_isolates_prev
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES first(down.day) as s
      ONE ROW PER MATCH
      PATTERN (down)
      DEFINE down AS price < PREV(price)
    ) order by symbol, s""",
    # test_next_navigation
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES first(peak.day) as d, first(peak.price) as p
      ONE ROW PER MATCH
      PATTERN (peak)
      DEFINE peak AS price > PREV(price) AND price > NEXT(price)
    ) order by symbol, d""",
    # test_measures_without_partition
    """select * from stock MATCH_RECOGNIZE (
      ORDER BY symbol, day
      MEASURES match_number() as m, first(r.price) as p
      ONE ROW PER MATCH
      PATTERN (r{3})
      DEFINE r AS price >= 0
    )""",
    # beyond the corpus: descending order, a whole-match measure, an
    # optional and a star, the empty match's row, alternation in a group
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day desc
      MEASURES first(day) as d0, last(day) as d1, last(price) as p, classifier() as c,
               match_number() as m
      ONE ROW PER MATCH
      PATTERN (up? down*)
      DEFINE up AS price > NEXT(price), down AS price < PREV(price)
    ) order by symbol, m""",
    """select * from stock MATCH_RECOGNIZE (
      ORDER BY price
      MEASURES first(x.symbol) as s, last(y.day) as d, classifier() as c
      ONE ROW PER MATCH
      PATTERN ((x | y)+ x)
      DEFINE x AS symbol = 'a', y AS price > PREV(price, 2)
    )""",
    """select * from stock MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY price desc, day
      MEASURES match_number() as m, last(x.day) as d, classifier() as c
      ONE ROW PER MATCH
      PATTERN (x y*)
      DEFINE x AS price > NEXT(price), y AS price < PREV(price, 1)
    ) order by symbol, m""",
    # one input row, and none
    """select * from stock_one MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES match_number() as m, first(x.day) as d, classifier() as c
      ONE ROW PER MATCH PATTERN (x) DEFINE x AS price > 0)""",
    """select * from stock_none MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES match_number() as m, first(x.day) as d
      ONE ROW PER MATCH PATTERN (x) DEFINE x AS price > 0)""",
    """select count(*) from stock_none MATCH_RECOGNIZE (
      ORDER BY day MEASURES match_number() as m
      ONE ROW PER MATCH PATTERN (x) DEFINE x AS price > 0)""",
]
MR_NULL_SQL = [
    # a NULL order key sorts by its data (0): first in its partition
    """select * from stock_nulls MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES first(day) as d0, last(day) as d1, first(price) as p0, match_number() as m
      ONE ROW PER MATCH
      PATTERN (s+)
      DEFINE s AS price > coalesce(PREV(price), 0)
    ) where symbol = 'b' order by m""",
    # a NULL partition key is its own partition (the reference merges it
    # into 'a', whose code its data holds; ROADMAP §3)
    """select * from stock_nulls MATCH_RECOGNIZE (
      PARTITION BY symbol ORDER BY day
      MEASURES first(day) as d, first(price) as p, match_number() as m
      ONE ROW PER MATCH
      PATTERN (down)
      DEFINE down AS price < PREV(price)
    ) order by symbol, d""",
]


def tstz_load(conn, mod, column_metadata, tz, schema: str) -> None:
    """TSTZ_TABLES[schema] into a memory connector of either package
    (`mod` its types module, `tz` its ops.tz): the packed values that
    the literals parse to, NULL from valids."""
    import numpy as np

    for name, ((tcol, vcol), rows) in TSTZ_TABLES[schema].items():
        packed = np.array([tz.parse_tstz(t) if t is not None else 0 for t, _ in rows], np.int64)
        valid = np.array([t is not None for t, _ in rows], bool)
        conn.load_table(schema, name, [column_metadata(tcol, mod.TIMESTAMP_TZ),
                                       column_metadata(vcol, mod.BIGINT)],
                        [packed, np.array([v for _, v in rows], np.int64)],
                        valids=[None if valid.all() else valid, None])


def tstz_runner(schema: str, device: str):
    """The port's runner over TSTZ_TABLES[schema], in its session zone."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.spi import ColumnMetadata
    from trino_tpu_torch.engine import LocalQueryRunner, Session
    from trino_tpu_torch.ops import tz

    conn = create_memory_connector()
    tstz_load(conn, T, ColumnMetadata, tz, schema)
    r = LocalQueryRunner(Session(catalog="memory", schema=schema,
                                 timezone=TSTZ_SESSION_ZONE[schema]), device=device)
    r.register_catalog("memory", conn)
    return r


def mr_load(conn, mod, column_metadata) -> None:
    """MR_STOCK as `stock`, MR_STOCK_NULLS as `stock_nulls` and
    MR_EDGE_TABLES (schema default) into a memory connector of either
    package."""
    import numpy as np

    cols = [column_metadata("symbol", mod.VARCHAR), column_metadata("day", mod.INTEGER),
            column_metadata("price", mod.INTEGER)]
    for name, rows in (("stock", MR_STOCK), ("stock_nulls", MR_STOCK_NULLS)) + MR_EDGE_TABLES:
        valids = [np.array([r[i] is not None for r in rows], bool) for i in range(3)]
        conn.load_table("default", name, cols, [
            [r[0] for r in rows],
            np.array([r[1] or 0 for r in rows], np.int32),
            np.array([r[2] for r in rows], np.int32)],
            valids=[None if v.all() else v for v in valids])


def mr_runner(device: str):
    """The port's runner over the stock tables."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.spi import ColumnMetadata
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    conn = create_memory_connector()
    mr_load(conn, T, ColumnMetadata)
    r = LocalQueryRunner(Session(catalog="memory", schema="default"), device=device)
    r.register_catalog("memory", conn)
    return r


def zone_days(dates):
    """Each distinct day of `dates` (epoch days) once, as the instant of
    its midnight in New York packed with the UTC zone (id 0): what
    TZ_MIDNIGHT makes of it, held in another zone. Python's zoneinfo
    resolves the offsets."""
    import datetime as dt
    from zoneinfo import ZoneInfo

    import numpy as np

    ny = ZoneInfo(TZ_NY)
    out = []
    for d in np.unique(dates).tolist():
        wall = dt.datetime(1970, 1, 1) + dt.timedelta(days=d)
        ms = int(wall.replace(tzinfo=ny).timestamp()) * 1000
        out.append(ms << 12)  # ops/tz.py's MILLIS_SHIFT, zone 0
    return np.asarray(out, np.int64)


def zone_hour_counts(dates) -> list:
    """TZ_DST's answer from zoneinfo: [utc offset hour of New York's
    midnight, orders] over the generated o_orderdate column."""
    import datetime as dt
    from zoneinfo import ZoneInfo

    import numpy as np

    ny = ZoneInfo(TZ_NY)
    days, counts = np.unique(dates, return_counts=True)
    by_hour: dict = {}
    for d, c in zip(days.tolist(), counts.tolist()):
        wall = dt.datetime(1970, 1, 1) + dt.timedelta(days=d)
        h = int(wall.replace(tzinfo=ny).utcoffset().total_seconds()) // 3600
        by_hour[h] = by_hour.get(h, 0) + c
    return [[h, by_hour[h]] for h in sorted(by_hour)]


def orders_dates(schema: str):
    """The generated o_orderdate column (epoch days) at `schema`."""
    from trino_tpu_torch.connectors.tpch import _schema_sf

    return orders_columns(_schema_sf(schema), "o_orderdate")[0][0]


def zones_load_days(conn, mod, column_metadata, schema: str) -> None:
    """zone_days of the orders at `schema` as table zones.days (column d
    TIMESTAMP WITH TIME ZONE) of either package's memory connector."""
    conn.load_table("zones", "days", [column_metadata("d", mod.TIMESTAMP_TZ)],
                    [zone_days(orders_dates(schema))])


def zones_runner(schema: str, device: str):
    """The port's runner over tpch at `schema` with zones.days in the
    memory catalog."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.spi import ColumnMetadata

    r = runner(schema, device)
    conn = create_memory_connector()
    zones_load_days(conn, T, ColumnMetadata, schema)
    r.register_catalog("memory", conn)
    return r


def check_zones(rows: dict, dates, n_orders: int) -> None:
    """The zone queries' identities: DST counts equal zoneinfo's, the
    mixed-zone groups equal count(distinct o_orderdate), every order
    lands in one day of date_trunc and of the join."""
    import numpy as np

    n_days = len(np.unique(dates))
    if rows["tz_dst"] != zone_hour_counts(dates):
        raise AssertionError(f"tz_dst {rows['tz_dst']} != zoneinfo's "
                             f"{zone_hour_counts(dates)}")
    if rows["tz_mixed"] != [[n_days, n_orders]] or rows["tz_mixed_check"] != [[n_days]]:
        raise AssertionError(f"tz_mixed {rows['tz_mixed']}, check {rows['tz_mixed_check']}: "
                             f"want {n_days} groups of {n_orders} orders")
    if sum(c for _, c in rows["tz_trunc"]) != n_orders:
        raise AssertionError("tz_trunc: the day counts do not sum to the orders")
    if rows["tz_join"] != [[n_orders]]:
        raise AssertionError(f"tz_join counts {rows['tz_join']}, not {n_orders}")


def check_patterns(rows: dict) -> None:
    """MR_ALL: one match a row, numbered up to the most orders of one
    customer."""
    if rows["mr_all"] != rows["mr_all_check"]:
        raise AssertionError(f"mr_all {rows['mr_all']} != count(*), most orders of a "
                             f"customer {rows['mr_all_check']}")

# ---- phase write: DDL, DML, MERGE and transactions -------------------------

# phase write's statements at sf1, each cold once on the card: a memory
# catalog `w` beside the session's tpch (unqualified names are tpch's).
# tests/test_torch_write.py runs them with their identities at tiny on the
# CPU; phase parity holds the card to the CPU at tiny and sf0.1
WRITE_CTAS = "create table w.s.orders as select * from orders"
WRITE_CTAS_CHECK = "select count(*), sum(o_orderkey), sum(o_totalprice) from {t}"
WRITE_CUST = "create table w.s.cust (k bigint, n bigint, total double)"
WRITE_CUST_INSERT = """insert into w.s.cust select o_custkey, count(*), sum(o_totalprice)
from orders group by 1"""
WRITE_CUST_CHECK = "select count(*), sum(n) from w.s.cust"
WRITE_CUSTKEYS = "select count(distinct o_custkey) from orders"
WRITE_OLD = "o_orderdate < date '1993-01-01'"
WRITE_UPDATE = f"update w.s.orders set o_orderstatus = 'X' where {WRITE_OLD}"
WRITE_UPDATE_SOURCE = f"select count(*) from orders where {WRITE_OLD}"
WRITE_UPDATE_CHECK = "select count(*) from w.s.orders where o_orderstatus = 'X'"
WRITE_DELETE = "delete from w.s.orders where o_orderpriority = '5-LOW'"
WRITE_COUNT = "select count(*) from w.s.orders"
# a quarter of the orders: the deleted 5-LOW orders come back, the rest
# update
WRITE_MERGE = """merge into w.s.orders t using (select * from orders
where o_orderkey % 4 = 0) s on t.o_orderkey = s.o_orderkey
when matched then update set o_comment = 'merged', o_totalprice = s.o_totalprice + 1
when not matched then insert values (s.o_orderkey, s.o_custkey, s.o_orderstatus,
s.o_totalprice, s.o_orderdate, s.o_orderpriority, s.o_clerk, s.o_shippriority,
s.o_comment)"""
WRITE_MERGE_SOURCE = """select count(*), count_if(o_orderpriority = '5-LOW')
from orders where o_orderkey % 4 = 0"""
WRITE_TXN = [  # (statement, the count of w.s.cust after it: n, or 2n)
    ("start transaction", 1), ("insert into w.s.cust select * from w.s.cust", 1),
    ("rollback", 1), ("start transaction", 1),
    ("insert into w.s.cust select * from w.s.cust", 1), ("commit", 2)]
WRITE_READ_ONLY = ["start transaction read only", "insert into w.s.cust values (1, 1, 1.0)",
                   "rollback"]
# three bounded keys (5 x 6 x 3 slots with the NULL groups, over the dense
# route's 64): the grouped_sum route
WRITE_GROUP = """select o_orderstatus, o_orderpriority, o_comment = 'merged' m, count(*),
sum(o_totalprice) from w.s.orders group by 1, 2, 3 order by 1, 2, 3"""
WRITE_DROPS = ["drop table w.s.orders", "drop table w.s.cust"]


def write_statements() -> list:
    """Phase write's statements in order, for the card-against-CPU check
    (the read-only violation and the SELECT after the drops raise on
    both)."""
    return ([WRITE_CTAS, WRITE_CTAS_CHECK.format(t="w.s.orders"),
             WRITE_CTAS_CHECK.format(t="orders"), WRITE_CUST, WRITE_CUST_INSERT,
             WRITE_CUST_CHECK, WRITE_UPDATE, WRITE_UPDATE_CHECK, WRITE_DELETE, WRITE_COUNT,
             WRITE_MERGE, WRITE_COUNT] + [s for s, _ in WRITE_TXN] + [WRITE_CUST_CHECK]
            + WRITE_READ_ONLY + [WRITE_GROUP] + WRITE_DROPS + [WRITE_COUNT])


# The write corpus: each script runs on a fresh runner with a memory
# catalog and tpch (tiny), its setup first. tests/test_torch_write.py holds
# the port to trino_tpu on every script, statement by statement (where the
# corpus exposes the test function, it runs that function and checks that
# it ran exactly these statements); phase parity holds the card to the CPU.
WRITE_SETUPS = {
    # tests/test_dml.py TestDeleteUpdate._runner
    "dml_t": ["CREATE TABLE t (x bigint, name varchar)",
              "INSERT INTO t VALUES (1, 'a'), (2, 'b'), (3, 'c'), (4, 'd')"],
    # tests/test_merge.py's r fixture
    "merge": ["create table memory.t.tgt (id bigint, v varchar, amt double)",
              "insert into tgt values (1, 'a', 10.0), (2, 'b', 20.0), (3, 'c', 30.0)",
              "create table memory.t.src (id bigint, v varchar, amt double)",
              "insert into src values (2, 'B', 200.0), (3, 'C', -1.0), "
              "(4, 'd', 40.0), (5, 'e', 50.0)"],
    # tests/test_decimal128.py's r fixture, TestFullDivision.rd and
    # TestHolisticLongDecimal.rh
    "decimal_big": [
        "create table memory.t.big (a decimal(30,4), b decimal(30,4), k bigint)",
        "insert into big values (12345678901234567890123456.7890, 2.0000, 1), "
        "(-9999999999999999999999.9999, 3.5000, 1), (0.0001, -1.0000, 2), "
        "(7777777777777777777777.7777, 0.5000, 2), (null, 1.0000, 3)"],
    "decimal_dd": [
        "create table memory.t.dd (a decimal(38,2), b decimal(38,2))",
        "insert into dd values "
        "(12345678901234567890123456789012.45, 98765432109876543210987654.32), "
        "(-9999999999999999999999999999999.99, 12345678901234567890.12), "
        "(1.00, 33333333333333333333333333333333.33), "
        "(-5000000000000000000000000000000.00, -7000000000000000000000000000000.00)"],
    "decimal_hb": [
        "create table memory.t.hb (k bigint, x decimal(38,2), y bigint)",
        "insert into hb values (1, 99999999999999999999999999999999999.01, 10), "
        "(1, -99999999999999999999999999999999999.02, 20), (1, 5.00, 30), "
        "(2, 12345678901234567890123456789.00, 40), "
        "(2, 12345678901234567890123456788.99, 50)"],
    # tests/test_array_columns.py's orders_tags, loaded there, written here
    "tags": ["create table orders_tags (id bigint, name varchar, tags array(varchar),"
             " scores array(bigint))",
             "insert into orders_tags values (1, 'ann', array['red', 'blue'], array[10, 20]),"
             " (2, 'bob', array['green'], array[30]),"
             " (3, 'cid', cast(array[] as array(varchar)), cast(array[] as array(bigint))),"
             " (4, 'dee', array['red', 'green', 'blue'], array[1, 2, 3])"],
    # a small table for the transaction cases
    "txn": ["create table c (k bigint, s varchar)",
            "insert into c values (1, 'a'), (2, 'b')"],
}


def _ws(schema: str, sql: list, setup: str = None, catalog: str = "memory",
        **session) -> dict:
    return {"catalog": catalog, "schema": schema, "setup": setup, "sql": sql,
            "session": session}


MERGE_ROWS = "select id, v, amt from tgt"  # tests/test_merge.py rows()
WRITE_SCRIPTS = {
    # tests/test_dml.py
    "dml_create_insert_select_drop": _ws("default", [
        "CREATE TABLE t (a bigint, b varchar, c double)",
        "INSERT INTO t VALUES (1, 'x', 1.5), (2, 'y', -2.25), (3, NULL, 0.0)",
        "SELECT * FROM t ORDER BY a", "INSERT INTO t (a) VALUES (99)",
        "SELECT count(*), sum(a) FROM t", "DROP TABLE t", "SELECT * FROM t"]),
    "dml_insert_from_query_with_coercion": _ws("default", [
        "CREATE TABLE s (k bigint, total double)",
        "INSERT INTO s SELECT n_regionkey, count(*) FROM tpch.tiny.nation"
        " GROUP BY n_regionkey", "SELECT sum(total) FROM s"]),
    "dml_ctas": _ws("default", [
        "CREATE TABLE agg AS SELECT n_regionkey, count(*) c"
        " FROM tpch.tiny.nation GROUP BY n_regionkey",
        "SELECT * FROM agg ORDER BY n_regionkey"]),
    "dml_values_standalone": _ws("default", [
        "VALUES (1, 'a'), (2, 'b')", "SELECT 1 UNION ALL VALUES (2)"]),
    "dml_delete_predicate": _ws("s", [
        "DELETE FROM t WHERE x > 2", "SELECT x FROM t ORDER BY x"], "dml_t"),
    "dml_delete_all": _ws("s", [
        "DELETE FROM t", "SELECT count(*) FROM t", "INSERT INTO t VALUES (9, 'z')",
        "SELECT count(*) FROM t"], "dml_t"),
    "dml_delete_null_predicate_keeps_row": _ws("s", [
        "INSERT INTO t VALUES (NULL, 'n')", "DELETE FROM t WHERE x > 2",
        "SELECT count(*) FROM t"], "dml_t"),
    "dml_update_with_predicate": _ws("s", [
        "UPDATE t SET name = 'z', x = x + 10 WHERE x = 2",
        "SELECT x, name FROM t ORDER BY x"], "dml_t"),
    "dml_update_all_rows_with_coercion": _ws("s", [
        "UPDATE t SET x = x + 0.5", "SELECT sum(x) FROM t"], "dml_t"),
    "dml_duplicate_assignment_rejected": _ws("s", ["UPDATE t SET x = 1, x = 2"], "dml_t"),
    "dml_update_unknown_column": _ws("s", ["UPDATE t SET nope = 1"], "dml_t"),
    "dml_dml_rejected_in_explicit_transaction": _ws("s", [
        "START TRANSACTION", "DELETE FROM t WHERE x = 1", "ROLLBACK"], "dml_t"),
    # tests/test_merge.py
    "merge_full_upsert": _ws("t", [
        "merge into tgt t using src s on t.id = s.id "
        "when matched and s.amt < 0 then delete "
        "when matched then update set v = s.v, amt = s.amt "
        "when not matched then insert (id, v, amt) values (s.id, s.v, s.amt)",
        MERGE_ROWS], "merge"),
    "merge_clause_order_first_match_wins": _ws("t", [
        "merge into tgt t using src s on t.id = s.id "
        "when matched and s.amt < 0 then delete "
        "when matched then update set amt = s.amt "
        "when not matched and s.amt > 45 then insert (id, v, amt) "
        "values (s.id, s.v, s.amt)", MERGE_ROWS], "merge"),
    "merge_update_only": _ws("t", [
        "merge into tgt t using src s on t.id = s.id "
        "when matched then update set amt = t.amt + s.amt", MERGE_ROWS], "merge"),
    "merge_delete_only": _ws("t", [
        "merge into tgt t using src s on t.id = s.id when matched then delete",
        MERGE_ROWS], "merge"),
    "merge_insert_only_with_default_null": _ws("t", [
        "merge into tgt t using src s on t.id = s.id "
        "when not matched then insert (id) values (s.id)", MERGE_ROWS], "merge"),
    "merge_subquery_source": _ws("t", [
        "merge into tgt t using "
        "(select id, amt * 2 as amt2 from src where amt > 0) s on t.id = s.id "
        "when matched then update set amt = s.amt2 "
        "when not matched then insert (id, amt) values (s.id, s.amt2)",
        MERGE_ROWS], "merge"),
    "merge_multiple_match_is_error": _ws("t", [
        "create table memory.t.dup (id bigint)", "insert into dup values (2), (2)",
        "merge into tgt t using dup s on t.id = s.id when matched then delete",
        MERGE_ROWS], "merge"),
    "merge_no_matches_noop": _ws("t", [
        "merge into tgt t using (select id from src where id > 100) s "
        "on t.id = s.id when matched then delete", MERGE_ROWS], "merge"),
    # TestScaledWriters.test_large_write_scales_out
    "merge_large_write_scales_out": _ws("t", [
        "create table memory.t.small (x bigint)", "create table memory.t.big2 (x bigint)",
        "insert into small values (1), (2)",
        "insert into big2 select x from unnest(sequence(1, 5000)) as u(x)",
        "select count(*) from big2"], batch_rows=1 << 16, task_concurrency=4),
    # TestInsertOnlyMultiMatch.test_insert_only_merge_with_duplicate_matches
    "merge_insert_only_merge_with_duplicate_matches": _ws("t", [
        "create table memory.t.tg2 (k bigint, v bigint)",
        "insert into tg2 values (1, 100), (2, 200)",
        "create table memory.t.sr2 (k bigint, v bigint)",
        "insert into sr2 values (1, 111), (1, 112), (3, 300)",
        "merge into tg2 using sr2 s on tg2.k = s.k "
        "when not matched then insert (k, v) values (s.k, s.v)",
        "select k, v from tg2"]),
    # tests/test_decimal128.py: TestTyping, TestArithmetic, TestRelational
    "decimal_literal_and_cast": _ws("t", ["select cast('1' as decimal(38,10))"], "decimal_big"),
    "decimal_add_result_type": _ws("t", ["select a + b from big where k = 2"], "decimal_big"),
    "decimal_mul_result_type": _ws("t", ["select b * b from big where k = 2"], "decimal_big"),
    "decimal_div_result_type": _ws("t", ["select a / b from big where k = 2"], "decimal_big"),
    "decimal_sum_is_38": _ws("t", ["select sum(a) from big"], "decimal_big"),
    "decimal_add_exact": _ws("t", ["select a + b from big where a is not null"],
                             "decimal_big"),
    "decimal_mul_exact_midsize": _ws("t", ["select b * b from big order by k, b"],
                                     "decimal_big"),
    "decimal_div_half_up": _ws("t", [
        "select cast(7 as decimal(20,0)) / cast(2 as decimal(20,0))"], "decimal_big"),
    "decimal_sum_exact": _ws("t", ["select sum(a) from big"], "decimal_big"),
    "decimal_group_sum_and_keys": _ws("t", [
        "select k, sum(a), count(a) from big group by k order by k"], "decimal_big"),
    "decimal_min_max_global": _ws("t", ["select min(a), max(a) from big"], "decimal_big"),
    "decimal_avg_long": _ws("t", ["select avg(a) from big where k = 2"], "decimal_big"),
    "decimal_compare_and_filter": _ws("t", ["select k from big where a > 0 order by a"],
                                      "decimal_big"),
    "decimal_order_by_long": _ws("t", [
        "select a from big where a is not null order by a desc"], "decimal_big"),
    "decimal_group_by_long_key": _ws("t", [
        "select a, count(*) from big group by a order by count(*), a"], "decimal_big"),
    "decimal_join_on_long_key": _ws("t", [
        "select count(*) from big x join big y on x.a = y.a"], "decimal_big"),
    "decimal_between_long": _ws("t", [
        "select count(*) from big where a between -1e22 and 1e25"], "decimal_big"),
    "decimal_case_unifies_short_and_long": _ws("t", [
        "select sum(case when k = 1 then a else 0 end) from big"], "decimal_big"),
    # TestFullDivision, TestHolisticLongDecimal
    "decimal_div_128_divisor": _ws("t", ["select a / b from dd"], "decimal_dd"),
    "decimal_mod_128_divisor": _ws("t", ["select a % b from dd"], "decimal_dd"),
    "decimal_div_overflow_nulls": _ws("t", [
        "select a / 0.000001 from dd where a < -1e30"], "decimal_dd"),
    "decimal_min_by_long_decimal_by": _ws("t", [
        "select k, min_by(y, x), max_by(y, x) from hb group by k order by k"], "decimal_hb"),
    "decimal_min_max_with_holistic_mix": _ws("t", [
        "select k, min(x), min_by(y, x) from hb group by k order by k"], "decimal_hb"),
    # TestWindowValueFns.test_lead_lag_first_last_over_long_decimal
    "decimal_lead_lag_first_last_over_long_decimal": _ws("t", [
        "create table memory.t.wd (d decimal(38,2), g bigint)",
        "insert into wd values (1.50, 1), "
        "(99999999999999999999999999999999.00, 2), (3.25, 3)",
        "select lead(d) over (order by g), lag(d) over (order by g),"
        " first_value(d) over (order by g) from wd"]),
    # tests/test_nested_types.py test_nested_type_ddl_parses (its SHOW
    # COLUMNS is ROADMAP §1 item 8b)
    "nested_type_ddl": _ws("default", [
        "create table nested_ddl (a array(bigint), m map(varchar, bigint),"
        " r row(x bigint, y varchar))", "select * from nested_ddl"]),
    # tests/test_nested_types.py test_full_join_with_nested_payload (fa2
    # loaded there, written here)
    "nested_full_join_with_nested_payload": _ws("default", [
        "create table fa2 (x bigint, t array(bigint))",
        "insert into fa2 values (1, array[10]), (2, array[20, 21])",
        "create table fb2 (y bigint)", "insert into fb2 values (2), (3)",
        "select x, t, y from fa2 full join fb2 on x = y"]),
    # tests/test_array_columns.py test_ctas_and_insert_arrays and
    # test_ctas_string_arrays: ARRAY of bigint and of varchar through the
    # flat store
    "array_ctas_and_insert_arrays": _ws("default", [
        "create table arr_copy as select id, scores from orders_tags where id <= 2",
        "select id, scores from arr_copy order by id",
        "insert into arr_copy select id, scores from orders_tags where id = 4",
        "select s from arr_copy, UNNEST(scores) u(s) where id = 4 order by s"], "tags"),
    "array_ctas_string_arrays": _ws("default", [
        "create table tag_copy as select id, tags from orders_tags",
        "select t, count(*) from tag_copy, UNNEST(tags) u(t) group by t order by t",
        "insert into orders_tags select * from orders_tags",
        "delete from orders_tags where id = 2",
        "select id, tags, scores from orders_tags order by id"], "tags"),
    # TIMESTAMP WITH TIME ZONE written and read back (packed int64); an
    # UPDATE ... WHERE over it hits the reference's CASE fault (ROADMAP §3)
    "timestamptz_write": _ws("z", [
        "create table ev (id bigint, t timestamp with time zone)",
        "insert into ev values (1, timestamp '2021-03-14 01:30:00 America/New_York'),"
        " (2, timestamp '2021-03-14 03:30:00 America/New_York'),"
        " (3, timestamp '2021-06-01 12:00:00 Asia/Tokyo'), (4, null)",
        "create table ev2 as select id, t at time zone 'UTC' u from ev",
        "select id, t, hour(t) from ev order by id",
        "update ev set t = t + interval '1' hour",
        "delete from ev where t > timestamp '2021-05-01 00:00:00 UTC'",
        "select e.id, e.t, f.u from ev e join ev2 f on e.id = f.id order by e.id"]),
    # transactions: rollback, commit, the read-only violation, and DELETE,
    # UPDATE and MERGE inside an explicit transaction
    "txn_rollback": _ws("s", [
        "start transaction", "insert into c values (3, 'c')",
        "create table e as select * from c", "select count(*) from c", "rollback",
        "select count(*) from c", "select count(*) from e"], "txn"),
    "txn_commit": _ws("s", [
        "start transaction", "insert into c select k + 10, s from c",
        "insert into c values (7, null)", "start transaction", "commit",
        "select * from c order by k", "commit"], "txn"),
    "txn_read_only": _ws("s", [
        "start transaction read only", "insert into c values (1, 'x')",
        "create table d (k bigint)", "create table d2 as select * from c",
        "drop table c", "select count(*) from c", "rollback"], "txn"),
    "txn_dml_rejected": _ws("s", [
        "start transaction", "delete from c where k = 1", "update c set k = 0",
        "merge into c t using c s on t.k = s.k when matched then delete",
        "rollback", "delete from c where k = 1", "select * from c"], "txn"),
}

# CASE, IF and COALESCE over one temporal or nested type keep that type
# in the port, and UPDATE ... WHERE over a tstz or ARRAY column rewrites
# each assigned column to such a CASE. The reference types them as
# bigint and refuses the plan (ROADMAP §3), so they stay out of
# WRITE_SCRIPTS: tests/test_torch_statements.py and test_torch_write.py
# hold the port's answers, and phase parity holds the card to the CPU.
NESTED_CHOICE_SQL = (
    "select id, case when id = 1 then array['x', 'red'] else tags end from orders_tags"
    " order by id",
    "select id, case when id > 2 then tags end, coalesce(case when id > 1 then scores end,"
    " array[7]) from orders_tags order by id",
    "select id, if(id = 1, row(id, name), row(id + 10, 'zz')) from orders_tags order by id",
)
NON_NUMERIC_UPDATES = (
    "update ev set t = t + interval '1' hour where id = 1",
    "update orders_tags set scores = array[0] where id = 1",
)
CHOICE_SCRIPT = _ws("z", [
    *WRITE_SCRIPTS["timestamptz_write"]["sql"][:2],
    "select id, coalesce(t, timestamp '2024-01-01 00:00:00 UTC'),"
    " case when id > 1 then t end from ev order by id",
    *NESTED_CHOICE_SQL, *NON_NUMERIC_UPDATES,
    "select * from ev order by id", "select * from orders_tags order by id"], "tags")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int, mode: str = "cold") -> float:
    """Mean ms of one call on the card (CUDA events after a warm-up);
    by default each call alone after the L2 was emptied, the time to hold
    against a bound on device-memory bytes (explore.device_ms's modes)."""
    from trino_tpu_torch.explore import device_ms

    return device_ms(fn, iters, mode)


def timings(rec: dict, iters: int, kernel, wrapper, plain, library,
            plain_iters: int = 0) -> None:
    """The timed keys of a kernel record: `ms` the bare launch cold,
    `warm_ms` back to back with inputs warm in L2, `wrapper_ms` the
    wrapper called from Python one call after another (its host cost),
    `plain_ms` and `library_ms` (one PyTorch call, None where there is
    none) cold."""
    rec["ms"] = time_ms(kernel, iters)
    rec["warm_ms"] = time_ms(kernel, iters, "warm")
    rec["wrapper_ms"] = time_ms(wrapper, iters, "host")
    rec["plain_ms"] = time_ms(plain, plain_iters or iters)
    rec["library_ms"] = time_ms(library, iters) if library else None


# ---------------------------------------------------------------------------
# phase 3: grouped_sum against its plain version
# ---------------------------------------------------------------------------


def grouped_sum_inputs(n, k, capacity, seed, dead_frac=0.0, extreme=False,
                       out_of_range=0, ids="even"):
    """ids: "even" (drawn evenly over the slots), "one_slot" (every row
    in slot 0), "sorted" (the even ids sorted, so long runs of one slot)
    or "q_mxu" (explore.q_mxu_like_ids)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gid = rng.integers(0, capacity, n, dtype=np.int32)
    if ids == "one_slot":
        gid[:] = 0
    elif ids == "sorted":
        gid.sort()
    elif ids == "q_mxu":
        from trino_tpu_torch.explore import q_mxu_like_ids

        gid = q_mxu_like_ids(rng, n)
    if out_of_range:
        # live rows with ids outside [0, capacity) must add nothing
        pos = rng.choice(n, size=out_of_range, replace=False)
        gid[pos] = np.where(rng.random(out_of_range) < 0.5, -1, capacity)
    live = rng.random(n) >= dead_frac
    if extreme:
        big = np.int64(2 ** 63 - 1)
        vals = np.where(
            rng.random((k, n)) < 0.5, big - rng.integers(0, 1000, (k, n)),
            -big - 1 + rng.integers(0, 1000, (k, n)),
        ).astype(np.int64)
    else:
        vals = rng.integers(-(10 ** 12), 10 ** 12, (k, n), dtype=np.int64)
    dev = torch.device("cuda")
    return (
        torch.from_numpy(gid).to(dev),
        torch.from_numpy(vals).to(dev),
        torch.from_numpy(live).to(dev),
    )


def grouped_sum_bound_ms(n: int, n_used: int, k: int, capacity: int) -> tuple:
    """(bound_ms, bound_by): bytes read once (gid and live for all n
    rows, k values for the n_used live, in-range rows) and written once
    ((k+1) x capacity sums) over the memory rate, against (k+1) int64
    adds per used row over the INT32 rate."""
    bytes_moved = n * (4 + 1) + n_used * 8 * k + (k + 1) * capacity * 8
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_used * (k + 1) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_grouped_sum(n, k, capacity, seed, iters=0, args=None, **kw):
    """Holds the kernel against its plain version on (gid, values, live):
    `args` when given (captured from the main path), else inputs made
    from `seed`. With `iters`, also times kernel, plain version and one
    index_add_ call."""
    import torch
    from trino_tpu_torch.ops import mxu_groupby as M

    gid, vals, live = args or grouped_sum_inputs(n, k, capacity, seed, **kw)
    got = M.grouped_sum(gid, vals, live, capacity)
    want = M.grouped_sum_reference(gid, vals, live, capacity)
    torch.cuda.synchronize()
    # exact integer contract: any differing element fails the phase
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"grouped_sum disagrees with its plain version at "
                f"n={n} k={k} capacity={capacity}"
            )
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    used = live & (gid >= 0) & (gid < capacity)
    n_used = int(used.sum())
    rec = {"n": n, "k": k, "capacity": capacity, "max_abs_err": err,
           "live_rows": n_used,
           "column_chunks": -(-(k + 1) // M.columns_per_block(k + 1, capacity))}
    if iters:
        rec["ms"] = time_ms(lambda: M.grouped_sum(gid, vals, live, capacity), iters)
        rec["plain_ms"] = time_ms(
            lambda: M.grouped_sum_reference(gid, vals, live, capacity), iters
        )
        g64 = torch.where(used, gid.to(torch.int64), capacity)
        src = vals.T

        def library():
            return torch.zeros(
                (capacity + 1, k), dtype=torch.int64, device=gid.device
            ).index_add_(0, g64, src)

        rec["library_ms"] = time_ms(library, iters)
        # what one streaming read of the values costs: a PyTorch sum over
        # each value column (the bytes the kernel must read, nothing else)
        rec["stream_ms"] = time_ms(lambda: vals.sum(dim=1), iters)
        rec["bound_ms"], rec["bound_by"] = grouped_sum_bound_ms(
            n, n_used, k, capacity)
        # contention: rows per slot, and how many of a warp's 32 rows
        # share one slot, on average over warps
        hits = torch.bincount(gid[used].to(torch.int64), minlength=capacity)
        rec["slots_hit"] = int((hits > 0).sum())
        # slots one tile of the kernel touches: how much its sort gathers
        tiles = -(-n // M.TILE_ROWS)
        tile_of = torch.arange(n, device=gid.device) // M.TILE_ROWS
        pairs = torch.unique((tile_of * capacity + gid.to(torch.int64))[used])
        per_tile = torch.bincount(pairs // capacity, minlength=tiles)
        rec["tile_slots_mean"] = float(per_tile.float().mean())
        rec["tile_slots_max"] = int(per_tile.max())
        rec["top_slot_share"] = float(hits.max()) / max(n_used, 1)
        w = n // 32 * 32
        g = torch.where(used[:w], gid[:w].to(torch.int64), -1).view(-1, 32)
        g, _ = torch.sort(g, dim=1)
        run = torch.ones_like(g)
        for j in range(1, 32):
            same = (g[:, j] == g[:, j - 1]) & (g[:, j] >= 0)
            run[:, j] = torch.where(same, run[:, j - 1] + 1, 1)
        run = torch.where(g >= 0, run, 0)
        rec["warp_max_same_slot"] = float(run.max(dim=1).values.float().mean())
    return rec


def phase_kernel(results: dict) -> None:
    shapes = [
        ("q_mxu_sf1", dict(n=4_194_304, k=13, capacity=480, seed=1, iters=20)),
        ("dead_rows", dict(n=1001, k=2, capacity=17, seed=2, dead_frac=0.3)),
        ("column_split", dict(n=1 << 20, k=13, capacity=2048, seed=3, iters=20)),
        ("one_column", dict(n=1 << 20, k=1, capacity=480, seed=4)),
        ("wraparound", dict(n=1 << 16, k=3, capacity=64, seed=5, extreme=True)),
        ("out_of_range_ids", dict(n=5000, k=2, capacity=100, seed=6,
                                  out_of_range=500)),
        # the shapes a per-tile sort finds hard: one hot slot, long runs,
        # ragged tiles, and ids shaped like the query's
        ("one_slot", dict(n=1 << 20, k=13, capacity=480, seed=8, ids="one_slot",
                          iters=20)),
        ("sorted_runs", dict(n=4_194_304, k=13, capacity=480, seed=9, ids="sorted",
                             iters=20)),
        ("tile_plus_one", dict(n=4097, k=13, capacity=480, seed=10, dead_frac=0.1)),
        ("three_rows", dict(n=3, k=13, capacity=480, seed=11)),
        ("q_mxu_like_ids", dict(n=4_194_304, k=13, capacity=480, seed=12, ids="q_mxu",
                                iters=20)),
    ]
    recs = {}
    for name, kw in shapes:
        rec = check_grouped_sum(**kw)
        recs[name] = rec
        line = (f"[kernel] grouped_sum {name}: n={rec['n']} k={rec['k']} "
                f"capacity={rec['capacity']} chunks={rec['column_chunks']} "
                f"bit-exact")
        if "ms" in rec:
            line += " " + timing_text(rec)
        log(line)
    results["grouped_sum_checks"] = recs


def timing_text(rec: dict) -> str:
    return (f"ms={rec['ms']} plain_ms={rec['plain_ms']} "
            f"library_ms={rec['library_ms']} stream_ms={rec['stream_ms']} "
            f"bound_us={rec['bound_ms'] * 1e3} ({rec['bound_by']}) "
            f"live_rows={rec['live_rows']} slots_hit={rec['slots_hit']} "
            f"tile_slots_mean={rec['tile_slots_mean']} "
            f"tile_slots_max={rec['tile_slots_max']} "
            f"top_slot_share={rec['top_slot_share']} "
            f"warp_max_same_slot={rec['warp_max_same_slot']}")


# ---------------------------------------------------------------------------
# phase 3: the rank and gather kernels against their plain versions
# ---------------------------------------------------------------------------

# name -> (source, the TPU kernel it replaces)
NEW_KERNELS = {
    "window_rank": ("trino_tpu_torch/csrc/window_rank.cu",
                    "benchmarks/explore_kernel_costs.py:42"),
    "take_flat": ("trino_tpu_torch/csrc/gather.cu",
                  "benchmarks/explore_pallas_gather.py:59"),
    "take_rows_sum": ("trino_tpu_torch/csrc/gather.cu",
                      "benchmarks/explore_pallas_gather.py:88"),
    "take_along_lanes": ("trino_tpu_torch/csrc/gather.cu",
                         "benchmarks/explore_pallas_gather.py:117"),
}
DEAD_HASH, NO_MATCH_HASH = 0xFFFFFFFF, 0xFFFFFFFE


def bound(bytes_moved: int, int_ops: int) -> tuple:
    """(bound_ms, bound_by): bytes over the memory rate against 32-bit
    operations over the INT32 rate, the larger of the two."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held(name: str, got, want) -> int:
    """Exact agreement of a kernel with its plain version; returns the
    largest absolute difference (0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def search_bytes(n: int, n_b: int, elem: int, steps: int) -> int:
    """Bytes of b that n searches of `steps` levels must read: one 32-byte
    sector a step, and no more than all of b."""
    return min(n_b * elem, n * steps * 32)


def flat_sectors(table, idx) -> int:
    """Distinct 32-byte sectors of `table` that take_flat reads for `idx`
    (clipped), counted on the tensors' device; the table is taken to start
    on a sector boundary, as the allocator places it."""
    import torch

    if idx.numel() == 0:
        return 0
    j = torch.clamp(idx.reshape(-1).to(torch.int64), 0, int(table.shape[0]) - 1)
    return int(torch.unique(j // (32 // table.element_size())).numel())


def flat_bytes(n: int, idx_bytes: int, n_table: int, elem: int, sectors: int) -> int:
    """Bytes a flat gather must move: each index read and each output
    written once, and the table sectors the indices touch, no more than
    the whole table."""
    return n * (idx_bytes + elem) + min(n_table * elem, 32 * sectors)


def rank_bound(n_a: int, n_b: int, elem: int, searched: bool, w0: int = 0,
               nwin: int = 1) -> tuple:
    """Fixed mode: one compare and one add per (element, window position
    in range), an int64 compare counting two ops. Searched mode: one
    compare and one select per bisection step over the window heads and
    inside the window. Bytes: a, the part of b the mode must read, out."""
    per = 2 if elem == 4 else 3
    if searched:
        steps = (-(-n_b // 128)).bit_length() + 8
        return bound(n_a * (elem + 4) + search_bytes(n_a, n_b, elem, steps),
                     n_a * steps * per)
    m = max(0, min(n_b - w0 * 128, nwin * 128))
    return bound(n_a * (elem + 4) + m * elem, n_a * m * per)


def check_rank(name, a, b, searched, w0=0, nwin=1, edge=False, iters=0,
               library=True) -> dict:
    import torch
    from trino_tpu_torch.ops import window_rank as W

    got = W.rank(a, b, searched, w0, nwin, edge)
    want = W.rank_reference(a, b, searched, w0, nwin, edge)
    torch.cuda.synchronize()
    rec = {"case": name, "n_a": a.numel(), "n_b": int(b.shape[0]),
           "dtype": str(a.dtype), "mode": "searched" if searched else "fixed",
           "nwin": nwin, "max_abs_err": held(f"window_rank {name}", got, want)}
    if searched:
        # the searched mode is the lower bound #{b < a}
        lb = torch.searchsorted(b, a.reshape(-1)).to(torch.int32).reshape(a.shape)
        if not torch.equal(got, lb):
            raise AssertionError(f"window_rank {name}: not the lower bound")
    if iters:
        timings(rec, iters, W.launcher(a, b, searched, w0, nwin, edge)[0],
                lambda: W.rank(a, b, searched, w0, nwin, edge),
                lambda: W.rank_reference(a, b, searched, w0, nwin, edge),
                (lambda: torch.searchsorted(b, a)) if searched and library else None,
                max(1, iters // 10))
        rec["bound_ms"], rec["bound_by"] = rank_bound(
            a.numel(), int(b.shape[0]), a.element_size(), searched, w0, nwin)
    return rec


def check_bounds(name, q, b, iters=0) -> dict:
    """The bounds kernel against its plain version (two lower bounds)
    and against torch.searchsorted, left and right (q below the type's
    maximum). With `iters`, times kernel, wrapper, plain version and the
    two searchsorted calls."""
    import torch
    from trino_tpu_torch.ops import window_rank as W

    lo, hi = W.bounds(q, b)
    want_lo, want_hi = W.bounds_reference(q, b)
    torch.cuda.synchronize()
    rec = {"case": name, "n_a": q.numel(), "n_b": int(b.shape[0]),
           "dtype": str(q.dtype), "mode": "bounds",
           "max_abs_err": max(held(f"bounds {name} lo", lo, want_lo),
                              held(f"bounds {name} hi", hi, want_hi))}
    for got, right in ((lo, False), (hi, True)):
        if not torch.equal(got, torch.searchsorted(b, q, right=right, out_int32=True)):
            raise AssertionError(f"bounds {name}: not searchsorted(right={right})")
    if iters:
        def library():
            torch.searchsorted(b, q, out_int32=True)
            torch.searchsorted(b, q, right=True, out_int32=True)

        timings(rec, iters, W.bounds_launcher(q, b)[0], lambda: W.bounds(q, b),
                lambda: W.bounds_reference(q, b), library, max(1, iters // 10))
        elem, n, n_b = q.element_size(), q.numel(), int(b.shape[0])
        steps = (-(-n_b // 128)).bit_length() + 8 + 2  # heads, window, gallop
        rec["bound_ms"], rec["bound_by"] = bound(
            n * (elem + 8) + search_bytes(n, n_b, elem, steps),
            n * steps * (2 if elem == 4 else 3))
    return rec


def check_run_owner(name, off, n_out, iters=0) -> dict:
    """The run-owner kernel against its plain version and against
    torch.searchsorted(off, arange(n_out), right=True). With `iters`,
    times kernel, wrapper, plain version and that searchsorted call (on
    an arange made beforehand)."""
    import torch
    from trino_tpu_torch.ops import window_rank as W

    got = W.run_owner(off, n_out)
    want = W.run_owner_reference(off, n_out)
    torch.cuda.synchronize()
    j = torch.arange(n_out, dtype=torch.int32, device=off.device)
    rec = {"case": name, "n_a": n_out, "n_b": int(off.shape[0]),
           "dtype": str(off.dtype), "mode": "run_owner",
           "max_abs_err": held(f"run_owner {name}", got, want)}
    if not torch.equal(got, torch.searchsorted(off, j, right=True, out_int32=True)):
        raise AssertionError(f"run_owner {name}: not searchsorted(right=True)")
    if iters:
        timings(rec, iters, W.run_owner_launcher(off, n_out)[0],
                lambda: W.run_owner(off, n_out), lambda: W.run_owner_reference(off, n_out),
                lambda: torch.searchsorted(off, j, right=True, out_int32=True),
                max(1, iters // 10))
        # off read once, out written once; the fill computes nothing
        rec["bound_ms"], rec["bound_by"] = bound(4 * (int(off.shape[0]) + n_out), 0)
    return rec


def run_owner_offsets(counts):
    """Inclusive int32 cumulative sum of numpy counts, on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(np.cumsum(counts).astype(np.int32)).to("cuda")


def check_take_flat(name, table, idx, iters=0) -> dict:
    """take_flat against its plain version; records the table sectors the
    indices touch. With `iters`, times kernel, wrapper, plain version and
    torch.take (where no index clips) against the bound on the bytes the
    gather must move (`flat_bytes`)."""
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK

    got = GK.take_flat(table, idx)
    want = GK.take_flat_reference(table, idx)
    torch.cuda.synchronize()
    rec = {"case": name, "n_table": int(table.shape[0]), "n": idx.numel(),
           "elem_bytes": table.element_size(), "idx_bytes": idx.element_size(),
           "sectors": flat_sectors(table, idx),
           "max_abs_err": held(f"take_flat {name}", got, want)}
    if iters:
        in_range = bool(((idx >= 0) & (idx < table.shape[0])).all())
        # torch.take computes the same function when no index clips
        idx64 = idx.to(torch.int64)  # torch.take indexes with int64 only
        timings(rec, iters, GK.flat_launcher(table, idx)[0], lambda: GK.take_flat(table, idx),
                lambda: GK.take_flat_reference(table, idx),
                (lambda: torch.take(table, idx64)) if in_range else None)
        rec["bound_ms"], rec["bound_by"] = bound(flat_bytes(
            rec["n"], rec["idx_bytes"], rec["n_table"], rec["elem_bytes"], rec["sectors"]), 0)
    return rec


def take_flat_edges(t, rng) -> list:
    """take_flat at the edges of its layout (a warp takes 32 x flat_ilp
    consecutive outputs, a block 256 threads) on each side of `flat_ilp`'s
    choice: 1 to 5 indices, lengths one off a warp's chunk and a block's,
    lengths one off the shortest call that gathers FLAT_ILP outputs a
    thread, index views one to three elements in, a table view one element
    in, int32 and int64 indices, a non-contiguous index tensor; every
    index set has clipped ones."""
    import numpy as np
    from trino_tpu_torch.ops import cuda_build
    from trino_tpu_torch.ops import gather_kernels as GK

    full = GK.FLAT_THREADS * GK.FLAT_ILP * cuda_build.sm_count(t(np.zeros(1)).device)
    lengths = (1, 2, 3, 4, 5, 127, 128, 129, 1023, 1024, 1025,
               full - 1, full, full + 1, full + 127, full + 129)
    recs = []
    tab8 = t(rng.integers(-(1 << 62), 1 << 62, 1001))
    tables = (("int32", t(rng.integers(-(1 << 31), (1 << 31) - 1, 1001).astype(np.int32))),
              ("int64", tab8), ("int64 table[1:]", tab8[1:]))
    ix32 = t(rng.integers(-3, 1004, full + 136).astype(np.int32))
    for tname, table in tables:
        for iname, ix in (("int32", ix32), ("int64", ix32.long())):
            for off in (0, 1, 3):
                for n in lengths:
                    recs.append(check_take_flat(f"{tname}, {iname} idx[{off}:{off + n}]",
                                                table, ix[off:off + n]))
        recs.append(check_take_flat(f"{tname}, non-contiguous idx", table,
                                    ix32[:1040].view(40, 26).T))
    for rec in recs:
        rec["edge"] = True
    return recs


def check_take_rows_sum(name, table2d, ridx, iters=0) -> dict:
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK

    got = GK.take_rows_sum(table2d, ridx)
    want = GK.take_rows_sum_reference(table2d, ridx)
    torch.cuda.synchronize()
    rows, width = int(table2d.shape[0]), int(table2d.shape[1])
    n = ridx.numel()
    rec = {"case": name, "rows": rows, "width": width, "n": n,
           "path": GK.rows_sum_path(rows, n),
           "max_abs_err": held(f"take_rows_sum {name}", got, want)}
    if iters:
        # no single PyTorch call sums gathered rows
        timings(rec, iters, GK.rows_sum_launcher(table2d, ridx)[0],
                lambda: GK.take_rows_sum(table2d, ridx),
                lambda: GK.take_rows_sum_reference(table2d, ridx), None)
        # the least work: each index read and each output written once,
        # and each row an output needs summed once (at most n of them)
        needed = min(rows, n)
        rec["bound_ms"], rec["bound_by"] = bound(
            n * (ridx.element_size() + 4) + needed * width * 4, needed * (width - 1))
    return rec


def check_take_along_lanes(name, src, sel, iters=0) -> dict:
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK

    got = GK.take_along_lanes(src, sel)
    want = GK.take_along_lanes_reference(src, sel)
    torch.cuda.synchronize()
    rec = {"case": name, "rows": int(src.shape[0]), "width": int(src.shape[1]),
           "max_abs_err": held(f"take_along_lanes {name}", got, want)}
    if iters:
        sel64 = sel.to(torch.int64)
        timings(rec, iters, GK.along_launcher(src, sel)[0],
                lambda: GK.take_along_lanes(src, sel),
                lambda: GK.take_along_lanes_reference(src, sel),
                lambda: torch.gather(src, 1, sel64))
        rec["bound_ms"], rec["bound_by"] = bound(src.numel() * 4 * 3, 0)
    return rec


def phase_kernel_join(results: dict) -> None:
    """The four kernels of this slice at the explorers' shapes and at
    edge shapes: ragged lengths, empty inputs, clipped indices, the
    join's sentinel hashes and int64 values beyond 2^32."""
    import numpy as np
    import torch
    from trino_tpu_torch.explore import kernel_costs, pallas_gather

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    recs = {k: [] for k in NEW_KERNELS}
    # -- window rank: the explorer's k0..k4, then edges --
    at, b = kernel_costs.make_inputs(dev)
    for tag, nwin, edge in kernel_costs.VARIANTS[2:]:  # v0, v1 == v2
        recs["window_rank"].append(check_rank(
            f"explorer {tag}", at, b, False, 0, nwin, edge, iters=20))
    a_r = t(rng.integers(-(1 << 31), (1 << 31) - 1, 1001).astype(np.int32))
    b_r = t(rng.integers(-(1 << 31), (1 << 31) - 1, 1000).astype(np.int32))
    recs["window_rank"] += [
        check_rank("ragged fixed w0=7", a_r, b_r, False, 7, 2),
        check_rank("ragged fixed edge", a_r, b_r, False, 0, 3, True),
        check_rank("empty a", a_r[:0], b_r, False, 0, 2),
        check_rank("empty b fixed", a_r, b_r[:0], False, 0, 2),
        check_rank("empty b searched", a_r, t(np.zeros(0, np.int32)), True),
    ]
    # the join's u32 hash domain in int64 carriers, sentinels included
    hashes = np.sort(np.concatenate([
        rng.integers(0, 0xFFFFFFFE, 100_003),
        rng.integers(0, 1000, 5000),  # long runs of equal hashes
        np.full(777, DEAD_HASH),
    ])).astype(np.int64)
    probes = np.concatenate([
        rng.integers(0, 1 << 32, 50_001), hashes[::7],
        np.full(33, NO_MATCH_HASH), np.full(3, DEAD_HASH),
    ]).astype(np.int64)
    hb, hp = t(hashes), t(probes)
    recs["window_rank"] += [
        check_rank("hashes lo", hp, hb, True),
        check_rank("hashes hi (q+1)", hp + 1, hb, True),
    ]
    wide = np.sort(rng.integers(-(1 << 40), 1 << 40, 4097)).astype(np.int64)
    recs["window_rank"].append(check_rank(
        "int64 beyond 2^32", t(rng.integers(-(1 << 41), 1 << 41, 3000)), t(wide), True))
    counts = rng.integers(0, 4, 300_000).astype(np.int32)
    off = np.cumsum(counts).astype(np.int32)
    j1 = np.arange(1, int(off[-1]) + 17, dtype=np.int32)
    recs["window_rank"].append(check_rank("offsets int32 (j+1)", t(j1), t(off), True))
    big_b = t(np.sort(rng.integers(0, 0xFFFFFFFE, 1_500_000)).astype(np.int64))
    big_a = t(rng.integers(0, 1 << 32, 4_194_304).astype(np.int64))
    recs["window_rank"].append(check_rank(
        "probe batch 4,194,304 x 1.5M hashes", big_a, big_b, True, iters=20))
    # -- bounds: the probe's (lo, hi) in one launch --
    recs["window_rank"].append(check_bounds(
        "probe batch 4,194,304 x 1.5M hashes", big_a, big_b, iters=20))
    del big_a, big_b
    long_runs = np.sort(np.concatenate([
        rng.integers(0, (1 << 31) - 2, 20_000), np.full(300, 77), np.full(5000, 1 << 30)]))
    for dt in (np.int32, np.int64):
        lr = long_runs.astype(dt)
        q_lr = np.concatenate([rng.integers(0, (1 << 31) - 2, 7001), lr[::3]]).astype(dt)
        recs["window_rank"] += [
            check_bounds(f"runs of 300 and 5000 across windows, {dt.__name__}",
                         t(q_lr), t(lr)),
            check_bounds(f"n_b 77 < 128, {dt.__name__}", t(q_lr[:999] % 60),
                         t(np.sort(rng.integers(0, 50, 77)).astype(dt))),
            check_bounds(f"n_b 1000, ragged, {dt.__name__}", t(q_lr),
                         t(np.sort(rng.integers(0, 1 << 31, 1000)).astype(dt))),
            check_bounds(f"empty b, {dt.__name__}", t(q_lr), t(np.zeros(0, dt))),
            check_bounds(f"empty q, {dt.__name__}", t(q_lr[:0]), t(lr)),
        ]
    recs["window_rank"] += [
        check_bounds("hashes with sentinels", hp, hb),
        check_bounds("int64 beyond 2^32", t(rng.integers(-(1 << 41), 1 << 41, 3000)),
                     t(wide)),
    ]
    # heads past the 200 KB shared-memory budget: every 2^k-th head staged
    many = t(np.sort(rng.integers(0, 1 << 40, 5_000_000)))
    recs["window_rank"].append(check_bounds(
        "5M int64 (heads strided)", t(rng.integers(0, 1 << 40, 1_000_003)), many))
    del many
    # -- run_owner: the expansion's row of each output --
    plateaus = rng.integers(0, 3, 300_000) * (rng.random(300_000) < 0.4)
    one_run = np.zeros(64, np.int64)
    one_run[17], one_run[40:43] = 10_000, 1
    skew = np.zeros(1000, np.int64)
    skew[500] = 3_000_000  # one build key matching three million rows
    empty_stretch = np.zeros(1_000_000, np.int64)  # a million probe rows with
    empty_stretch[::250_000] = 5                   # no match between matches
    recs["window_rank"] += [
        check_run_owner("zero-count plateaus", run_owner_offsets(plateaus),
                        int(plateaus.sum())),
        check_run_owner("n_out past the total", run_owner_offsets(counts),
                        int(counts.sum()) + 333),
        check_run_owner("n_out below the total", run_owner_offsets(counts),
                        int(counts.sum()) // 3),
        check_run_owner("one run of 10,000", run_owner_offsets(one_run), 16_384),
        check_run_owner("one run of 3,000,000", run_owner_offsets(skew), 1 << 22,
                        iters=20),
        check_run_owner("empty runs between runs of 5", run_owner_offsets(empty_stretch),
                        30, iters=20),
        check_run_owner("one row", run_owner_offsets(np.array([3])), 7),
        check_run_owner("no rows", run_owner_offsets(np.zeros(0, np.int64)), 100),
        check_run_owner("no outputs", run_owner_offsets(counts), 0),
    ]
    # the expansion's sf1 shape: 4,194,304 probe rows with one match each
    # and a few hash-collision pairs, into 8,388,608 outputs
    sf1 = 1 + (rng.random(4_194_304) < 0.001)
    recs["window_rank"].append(check_run_owner(
        "expansion 8,388,608 outputs over 4,194,304 offsets",
        run_owner_offsets(sf1), 1 << 23, iters=20))
    # -- gathers: the explorer's shapes, then edges --
    x = pallas_gather.make_inputs(dev)
    table = x["table2d"].reshape(-1)
    recs["take_flat"] += [
        check_take_flat("explorer v1", table, x["idx2d"], iters=20),
        check_take_flat("clipped int32", table[:1001],
                        t(rng.integers(-50, 1100, 4999).astype(np.int32))),
        check_take_flat("int64 beyond 2^32, int64 idx",
                        t(rng.integers(-(1 << 50), 1 << 50, 1000)),
                        t(rng.integers(-3, 1004, 5001))),
        check_take_flat("empty idx", table, t(np.zeros(0, np.int32))),
    ]
    edges = take_flat_edges(t, rng)
    recs["take_flat"] += edges
    log(f"[kernel] take_flat edges: {len(edges)} cases bit-exact, on both sides of "
        f"flat_ilp's choice")
    recs["take_rows_sum"] += [
        check_take_rows_sum("explorer v2", x["table2d"], x["ridx2d"], iters=20),
        check_take_rows_sum(
            "wrapping sums, clipped rows",
            t(rng.integers((1 << 31) - 100, (1 << 31) - 1, (33, 128)).astype(np.int32)),
            t(rng.integers(-5, 40, 1001).astype(np.int32))),
        check_take_rows_sum("width 100", t(rng.integers(
            -(1 << 31), (1 << 31) - 1, (17, 100)).astype(np.int32)),
            t(rng.integers(0, 17, 999))),
        check_take_rows_sum("empty", x["table2d"], t(np.zeros(0, np.int32))),
        # more rows than indices: the per-output path
        check_take_rows_sum(
            "1,000,000 rows, 1,000 indices",
            t(rng.integers(-(1 << 31), (1 << 31) - 1, (1_000_000, 128)).astype(np.int32)),
            t(rng.integers(-10, 1_000_010, 1000).astype(np.int32)), iters=20),
        check_take_rows_sum("width 100, more rows than indices", t(rng.integers(
            -(1 << 31), (1 << 31) - 1, (5000, 100)).astype(np.int32)),
            t(rng.integers(-3, 5003, 999))),
        check_take_rows_sum(
            "one row", t(rng.integers(-(1 << 31), (1 << 31) - 1, (1, 128)).astype(np.int32)),
            t(rng.integers(-3, 4, 5000))),
    ]
    # width 128 from a buffer offset by one element: not 16-byte aligned
    odd = torch.empty(1001 * 128 + 1, dtype=torch.int32, device=dev)[1:].view(1001, 128)
    odd.copy_(t(rng.integers(-(1 << 31), (1 << 31) - 1, (1001, 128)).astype(np.int32)))
    recs["take_along_lanes"] += [
        check_take_along_lanes("explorer v3", x["src"], x["sel"], iters=20),
        check_take_along_lanes(
            "1001 rows, clipped selectors",
            t(rng.integers(-(1 << 31), (1 << 31) - 1, (1001, 128)).astype(np.int32)),
            t(rng.integers(-9, 140, (1001, 128)).astype(np.int32))),
        check_take_along_lanes(
            "width 100", t(rng.integers(0, 1 << 30, (999, 100)).astype(np.int32)),
            t(rng.integers(-5, 105, (999, 100)).astype(np.int32))),
        check_take_along_lanes(
            "width 128, unaligned", odd, t(rng.integers(-5, 133, (1001, 128)).astype(np.int32))),
        check_take_along_lanes("empty", x["src"][:0], x["sel"][:0]),
    ]
    for name, rs in recs.items():
        for rec in rs:
            if rec.get("edge"):
                continue
            line = f"[kernel] {name} {rec['case']}: bit-exact"
            if "path" in rec:
                line += f" path={rec['path']}"
            if "sectors" in rec:
                line += f" sectors={rec['sectors']}"
            if "bound_ms" in rec:
                line += (f" ms={rec['ms']} warm_ms={rec['warm_ms']} "
                         f"wrapper_ms={rec['wrapper_ms']} plain_ms={rec['plain_ms']} "
                         f"library_ms={rec['library_ms']} "
                         f"bound_us={rec['bound_ms'] * 1e3} ({rec['bound_by']})")
            log(line)
    results["join_kernel_checks"] = recs


# ---------------------------------------------------------------------------
# phase 4/5: the engine
# ---------------------------------------------------------------------------


def runner(schema: str, device: str, catalog: str = "tpch", **session):
    """A runner over the tpch or tpcds generator at `schema`."""
    from trino_tpu_torch.connectors.tpcds import create_tpcds_connector
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    r = LocalQueryRunner(Session(catalog=catalog, schema=schema, **session),
                         device=device)
    r.register_catalog(catalog, create_tpch_connector() if catalog == "tpch"
                       else create_tpcds_connector())
    return r


def tpcds_sql(name: str, r) -> str:
    """A TPC-DS template with tests/test_tpcds.py's parameter
    substitution, the values read through `r` at its own scale (ties
    broken by value, so the choice is deterministic)."""
    sql = TPCDS_QUERIES[name]

    def top(column):
        return r.execute(f"select {column} from item group by {column}"
                         f" order by count(*) desc, {column} limit 1").rows[0][0]

    if name == "q96":
        store = r.execute("select s_store_name from store order by s_store_sk"
                          " limit 1").rows[0][0]
        sql = sql.replace("'ese'", f"'{store}'")
    if name in ("q42", "q52"):
        sql = sql.replace("i_manager_id = 1", f"i_manager_id = {top('i_manager_id')}")
    if name == "q3":
        sql = sql.replace("i_manufact_id = 436", f"i_manufact_id = {top('i_manufact_id')}")
    if name == "q82":
        ids = [str(row[0]) for row in r.execute(
            "select distinct i_manufact_id from item where i_current_price"
            " between 30 and 60 order by 1 limit 4").rows]
        sql = sql.replace("437, 129, 727, 663", ", ".join(ids) or "437")
    return sql


def widestr_arrays(rows: int) -> tuple:
    """bench.py's config 5 arrays: WIDESTR_GROUPS strings of
    WIDESTR_WIDTH characters, zipf(1.3) codes and v uniform in
    [0, 10^6), from default_rng(7)."""
    import hashlib

    import numpy as np

    vals = [hashlib.sha256(f"widestr-{i}".encode()).hexdigest()[:WIDESTR_WIDTH]
            .ljust(WIDESTR_WIDTH, "x") for i in range(WIDESTR_GROUPS)]
    rng = np.random.default_rng(7)
    codes = rng.zipf(1.3, rows).astype(np.int64) % WIDESTR_GROUPS
    v = rng.integers(0, 1_000_000, rows, dtype=np.int64)
    return vals, codes, v


def widestr_runner(rows: int, device: str):
    """widestr_arrays(rows) loaded into the port's memory connector as
    bench.widestr. Returns the runner and the numpy arrays."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Dictionary
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.spi import ColumnMetadata
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    vals, codes, v = widestr_arrays(rows)
    mem = create_memory_connector()
    mem.load_table("bench", "widestr",
                   [ColumnMetadata("s", T.VARCHAR), ColumnMetadata("v", T.BIGINT)],
                   [codes, v], None, [Dictionary(vals), None])
    r = LocalQueryRunner(Session(catalog="memory", schema="bench", batch_rows=1 << 22),
                         device=device)
    r.register_catalog("memory", mem)
    return r, (vals, codes, v)


def widestr_numpy(vals, codes, v, limit: int = 10) -> list:
    """The wide-string query's answer by np.bincount over the same
    arrays: count and sum(v) per string, by count desc then string."""
    import numpy as np

    d = sorted(vals)
    cnt = np.bincount(codes, minlength=len(vals))
    tot = np.bincount(codes, weights=v, minlength=len(vals)).astype(np.int64)
    if int(v.sum()) >= 2 ** 53:  # the float sums are exact below 2^53
        raise ValueError("widestr: sum(v) too large for a float bincount")
    order = sorted((c for c in range(len(vals)) if cnt[c]), key=lambda c: (-cnt[c], d[c]))
    return [[d[c], int(cnt[c]), int(tot[c])] for c in order[:limit]]


def tagged_arrays(rows: int):
    """NEST_MEMORY's table from default_rng(11): per row 0 to 8 tags in
    [0, NEST_MEMORY_TAGS), as (python lists, flat numpy tags)."""
    import numpy as np

    rng = np.random.default_rng(11)
    lens = rng.integers(0, 9, rows)
    flat = rng.integers(0, NEST_MEMORY_TAGS, int(lens.sum()), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [flat[offs[i]:offs[i + 1]].tolist() for i in range(rows)], flat


def tagged_runner(rows: int, device: str, lists=None):
    """tagged_arrays(rows) in the port's memory connector as
    nest.tagged (id bigint, tags array(bigint)). Returns the runner and
    the flat tags."""
    import numpy as np
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.spi import ColumnMetadata
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    lists, flat = lists or tagged_arrays(rows)
    mem = create_memory_connector()
    mem.load_table("nest", "tagged", [ColumnMetadata("id", T.BIGINT),
                                      ColumnMetadata("tags", T.array_of(T.BIGINT))],
                   [np.arange(rows, dtype=np.int64), lists])
    r = LocalQueryRunner(Session(catalog="memory", schema="nest"), device=device)
    r.register_catalog("memory", mem)
    return r, flat


def tagged_numpy(flat) -> list:
    """NEST_MEMORY's answer by np.bincount."""
    import numpy as np

    cnt = np.bincount(flat, minlength=NEST_MEMORY_TAGS)
    return [[t, int(c)] for t, c in enumerate(cnt) if c]


class TimedPageSource:
    """Wraps a connector's page source and adds up the host seconds
    spent producing batches (data generation + copy to the card)."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0

    def batches(self, *args, **kwargs):
        it = self.inner.batches(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.seconds += time.perf_counter() - t0
            if batch is None:
                return
            yield batch


def scaled(v: float, scale: int) -> int:
    """A decoded decimal back to its exact scaled integer."""
    x = v * 10 ** scale
    r = round(x)
    assert abs(x - r) < 1e-3, (v, scale)
    return r


def launch_counters() -> dict:
    """{name: wrapper function carrying `launches` and `shapes`}; the
    window_rank source has three entry points (searched or fixed rank,
    bounds, run_owner)."""
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import mxu_groupby as M
    from trino_tpu_torch.ops import window_rank as W

    return {"grouped_sum": M.grouped_sum, "window_rank": W.rank, "bounds": W.bounds,
            "run_owner": W.run_owner, "take_flat": GK.take_flat,
            "take_rows_sum": GK.take_rows_sum, "take_along_lanes": GK.take_along_lanes}


def join_kernel_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def reset_kernel_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0
        fn.shapes.clear()


class Capture:
    """Wraps a module's function. `calls` counts the calls whose key
    (argument shapes) is not None and `keys` holds every such key. The
    arguments of a key's first call stay in `args` only while that key is
    the largest under one of the orders `keep` (every key's when `keep`
    is None, none when it is empty), so that a capture holds little of
    the card's memory. The bookkeeping holds a lock: a distributed query's
    tasks call from several threads."""

    def __init__(self, module, attr: str, key, keep=(lambda k: k,)):
        import threading

        self.module, self.attr, self.key, self.keep = module, attr, key, keep
        self.inner = getattr(module, attr)
        self.args: dict = {}
        self.keys: set = set()
        self.calls = 0
        self._lock = threading.Lock()

    def __enter__(self):
        def capturing(*args):
            k = self.key(*args)
            if k is not None:
                with self._lock:
                    self.calls += 1
                    self.keys.add(k)
                    if self.keep is None:
                        self.args.setdefault(k, args)
                    else:
                        best = {max(self.keys, key=order) for order in self.keep}
                        if k in best:
                            self.args.setdefault(k, args)
                        self.args = {b: self.args[b] for b in best if b in self.args}
            return self.inner(*args)

        setattr(self.module, self.attr, capturing)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)

    def largest(self, order=lambda key: key):
        """The arguments whose key is largest under `order`."""
        return max(self.args.items(), key=lambda kv: order(kv[0]))[1] if self.args else None


class LaunchTimer:
    """Wraps a module's launcher, a function that returns (go, out) where
    `go()` launches one kernel and nothing else, while the main path runs:
    CUDA events around every `go()`, read once, in `totals`. Each pair
    sits behind a spin kernel queued first, so that the card waits on the
    spin, not on the host, until the host has queued the launch and the
    end event, and the pair times the kernel alone; the launcher's own
    work (allocation, which may wait on the card) stays outside. A launch
    whose host window (spin to end event, host clock) outlasted the
    shortest spin the card measured is counted as `late`: its pair may
    hold host time. The spins add about 0.5 ms of device time a launch to
    the walls. `family` names the part of the main path that is running."""

    SPIN_CYCLES = 1_000_000  # ~0.5 ms at 1.98 GHz

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.inner = None
        self.family = None
        self.marks: list = []  # (family, spin event, start, end, host seconds)

    def __enter__(self):
        import torch

        self.inner = getattr(self.module, self.attr)

        def timed(*args):
            go, out = self.inner(*args)
            family = self.family

            def timed_go():
                spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                t0 = time.perf_counter()
                spin.record()
                torch.cuda._sleep(self.SPIN_CYCLES)
                start.record()
                go()
                end.record()
                self.marks.append((family, spin, start, end, time.perf_counter() - t0))

            return timed_go, out

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)

    def totals(self) -> dict:
        """{family: {"launches", "ms" (summed kernel time), "late",
        "host_ms_max", "spin_ms"}}."""
        import torch

        torch.cuda.synchronize()
        spin_ms = min((s.elapsed_time(b) for _, s, b, _, _ in self.marks), default=0.0)
        out: dict = {}
        for family, _, start, end, host in self.marks:
            tot = out.setdefault(family, {"launches": 0, "ms": 0.0, "late": 0,
                                          "host_ms_max": 0.0, "spin_ms": spin_ms})
            tot["launches"] += 1
            tot["ms"] += start.elapsed_time(end)
            tot["late"] += host * 1e3 >= spin_ms
            tot["host_ms_max"] = max(tot["host_ms_max"], host * 1e3)
        return out


def run_query(r, scan, name, run, sql, per_query, probes=None) -> list:
    """Runs one query and records its wall, scan seconds, rows and the
    kernel launches it caused; with `probes` (the Capture around
    sorted_run_bounds), also its non-empty probe batches."""
    import torch
    from trino_tpu_torch.ops import mxu_groupby as M
    from trino_tpu_torch.sql import local_planner as LP

    before = join_kernel_counts()
    batches_before = probes.calls if probes else 0
    shapes_before = set(M.grouped_sum.shapes)
    selected_before = LP.mxu_join_selected
    scan.seconds = 0.0
    t0 = time.perf_counter()
    res = r.execute(sql)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = join_kernel_counts()
    n = {k: after[k] - before[k] for k in after}
    batches = (probes.calls if probes else 0) - batches_before
    per_query[f"{name}_{run}"] = {
        "wall_s": wall, "scan_s": scan.seconds, "launches": n, "probe_batches": batches,
        "rows": len(res.rows),
        "grouped_sum_shapes": sorted(set(M.grouped_sum.shapes) - shapes_before),
        "mxu_join_selected": LP.mxu_join_selected - selected_before}
    log(f"[main] {name} {run}: {len(res.rows)} rows, wall_s={wall}, "
        f"scan_s={scan.seconds} (host generation + copy to the card), "
        f"rest_s={wall - scan.seconds}, probe_batches={batches}, launches={n}, "
        f"mxu_join_selected={per_query[f'{name}_{run}']['mxu_join_selected']}")
    return res.rows


TPCH_MAIN = (("q1", Q1, False), ("q6", Q6, False), ("q_mxu", Q_MXU, False), ("q3", Q3, False),
             ("q18", Q18, False), ("q16", Q16, False), ("q22", Q22, False),
             ("q_win", Q_WIN, False), ("q_mxj", Q_MXJ, True), ("q_mxj_off", Q_MXJ, False))
TPCH_RUNS = {f"{name}_cold" for name, _, _ in TPCH_MAIN}


def phase_main(results: dict) -> None:
    import torch
    from trino_tpu_torch.connectors.tpch import base_row_count
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import join as TJ
    from trino_tpu_torch.ops import mxu_groupby as M
    from trino_tpu_torch.ops import window_rank as W

    r = runner("sf1", "cuda")
    conn = r.catalogs.get("tpch")
    scan = conn.page_source = TimedPageSource(conn.page_source)
    batches = -(-base_row_count("lineitem", 1.0) // r.session.batch_rows)
    rows, per_query = {}, {}
    # keep the arguments the main path gives each kernel, to time the
    # kernels on the queries' own data afterwards
    gs = Capture(M, "_launch", lambda gid, v, live, cap: (int(gid.shape[0]), int(v.shape[0]), cap),
                 keep=None)
    bd = Capture(W, "_launch_bounds", lambda q, b: (q.numel(), int(b.shape[0]), q.element_size()),
                 keep=(lambda k: k, lambda k: (k[1], k[0])))
    ro = Capture(W, "_launch_run_owner", lambda off, n_out: (n_out, int(off.shape[0])))
    tf = Capture(GK, "_launch_flat", lambda table, idx: (
        idx.numel(), int(table.shape[0]), table.element_size()))
    # the probe batches that reach a kernel (both sides non-empty)
    probes = Capture(TJ, "sorted_run_bounds", lambda sorted_arr, q: (
        (q.numel(), int(sorted_arr.shape[0])) if q.numel() and sorted_arr.numel() else None),
        keep=())
    # every take_flat launch timed on the card, summed per family; each of
    # its kernels launched once first (CUDA loads a kernel at its first
    # launch), short and long calls, so no timed launch waits on that
    flat_timer = LaunchTimer(GK, "flat_launcher")
    flat_timer.family = "tpch"
    for table_type in (torch.int32, torch.int64):
        for idx_type in (torch.int32, torch.int64):
            for n in (1, 1 << 18):
                GK.take_flat(torch.zeros(8, dtype=table_type, device="cuda"),
                             torch.zeros(n, dtype=idx_type, device="cuda"))
    results["main_args"] = {}
    reset_kernel_counts()
    with gs, bd, ro, tf, probes, flat_timer:
        # every query runs cold once (the warm runs were dropped to keep
        # the script inside half its time limit); Q-MXJ runs with the
        # join-project route on, then its twin with the route off
        for name, sql, mxu in TPCH_MAIN:
            r.session.mxu_join_enabled = mxu
            rows[name] = run_query(r, scan, name, "cold", sql, per_query, probes)
        r.session.mxu_join_enabled = False
        # the largest flat gather of the TPC-H queries alone
        results["main_args"]["tpch"] = (None, None, tf.largest())
        flat_timer.family = "functions"
        main_functions(results, r, scan, per_query, probes)
        flat_timer.family = "tpch"
        main_holistic(r, scan, per_query)
        main_tpcds(results, per_query, probes, flat_timer)
        flat_timer.family = "widestr"
        main_widestr(results, per_query)
    results["main_launches"] = join_kernel_counts()
    flat = results["take_flat_main_path"] = flat_timer.totals()
    if sum(f["launches"] for f in flat.values()) != results["main_launches"]["take_flat"]:
        raise AssertionError(f"take_flat: the timer saw {flat}, the wrapper counted "
                             f"{results['main_launches']['take_flat']} launches")
    log(f"[main] take_flat launches and summed kernel ms per family: {flat}")
    results["main_shapes"] = sorted(M.grouped_sum.shapes, reverse=True)
    # bounds twice: the call with the most queries, and the one into the
    # largest build side (its search goes deepest)
    results["main_args"].update({
        "grouped_sum": gs.args, "bounds": bd.largest(),
        "bounds_largest_build": bd.largest(lambda k: (k[1], k[0])),
        "run_owner": ro.largest(), "take_flat": tf.largest()})
    results["main_join_shapes"] = {
        name: sorted(launch_counters()[name].shapes, reverse=True)
        for name in ("window_rank", "bounds", "run_owner", "take_flat")}
    results["main"] = per_query
    cross = run_query(r, scan, "q18_check", "cold", Q18_CHECK, per_query)
    win_check = [run_query(r, scan, "q_win_customers", "cold", Q_WIN_CUSTOMERS, per_query),
                 run_query(r, scan, "q_win_totals", "cold", Q_WIN_TOTALS, per_query)]
    for name in ("q1", "q6", "q_mxu", "q3", "q18", "q16", "q22", "q_win", "q_mxj"):
        for row in rows[name][:6]:
            log(f"[main] {name} row: {row}")
    check_main(rows, per_query, cross, batches)
    check_breadth_queries(rows, per_query, win_check, batches)
    log(f"[main] launches over the main path: {results['main_launches']}")


class RouteLog:
    """Records `attr` of every operator of class `cls` that finishes while
    it is entered: by default each HashAggregationOperator's route
    (dense, grouped_sum, sort, global); MatchRecognizeOperator's `stats`
    in phase zones."""

    def __init__(self, cls=None, attr: str = "route"):
        self.cls, self.attr = cls, attr

    def __enter__(self):
        if self.cls is None:
            from trino_tpu_torch.exec import operators as O

            self.cls = O.HashAggregationOperator
        self.routes: list = []
        self.inner = self.cls.finish

        def finish(op):
            first = not op._finishing
            out = self.inner(op)
            if first:
                self.routes.append(getattr(op, self.attr))
            return out

        self.cls.finish = finish
        return self

    def __exit__(self, *exc):
        self.cls.finish = self.inner


NEST_SF1 = (("nest_words", NEST_WORDS), ("nest_words_total", NEST_WORDS_TOTAL),
            ("nest_agg_unnest", NEST_AGG_UNNEST), ("nest_agg_check", NEST_AGG_CHECK),
            ("nest_lambda", NEST_LAMBDA), ("nest_lambda_like", NEST_LAMBDA_LIKE),
            ("nest_maps", NEST_MAPS))


def nest_queries(schema: str) -> tuple:
    """The nested queries at a scale, NEST_JOIN and its twin at its cut."""
    cut = NEST_JOIN_CUT[schema]
    return NEST_SF1 + (("nest_join", NEST_JOIN.format(cut=cut)),
                       ("nest_join_twin", NEST_JOIN_TWIN.format(cut=cut)))


def check_nested(rows: dict, per_query: dict, memory_flat) -> None:
    """The nested queries' identities (NEST_* above)."""
    words = rows["nest_words"]
    total = rows["nest_words_total"][0][0]
    if sum(c for _, c in words) != total:
        raise AssertionError(f"nest_words: counts sum to {sum(c for _, c in words)}, "
                             f"not sum(cardinality(split)) = {total}")
    if rows["nest_agg_unnest"] != rows["nest_agg_check"]:
        raise AssertionError(f"nest_agg_unnest {rows['nest_agg_unnest']} != count(*), "
                             f"sum(o_orderkey), max orders a customer "
                             f"{rows['nest_agg_check']}")
    long_words, n_parts, special = rows["nest_lambda"][0]
    want = sum(c for w, c in words if len(w) > 5)
    if (long_words, n_parts, special) != (want, total, rows["nest_lambda_like"][0][0]):
        raise AssertionError(f"nest_lambda {rows['nest_lambda']}: want {want} long "
                             f"words, {total} parts, {rows['nest_lambda_like']} 'special'")
    for prio, hist, agg, n in rows["nest_maps"]:
        if sum(hist.values()) != n or set(agg) != set(hist):
            raise AssertionError(f"nest_maps {prio}: histogram {hist} against count {n}, "
                                 f"map_agg keys {sorted(agg)}")
    if rows["nest_join"] != rows["nest_join_twin"] or not rows["nest_join"]:
        raise AssertionError("nest_join: the join's filtered arrays differ from its twin's")
    if per_query["nest_join_cold"]["launches"]["bounds"] <= 0:
        raise AssertionError("nest_join launched no bounds")
    if rows["nest_memory"] != tagged_numpy(memory_flat):
        raise AssertionError("nest_memory: UNNEST ... GROUP BY tag differs from numpy")
    for q in ("nest_words", "nest_agg_unnest", "nest_memory"):
        n = per_query[f"{q}_cold"]["launches"]
        if n["run_owner"] <= 0 or n["take_flat"] <= 0:
            raise AssertionError(f"{q}: UNNEST launched run_owner {n['run_owner']}, "
                                 f"take_flat {n['take_flat']} times")


def phase_nested(results: dict) -> None:
    """The nested queries at sf1 (memory table: NEST_MEMORY_ROWS rows),
    each cold once, held to their identities; the kernels UNNEST and the
    join launch, counted over this phase alone and timed on their largest
    arguments here; then the card against the CPU on every nested SQL
    case at tiny and the nested queries at tiny and sf0.1."""
    import torch
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import window_rank as W

    r = runner("sf1", "cuda")
    conn = r.catalogs.get("tpch")
    scan = conn.page_source = TimedPageSource(conn.page_source)
    lists, flat = tagged_arrays(NEST_MEMORY_ROWS)
    mem, _ = tagged_runner(NEST_MEMORY_ROWS, "cuda", (lists, flat))
    mem_conn = mem.catalogs.get("memory")
    mem_scan = mem_conn.page_source = TimedPageSource(mem_conn.page_source)
    rows, per_query = {}, {}
    ro = Capture(W, "_launch_run_owner", lambda off, n_out: (n_out, int(off.shape[0])))
    tf = Capture(GK, "_launch_flat", lambda table, idx: (
        idx.numel(), int(table.shape[0]), table.element_size()))
    reset_kernel_counts()
    with ro, tf, RouteLog() as routes:
        for name, sql in nest_queries("sf1"):
            before = len(routes.routes)
            rows[name] = run_query(r, scan, name, "cold", sql, per_query)
            per_query[f"{name}_cold"]["group_by_routes"] = routes.routes[before:]
        before = len(routes.routes)
        rows["nest_memory"] = run_query(mem, mem_scan, "nest_memory", "cold", NEST_MEMORY,
                                        per_query)
        per_query["nest_memory_cold"]["group_by_routes"] = routes.routes[before:]
    results["nested_launches"] = join_kernel_counts()
    results["nested"] = per_query
    results.setdefault("main_args", {}).update(
        {"run_owner_nested": ro.largest(), "take_flat_nested": tf.largest()})
    width = max(len(a) for _, _, a in rows["nest_join_twin"]) if rows["nest_join_twin"] else 0
    parts = r.execute("select max(cardinality(split(o_comment, ' '))),"
                      " count(*) from orders").rows[0]
    total = rows["nest_words_total"][0][0]
    log(f"[nested] split's W at sf1 = {parts[0]} (flat store {parts[1]} x {parts[0]} int32); "
        f"word count routes {per_query['nest_words_cold']['group_by_routes']}, "
        f"{len(rows['nest_words'])} words, {total} in all, top {rows['nest_words'][:3]}; "
        f"longest filtered array in nest_join {width}")
    results["nested_split_width"], results["nested_words"] = parts[0], total
    check_nested(rows, per_query, flat)
    for k in ("run_owner", "take_flat", "bounds"):
        if results["nested_launches"][k] <= 0:
            raise AssertionError(f"phase nested never launched {k}")
    log(f"[nested] identities hold; launches over the phase: {results['nested_launches']}")
    del rows, mem, lists
    torch.cuda.empty_cache()
    # the card against the CPU: every nested SQL case at tiny, the
    # nested queries at tiny and sf0.1, NEST_MEMORY at 2^16 rows
    for schema in nest_tables():
        gpu, cpu = nest_runner(schema, "cuda"), nest_runner(schema, "cpu")
        for sch, sql in NEST_MEMORY_SQL:
            if sch == schema and not rows_close(gpu.execute(sql).rows, cpu.execute(sql).rows):
                raise AssertionError(f"nested {schema}: card and CPU differ on {sql}")
    log(f"[parity] nested SQL cases: {len(NEST_MEMORY_SQL)} queries, card == CPU")
    for schema in ("tiny", "sf0.1"):
        gpu, cpu = runner(schema, "cuda"), runner(schema, "cpu")
        for name, sql in nest_queries(schema):
            a, b = gpu.execute(sql).rows, cpu.execute(sql).rows
            if a != b:
                raise AssertionError(f"{name}: card and CPU rows differ at {schema}")
            log(f"[parity] {name} {schema}: {len(a)} rows, card == CPU")
    small = tagged_arrays(1 << 16)
    a = tagged_runner(1 << 16, "cuda", small)[0].execute(NEST_MEMORY).rows
    b = tagged_runner(1 << 16, "cpu", small)[0].execute(NEST_MEMORY).rows
    if a != b or a != tagged_numpy(small[1]):
        raise AssertionError("nest_memory: card, CPU and numpy differ at 2^16 rows")
    log(f"[parity] nest_memory 2^16 rows: {len(a)} tags, card == CPU == numpy")


def zone_rowwise(results: dict) -> None:
    """offset_millis_rowwise on one orders batch of random instants
    (1900-2037) and zone ids over the whole registry: CUDA events around
    one cold call and 20 warm calls, the card's peak memory above what
    was allocated before the call, and the answer against the CPU's."""
    import torch
    from trino_tpu_torch.ops import tz as TZ

    n = TZ_ROWWISE_ROWS
    n_ids = TZ._NAMED_BASE + len(TZ._named_zones())
    g = torch.Generator().manual_seed(0)
    lo, hi = -2_208_988_800_000, 2_145_916_800_000  # 1900-01-01 .. 2038-01-01
    inst = lo + (torch.rand(n, generator=g, dtype=torch.float64) * (hi - lo)).to(torch.int64)
    zids = torch.randint(0, n_ids, (n,), generator=g, dtype=torch.int32)
    d_inst, d_zids = inst.cuda(), zids.cuda()
    TZ.offset_millis_rowwise(d_inst[:1], d_zids[:1])  # the flat table, placed once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = TZ.offset_millis_rowwise(d_inst, d_zids)
    end.record()
    torch.cuda.synchronize()
    cold_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - base
    start.record()
    for _ in range(20):
        TZ.offset_millis_rowwise(d_inst, d_zids)
    end.record()
    torch.cuda.synchronize()
    warm_ms = start.elapsed_time(end) / 20
    if not torch.equal(out.cpu(), TZ.offset_millis_rowwise(inst, zids)):
        raise AssertionError("offset_millis_rowwise: the card and the CPU differ")
    flat_t = TZ._zone_flat()[0]
    width = int(TZ._zone_flat()[3].max())
    # the reference's formulation gathers a transitions row and an
    # offsets row per input row, then compares the first with the instant
    matrix = n * (width * 8 + (width + 1) * 8 + width)
    rec = {"n": n, "zone_ids": n_ids, "transitions": int(flat_t.shape[0]),
           "longest_zone": width, "cold_ms": cold_ms, "warm_ms": warm_ms,
           "peak_bytes": peak, "peak_bytes_per_row": peak / n,
           "matrix_rows_bytes": matrix, "output_bytes": n * 8}
    results["zones_rowwise"] = rec
    log(f"[zones] offset_millis_rowwise n={n} over {n_ids} ids ({rec['transitions']} "
        f"transitions, longest zone {width}): cold_ms={cold_ms} warm_ms={warm_ms} "
        f"peak above the inputs {peak} bytes ({peak / n} a row; the reference's per-row "
        f"matrix rows would take {matrix} bytes); card == CPU")


def phase_zones(results: dict) -> None:
    """TIMESTAMP WITH TIME ZONE and MATCH_RECOGNIZE at sf1, each query
    cold once with its scan_s, rest_s and launches, held to their
    identities; MR_ORDERS, MR_NEXT and TZ_TRUNC also against the CPU at
    sf1; then offset_millis_rowwise alone on one batch."""
    import zoneinfo

    import torch
    from trino_tpu_torch.connectors.tpch import base_row_count
    from trino_tpu_torch.exec import match_recognize as MR
    from trino_tpu_torch.ops import join as TJ

    t_phase = time.perf_counter()
    n_zones = len(zoneinfo.available_timezones())
    results["zones_tzdata"] = {"named_zones": n_zones, "tzpath": list(zoneinfo.TZPATH)}
    log(f"[zones] zoneinfo.available_timezones() holds {n_zones} zones "
        f"(TZPATH {list(zoneinfo.TZPATH)})")
    if n_zones == 0:
        raise AssertionError("no TZif database on this machine: the named zones cannot run")
    r = zones_runner("sf1", "cuda")
    conn = r.catalogs.get("tpch")
    scan = conn.page_source = TimedPageSource(conn.page_source)
    rows, per_query = {}, {}
    probes = Capture(TJ, "sorted_run_bounds", lambda sorted_arr, q: (
        (q.numel(), int(sorted_arr.shape[0])) if q.numel() and sorted_arr.numel() else None),
        keep=())
    reset_kernel_counts()
    with probes, RouteLog(MR.MatchRecognizeOperator, "stats") as patterns:
        for name, sql in ZONE_QUERIES:
            before = len(patterns.routes)
            rows[name] = run_query(r, scan, name, "cold", sql, per_query, probes)
            for st in patterns.routes[before:]:
                per_query[f"{name}_cold"]["match_recognize"] = st
                log(f"[zones] {name}: {st['rows']} rows in, {st['matches']} matches; "
                    f"device_s={st['device_s']} (consolidate, sort, DEFINEs, masks to the "
                    f"host) automaton_s={st['automaton_s']} output_s={st['output_s']}")
    results["zones_launches"] = join_kernel_counts()
    results["zones"] = per_query
    n_orders = base_row_count("orders", 1.0)
    log(f"[zones] tz_dst {rows['tz_dst']}; tz_mixed {rows['tz_mixed']}; tz_trunc "
        f"{len(rows['tz_trunc'])} days; tz_join {rows['tz_join']}; mr_all {rows['mr_all']}; "
        f"mr_orders {len(rows['mr_orders'])} matches, first {rows['mr_orders'][:2]}")
    check_zones(rows, orders_dates("sf1"), n_orders)
    check_patterns(rows)
    join = per_query["tz_join_cold"]
    if not 0 < join["launches"]["bounds"] == join["probe_batches"]:
        raise AssertionError(f"tz_join: bounds launched {join['launches']['bounds']} times "
                             f"over {join['probe_batches']} probe batches")
    log(f"[zones] identities hold; launches over the phase: {results['zones_launches']}")
    del r
    torch.cuda.empty_cache()
    cpu = zones_runner("sf1", "cpu")
    for name in ("tz_trunc", "mr_orders", "mr_next"):
        t0 = time.perf_counter()
        got = cpu.execute(dict(ZONE_QUERIES)[name]).rows
        if got != rows[name]:
            raise AssertionError(f"{name}: card and CPU rows differ at sf1")
        log(f"[zones] {name} sf1: {len(got)} rows, card == CPU (CPU run "
            f"{time.perf_counter() - t0} s)")
    zone_rowwise(results)
    log(f"[zones] phase took {time.perf_counter() - t_phase} s")


def write_runner(schema: str, device: str):
    """A tpch runner at `schema` with an empty memory catalog `w`."""
    from trino_tpu_torch.connectors.memory import create_memory_connector

    r = runner(schema, device)
    r.register_catalog("w", create_memory_connector())
    return r


def script_runner(script: dict, device: str):
    """The port's runner for one WRITE_SCRIPTS entry, its setup run: a
    memory catalog and tpch (tiny)."""
    from trino_tpu_torch.connectors.memory import create_memory_connector
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import LocalQueryRunner, Session

    r = LocalQueryRunner(Session(catalog=script["catalog"], schema=script["schema"],
                                 **script["session"]), device=device)
    r.register_catalog("memory", create_memory_connector())
    r.register_catalog("tpch", create_tpch_connector())
    for sql in WRITE_SETUPS.get(script["setup"], ()):
        r.execute(sql)
    return r


class SinkTimer:
    """Adds up the host seconds spent in the memory connector's page sink
    (each batch's live rows copied from the card to the host, the
    dictionary remap and the append), the rewrites' replace_rows too."""

    def __enter__(self):
        from trino_tpu_torch.connectors import memory as MEM

        self.cls, self.inner = MEM.MemoryPageSink, MEM.MemoryPageSink.append
        self.seconds, self.calls = 0.0, 0

        def append(sink, batch):
            t0 = time.perf_counter()
            try:
                return self.inner(sink, batch)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        self.cls.append = append
        return self

    def __exit__(self, *exc):
        self.cls.append = self.inner


def tensor_bytes(obj, seen=None) -> int:
    """Bytes of the distinct tensors reachable from a batch, a column or
    a list of them."""
    import dataclasses

    import torch

    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        if obj.data_ptr() in seen:
            return 0
        seen.add(obj.data_ptr())
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(x, seen) for x in obj)
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name), seen) for f in dataclasses.fields(obj))
    return 0


def device_cache_bytes(conn) -> int:
    """Card bytes of the batches the memory connector keeps per table."""
    return sum(tensor_bytes(list(t.device_cache.values())) for t in conn.store.tables.values())


def write_step(r, scans, sink, name, sql, steps, probes):
    """Runs one statement cold and logs its three lines: wall, scan_s and
    sink_s; its kernel launches; the card's peak memory. Also the card
    bytes of the memory catalog's cached batches before and after it (a
    write drops the older versions')."""
    import torch

    cache_before = device_cache_bytes(r.catalogs.get("w"))
    before = join_kernel_counts()
    batches_before = probes.calls
    for s in scans:
        s.seconds = 0.0
    sink.seconds = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    error = None
    try:
        res = r.execute(sql)
    except Exception as e:  # noqa: BLE001 - the caller checks what was expected
        res, error = None, e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = join_kernel_counts()
    rec = steps[name] = {
        "wall_s": wall, "scan_s": sum(s.seconds for s in scans), "sink_s": sink.seconds,
        "launches": {k: after[k] - before[k] for k in after},
        "probe_batches": probes.calls - batches_before,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "cache_bytes": [cache_before, device_cache_bytes(r.catalogs.get("w"))],
        "error": None if error is None else f"{type(error).__name__}: {error}"}
    log(f"[write] {name}: wall_s={wall} scan_s={rec['scan_s']} sink_s={rec['sink_s']} "
        f"(host time in the page sink, the copy from the card included) "
        f"rows={None if res is None else res.rows[:4]} error={rec['error']}")
    log(f"[write] {name}: launches={rec['launches']} probe_batches={rec['probe_batches']}")
    log(f"[write] {name}: peak card memory {rec['peak_bytes']} bytes; cached batches "
        f"{rec['cache_bytes'][0]} bytes before, {rec['cache_bytes'][1]} after")
    return res, error


def write_identities(r, step, n: int) -> None:
    """Phase write's statements in order on runner `r` (a tpch runner
    with the memory catalog `w`), each through `step(name, sql)`, which
    returns (rows, error), held to its identity; `n` is the orders'
    row count. tests/test_torch_write.py runs this at tiny."""
    from trino_tpu_torch.transaction import TransactionError

    def run(name, sql):
        rows, error = step(name, sql)
        if error is not None:
            raise error
        return rows

    def value(sql):
        return r.execute(sql).rows

    def check(ok, what):
        if not ok:
            raise AssertionError(f"phase write: {what}")

    got = run("ctas", WRITE_CTAS)
    check(got == [[n]], f"CTAS wrote {got}, orders holds {n}")
    mine = run("ctas_check", WRITE_CTAS_CHECK.format(t="w.s.orders"))
    source = value(WRITE_CTAS_CHECK.format(t="orders"))
    check(rows_close(mine, source), f"the written orders {mine} against tpch's {source}")
    run("cust_create", WRITE_CUST)
    got = run("cust_insert", WRITE_CUST_INSERT)
    keys = value(WRITE_CUSTKEYS)
    check(got == keys and value(WRITE_CUST_CHECK) == [[keys[0][0], n]],
          f"INSERT ... GROUP BY wrote {got} of {keys} customers")
    got = run("update", WRITE_UPDATE)
    old = value(WRITE_UPDATE_SOURCE)
    check(got == old and value(WRITE_UPDATE_CHECK) == old,
          f"UPDATE changed {got} rows, {old} match")
    deleted = run("delete", WRITE_DELETE)[0][0]
    check(value(WRITE_COUNT) == [[n - deleted]], f"DELETE removed {deleted} rows")
    (q, q_low), = value(WRITE_MERGE_SOURCE)
    got = run("merge", WRITE_MERGE)
    final = n - deleted + q_low
    check(got == [[q]] and value(WRITE_COUNT) == [[final]],
          f"MERGE touched {got} rows of {q} ({q_low} re-inserted)")
    n_cust = keys[0][0]
    for i, (sql, times) in enumerate(WRITE_TXN):
        run(f"txn{i}", sql)
        check(value(WRITE_CUST_CHECK)[0][0] == times * n_cust,
              f"after {sql!r} w.s.cust does not hold {times} x {n_cust} rows")
    run("read_only_start", WRITE_READ_ONLY[0])
    _, error = step("read_only_insert", WRITE_READ_ONLY[1])
    check(isinstance(error, TransactionError), f"a read-only write gave {error!r}")
    run("read_only_rollback", WRITE_READ_ONLY[2])
    groups = run("group", WRITE_GROUP)
    check(sum(g[3] for g in groups) == final
          and sum(g[3] for g in groups if g[2]) == q - q_low,
          f"the GROUP BY's counts {groups} against {final} rows")
    for i, sql in enumerate(WRITE_DROPS):
        run(f"drop{i}", sql)
    _, error = step("select_dropped", WRITE_COUNT)
    check(error is not None, "a SELECT of the dropped table answered")


def phase_write(results: dict) -> None:
    """The write side at sf1 on the card, each statement cold once, held
    to its identity (write_identities): CTAS of orders, INSERT ... SELECT
    with a GROUP BY, UPDATE, DELETE, MERGE, the transactions, a GROUP BY
    over the written table and DROP. MERGE launches bounds once per probe
    batch and take_flat, the GROUP BY grouped_sum. Launches count over
    this phase alone (`write_launches`)."""
    import torch
    from trino_tpu_torch.connectors.tpch import base_row_count
    from trino_tpu_torch.ops import join as TJ

    t_phase = time.perf_counter()
    r = write_runner("sf1", "cuda")
    tpch, w = r.catalogs.get("tpch"), r.catalogs.get("w")
    scans = [TimedPageSource(tpch.page_source), TimedPageSource(w.page_source)]
    tpch.page_source, w.page_source = scans
    probes = Capture(TJ, "sorted_run_bounds", lambda sorted_arr, q: (
        (q.numel(), int(sorted_arr.shape[0])) if q.numel() and sorted_arr.numel() else None),
        keep=())
    steps: dict = {}
    reset_kernel_counts()
    with probes, SinkTimer() as sink:
        def step(name, sql):
            res, error = write_step(r, scans, sink, name, sql, steps, probes)
            return (None if res is None else res.rows), error

        write_identities(r, step, base_row_count("orders", 1.0))
    merge, group = steps["merge"], steps["group"]
    if not 0 < merge["probe_batches"] <= merge["launches"]["bounds"]:
        raise AssertionError(f"MERGE launched bounds {merge['launches']['bounds']} times "
                             f"over {merge['probe_batches']} probe batches")
    if merge["launches"]["take_flat"] <= 0:
        raise AssertionError("MERGE never launched take_flat")
    if group["launches"]["grouped_sum"] <= 0:
        raise AssertionError("the GROUP BY over w.s.orders never launched grouped_sum")
    results["write_launches"] = join_kernel_counts()
    results["write"] = steps
    writes = ("update", "delete", "merge", "txn5")
    results["write_cache_bytes"] = {k: steps[k]["cache_bytes"] for k in writes}
    log(f"[write] cached batches of the written tables before and after each write "
        f"(bytes; an older version's are dropped at the write): "
        f"{results['write_cache_bytes']}")
    log(f"[write] identities hold; launches over the phase: {results['write_launches']}")
    log(f"[write] phase took {time.perf_counter() - t_phase} s")
    del r
    torch.cuda.empty_cache()


# ---- phase statements: PREPARE/EXECUTE, the plan cache, EXPLAIN, SHOW,
# SET SESSION and access control ---------------------------------------------

# a bounded GROUP BY over orders with a date parameter: 4 x 6 x 3 slots
# with the NULL groups, over the dense route's 64, the grouped_sum route
ST_GROUP = """select o_orderstatus, o_orderpriority, o_totalprice > 200000 big, count(*),
sum(o_totalprice) from orders where o_orderdate < ? group by 1, 2, 3 order by 1, 2, 3"""
ST_GROUP_COUNT = "select count(*) from orders where o_orderdate < {d}"
ST_DATES = ("date '1995-01-01'", "date '1997-06-30'")
# orders joined to customer with a parameter on c_mktsegment (bounds once
# per probe batch, take_flat)
ST_JOIN = """select c_nationkey, count(*), sum(o_totalprice) from orders join customer
on o_custkey = c_custkey where c_mktsegment = ? group by 1 order by 1"""
ST_SEGMENT = "'BUILDING'"
# alice may read every table but customer; admin may read everything
ST_RULES = [{"user": "alice", "table": "customer", "privileges": []},
            {"user": "alice", "privileges": ["SELECT"]},
            {"user": "admin", "privileges": ["OWNERSHIP"]}]
ST_RECENT = """create table w.s.recent as select o_orderkey, o_orderstatus, o_orderpriority,
o_totalprice from orders where o_orderdate >= date '1998-01-01'"""
ST_RECENT_GROUP = """select o_orderstatus, o_orderpriority, count(*) from w.s.recent
where o_totalprice > ? group by 1, 2 order by 1, 2"""
ST_RECENT_INSERT = """insert into w.s.recent select o_orderkey, o_orderstatus,
o_orderpriority, o_totalprice from orders
where o_orderdate >= date '1997-12-01' and o_orderdate < date '1998-01-01'"""
ST_PRICE = "100000"
ST_SHOWS = ("show session", "show schemas", "show tables", "show columns from orders",
            "show functions")


class PlanTimer:
    """Notes the host clock when a runner's `_plan` returns: the end of
    parse, analysis and planning, or of the cache lookup on a hit."""

    def __init__(self, r):
        self.at = None
        inner = r._plan

        def timed(*args, **kwargs):
            out = inner(*args, **kwargs)
            if self.at is None:
                self.at = time.perf_counter()
            return out

        r._plan = timed


def statement_identities(schema: str, device: str, log, probes=None) -> dict:
    """Phase statements' steps at `schema` on `device`, each held to its
    identity; returns {step: record} with its rows (or error), wall_s,
    plan_s (parse to a physical plan, or to the cache lookup on a hit;
    None where no query was planned), run_s, the plan cache's hits and
    misses, and the kernel launches (counted only on the card).
    tests/test_torch_statements.py runs this at tiny on the CPU."""
    import torch
    from trino_tpu_torch.engine import LocalQueryRunner, Session
    from trino_tpu_torch.security import AccessDeniedError, FileBasedAccessControl, Identity

    r = write_runner(schema, device)
    secure = LocalQueryRunner(Session(catalog="tpch", schema=schema, user="alice"),
                              access_control=FileBasedAccessControl(ST_RULES), device=device)
    secure.register_catalog("tpch", r.catalogs.get("tpch"))
    timers = {id(x): PlanTimer(x) for x in (r, secure)}
    steps: dict = {}

    def step(name, sql, on=r, **kw):
        cache, timer = on._plan_cache, timers[id(on)]
        hits, misses = cache.hits, cache.misses
        before = join_kernel_counts()
        batches = probes.calls if probes else 0
        timer.at = None
        error = res = None
        t0 = time.perf_counter()
        try:
            res = on.execute(sql, **kw)
        except Exception as e:  # noqa: BLE001 - the identities check which
            error = e
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        plan_s = None if timer.at is None else timer.at - t0
        if sql.startswith("explain"):
            plan_s = wall  # EXPLAIN plans and runs nothing
        after = join_kernel_counts()
        rec = steps[name] = {
            "rows": None if res is None else res.rows, "wall_s": wall, "plan_s": plan_s,
            "run_s": wall - (plan_s or 0.0), "hits": cache.hits - hits,
            "misses": cache.misses - misses,
            "launches": {k: after[k] - before[k] for k in after},
            "probe_batches": (probes.calls if probes else 0) - batches,
            "error": None if error is None else f"{type(error).__name__}: {error}"}
        log(f"[statements] {schema} {name}: plan_s={plan_s} run_s={rec['run_s']} "
            f"wall_s={wall} hits={rec['hits']} misses={rec['misses']} "
            f"probe_batches={rec['probe_batches']} launches={rec['launches']} "
            f"rows={None if res is None else str(res.rows[:3])[:160]} error={rec['error']}")
        return res, error

    def run(name, sql, on=r, **kw):
        res, error = step(name, sql, on, **kw)
        if error is not None:
            raise error
        return res.rows

    def check(ok, what):
        if not ok:
            raise AssertionError(f"phase statements {schema}: {what}")

    def cached(name, hit):
        got = (steps[name]["hits"], steps[name]["misses"])
        check(got == ((1, 0) if hit else (0, 1)),
              f"{name}: plan cache hits, misses {got}, expected a {'hit' if hit else 'miss'}")

    # 1-2: the bounded GROUP BY, prepared; one date twice, then another
    run("group_prepare", f"prepare g from {ST_GROUP}")
    d1, d2 = ST_DATES
    first = run("group_miss", f"execute g using {d1}")
    again = run("group_hit", f"execute g using {d1}")
    cached("group_miss", False)
    cached("group_hit", True)
    total = r.execute(ST_GROUP_COUNT.format(d=d1)).rows[0][0]
    check(first == again and sum(row[3] for row in first) == total,
          f"the prepared GROUP BY's counts against count(*) {total}")
    run("group_other", f"execute g using {d2}")
    cached("group_other", False)
    # 3-4: the join, prepared; then without dynamic filtering
    run("join_prepare", f"prepare j from {ST_JOIN}")
    twin = r.execute(ST_JOIN.replace("?", ST_SEGMENT)).rows
    rows = [run("join_miss", f"execute j using {ST_SEGMENT}"),
            run("join_hit", f"execute j using {ST_SEGMENT}")]
    cached("join_miss", False)
    cached("join_hit", True)
    run("set_no_dynamic_filtering", "set session enable_dynamic_filtering = false")
    rows.append(run("join_no_dynamic_filtering", f"execute j using {ST_SEGMENT}"))
    cached("join_no_dynamic_filtering", False)
    check(all(rows_close(x, twin) for x in rows) and twin,
          "the prepared join's rows against the unprepared text's")
    # 5-6: EXPLAIN and the SHOWs (the caller holds them to the CPU's)
    run("explain_q3", f"explain {Q3}")
    for i, sql in enumerate(ST_SHOWS):
        run(f"show{i}", sql)
    # 7: access control denies customer to alice, on a miss and on a hit
    run("secure_prepare_join", f"prepare j from {ST_JOIN}", secure)
    for name, kw in (("secure_join_miss", {}),
                     ("secure_join_admin", {"identity": Identity("admin")}),
                     ("secure_join_hit", {})):
        res, error = step(name, f"execute j using {ST_SEGMENT}", secure, **kw)
        if name == "secure_join_admin":
            check(error is None and rows_close(res.rows, twin), "admin's join")
        else:
            check(isinstance(error, AccessDeniedError), f"{name} gave {error!r}")
    cached("secure_join_miss", False)
    cached("secure_join_admin", False)
    cached("secure_join_hit", True)
    run("secure_prepare_group", f"prepare g from {ST_GROUP}", secure)
    check(run("secure_group", f"execute g using {d1}", secure) == first,
          "alice's GROUP BY over orders")
    # 8: a memory table: a hit, a miss after its INSERT, and the tpch
    # plan still cached (the invalidation is table-granular)
    run("ctas", ST_RECENT)
    run("recent_prepare", f"prepare m from {ST_RECENT_GROUP}")
    before = run("recent_miss", f"execute m using {ST_PRICE}")
    check(run("recent_hit", f"execute m using {ST_PRICE}") == before, "the memory table's hit")
    cached("recent_miss", False)
    cached("recent_hit", True)
    inserted = run("recent_insert", ST_RECENT_INSERT)[0][0]
    after = run("recent_after_insert", f"execute m using {ST_PRICE}")
    cached("recent_after_insert", False)
    want = r.execute(ST_RECENT_GROUP.replace("?", ST_PRICE)).rows
    check(after == want and inserted > 0 and sum(x[2] for x in after) > sum(x[2] for x in before),
          f"after inserting {inserted} rows the prepared GROUP BY reads {after}")
    check(rows_close(run("join_after_insert", f"execute j using {ST_SEGMENT}"), twin),
          "the tpch plan's rows")
    cached("join_after_insert", True)
    # 9: every rule application validated, and double planning, against
    # EXPLAIN once more under 'passes' (the first one paid the first
    # reads of lineitem's statistics)
    run("explain_q3_warm", f"explain {Q3}")
    run("set_rules", "set session plan_validation = 'rules'")
    run("explain_q3_rules", f"explain {Q3}")
    check(steps["explain_q3_rules"]["rows"] == steps["explain_q3"]["rows"],
          "EXPLAIN under plan_validation = 'rules' differs")
    return steps


def phase_statements(results: dict) -> None:
    """The statement surface at sf1 on the card (statement_identities),
    each step's plan_s, run_s, plan-cache hits and misses and launches
    printed. A cache hit launches the same kernels as its miss and gives
    the same rows: grouped_sum for the GROUP BY, bounds once per probe
    batch and take_flat for the join (run_owner where a build key
    repeats, as many times). EXPLAIN of Q3 and the SHOWs equal the CPU
    runner's. Launches count over this phase alone
    (`statements_launches`)."""
    import torch
    from trino_tpu_torch.ops import join as TJ

    t_phase = time.perf_counter()
    probes = Capture(TJ, "sorted_run_bounds", lambda sorted_arr, q: (
        (q.numel(), int(sorted_arr.shape[0])) if q.numel() and sorted_arr.numel() else None),
        keep=())
    reset_kernel_counts()
    with probes:
        steps = statement_identities("sf1", "cuda", log, probes)
    results["statements_launches"] = join_kernel_counts()
    for miss, hit in (("group_miss", "group_hit"), ("join_miss", "join_hit"),
                      ("recent_miss", "recent_hit")):
        if steps[miss]["launches"] != steps[hit]["launches"]:
            raise AssertionError(f"{hit} launched {steps[hit]['launches']}, its miss "
                                 f"{steps[miss]['launches']}")
    for name in ("group_miss", "group_hit", "group_other", "secure_group"):
        if steps[name]["launches"]["grouped_sum"] <= 0:
            raise AssertionError(f"{name} never launched grouped_sum")
    for name in ("join_miss", "join_hit", "join_no_dynamic_filtering", "secure_join_admin",
                 "join_after_insert"):
        run = steps[name]
        if not 0 < run["launches"]["bounds"] == run["probe_batches"] \
                or run["launches"]["take_flat"] <= 0:
            raise AssertionError(f"{name}: bounds {run['launches']['bounds']} over "
                                 f"{run['probe_batches']} probe batches, take_flat "
                                 f"{run['launches']['take_flat']}")
    # EXPLAIN and the SHOWs against a CPU runner in the same session state
    cpu = write_runner("sf1", "cpu")
    cpu.execute("set session enable_dynamic_filtering = false")
    for i, sql in enumerate(ST_SHOWS):
        if cpu.execute(sql).rows != steps[f"show{i}"]["rows"]:
            raise AssertionError(f"{sql}: the card's runner and the CPU's differ")
    if cpu.execute(f"explain {Q3}").rows != steps["explain_q3"]["rows"]:
        raise AssertionError("EXPLAIN of Q3: the card's runner and the CPU's differ")
    results["statements"] = {k: {f: v for f, v in rec.items() if f != "rows"}
                             for k, rec in steps.items()}
    log(f"[statements] plan_s of EXPLAIN Q3: {steps['explain_q3']['plan_s']} s first and "
        f"{steps['explain_q3_warm']['plan_s']} s again under plan_validation 'passes', "
        f"{steps['explain_q3_rules']['plan_s']} s under 'rules'")
    log(f"[statements] identities hold; launches over the phase: "
        f"{results['statements_launches']}")
    log(f"[statements] phase took {time.perf_counter() - t_phase} s")
    torch.cuda.empty_cache()


def parity_statements() -> None:
    """The card against the CPU: phase statements' steps at tiny and
    sf0.1, equal rows (or the same error) step by step, and
    CHOICE_SCRIPT at tiny."""
    for schema in ("tiny", "sf0.1"):
        t0 = time.perf_counter()
        gpu, cpu = (statement_identities(schema, d, lambda msg: None)
                    for d in ("cuda", "cpu"))
        for name, rec in gpu.items():
            if not (rows_close(rec["rows"], cpu[name]["rows"]) if rec["rows"] is not None
                    else rec["error"] == cpu[name]["error"]):
                raise AssertionError(f"statements {name}: card and CPU differ at {schema}")
        log(f"[parity] statements {schema}: {len(gpu)} steps, card == CPU "
            f"({time.perf_counter() - t0} s)")
    t0 = time.perf_counter()
    same_writes(script_runner(CHOICE_SCRIPT, "cuda"), script_runner(CHOICE_SCRIPT, "cpu"),
                CHOICE_SCRIPT["sql"], "choice script", "memory")
    log(f"[parity] CASE over nested and zoned values and UPDATE ... WHERE over them: "
        f"{len(CHOICE_SCRIPT['sql'])} statements at tiny, card == CPU "
        f"({time.perf_counter() - t0} s)")


# ---- phase files: CSV and Parquet tables, the file connector and blackhole --

FILES_CTAS = (("ctas_orders", "create table pq.s.orders as select * from orders", "orders"),
              ("ctas_customer", "create table pq.s.customer as select * from customer",
               "customer"),
              ("ctas_customer_csv", "create table csv.s.customer as select * from customer",
               "customer"))
FILES_TOTALS = "select count(*), sum(o_totalprice) from {t}"
# row-group pruning: o_orderkey ascends through the written orders, so
# one of its 65,536-row groups holds every key below 60,000
FILES_PRUNED = FILES_TOTALS + " where o_orderkey < 60000"
# a join whose build side (63 customers) folds into the file probe's
# splits as an IN-list dynamic filter
FILES_FAULT = """select count(*), sum(o.o_totalprice) from {o} o join {c} c
on o.o_custkey = c.c_custkey where c.c_custkey < 64"""
FILES_INSERT = "insert into pq.s.orders select * from {t} where o_orderkey % 100 = 1"
FILES_BLACKHOLE = "create table bh.default.customer as select * from customer"


class FileSinkTimer:
    """Adds up the host seconds spent in the file connector's page sinks
    (each batch's live rows copied from the card, the CSV text or the
    parquet encoding, the part's write and rename)."""

    def __enter__(self):
        from trino_tpu_torch.connectors import file as F

        self.seconds = 0.0
        self.saved = []
        for cls in (F.FilePageSink, F.ParquetPageSink):
            for attr in ("append", "finish"):
                inner = getattr(cls, attr)
                self.saved.append((cls, attr, inner))

                def timed(sink, *args, _inner=inner):
                    t0 = time.perf_counter()
                    try:
                        return _inner(sink, *args)
                    finally:
                        self.seconds += time.perf_counter() - t0

                setattr(cls, attr, timed)
        return self

    def __exit__(self, *exc):
        for cls, attr, inner in self.saved:
            setattr(cls, attr, inner)


class ParseTimer:
    """Adds up the host seconds the file connector spends parsing files
    (CSV and JSON-lines text, parquet pages: decompression, decoding,
    string dictionaries), which split enumeration reaches first."""

    def __enter__(self):
        from trino_tpu_torch.connectors import file as F

        self.seconds = 0.0
        self.saved = [(attr, getattr(F._FileStore, attr)) for attr in ("_parse", "_parse_parquet")]
        for attr, inner in self.saved:
            def timed(store, *args, _inner=inner, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _inner(store, *args, **kwargs)
                finally:
                    self.seconds += time.perf_counter() - t0

            setattr(F._FileStore, attr, timed)
        return self

    def __exit__(self, *exc):
        from trino_tpu_torch.connectors import file as F

        for attr, inner in self.saved:
            setattr(F._FileStore, attr, inner)


class FileScans(TimedPageSource):
    """TimedPageSource over a file catalog that also notes the device of
    every batch it yields and the splits that gained constraints at run
    time (the dynamic filters' build domains)."""

    def __init__(self, inner):
        super().__init__(inner)
        self.devices: set = set()
        self.folded = 0

    def batches(self, split, *args, **kwargs):
        if len(split.table.constraints) > len(split.payload):
            self.folded += 1
        for batch in super().batches(split, *args, **kwargs):
            self.devices.add(batch.live_mask().device.type)
            yield batch


def file_identities(schema: str, device: str, log, probes=None) -> dict:
    """Phase files' steps at `schema` on `device`, each held to its
    identity; returns {step: record} with its rows (or error), wall_s,
    parse_s (host time parsing files, where split enumeration first asks
    for a table), scan_s (in the file catalogs' page sources: the copies
    to the device), sink_s (in the file sinks), the parquet pages' bytes
    read (bytes_scanned), the
    kernel launches (counted only on the card) and the probe batches.
    The tables are written into a fresh temporary directory, removed at
    the end. tests/test_torch_isolation.py runs this at tiny on the CPU."""
    import shutil
    import tempfile

    import torch
    from trino_tpu_torch.connectors.blackhole import create_blackhole_connector
    from trino_tpu_torch.connectors.file import create_file_connector
    from trino_tpu_torch.connectors.tpch import base_row_count
    from trino_tpu_torch.runtime.metrics import METRICS

    sf = {"tiny": 0.01}.get(schema) or float(schema[2:])
    n_orders, n_customers = (base_row_count(t, sf) for t in ("orders", "customer"))
    root = tempfile.mkdtemp(prefix="chip_smoke_files_")
    steps: dict = {}
    parse = ParseTimer()
    try:
        parse.__enter__()
        r = runner(schema, device)
        pq_root, csv_root = os.path.join(root, "pq"), os.path.join(root, "csv")
        r.register_catalog("pq", create_file_connector(pq_root, file_format="parquet"))
        r.register_catalog("csv", create_file_connector(csv_root))
        r.register_catalog("bh", create_blackhole_connector())
        scans = {}
        for name in ("pq", "csv"):
            conn = r.catalogs.get(name)
            scans[name] = conn.page_source = FileScans(conn.page_source)

        def step(name, sql, sink=None):
            before = join_kernel_counts()
            batches = probes.calls if probes else 0
            for x in scans.values():
                x.seconds = 0.0
            sink_before = sink.seconds if sink else 0.0
            parse_before = parse.seconds
            b0 = METRICS.counter("bytes_scanned")
            error = res = None
            t0 = time.perf_counter()
            try:
                res = r.execute(sql)
            except Exception as e:  # noqa: BLE001 - the identities check which
                error = e
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = join_kernel_counts()
            rec = steps[name] = {
                "rows": None if res is None else res.rows, "wall_s": wall,
                "parse_s": parse.seconds - parse_before,
                "scan_s": sum(x.seconds for x in scans.values()),
                "sink_s": (sink.seconds - sink_before) if sink else 0.0,
                "bytes_scanned": METRICS.counter("bytes_scanned") - b0,
                "launches": {k: after[k] - before[k] for k in after},
                "probe_batches": (probes.calls if probes else 0) - batches,
                "error": None if error is None else f"{type(error).__name__}: {error}"}
            log(f"[files] {schema} {name}: wall_s={wall} parse_s={rec['parse_s']} "
                f"scan_s={rec['scan_s']} "
                f"sink_s={rec['sink_s']} bytes_scanned={rec['bytes_scanned']} "
                f"probe_batches={rec['probe_batches']} launches={rec['launches']} "
                f"rows={None if res is None else str(res.rows[:3])[:160]} error={rec['error']}")
            if error is not None:
                raise error
            return res.rows

        def check(ok, what):
            if not ok:
                raise AssertionError(f"phase files {schema}: {what}")

        def twin(name, sql, want_sql):
            got, want = step(name, sql), r.execute(want_sql).rows
            check(rows_close(got, want) and got, f"{name}: {str(got)[:200]} against the tpch "
                  f"twin's {str(want)[:200]}")
            return got

        # writes: CTAS of orders and customer into parquet, customer into CSV
        with FileSinkTimer() as sink:
            for name, sql, table in FILES_CTAS:
                n = {"orders": n_orders, "customer": n_customers}[table]
                check(step(name, sql, sink) == [[n]], f"{name} did not write {n} rows")
        # the catalog's first parse of the whole table, then a cold catalog
        # on the same files pruned to one row group
        twin("first_parse", FILES_TOTALS.format(t="pq.s.orders"),
             FILES_TOTALS.format(t="orders"))
        r.register_catalog("pq_cold", create_file_connector(pq_root))
        cold = r.catalogs.get("pq_cold")
        scans["pq_cold"] = cold.page_source = FileScans(cold.page_source)
        twin("pruned", FILES_PRUNED.format(t="pq_cold.s.orders"),
             FILES_PRUNED.format(t="orders"))
        # (tiny's orders fill one row group: nothing to prune)
        check(0 < steps["pruned"]["bytes_scanned"] < steps["first_parse"]["bytes_scanned"]
              or n_orders <= 1 << 16, f"the pruned scan read {steps['pruned']['bytes_scanned']} bytes, the full one "
              f"{steps['first_parse']['bytes_scanned']}")
        group = ST_GROUP.replace("?", ST_DATES[0])
        twin("group", group.replace("from orders", "from pq.s.orders"), group)
        join = ST_JOIN.replace("?", ST_SEGMENT)
        twin("join", join.replace("from orders join customer",
                                  "from pq.s.orders join pq.s.customer"), join)
        twin("join_csv", join.replace("from orders join customer",
                                      "from pq.s.orders join csv.s.customer"), join)
        folded = scans["pq"].folded
        twin("fault_join", FILES_FAULT.format(o="pq.s.orders", c="pq.s.customer"),
             FILES_FAULT.format(o="orders", c="customer"))
        check(scans["pq"].folded > folded, "the dynamic filter never reached the file probe")
        # a second part: INSERT ... SELECT of about 1 % of the orders
        parts = sorted(os.listdir(os.path.join(pq_root, "s", "orders")))
        with FileSinkTimer() as sink:
            got = step("insert", FILES_INSERT.format(t="orders"), sink)
        added = r.execute(FILES_TOTALS.format(t="orders") + " where o_orderkey % 100 = 1").rows
        check(got == [[added[0][0]]], f"INSERT wrote {got}, the source holds {added}")
        new = sorted(set(os.listdir(os.path.join(pq_root, "s", "orders"))) - set(parts))
        check(len(new) == 1 and new[0].endswith(".parquet"), f"INSERT added the parts {new}")
        (count, price), = step("after_insert", FILES_TOTALS.format(t="pq.s.orders"))
        whole = steps["first_parse"]["rows"][0]
        check(count == whole[0] + added[0][0]
              and scaled(price, 2) == scaled(whole[1], 2) + scaled(added[0][1], 2),
              f"after the INSERT pq.s.orders holds {count} rows, {price}")
        # blackhole counts and discards; DROP TABLE removes a CSV table
        with FileSinkTimer() as sink:
            check(step("blackhole_ctas", FILES_BLACKHOLE, sink) == [[n_customers]],
                  "the blackhole CTAS count")
        check(step("blackhole_select", "select * from bh.default.customer") == [],
              "a SELECT from blackhole returned rows")
        step("drop_csv", "drop table csv.s.customer")
        check(step("show_csv", "show tables from csv.s") == [], "DROP TABLE left the table")
        check(not os.path.exists(os.path.join(csv_root, "s", "customer")),
              "DROP TABLE left the files")
        devices = set().union(*(x.devices for x in scans.values()))
        check(devices == {torch.device(device).type},
              f"the file page sources yielded batches on {devices}")
    finally:
        parse.__exit__()
        shutil.rmtree(root, ignore_errors=True)
    return steps


def phase_files(results: dict) -> None:
    """The file connectors at sf1 on the card (file_identities), each
    step's wall, scan_s (the first parse apart from scans from the parse
    cache), sink_s, bytes_scanned and launches printed: the bounded GROUP
    BY over the parquet orders launches grouped_sum; each join bounds once
    per probe batch and take_flat; run_owner runs in the phase. Launches
    count over this phase alone (`files_launches`)."""
    import torch
    from trino_tpu_torch.ops import join as TJ

    t_phase = time.perf_counter()
    probes = Capture(TJ, "sorted_run_bounds", lambda sorted_arr, q: (
        (q.numel(), int(sorted_arr.shape[0])) if q.numel() and sorted_arr.numel() else None),
        keep=())
    reset_kernel_counts()
    with probes:
        steps = file_identities("sf1", "cuda", log, probes)
    results["files_launches"] = join_kernel_counts()
    if steps["group"]["launches"]["grouped_sum"] <= 0:
        raise AssertionError("the GROUP BY over the parquet orders never launched grouped_sum")
    for name in ("join", "join_csv", "fault_join"):
        run = steps[name]
        if not 0 < run["launches"]["bounds"] == run["probe_batches"] \
                or run["launches"]["take_flat"] <= 0:
            raise AssertionError(f"{name}: bounds {run['launches']['bounds']} over "
                                 f"{run['probe_batches']} probe batches, take_flat "
                                 f"{run['launches']['take_flat']}")
    for k in ("grouped_sum", "bounds", "run_owner", "take_flat"):
        if results["files_launches"][k] <= 0:
            raise AssertionError(f"phase files never launched {k}")
    results["files"] = {k: {f: v for f, v in rec.items() if f != "rows"}
                        for k, rec in steps.items()}
    log(f"[files] the first parse of orders: parse_s {steps['first_parse']['parse_s']} s, "
        f"scan_s {steps['first_parse']['scan_s']} s; from the parse cache: group parse_s "
        f"{steps['group']['parse_s']} s, scan_s {steps['group']['scan_s']} s; join (its first "
        f"parse of customer) parse_s {steps['join']['parse_s']} s, scan_s "
        f"{steps['join']['scan_s']} s")
    log(f"[files] bytes_scanned: pruned to o_orderkey < 60000 "
        f"{steps['pruned']['bytes_scanned']}, a full scan {steps['first_parse']['bytes_scanned']}, "
        f"the dynamic-filter join {steps['fault_join']['bytes_scanned']} (parse cache)")
    log(f"[files] identities hold; launches over the phase: {results['files_launches']}")
    log(f"[files] phase took {time.perf_counter() - t_phase} s")
    torch.cuda.empty_cache()


def parity_files() -> None:
    """The card against the CPU: phase files' steps at tiny and sf0.1,
    equal rows (or the same error) and bytes_scanned step by step."""
    for schema in ("tiny", "sf0.1"):
        t0 = time.perf_counter()
        gpu, cpu = (file_identities(schema, d, lambda msg: None) for d in ("cuda", "cpu"))
        for name, rec in gpu.items():
            if not (rows_close(rec["rows"], cpu[name]["rows"]) if rec["rows"] is not None
                    else rec["error"] == cpu[name]["error"]) \
                    or rec["bytes_scanned"] != cpu[name]["bytes_scanned"]:
                raise AssertionError(f"files {name}: card and CPU differ at {schema}")
        log(f"[parity] files {schema}: {len(gpu)} steps, card == CPU "
            f"({time.perf_counter() - t0} s)")


# ---- phase spill: the memory pool, spill, the grace hash join, serde --------

SPILL_BATCH_ROWS = 1 << 18
# the pool is this fraction of one sf1 orders batch's device bytes: below
# every operator state the phase accumulates (two batches' grouped-sum
# tables of 1,024 slots included), so each statement spills
SPILL_POOL_FRACTION = 128
SP_ORDERS = "(select o_orderkey, o_custkey, o_totalprice from orders)"
SP_CUSTOMER = "(select c_custkey, c_mktsegment from customer)"
SPILL_STATEMENTS = (
    # HashAggregationOperator, the sort route (about 100,000 groups)
    ("group", "select o_custkey, count(*), sum(o_totalprice) from orders group by o_custkey"),
    # the grouped-sum route (1,000 clerks, 1,024 slots)
    ("group_bounded", "select o_clerk, count(*), sum(o_custkey), sum(o_shippriority)"
                      " from orders group by o_clerk"),
    # SortOperator: a full ORDER BY of orders
    ("sort", "select o_orderkey, o_custkey, o_totalprice from orders"
             " order by o_totalprice desc, o_orderkey"),
    # tests/test_memory.py's four JOIN_QS shapes over orders and customer
    # (each side projected first, so the scans read only the columns used)
    ("inner_agg", f"select c_mktsegment, count(*), sum(o_totalprice) from {SP_ORDERS} o,"
                  f" {SP_CUSTOMER} c where o_custkey = c_custkey group by c_mktsegment"
                  " order by c_mktsegment"),
    ("left", f"select c_custkey, o_orderkey from {SP_CUSTOMER} c left join {SP_ORDERS} o"
             " on c_custkey = o_custkey where c_custkey < 5000 order by c_custkey, o_orderkey"),
    ("semi", f"select count(*) from {SP_CUSTOMER} c where c_custkey in"
             " (select o_custkey from orders where o_totalprice > 400000)"),
    ("anti", f"select count(*) from {SP_CUSTOMER} c where c_custkey not in"
             " (select o_custkey from orders)"),
)
SPILL_JOINS = ("inner_agg", "left", "semi", "anti")
# tests/test_memory.py's queries with their sessions (AGG_Q, SORT_Q,
# JOIN_QS); tests/test_torch_spill.py holds them equal to the file's
MEMORY_QS = {
    "agg": ("select l_orderkey, sum(l_quantity) q, count(*) c from lineitem"
            " group by l_orderkey order by q desc, l_orderkey limit 10",
            {"batch_rows": 8192, "memory_pool_bytes": 256 * 1024}),
    "sort": ("select l_orderkey, l_extendedprice from lineitem"
             " order by l_extendedprice desc, l_orderkey limit 20",
             {"batch_rows": 4096, "memory_pool_bytes": 256 * 1024}),
    "inner_agg": ("select o_orderpriority, count(*), sum(l_quantity) from orders,"
                  " lineitem where o_orderkey = l_orderkey"
                  " group by o_orderpriority order by o_orderpriority",
                  {"batch_rows": 4096, "memory_pool_bytes": 192 * 1024}),
    "left": ("select c_custkey, o_orderkey from customer left join orders"
             " on c_custkey = o_custkey where c_custkey < 50"
             " order by c_custkey, o_orderkey",
             {"batch_rows": 4096, "memory_pool_bytes": 192 * 1024}),
    "semi": ("select count(*) from orders where o_orderkey in"
             " (select l_orderkey from lineitem where l_quantity > 48)",
             {"batch_rows": 4096, "memory_pool_bytes": 192 * 1024}),
    "anti": ("select count(*) from customer where c_custkey not in"
             " (select o_custkey from orders)",
             {"batch_rows": 4096, "memory_pool_bytes": 192 * 1024}),
}
_EA_ROWS = re.compile(r"^\s+(\w+): in=(\d+) rows/\d+ batches, out=(\d+) rows/", re.MULTILINE)


def orders_batches(schema: str, device: str) -> list:
    """The orders table at `schema` as its scan gives it, SPILL_BATCH_ROWS
    rows a batch, every column, on `device`."""
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.exec.operators import TableScanOperator

    conn = create_tpch_connector()
    handle = conn.metadata.get_table_handle(schema, "orders")
    cols = [c.name for c in conn.metadata.get_table_metadata(handle).columns]
    op = TableScanOperator(conn.page_source, conn.split_manager.get_splits(handle, 1),
                           cols, SPILL_BATCH_ROWS, device)
    out = []
    while not op.is_finished():
        b = op.get_output()
        if b is not None:
            out.append(b)
    return out


def spill_pool_bytes(batch) -> int:
    """The phase's pool: a fraction of one orders batch's device bytes."""
    from trino_tpu_torch.runtime.memory import batch_bytes

    return batch_bytes(batch) // SPILL_POOL_FRACTION


def spill_identities(schema: str, device: str, log, pool: int, unspilled=()) -> dict:
    """Phase spill's statements at `schema` on `device`: each on a runner
    whose pool is `pool` bytes and on its twin with no pool (both at
    SPILL_BATCH_ROWS rows a batch); returns {statement: record} with both
    walls, the rows' count, the spilled bytes, spill files and grace
    partitions (exec/spill.stats) and the pooled run's launches (counted
    only on the card). Every statement must equal its twin row for row
    and spill (but those named in `unspilled`: at tiny the bounded GROUP
    BY reads one batch of ten clerks); each join must finish partition
    by partition and launch the bounds kernel. Then EXPLAIN ANALYZE of the inner join on both
    runners: its operators' in=/out= rows must be the twin's.
    tests/test_torch_grace_join.py runs this at tiny on the CPU."""
    import torch
    from trino_tpu_torch.exec import spill

    pooled = runner(schema, device, batch_rows=SPILL_BATCH_ROWS, memory_pool_bytes=pool)
    plain = runner(schema, device, batch_rows=SPILL_BATCH_ROWS)

    def timed(r, sql):
        t0 = time.perf_counter()
        res = r.execute(sql)
        if device == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    steps: dict = {}
    for name, sql in SPILL_STATEMENTS + (("explain_analyze",
                                          "explain analyze " + dict(SPILL_STATEMENTS)["inner_agg"]),):
        s0, k0 = spill.stats(), join_kernel_counts()
        res, wall = timed(pooled, sql)
        s1, k1 = spill.stats(), join_kernel_counts()
        twin, twin_wall = timed(plain, sql)
        rec = steps[name] = {
            "wall_s": wall, "twin_wall_s": twin_wall, "rows": len(res.rows),
            **{k: s1[k] - s0[k] for k in s1},
            "launches": {k: k1[k] - k0[k] for k in k1}}
        log(f"[spill] {schema} {name}: wall_s={wall} twin_wall_s={twin_wall} "
            f"rows={rec['rows']} spilled_bytes={rec['spilled_bytes']} "
            f"spill_files={rec['spill_files']} grace_partitions={rec['grace_partitions']} "
            f"launches={rec['launches']}")
        if name == "explain_analyze":
            got, want = (_EA_ROWS.findall(x.only_value()) for x in (res, twin))
            if not got or got != want:
                raise AssertionError(f"EXPLAIN ANALYZE operator rows {got} != the plain "
                                     f"run's {want}")
            log(f"[spill] {schema} EXPLAIN ANALYZE of the inner join, operator rows as "
                f"without a pool: {got}")
        elif res.rows != twin.rows:
            raise AssertionError(f"spill {name}: rows differ from the unspilled twin")
        if rec["spilled_bytes"] <= 0 and name not in unspilled:
            raise AssertionError(f"spill {name} spilled nothing under a {pool}-byte pool")
        if name in SPILL_JOINS + ("explain_analyze",) and rec["grace_partitions"] <= 0:
            raise AssertionError(f"spill {name}: the join never ran partition by partition")
        if device == "cuda" and name in SPILL_JOINS and rec["launches"]["bounds"] <= 0:
            raise AssertionError(f"spill {name}: the grace join never launched bounds")
    return steps


def serde_round_trips(gpu: list, cpu: list, log) -> dict:
    """Every orders batch through the page serde on the card (`gpu`, and
    `cpu`, the same scan on the CPU): its page bytes equal the CPU port's
    for the same rows, and the page read back onto the card serializes
    to the same bytes. The one device->host copy of each batch
    (serde.to_host) is timed."""
    import torch
    from trino_tpu_torch.exec import serde
    from trino_tpu_torch.runtime.memory import batch_bytes

    if len(gpu) != len(cpu):
        raise AssertionError("serde: the card and the CPU scanned orders in different batches")
    copy_s, ser_s, nbytes, dev_bytes = [], [], 0, 0
    for g, c in zip(gpu, cpu):
        tensors = [g.live] if g.live is not None else []
        tensors += [x for col in g.columns for x in (col.data, col.valid) if x is not None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serde.to_host(tensors)
        copy_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        data = serde.serialize_batch(g)
        ser_s.append(time.perf_counter() - t0)
        if data != serde.serialize_batch(c):
            raise AssertionError("serde: the card's page bytes differ from the CPU's")
        back = serde.deserialize_batch(data, "cuda")
        if back.device.type != "cuda" or serde.serialize_batch(back) != data:
            raise AssertionError("serde: a page read back onto the card differs")
        nbytes += len(data)
        dev_bytes += batch_bytes(g)
    rec = {"batches": len(gpu), "page_bytes": nbytes, "device_bytes": dev_bytes,
           "copy_s": copy_s, "serialize_s": ser_s}
    log(f"[spill] serde: {len(gpu)} orders batches ({dev_bytes} device bytes) "
        f"-> {nbytes} page bytes, card == CPU and round trips equal; device->host "
        f"copies {copy_s} s, serialize (the copy included) {ser_s} s")
    return rec


def phase_spill(results: dict) -> None:
    """The memory pool, spill and the grace hash join at sf1 on the card
    (spill_identities), the pool worked out from one orders batch and
    printed, and the page serde round trip of every orders batch. Launches
    of the pooled runs count apart (`spill_launches`)."""
    import torch

    from trino_tpu_torch.runtime.memory import batch_bytes

    t_phase = time.perf_counter()
    reset_kernel_counts()
    batches = orders_batches("sf1", "cuda")
    pool = spill_pool_bytes(batches[0])
    log(f"[spill] one sf1 orders batch ({batches[0].capacity} rows, 9 columns): "
        f"{batch_bytes(batches[0])} device bytes; the pool: 1/{SPILL_POOL_FRACTION} of it, "
        f"{pool} bytes")
    serde_rec = serde_round_trips(batches, orders_batches("sf1", "cpu"), log)
    del batches
    steps = spill_identities("sf1", "cuda", log, pool)
    launches = {k: sum(rec["launches"][k] for rec in steps.values())
                for k in join_kernel_counts()}
    results["spill_launches"] = launches
    for k in ("bounds", "run_owner", "take_flat", "grouped_sum"):
        if launches[k] <= 0:
            raise AssertionError(f"phase spill never launched {k}")
    results["spill"] = {"pool_bytes": pool, "steps": steps, "serde": serde_rec}
    log(f"[spill] identities hold; launches of the pooled runs: {launches}")
    log(f"[spill] phase took {time.perf_counter() - t_phase} s")
    torch.cuda.empty_cache()


def parity_spill() -> None:
    """The card against the CPU: tests/test_memory.py's queries at tiny
    with their pools (MEMORY_QS), equal rows."""
    t0 = time.perf_counter()
    for name, (sql, session) in MEMORY_QS.items():
        a, b = (runner("tiny", d, **session).execute(sql).rows for d in ("cuda", "cpu"))
        if a != b:
            raise AssertionError(f"memory {name}: card and CPU rows differ at tiny")
    log(f"[parity] memory corpus: {len(MEMORY_QS)} queries at tiny under their pools, "
        f"card == CPU ({time.perf_counter() - t0} s)")


DIST_WORKERS = 4  # tests/test_distributed.py's topology: 4 workers, 4 hash partitions
DIST_JOIN = """select c_mktsegment, count(*), sum(o_totalprice) from customer
join orders on c_custkey = o_custkey group by c_mktsegment order by c_mktsegment"""
DIST_STATEMENTS = (
    ("clerk_group", "select o_clerk, count(*), sum(o_totalprice) from orders "
                    "group by o_clerk order by o_clerk"),
    ("custkey_group", "select o_custkey, count(*), sum(o_totalprice) from orders "
                      "group by o_custkey order by o_custkey"),
    ("segment_join", DIST_JOIN),
    ("supplier_nation", "select n_name, count(*), sum(s_acctbal) from supplier join nation "
                        "on s_nationkey = n_nationkey group by n_name order by n_name"),
    ("top_price", "select o_orderkey, o_totalprice from orders "
                  "order by o_totalprice desc, o_orderkey limit 10"),
    ("full_sort", "select o_orderkey, o_custkey from orders order by o_orderkey"),
    ("count", "select count(*) from orders"),
    ("explain", "explain " + DIST_JOIN),
    ("explain_analyze", "explain analyze " + DIST_JOIN),
)
_EA_SCAN = re.compile(r"TableScanOperator: in=\d+ rows/\d+ batches, out=(\d+) rows/")


def dist_runners(schema: str, device: str) -> tuple:
    """A DistributedQueryRunner (DIST_WORKERS in-process workers and
    hash partitions, the page exchange) and its LocalQueryRunner twin on
    `device`, over one tpch connector. The broadcast threshold is half
    of customer's rows, so customer and orders repartition for their
    join and nation broadcasts."""
    from trino_tpu_torch.connectors.tpch import base_row_count, create_tpch_connector
    from trino_tpu_torch.engine import LocalQueryRunner, Session
    from trino_tpu_torch.runtime import DistributedQueryRunner

    sf = {"tiny": 0.01}.get(schema) or float(schema[2:])
    session = dict(catalog="tpch", schema=schema,
                   broadcast_join_threshold=base_row_count("customer", sf) // 2)
    conn = create_tpch_connector()
    dist = DistributedQueryRunner(Session(mesh_execution=False, **session),
                                  n_workers=DIST_WORKERS, hash_partitions=DIST_WORKERS,
                                  device=device)
    dist.register_catalog("tpch", conn)
    twin = LocalQueryRunner(Session(**session), device=device)
    twin.register_catalog("tpch", conn)
    return dist, twin


def distributed_identities(schema: str, device: str, log) -> dict:
    """Phase distributed's statements at `schema` on `device`: each
    through the DistributedQueryRunner and through its LocalQueryRunner
    twin (dist_runners); returns {statement: record} with both walls, the
    rows, rows_shuffled, the host time of the exchange's page copies
    (exchange.page_out_s: Page.from_batch and the hash split;
    exchange.page_in_s: Page.to_batch) and the distributed run's
    launches (counted only on the card). Rows must equal the twin's
    exactly; the plans must be the fragments expected (a partial and a
    final step, a hash join over two repartitioned inputs, a broadcast
    of nation, a merging gather); EXPLAIN ANALYZE's orders scan must
    report every order; no task may be left on a worker. The twin of the
    join runs first, untimed, to build the generator's dictionaries.
    tests/test_torch_distributed.py runs this at tiny on the CPU."""
    import torch
    from trino_tpu_torch.connectors.tpch import base_row_count
    from trino_tpu_torch.runtime.metrics import METRICS

    sf = {"tiny": 0.01}.get(schema) or float(schema[2:])
    dist, twin = dist_runners(schema, device)
    twin.execute(DIST_JOIN)

    def timed(r, sql):
        t0 = time.perf_counter()
        res = r.execute(sql)
        if device == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    counters = ("rows_shuffled", "exchange.page_out_s", "exchange.page_in_s")
    steps: dict = {}
    for name, sql in DIST_STATEMENTS:
        m0, k0 = METRICS.snapshot(), join_kernel_counts()
        res, wall = timed(dist, sql)
        m1, k1 = METRICS.snapshot(), join_kernel_counts()
        twin_res, twin_wall = timed(twin, sql)
        rec = steps[name] = {
            "wall_s": wall, "twin_wall_s": twin_wall, "rows": len(res.rows),
            **{c: m1.get(c, 0.0) - m0.get(c, 0.0) for c in counters},
            "launches": {k: k1[k] - k0[k] for k in k1}}
        log(f"[distributed] {schema} {name}: wall_s={wall} twin_wall_s={twin_wall} "
            f"rows={rec['rows']} rows_shuffled={rec['rows_shuffled']} "
            f"page_out_s={rec['exchange.page_out_s']} page_in_s={rec['exchange.page_in_s']} "
            f"launches={rec['launches']}")
        if name == "explain":
            text = res.only_value()
            for want in ("Fragment", "output=hash", "RemoteSource"):
                if want not in text:
                    raise AssertionError(f"distributed EXPLAIN lacks {want!r}:\n{text}")
            log(f"[distributed] {schema} EXPLAIN of the join:\n{text}")
        elif name == "explain_analyze":
            text = res.only_value()
            scans = [int(n) for n in _EA_SCAN.findall(text)]
            n_orders = base_row_count("orders", sf)
            if n_orders not in scans or f"[{DIST_WORKERS} tasks]" not in text:
                raise AssertionError(f"EXPLAIN ANALYZE's stages do not read every order "
                                     f"({n_orders}) in {DIST_WORKERS} tasks: {scans}")
            log(f"[distributed] {schema} EXPLAIN ANALYZE of the join:\n{text}")
        elif res.rows != twin_res.rows:
            raise AssertionError(f"distributed {name}: rows differ from the local twin")
        if any(w.task_ids() for w in dist.workers):
            raise AssertionError(f"distributed {name}: tasks left on the workers")
    plans = {name: dist.execute("explain " + sql).only_value()
             for name, sql in DIST_STATEMENTS[:6]}
    for name, want in (("clerk_group", "step=partial"), ("segment_join", "[hash] output"),
                       ("supplier_nation", "output=broadcast")):
        if want not in plans[name]:
            raise AssertionError(f"distributed {name}: the plan lacks {want!r}:\n{plans[name]}")
    from trino_tpu_torch.sql.fragmenter import plan_distributed
    from trino_tpu_torch.sql.parser import parse

    sort_plan = plan_distributed(dist._analyze(parse(dict(DIST_STATEMENTS)["full_sort"])),
                                 dist.catalogs)
    if not any(f.output_merge_keys for f in sort_plan.all_fragments()):
        raise AssertionError("distributed full_sort: no merging gather in its plan")
    if steps["segment_join"]["rows_shuffled"] < base_row_count("orders", sf):
        raise AssertionError("the join's inputs did not cross the exchange")
    if device == "cuda":
        for name, kernels in (("clerk_group", ("grouped_sum",)),
                              ("segment_join", ("bounds", "take_flat")),
                              ("supplier_nation", ("bounds",))):
            for k in kernels:
                if steps[name]["launches"][k] <= 0:
                    raise AssertionError(f"distributed {name} never launched {k}")
    return steps


def rows_match(a: list, b: list, rel_tol: float = 1e-9, abs_tol: float = 1e-6) -> bool:
    """tests/oracle.py's assert_rows_match for ordered rows, as a
    predicate: equal rows, doubles within max(abs_tol, rel_tol * |x|)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None:
                    if not (x is None and y is None):
                        return False
                elif abs(x - y) > max(abs_tol, rel_tol * max(abs(x), abs(y))):
                    return False
            elif x != y:
                return False
    return True


def tpch_queries() -> dict:
    """tests/tpch_queries.py's 22 queries, loaded by path (see
    function_corpus)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tpch_queries", os.path.join(HERE, "tests", "tpch_queries.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.QUERIES


def distributed_tpch(schema: str, log) -> dict:
    """The 22 TPC-H queries at `schema` through the distributed runner on
    the card and on the CPU (4 workers each): rows equal, doubles within
    tests/oracle.py's tolerances (rows_match). Returns {query: (card
    wall, CPU wall)}."""
    import torch
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime import DistributedQueryRunner

    def cluster(device):
        r = DistributedQueryRunner(Session(catalog="tpch", schema=schema, mesh_execution=False),
                                   n_workers=DIST_WORKERS, hash_partitions=DIST_WORKERS,
                                   device=device)
        r.register_catalog("tpch", create_tpch_connector())
        return r

    card, cpu = cluster("cuda"), cluster("cpu")
    walls = {}
    for qid, sql in sorted(tpch_queries().items()):
        t0 = time.perf_counter()
        a = card.execute(sql).rows
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = cpu.execute(sql).rows
        walls[qid] = (t1 - t0, time.perf_counter() - t1)
        if not rows_match(a, b):
            raise AssertionError(f"distributed TPC-H Q{qid} at {schema}: card and CPU rows differ")
    log(f"[distributed] the 22 TPC-H queries at {schema}, 4 workers: card == CPU; walls "
        f"(card s, CPU s): {walls}")
    return walls


def phase_distributed(results: dict) -> None:
    """The distributed runner on the card: phase distributed's
    statements at sf1 (distributed_identities), then the 22 TPC-H
    queries at tiny against the CPU's distributed rows. Launches count
    apart (`distributed_launches`)."""
    import torch

    t_phase = time.perf_counter()
    reset_kernel_counts()
    steps = distributed_identities("sf1", "cuda", log)
    launches = {k: sum(rec["launches"][k] for rec in steps.values())
                for k in join_kernel_counts()}
    results["distributed_launches"] = launches
    for k in ("bounds", "take_flat", "grouped_sum"):
        if launches[k] <= 0:
            raise AssertionError(f"phase distributed never launched {k}")
    tpch = distributed_tpch("tiny", log)
    results["distributed"] = {"steps": steps, "tpch_tiny_walls": tpch}
    log(f"[distributed] identities hold; launches of the distributed runs: {launches}")
    log(f"[distributed] phase took {time.perf_counter() - t_phase} s")
    torch.cuda.empty_cache()


WIRE_WORKERS = 2
WIRE_STATEMENTS = ("clerk_group", "segment_join")  # of DIST_STATEMENTS
# tests/test_distributed.py's FTE_SHAPES "agg" and "join_agg" (a test
# keeps them equal)
WIRE_FTE_SHAPES = {
    "agg": ("SELECT l_returnflag, sum(l_quantity), count(*) FROM lineitem"
            " GROUP BY l_returnflag ORDER BY l_returnflag"),
    "join_agg": ("SELECT o_orderpriority, count(*) FROM orders, lineitem"
                 " WHERE o_orderkey = l_orderkey AND l_shipmode = 'MAIL'"
                 " GROUP BY o_orderpriority ORDER BY o_orderpriority"),
}
WIRE_FRONT_DOOR = (1, 3, 18)  # TPC-H queries through the Client and DB-API


def _synced(device, fn):
    """fn()'s result and its wall (host clock, the card synchronized)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if device is None or str(device).startswith("cuda"):
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def wire_http(schema: str, device, log) -> dict:
    """WIRE_STATEMENTS at `schema` through WIRE_WORKERS WorkerServers on
    127.0.0.1 (Worker(device=device) each, None: the card), the internal
    secret set for the phase in TRINO_TPU_INTERNAL_SECRET, beside their
    in-process twin: a DistributedQueryRunner over as many in-process
    Workers on the same device and connector. Rows must be equal; an
    unauthenticated request must get 401. Returns {statement: record}
    with both walls, the rows, the bytes pulled over HTTP
    (exchange.http_bytes) and the HTTP run's launches."""
    import secrets
    import urllib.error
    import urllib.request

    from trino_tpu_torch.connectors.spi import CatalogManager
    from trino_tpu_torch.connectors.tpch import base_row_count, create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime import DistributedQueryRunner, Worker
    from trino_tpu_torch.runtime.http import HttpWorkerClient, WorkerServer
    from trino_tpu_torch.runtime.metrics import METRICS

    sf = {"tiny": 0.01}.get(schema) or float(schema[2:])
    session = dict(catalog="tpch", schema=schema, mesh_execution=False,
                   broadcast_join_threshold=base_row_count("customer", sf) // 2)
    conn = create_tpch_connector()
    cats = CatalogManager()
    cats.register("tpch", conn)
    saved = os.environ.get("TRINO_TPU_INTERNAL_SECRET")
    os.environ["TRINO_TPU_INTERNAL_SECRET"] = secrets.token_hex(16)
    servers = []
    try:
        servers = [WorkerServer(Worker(f"http-w{i}", cats, device=device))
                   for i in range(WIRE_WORKERS)]
        try:
            urllib.request.urlopen(servers[0].uri + "/v1/status", timeout=10)
            raise AssertionError("a worker answered a request without the internal secret")
        except urllib.error.HTTPError as e:
            if e.code != 401:
                raise
        http = DistributedQueryRunner(
            Session(**session), worker_handles=[HttpWorkerClient(s.uri) for s in servers],
            hash_partitions=WIRE_WORKERS, device=device)
        http.catalogs = cats
        twin = DistributedQueryRunner(Session(**session), n_workers=WIRE_WORKERS,
                                      hash_partitions=WIRE_WORKERS, device=device)
        twin.register_catalog("tpch", conn)
        twin.execute(DIST_JOIN)  # the generator's dictionaries, untimed
        steps = {}
        for name in WIRE_STATEMENTS:
            sql = dict(DIST_STATEMENTS)[name]
            b0, k0 = METRICS.counter("exchange.http_bytes"), join_kernel_counts()
            res, wall = _synced(device, lambda: http.execute(sql))
            b1, k1 = METRICS.counter("exchange.http_bytes"), join_kernel_counts()
            twin_res, twin_wall = _synced(device, lambda: twin.execute(sql))
            if res.rows != twin_res.rows:
                raise AssertionError(f"wire {name}: HTTP rows differ from the in-process run")
            rec = steps[name] = {"wall_s": wall, "twin_wall_s": twin_wall,
                                 "rows": len(res.rows), "http_bytes": b1 - b0,
                                 "launches": {k: k1[k] - k0[k] for k in k1}}
            log(f"[wire] {schema} {name} over HTTP: wall_s={wall} in-process "
                f"twin_wall_s={twin_wall} rows={rec['rows']} http_bytes={rec['http_bytes']} "
                f"launches={rec['launches']}")
            if any(s.worker.task_ids() for s in servers):
                raise AssertionError(f"wire {name}: tasks left on the workers")
        return steps
    finally:
        for srv in servers:
            srv.stop()
        if saved is None:
            os.environ.pop("TRINO_TPU_INTERNAL_SECRET", None)
        else:
            os.environ["TRINO_TPU_INTERNAL_SECRET"] = saved


def wire_fte(schema: str, device, log) -> dict:
    """retry_policy="task" over WIRE_WORKERS in-process Workers on
    `device`: each of WIRE_FTE_SHAPES at `schema` without failures, then
    with every task's first attempt killed at "start" and at "mid"; the
    rows must equal the clean run's. Returns {shape: record} with the
    walls, the retries and the spool's bytes and host seconds
    (spool.bytes_written/write_s, spool.bytes_read/read_s)."""
    from trino_tpu_torch.connectors.spi import CatalogManager
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import Session
    from trino_tpu_torch.runtime import DistributedQueryRunner, Worker
    from trino_tpu_torch.runtime.failure import FailureInjector
    from trino_tpu_torch.runtime.metrics import METRICS

    inj = FailureInjector()
    cats = CatalogManager()
    cats.register("tpch", create_tpch_connector())
    workers = [Worker(f"fte-w{i}", cats, failure_injector=inj, device=device)
               for i in range(WIRE_WORKERS)]
    r = DistributedQueryRunner(Session(catalog="tpch", schema=schema, retry_policy="task"),
                               worker_handles=workers, hash_partitions=WIRE_WORKERS,
                               device=device)
    r.catalogs = cats
    spool = ("spool.bytes_written", "spool.write_s", "spool.bytes_read", "spool.read_s")
    out = {}
    for shape, sql in WIRE_FTE_SHAPES.items():
        rec = out[shape] = {}
        want = None
        for where in ("none", "start", "mid"):
            inj.clear()
            if where != "none":
                inj.inject(attempts=(0,), where=where)
            m0 = {c: METRICS.counter(c) for c in spool}
            try:
                res, wall = _synced(device, lambda: r.execute(sql))
            finally:
                inj.clear()
            run = rec[where] = {"wall_s": wall, "retries": r.last_fte_stats["retries"],
                                **{c: METRICS.counter(c) - m0[c] for c in spool}}
            if where == "none":
                want = res.rows
            elif res.rows != want:
                raise AssertionError(f"wire FTE {shape}: rows under failures at {where} "
                                     "differ from the clean run")
            elif run["retries"] < 1:
                raise AssertionError(f"wire FTE {shape}: no retry under failures at {where}")
            log(f"[wire] {schema} FTE {shape} failures={where}: {run}")
    if any(w.task_ids() for w in workers):
        raise AssertionError("wire FTE: tasks left on the workers")
    return out


def wire_front_door(schema: str, device, log) -> dict:
    """A CoordinatorServer over LocalQueryRunner(device=device): TPC-H
    WIRE_FRONT_DOOR at `schema` through the port's Client and DB-API must
    equal runner.execute; `python -m trino_tpu_torch.cli --server` in a
    subprocess must print Q1's rows as format_table renders them."""
    from trino_tpu_torch import dbapi
    from trino_tpu_torch.cli import format_table
    from trino_tpu_torch.client import Client
    from trino_tpu_torch.connectors.tpch import create_tpch_connector
    from trino_tpu_torch.engine import LocalQueryRunner, Session
    from trino_tpu_torch.runtime.server import CoordinatorServer

    r = LocalQueryRunner(Session(catalog="tpch", schema=schema), device=device)
    r.register_catalog("tpch", create_tpch_connector())
    queries = tpch_queries()
    srv = CoordinatorServer(r)
    out = {}
    try:
        for qid in WIRE_FRONT_DOOR:
            sql = queries[qid]
            want, wall = _synced(device, lambda: r.execute(sql))
            got, client_wall = _synced(device, lambda: Client(srv.uri).execute(sql))
            cur = dbapi.connect(srv.uri, user="chip_smoke").cursor()
            _, dbapi_wall = _synced(device, lambda: cur.execute(sql))
            if got.rows != want.rows or got.column_names != want.column_names:
                raise AssertionError(f"front door Q{qid}: Client rows differ from execute's")
            if cur.fetchall() != want.rows:
                raise AssertionError(f"front door Q{qid}: DB-API rows differ from execute's")
            out[f"q{qid}"] = {"rows": len(want.rows), "execute_s": wall,
                              "client_s": client_wall, "dbapi_s": dbapi_wall}
            log(f"[wire] {schema} front door Q{qid}: {out[f'q{qid}']}")
        want = r.execute(queries[1])
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "trino_tpu_torch.cli", "--server", srv.uri,
             "--execute", queries[1]],
            cwd=HERE, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": HERE})
        out["cli_s"] = time.perf_counter() - t0
        if cli.returncode != 0 or cli.stdout.strip() != format_table(want.column_names,
                                                                     want.rows):
            raise AssertionError(f"the CLI's Q1 differs (rc {cli.returncode}):\n"
                                 f"{cli.stdout}\n{cli.stderr}")
        log(f"[wire] {schema} CLI over the server printed Q1's {len(want.rows)} rows "
            f"in {out['cli_s']} s")
    finally:
        srv.stop()
    return out


def phase_wire(results: dict) -> None:
    """The wire and the front door on the card (see the module
    docstring); grouped_sum, bounds and take_flat must each launch."""
    import torch

    t_phase = time.perf_counter()
    log(f"[wire] card: {card_line()}")
    reset_kernel_counts()
    http = wire_http("sf1", None, log)
    fte = wire_fte("tiny", None, log)
    front = wire_front_door("tiny", None, log)
    launches = join_kernel_counts()
    results["wire_launches"] = launches
    for k in ("grouped_sum", "bounds", "take_flat"):
        if launches[k] <= 0:
            raise AssertionError(f"phase wire never launched {k}")
    results["wire"] = {"http": http, "fte": fte, "front_door": front}
    log(f"[wire] identities hold; launches of the phase: {launches}")
    log(f"[wire] phase took {time.perf_counter() - t_phase} s")
    torch.cuda.empty_cache()


_ENDS_ORDERED = re.compile(r"order\s+by[^()]*$", re.IGNORECASE | re.DOTALL)


def same_writes(gpu, cpu, statements, what, catalog) -> None:
    """Each statement on the card and on the CPU: equal types and rows
    (in order where it ends with ORDER BY), or the same error; before
    the first DROP TABLE, and at the end, every table of `catalog`
    read back equal (as multisets of rows)."""

    def run(r, sql):
        try:
            res = r.execute(sql)
            return [str(t) for t in res.column_types], res.rows
        except Exception as e:  # noqa: BLE001 - compared below
            return type(e).__name__, str(e)

    def tables():
        conn = cpu.catalogs.get(catalog)
        for schema in conn.metadata.list_schemas():
            for table in conn.metadata.list_tables(schema):
                sql = f"select * from {catalog}.{schema}.{table}"
                a, b = gpu.execute(sql).rows, cpu.execute(sql).rows
                if not rows_close(sorted(a, key=repr), sorted(b, key=repr)):
                    raise AssertionError(f"{what}: {table} differs between card and CPU")

    for sql in statements:
        if sql.lower().startswith("drop table"):
            tables()
        a, b = run(gpu, sql), run(cpu, sql)
        if isinstance(a[1], list) and isinstance(b[1], list) and a[0] == b[0]:
            ra, rb = a[1], b[1]
            if not _ENDS_ORDERED.search(sql):
                ra, rb = sorted(ra, key=repr), sorted(rb, key=repr)
            if rows_close(ra, rb):
                continue
        elif a == b:
            continue
        raise AssertionError(f"{what}: card {str(a)[:200]} and CPU {str(b)[:200]} differ "
                             f"on {sql}")
    tables()


def parity_write() -> None:
    """The card against the CPU: phase write's statements at tiny and
    sf0.1, and every script of the write corpus at tiny."""
    for schema in ("tiny", "sf0.1"):
        t0 = time.perf_counter()
        same_writes(write_runner(schema, "cuda"), write_runner(schema, "cpu"),
                    write_statements(), f"write {schema}", "w")
        log(f"[parity] write statements {schema}: {len(write_statements())} statements, "
            f"card == CPU ({time.perf_counter() - t0} s)")
    t0 = time.perf_counter()
    for name, script in WRITE_SCRIPTS.items():
        same_writes(script_runner(script, "cuda"), script_runner(script, "cpu"),
                    script["sql"], f"write script {name}", "memory")
    log(f"[parity] write corpus: {len(WRITE_SCRIPTS)} scripts at tiny, card == CPU "
        f"({time.perf_counter() - t0} s)")


def parity_zones() -> None:
    """The card against the CPU: every timestamptz and MATCH_RECOGNIZE
    case at tiny (TSTZ_SQL, MR_SQL, MR_NULL_SQL) and phase zones'
    queries at tiny and sf0.1."""
    for schema in TSTZ_TABLES:
        gpu, cpu = tstz_runner(schema, "cuda"), tstz_runner(schema, "cpu")
        for sch, sql in TSTZ_SQL:
            if sch == schema and gpu.execute(sql).rows != cpu.execute(sql).rows:
                raise AssertionError(f"timestamptz {schema}: card and CPU differ on {sql}")
        if schema == "t":
            now = [x.execute(TSTZ_NOW).rows[0][0] for x in (gpu, cpu)]
            if not all(v.endswith(TSTZ_SESSION_ZONE["t"]) for v in now):
                raise AssertionError(f"now() is not in the session zone: {now}")
    log(f"[parity] timestamptz cases: {len(TSTZ_SQL)} queries and now(), card == CPU")
    gpu, cpu = mr_runner("cuda"), mr_runner("cpu")
    for sql in MR_SQL + MR_NULL_SQL:
        if gpu.execute(sql).rows != cpu.execute(sql).rows:
            raise AssertionError(f"MATCH_RECOGNIZE: card and CPU differ on {sql}")
    log(f"[parity] MATCH_RECOGNIZE cases: {len(MR_SQL) + len(MR_NULL_SQL)} queries, card == CPU")
    for schema in ("tiny", "sf0.1"):
        gpu, cpu = zones_runner(schema, "cuda"), zones_runner(schema, "cpu")
        for name, sql in ZONE_QUERIES:
            a, b = gpu.execute(sql).rows, cpu.execute(sql).rows
            if a != b:
                raise AssertionError(f"{name}: card and CPU rows differ at {schema}")
            log(f"[parity] {name} {schema}: {len(a)} rows, card == CPU")


def rows_close(a: list, b: list) -> bool:
    """Rows equal, doubles within 1e-12 relative (NaN equal to NaN): the
    card's libm and the CPU's may differ in the last ulps of a
    transcendental, and sums in another order in the last bits."""
    import math

    def same(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return (math.isnan(x) and math.isnan(y)) or x == y or \
                abs(x - y) <= 1e-12 * max(abs(x), abs(y))
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            return len(x) == len(y) and all(same(p, q) for p, q in zip(x, y))
        if isinstance(x, dict) and isinstance(y, dict):
            return list(x) == list(y) and all(same(x[k], y[k]) for k in x)
        return x == y

    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(same(x, y) for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def function_corpus() -> list:
    """The SQL of tests/test_functions.py's five case lists. The file is
    loaded by its path: the repo's tests/ is a namespace package, which
    a regular package named `tests` elsewhere on the path would shadow."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "function_corpus", os.path.join(HERE, "tests", "test_functions.py"))
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    return [sql for lst in ("CASES", "MATH_CASES", "STRING_CASES", "DATE_CASES",
                            "REGISTRY_CASES") for sql, _ in getattr(corpus, lst)]


def orders_columns(sf: float, *cols) -> list:
    """Columns of orders from the generator, as the scan makes them."""
    from trino_tpu_torch.connectors.tpch import base_row_count, generate_column

    n = base_row_count("orders", sf)
    return [generate_column("orders", c, sf, 0, n) for c in cols]


def per_value_sum(column, fn) -> int:
    """Sum of fn over a dictionary column's rows: fn once per value,
    weighted by the count of its code (numpy's bincount)."""
    import numpy as np

    codes, dictionary = column
    counts = np.bincount(codes.astype(np.int64), minlength=len(dictionary))
    return int(np.dot(counts, np.asarray([fn(v) for v in dictionary.values],
                                         dtype=np.int64)))


def main_functions(results, r, scan, per_query, probes) -> None:
    """The scalar functions at sf1 (orders, customer), each held exactly:
    date_trunc/quarter against extract, date round trips over every
    order, regexp_like against LIKE, regexp_count/strpos/split_part
    against numpy over the generated columns, a regexp and bitwise join
    against its substr and % 16 twin (bounds once per probe batch),
    md5/xxhash64/lpad against hashlib and pyfns, ln/sqrt/geometric_mean
    within 1e-9 of numpy, and entropy and checksum against the CPU."""
    import datetime
    import hashlib
    import re

    import numpy as np
    from trino_tpu_torch.connectors.tpch import _schema_sf, base_row_count
    from trino_tpu_torch.expr import pyfns

    sf = _schema_sf(r.session.schema)
    rows = {name: run_query(r, scan, name, "cold", sql, per_query, probes)
            for name, sql in FN_QUERIES}
    # date_trunc and quarter against extract(year/month)

    def year_month(days):
        d = datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
        return d.year, d.month

    months = [[*year_month(m), c, total] for m, _, c, total in rows["fn_months"]]
    quarters_ok = all(q == (year_month(m)[1] - 1) // 3 + 1
                      for m, q, _, _ in rows["fn_months"])
    if months != rows["fn_months_check"] or not quarters_ok or len(months) < 12:
        raise AssertionError(f"date_trunc/quarter by month {rows['fn_months'][:3]} != "
                             f"extract {rows['fn_months_check'][:3]}")
    n_orders = base_row_count("orders", sf)
    if rows["fn_round_trips"] != [[n_orders] * 4]:
        raise AssertionError(f"date round trips {rows['fn_round_trips']} over {n_orders} orders")
    if rows["fn_regexp"] != rows["fn_regexp_like"] or rows["fn_regexp"][0][0] <= 0:
        raise AssertionError(f"regexp_like {rows['fn_regexp']} != LIKE {rows['fn_regexp_like']}")
    comment, clerk = orders_columns(sf, "o_comment", "o_clerk")
    rx = re.compile("e")
    want = [per_value_sum(comment, lambda v: len(rx.findall(v))),
            per_value_sum(comment, lambda v: v.find("the") + 1),
            per_value_sum(clerk, lambda v: int(v.split("#")[1]))]
    got = [int(x) for x in rows["fn_strings"][0]]
    if got != want:
        raise AssertionError(f"regexp_count/strpos/split_part sums {got} != numpy {want}")
    if rows["fn_join"] != rows["fn_join_twin"] or not rows["fn_join"]:
        raise AssertionError("the regexp/bitwise join differs from its substr twin")
    # customer is the build side and c_custkey unique, so no probe row
    # has two matches and the expansion needs no run-owner fill
    run = per_query["fn_join_cold"]
    if run["launches"]["bounds"] != run["probe_batches"] or run["launches"]["bounds"] <= 0 \
            or run["launches"]["take_flat"] <= 0 or run["launches"]["window_rank"]:
        raise AssertionError(f"fn_join launches {run['launches']} for "
                             f"{run['probe_batches']} probe batches")
    for key, name, md5, xx, pad in rows["fn_hash"]:
        b = name.encode()
        if md5 != hashlib.md5(b).hexdigest() or xx != format(pyfns.xxhash64(b), "016x") \
                or pad != (str(key).zfill(12) if key < SMALL_INT_CAST else None):
            raise AssertionError(f"hash row {key} {name}: {md5} {xx} {pad}")
    if len(rows["fn_hash"]) != base_row_count("customer", sf):
        raise AssertionError(f"fn_hash returned {len(rows['fn_hash'])} customers")
    (price_cents, _), = orders_columns(sf, "o_totalprice")
    price = price_cents.astype(np.float64) / 100
    want = [np.log(price).sum(), np.sqrt(price).sum(), np.exp(np.log(price).mean())]
    for g, w in zip(rows["fn_math"][0], want):
        if abs(g - w) > 1e-9 * abs(w):
            raise AssertionError(f"ln/sqrt/geometric_mean {rows['fn_math'][0]} != numpy {want}")
    cpu = runner(r.session.schema, "cpu")
    cpu_agg = cpu.execute(FN_AGG).rows
    if not rows_close(rows["fn_agg"], cpu_agg):
        raise AssertionError(f"entropy/checksum card {rows['fn_agg']} != CPU {cpu_agg}")
    results["functions"] = {name: per_query[f"{name}_cold"] for name, _ in FN_QUERIES}
    for name, _ in FN_QUERIES:
        run = per_query[f"{name}_cold"]
        launched = {k: v for k, v in run["launches"].items() if v}
        log(f"[main] {name}: kernels launched {launched or 'none'}")
    log(f"[main] functions: {len(months)} months equal extract's; {n_orders} orders hold "
        f"the date round trips; regexp_like == LIKE ({rows['fn_regexp'][0][0]}); sums "
        f"{got} equal numpy's; the join equals its twin over {len(rows['fn_join'])} groups; "
        f"{len(rows['fn_hash'])} hashes equal hashlib/pyfns; ln/sqrt/geometric_mean within 1e-9 of numpy; "
        f"entropy/checksum equal the CPU's {cpu_agg}")


def join_captures():
    """Captures of the join kernels' arguments (bounds, run_owner,
    take_flat), keyed by size, to time each on its largest call. A
    run_owner key ends with the expansion's pairs (its last offset)."""
    from trino_tpu_torch.ops import gather_kernels as GK
    from trino_tpu_torch.ops import window_rank as W

    return (Capture(W, "_launch_bounds", lambda q, b: (q.numel(), int(b.shape[0]),
                                                       q.element_size())),
            Capture(W, "_launch_run_owner", lambda off, n_out: (
                n_out, int(off.shape[0]), int(off[-1]) if off.numel() else 0)),
            Capture(GK, "_launch_flat", lambda table, idx: (
                idx.numel(), int(table.shape[0]), table.element_size())))


def held_bytes(caps) -> int:
    """Device bytes of the tensors the captures keep."""
    import torch

    sizes = {t.data_ptr(): t.numel() * t.element_size()
             for c in caps for args in c.args.values() for t in args
             if isinstance(t, torch.Tensor) and t.is_cuda}
    return sum(sizes.values())


def main_holistic(r, scan, per_query) -> None:
    """The holistic and sketch aggregates over orders at the runner's
    scale, each held to an identity: approx_distinct on the holistic
    path equals count(distinct), the min_by/max_by keys carry the
    extreme prices, the pctl_merge medians lie within their 2^-9 wide
    bucket of the exact nearest-rank medians, and the lone HLL estimate
    within 3 standard errors (3 x 1.04 / sqrt(2048)) of the count."""
    (distinct, kmin, kmax), = run_query(r, scan, "hol", "cold", Q_HOLISTIC, per_query)
    (lo, hi), = run_query(r, scan, "hol_extremes", "cold", Q_HOLISTIC_EXTREMES, per_query)
    (exact_distinct,), = run_query(r, scan, "hol_distinct", "cold", Q_WIN_CUSTOMERS,
                                   per_query)
    prices = dict(run_query(
        r, scan, "hol_prices", "cold",
        f"select o_orderkey, o_totalprice from orders where o_orderkey in ({kmin}, {kmax})",
        per_query))
    if distinct != exact_distinct or prices.get(kmin) != lo or prices.get(kmax) != hi:
        raise AssertionError(
            f"holistic: approx_distinct {distinct} vs count(distinct) {exact_distinct}, "
            f"min_by {kmin} -> {prices.get(kmin)} vs min {lo}, "
            f"max_by {kmax} -> {prices.get(kmax)} vs max {hi}")
    pctl = run_query(r, scan, "pctl", "cold", Q_PCTL, per_query)
    exact = run_query(r, scan, "pctl_exact", "cold", Q_PCTL_EXACT, per_query)
    if [row[0] for row in pctl] != [row[0] for row in exact] or len(pctl) != 5:
        raise AssertionError(f"pctl_merge groups differ: {pctl} vs {exact}")
    for (prio, est), (_, med, _) in zip(pctl, exact):
        if abs(est - med) > 2.0 ** -9 * abs(med) + 0.01:
            raise AssertionError(f"pctl_merge {prio}: {est} outside the bucket of {med}")
    (hll,), = run_query(r, scan, "hll", "cold", Q_HLL, per_query)
    if abs(hll - exact_distinct) > 3 * 1.04 / 2048 ** 0.5 * exact_distinct:
        raise AssertionError(f"HLL estimate {hll} vs {exact_distinct}")
    log(f"[main] holistic: approx_distinct {distinct} == count(distinct o_custkey); "
        f"min_by/max_by keys {kmin}/{kmax} carry o_totalprice {lo}/{hi}; pctl_merge "
        f"medians {[row[1] for row in pctl]} vs exact {[row[1] for row in exact]}; "
        f"lone approx_distinct (HLL) {hll}")


def q72_pairs(schema: str) -> int:
    """Pairs of q72's bottom join catalog_sales x inventory on item at
    `schema`, from the generator's own columns."""
    import numpy as np
    from trino_tpu_torch.connectors.tpcds import _schema_sf, generate_column, row_count

    sf = _schema_sf(schema)
    cs, _ = generate_column("catalog_sales", "cs_item_sk", sf, 0,
                            row_count("catalog_sales", sf))
    inv, _ = generate_column("inventory", "inv_item_sk", sf, 0, row_count("inventory", sf))
    m = int(max(cs.max(), inv.max())) + 1
    return int(np.dot(np.bincount(cs, minlength=m), np.bincount(inv, minlength=m)))


def main_tpcds(results, per_query, probes, flat_timer) -> None:
    """TPC-DS at sf1 (the fact tables' counts, the nine templates other
    than q72) and q72 at Q72_SCHEMA, each cold once; `flat_timer`'s
    family follows them."""
    import torch
    from trino_tpu_torch.connectors.tpcds import _schema_sf, row_count

    flat_timer.family = "tpcds"
    ds = runner("sf1", "cuda", catalog="tpcds")
    conn = ds.catalogs.get("tpcds")
    scan = conn.page_source = TimedPageSource(conn.page_source)
    sf = _schema_sf(ds.session.schema)
    for table in ("store_sales", "catalog_sales", "inventory"):
        got = run_query(ds, scan, f"ds_count_{table}", "cold",
                        f"select count(*) from {table}", per_query)
        if got != [[row_count(table, sf)]]:
            raise AssertionError(f"count(*) of {table}: {got} != {row_count(table, sf)}")
    rows = {}
    caps = join_captures()
    with caps[0], caps[1], caps[2]:
        for name in sorted(TPCDS_QUERIES):
            if name != "q72":
                rows[name] = run_query(ds, scan, f"ds_{name}", "cold", tpcds_sql(name, ds),
                                       per_query, probes)
    results["main_args"]["tpcds"] = [c.largest() for c in caps]

    r72 = runner(Q72_SCHEMA, "cuda", catalog="tpcds")
    conn = r72.catalogs.get("tpcds")
    scan72 = conn.page_source = TimedPageSource(conn.page_source)
    sql72 = tpcds_sql("q72", r72)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the peak resets to what is allocated now (the earlier queries'
    # kept kernel arguments), so q72's own peak is the rise above that
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    caps = join_captures()
    flat_timer.family = "q72"
    with caps[0], caps[1], caps[2]:
        rows["q72"] = run_query(r72, scan72, "ds_q72", "cold", sql72, per_query, probes)
    peak = torch.cuda.max_memory_allocated()
    widest = max((k[2] for k in caps[1].keys), default=0)
    results["main_args"]["q72"] = [c.largest() for c in caps]
    kept = held_bytes(caps)
    results["q72"] = {"schema": Q72_SCHEMA, "peak_bytes": peak - base, "base_bytes": base,
                      "kept_arg_bytes": kept, "widest_expansion": widest,
                      "bottom_join_pairs": q72_pairs(Q72_SCHEMA), "rows": len(rows["q72"])}
    log(f"[main] q72 at {Q72_SCHEMA}: {len(rows['q72'])} rows, "
        f"torch.cuda.max_memory_allocated()={peak} over {base} allocated before it: "
        f"q72's peak {peak - base} bytes, of which at most {kept} are its largest kernel "
        f"arguments kept for timing; widest expansion {widest} pairs, "
        f"bottom join catalog_sales x inventory {results['q72']['bottom_join_pairs']} pairs")
    torch.cuda.empty_cache()
    check_tpcds(rows, per_query)


def check_tpcds(rows, per_query) -> None:
    """Shapes at sf1 and q72's scale: the templates that select rows at
    tiny select rows here too; q72's counts add up; every template is a
    join and launches bounds once per probe batch and no searched rank."""
    import math

    for name, got in rows.items():
        if name in TPCDS_NONEMPTY and not got:
            raise AssertionError(f"TPC-DS {name} selected no rows")
        for row in got:
            if any(isinstance(x, float) and not math.isfinite(x) for x in row):
                raise AssertionError(f"TPC-DS {name}: a non-finite value in {row}")
        run = per_query[f"ds_{name}_cold"]
        launched = run["launches"]
        if launched["bounds"] != run["probe_batches"] or launched["window_rank"] \
                or launched["bounds"] <= 0:
            raise AssertionError(f"TPC-DS {name}: {launched['bounds']} bounds launches for "
                                 f"{run['probe_batches']} probe batches, "
                                 f"{launched['window_rank']} rank launches")
    counts = [row[5] for row in rows["q72"]]
    if any(row[3] + row[4] != row[5] for row in rows["q72"]) \
            or counts != sorted(counts, reverse=True):
        raise AssertionError(f"q72 rows out of shape: {rows['q72'][:5]}")
    log(f"[main] TPC-DS: {', '.join(f'{n} {len(r)} rows' for n, r in sorted(rows.items()))}")


def main_widestr(results, per_query) -> None:
    """BASELINE config 5 at its size (2^21 rows), equal to numpy's own
    group-by of the same arrays; records the aggregation route."""
    r, (vals, codes, v) = widestr_runner(WIDESTR_ROWS, "cuda")
    conn = r.catalogs.get("memory")
    scan = conn.page_source = TimedPageSource(conn.page_source)
    got = run_query(r, scan, "widestr", "cold", WIDESTR, per_query)
    want = widestr_numpy(vals, codes, v)
    if got != want:
        raise AssertionError(f"wide-string GROUP BY {got[:3]} != numpy {want[:3]}")
    run = per_query["widestr_cold"]
    route = "grouped_sum" if run["launches"]["grouped_sum"] else "not grouped_sum"
    results["widestr"] = {"rows": WIDESTR_ROWS, "route": route,
                          "grouped_sum_launches": run["launches"]["grouped_sum"],
                          "grouped_sum_shapes": run["grouped_sum_shapes"]}
    log(f"[main] wide-string GROUP BY over {WIDESTR_ROWS} rows equals numpy's; route "
        f"{route}, grouped_sum launches {run['launches']['grouped_sum']} at "
        f"{run['grouped_sum_shapes']}")


JOIN_QUERIES = ("q3_", "q18_cold", "q16_", "q22_", "q_mxj_")


def check_main(rows, per_query, cross, batches) -> None:
    import math

    if per_query["q_mxu_cold"]["launches"]["grouped_sum"] < batches:
        raise AssertionError("Q-MXU launched grouped_sum fewer times than scan batches")
    for q in ("q1_cold", "q6_cold"):
        if per_query[q]["launches"]["grouped_sum"]:
            raise AssertionError("Q1/Q6 are expected on the dense/global routes")
    for q, n in per_query.items():
        launched = n["launches"]
        joins = [launched[k] for k in ("bounds", "run_owner", "take_flat")]
        if q.startswith(JOIN_QUERIES):
            if q.startswith(("q3_", "q18_")) and min(joins) <= 0:
                raise AssertionError(f"{q}: the join ran without its kernels {launched}")
            # one bounds launch per probe batch, and no searched rank
            if launched["bounds"] != n["probe_batches"] or launched["window_rank"]:
                raise AssertionError(
                    f"{q}: {launched['bounds']} bounds launches for "
                    f"{n['probe_batches']} probe batches, "
                    f"{launched['window_rank']} rank launches")
        elif q.startswith(("q1_", "q6_", "q_mxu_", "q_win")) and \
                max(joins + [launched["window_rank"]]) > 0:
            raise AssertionError(f"{q}: join kernels launched on a join-free query")
    # Q-MXU rolled up over (shipmode, shipinstruct) is Q1's measures
    rollup = {}
    for rf, ls, _, _, qty, base, disc, cnt in rows["q_mxu"]:
        acc = rollup.setdefault((rf, ls), [0, 0, 0, 0])
        acc[0] += scaled(qty, 2)
        acc[1] += scaled(base, 2)
        acc[2] += scaled(disc, 4)
        acc[3] += cnt
    q1 = {(row[0], row[1]): [scaled(row[2], 2), scaled(row[3], 2),
                             scaled(row[4], 4), row[9]] for row in rows["q1"]}
    if rollup != q1:
        raise AssertionError(f"Q-MXU roll-up {rollup} != Q1 {q1}")
    if len(rows["q_mxu"]) == 0 or len(rows["q6"]) != 1:
        raise AssertionError("unexpected result sizes")
    # Q3: ten rows, finite revenues in descending order
    rev = [row[1] for row in rows["q3"]]
    if len(rev) != 10 or not all(math.isfinite(v) and v > 0 for v in rev) \
            or rev != sorted(rev, reverse=True):
        raise AssertionError(f"Q3 rows out of shape: {rows['q3']}")
    # Q18 against the join-free route: each row's sum(l_quantity) is its
    # order's total, and the orders are exactly those over 300
    totals = {row[0]: scaled(row[1], 2) for row in cross}
    got = {row[2]: scaled(row[5], 2) for row in rows["q18"]}
    if not got or any(totals.get(k) != v for k, v in got.items()):
        raise AssertionError("Q18 sums differ from the join-free group-by")
    if len(totals) <= 100 and set(got) != set(totals):
        raise AssertionError("Q18 orders differ from the join-free group-by")
    log(f"[main] Q-MXU roll-up equals Q1 over {len(q1)} groups; Q18's "
        f"{len(got)} orders equal the join-free group-by's {len(totals)}")


def check_breadth_queries(rows, per_query, win_check, batches) -> None:
    """Q16, Q22, Q-WIN and Q-MXJ at sf1: shapes, identities and the
    join-project route's launches."""
    import math

    q16 = rows["q16"]
    cnts = [row[3] for row in q16]
    if not q16 or not all(isinstance(c, int) and c > 0 for c in cnts) \
            or cnts != sorted(cnts, reverse=True):
        raise AssertionError(f"Q16 rows out of shape: {q16[:5]}")
    q22 = rows["q22"]
    codes = [row[0] for row in q22]
    if not q22 or codes != sorted(codes) or not set(codes) <= {
            "13", "31", "23", "29", "30", "18", "17"} \
            or not all(row[1] > 0 and math.isfinite(row[2]) for row in q22):
        raise AssertionError(f"Q22 rows out of shape: {q22}")
    # Q-WIN: the last row of each customer's partition (no next order)
    # holds the running total and the order count of that customer
    (customers,), (total, count) = win_check[0][0], win_check[1][0]
    want = [customers, total, count]
    if rows["q_win"] != [want]:
        raise AssertionError(f"Q-WIN {rows['q_win']} != [count distinct customers, "
                             f"sum(o_totalprice), count(*)] {want}")
    on, off = per_query["q_mxj_cold"], per_query["q_mxj_off_cold"]
    if on["mxu_join_selected"] != 1 or off["mxu_join_selected"] != 0:
        raise AssertionError(f"Q-MXJ route selected {on['mxu_join_selected']} times "
                             f"on, {off['mxu_join_selected']} off")
    if rows["q_mxj"] != rows["q_mxj_off"] or not rows["q_mxj"]:
        raise AssertionError("Q-MXJ rows differ from its mxu-off twin")
    launched = on["launches"]
    if launched["grouped_sum"] < batches:
        raise AssertionError(f"Q-MXJ launched grouped_sum {launched['grouped_sum']} "
                             f"times for {batches} lineitem batches")
    if launched["run_owner"] or launched["take_flat"]:
        raise AssertionError(f"Q-MXJ expanded join pairs: {launched}")
    log(f"[main] Q-WIN equals count(distinct o_custkey), sum(o_totalprice) and "
        f"count(*) of orders: {want}; Q-MXJ equals its mxu-off twin over "
        f"{len(rows['q_mxj'])} brands with {launched['grouped_sum']} grouped_sum "
        f"launches and no pair expansion")


def phase_explore(results: dict) -> None:
    """Both explorer entry points, with the launch counts they cause."""
    from trino_tpu_torch.explore import kernel_costs, pallas_gather

    reset_kernel_counts()
    recs = {"pallas_gather": pallas_gather.run(), "kernel_costs": kernel_costs.run()}
    counts = join_kernel_counts()
    results["explore"] = recs
    results["explore_launches"] = counts
    bad = [r for rs in recs.values() for r in rs if not r["correct"]]
    if bad:
        raise AssertionError(f"explorer outputs differ from the plain versions: {bad}")
    for k in ("window_rank", "take_flat", "take_rows_sum", "take_along_lanes"):
        if counts[k] <= 0:
            raise AssertionError(f"the explorers never launched {k}")
    log(f"[explore] launches: {counts}")


def phase_parity(results: dict) -> None:
    # Q-MXJ twice: with the join-project route on, and off
    breadth = (("q16", Q16, False), ("q22", Q22, False), ("q_win", Q_WIN, False),
               ("q_mxj", Q_MXJ, True), ("q_mxj_off", Q_MXJ, False),
               ("hol", Q_HOLISTIC, False), ("hol_extremes", Q_HOLISTIC_EXTREMES, False),
               ("pctl", Q_PCTL, False), ("pctl_exact", Q_PCTL_EXACT, False),
               ("hll", Q_HLL, False))
    tests = tuple((f"window{i}", q, False) for i, q in enumerate(WINDOW_QUERIES)) + tuple(
        (f"set{i}", q, False) for i, q in enumerate(SET_QUERIES))
    for schema, queries in (
        ("tiny", (("q1", Q1, False), ("q6", Q6, False), ("q_mxu", Q_MXU, False),
                  ("q3", Q3, False), ("q18", Q18, False), ("listagg", Q_LISTAGG, False))
         + breadth + tests),
        ("sf0.1", (("q3", Q3, False), ("q18", Q18, False)) + breadth),
    ):
        gpu, cpu = runner(schema, "cuda"), runner(schema, "cpu")
        for name, sql, mxu in queries:
            gpu.session.mxu_join_enabled = cpu.session.mxu_join_enabled = mxu
            a, b = gpu.execute(sql).rows, cpu.execute(sql).rows
            if a != b:
                raise AssertionError(f"{name}: card and CPU rows differ at {schema}")
            log(f"[parity] {name} {schema}: {len(a)} rows, card == CPU")
    # the scalar function corpus of tests/test_functions.py at tiny, and
    # the functions queries at sf0.1; doubles within rows_close's 1e-12
    for schema, queries in (("tiny", list(enumerate(function_corpus()))),
                            ("sf0.1", FN_QUERIES)):
        gpu, cpu = runner(schema, "cuda"), runner(schema, "cpu")
        for name, sql in queries:
            a, b = gpu.execute(sql).rows, cpu.execute(sql).rows
            if not rows_close(a, b):
                raise AssertionError(f"functions {name}: card {a[:3]} and CPU {b[:3]} "
                                     f"differ at {schema}")
        log(f"[parity] functions {schema}: {len(queries)} queries, card == CPU")
    # TPC-DS: the ten templates at tiny, the nine other than q72 at sf0.1
    for schema, names in (("tiny", sorted(TPCDS_QUERIES)),
                          ("sf0.1", [n for n in sorted(TPCDS_QUERIES) if n != "q72"])):
        gpu, cpu = runner(schema, "cuda", "tpcds"), runner(schema, "cpu", "tpcds")
        for name in names:
            sql = tpcds_sql(name, cpu)
            a, b = gpu.execute(sql).rows, cpu.execute(sql).rows
            if a != b:
                raise AssertionError(f"TPC-DS {name}: card and CPU rows differ at {schema}")
            if schema == "tiny" and name in TPCDS_NONEMPTY and not a:
                raise AssertionError(f"TPC-DS {name} selected no rows at tiny")
            log(f"[parity] TPC-DS {name} {schema}: {len(a)} rows, card == CPU")
    # the wide-string GROUP BY at 2^16 rows, also against numpy
    (gpu, arrays), (cpu, _) = widestr_runner(1 << 16, "cuda"), widestr_runner(1 << 16, "cpu")
    a, b = gpu.execute(WIDESTR).rows, cpu.execute(WIDESTR).rows
    if a != b or a != widestr_numpy(*arrays):
        raise AssertionError("wide-string GROUP BY: card, CPU and numpy differ at 2^16 rows")
    log(f"[parity] wide-string GROUP BY 2^16 rows: {len(a)} rows, card == CPU == numpy")
    parity_zones()
    parity_write()
    parity_statements()
    parity_files()
    parity_spill()


def timed_main_args(results: dict) -> dict:
    """Each kind of join-path call timed on the largest arguments the
    main path gave it: the probe's bounds, the expansion's run owners and
    the flat gather."""
    args = results.get("main_args", {})
    out = {}
    if args.get("bounds"):
        out["bounds"] = check_bounds("main path, most queries", *args["bounds"], iters=20)
    if args.get("bounds_largest_build"):
        out["bounds_largest_build"] = check_bounds(
            "main path, largest build", *args["bounds_largest_build"], iters=20)
    if args.get("run_owner"):
        out["run_owner"] = check_run_owner("main path", *args["run_owner"], iters=20)
    if args.get("take_flat"):
        out["take_flat"] = check_take_flat("main path", *args["take_flat"], iters=20)
    # UNNEST's and the array functions' largest (phase nested)
    if args.get("run_owner_nested"):
        out["run_owner_nested"] = check_run_owner("nested, largest", *args["run_owner_nested"],
                                                  iters=20)
    if args.get("take_flat_nested"):
        out["take_flat_nested"] = check_take_flat("nested, largest", *args["take_flat_nested"],
                                                  iters=20)
    # TPC-H's, the TPC-DS templates' and q72's own largest arguments
    for fam in ("tpch", "tpcds", "q72"):
        b, o, f = args.get(fam) or (None, None, None)
        if b:
            out[f"bounds_{fam}"] = check_bounds(f"{fam}, largest", *b, iters=20)
        if o:
            out[f"run_owner_{fam}"] = check_run_owner(f"{fam}, largest", *o, iters=20)
        if f:
            out[f"take_flat_{fam}"] = check_take_flat(f"{fam}, largest", *f, iters=20)
    for name, rec in out.items():
        flat = f"sectors={rec['sectors']} " if name.startswith("take_flat") else ""
        log(f"[kernel] {name} main-path arguments: n={rec.get('n_a', rec.get('n'))} "
            f"n_b={rec.get('n_b', rec.get('n_table'))} {flat}"
            f"ms={rec['ms']} warm_ms={rec['warm_ms']} wrapper_ms={rec['wrapper_ms']} "
            f"plain_ms={rec['plain_ms']} "
            f"library_ms={rec['library_ms']} "
            f"bound_us={rec['bound_ms'] * 1e3} ({rec['bound_by']})")
    results["main_arg_join_timings"] = out
    return out


def mode_record(rec: dict, launches: int) -> dict:
    """The numbers of one timed record, as the `kernels` line shows them."""
    return {"launches": launches, "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"), "wrapper_ms": rec.get("wrapper_ms"),
            "warm_ms": rec.get("warm_ms"),
            "shape": {k: v for k, v in rec.items()
                      if k in ("n_a", "n_b", "n", "n_table", "rows", "width", "dtype",
                               "k", "capacity", "live_rows", "sectors")}}


def family_modes(results: dict, on_path: dict, kernels) -> dict:
    """Per kernel, a record on the TPC-DS templates' and on q72's own
    largest arguments, with the launches of those queries, and one on
    phase nested's largest with that phase's launches."""
    main = results.get("main", {})
    out = {}
    nested = results.get("nested_launches", {})
    for k in kernels:
        if nested:
            out[f"{k}_nested"] = mode_record(on_path.get(f"{k}_nested", {}), nested.get(k, 0))
    for fam, pick in (("tpch", lambda q: q in TPCH_RUNS),
                      ("tpcds", lambda q: q.startswith("ds_q") and q != "ds_q72_cold"),
                      ("q72", lambda q: q == "ds_q72_cold")):
        for k in kernels:
            rec = on_path.get(f"{k}_{fam}")
            if rec:
                n = sum(run["launches"].get(k, 0) for q, run in main.items() if pick(q))
                out[f"{k}_{fam}"] = mode_record(rec, n)
    return out


# the phases whose launches count apart from the main path's
PHASE_LAUNCHES = ("nested", "zones", "write", "statements", "files", "spill", "distributed",
                  "wire")


def kernels_line(results: dict) -> dict:
    checks = results.get("grouped_sum_checks", {})
    timed = checks.get("q_mxu_sf1", {})
    # time again on the main path's own arguments at each shape it gave
    # the kernel, beside inputs of that shape with ids spread evenly;
    # the line reports the query's own data at the largest shape
    captured = results.get("main_args", {}).get("grouped_sum", {})
    by_shape = {}
    for i, (n, k, cap) in enumerate(results.get("main_shapes", [])):
        rec = check_grouped_sum(n=n, k=k, capacity=cap, seed=7 + i, iters=20,
                                args=captured[(n, k, cap)][:3])
        even = check_grouped_sum(n=n, k=k, capacity=cap, seed=7 + i, iters=20)
        log(f"[kernel] grouped_sum main-path arguments n={n} k={k} "
            f"capacity={cap}: {timing_text(rec)}")
        log(f"[kernel] grouped_sum same shape, ids spread evenly: "
            f"{timing_text(even)}")
        results.setdefault("main_arg_timings", []).append(
            {"main_path": rec, "even_ids": even})
        by_shape[(n, k, cap)] = rec
    # per query that launched it: its launches, and the timing at the
    # largest arguments it gave the kernel (Q-MXU's is the entry's own)
    modes = {}
    for q in ("q_mxu", "q_mxj", "widestr"):
        run = results.get("main", {}).get(f"{q}_cold", {})
        shapes = [tuple(x) for x in run.get("grouped_sum_shapes", [])]
        rec = by_shape.get(max(shapes), {}) if shapes else {}
        modes[q] = mode_record(rec, run.get("launches", {}).get("grouped_sum", 0))
        if q == "q_mxu" and rec:
            timed = rec
    launches = results.get("main_launches", {})
    line = [{
        "name": "grouped_sum",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/grouped_sum.cu",
        "replaces": "trino_tpu/ops/mxu_groupby.py:77",
        "launches": launches.get("grouped_sum", 0),
        "max_abs_err": max(
            [c["max_abs_err"] for c in checks.values()]
            + [t["main_path"]["max_abs_err"]
               for t in results.get("main_arg_timings", [])], default=0),
        "ms": timed.get("ms"),
        "plain_ms": timed.get("plain_ms"),
        "bound_ms": timed.get("bound_ms"),
        "bound_by": timed.get("bound_by"),
        "library_ms": timed.get("library_ms"),
        "shape": {"n": timed.get("n"), "k": timed.get("k"),
                  "capacity": timed.get("capacity")},
        "modes": modes,
    }]
    for phase in PHASE_LAUNCHES:
        if f"{phase}_launches" in results:
            line[0][f"{phase}_launches"] = results[f"{phase}_launches"].get("grouped_sum", 0)
    join_checks = results.get("join_kernel_checks", {})
    on_path = timed_main_args(results)
    explore_launches = results.get("explore_launches", {})
    for name, (source, replaces) in NEW_KERNELS.items():
        recs = join_checks.get(name, [])
        modes = None
        if name == "window_rank":
            # one source, three entry points: the probe's bounds (the
            # entry's own numbers), the expansion's run owners, and rank
            # (searched: the probe shape of phase kernel; fixed: the
            # explorer's k0, launched by phase explore)
            timed = {m: next((c for c in recs if c.get("mode") == m and "ms" in c), {})
                     for m in ("searched", "fixed")}
            modes = {
                **family_modes(results, on_path, ("bounds", "run_owner")),
                "bounds": mode_record(on_path.get("bounds", {}), launches.get("bounds", 0)),
                "bounds_largest_build": mode_record(on_path.get("bounds_largest_build", {}),
                                                    launches.get("bounds", 0)),
                "run_owner": mode_record(on_path.get("run_owner", {}),
                                         launches.get("run_owner", 0)),
                "searched": mode_record(timed["searched"], launches.get("window_rank", 0)),
                "fixed": mode_record(timed["fixed"], explore_launches.get("window_rank", 0)),
            }
            recs = recs + [on_path[m] for m in on_path
                           if m.startswith(("bounds", "run_owner"))]
            rec = on_path.get("bounds", {})
            n = sum(launches.get(m, 0) for m in ("window_rank", "bounds", "run_owner"))
        elif name in on_path:
            # the join path: its own largest arguments and its launches
            rec, n = on_path[name], launches.get(name, 0)
            recs = recs + [rec] + [on_path[m] for m in on_path if m.startswith(f"{name}_")]
            modes = family_modes(results, on_path, (name,))
        else:
            # the explorer entry point is this kernel's only path
            rec = next((c for c in recs if "ms" in c), {})
            n = explore_launches.get(name, 0)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "max_abs_err": max([c["max_abs_err"] for c in recs], default=None),
                 **mode_record(rec, n)}
        for phase in PHASE_LAUNCHES:
            # these phases count apart from the main path
            if f"{phase}_launches" in results:
                got = results[f"{phase}_launches"]
                entry[f"{phase}_launches"] = (
                    sum(got.get(m, 0) for m in ("window_rank", "bounds", "run_owner"))
                    if name == "window_rank" else got.get(name, 0))
        if modes:
            entry["modes"] = modes
        if name == "take_flat" and "take_flat_main_path" in results:
            entry["main_path"] = results["take_flat_main_path"]
        line.append(entry)
    return {"kernels": line}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="identity,build,kernel,main,nested,zones,write,statements,"
                            "files,spill,distributed,wire,explore,parity",
                    help="comma-separated subset of the phases to run")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from trino_tpu_torch.ops import cuda_build

    results: dict = {}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[identity] nvidia-smi: {card}")
    log(f"[identity] torch: {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    cuda_build.build_all()  # one nvcc per source, all started together
    log(f"[build] {', '.join(f'{n}.cu' for n in cuda_build.SOURCES)} built "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, text in cuda_build.PTXAS_LOG.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")
    from trino_tpu_torch.explore import atomic_opcodes

    results["sass_atomics"] = {n: atomic_opcodes(cuda_build.library_path(n))
                               for n in cuda_build.SOURCES}
    for name, ops in results["sass_atomics"].items():
        log(f"[build] {name} SASS atomics: {ops}")
    if "kernel" in phases:
        phase_kernel(results)
        phase_kernel_join(results)
    if "main" in phases:
        phase_main(results)
    if "nested" in phases:
        phase_nested(results)
    if "zones" in phases:
        phase_zones(results)
    if "write" in phases:
        phase_write(results)
    if "statements" in phases:
        phase_statements(results)
    if "files" in phases:
        phase_files(results)
    if "spill" in phases:
        phase_spill(results)
    if "distributed" in phases:
        phase_distributed(results)
    if "wire" in phases:
        phase_wire(results)
    if "explore" in phases:
        phase_explore(results)
    if "parity" in phases:
        phase_parity(results)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    line = kernels_line(results)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        results.pop("main_args", None)
        json.dump({"card": card, **results, **line}, fh, indent=1, default=str)
    log(f"[summary] phases {sorted(phases)} took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

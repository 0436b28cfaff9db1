"""TIMESTAMP WITH TIME ZONE: trino_tpu_torch (device="cpu") against
trino_tpu on the same inputs.

- ops/tz.py: the zone registry round trip over every id, the TZif rules,
  packing, the host helpers, and the device functions bit-equal to the
  reference's on seeded instants over every zone id (out-of-range ids
  included), with instants exactly at and one millisecond before
  transitions and around 1900, 1970 and 2037. `offset_millis_rowwise`
  makes no temporary larger than its input (the flat binary search; the
  reference gathers a zones x longest-zone row per input row).
- SQL: every case of tests/test_timestamptz.py, equal rows. The port has
  no CREATE TABLE or INSERT yet, so its tables are loaded with
  `load_table` (chip_smoke.TSTZ_TABLES, the packed values the literals
  parse to) and its session set directly; the reference makes its tables
  with its own CREATE TABLE and INSERT, as tests/test_timestamptz.py
  does. The SQL is inline in those tests, so chip_smoke.py lists it
  (TSTZ_SQL, each with a comment naming the test) for its card-against-
  CPU check, and it is imported here.
- The zone queries of chip_smoke.py's phase zones at tpch.tiny.
"""

import datetime as dt
from zoneinfo import ZoneInfo

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as CS
from tests.test_timestamptz import NY
from trino_tpu.connectors.memory import create_memory_connector as jmemory
from trino_tpu.connectors.tpch import create_tpch_connector as jtpch
from trino_tpu.engine import LocalQueryRunner as JRunner
from trino_tpu.engine import Session as JSession
from trino_tpu.ops import tz as JTZ
from trino_tpu_torch.ops import tz as TZ

N_IDS = TZ._NAMED_BASE + len(TZ._named_zones())
UTC = TZ.UTC_ID

# ---- ops/tz.py ---------------------------------------------------------------


def test_registry_round_trip_over_every_id():
    assert TZ._named_zones() == JTZ._named_zones()
    for zid in list(range(0, 1682)) + list(range(TZ._NAMED_BASE, N_IDS)):
        name = TZ.zone_name(zid)
        assert name == JTZ.zone_name(zid)
        # +00:00 (id 841) and GMT, UT and the like name UTC, id 0
        assert TZ.zone_id(name) == JTZ.zone_id(name) in (zid, UTC)
    for zid in (1682, 1799, N_IDS, -1):
        with pytest.raises(ValueError):
            TZ.zone_name(zid)
    for name in ("Z", "gmt", "+0530", "-08", "+14:00", " Europe/London "):
        assert TZ.zone_id(name) == JTZ.zone_id(name)
    for name in ("+14:01", "Mars/Olympus"):
        with pytest.raises(ValueError):
            TZ.zone_id(name)


def test_zone_rules_equal_the_reference_for_every_zone():
    for zid in [0, 1, 841, 1681] + list(range(TZ._NAMED_BASE, N_IDS)):
        (t, o), (jt, jo) = TZ.zone_rules(zid), JTZ.zone_rules(zid)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(o, jo)


def _instants(seed: int, n: int) -> np.ndarray:
    """Seeded instants (ms): uniform over 1850-2100, every tenth one at a
    transition of the flat table or a millisecond before it, and a band
    around each of 1900, 1970 and 2037."""
    rng = np.random.default_rng(seed)
    lo = int(dt.datetime(1850, 1, 1, tzinfo=dt.timezone.utc).timestamp() * 1000)
    hi = int(dt.datetime(2100, 1, 1, tzinfo=dt.timezone.utc).timestamp() * 1000)
    inst = rng.integers(lo, hi, n).astype(np.int64)
    trans = TZ._zone_flat()[0]
    k = n // 10
    inst[:k] = rng.choice(trans, k)
    inst[k:2 * k] = rng.choice(trans, k) - 1
    for i, year in enumerate((1900, 1970, 2037)):
        mid = int(dt.datetime(year, 1, 1, tzinfo=dt.timezone.utc).timestamp() * 1000)
        band = slice((2 + i) * k, (3 + i) * k)
        inst[band] = mid + rng.integers(-400 * 86_400_000, 400 * 86_400_000, k)
    return inst


def _zone_ids(seed: int, n: int) -> np.ndarray:
    """Every id of the registry's range and beyond it on each side, then
    random ones, n in all."""
    rng = np.random.default_rng(seed)
    every = np.arange(-5, N_IDS + 5)
    return np.concatenate([every, rng.integers(-50, N_IDS + 50, n - len(every))]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_rowwise_functions_bit_equal_over_every_zone_id(seed):
    n = 16_384
    inst, zids = _instants(seed, n), _zone_ids(seed, n)
    for fn in ("offset_millis_rowwise", "wall_to_instant_rowwise"):
        want = np.asarray(getattr(JTZ, fn)(jnp.asarray(inst), jnp.asarray(zids)))
        got = getattr(TZ, fn)(torch.from_numpy(inst), torch.from_numpy(zids))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)


def test_static_zone_functions_bit_equal():
    inst = _instants(2, 8192)
    for name in ("UTC", "+05:30", "-08:00", NY, "Asia/Tokyo", "Europe/London",
                 "Australia/Lord_Howe", "Pacific/Chatham"):
        zid = TZ.zone_id(name)
        for fn in ("offset_millis_at", "wall_to_instant_millis"):
            want = np.asarray(getattr(JTZ, fn)(jnp.asarray(inst), zid))
            got = getattr(TZ, fn)(torch.from_numpy(inst), zid).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{fn} {name}")


class _LargestOutput(TorchDispatchMode):
    """The largest tensor any op makes while it is entered."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_rowwise_offset_makes_no_temporary_larger_than_its_input():
    n = 4096
    inst = torch.from_numpy(_instants(3, n))
    zids = torch.from_numpy(_zone_ids(3, n))
    TZ.offset_millis_rowwise(inst[:1], zids[:1])  # the flat table, once
    longest = int(TZ._zone_flat()[3].max())
    assert longest > 100  # the reference's per-row matrix rows are this wide
    with _LargestOutput() as mode:
        TZ.offset_millis_rowwise(inst, zids)
    assert mode.largest == n


def test_packing_and_host_helpers_equal_the_reference():
    inst = _instants(4, 64)
    zids = np.abs(_zone_ids(4, N_IDS + 10)[-64:]) % 1682
    packed = TZ.pack(torch.from_numpy(inst), 1970)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JTZ.pack(jnp.asarray(inst), 1970)))
    np.testing.assert_array_equal(TZ.unpack_millis(packed).numpy(), inst)
    assert (TZ.unpack_zone(packed).numpy() == 1970).all()
    for ms, zid in zip(inst.tolist(), zids.tolist()):
        assert TZ.pack_py(ms, zid) == JTZ.pack_py(ms, zid)
        assert TZ.offset_millis_py(zid, ms) == JTZ.offset_millis_py(zid, ms)
        assert TZ.format_tstz(TZ.pack_py(ms, zid)) == JTZ.format_tstz(JTZ.pack_py(ms, zid))
    texts = ["2024-03-10 02:30:00 America/New_York", "2024-11-03 01:30:00 America/New_York",
             "2024-07-04T12:00:00Z", "2024-07-04 12:00:00+05:30", "1969-12-31 23:59:59.999 UTC",
             "1900-01-01 00:00:00 Europe/London", "2037-06-01 12:00:00 -0800",
             "2024-07-04 12:00:00", "not a time", "2024-07-04 12:00:00 Mars/Olympus"]
    for s in texts:
        assert TZ.literal_has_zone(s) == JTZ.literal_has_zone(s), s
        assert TZ._split_zone(s) == JTZ._split_zone(s), s
        assert TZ.parse_tstz(s, NY) == JTZ.parse_tstz(s, NY), s


def test_offsets_match_zoneinfo_at_the_dst_edges():
    # tests/test_timestamptz.py::TestZoneDb's instants, read on the device
    zid = TZ.zone_id(NY)
    isos = ["2024-03-10 06:59:59", "2024-03-10 07:00:00", "2024-11-03 05:59:59",
            "2024-11-03 06:00:00", "1975-06-01 00:00:00", "2035-12-25 12:00:00"]
    ds = [dt.datetime.fromisoformat(s).replace(tzinfo=dt.timezone.utc) for s in isos]
    ms = torch.tensor([int(d.timestamp() * 1000) for d in ds])
    want = [int(d.astimezone(ZoneInfo(NY)).utcoffset().total_seconds() * 1000) for d in ds]
    assert TZ.offset_millis_at(ms, zid).tolist() == want
    assert TZ.offset_millis_rowwise(ms, torch.full((6,), zid)).tolist() == want


# ---- SQL ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def runners():
    """{schema: (port runner, reference runner)}; the reference's tables
    come from tests/test_timestamptz.py's own CREATE TABLE and INSERT."""
    j = JRunner(JSession(catalog="memory", schema="t", timezone=NY))
    j.register_catalog("memory", jmemory())
    # TestEngineIntegration.rt
    j.execute("create table memory.t.ev (ts timestamp with time zone, v bigint)")
    j.execute("insert into ev values "
              f"(timestamp '2024-03-10 01:59:00 {NY}', 1), "
              f"(timestamp '2024-03-10 03:00:00 {NY}', 2), "
              f"(timestamp '2024-03-10 03:00:00 {NY}', 3), "
              "(null, 4)")
    jz = JRunner(JSession(catalog="memory", schema="z"))
    jz.register_catalog("memory", jmemory())
    # TestMixedZoneKeys.rz and test_join_matches_across_zones
    jz.execute("create table mz (ts timestamp with time zone, v bigint)")
    jz.execute("insert into mz values"
               " (TIMESTAMP '2024-03-10 01:59:00 America/New_York', 1),"
               " (TIMESTAMP '2024-03-10 06:59:00 UTC', 2),"
               " (TIMESTAMP '2024-03-10 07:59:00 UTC', 5)")
    jz.execute("create table mu (ts timestamp with time zone, w bigint)")
    jz.execute("insert into mu values (TIMESTAMP '2024-03-10 06:59:00 UTC', 77)")
    return {"t": (CS.tstz_runner("t", "cpu"), j), "z": (CS.tstz_runner("z", "cpu"), jz)}


@pytest.mark.parametrize("schema,sql", CS.TSTZ_SQL,
                         ids=[f"{i}-{s}" for i, (s, _) in enumerate(CS.TSTZ_SQL)])
def test_corpus_equals_the_reference(runners, schema, sql):
    port, ref = runners[schema]
    got, want = port.execute(sql), ref.execute(sql)
    assert got.rows == want.rows
    assert got.column_types == want.column_types or [str(t) for t in got.column_types] == [
        str(t) for t in want.column_types]


def test_timestamp_literal_answers(runners):
    port, ref = runners["z"]
    sql = "select timestamp '2024-01-01 00:00:00'"
    assert port.execute(sql).rows == ref.execute(sql).rows == [[1_704_067_200_000_000]]


def test_now_is_in_the_session_zone(runners):
    # tests/test_timestamptz.py::TestEngineIntegration::test_now_is_tstz
    port, ref = runners["t"]
    got, want = port.execute(CS.TSTZ_NOW).rows[0][0], ref.execute(CS.TSTZ_NOW).rows[0][0]
    assert got.endswith(NY) and want.endswith(NY)
    assert abs(dt.datetime.fromisoformat(got[:23]) - dt.datetime.fromisoformat(want[:23])) \
        < dt.timedelta(minutes=5)


def test_optimizer_off_same_answers(runners):
    # TestMixedZoneKeys::test_optimizer_off_same_answers (SET SESSION in
    # the reference; the port's Session field directly)
    port, ref = runners["z"]
    sql = "select ts, sum(v) from mz group by ts order by 2"
    ref.execute("SET SESSION enable_optimizer = false")
    port.session.enable_optimizer = False
    try:
        got, want = port.execute(sql).rows, ref.execute(sql).rows
    finally:
        ref.execute("SET SESSION enable_optimizer = true")
        port.session.enable_optimizer = True
    assert got == want and len(got) == 2 and sorted(x[1] for x in got) == [3, 5]


def test_extract_hour_from_date_raises_in_both(runners):
    # TestCoercionAndFunctions::test_extract_hour_from_date_rejected
    port, ref = runners["t"]
    sql = "select extract(hour from date '2024-01-01')"
    with pytest.raises(Exception):
        ref.execute(sql)
    with pytest.raises(Exception):
        port.execute(sql)


def test_comparison_strips_the_zone_with_an_arithmetic_shift(runners):
    # instants before 1970 are negative: the shift must keep the sign
    port, ref = runners["z"]
    sql = ("select timestamp '1969-12-31 23:59:59.999 UTC' < timestamp '1970-01-01 00:00:00 UTC',"
           " timestamp '1900-01-01 00:00:00 UTC' = timestamp '1899-12-31 19:00:00 -05:00',"
           " timestamp '1960-06-01 12:00:00 Asia/Tokyo' > timestamp '1960-06-01 12:00:00 UTC',"
           " cast(timestamp '1950-03-04 05:06:07.089 Europe/London' as varchar)")
    assert port.execute(sql).rows == ref.execute(sql).rows == [
        [True, True, False, "1950-03-04 05:06:07.089 Europe/London"]]


# ---- the phase's zone queries at tiny ----------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The port and reference over tpch.tiny, each with the day table."""
    port = CS.zones_runner("tiny", "cpu")
    from trino_tpu import types as JT
    from trino_tpu.connectors.spi import ColumnMetadata as JColumnMetadata

    ref = JRunner(JSession(catalog="tpch", schema="tiny"))
    ref.register_catalog("tpch", jtpch())
    conn = jmemory()
    CS.zones_load_days(conn, JT, JColumnMetadata, "tiny")
    ref.register_catalog("memory", conn)
    return port, ref


@pytest.mark.parametrize("name", ["tz_dst", "tz_mixed", "tz_mixed_check", "tz_trunc", "tz_join"])
def test_zone_queries_equal_the_reference_at_tiny(tiny, name):
    port, ref = tiny
    sql = dict(CS.ZONE_QUERIES)[name]
    assert port.execute(sql).rows == ref.execute(sql).rows


def test_zone_query_identities_at_tiny(tiny):
    port, _ = tiny
    rows = {name: port.execute(sql).rows for name, sql in CS.ZONE_QUERIES if name.startswith("tz")}
    CS.check_zones(rows, CS.orders_dates("tiny"), n_orders=15_000)


def test_case_and_coalesce_over_zoned_values_type_as_bigint(runners):
    # reference fault (ROADMAP §3): the reference's _unify_types has no
    # temporal branch, so CASE and COALESCE over TIMESTAMP WITH TIME ZONE
    # type as bigint and its plan validation refuses the plan. The port's
    # keep the type (its plan validation passes them) and answer the
    # zoned values
    port, ref = runners["z"]
    sql = ("select coalesce(ts, timestamp '2024-01-01 00:00:00 UTC'),"
           " case when v > 1 then ts end from mz order by v")
    with pytest.raises(Exception, match="typed timestamp with time zone, node typed bigint"):
        ref.execute(sql)
    got = port.execute(sql)
    assert [t.kind.name for t in got.column_types] == ["TIMESTAMP_TZ", "TIMESTAMP_TZ"]
    assert got.rows[0] == ["2024-03-10 01:59:00.000 America/New_York", None]
    assert got.rows[1][1] == got.rows[1][0]  # v > 1: the case takes ts


# GREATEST, LEAST and ARRAY literals keep the reference's typing: only
# CASE, IF and COALESCE keep one temporal type (ROADMAP §3)
SAME_TYPING_SQL = (
    "select greatest(ts, timestamp '2024-03-10 07:00:00 UTC') from mz order by v",
    "select least(ts, timestamp '2024-03-10 07:00:00 UTC'), v from mz order by v",
    "select greatest(timestamp '2024-01-01 00:00:00', timestamp '2024-01-02 00:00:00')",
    "select least(timestamp '2024-01-01 00:00:00', timestamp '2024-01-02 00:00:00')",
    "select greatest(interval '1' year, interval '2' month)",
    "select least(interval '1' day, interval '2' hour)",
    "select array[timestamp '2024-01-01 00:00:00', timestamp '2024-01-02 00:00:00']",
    "select array[timestamp '2024-01-01 00:00:00 UTC']",
    "select array[interval '1' day, interval '2' hour]",
)


@pytest.mark.parametrize("sql", SAME_TYPING_SQL)
def test_greatest_least_and_array_literals_type_as_the_reference(runners, sql):
    port, ref = runners["z"]
    try:
        want = ref.execute(sql)
    except Exception as e:
        with pytest.raises(Exception) as got:
            port.execute(sql)
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        return
    got = port.execute(sql)
    assert got.rows == want.rows
    assert [str(t) for t in got.column_types] == [str(t) for t in want.column_types]


def test_gap_and_overlap_resolve_by_two_offset_reads_in_both():
    # a deviation from Trino the reference documents and the port keeps
    # (ROADMAP §3): a wall time is read as an instant, corrected by the
    # offset there, and corrected again by the offset at that instant.
    # In New York's spring-forward gap 02:30 resolves to 06:30 UTC (01:30
    # EST; Trino shifts forward to 03:30 EDT, 07:30 UTC). In an overlap
    # the result depends on the zone's side of UTC: New York's 01:30
    # resolves to the first occurrence (EDT, 05:30 UTC, as Trino), Berlin's
    # 02:30 to the second (CET, 01:30 UTC; Trino takes CEST, 00:30 UTC).
    for zone, wall, want_utc in (
            (NY, "2024-03-10 02:30:00", "2024-03-10 06:30:00"),
            (NY, "2024-11-03 01:30:00", "2024-11-03 05:30:00"),
            ("Europe/Berlin", "2024-10-27 02:30:00", "2024-10-27 01:30:00")):
        zid = TZ.zone_id(zone)
        packed = TZ.parse_tstz(f"{wall} {zone}")
        assert packed == JTZ.parse_tstz(f"{wall} {zone}")
        utc = dt.datetime.fromtimestamp((packed >> TZ.MILLIS_SHIFT) / 1000, dt.timezone.utc)
        assert utc.strftime("%Y-%m-%d %H:%M:%S") == want_utc
        wall_ms = int(dt.datetime.fromisoformat(wall).replace(tzinfo=dt.timezone.utc)
                      .timestamp() * 1000)
        for fn in (lambda w: TZ.wall_to_instant_millis(w, zid),
                   lambda w: TZ.wall_to_instant_rowwise(w, torch.tensor([zid], dtype=torch.int32))):
            assert fn(torch.tensor([wall_ms])).tolist() == [packed >> TZ.MILLIS_SHIFT]

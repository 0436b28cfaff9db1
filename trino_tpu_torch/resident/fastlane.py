"""The serving fast lane over pinned resident tables.

Counterpart of trino_tpu/resident/fastlane.py. `try_resident_lookup`
sits in front of the ordinary execute path on the coordinator server:
it takes the micro-batcher's STRICT point-lookup classifier, and when
the probed table is named in the `resident_tables` session property it
serves the lookup from a pinned `ResidentTable`: a probe on the device,
nothing rebuilt, no plan-cache or scheduler work. A miss (first touch,
or a generation bump from DML) builds the table with ONE scan through
the ordinary execute path, pins it under the current generation
snapshot, and serves from the pin thereafter.

Declines are typed, each with its counter, and return None so the
caller takes the cold path:
- the session names no resident table, or not this one;
- the statement is not a point lookup (the classifier says None);
- a selected column is nested (`resident.skips_nested`);
- the key column's type is not the literal's kind: an integer column
  under an integer literal, VARCHAR under a string one
  (`resident.skips_key_type`);
- a key's fanout passes the probe rung (`resident.skips_fanout`);
and the budget refusing the pin serves this one lookup from the
transient build, pinning nothing (`resident.skips`). Any other error
propagates. The reference turns every exception of the build, the
write tap and compaction into the cold path; on the card that would
hide a device or kernel failure behind a cold execution, so the port
does not (as its mesh arm does not, ROADMAP §3).

Writes (`table_written`, from the engine's invalidation): an autocommit
INSERT whose rows a `DeltaTap` captured appends to the pinned table's
delta side and RE-KEYS the entry under the table's new generation (the
pin stays warm); UPDATE/DELETE/MERGE/DDL evict (DROP TABLE too: the
reference's `table_dropped`, which nothing calls, is left out), and so
does an insert
whose tap was poisoned (a batch it could not read), so a pin never keeps
bad data. Once the delta crosses half its budget a background
compaction (one worker thread, never the query's) folds it into the
base at a ladder rung.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.resident.manager import GENERATIONS, RESIDENT, table_key
from trino_tpu_torch.resident.table import ResidentTable
from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.witness import named_lock

_lock = named_lock("fastlane._lock")
# compactions run one at a time
_compaction_lock = named_lock("fastlane._compaction_lock")
_pending_compactions: List = []


def _resolve_table(table_sql: str, session) -> Tuple[str, str, str]:
    parts = table_sql.split(".")
    cat, schema = session.catalog, session.schema
    if len(parts) == 2:
        schema = parts[0]
    elif len(parts) == 3:
        cat, schema = parts[0], parts[1]
    return table_key(cat, schema, parts[-1])


def _configured(tkey: Tuple[str, str, str], session) -> bool:
    names = [t.strip().lower() for t in str(session.resident_tables or "").split(",")
             if t.strip()]
    cat, schema, table = tkey
    return (table in names or f"{schema}.{table}" in names
            or f"{cat}.{schema}.{table}" in names)


def _full_key(tkey, key_col, select_sql, dkind, sig, rung, gen) -> Tuple:
    # convention: the generation snapshot is always the LAST component
    return ("fastlane", tkey, key_col, select_sql, dkind, sig, rung, gen)


def _index_key(tkey, key_col, select_sql, dkind) -> Tuple:
    return ("fastlane", tkey, key_col, select_sql, dkind)


def _result(rows, names, types):
    from trino_tpu_torch.engine import MaterializedResult

    return MaterializedResult(rows, list(names), list(types))


def try_resident_lookup(runner, sql: str, identity=None, prepared=None,
                        query_span=None):
    """A MaterializedResult from a pinned table, or None: the cold path."""
    from trino_tpu_torch.runtime.metrics import METRICS

    session = getattr(runner, "session", None)
    if session is None or not getattr(session, "resident_tables", ""):
        return None
    from trino_tpu_torch.serving.batcher import classify

    look = classify(sql, runner=runner, prepared=prepared)
    if look is None:
        return None
    tkey = _resolve_table(look.table_sql, session)
    if not _configured(tkey, session):
        return None
    dkind = look.group_key[3]
    ikey = _index_key(tkey, look.key_col, look.select_sql, dkind)
    gen = GENERATIONS.snapshot([tkey])

    # access control on every lookup, pinned or not: a pin is never a
    # bypass
    ac = getattr(runner, "access_control", None)
    if ac is not None:
        from trino_tpu_torch.security import Identity

        ident = identity or Identity(session.user)
        cols = [look.key_col] + [c.strip() for c in look.select_sql.split(",")]
        ac.check_can_select(ident, *tkey, cols)

    found = RESIDENT.find(ikey)
    if found is not None:
        key, table = found
        if key[-1] == gen and isinstance(table, ResidentTable):
            rows = table.probe(look.value)
            if rows is None:
                METRICS.increment("resident.skips_fanout")
                return None
            RESIDENT.lookup(key)  # counts the hit, touches the LRU
            if query_span is not None:
                query_span.event("resident_hit", table=".".join(tkey))
            return _result(rows, table.names, table.types)
        # a stale generation the invalidation missed (an epoch bump):
        # reclaim the pin and rebuild below
        RESIDENT.evict(key)
    RESIDENT.note_miss()
    return _build_and_probe(runner, session, look, tkey, ikey, gen, dkind, identity,
                            query_span)


def _build_and_probe(runner, session, look, tkey, ikey, gen, dkind, identity, query_span):
    from trino_tpu_torch.runtime.metrics import METRICS

    # nested select columns have no scalar device layout to pin against
    # (the census's [nested] rule), and a key is pinned only where its
    # column's type is the literal's kind: each a counted decline
    decline = _ineligible(runner, tkey, look, dkind)
    if decline is not None:
        METRICS.increment(decline)
        return None
    oracle_sql = f"SELECT {look.key_col}, {look.select_sql} FROM {look.table_sql}"
    kwargs = {"identity": identity} if identity is not None else {}
    result = runner.execute(oracle_sql, **kwargs)
    names = list(result.column_names[1:])
    types = list(result.column_types[1:])
    table = ResidentTable(
        look.key_col, names, types,
        [r[0] for r in result.rows], [r[1:] for r in result.rows],
        string_key=(dkind == "s"),
        delta_max_rows=int(session.resident_delta_max_rows),
        device=_device_of(runner),
    )
    RESIDENT.configure(int(session.resident_pin_budget_mb) << 20)
    key = _full_key(tkey, look.key_col, look.select_sql, dkind, table.dtype_sig,
                    table.base_cap, gen)
    pinned = RESIDENT.pin(key, table, table.device_bytes, [tkey], index_key=ikey)
    if not pinned:
        # the budget refused the pin: serve this one lookup from the
        # transient build; nothing stays pinned
        METRICS.increment("resident.skips")
    rows = table.probe(look.value)
    if rows is None:
        METRICS.increment("resident.skips_fanout")
        return None
    if query_span is not None:
        query_span.event("resident_build", table=".".join(tkey), pinned=pinned)
    return _result(rows, names, types)


def _device_of(runner):
    """The device the runner's queries run on."""
    device = getattr(runner, "device", None)
    if device is None:
        raise TypeError(f"{type(runner).__name__} names no device for a resident pin")
    return device


_KEY_KINDS = {
    "i": (T.TypeKind.TINYINT, T.TypeKind.SMALLINT, T.TypeKind.INTEGER, T.TypeKind.BIGINT),
    "s": (T.TypeKind.VARCHAR,),
}


def _ineligible(runner, tkey, look, dkind) -> Optional[str]:
    """The counter of the decline that applies, or None. A selected
    column that is nested (sql/validate.nested_column_types, the
    census's predicate) declines as `resident.skips_nested`; a key
    column that is not an integer column under an integer literal, or
    a VARCHAR column under a string literal, as `resident.skips_key_type`
    (a DOUBLE key would truncate, a CHAR key compares padded). An
    unknown table or catalog is left to the build's query, which raises
    its own error."""
    from trino_tpu_torch.sql.validate import nested_column_types

    catalogs = getattr(runner, "catalogs", None)
    if catalogs is None or tkey[0] not in catalogs.catalogs():
        return None
    conn = catalogs.get(tkey[0])
    handle = conn.metadata.get_table_handle(tkey[1], tkey[2])
    if handle is None:
        return None
    types = {c.name.lower(): c.type for c in conn.metadata.get_table_metadata(handle).columns}
    wanted = {c.strip().lower() for c in look.select_sql.split(",")}
    if nested_column_types([t for n, t in types.items() if n in wanted]):
        return "resident.skips_nested"
    key_type = types.get(look.key_col.lower())
    if key_type is not None and key_type.kind not in _KEY_KINDS[dkind]:
        return "resident.skips_key_type"
    return None


# -- the write path ------------------------------------------------------


class DeltaTap:
    """Captures the host rows of one INSERT as they stream into the
    connector sink (the engine tees its page sink through this)."""

    def __init__(self, names: List[str]):
        self.names = [n.lower() for n in names]
        self.rows: Optional[List[list]] = []

    def add_batch(self, batch) -> None:
        self.rows.extend(batch.to_pylists())


class TeeSink:
    """Connector-sink wrapper feeding a DeltaTap (the append/finish
    surface of both plain page sinks and ScaledWriterSink)."""

    def __init__(self, inner, tap: DeltaTap):
        self._inner = inner
        self._tap = tap

    def append(self, batch) -> None:
        if self._tap.rows is not None:
            try:
                self._tap.add_batch(batch)
            except (TypeError, ValueError):
                # a batch the tap cannot read poisons it: the pin is
                # evicted after the write, never fed partial rows
                self._tap.rows = None
        self._inner.append(batch)

    def finish(self) -> int:
        return self._inner.finish()


def delta_tap(catalog: str, schema: str, table: str, column_names) -> Optional[DeltaTap]:
    """A tap when a pinned entry could absorb this table's insert;
    None leaves the write path untouched."""
    if not RESIDENT.entries_for(table_key(catalog, schema, table)):
        return None
    return DeltaTap(list(column_names))


def table_written(catalog: str, schema: str, table: str, appended: bool = False,
                  tap: Optional[DeltaTap] = None) -> None:
    """Called after a write and after its generation bump: an append
    with captured rows rides the delta; anything else evicts. A delta
    append that raises evicts its pin before the error propagates."""
    tkey = table_key(catalog, schema, table)
    keys = RESIDENT.entries_for(tkey)
    if not keys:
        return
    new_gen = GENERATIONS.snapshot([tkey])
    for key in keys:
        t = RESIDENT.peek(key)
        if (appended and tap is not None and tap.rows is not None
                and isinstance(t, ResidentTable) and key[0] == "fastlane"):
            rows = _project(tap, t.key_col, t.names)
            if rows is not None and t.delta_room(len(rows)):
                try:
                    appended_rows = t.append_delta([r[0] for r in rows], [r[1:] for r in rows])
                except BaseException:
                    RESIDENT.evict(key)  # no pin outlives a write it missed
                    raise
                if appended_rows:
                    new_key = key[:-1] + (new_gen,)
                    RESIDENT.rekey(key, new_key)
                    RESIDENT.set_bytes(new_key, t.device_bytes)
                    if t.wants_compaction():
                        _schedule_compaction(new_key, t)
                    continue
        RESIDENT.evict(key)


def _project(tap: DeltaTap, key_col: str, value_names: List[str]) -> Optional[List[list]]:
    """Tap rows (the table's full schema) as [key, values...] in the
    resident table's column order; None when a column is missing."""
    pos = {n: i for i, n in enumerate(tap.names)}
    want = [key_col.lower()] + [n.lower() for n in value_names]
    if any(n not in pos for n in want):
        return None
    idxs = [pos[n] for n in want]
    return [[row[i] for i in idxs] for row in tap.rows]


# -- background compaction -------------------------------------------------


def _schedule_compaction(key: Tuple, table: ResidentTable) -> None:
    """Compact on a daemon thread (one at a time, never on the
    query's thread); its Future joins _pending_compactions."""
    from concurrent.futures import Future

    fut: Future = Future()

    def run():
        with _compaction_lock:
            try:
                _compact_one(key, table)
            except Exception as e:  # noqa: BLE001 - handed to the future
                fut.set_exception(e)
            else:
                fut.set_result(None)

    with _lock:
        _pending_compactions[:] = [f for f in _pending_compactions if not f.done()]
        _pending_compactions.append(fut)
    threadreg.spawn("trino-tpu-resident-compact", run, owner="ResidentManager")


def _compact_one(key: Tuple, table: ResidentTable) -> None:
    """Fold the delta in; a failure evicts the pin (its base and delta
    are left as they were, but nothing serves from a table whose
    compaction raised) and re-raises into the future, where
    drain_compactions finds it."""
    try:
        old_rung = table.base_cap
        table.compact()
    except BaseException:
        RESIDENT.evict(key)
        raise
    RESIDENT.note_compaction()
    # fold the new rung into the key, so the key stays honest
    if key[0] == "fastlane" and table.base_cap != old_rung:
        new_key = key[:6] + (table.base_cap,) + key[7:]
        RESIDENT.rekey(key, new_key)
        key = new_key
    RESIDENT.set_bytes(key, table.device_bytes)


def drain_compactions(timeout_s: float = 30.0) -> None:
    """Wait for the scheduled compactions; re-raises the first one that
    failed."""
    import concurrent.futures as cf

    with _lock:
        pending = list(_pending_compactions)
    if pending:
        cf.wait(pending, timeout=timeout_s)
    with _lock:
        _pending_compactions[:] = [f for f in _pending_compactions if not f.done()]
    for f in pending:
        if f.done():
            f.result()

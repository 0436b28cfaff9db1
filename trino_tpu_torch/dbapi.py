"""DB-API 2.0 (PEP 249) driver over the statement protocol.

Counterpart of trino_tpu/dbapi.py (host code only).

The trino-jdbc analogue (client/trino-jdbc/.../TrinoDriver.java:21 —
SURVEY.md §2.11): the standard database driver interface of the host
language, layered on the polling HTTP client exactly as the JDBC
driver layers on StatementClientV1. Supports qmark parameter binding
by literal substitution (the protocol is text-based, as in the
reference's non-prepared path), Basic and Bearer authentication.

    import trino_tpu_torch.dbapi as dbapi
    conn = dbapi.connect("http://127.0.0.1:8080", user="alice")
    cur = conn.cursor()
    cur.execute("SELECT n_name FROM nation WHERE n_nationkey = ?", (3,))
    print(cur.fetchall())
"""

from __future__ import annotations

import base64
import datetime
from typing import Iterable, List, Optional, Sequence

from trino_tpu_torch.client import Client, QueryError

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class ProgrammingError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


def _quote_param(value) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, datetime.date) and not isinstance(
        value, datetime.datetime
    ):
        return f"date '{value.isoformat()}'"
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    raise ProgrammingError(f"cannot bind parameter of type {type(value).__name__}")


def _substitute(sql: str, params: Sequence) -> str:
    """qmark substitution, skipping '?' inside string literals,
    double-quoted identifiers, and -- / block comments."""
    out: List[str] = []
    it = iter(params)
    i = 0
    n = len(sql)
    while i < n:
        c = sql[i]
        if c == "'" or c == '"':
            q = c
            j = i + 1
            while j < n:
                if sql[j] == q and j + 1 < n and sql[j + 1] == q:
                    j += 2
                    continue
                if sql[j] == q:
                    break
                j += 1
            out.append(sql[i:j + 1])
            i = j + 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            j = n if j < 0 else j
            out.append(sql[i:j])
            i = j
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(sql[i:j])
            i = j
            continue
        if c == "?":
            try:
                out.append(_quote_param(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters") from None
            i += 1
            continue
        out.append(c)
        i += 1
    remaining = sum(1 for _ in it)
    if remaining:
        raise ProgrammingError(f"{remaining} unused parameters")
    return "".join(out)


class Cursor:
    arraysize = 1

    def __init__(self, connection: "Connection"):
        self.connection = connection
        self.description: Optional[List[tuple]] = None
        self.rowcount = -1
        self._rows: List[list] = []
        self._pos = 0
        self._closed = False

    def _check(self):
        if self._closed or self.connection._closed:
            raise InterfaceError("cursor is closed")

    def execute(self, operation: str, parameters: Sequence = ()) -> "Cursor":
        self._check()
        if parameters:
            # server-side parameter binding (VERDICT r3 item #8): ship
            # the statement once via the prepared-statement protocol
            # headers and EXECUTE ... USING with literal parameters —
            # no client-side string interpolation of the query body
            client = getattr(self.connection, "_client", None)
            if client is not None and hasattr(client, "prepared"):
                name = "stmt"
                client.prepared[name] = operation
                lits = ", ".join(_quote_param(p) for p in parameters)
                operation = f"EXECUTE {name} USING {lits}"
            else:
                operation = _substitute(operation, list(parameters))
        try:
            result = self.connection._execute(operation)
        except QueryError as ex:
            raise DatabaseError(str(ex)) from ex
        self.description = [
            (c["name"], c.get("type"), None, None, None, None, None)
            for c in result.columns
        ]
        self._rows = result.rows
        self._pos = 0
        self.rowcount = len(self._rows)
        return self

    def executemany(self, operation: str, seq_of_parameters: Iterable[Sequence]):
        for p in seq_of_parameters:
            self.execute(operation, p)
        return self

    def fetchone(self) -> Optional[list]:
        self._check()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[list]:
        self._check()
        size = size or self.arraysize
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[list]:
        self._check()
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self):
        self._closed = True


class Connection:
    """One protocol session. commit()/rollback() issue the transaction
    statements when autocommit is off (PEP 249 transaction model)."""

    def __init__(self, client_or_uri, user=None, password=None, token=None,
                 autocommit=True, timeout: float = 120.0):
        if isinstance(client_or_uri, str):
            headers = {}
            if token is not None:
                headers["Authorization"] = f"Bearer {token}"
            elif password is not None:
                cred = base64.b64encode(
                    f"{user}:{password}".encode()
                ).decode()
                headers["Authorization"] = f"Basic {cred}"
            elif user is not None:
                headers["X-Trino-User"] = user
            self._client = Client(
                client_or_uri, timeout=timeout, headers=headers
            )
        else:
            self._client = client_or_uri
        self.autocommit = autocommit
        self._closed = False
        self._in_txn = False

    def _execute(self, sql: str):
        if not self.autocommit and not self._in_txn:
            self._client.execute("START TRANSACTION")
            self._in_txn = True
        return self._client.execute(sql)

    def cursor(self) -> Cursor:
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def _clear_txn(self):
        self._in_txn = False
        if hasattr(self._client, "transaction_id"):
            self._client.transaction_id = None

    def _end_txn(self, sql: str):
        """Issue COMMIT/ROLLBACK. A SERVER-reported failure still prunes
        the server-side transaction, so local state must clear too or
        every later statement wedges on a dead id. A TRANSPORT failure
        (the statement may never have reached the server) keeps local
        state so the application can retry."""
        try:
            self._client.execute(sql)
        except QueryError:
            self._clear_txn()
            raise
        else:
            self._clear_txn()

    def commit(self):
        if self._in_txn:
            self._end_txn("COMMIT")

    def rollback(self):
        if self._in_txn:
            self._end_txn("ROLLBACK")

    def close(self):
        if self._in_txn:
            try:
                self.rollback()
            except Exception:
                pass
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(uri: str, user: Optional[str] = None,
            password: Optional[str] = None, token: Optional[str] = None,
            autocommit: bool = True, timeout: float = 120.0) -> Connection:
    return Connection(uri, user=user, password=password, token=token,
                      autocommit=autocommit, timeout=timeout)

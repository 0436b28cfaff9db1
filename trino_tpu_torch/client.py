"""Python client for the statement protocol.

Counterpart of trino_tpu/client.py (host code only: JSON over HTTP).

Analogue of client/trino-client's StatementClientV1 (StatementClientV1.
java:65, advance():334 — POST /v1/statement then follow nextUri until
the results are exhausted; SURVEY.md §2.11)."""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import List, Optional


class QueryError(RuntimeError):
    pass


@dataclasses.dataclass
class ClientResult:
    query_id: str
    columns: List[dict]
    rows: List[list]

    @property
    def column_names(self) -> List[str]:
        return [c["name"] for c in self.columns]


class Client:
    def __init__(self, uri: str, timeout: float = 60.0,
                 poll_interval: float = 0.05, headers: Optional[dict] = None):
        self.uri = uri.rstrip("/")
        self.timeout = timeout
        self.poll_interval = poll_interval
        self.headers = dict(headers or {})
        # this connection's transaction (X-Trino-Transaction-Id model:
        # the client carries the id; the server holds no session state)
        self.transaction_id: Optional[str] = None
        # prepared statements are also client session state
        # (X-Trino-Prepared-Statement / addedPrepare protocol)
        self.prepared: dict = {}

    def _request(self, method: str, url: str, body: Optional[bytes] = None) -> dict:
        headers = dict(self.headers)
        headers["X-Trino-Transaction-Id"] = self.transaction_id or "NONE"
        if self.prepared:
            import urllib.parse as _up

            headers["X-Trino-Prepared-Statement"] = ",".join(
                f"{k}={_up.quote(v)}" for k, v in self.prepared.items()
            )
        req = urllib.request.Request(
            url, data=body, method=method, headers=headers
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def execute(self, sql: str) -> ClientResult:
        """Submit and drain: the StatementClientV1 polling loop."""
        out = self._request(
            "POST", f"{self.uri}/v1/statement", sql.encode("utf-8")
        )
        columns: List[dict] = []
        rows: List[list] = []
        query_id = out.get("id", "")
        deadline = time.monotonic() + self.timeout
        while True:
            # transaction headers apply even on FAILED responses: a
            # failed COMMIT/ROLLBACK still cleared the server-side
            # transaction, and keeping a dead id would wedge every later
            # statement on this connection with "unknown transaction"
            if out.get("startedTransactionId"):
                self.transaction_id = out["startedTransactionId"]
            if out.get("clearedTransactionId"):
                self.transaction_id = None
            if out.get("addedPrepare"):
                ap = out["addedPrepare"]
                self.prepared[ap["name"]] = ap["sql"]
            if out.get("deallocatedPrepare"):
                self.prepared.pop(out["deallocatedPrepare"], None)
            if "error" in out:
                raise QueryError(out["error"].get("message", "query failed"))
            if out.get("columns"):
                columns = out["columns"]
            rows.extend(out.get("data", ()))
            next_uri = out.get("nextUri")
            if next_uri is None:
                return ClientResult(query_id, columns, rows)
            if time.monotonic() > deadline:
                raise QueryError(f"query {query_id} timed out client-side")
            if not out.get("data"):
                time.sleep(self.poll_interval)
            out = self._request("GET", next_uri)

    def cancel(self, query_id: str) -> None:
        self._request("DELETE", f"{self.uri}/v1/statement/executing/{query_id}")

"""Coordinator HTTP server: the client statement protocol.

Counterpart of trino_tpu/runtime/server.py: the same routes and JSON in
front of any port runner (LocalQueryRunner or DistributedQueryRunner,
each on its own device), with the admission pipeline and resource
groups. Three arms of the reference wait for ROADMAP §1 item 13: the
MicroBatcher (micro_batch_window_ms and micro_batch_max raise when set,
config.UNPORTED_READERS, and a `batcher` raises here), the resident
fast lane (resident_tables raises when set, so no lookup is tried) and
GET /v1/fabric, which answers 501 naming the item.

Analogue of the reference's client protocol (client/trino-client
StatementClientV1.java:65 — POST /v1/statement, poll nextUri, token-
paged results; QueuedStatementResource.java:106 +
ExecutingStatementResource.java:73 — SURVEY.md §2.11, §3.1). Queries
run asynchronously on an executor; clients poll:

  POST /v1/statement               SQL text -> {id, nextUri, stats}
  GET  /v1/statement/executing/{id}/{token}
                                   {columns, data, nextUri?, stats}
  DELETE /v1/statement/executing/{id}     cancel

Data pages out in row chunks per poll (the JSON protocol's data field).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

ROWS_PER_PAGE = 4096

# Minimal coordinator dashboard (the reference ships a React SPA under
# main/server/ui/ + webapp assets; this is the same information surface
# — cluster stats + query list — as one self-contained page).
_UI_HTML = """<!doctype html>
<html><head><title>trino-tpu</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem; }
 h1 { font-size: 1.3rem; } .stats span { margin-right: 2rem; }
 table { border-collapse: collapse; margin-top: 1rem; width: 100%; }
 td, th { border: 1px solid #ccc; padding: 4px 8px; font-size: 0.85rem;
          text-align: left; }
 .finished { color: #2a7d2a; } .failed { color: #b22; }
 .running, .queued { color: #b80; }
</style></head>
<body>
<h1>trino-tpu coordinator</h1>
<div class="stats" id="stats">loading…</div>
<table><thead><tr><th>query id</th><th>state</th><th>rows</th>
<th>sql</th></tr></thead><tbody id="queries"></tbody></table>
<script>
async function tick() {
  try {
    const s = await (await fetch('/v1/cluster')).json();
    document.getElementById('stats').innerHTML =
      `<span>queries: ${s.total_queries}</span>` +
      `<span>running: ${s.running_queries}</span>` +
      `<span>finished: ${s.finished_queries}</span>` +
      `<span>failed: ${s.failed_queries}</span>`;
    const q = await (await fetch('/v1/query')).json();
    document.getElementById('queries').innerHTML = q.map(j =>
      `<tr><td>${j.id}</td><td class="${j.state}">${j.state}</td>` +
      `<td>${j.rows}</td><td><code>${j.sql.replace(/</g,'&lt;')}</code></td></tr>`
    ).join('');
  } catch (e) { /* server gone */ }
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""


class _QueryJob:
    def __init__(self, query_id: str, sql: str, user: Optional[str] = None):
        self.query_id = query_id
        self.sql = sql
        self.user = user
        self.state = "queued"
        self.rows: List[list] = []
        self.columns: List[dict] = []
        self.error: Optional[str] = None
        self.started_transaction_id: Optional[str] = None
        self.added_prepare = None
        self.deallocated_prepare = None
        self.cleared_transaction = False
        self.finished_at: Optional[float] = None  # monotonic, for TTL expiry
        self.drained = False  # final result page delivered to the client
        self.abandoned = False
        self.created_at = time.monotonic()  # admission-queue wait base
        self.last_heartbeat = time.monotonic()  # any client poll refreshes
        self.lock = threading.Lock()  # _QueryJob.lock

    def snapshot(self, token: int):
        with self.lock:
            self.last_heartbeat = time.monotonic()
            return (
                self.state,
                self.columns,
                self.rows[token : token + ROWS_PER_PAGE],
                len(self.rows),
                self.error,
            )


class CoordinatorServer:
    """HTTP front for any runner with .execute(sql) -> MaterializedResult
    (LocalQueryRunner or DistributedQueryRunner)."""

    def __init__(
        self,
        runner,
        port: int = 0,
        max_concurrent: int = 4,
        resource_groups=None,  # runtime.resource_groups.ResourceGroupManager
        authenticator=None,  # security.Authenticator; None = insecure
        client_timeout_s: Optional[float] = None,
        reap_interval_s: Optional[float] = None,
        admission=None,  # serving.admission.AdmissionPipeline
        batcher=None,  # serving.batcher.MicroBatcher: ROADMAP §1 item 13
    ):
        from trino_tpu_torch.security import AuthenticationError, InsecureAuthenticator

        self.runner = runner
        self.resource_groups = resource_groups
        self.authenticator = authenticator or InsecureAuthenticator()
        # serving tier: lane-based admission (shed with 429 instead of
        # queueing without bound) and optional point-lookup coalescing
        _sess = getattr(runner, "session", None)
        if admission is None:
            from trino_tpu_torch.serving.admission import AdmissionPipeline

            admission = AdmissionPipeline(
                resource_groups,
                fast_depth=int(
                    getattr(_sess, "admission_fast_depth", 64) or 64
                ),
                general_depth=int(
                    getattr(_sess, "admission_general_depth", 256) or 256
                ),
                retry_after_s=float(
                    getattr(_sess, "admission_retry_after_s", 1.0) or 1.0
                ),
            )
        self.admission = admission
        # point-lookup coalescing: the reference builds a MicroBatcher
        # when micro_batch_window_ms > 0
        if batcher is not None:
            raise NotImplementedError(
                "the micro-batcher (serving/batcher.py) is ROADMAP §1 item 13"
            )
        if _sess is not None:
            from trino_tpu_torch.config import check_ported

            for name in ("micro_batch_window_ms", "micro_batch_max"):
                check_ported(name, getattr(_sess, name))
        self._jobs: Dict[str, _QueryJob] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_concurrent)
        # client-abandonment TTL: explicit arg wins, else the runner
        # session's client_timeout_s, else the class default
        if client_timeout_s is None:
            client_timeout_s = getattr(
                getattr(runner, "session", None), "client_timeout_s", None
            )
        if client_timeout_s:
            self.CLIENT_TTL_S = float(client_timeout_s)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj, headers=None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _auth(self):
                """Authenticate or answer 401 (the reference's
                authenticator filter chain, main/server/security/)."""
                try:
                    return outer.authenticator.authenticate(self.headers)
                except AuthenticationError as ex:
                    # drain the request body first: HTTP/1.1 keep-alive
                    # would otherwise parse the unread body bytes as
                    # the connection's next request line
                    ln = int(self.headers.get("Content-Length", "0") or 0)
                    if ln:
                        self.rfile.read(ln)
                    body = json.dumps({"error": f"Unauthorized: {ex}"}).encode()
                    self.send_response(401)
                    self.send_header("WWW-Authenticate", "Basic, Bearer")
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return None

            def do_POST(self):
                identity = self._auth()
                if identity is None:
                    return
                parts = [p for p in self.path.split("/") if p]
                if parts == ["v1", "statement"]:
                    ln = int(self.headers.get("Content-Length", "0"))
                    sql = self.rfile.read(ln).decode("utf-8")
                    # per-connection transaction threading: the client
                    # carries its transaction id on every request
                    # (StatementClientV1's X-Trino-Transaction-Id)
                    txn = self.headers.get("X-Trino-Transaction-Id", "NONE")
                    # prepared statements are CLIENT session state,
                    # carried per request (X-Trino-Prepared-Statement:
                    # name=urlencoded-sql, repeatable)
                    import urllib.parse as _up

                    prepared = {}
                    for hv in self.headers.get_all(
                        "X-Trino-Prepared-Statement"
                    ) or []:
                        for part in hv.split(","):
                            if "=" in part:
                                k, v = part.split("=", 1)
                                prepared[k.strip()] = _up.unquote(v)
                    from trino_tpu_torch.serving.admission import (
                        OverloadSheddedError,
                    )

                    try:
                        job = outer._submit(sql, identity, txn, prepared)
                    except OverloadSheddedError as ex:
                        # shed at admission: the client backs off and
                        # retries instead of growing an unbounded queue
                        self._json(
                            429,
                            {"error": {
                                "message": str(ex),
                                "errorName": "SERVER_OVERLOADED",
                            }},
                            headers={"Retry-After": f"{ex.retry_after_s:g}"},
                        )
                        return
                    self._json(200, outer._response(job, 0))
                    return
                self._json(404, {"error": "no route"})

            def do_GET(self):
                identity = self._auth()
                if identity is None:
                    return
                parts = [p for p in self.path.split("/") if p]
                if (
                    len(parts) == 5
                    and parts[:3] == ["v1", "statement", "executing"]
                ):
                    job = outer._jobs.get(parts[3])
                    if job is None:
                        self._json(404, {"error": "unknown query"})
                        return
                    self._json(200, outer._response(job, int(parts[4])))
                    return
                # observability REST surface (QueryResource /
                # ClusterStatsResource analogues) + the web UI page
                if parts == ["v1", "cluster"]:
                    self._json(200, outer.cluster_stats())
                    return
                if parts == ["v1", "metrics"]:
                    from trino_tpu_torch.runtime.metrics import METRICS

                    self._json(200, METRICS.snapshot())
                    return
                if parts == ["v1", "fabric"]:
                    self._json(501, {"error": (
                        "the checkpoint fabric (runtime/fabric.py) is "
                        "ROADMAP §1 item 13.3"
                    )})
                    return
                if parts == ["v1", "query"]:
                    self._json(200, outer.query_list(identity))
                    return
                # per-query observability: aggregated QueryInfo and the
                # Perfetto-loadable span tree (distributed runner only —
                # getattr guards the local runner, which lacks the
                # completed-query registry)
                if len(parts) == 3 and parts[:2] == ["v1", "query"]:
                    fn = getattr(outer.runner, "query_info", None)
                    info = fn(parts[2]) if fn is not None else None
                    if info is None:
                        self._json(404, {"error": "unknown query"})
                    else:
                        self._json(200, info)
                    return
                if (
                    len(parts) == 4
                    and parts[:2] == ["v1", "query"]
                    and parts[3] == "trace"
                ):
                    fn = getattr(outer.runner, "query_chrome_trace", None)
                    tr = fn(parts[2]) if fn is not None else None
                    if tr is None:
                        self._json(404, {"error": "no trace for query"})
                    else:
                        self._json(200, tr)
                    return
                if len(parts) == 2 and parts[0] == "v1" and parts[1] == "info":
                    self._json(200, {"starting": False, "uptime": "n/a"})
                    return
                if parts == ["ui"] or parts == []:
                    body = _UI_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._json(404, {"error": "no route"})

            def do_DELETE(self):
                if self._auth() is None:
                    return
                parts = [p for p in self.path.split("/") if p]
                if (
                    len(parts) == 4
                    and parts[:3] == ["v1", "statement", "executing"]
                ):
                    outer._kill(parts[3])
                    self._json(200, {})
                    return
                self._json(404, {"error": "no route"})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self.uri = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="statement-server",
            daemon=True,
        )
        self._thread.start()
        # abandonment reaper: _evict_completed used to run only on
        # submit, so an idle server never noticed a vanished client —
        # the RUNNING query it left behind kept its resource-group slot
        # and memory forever. The reaper ticks independently of traffic;
        # the running query observes job.abandoned through the `cancel`
        # hook passed to runner.execute and unwinds, releasing both.
        self._reaper_stop = threading.Event()
        self._reap_interval_s = (
            reap_interval_s
            if reap_interval_s is not None
            else max(0.05, min(1.0, self.CLIENT_TTL_S / 4.0))
        )

        def _reap_loop():
            while not self._reaper_stop.wait(self._reap_interval_s):
                try:
                    self._evict_completed()
                except Exception:
                    pass  # a reaper crash must not take the server down

        self._reaper = threading.Thread(
            target=_reap_loop, name="client-reaper", daemon=True
        )
        self._reaper.start()

    def cluster_stats(self) -> dict:
        """ClusterStatsResource analogue."""
        states = [j.state for j in list(self._jobs.values())]
        return {
            "total_queries": len(states),
            "running_queries": sum(1 for s in states if s in ("queued", "running")),
            "finished_queries": sum(1 for s in states if s == "finished"),
            "failed_queries": sum(1 for s in states if s == "failed"),
        }

    def query_list(self, identity=None) -> list:
        """QueryResource GET /v1/query analogue. SQL text and errors are
        visible only to the query's owner (other users see state-level
        metadata, the reference's query-details access rule)."""
        out = []
        user = getattr(identity, "user", None)
        for job in list(self._jobs.values()):
            with job.lock:
                visible = (
                    identity is None or job.user is None or job.user == user
                )
                out.append(
                    {
                        "id": job.query_id,
                        "state": job.state,
                        "rows": len(job.rows),
                        "sql": job.sql[:200] if visible else None,
                        "error": job.error if visible else None,
                    }
                )
        return out

    # completed-job retention (QueryTracker TTL analogue,
    # main/execution/QueryTracker.java): evict after TTL or beyond a cap,
    # oldest first — an unbounded _jobs map leaks in a long-lived server.
    # The cap only evicts DRAINED jobs (final page delivered); a client
    # mid-pagination is protected until the TTL, which bounds abandoned
    # queries regardless.
    COMPLETED_TTL_S = 300.0
    MAX_COMPLETED = 200
    # abandoned-query expiry (QueryTracker.failAbandonedQueries analogue,
    # main/execution/QueryTracker.java + query.client.timeout): a live
    # query whose client stopped polling fails after this long so it
    # cannot pin results/resources forever
    CLIENT_TTL_S = 300.0

    def _evict_completed(self) -> None:
        now = time.monotonic()
        for qid, j in list(self._jobs.items()):
            # age from the LATER of finish and last client poll: a client
            # still paginating keeps refreshing last_heartbeat and must
            # not lose its remaining pages to the hard pop
            last_activity = max(
                j.finished_at or 0.0, j.last_heartbeat
            )
            if (
                j.finished_at is not None
                and now - last_activity > self.COMPLETED_TTL_S
            ):
                self._jobs.pop(qid, None)
                continue
            with j.lock:
                if (
                    j.finished_at is None
                    and now - j.last_heartbeat > self.CLIENT_TTL_S
                ) or (
                    j.state == "finished"
                    and not j.drained
                    and now - j.last_heartbeat > self.CLIENT_TTL_S
                ):
                    j.abandoned = True
                    j.state = "failed"
                    j.error = (
                        "Query abandoned: no client heartbeat for "
                        f"{self.CLIENT_TTL_S:g}s"
                    )
                    j.rows = []
                    j.finished_at = now
                    j.drained = True
        drained = sorted(
            (j.finished_at, qid)
            for qid, j in list(self._jobs.items())
            if j.finished_at is not None and j.drained
        )
        if len(drained) > self.MAX_COMPLETED:
            for _, qid in drained[: len(drained) - self.MAX_COMPLETED]:
                self._jobs.pop(qid, None)

    def _kill(self, query_id: str) -> None:
        """Client cancel (DELETE /v1/statement/executing/{id}): mark the
        job dead instead of dropping it. A QUEUED job's admission wait
        observes `abandoned` and withdraws its ticket — the queue slot
        is released and the query never runs (and never counts toward
        `running`); a RUNNING job keeps executing to completion but its
        result is discarded and the verdict preserved."""
        job = self._jobs.get(query_id)
        if job is None:
            return
        with job.lock:
            if job.finished_at is not None:
                return  # already terminal: keep the real verdict
            job.abandoned = True
            job.state = "failed"
            job.error = "Query killed by user (DELETE)"
            job.finished_at = time.monotonic()
            job.drained = True

    def _submit(self, sql: str, identity=None, transaction_id="NONE",
                prepared=None) -> _QueryJob:
        from trino_tpu_torch.runtime.metrics import METRICS
        from trino_tpu_torch.serving.admission import fast_path_probe

        self._evict_completed()
        # synchronous shed point, BEFORE a job exists: cached-plan point
        # lookups ride the short fast lane, everything else the general
        # lane; a full lane raises OverloadSheddedError (HTTP 429) here
        # on the request thread
        reservation = self.admission.reserve(
            fast=fast_path_probe(self.runner, sql, prepared)
        )
        job = _QueryJob(
            uuid.uuid4().hex[:16], sql, getattr(identity, "user", None)
        )
        self._jobs[job.query_id] = job
        METRICS.increment("queries.submitted")

        def run():
            try:
                # resource-group queueing (lane passed as selector
                # source); a DELETE or client-abandon while queued flips
                # job.abandoned and acquire withdraws the ticket — slot
                # released, the query never runs
                self.admission.wait(
                    reservation, user=job.user or "user",
                    cancelled=lambda: job.abandoned,
                )
                with job.lock:
                    if job.abandoned:
                        return  # expired while queued: don't run or revive
                    job.state = "running"
                # query_max_run_time_s covers the QUEUED phase too: a
                # query that burned its whole wall budget waiting for an
                # admission slot fails typed, before launching anything
                run_limit = float(
                    getattr(
                        getattr(self.runner, "session", None),
                        "query_max_run_time_s", 0.0,
                    ) or 0.0
                )
                if run_limit and (
                    time.monotonic() - job.created_at > run_limit
                ):
                    from trino_tpu_torch.runtime.query_tracker import (
                        EXCEEDED_TIME_LIMIT,
                        ExceededTimeLimitError,
                    )

                    raise ExceededTimeLimitError(
                        f"Query {job.query_id} exceeded the maximum run "
                        f"time limit of {run_limit}s while queued "
                        f"[{EXCEEDED_TIME_LIMIT}]"
                    )
                kwargs = dict(
                    identity=identity, transaction_id=transaction_id,
                    prepared=prepared or None,
                )
                # abandonment reaches INTO the running query: runners
                # that take `cancel` poll it per result page / scheduling
                # round and tear down tasks + memory when it flips
                import inspect

                try:
                    if "cancel" in inspect.signature(
                        self.runner.execute
                    ).parameters:
                        kwargs["cancel"] = lambda: job.abandoned
                except (TypeError, ValueError):
                    pass
                # the reference tries its resident fast lane and the
                # micro-batcher first (ROADMAP §1 item 13; neither can
                # be switched on in the port)
                result = self.runner.execute(sql, **kwargs)
                with job.lock:
                    if job.abandoned:
                        return  # expired while executing: keep the verdict
                    job.columns = [
                        {"name": n, "type": str(t)}
                        for n, t in zip(result.column_names, result.column_types)
                    ]
                    job.rows = result.rows
                    job.added_prepare = getattr(
                        result, "added_prepare", None
                    )
                    job.deallocated_prepare = getattr(
                        result, "deallocated_prepare", None
                    )
                    job.started_transaction_id = getattr(
                        result, "started_transaction_id", None
                    )
                    job.cleared_transaction = getattr(
                        result, "cleared_transaction", False
                    )
                    job.state = "finished"
                    job.finished_at = time.monotonic()
                METRICS.increment("queries.finished")
            except Exception as e:
                METRICS.increment("queries.failed")
                with job.lock:
                    if job.abandoned:
                        return
                    job.error = str(e)
                    job.state = "failed"
                    job.finished_at = time.monotonic()
                    # TransactionManager prunes the transaction even when
                    # COMMIT/ROLLBACK fail — tell the client its id is
                    # dead or every later statement wedges on it
                    head = sql.lstrip().upper()
                    if head.startswith("COMMIT") or head.startswith("ROLLBACK"):
                        job.cleared_transaction = True
            finally:
                self.admission.release(reservation)

        self._pool.submit(run)
        return job

    def _response(self, job: _QueryJob, token: int) -> dict:
        state, columns, data, total, error = job.snapshot(token)
        out = {
            "id": job.query_id,
            "stats": {"state": state.upper()},
        }
        if state == "failed":
            out["error"] = {"message": error}
            if job.cleared_transaction:
                out["clearedTransactionId"] = True
            job.drained = True  # error delivered: cap-evictable
            return out
        if state != "finished":
            out["nextUri"] = f"{self.uri}/v1/statement/executing/{job.query_id}/{token}"
            return out
        out["columns"] = columns
        if job.added_prepare:
            out["addedPrepare"] = {
                "name": job.added_prepare[0], "sql": job.added_prepare[1],
            }
        if job.deallocated_prepare:
            out["deallocatedPrepare"] = job.deallocated_prepare
        if job.started_transaction_id:
            out["startedTransactionId"] = job.started_transaction_id
        if job.cleared_transaction:
            out["clearedTransactionId"] = True
        if data:
            out["data"] = data
        next_token = token + len(data)
        if next_token < total:
            out["nextUri"] = (
                f"{self.uri}/v1/statement/executing/{job.query_id}/{next_token}"
            )
        else:
            job.drained = True  # final page delivered: cap-evictable
        return out

    def stop(self) -> None:
        self._reaper_stop.set()
        self._reaper.join(2)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
        self._pool.shutdown(wait=False)

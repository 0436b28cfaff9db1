"""HTTP task protocol: worker server + coordinator-side remote client.

Counterpart of trino_tpu/runtime/http.py, the worker side: the same
routes, the same typed spec wire (runtime/codec.py) and the same page
frames (pack_pages over exec/serde's bytes, equal to the reference's).
A WorkerServer fronts a port Worker, whose tasks run on the Worker's
device (`Worker(device=None)` takes the CUDA card and raises without
one). Pages leave the worker as host bytes and the consuming task's
RemoteSourceOperator puts them on its own device. A failed pull is
retried by the RequestErrorTracker loop against the same worker and
then fails the task; it is never re-run on another, in-process worker.
Every pulled frame adds its bytes to the METRICS counter
`exchange.http_bytes`.
The checkpoint fabric's routes (FabricServer over a runtime/fabric.py
HostFabric, FabricClient on the peer side) carry mesh checkpoint bytes
between coordinators, each call inside the same RequestErrorTracker
loop; their bodies are framed as the reference frames them
(`frame_fabric_body`), so the same key and payload give its bytes.

Analogue of the reference's internal communication (SURVEY.md §5.8):
control plane = task create/status/delete (main/server/TaskResource.java:92,
HttpRemoteTask §3.2), data plane = pull-based binary page streams with
token/ack semantics (GET /v1/task/{id}/results/{partition}/{token},
TaskResource.java:321). JSON for control, the serde wire format for
pages (a typed binary layout — no object deserialization on wire
bytes). Task specs travel as typed, allowlist-decoded JSON
(runtime/codec.py — the TaskUpdateRequest Jackson-codec analogue; a
request body can only instantiate registered plan/task dataclasses,
never arbitrary objects). Internal authentication additionally gates
EVERY endpoint (TRINO_TPU_INTERNAL_SECRET;
InternalAuthenticationManager analogue), and a NETWORKED worker
refuses to start without a secret — require_secret=False is for
single-process embedding and tests only.

Endpoints served by WorkerServer:
  POST   /v1/task/{taskId}                     create/update task
  GET    /v1/task/{taskId}/status              task state JSON
  GET    /v1/task/{taskId}/results/{p}/{tok}   pull pages (long-poll)
  DELETE /v1/task/{taskId}                     abort + remove
  DELETE /v1/query/{queryId}?reason=...        fail every task of a query
                                               (low-memory killer /
                                               speculation-loser kill)
  GET    /v1/status                            worker heartbeat/info
  PUT    /v1/shutdown                          graceful shutdown (drain)
  PUT    /v1/info/state                        body "SHUTTING_DOWN" ->
                                               drain (reference API)

A draining worker answers task creation with 409 — deliberately NOT a
retryable status (503 would spin the RequestErrorTracker loop for the
full error budget): the refusal is permanent, the scheduler must
re-place the task elsewhere immediately.
"""

from __future__ import annotations

import json
import struct
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from trino_tpu_torch.exec.serde import Page, deserialize_page, serialize_page
from trino_tpu_torch.runtime import codec
from trino_tpu_torch.runtime.metrics import METRICS
from trino_tpu_torch.runtime.worker import Worker, WorkerShuttingDownError
from trino_tpu_torch.analysis import threadreg

_U32 = struct.Struct("<I")


def default_internal_secret() -> Optional[str]:
    """Cluster-wide shared secret for engine-internal HTTP, from the
    environment (the config.properties internal-communication.shared-secret
    analogue). None disables internal auth (single-process embedding)."""
    import os

    return os.environ.get("TRINO_TPU_INTERNAL_SECRET") or None


def pack_pages(pages: List[Page]) -> bytes:
    out = [_U32.pack(len(pages))]
    for p in pages:
        body = serialize_page(p)
        out.append(_U32.pack(len(body)))
        out.append(body)
    return b"".join(out)


def unpack_pages(data: bytes) -> List[Page]:
    (n,) = _U32.unpack_from(data, 0)
    off = _U32.size
    pages = []
    for _ in range(n):
        (ln,) = _U32.unpack_from(data, off)
        off += _U32.size
        pages.append(deserialize_page(data[off : off + ln]))
        off += ln
    return pages


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    worker: Worker = None  # set by server factory
    server_ref = None

    def log_message(self, *args):  # quiet
        pass

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, code: int, body: bytes, headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _authorized(self) -> bool:
        """Internal-comms gate (InternalAuthenticationManager analogue):
        when the server carries a shared secret, every request must
        present a valid X-Trino-Internal-Bearer."""
        auth = self.server_ref.internal_auth
        if auth is None:
            return True
        from trino_tpu_torch.security import AuthenticationError

        try:
            auth.verify(self.headers)
            return True
        except AuthenticationError as ex:
            ln = int(self.headers.get("Content-Length", "0") or 0)
            if ln:
                self.rfile.read(ln)
            self._json(401, {"error": f"Unauthorized: {ex}"})
            return False

    # -- routes --
    def do_GET(self):
        if not self._authorized():
            return
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if parts[:2] == ["v1", "status"]:
                # the worker's own status() carries lifecycle state +
                # running-task count — the drain waiter reads both
                self._json(200, self.worker.status())
                return
            if parts[:2] == ["v1", "task"] and len(parts) >= 4:
                task_id = parts[2]
                if parts[3] == "status":
                    self._json(200, self.worker.task_state(task_id))
                    return
                if parts[3] == "results" and len(parts) == 6:
                    partition, token = int(parts[4]), int(parts[5])
                    wait = 0.0
                    if "?" in self.path and "wait=" in self.path:
                        wait = float(self.path.split("wait=")[1].split("&")[0])
                    pages, next_token, complete = self.worker.get_results(
                        task_id, partition, token, wait=wait
                    )
                    self._bytes(
                        200,
                        pack_pages(pages),
                        [
                            ("X-Next-Token", str(next_token)),
                            ("X-Complete", "1" if complete else "0"),
                        ],
                    )
                    return
            self._json(404, {"error": f"no route {self.path}"})
        except KeyError:
            self._json(404, {"error": f"unknown task {self.path}"})
        except Exception as e:  # engine-internal; report upstream
            self._json(500, {"error": repr(e)})

    def do_POST(self):
        if not self._authorized():
            return
        parts = [p for p in self.path.split("/") if p]
        try:
            if parts[:2] == ["v1", "task"] and len(parts) == 3:
                if self.worker.state != "active":
                    # 409, not 503: a drain refusal is permanent for
                    # this worker — the client must re-place, not retry
                    self._json(409, {"error": "worker shutting down"})
                    return
                ln = int(self.headers.get("Content-Length", "0"))
                spec = codec.loads(self.rfile.read(ln))
                task = self.worker.create_task(spec)
                self._json(200, {"task_id": str(task.spec.task_id), "state": task.state})
                return
            self._json(404, {"error": f"no route {self.path}"})
        except WorkerShuttingDownError as e:
            self._json(409, {"error": str(e)})
        except Exception as e:
            self._json(500, {"error": repr(e)})

    def do_DELETE(self):
        if not self._authorized():
            return
        path, _, query = self.path.partition("?")
        parts = [p for p in path.split("/") if p]
        try:
            if parts[:2] == ["v1", "task"] and len(parts) == 3:
                self.worker.remove_task(parts[2])
                self._json(200, {})
                return
            if parts[:2] == ["v1", "query"] and len(parts) == 3:
                # kill every task of a query with a reason (the
                # low-memory killer / speculation-loser cancel path on
                # HTTP topologies — Worker.fail_query over the wire)
                import urllib.parse as _up

                reason = _up.parse_qs(query).get("reason", [""])[0] or (
                    "Query killed via DELETE /v1/query"
                )
                self.worker.fail_query(parts[2], reason)
                self._json(200, {})
                return
            self._json(404, {"error": f"no route {self.path}"})
        except Exception as e:
            self._json(500, {"error": repr(e)})

    def do_PUT(self):
        if not self._authorized():
            return
        parts = [p for p in self.path.split("/") if p]
        if parts[:2] == ["v1", "shutdown"]:
            # graceful shutdown (GracefulShutdownHandler.java:43): stop
            # accepting tasks; running tasks drain
            self.worker.shutdown_gracefully()
            self._json(200, {"state": "shutting_down"})
            return
        if parts[:3] == ["v1", "info", "state"]:
            # the reference's worker-state API: PUT /v1/info/state with
            # body "SHUTTING_DOWN" (JSON string) starts the drain
            ln = int(self.headers.get("Content-Length", "0") or 0)
            body = self.rfile.read(ln).decode("utf-8", "replace").strip()
            want = body.strip('"').upper()
            if want != "SHUTTING_DOWN":
                self._json(
                    400,
                    {"error": f"unsupported state {body!r}: only "
                              "SHUTTING_DOWN may be requested"},
                )
                return
            self.worker.shutdown_gracefully()
            self._json(200, {"state": "shutting_down"})
            return
        self._json(404, {"error": f"no route {self.path}"})


class WorkerServer:
    """HTTP front of one Worker (TrinoServer worker bootstrap analogue).
    `internal_secret` turns on shared-secret authentication of every
    endpoint (InternalAuthenticationManager analogue)."""

    def __init__(self, worker: Worker, port: int = 0,
                 internal_secret: Optional[str] = "__env__",
                 require_secret: bool = True):
        self.worker = worker
        self.internal_auth = None
        if internal_secret == "__env__":
            internal_secret = default_internal_secret()
        if internal_secret is None and require_secret:
            # a worker port without auth accepts task specs from anyone
            # who can reach it; default-config deployments must not be
            # open. Single-process embeddings/tests opt out explicitly.
            raise RuntimeError(
                "refusing to start a networked worker without an internal "
                "secret: set TRINO_TPU_INTERNAL_SECRET (or pass "
                "internal_secret=...), or pass require_secret=False for "
                "single-process embedding"
            )
        if internal_secret is not None:
            from trino_tpu_torch.security import InternalAuthenticator

            self.internal_auth = InternalAuthenticator(internal_secret)
        handler = type("BoundHandler", (_Handler,), {"worker": worker, "server_ref": self})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self._httpd.server_port
        self.uri = f"http://127.0.0.1:{self.port}"
        self._thread = threadreg.spawn(
            f"worker-http-{self.port}", self._httpd.serve_forever,
            owner="WorkerServer",
        )

    @property
    def state(self) -> str:
        """Lifecycle lives on the Worker (single source of truth shared
        by the in-process and HTTP surfaces)."""
        return self.worker.state

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()


class HttpWorkerClient:
    """Coordinator-side proxy for a remote worker (HttpRemoteTask +
    ContinuousTaskStatusFetcher collapsed into synchronous calls).

    Every call runs a RequestErrorTracker retry loop
    (runtime/error_tracker.py): transient failures back off with jitter
    until the per-destination error budget or hard deadline is spent,
    then the call raises RequestFailedError — the caller fails the TASK
    (FTE re-places it), never the query. The tracker is safe here
    because every endpoint is idempotent: create_task re-delivers by
    task id, results are pulled with an advancing ack token, and DELETE
    is a no-op on a missing task. `failure_listener` (e.g. a
    NodeManager) hears every success/failure for circuit-breaker
    accounting."""

    def __init__(self, uri: str, timeout: float = 30.0,
                 internal_secret: Optional[str] = "__env__",
                 retry_policy=None, failure_listener=None):
        self.uri = uri.rstrip("/")
        self.timeout = timeout
        self.worker_id = uri
        # None = "not explicitly chosen": the coordinator may bind the
        # session's request_max_error_duration_s onto it at registration
        self.retry_policy = retry_policy
        self.failure_listener = failure_listener
        self._auth = None
        if internal_secret == "__env__":
            internal_secret = default_internal_secret()
        if internal_secret is not None:
            from trino_tpu_torch.security import InternalAuthenticator

            self._auth = InternalAuthenticator(internal_secret)

    def _req(self, method: str, path: str, body: Optional[bytes] = None):
        headers = {}
        if self._auth is not None:
            headers[self._auth.HEADER] = self._auth.token()
        req = urllib.request.Request(
            self.uri + path, data=body, method=method, headers=headers
        )
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _retrying(self, fn):
        from trino_tpu_torch.runtime.error_tracker import (
            RetryPolicy,
            run_with_retry,
        )

        return run_with_retry(
            self.uri, fn, policy=self.retry_policy or RetryPolicy(),
            listener=self.failure_listener,
        )

    def create_task(self, spec) -> str:
        body = codec.dumps(spec)

        def go():
            try:
                with self._req("POST", f"/v1/task/{spec.task_id}", body) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    # drain refusal: permanent for this worker, typed so
                    # the scheduler re-places instead of retrying
                    raise WorkerShuttingDownError(
                        f"worker {self.uri} is shutting down"
                    ) from e
                raise

        out = self._retrying(go)
        if "error" in out:
            raise RuntimeError(out["error"])
        return out["task_id"]

    def task_state(self, task_id) -> dict:
        def go():
            with self._req("GET", f"/v1/task/{task_id}/status") as r:
                return json.loads(r.read())

        return self._retrying(go)

    def get_results(
        self, task_id, partition: int, token: int,
        max_pages: int = 16, wait: float = 0.0,
    ) -> Tuple[List[Page], int, bool]:
        path = f"/v1/task/{task_id}/results/{partition}/{token}?wait={wait}"

        def go():
            with self._req("GET", path) as r:
                data = r.read()
                next_token = int(r.headers["X-Next-Token"])
                complete = r.headers["X-Complete"] == "1"
            METRICS.increment("exchange.http_bytes", len(data))
            return unpack_pages(data), next_token, complete

        return self._retrying(go)

    def remove_task(self, task_id) -> None:
        try:
            self._req("DELETE", f"/v1/task/{task_id}").close()
        except (urllib.error.URLError, OSError):
            pass

    def fail_query(self, query_id: str, message: str) -> None:
        """DELETE /v1/query/{id}?reason=...: fail every task of the
        query on this worker with the kill reason (low-memory killer /
        speculation-loser cancellation over the wire)."""
        import urllib.parse as _up

        try:
            self._req(
                "DELETE",
                f"/v1/query/{query_id}?reason={_up.quote(message)}",
            ).close()
        except (urllib.error.URLError, OSError):
            pass  # a vanished worker has nothing left to kill

    def results_location(self, task_id):
        """Picklable location descriptor for TaskSpec.input_locations
        (resolved worker-side by task._resolve_fetch)."""
        return ("http", self.uri, str(task_id))

    def status(self) -> dict:
        # heartbeat probe: NO retry loop — the failure detector wants to
        # see every miss, and a probe that silently retries for 30s
        # would stall the ping loop behind one dead node
        with self._req("GET", "/v1/status") as r:
            return json.loads(r.read())

    def shutdown_gracefully(self) -> None:
        self._req("PUT", "/v1/shutdown").close()

    def set_state(self, state: str) -> None:
        """PUT /v1/info/state (the reference's worker-state API); only
        "SHUTTING_DOWN" is accepted by the server."""
        self._req(
            "PUT", "/v1/info/state", json.dumps(state).encode()
        ).close()


def frame_fabric_body(ekey: str, payload: bytes) -> bytes:
    """Length-prefix framing of a fabric POST body: an 8-byte big-endian
    key length, the ascii key, then the checkpoint payload. The encoded
    key (a pickled program identity) can pass http.server's 64 KiB
    request-line limit, so it rides in the body."""
    kb = ekey.encode("ascii")
    return struct.pack(">Q", len(kb)) + kb + payload


def unframe_fabric_body(body: bytes) -> Tuple[str, bytes]:
    if len(body) < 8:
        raise ValueError("fabric body too short for key frame")
    (klen,) = struct.unpack(">Q", body[:8])
    if klen > len(body) - 8:
        raise ValueError("fabric body key frame overruns body")
    return body[8:8 + klen].decode("ascii"), body[8 + klen:]


class _FabricHandler(_Handler):
    """The coordinator-to-coordinator checkpoint routes (a HostFabric
    behind them):

      POST /v1/fabric/checkpoint        pushed bytes: framed body (key +
                                        payload), X-Fabric-Digest covers
                                        the payload
      POST /v1/fabric/checkpoint/pull   body is the encoded key: bytes +
                                        digest, 404 when absent or stale
      GET  /v1/fabric/status            endpoint state JSON

    _Handler's responders and its internal-auth gate; an error inside a
    route answers 500 with its text (the caller's tracker sees it as a
    protocol error)."""

    fabric = None  # set by FabricServer

    def do_GET(self):
        if not self._authorized():
            return
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if parts == ["v1", "fabric", "status"]:
                self._json(200, self.fabric.status())
                return
            self._json(404, {"error": f"no route {self.path}"})
        except Exception as e:  # noqa: BLE001 - answered as a 500
            self._json(500, {"error": repr(e)})

    def do_POST(self):
        if not self._authorized():
            return
        parts = [p for p in self.path.split("/") if p]
        try:
            ln = int(self.headers.get("Content-Length", "0") or 0)
            body = self.rfile.read(ln)
            if parts == ["v1", "fabric", "checkpoint"]:
                ekey, data = unframe_fabric_body(body)
                digest = self.headers.get(FabricClient.HEADER_DIGEST, "")
                self._json(200, self.fabric.receive_checkpoint(ekey, data, digest))
                return
            if parts == ["v1", "fabric", "checkpoint", "pull"]:
                out = self.fabric.serve_checkpoint(body.decode("ascii"))
                if out is None:
                    self._json(404, {"error": "no checkpoint"})
                    return
                data, digest = out
                self._bytes(200, data, [(FabricClient.HEADER_DIGEST, digest)])
                return
            self._json(404, {"error": f"no route {self.path}"})
        except Exception as e:  # noqa: BLE001 - answered as a 500
            self._json(500, {"error": repr(e)})


class FabricServer:
    """HTTP front of one HostFabric on 127.0.0.1. Like WorkerServer, it
    refuses to start without an internal secret (a fabric port without
    one takes and serves checkpoint bytes from anyone who reaches it)
    unless `require_secret=False` (single-process tests)."""

    def __init__(self, fabric, port: int = 0, internal_secret: Optional[str] = "__env__",
                 require_secret: bool = True):
        self.fabric = fabric
        self.internal_auth = None
        if internal_secret == "__env__":
            internal_secret = default_internal_secret()
        if internal_secret is None and require_secret:
            raise RuntimeError(
                "refusing to start a networked fabric endpoint without an "
                "internal secret: set TRINO_TPU_INTERNAL_SECRET (or pass "
                "internal_secret=...), or pass require_secret=False for "
                "single-process embedding"
            )
        if internal_secret is not None:
            from trino_tpu_torch.security import InternalAuthenticator

            self.internal_auth = InternalAuthenticator(internal_secret)
        handler = type("BoundFabricHandler", (_FabricHandler,),
                       {"fabric": fabric, "server_ref": self})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self._httpd.server_port
        self.uri = f"http://127.0.0.1:{self.port}"
        self._thread = threadreg.spawn(
            f"fabric-http-{self.port}", self._httpd.serve_forever,
            owner="FabricServer",
        )

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()


class FabricClient:
    """Peer side of the checkpoint fabric: push and pull checkpoint
    bytes with their digests, every call inside the RequestErrorTracker
    loop (a spent budget raises RequestFailedError)."""

    HEADER_DIGEST = "X-Fabric-Digest"

    def __init__(self, uri: str, timeout: float = 10.0,
                 internal_secret: Optional[str] = "__env__", retry_policy=None,
                 failure_listener=None):
        self.uri = uri.rstrip("/")
        self.timeout = timeout
        self.retry_policy = retry_policy
        self.failure_listener = failure_listener
        self._auth = None
        if internal_secret == "__env__":
            internal_secret = default_internal_secret()
        if internal_secret is not None:
            from trino_tpu_torch.security import InternalAuthenticator

            self._auth = InternalAuthenticator(internal_secret)

    def _req(self, method: str, path: str, body: Optional[bytes] = None,
             headers: Optional[dict] = None):
        hdrs = dict(headers or {})
        if self._auth is not None:
            hdrs[self._auth.HEADER] = self._auth.token()
        req = urllib.request.Request(self.uri + path, data=body, method=method, headers=hdrs)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _retrying(self, fn):
        from trino_tpu_torch.runtime.error_tracker import RetryPolicy, run_with_retry

        return run_with_retry(self.uri, fn, policy=self.retry_policy or RetryPolicy(),
                              listener=self.failure_listener)

    def push_checkpoint(self, key: tuple, data: bytes, digest: Optional[str] = None) -> dict:
        from trino_tpu_torch.runtime.fabric import checkpoint_digest, encode_key

        digest = digest or checkpoint_digest(data)
        body = frame_fabric_body(encode_key(key), data)

        def go():
            with self._req("POST", "/v1/fabric/checkpoint", body=body,
                           headers={self.HEADER_DIGEST: digest}) as r:
                return json.loads(r.read())

        return self._retrying(go)

    def pull_checkpoint(self, key: tuple) -> Tuple[Optional[bytes], Optional[str]]:
        """(bytes, digest) of the peer's live entry, or (None, None)
        when the peer holds none under the key."""
        from trino_tpu_torch.runtime.fabric import encode_key

        body = encode_key(key).encode("ascii")

        def go():
            try:
                with self._req("POST", "/v1/fabric/checkpoint/pull", body=body) as r:
                    return r.read(), r.headers.get(self.HEADER_DIGEST)
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    return None, None  # absent is an answer, not an error
                raise

        return self._retrying(go)

    def status(self) -> dict:
        def go():
            with self._req("GET", "/v1/fabric/status") as r:
                return json.loads(r.read())

        return self._retrying(go)


def http_fetch(uri: str, task_id: str, retry_policy=None):
    """Location descriptor -> fetch callable for TaskSpec.input_locations
    (the HttpPageBufferClient pull side). Worker-to-worker page pulls
    carry the same retry/backoff discipline as coordinator calls."""
    client = HttpWorkerClient(uri, retry_policy=retry_policy)

    def fetch(partition: int, token: int, max_pages: int, wait: float):
        return client.get_results(task_id, partition, token, max_pages, wait)

    return fetch

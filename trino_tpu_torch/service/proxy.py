"""HTTP proxy fronting one or more coordinators.

Counterpart of trino_tpu/service/proxy.py (host code only).

service/trino-proxy analogue (913 LoC in the reference): accepts the
client statement protocol, forwards to a backend coordinator chosen
round-robin per NEW query, and rewrites nextUri links so the client
keeps polling through the proxy. Follow-up polls route to the backend
that owns the query (sticky by query id)."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

from trino_tpu_torch.analysis import threadreg
from trino_tpu_torch.analysis.witness import named_lock


class ProxyServer:
    def __init__(self, backend_uris: List[str], port: int = 0):
        self.backends = [u.rstrip("/") for u in backend_uris]
        assert self.backends, "proxy needs at least one backend"
        self._rr = 0
        self._owner: Dict[str, str] = {}  # query id -> backend uri
        self._lock = named_lock("ProxyServer._lock")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _forward(self, backend: str, body: bytes | None):
                req = urllib.request.Request(
                    backend + self.path,
                    data=body,
                    method=self.command,
                    headers={
                        k: v
                        for k, v in self.headers.items()
                        if k.lower() not in ("host", "content-length")
                    },
                )
                try:
                    with urllib.request.urlopen(req, timeout=300) as r:
                        ctype = r.headers.get(
                            "Content-Type", "application/json"
                        )
                        return r.status, r.read(), ctype
                except urllib.error.HTTPError as e:
                    return (
                        e.code, e.read(),
                        e.headers.get("Content-Type", "application/json"),
                    )

            def _respond(self, code: int, payload: bytes, ctype: str,
                         backend: str):
                # rewrite nextUri to keep the client pointed at the proxy
                if "json" in ctype:
                    try:
                        doc = json.loads(payload)
                        if isinstance(doc, dict) and doc.get("nextUri"):
                            doc["nextUri"] = doc["nextUri"].replace(
                                backend, outer.uri
                            )
                            if doc.get("id"):
                                outer._remember(doc["id"], backend)
                        if (
                            isinstance(doc, dict)
                            and doc.get("nextUri") is None
                            and doc.get("id")
                        ):
                            outer._forget(doc["id"])
                        payload = json.dumps(doc).encode()
                    except Exception:
                        pass
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _backend_for_path(self) -> str:
                parts = [p for p in self.path.split("/") if p]
                if len(parts) >= 4 and parts[:3] == [
                    "v1", "statement", "executing",
                ]:
                    with outer._lock:
                        owner = outer._owner.get(parts[3])
                    if owner:
                        return owner
                with outer._lock:
                    outer._rr = (outer._rr + 1) % len(outer.backends)
                    return outer.backends[outer._rr]

            def do_POST(self):
                ln = int(self.headers.get("Content-Length", "0") or 0)
                body = self.rfile.read(ln) if ln else None
                backend = self._backend_for_path()
                self._respond(*self._forward(backend, body), backend)

            def do_GET(self):
                backend = self._backend_for_path()
                self._respond(*self._forward(backend, None), backend)

            def do_DELETE(self):
                backend = self._backend_for_path()
                self._respond(*self._forward(backend, None), backend)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self.uri = f"http://127.0.0.1:{self.port}"
        self._thread = threadreg.spawn(
            "proxy-server", self._httpd.serve_forever, owner="ProxyServer"
        )

    _MAX_TRACKED = 10_000

    def _remember(self, query_id: str, backend: str) -> None:
        with self._lock:
            self._owner[query_id] = backend
            # bounded: evict oldest entries past the cap (query ids of
            # drained queries are also dropped eagerly via _forget)
            while len(self._owner) > self._MAX_TRACKED:
                self._owner.pop(next(iter(self._owner)))

    def _forget(self, query_id: str) -> None:
        with self._lock:
            self._owner.pop(query_id, None)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

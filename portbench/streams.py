"""The client side of a run, in a process of its own: one thread a stream,
each with the port's `client.Client` at its default settings, sending its
statements one after another with no think time (a closed loop).

Reads one JSON line on stdin ({"streams": [[[id, sql], ...], ...],
"seconds", "timeout"}: the client's statement deadline, the one setting
not left at its default, so that an answer that comes late is waited
for), imports the client and answers "ready"; then reads
"go <monotonic start> <server uri>", runs until start + seconds and lets the
statements in flight finish. It prints one JSON line: every statement's
stream, id, monotonic send and last-row times, and its rows or error.
Only the client module of the port is imported, so the clients never
share the server's interpreter lock.
"""

from __future__ import annotations

import json
import sys
import threading
import time


def main() -> int:
    job = json.loads(sys.stdin.readline())
    from trino_tpu_torch.client import Client

    print("ready", flush=True)
    go = sys.stdin.readline().split()
    start, uri = float(go[1]), go[2]
    end = start + float(job["seconds"])
    records = []
    lock = threading.Lock()

    def stream(k: int, statements) -> None:
        client = Client(uri, timeout=float(job["timeout"]))
        i = 0
        while True:
            t0 = time.monotonic()
            if t0 >= end:
                return
            sid, sql = statements[i % len(statements)]
            i += 1
            try:
                rows, err = client.execute(sql).rows, None
            except Exception as e:  # a failed statement is recorded, not fatal
                rows, err = None, f"{type(e).__name__}: {e}"
            t1 = time.monotonic()
            with lock:
                records.append([k, sid, t0, t1, rows, err])

    threads = [threading.Thread(target=stream, args=(k, s), daemon=True)
               for k, s in enumerate(job["streams"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps(records), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

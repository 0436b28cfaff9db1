"""Spooled (external) exchange: durable task output for fault tolerance.

Counterpart of trino_tpu/runtime/spool.py. Pages are the port's
exec/serde.Page (host bytes, the reference's wire format), so a spool
written by one package reads in the other. The METRICS counters
`spool.bytes_written`/`spool.write_s` and `spool.bytes_read`/
`spool.read_s` sum the page files' bytes and the host seconds spent
serializing and writing or reading and decoding them. Analogue of the exchange SPI + filesystem exchange plugin
(spi/exchange/ExchangeManager.java:42, plugin/trino-exchange-filesystem
FileSystemExchangeSink.java:63 — SURVEY.md §2.8, §3.5): each task's
output is persisted per partition and committed atomically, making tasks
idempotent and restartable; consumers read only COMMITTED attempts (the
ExchangeSourceOutputSelector de-duplication of speculative/retried
tasks).

Layout: {base}/{task}/{partition}-{seq}.page + {base}/{task}/committed
(manifest listing page counts per partition, written last).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.exec.serde import Page, deserialize_page, serialize_page
from trino_tpu_torch.runtime.metrics import METRICS


class SpoolingExchangeSink:
    """OutputBuffer-compatible sink that spools to files
    (SpoolingExchangeOutputBuffer analogue). Same enqueue /
    set_no_more_pages / abort / get_pages surface so
    PartitionedOutputOperator and the results protocol work unchanged —
    get_pages serves from disk after commit (the coordinator's
    deduplicating fetch of the root stage)."""

    def __init__(self, base_dir: str, task_key: str, n_partitions: int):
        self._dir = os.path.join(base_dir, task_key)
        os.makedirs(self._dir, exist_ok=True)
        self._n = n_partitions
        self._seq = [0] * n_partitions
        self._committed = False
        self._aborted = False
        self._lock = threading.Condition()  # SpoolingExchangeSink._lock

    @property
    def n_partitions(self) -> int:
        return self._n

    def enqueue(self, partition: int, page: Page) -> None:
        seq = self._seq[partition]
        self._seq[partition] = seq + 1
        path = os.path.join(self._dir, f"{partition}-{seq}.page")
        tmp = path + ".tmp"
        t0 = time.monotonic()
        data = serialize_page(page)
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        METRICS.increment("spool.write_s", time.monotonic() - t0)
        METRICS.increment("spool.bytes_written", len(data))

    def set_no_more_pages(self) -> None:
        with self._lock:
            if self._committed or self._aborted:
                return
            manifest = {"pages": list(self._seq)}
            tmp = os.path.join(self._dir, "committed.tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(self._dir, "committed"))
            self._committed = True
            self._lock.notify_all()

    def abort(self) -> None:
        with self._lock:
            self._aborted = True
            self._lock.notify_all()

    # -- consumer surface (post-commit reads) --
    def get_pages(
        self, partition: int, token: int, max_pages: int = 16, wait: float = 0.0
    ) -> Tuple[List[Page], int, bool]:
        with self._lock:
            if self._aborted:
                raise RuntimeError("spooled output aborted (task failed)")
            if not self._committed:
                if wait > 0:
                    self._lock.wait(timeout=wait)
                if not self._committed:
                    if self._aborted:
                        raise RuntimeError("spooled output aborted (task failed)")
                    return [], token, False
        return read_spool(self._dir, partition, token, max_pages)

    def is_fully_consumed(self) -> bool:
        return self._committed


def read_spool(
    task_dir: str, partition: int, token: int, max_pages: int = 16
) -> Tuple[List[Page], int, bool]:
    """Read a committed task attempt's pages for one partition starting
    at `token` (ExchangeSource analogue; tokens index spooled files, so
    redelivery after a consumer restart is natural)."""
    with open(os.path.join(task_dir, "committed")) as f:
        manifest = json.load(f)
    total = manifest["pages"][partition]
    pages = []
    seq = token
    t0, n = time.monotonic(), 0
    while seq < total and len(pages) < max_pages:
        with open(os.path.join(task_dir, f"{partition}-{seq}.page"), "rb") as f:
            data = f.read()
        pages.append(deserialize_page(data))
        n += len(data)
        seq += 1
    METRICS.increment("spool.read_s", time.monotonic() - t0)
    METRICS.increment("spool.bytes_read", n)
    return pages, seq, seq >= total


def spool_fetch(base_dir: str, task_key: str):
    """Location descriptor resolver: ("spool", base_dir, task_key) ->
    fetch callable reading the committed attempt."""
    task_dir = os.path.join(base_dir, task_key)

    def fetch(partition: int, token: int, max_pages: int, wait: float):
        return read_spool(task_dir, partition, token, max_pages)

    return fetch


def is_committed(base_dir: str, task_key: str) -> bool:
    return os.path.exists(os.path.join(base_dir, task_key, "committed"))

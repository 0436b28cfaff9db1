"""Engine transaction manager.

Counterpart of trino_tpu/transaction.py (main/transaction/ +
spi/transaction/): the engine-level TransactionManager hands out
transaction ids, connectors join lazily on first touch, and
commit/rollback fans out to every joined connector handle. Connectors
opt in by overriding Connector.begin_transaction; the default handle is
a no-op autocommit (matching the reference, where most connectors are
not transactional across statements).

Scope limits (documented, fail-open like most engines): DML (INSERT)
is transactional for connectors that buffer (memory connector); DDL
(CREATE/DROP TABLE, CTAS table creation) applies immediately and is
NOT rolled back — a ROLLBACK after CTAS leaves an empty table behind.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Dict


class TransactionError(Exception):
    pass


class ConnectorTransactionHandle:
    """spi/transaction/ConnectorTransactionHandle analogue. The default
    is autocommit: commit/rollback are no-ops."""

    def commit(self) -> None:
        pass

    def rollback(self) -> None:
        pass


@dataclasses.dataclass
class TransactionInfo:
    transaction_id: str
    read_only: bool
    # catalog -> joined connector handle
    handles: Dict[str, ConnectorTransactionHandle] = dataclasses.field(
        default_factory=dict
    )
    completed: bool = False


class TransactionManager:
    """main/transaction/InMemoryTransactionManager analogue."""

    def __init__(self, catalogs):
        self.catalogs = catalogs
        self._transactions: Dict[str, TransactionInfo] = {}
        self._lock = threading.Lock()

    def begin(self, read_only: bool = False) -> str:
        tx = TransactionInfo(uuid.uuid4().hex[:16], read_only)
        with self._lock:
            self._transactions[tx.transaction_id] = tx
        return tx.transaction_id

    def _get(self, transaction_id: str) -> TransactionInfo:
        tx = self._transactions.get(transaction_id)
        if tx is None or tx.completed:
            raise TransactionError(f"unknown or completed transaction {transaction_id}")
        return tx

    def join(
        self, transaction_id: str, catalog: str, connector=None
    ) -> ConnectorTransactionHandle:
        """Connector joins on first touch (lazy, like the reference's
        per-catalog transaction start)."""
        tx = self._get(transaction_id)
        with self._lock:
            if catalog not in tx.handles:
                if connector is None:
                    connector = self.catalogs.get(catalog)
                begin = getattr(connector, "begin_transaction", None)
                tx.handles[catalog] = (
                    begin(tx.read_only) if begin else ConnectorTransactionHandle()
                )
            return tx.handles[catalog]

    def commit(self, transaction_id: str) -> None:
        tx = self._get(transaction_id)
        tx.completed = True
        errors = []
        for catalog, handle in tx.handles.items():
            try:
                handle.commit()
            except Exception as ex:  # noqa: BLE001 - aggregate and rethrow
                errors.append(f"{catalog}: {ex}")
        self._prune(transaction_id)
        if errors:
            raise TransactionError("commit failed: " + "; ".join(errors))

    def rollback(self, transaction_id: str) -> None:
        tx = self._get(transaction_id)
        tx.completed = True
        for handle in tx.handles.values():
            handle.rollback()
        self._prune(transaction_id)

    def _prune(self, transaction_id: str) -> None:
        """Completed transactions leave the registry immediately — a
        long-lived runner must not accumulate them."""
        with self._lock:
            self._transactions.pop(transaction_id, None)

    def is_active(self, transaction_id: str) -> bool:
        tx = self._transactions.get(transaction_id)
        return tx is not None and not tx.completed

    def is_read_only(self, transaction_id: str) -> bool:
        return self._get(transaction_id).read_only

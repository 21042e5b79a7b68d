"""Storage interfaces (the port's copy of the JAX package's
``storage/interfaces.py``).

Reference: bcos-framework/storage/StorageInterface.h — read/write interface
plus the transactional (2PC) extension implemented by the durable backends
(RocksDBStorage.cpp asyncPrepare/asyncCommit/asyncRollback) and driven by the
scheduler's commit (TwoPCParams). Python methods are synchronous; async
orchestration happens at the node layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

from .entry import Entry


@dataclass
class TwoPCParams:
    """bcos-framework/storage/StorageInterface.h TwoPCParams analog."""

    number: int = 0
    primary_key: str = ""
    timestamp: int = 0


class StorageInterface:
    def get_row(self, table: str, key: bytes) -> Entry | None:
        raise NotImplementedError

    def get_rows(self, table: str, keys: Iterable[bytes]) -> list[Entry | None]:
        return [self.get_row(table, k) for k in keys]

    def set_row(self, table: str, key: bytes, entry: Entry) -> None:
        raise NotImplementedError

    def set_rows(self, table: str, items: list[tuple[bytes, Entry]]) -> None:
        """Bulk write; durable backends commit all rows in one transaction
        (hot paths like pool persistence write thousands of rows per block)."""
        for key, entry in items:
            self.set_row(table, key, entry)

    def get_primary_keys(self, table: str) -> list[bytes]:
        raise NotImplementedError


class TraversableStorage(StorageInterface):
    def traverse(self) -> Iterator[tuple[str, bytes, Entry]]:
        """Yield (table, key, entry) for every locally-held row."""
        raise NotImplementedError


class TransactionalStorage(StorageInterface):
    """Durable backend with two-phase commit."""

    def prepare(self, params: TwoPCParams, writes: TraversableStorage) -> None:
        raise NotImplementedError

    def commit(self, params: TwoPCParams) -> None:
        raise NotImplementedError

    def rollback(self, params: TwoPCParams) -> None:
        raise NotImplementedError

    def pending_numbers(self) -> list[int]:
        """Block numbers with a prepared-but-unresolved 2PC slot.

        Part of the interface because the distributed recovery plane
        (DistributedStorage.recover_in_flight) DEPENDS on every backend
        answering truthfully — a backend silently reporting [] would make
        recovery skip its stuck slots forever."""
        raise NotImplementedError

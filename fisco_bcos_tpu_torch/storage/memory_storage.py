"""In-memory transactional backend (tests + fakers; FakeKVStorage analog;
the port's copy of the JAX package's ``storage/memory_storage.py``).

A node's state is its storage: :meth:`MemoryStorage.from_rows` builds one
from plain ``(table, key, fields, status)`` tuples, the form a chain written
by another process (the JAX node, for one) can be carried across in without
this package seeing any of that process's objects.
"""

from __future__ import annotations

import threading
from typing import Iterator

from .entry import Entry, EntryStatus
from .interfaces import TransactionalStorage, TraversableStorage, TwoPCParams


class MemoryStorage(TransactionalStorage):
    def __init__(self) -> None:
        self._data: dict[tuple[str, bytes], Entry] = {}
        self._pending: dict[int, dict[tuple[str, bytes], Entry]] = {}
        self._lock = threading.RLock()

    @classmethod
    def from_rows(cls, rows) -> "MemoryStorage":
        """A storage holding `rows`: ``(table: str, key: bytes, fields:
        dict[str, bytes], status: int)`` tuples, as ``traverse()`` yields
        them with each entry's fields and status taken out. Deleted rows are
        kept as tombstones, as ``traverse()`` gives them."""
        st = cls()
        for table, key, fields, status in rows:
            st._data[(str(table), bytes(key))] = Entry(
                {str(n): bytes(v) for n, v in fields.items()}, EntryStatus(int(status))
            )
        return st

    def get_row(self, table: str, key: bytes) -> Entry | None:
        with self._lock:
            e = self._data.get((table, bytes(key)))
            return None if e is None or e.deleted else e.copy()

    def set_row(self, table: str, key: bytes, entry: Entry) -> None:
        with self._lock:
            self._data[(table, bytes(key))] = entry.copy()

    def get_primary_keys(self, table: str) -> list[bytes]:
        with self._lock:
            return sorted(
                k for (t, k), e in self._data.items() if t == table and not e.deleted
            )

    def traverse(self) -> Iterator[tuple[str, bytes, Entry]]:
        with self._lock:
            items = list(self._data.items())
        for (t, k), e in items:
            yield t, k, e.copy()

    # -- 2PC ------------------------------------------------------------

    def prepare(self, params: TwoPCParams, writes: TraversableStorage) -> None:
        """Stage writes for `number`. PER-KEY MERGE, not slot replacement:
        a Max-form block is prepared by several executor participants, each
        staging its own (disjoint) dirty set into the same number — TiKV's
        multi-participant prewrite semantics. Re-preparing the same key
        (block re-execution after a term switch) overwrites per key."""
        with self._lock:
            slot = self._pending.setdefault(params.number, {})
            for t, k, e in writes.traverse():
                slot[(t, bytes(k))] = e.copy()

    def commit(self, params: TwoPCParams) -> None:
        with self._lock:
            for (t, k), e in self._pending.pop(params.number, {}).items():
                self._data[(t, k)] = e

    def rollback(self, params: TwoPCParams) -> None:
        with self._lock:
            self._pending.pop(params.number, None)

    def pending_numbers(self) -> list[int]:
        with self._lock:
            return sorted(self._pending)

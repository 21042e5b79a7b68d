"""Table abstraction over a storage layer (the port's copy of the JAX
package's ``storage/table.py``).

Reference: bcos-framework/storage/Table.h + bcos-table/src/Table.cpp; table
metadata lives in the s_tables system table (TableManagerPrecompiled creates
user tables there at runtime).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .entry import Entry
from .interfaces import StorageInterface

SYS_TABLES = "s_tables"


@dataclass(frozen=True)
class TableInfo:
    name: str
    key_field: str = "key"
    value_fields: tuple[str, ...] = ("value",)

    def encode(self) -> bytes:
        return ",".join([self.key_field, *self.value_fields]).encode()

    @classmethod
    def decode(cls, name: str, buf: bytes) -> "TableInfo":
        parts = buf.decode().split(",")
        return cls(name=name, key_field=parts[0], value_fields=tuple(parts[1:]))


@dataclass
class Table:
    info: TableInfo
    storage: StorageInterface = field(repr=False)

    def get_row(self, key: bytes) -> Entry | None:
        return self.storage.get_row(self.info.name, key)

    def get_rows(self, keys) -> list[Entry | None]:
        return self.storage.get_rows(self.info.name, keys)

    def set_row(self, key: bytes, entry: Entry) -> None:
        self.storage.set_row(self.info.name, key, entry)

    def remove(self, key: bytes) -> None:
        remove = getattr(self.storage, "remove_row", None)
        if remove is None:
            from .entry import EntryStatus

            self.storage.set_row(
                self.info.name, key, Entry(status=EntryStatus.DELETED)
            )
        else:
            remove(self.info.name, key)

    def new_entry(self) -> Entry:
        return Entry()


def open_table(storage: StorageInterface, name: str) -> Table | None:
    meta = storage.get_row(SYS_TABLES, name.encode())
    if meta is None:
        return None
    return Table(TableInfo.decode(name, meta.get()), storage)


def create_table(
    storage: StorageInterface,
    name: str,
    key_field: str = "key",
    value_fields: tuple[str, ...] = ("value",),
) -> Table:
    info = TableInfo(name, key_field, value_fields)
    existing = storage.get_row(SYS_TABLES, name.encode())
    if existing is not None:
        raise ValueError(f"table exists: {name}")
    storage.set_row(SYS_TABLES, name.encode(), Entry().set(info.encode()))
    return Table(info, storage)

"""Storage: entry/table model, overlay state, durable backends, 2PC (the
port's copies of the JAX package's ``storage`` modules the pool path runs:
the KV backends, the overlay and its state hash on the port's suite).

Reference counterparts: bcos-framework/storage/{StorageInterface,Entry,Table}.h,
bcos-table (StateStorage/KeyPageStorage), bcos-storage (RocksDB/TiKV 2PC).
"""

from .entry import Entry, EntryStatus  # noqa: F401
from .table import Table, TableInfo  # noqa: F401
from .memory_storage import MemoryStorage  # noqa: F401
from .sqlite_storage import SQLiteStorage  # noqa: F401
from .state_storage import StateStorage  # noqa: F401

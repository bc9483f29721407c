"""Keyed, idempotent result sinks (the port's own copy of the JAX
package's ``store``): the chip, pixel, segment and tile tables over
memory, sqlite, parquet, Cassandra and object backends, with the same
keys, column types, CQL, sqlite file layout and object layout, so either
package reads what the other wrote.  Writes are upserts on the primary
key.  With FIREBIRD_OBJECT_ROOT set, a local store's writes are mirrored
to the object tier (``objectstore.MirroredStore``).

Writes drain through an :class:`AsyncWriter` on host threads, so the
card's compute overlaps egress.
"""

from firebird_tpu_torch.store.backends import (CassandraStore, ColumnUpdate,
                                               MemoryStore, ParquetStore,
                                               SqliteStore, cassandra_ddl,
                                               open_store, sanitize_keyspace)
from firebird_tpu_torch.store.objectstore import (LocalObjectStore,
                                                  MirroredStore,
                                                  ObjectBackedStore,
                                                  ObjectStoreError,
                                                  PreconditionFailed,
                                                  StaleObjectFence,
                                                  open_object_root)
from firebird_tpu_torch.store.schema import TABLES, primary_key
from firebird_tpu_torch.store.writer import AsyncWriter

__all__ = ["TABLES", "primary_key", "ColumnUpdate", "MemoryStore",
           "SqliteStore", "ParquetStore", "CassandraStore", "cassandra_ddl",
           "sanitize_keyspace", "open_store", "LocalObjectStore",
           "ObjectBackedStore", "MirroredStore", "ObjectStoreError",
           "PreconditionFailed", "StaleObjectFence", "open_object_root",
           "AsyncWriter"]

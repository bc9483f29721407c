"""Keyed, idempotent result sinks (the port's own copy of the JAX
package's ``store``): the chip, pixel, segment and tile tables over
memory, sqlite and parquet backends, with the same keys, column types and
sqlite file layout, so either package reads what the other wrote.  Writes
are upserts on the primary key.  The object store, its mirror and
Cassandra are not ported yet.

Writes drain through an :class:`AsyncWriter` on host threads, so the
card's compute overlaps egress.
"""

from firebird_tpu_torch.store.backends import (MemoryStore, ParquetStore,
                                               SqliteStore, open_store)
from firebird_tpu_torch.store.schema import TABLES, primary_key
from firebird_tpu_torch.store.writer import AsyncWriter

__all__ = ["TABLES", "primary_key", "MemoryStore", "SqliteStore",
           "ParquetStore", "open_store", "AsyncWriter"]

"""streamops: the stream path's checkpoint store.

- :mod:`firebird_tpu_torch.streamops.statestore`: the tile-packed stream
  checkpoint store, one file per tile holding 2500 fixed-size chip slots
  with per-slot generations and checksums, in the JAX package's format.

The acquisition watcher (the JAX package's ``streamops/watcher.py``) is
not ported yet.
"""

from firebird_tpu_torch.streamops.statestore import (LegacyNpzStore,
                                                     StateStoreError,
                                                     TileStateStore,
                                                     open_statestore)

__all__ = ["LegacyNpzStore", "StateStoreError", "TileStateStore",
           "open_statestore"]

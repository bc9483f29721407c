"""streamops: the stream path's checkpoint store and its acquisition
watcher.

- :mod:`firebird_tpu_torch.streamops.statestore`: the tile-packed stream
  checkpoint store, one file per tile holding 2500 fixed-size chip slots
  with per-slot generations and checksums, in the JAX package's format,
  and its object-tier mirror.
- :mod:`firebird_tpu_torch.streamops.watcher`: the acquisition watcher,
  which polls a source's ``list_acquisitions`` manifest, dedupes scene
  ids against a durable sqlite cursor, maps scene footprints to chips and
  enqueues idempotent ``stream`` jobs (``detect`` bootstrap jobs dep'd
  ahead of them) on the fleet queue.
"""

from firebird_tpu_torch.streamops.statestore import (LegacyNpzStore,
                                                     MirroredStateStore,
                                                     ObjectStateStore,
                                                     StateStoreError,
                                                     TileStateStore,
                                                     open_statestore)
from firebird_tpu_torch.streamops.watcher import (AcquisitionWatcher,
                                                  SceneCursor,
                                                  watch_db_path)

__all__ = ["AcquisitionWatcher", "LegacyNpzStore", "MirroredStateStore",
           "ObjectStateStore", "SceneCursor", "StateStoreError",
           "TileStateStore", "open_statestore", "watch_db_path"]

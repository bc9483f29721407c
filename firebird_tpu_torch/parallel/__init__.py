"""Sharded dispatch of the detector over a list of devices, with the
straggler-rebalancing ring (:mod:`firebird_tpu_torch.parallel.mesh`), and
one process per card (:mod:`firebird_tpu_torch.parallel.dist`)."""

from firebird_tpu_torch.parallel.dist import init_distributed
from firebird_tpu_torch.parallel.mesh import (RebalanceSpec, detect_sharded,
                                              rebalance_spec,
                                              rebalance_tail_back,
                                              rebalance_tail_out,
                                              shard_devices)

__all__ = ["RebalanceSpec", "detect_sharded", "init_distributed",
           "rebalance_spec", "rebalance_tail_back", "rebalance_tail_out",
           "shard_devices"]

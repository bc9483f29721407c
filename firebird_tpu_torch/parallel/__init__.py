"""Sharded dispatch of the detector over a list of devices or a global
mesh of every process's shards, with the straggler-rebalancing ring
(:mod:`firebird_tpu_torch.parallel.mesh`), and one process per card
(:mod:`firebird_tpu_torch.parallel.dist`)."""

from firebird_tpu_torch.parallel.dist import init_distributed
from firebird_tpu_torch.parallel.mesh import (Mesh, MeshMismatch,
                                              RebalanceSpec, detect_sharded,
                                              make_mesh, rebalance_spec,
                                              rebalance_tail_back,
                                              rebalance_tail_out,
                                              shard_devices, spans_processes)

__all__ = ["Mesh", "MeshMismatch", "RebalanceSpec", "detect_sharded",
           "init_distributed", "make_mesh", "rebalance_spec",
           "rebalance_tail_back", "rebalance_tail_out", "shard_devices",
           "spans_processes"]

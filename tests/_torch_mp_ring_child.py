"""Child process of the port's global-mesh tests (test_torch_global_mesh.py).

Each of two processes joins one gloo process group (parallel.dist), builds
the global mesh (parallel.make_mesh) and runs three dispatches over it, in
order, each writing its results into ``<out>/<case>.<pid>.npz``:

- ``ragged``: one CPU shard each over the forced-ragged pair of chips in
  ``<out>/ragged.npz`` (process p holds chip p), the ring on: the ring's
  hops cross between the processes (gloo send/receive).
- ``cadence``: the counterpart of tests/_mp_mesh_child.py with two CPU
  shards each: the processes pack their chips at cadences 16 and 8 (their
  window caps differ, so the window-cap agreement decides), start at
  max_segments=1 (the capacity retry's agreement fires), and run with the
  ring on; each process also runs kernel.detect_packed on its chips.
- ``mismatch``: one shard each, the ring on, the capacity retry off, and a
  segment capacity that differs between the processes (1 and 2): the
  stage-2 carries' signatures differ, and both processes must raise
  MeshMismatch naming the payload signature.

Run as ``python tests/_torch_mp_ring_child.py PID HOST:PORT OUTDIR``; the
parent sets FIREBIRD_COMPACT_MIN_LANES and FIREBIRD_REBALANCE_THRESHOLD.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STORE = ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef", "mask",
         "procedure", "lanes_migrated")


def save(path, seg, **extra):
    import numpy as np

    np.savez(path, **{f: getattr(seg, f).numpy() for f in STORE
                      if getattr(seg, f) is not None}, **extra)


def main() -> int:
    pid, coord, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from firebird_tpu_torch.ccd import kernel
    from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY
    from firebird_tpu_torch.ingest import SyntheticSource, pack
    from firebird_tpu_torch.ingest.packer import PackedChips
    from firebird_tpu_torch.parallel import (MeshMismatch, detect_sharded,
                                             dist, make_mesh,
                                             spans_processes)

    assert dist.init_distributed(coord, 2, pid)

    # ragged: one CPU shard a process, chip p of the pair.
    mesh = make_mesh(["cpu"], timeout_s=60)
    assert spans_processes(mesh) and len(mesh) == 2
    assert list(mesh.local) == [pid], mesh
    arrays = dict(np.load(os.path.join(out, "ragged.npz")))
    mine = PackedChips(**{k: v[pid:pid + 1] for k, v in arrays.items()})
    seg = detect_sharded(mine, mesh, compact=True, rebalance=True)
    save(os.path.join(out, f"ragged.{pid}.npz"), seg)

    # cadence: two CPU shards a process, the agreements exercised.
    mesh = make_mesh(["cpu", "cpu"], timeout_s=60)
    assert len(mesh) == 4 and list(mesh.local) == [2 * pid, 2 * pid + 1]
    src = SyntheticSource(seed=3, start="1996-01-01", end="1998-07-01",
                          cadence_days=16 if pid == 0 else 8,
                          sensor=LANDSAT_ARD_TINY)
    cids = [(100, 200), (3100, 200), (6100, 200), (9100, 200)]
    packed = pack([src.chip(cx, cy)
                   for cx, cy in cids[pid * 2:(pid + 1) * 2]], bucket=128)
    seg = detect_sharded(packed, mesh, compact=True, rebalance=True,
                         max_segments=1)
    ref = kernel.detect_packed(packed, device="cpu", compact=True)
    save(os.path.join(out, f"cadence.{pid}.npz"), seg,
         wcap_local=kernel.window_cap(packed),
         ref_n_segments=ref.n_segments.numpy(),
         ref_seg_meta=ref.seg_meta.numpy(),
         ref_seg_coef=ref.seg_coef.numpy(),
         ref_seg_rmse=ref.seg_rmse.numpy(), ref_mask=ref.mask.numpy())

    # mismatch: the stage-2 carries differ in their segment capacity.
    try:
        detect_sharded(packed, mesh, compact=True, rebalance=True,
                       max_segments=1 + pid, check_capacity=False)
    except MeshMismatch as e:
        print(f"MISMATCH_RAISED {pid}: {e}", flush=True)
    else:
        raise AssertionError("the mismatched ring ran")
    print(f"CHILD_OK {pid}", flush=True)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

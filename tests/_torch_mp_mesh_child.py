"""Child process of the port's two-process mesh test (test_torch_multiproc.py),
the counterpart of tests/_mp_mesh_child.py.

Each of two processes joins one gloo process group (parallel.dist) and runs
parallel.detect_sharded over ITS OWN chips on its own two CPU shards: a
device list is process-local, so this dispatch makes no exchange.  The two processes pack their
chips at different acquisition cadences (so their window caps differ) and
start at max_segments=1 (so the capacity retry fires); each process's
results must equal kernel.detect_packed on its chips.  The rebalancing
ring over a process-local list runs in the process alone and equals the
ring-off dispatch (a global mesh's ring: test_torch_global_mesh.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    pid, coord = int(sys.argv[1]), sys.argv[2]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from firebird_tpu_torch.ccd import kernel
    from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY
    from firebird_tpu_torch.ingest import SyntheticSource, pack
    from firebird_tpu_torch.parallel import detect_sharded, dist

    assert dist.init_distributed(coord, 2, pid)
    assert dist.process_count() == 2 and dist.process_index() == pid

    src = SyntheticSource(seed=3, start="1996-01-01", end="1998-07-01",
                          cadence_days=16 if pid == 0 else 8,
                          sensor=LANDSAT_ARD_TINY)
    cids = [(100, 200), (3100, 200), (6100, 200), (9100, 200)]
    mine = cids[pid * 2:(pid + 1) * 2]
    packed = pack([src.chip(cx, cy) for cx, cy in mine], bucket=128)
    seg = detect_sharded(packed, ["cpu", "cpu"], max_segments=1)
    ref = kernel.detect_packed(packed, device="cpu")
    for name in ("n_segments", "seg_meta", "seg_coef", "seg_rmse", "mask"):
        got, want = getattr(seg, name).numpy(), getattr(ref, name).numpy()
        if got.ndim >= 3 and name != "mask":
            S = min(got.shape[2], want.shape[2])
            got, want = got[:, :, :S], want[:, :, :S]
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the capacity retry fired (it started at 1)
    assert seg.seg_meta.shape[2] >= 2, seg.seg_meta.shape
    # The ring over a process-local device list runs in this process
    # alone and leaves the store fields as the ring-off dispatch does.
    ringed = detect_sharded(packed, ["cpu", "cpu"], rebalance=True,
                            max_segments=1)
    for name in ("n_segments", "seg_meta", "seg_coef", "seg_rmse", "mask"):
        np.testing.assert_array_equal(getattr(ringed, name).numpy(),
                                      getattr(seg, name).numpy(),
                                      err_msg=name)
    assert ringed.lanes_migrated.shape == (2,)
    print(f"wcap_local={kernel.window_cap(packed)} CHILD_OK {pid}",
          flush=True)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

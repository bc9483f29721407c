"""The port's stream checkpoint store against the JAX package's.

The port keeps its own copy of ``streamops/statestore.py`` with the same
on-disk format, so a checkpoint either package writes loads in the other.
Here: ``serialize_state`` byte for byte against JAX's on the same state; a
tile file JAX wrote loads in the port, and the reverse; and the port's
counterparts of tests/test_streamops.py's statestore tests (a torn slot
falls back one generation, both banks corrupt fail loudly, ``void``, the
thread race, the legacy npz migration, ``load_batch``, ``open_statestore``
modes).
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd.incremental import StreamState as JState
from firebird_tpu.config import Config as JConfig
from firebird_tpu.streamops import statestore as jss
from firebird_tpu_torch import grid
from firebird_tpu_torch.ccd import convert
from firebird_tpu_torch.ccd.incremental import STATE_FIELDS, StreamState
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.streamops import statestore as ss
from firebird_tpu_torch.utils.fn import take


def _chips(n=3):
    return [tuple(int(v) for v in c)
            for c in take(n, grid.chips(grid.tile(x=100.0, y=200.0)))]


def _mk_arrays(P=5, B=7, K=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "coefs": rng.normal(size=(P, B, K)).astype(np.float32),
        "rmse": rng.random((P, B)).astype(np.float32),
        "vario": rng.random((P, B)).astype(np.float32),
        "nobs": rng.integers(0, 100, P).astype(np.int32),
        "n_exceed": rng.integers(0, 6, P).astype(np.int32),
        "end_day": (rng.random(P) * 1000).astype(np.float32),
        "exceed_day0": np.zeros(P, np.float32),
        "break_day": np.where(rng.random(P) < 0.3,
                              728000.0, 0.0).astype(np.float32),
        "active": rng.random(P) < 0.5,
        "sday": (rng.random(P) * 1000).astype(np.float64),
        "curqa": rng.integers(0, 64, P).astype(np.int64),
        "anchor": np.float64(123.0),
        "horizon": np.float64(456.0),
    }


def _side(a):
    return {k: a[k] for k in ss.SIDE_FIELDS}


def _port_state(a):
    return convert.stream_state_from_numpy(a)


def _jax_state(a):
    return JState(*(jnp.asarray(a[f]) for f in STATE_FIELDS))


def _assert_arrays_equal(got, want):
    for k in STATE_FIELDS + ss.SIDE_FIELDS:
        g = got[k]
        g = g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


def _loaded(st, side):
    got = {f: getattr(st, f) for f in STATE_FIELDS}
    got.update(side)
    return got


def test_layout_constants_equal_jax():
    assert ss.STATE_FIELDS == jss.STATE_FIELDS
    assert ss.SIDE_FIELDS == jss.SIDE_FIELDS
    assert ss._layout(10, 7, 8) == jss._layout(10, 7, 8)
    for name in ("STATESTORE_SCHEMA", "FILE_MAGIC", "FILE_VERSION",
                 "FILE_HDR_SIZE", "SLOT_HDR_SIZE", "SLOT_MAGIC"):
        assert getattr(ss, name) == getattr(jss, name), name
    assert ss._FILE_HDR.format == jss._FILE_HDR.format
    assert ss._SLOT_HDR.format == jss._SLOT_HDR.format


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serialize_state_byte_identical_to_jax(seed):
    a = _mk_arrays(P=37, seed=seed)
    want = jss.serialize_state(_jax_state(a), _side(a))
    assert ss.serialize_state(_port_state(a), _side(a)) == want
    assert ss.serialize_state(a_obj(a), _side(a)) == want
    got = ss.deserialize_state(want, 37, 7, 8)
    _assert_arrays_equal(got, a)


def a_obj(a):
    """The state as an object of numpy attributes (no tensors)."""
    return type("S", (), {f: a[f] for f in STATE_FIELDS})()


def test_jax_written_tile_loads_in_the_port(tmp_path):
    cids = _chips(3)
    per_chip = [_mk_arrays(seed=10 + i) for i in range(3)]
    js = jss.TileStateStore(str(tmp_path))
    for cid, a in zip(cids, per_chip):
        js.save(cid, _jax_state(a), _side(a))
    js.save(cids[0], _jax_state(per_chip[1]), _side(per_chip[1]))  # gen 2
    js.close()
    ts = ss.TileStateStore(str(tmp_path))
    assert ts.chips() == sorted(cids)
    _assert_arrays_equal(_loaded(*ts.load(cids[0])), per_chip[1])
    for cid, a in zip(cids[1:], per_chip[1:]):
        _assert_arrays_equal(_loaded(*ts.load(cid)), a)
        assert ts.peek_horizon(cid) == 456.0
    ts.close()


def test_port_written_tile_loads_in_jax(tmp_path):
    cids = _chips(2)
    per_chip = [_mk_arrays(seed=20 + i) for i in range(2)]
    ts = ss.TileStateStore(str(tmp_path))
    for cid, a in zip(cids, per_chip):
        ts.save(cid, _port_state(a), _side(a))
    ts.close()
    js = jss.TileStateStore(str(tmp_path))
    for cid, a in zip(cids, per_chip):
        st, side = js.load(cid)
        got = {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS}
        got.update(side)
        _assert_arrays_equal(got, a)
    js.close()
    # The two packages' files are byte-identical for the same saves.
    other = tmp_path / "jax"
    js = jss.TileStateStore(str(other))
    for cid, a in zip(cids, per_chip):
        js.save(cid, _jax_state(a), _side(a))
    js.close()
    name = ss.TileStateStore(str(tmp_path)).tile_path(
        ss.TileStateStore(str(tmp_path)).slot_of(cids[0])[0])
    assert (open(name, "rb").read()
            == open(other / os.path.basename(name), "rb").read())


def test_roundtrip_and_absent_chip(tmp_path):
    store = ss.TileStateStore(str(tmp_path))
    cid, other = _chips(2)
    with pytest.raises(KeyError):
        store.load(cid)
    a = _mk_arrays(seed=1)
    store.save(cid, _port_state(a), _side(a))
    assert store.exists(cid) and not store.exists(other)
    st, side = store.load(cid)
    assert st.coefs.device.type == "cpu"
    _assert_arrays_equal(_loaded(st, side), a)
    store.close()


def test_lossy_state_rejected(tmp_path):
    store = ss.TileStateStore(str(tmp_path))
    a = _mk_arrays()
    a["coefs"] = a["coefs"].astype(np.float64) + 1e-12
    with pytest.raises(ss.StateStoreError, match="npz"):
        store.save_arrays(_chips(1)[0], a)
    store.close()


def _newest_payload(store, cid):
    hv, idx = store.slot_of(cid)
    cap, span = store._spans(*store._geom[hv])
    base = store._slot_offset(idx, span)
    banks = sorted(store._read_banks(store._fds[hv], base, cap), reverse=True)
    gen, length, _, _, _, off = banks[0]
    return store.tile_path(hv), off, length


def test_torn_slot_falls_back_one_generation(tmp_path):
    store = ss.TileStateStore(str(tmp_path))
    cid = _chips(1)[0]
    gen1, gen2 = _mk_arrays(seed=10), _mk_arrays(seed=11)
    store.save_arrays(cid, gen1)
    store.save_arrays(cid, gen2)
    path, off, length = _newest_payload(store, cid)
    with open(path, "r+b") as f:
        f.seek(off + length // 2)
        f.write(b"\xde\xad\xbe\xef" * 4)
    _assert_arrays_equal(store.peek_arrays(cid), gen1)
    assert store.tallies["torn_recoveries"] == 1
    # The JAX package reads the same torn file the same way.
    _assert_arrays_equal(jss.TileStateStore(str(tmp_path)).peek_arrays(cid),
                         gen1)
    gen3 = _mk_arrays(seed=12)
    store.save_arrays(cid, gen3)
    _assert_arrays_equal(store.peek_arrays(cid), gen3)
    store.close()


def _scribble_both_banks(store, cid):
    hv, idx = store.slot_of(cid)
    cap, span = store._spans(*store._geom[hv])
    base = store._slot_offset(idx, span)
    with open(store.tile_path(hv), "r+b") as f:
        for bank in (0, 1):
            f.seek(base + 2 * ss.SLOT_HDR_SIZE + bank * cap)
            f.write(b"\xff" * cap)


def test_both_banks_corrupt_is_loud(tmp_path):
    store = ss.TileStateStore(str(tmp_path))
    cid = _chips(1)[0]
    store.save_arrays(cid, _mk_arrays(seed=20))
    store.save_arrays(cid, _mk_arrays(seed=21))
    _scribble_both_banks(store, cid)
    with pytest.raises(ss.StateStoreError, match="checksum"):
        store.peek_arrays(cid)
    with pytest.raises(ss.StateStoreError, match="checksum"):
        store.load(cid)
    store.close()


def test_void_unrecoverable_slot(tmp_path):
    store = ss.TileStateStore(str(tmp_path))
    cid = _chips(1)[0]
    store.save_arrays(cid, _mk_arrays(seed=60))
    _scribble_both_banks(store, cid)
    assert store.exists(cid)
    with pytest.raises(ss.StateStoreError):
        store.load(cid)
    store.void(cid)
    assert not store.exists(cid)
    with pytest.raises(KeyError):
        store.load(cid)
    store.save_arrays(cid, _mk_arrays(seed=61))
    _assert_arrays_equal(store.peek_arrays(cid), _mk_arrays(seed=61))
    store.close()


def test_same_process_thread_race(tmp_path):
    store = ss.TileStateStore(str(tmp_path))
    cid = _chips(1)[0]
    errs = []

    def hammer(seed):
        try:
            for i in range(10):
                a = _mk_arrays(seed=seed + i)
                store.save(cid, _port_state(a), _side(a))
        except Exception as e:  # noqa: BLE001 — the assert surface
            errs.append(e)

    ts = [threading.Thread(target=hammer, args=(s,)) for s in (1, 50)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    got = store.peek_arrays(cid)
    assert any(np.array_equal(got["coefs"], _mk_arrays(seed=s)["coefs"])
               for s in (10, 59))
    store.close()


def test_legacy_npz_migrates_bit_exact(tmp_path):
    """A per-chip .npz the JAX package wrote reads through the port's
    packed store bit-exactly and lands in its slot."""
    cid = _chips(1)[0]
    a = _mk_arrays(seed=30)
    jss.save_state(jss.legacy_state_path(str(tmp_path), cid), _jax_state(a),
                   _side(a))
    store = ss.TileStateStore(str(tmp_path))
    assert store.exists(cid)
    _assert_arrays_equal(_loaded(*store.load(cid)), a)
    assert store.tallies["migrations"] == 1
    os.remove(ss.legacy_state_path(str(tmp_path), cid))
    _assert_arrays_equal(store.peek_arrays(cid), a)
    store.load(cid)
    assert store.tallies["migrations"] == 1
    store.close()


def test_load_batch_stacks_chips(tmp_path):
    store = ss.TileStateStore(str(tmp_path))
    cids = _chips(3)
    per_chip = [_mk_arrays(seed=40 + i) for i in range(3)]
    for cid, a in zip(cids, per_chip):
        store.save_arrays(cid, a)
    st, sides = store.load_batch(cids)
    assert isinstance(st, StreamState) and st.coefs.shape == (3, 5, 7, 8)
    for i, a in enumerate(per_chip):
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(getattr(st, f)[i].numpy(), a[f],
                                          err_msg=f)
        for k in ss.SIDE_FIELDS:
            np.testing.assert_array_equal(sides[i][k], a[k], err_msg=k)
    store.close()


def test_open_statestore_modes(tmp_path):
    kw = dict(store_path=str(tmp_path / "s.db"),
              stream_dir=str(tmp_path / "st"))
    assert isinstance(ss.open_statestore(Config(**kw)), ss.TileStateStore)
    assert isinstance(ss.open_statestore(Config(**kw,
                                                stream_statestore="npz")),
                      ss.LegacyNpzStore)
    # float64 state does not fit the packed float32 layout: npz.
    assert isinstance(ss.open_statestore(Config(**kw, dtype="float64")),
                      ss.LegacyNpzStore)
    assert isinstance(jss.open_statestore(JConfig(**kw, dtype="float64")),
                      jss.LegacyNpzStore)
    with pytest.raises(ValueError, match="not ported.*object_root"):
        ss.open_statestore(Config(**kw, object_root=str(tmp_path / "obj")))
    assert ss.state_dir(Config(store_path="/x/s.db")) == "/x/s.db.stream"


def test_npz_store_roundtrips_float64_with_jax(tmp_path):
    """The npz escape hatch carries float64 state between the packages."""
    a = _mk_arrays(seed=7)
    for f in ("coefs", "rmse", "vario", "end_day", "exceed_day0",
              "break_day"):
        a[f] = a[f].astype(np.float64) + 1e-12
    cid = _chips(1)[0]
    ss.LegacyNpzStore(str(tmp_path)).save(cid, _port_state(a), _side(a))
    st, side = jss.LegacyNpzStore(str(tmp_path)).load(cid)
    got = {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS}
    got.update(side)
    _assert_arrays_equal(got, a)
    assert ss.LegacyNpzStore(str(tmp_path)).chips() == [cid]

"""The port's Cassandra store and ``schema`` command against the JAX
package's, on the CPU (no cluster: the injectable session).

tests/test_store.py's Cassandra cases run on both packages' stores over
one recording session (its ``FakeCqlSession``, which executes the CQL the
stores generate against in-memory tables): every prepared statement,
executed CQL string and bound value must be the JAX store's, call for
call, and every read the same.  The port's two store extensions (a
``ColumnUpdate`` written as a whole-row upsert, ``read(..., columns=)``)
hold on it too, and ``python -m firebird_tpu_torch schema`` prints the
JAX command's output byte for byte.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from firebird_tpu.store import CassandraStore as JCassandraStore
from firebird_tpu.store.backends import sanitize_keyspace as jsanitize
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch.store import CassandraStore, ColumnUpdate
from firebird_tpu_torch.store import cassandra_ddl, sanitize_keyspace
from tests.test_store import FakeCqlSession, seg_frame

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RecordingSession(FakeCqlSession):
    """tests/test_store.py's fake session, logging every call: what a
    store asked the driver to prepare and execute, with the bound values."""

    def __init__(self):
        super().__init__()
        self.log = []

    def prepare(self, cql):
        self.log.append(("prepare", cql))
        return super().prepare(cql)

    def execute_async(self, stmt, params):
        self.log.append(("execute_async", stmt.cql, tuple(params)))
        return super().execute_async(stmt, params)

    def execute(self, cql, params=()):
        self.log.append(("execute", cql, tuple(params)))
        return super().execute(cql, params)


def both(**kw):
    """A port store and a JAX store, each on its own recording session."""
    ts, js = RecordingSession(), RecordingSession()
    return (CassandraStore(session=ts, **kw), ts,
            JCassandraStore(session=js, **kw), js)


def test_cassandra_roundtrip_all_tables_equals_jax():
    t, ts, j, js = both(keyspace="ks")

    def drive(store):
        store.write("chip", {"cx": [10], "cy": [20],
                             "dates": [["1999-01-01", "1999-02-01"]]})
        store.write("segment", seg_frame(cx=10, cy=20))
        return (store.read("chip", {"cx": 10, "cy": 20}),
                store.read("segment"), store.count("segment"),
                store.chip_ids("segment"))

    got, want = drive(t), drive(j)
    assert got == want
    assert got[0]["dates"][0] == ["1999-01-01", "1999-02-01"]
    assert got[1]["blcoef"][0] == [0.1, 0.2, 0.3]
    assert got[2:] == (1, {(10, 20)})
    assert ts.log == js.log
    assert ts.tables == js.tables


def test_cassandra_schema_parity_with_jax():
    """The DDL mirrors resources/schema.cql's keys: partition key = the
    first two key columns, the rest clustering; the same statements as
    JAX's, in order."""
    t, ts, j, js = both(keyspace="my-ks!")
    assert ts.ddl == js.ddl
    assert any("CREATE KEYSPACE IF NOT EXISTS my_ks_" in d for d in ts.ddl)
    seg_ddl = next(d for d in ts.ddl if ".segment" in d)
    assert "PRIMARY KEY ((cx, cy), px, py, sday, eday)" in seg_ddl
    assert t.keyspace == j.keyspace


@pytest.mark.parametrize("keyspace", ["my-ks!", "ks", "!prod", "_prod",
                                      "9lives", ""])
def test_cassandra_ddl_generator_matches_backend_and_jax(keyspace):
    from firebird_tpu.store import cassandra_ddl as jddl

    sess = RecordingSession()
    CassandraStore(keyspace=keyspace, session=sess)
    assert sess.ddl == cassandra_ddl(keyspace) == jddl(keyspace)
    assert cassandra_ddl(keyspace, 3) == jddl(keyspace, 3)
    assert sanitize_keyspace(keyspace) == jsanitize(keyspace)


@pytest.mark.parametrize("argv", [["-k", "1bad ks!"], [],
                                  ["-k", "prod", "-r", "3"]])
def test_schema_command_prints_jaxs_output(argv, capsys):
    from click.testing import CliRunner

    from firebird_tpu.cli import entrypoint

    want = CliRunner().invoke(entrypoint, ["schema", *argv])
    assert want.exit_code == 0, want.output
    tmain.main(["schema", *argv])
    assert capsys.readouterr().out == want.output
    assert want.output.rstrip().endswith(";")


def test_cassandra_upsert_and_bounded_writes_as_jax():
    t, ts, j, js = both(keyspace="ks", concurrent_writes=2)
    f = seg_frame(chprob=0.5)
    multi = {k: v * 50 for k, v in f.items()}
    multi["px"] = list(range(50))
    for store in (t, j):
        store.write("segment", multi)
        store.write("segment", seg_frame(chprob=0.9))
        store.write("segment", seg_frame(chprob=0.2))
    assert t.count("segment") == j.count("segment") == 50
    assert ts.max_in_flight <= 3     # 2 waiting + the one being issued
    assert ts.max_in_flight == js.max_in_flight
    assert ts.log == js.log


def test_cassandra_missing_driver_is_clear():
    try:
        import cassandra  # noqa: F401
        pytest.skip("cassandra-driver is installed here")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="cassandra-driver"):
        CassandraStore(keyspace="ks")


def test_column_update_is_a_whole_row_upsert_as_jax_writes_it():
    """A ColumnUpdate (rows read back with rfrawp changed) is upserted
    whole: the CQL and the stored rows equal JAX's write of the same
    frame."""
    t, ts, j, js = both(keyspace="ks")
    for store in (t, j):
        store.write("segment", {k: v * 2 for k, v in seg_frame().items()}
                    | {"px": [3, 4]})
    rows = t.read("segment")
    rows["rfrawp"] = [[0.25, 0.75], [1.0, 0.0]]
    t.write("segment", ColumnUpdate(rows, ["rfrawp"]))
    j.write("segment", dict(j.read("segment"), rfrawp=rows["rfrawp"]))
    assert ts.log == js.log
    assert t.read("segment") == j.read("segment")
    assert sorted(map(tuple, t.read("segment")["rfrawp"])) == \
        [(0.25, 0.75), (1.0, 0.0)]


def test_read_of_named_columns_selects_them():
    t, ts, *_ = both(keyspace="ks")
    t.write("segment", seg_frame(cx=10, cy=20))
    ts.log.clear()
    got = t.read("segment", {"cx": 10, "cy": 20},
                 columns=["px", "py", "sday", "blcoef"])
    assert ts.log == [("execute", "SELECT px, py, sday, blcoef FROM "
                       "ks.segment WHERE cx = %s AND cy = %s ALLOW FILTERING",
                       (10, 20))]
    whole = t.read("segment", {"cx": 10, "cy": 20})
    assert got == {c: whole[c] for c in ("px", "py", "sday", "blcoef")}


@pytest.mark.parametrize("argv", [["schema"], ["lint", "-q"]])
def test_schema_and_lint_start_without_torch(argv):
    """``schema`` and ``lint`` are host-only commands: they load neither
    torch nor the detector."""
    code = ("import sys\nfrom firebird_tpu_torch import __main__ as m\n"
            "try:\n    m.main(sys.argv[1:])\nexcept SystemExit as e:\n"
            "    print('exit', e.code)\n"
            "print('loaded', sorted(n for n in ('torch', 'scipy', "
            "'firebird_tpu_torch.ccd.kernel') if n in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded []", out.stdout

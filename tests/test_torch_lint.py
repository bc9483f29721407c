"""The port's firebird-lint (firebird_tpu_torch/analysis) against the JAX
package's, on tests/test_lint.py's fixtures.

The port lints its own package: each fixture repo is built twice, once as
tests/test_lint.py builds it for the JAX linter and once with its python
files under ``firebird_tpu_torch/`` (and module paths named so) for the
port's.  The findings must be JAX's, rule, line and message; only the
package path differs, and the metrics-contract messages list README.md
among the documents read (the port's own metrics table lives there).  The
engine's mechanics (suppressions, baseline, filters, parse errors, the
CLI) are held to JAX's on a finding of another family where JAX's tests
use a jax-hotpath one; baselines and ``--json`` reports cross between the
packages both ways; ``--rules jax-hotpath`` is refused by name; and the
port's package lints clean against its committed (empty) baseline.
"""

import json
import textwrap
from pathlib import Path

import pytest

from firebird_tpu.analysis import Baseline as JBaseline
from firebird_tpu.analysis import engine as jengine
from firebird_tpu.analysis import run_lint as jrun_lint
from firebird_tpu_torch.analysis import Baseline, run_lint
from firebird_tpu_torch.analysis import engine
from tests.test_lint import KNOB_CONFIG, KNOB_README, METRIC_DOCS

PKG = "firebird_tpu_torch"


def build(root, files):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(root)


def port_layout(files):
    """The fixture as the port's linter reads it: every python file inside
    the package, its repo paths and module names the port's."""
    out = {}
    for rel, text in files.items():
        if rel.endswith(".py"):
            rel = (PKG + rel[len("firebird_tpu"):]
                   if rel.startswith("firebird_tpu/") else f"{PKG}/{rel}")
        out[rel] = (textwrap.dedent(text)
                    .replace("firebird_tpu.", f"{PKG}.")
                    .replace('"other.py"', f'"{PKG}/other.py"'))
    return out


def norm(findings, pkg):
    """Findings with the package path taken out of paths and messages."""
    strip = lambda s: s.replace(f"{pkg}/", "").replace(", README.md", "")
    return [(f.rule, strip(f.path), f.line, strip(f.message))
            for f in findings]


def both(tmp_path, files, **kw):
    j = jrun_lint(build(tmp_path / "jax", files), **kw)
    t = run_lint(build(tmp_path / "port", port_layout(files)), **kw)
    return j, t


BAD_GLOBAL = """
    def f():
        global _g
        _g = 1
"""

OWNED = """
    import threading

    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self._q = []  # guarded-by: _lock

        def ok(self):
            with self._lock:
                self._q.append(1)

        def ok_locked(self):
            self._q.append(2)

        def bad(self):
            return len(self._q)
"""

CASES = {
    "knob_unregistered_and_reader_drift": {
        "firebird_tpu/config.py": KNOB_CONFIG, "README.md": KNOB_README,
        "other.py": """
            import os

            def f():
                a = os.environ.get("FIREBIRD_UNKNOWN")     # unregistered
                b = os.environ.get("FIREBIRD_GOOD")        # reader drift
                c = os.environ.get("FIREBIRD_SECRET")      # declared reader
                return a, b, c
        """},
    "knob_dead_undocumented_stale_and_field": {
        "firebird_tpu/config.py": KNOB_CONFIG, "README.md": KNOB_README},
    "env_knob_call_of_unregistered_name": {
        "firebird_tpu/config.py": KNOB_CONFIG,
        "firebird_tpu/mod.py": """
            from firebird_tpu.config import env_knob

            def f():
                return env_knob("FIREBIRD_NOT_REGISTERED")
        """},
    "knob_registry_required": {"firebird_tpu/config.py": "X = 1\n"},
    "metric_rules": {
        "docs/OBSERVABILITY.md": METRIC_DOCS,
        "firebird_tpu/work.py": """
            from firebird_tpu.obs.metrics import counter, gauge, histogram

            def f():
                counter("good_total", help="fine").add(1)
                counter("Bad-Name").add(1)                   # metric-name
                gauge("queue_total").set(2)                  # total-suffix
                gauge("prose_documented", help="h").set(1)
                histogram("undoc_seconds", help="h").observe(1)
        """},
    "metric_dynamic_name_matches_doc_wildcard": {
        "docs/OBSERVABILITY.md": """
            | Metric | Kind | Meaning |
            |---|---|---|
            | `stream_*` | gauge | per-run streaming summary values |
        """,
        "firebird_tpu/s.py": """
            from firebird_tpu.obs.metrics import gauge

            def put(k, v):
                gauge(f"stream_{k}", help="summary value").set(v)
        """},
    "span_rules_both_directions": {
        "firebird_tpu/obs/report.py": """
            SPAN_NAMES = ("fetch", "ghost")
            DRIVER_SPAN_NAMES = ("fetch", "rogue")
        """,
        "firebird_tpu/work.py": """
            from firebird_tpu.obs import tracing

            def f():
                with tracing.span("fetch", chips=2):
                    pass
                with tracing.span("mystery"):
                    pass
        """,
        "docs/OBSERVABILITY.md": """
            | Span | Kind | Where |
            |---|---|---|
            | `fetch` | span | documented and declared |
            | `stale_span` | span | documented but undeclared |
        """},
    "span_rules_clean": {
        "firebird_tpu/obs/report.py": 'SPAN_NAMES = ("drain",)\n',
        "firebird_tpu/w.py": """
            from firebird_tpu.obs import tracing

            def f():
                with tracing.span("drain"):
                    pass
        """,
        "docs/OBSERVABILITY.md": """
            | Span | Kind | Where |
            |---|---|---|
            | `drain` | span | fine |
        """},
    "span_rules_skip_without_catalog": {
        "firebird_tpu/w.py": """
            from firebird_tpu.obs import tracing

            def f():
                with tracing.span("anything"):
                    pass
        """},
    "span_match_span_method_without_name_is_ignored": {
        "firebird_tpu/obs/report.py": 'SPAN_NAMES = ("drain",)\n',
        "docs/OBSERVABILITY.md": "| `drain` | span | fine |\n",
        "firebird_tpu/w.py": """
            import re
            from firebird_tpu.obs import tracing

            def f(m: re.Match, nm):
                a, b = m.span()
                with tracing.span(nm):       # non-literal: not checkable
                    pass
                with tracing.span("drain"):
                    pass
        """},
    "ownership_unguarded_attr": {"mod.py": OWNED},
    "ownership_nested_def_resets_lock_context": {"mod.py": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = []  # guarded-by: _lock

            def spawn(self):
                with self._lock:
                    def worker():
                        self._q.append(1)
                    return worker
    """},
    "ownership_globals": {"mod.py": """
        import threading

        _lock = threading.Lock()
        _state = None  # guarded-by: _lock
        _latch = False

        def ok():
            global _state
            with _lock:
                _state = 1

        def bad_annotated():
            global _state
            _state = 2

        def bad_unannotated():
            global _latch
            _latch = True

        def ok_under_some_lock():
            global _latch
            with _lock:
                _latch = True
    """},
    "ownership_annotation_on_first_body_line": {"mod.py": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._v = 0  # guarded-by: _lock

            def bump(self):
                self._v += 1  # guarded-by: _lock

            def held(self):  # guarded-by: _lock
                self._v += 1
    """},
    "ownership_annotation_on_continuation_line": {"mod.py": """
        import threading
        import collections

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._entries: collections.OrderedDict = \\
                    collections.OrderedDict()  # guarded-by: _lock

            def bad(self):
                return self._entries.get(1)
    """},
    "ownership_nested_global_does_not_leak": {"mod.py": """
        def outer():
            x = 1

            def inner():
                global x
                x = 2
            return x
    """},
    "suppression_line_and_file": {
        "a.py": """
            def f():
                global _g
                _g = 1  # firebird-lint: disable=ownership-global-mutation
        """,
        "b.py": """
            # firebird-lint: disable-file=ownership-global-mutation
            def f():
                global _g
                _g = 1

            def g():
                global _h
                _h = 2
        """},
    "suppression_inside_string_literal_is_inert": {"a.py": '''
        HELP = "silence: '# firebird-lint: disable-file=ownership-global-mutation'"

        def f():
            """Docs: use `# firebird-lint: disable=ownership-global-mutation`."""
            global _g
            _g = 1
    '''},
    "suppression_is_rule_scoped": {"a.py": """
        def f():
            global _g
            _g = 1  # firebird-lint: disable=knob-dead
    """},
    "parse_error_is_a_finding": {"broken.py": "def f(:\n"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_equal_jax(case, tmp_path):
    j, t = both(tmp_path, CASES[case])
    assert norm(t.findings, PKG) == norm(j.findings, "firebird_tpu")
    assert norm(t.parse_errors, PKG) == norm(j.parse_errors, "firebird_tpu")
    assert (t.suppressed, t.files_scanned, t.clean) == \
        (j.suppressed, j.files_scanned, j.clean)


def test_the_port_scans_only_its_package(tmp_path):
    """Files outside firebird_tpu_torch/, and its tests and bytecode, are
    not the port's: it scans none of them."""
    root = build(tmp_path, {"mod.py": BAD_GLOBAL,
                            "firebird_tpu/mod.py": BAD_GLOBAL,
                            f"{PKG}/tests/test_x.py": BAD_GLOBAL,
                            f"{PKG}/__pycache__/junk.py": BAD_GLOBAL})
    res = run_lint(root)
    assert res.files_scanned == 0 and res.clean


@pytest.mark.parametrize("only", [["thread-ownership"], ["knob-*"],
                                  ["ownership-global-mutation"]])
def test_rule_filtering_by_family_and_glob_as_jax(only, tmp_path):
    files = {"firebird_tpu/config.py": KNOB_CONFIG, "README.md": KNOB_README,
             "mod.py": BAD_GLOBAL}
    j, t = both(tmp_path, files, only=only)
    assert norm(t.findings, PKG) == norm(j.findings, "firebird_tpu")
    assert {f.rule for f in t.findings}
    assert len(t.all_findings) > len(t.findings)


def test_baseline_roundtrip_absorbs_then_surfaces_regression(tmp_path):
    root = build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL})
    first = run_lint(root)
    assert len(first.new) == 1
    bpath = str(tmp_path / "lint_baseline.json")
    Baseline().save(bpath, first.findings)
    assert len(Baseline.load(bpath)) == 1
    again = run_lint(root, baseline=Baseline.load(bpath))
    assert again.clean and len(again.known) == 1 and not again.new
    # A second identical violation exceeds the baseline count: new.
    build(tmp_path, {f"{PKG}/b.py": BAD_GLOBAL.replace("_g", "_h")
                     .replace("def f", "def g")})
    build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL + BAD_GLOBAL.replace(
        "def f", "def f2")})
    worse = run_lint(root, baseline=Baseline.load(bpath))
    assert len(worse.known) == 1 and len(worse.new) == 2
    assert not worse.clean


def test_baseline_fingerprint_is_line_independent(tmp_path):
    root = build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL})
    bpath = str(tmp_path / "b.json")
    Baseline().save(bpath, run_lint(root).findings)
    build(tmp_path, {f"{PKG}/a.py": "# pad\n" * 20
                     + textwrap.dedent(BAD_GLOBAL)})
    assert run_lint(root, baseline=Baseline.load(bpath)).clean


def test_baseline_rejects_unknown_schema(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"schema": "nope/9", "findings": {}}))
    with pytest.raises(ValueError):
        Baseline.load(str(p))
    with pytest.raises(ValueError):
        JBaseline.load(str(p))


def test_baselines_and_reports_cross_both_ways(tmp_path):
    """A baseline either package writes absorbs the other's findings of
    the same repo (their fingerprints are one format), and the --json
    reports carry one schema and one set of keys."""
    root = build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL})
    port, jax = run_lint(root), jrun_lint(root)
    ours = [f for f in jax.findings if f.path.startswith(PKG)]
    assert [f.fingerprint for f in ours] == \
        [f.fingerprint for f in port.findings]
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    Baseline().save(a, port.findings)
    JBaseline().save(b, ours)
    assert open(a).read() == open(b).read()
    assert jrun_lint(root, baseline=JBaseline.load(a)).new == \
        [f for f in jax.findings if not f.path.startswith(PKG)]
    assert run_lint(root, baseline=Baseline.load(b)).clean
    ra, rb = str(tmp_path / "ra.json"), str(tmp_path / "rb.json")
    assert engine.main(["--root", root, "--no-baseline", "--json", ra]) == 1
    jengine.main(["--root", root, "--no-baseline", "--json", rb])
    da, db = json.load(open(ra)), json.load(open(rb))
    assert da.keys() == db.keys() and da["schema"] == db["schema"]
    assert da["per_rule"] == {"ownership-global-mutation": 1}
    assert Baseline().split(port.findings)[0] == port.findings


def test_cli_exit_codes_update_baseline_and_json(tmp_path):
    root = build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL})
    bpath = str(tmp_path / "lint_baseline.json")
    jpath = str(tmp_path / "out" / "lint_report.json")
    argv = ["--root", root, "--baseline", bpath]
    assert engine.main(argv + ["--json", jpath]) == 1
    doc = json.loads((tmp_path / "out" / "lint_report.json").read_text())
    assert doc["schema"] == engine.REPORT_SCHEMA == jengine.REPORT_SCHEMA
    assert doc["clean"] is False and doc["new_count"] == 1
    assert engine.main(argv + ["--update-baseline"]) == 0
    assert engine.main(argv + ["--json", jpath]) == 0
    doc = json.loads((tmp_path / "out" / "lint_report.json").read_text())
    assert doc["clean"] is True and doc["baselined_count"] == 1
    assert engine.main(argv + ["--no-baseline"]) == 1


def test_update_baseline_with_rules_filter_keeps_other_families(tmp_path):
    root = build(tmp_path, port_layout({
        "firebird_tpu/config.py": KNOB_CONFIG, "README.md": KNOB_README,
        "mod.py": BAD_GLOBAL}))
    bpath = str(tmp_path / "lint_baseline.json")
    argv = ["--root", root, "--baseline", bpath]
    assert engine.main(argv + ["--rules", "knob-*",
                               "--update-baseline"]) == 0
    doc = json.loads((tmp_path / "lint_baseline.json").read_text())
    assert any(k.startswith("ownership-") for k in doc["findings"])
    assert engine.main(argv) == 0


def test_update_baseline_refreshes_json_report(tmp_path):
    root = build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL})
    bpath = str(tmp_path / "lint_baseline.json")
    jpath = str(tmp_path / "lint_report.json")
    argv = ["--root", root, "--baseline", bpath, "--json", jpath]
    assert engine.main(argv) == 1
    assert engine.main(argv + ["--update-baseline"]) == 0
    doc = json.loads((tmp_path / "lint_report.json").read_text())
    assert doc["clean"] is True and doc["baselined_count"] == 1


def test_update_baseline_refuses_parse_errors(tmp_path):
    root = build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL,
                            f"{PKG}/broken.py": "def f(:\n"})
    bpath = str(tmp_path / "lint_baseline.json")
    assert engine.main(["--root", root, "--baseline", bpath,
                        "--update-baseline"]) == 1
    assert not (tmp_path / "lint_baseline.json").exists()


def test_rule_catalog_is_populated_without_jax_hotpath():
    engine._load_families()
    jengine._load_families()
    assert {"knob-unregistered-read", "metric-doc-stale",
            "ownership-unguarded-attr", "span-dead",
            "slo-metric-unknown"} <= set(engine.RULE_DOCS)
    assert all(engine.RULE_DOCS.values())
    assert engine.families() == ["knob-registry", "metrics-contract",
                                 "thread-ownership"]
    assert set(engine.RULE_DOCS) == {r for r in jengine.RULE_DOCS
                                     if not r.startswith("hotpath-")}


@pytest.mark.parametrize("rules", ["jax-hotpath", "hotpath-*",
                                   "knob-*,hotpath-host-sync"])
def test_jax_hotpath_is_refused_by_name(rules, tmp_path, capsys):
    root = build(tmp_path, {f"{PKG}/a.py": BAD_GLOBAL})
    assert engine.main(["--root", root, "--rules", rules]) == 2
    assert "jax-hotpath is not ported" in capsys.readouterr().out
    assert engine.main(["--root", root, "--rules", "*"]) == 1


def test_the_port_lints_clean_against_its_committed_baseline():
    root = engine.default_root()
    bl = Baseline.load(engine.default_baseline(root))
    assert len(bl) == 0
    res = run_lint(root, baseline=bl)
    assert res.files_scanned > 90
    assert not res.parse_errors
    assert res.clean, "new findings:\n" + "\n".join(str(f) for f in res.new)


def test_jax_only_knobs_are_registered_and_read_by_no_port_module():
    """The knobs the port's dead-knob rule counts as referenced
    (``analysis.knobs.JAX_ONLY``) are registered, and no module of the
    port names them outside the registry: they act on the JAX package
    alone."""
    from firebird_tpu_torch import config as tconfig
    from firebird_tpu_torch.analysis import knobs

    assert knobs.JAX_ONLY <= set(tconfig.KNOBS_BY_NAME)
    pkg = Path(engine.default_root()) / "firebird_tpu_torch"
    skip = {pkg / "config.py", pkg / "analysis" / "knobs.py"}
    for path in pkg.rglob("*.py"):
        if path not in skip:
            found = set(knobs.KNOB_RE.findall(path.read_text()))
            assert not found & knobs.JAX_ONLY, path

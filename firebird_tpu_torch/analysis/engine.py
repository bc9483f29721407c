"""firebird-lint engine: findings, suppressions, baseline, and the runner.

The port's own copy of the JAX package's ``analysis/engine.py``.  It lints
the port's package (``firebird_tpu_torch/``) against the port's own
registries: its ``config.KNOBS``, its ``obs/metrics.py``, span catalog
and SLO module, the docs' metric tables and the port's metrics table in
README.md.  Three families are ported: knob-registry, metrics-contract
and thread-ownership.  The JAX package's fourth, jax-hotpath, checks
``jax.jit`` functions, ``lax`` control-flow bodies, ``pallas_call`` and
the AOT seam's ``_WIRE_STATICS``, none of which the port has; asking for
it is refused by name.  The committed baseline lives inside the package
(``analysis/lint_baseline.json``).

The port's correctness rests on cross-cutting contracts that no unit
test can see whole: ``FIREBIRD_*`` knobs vs the config registry and the
docs, obs instruments vs the metric tables, and lock-guarded shared state
across the prefetch/drain/writer/serve threads.  Every contract is an
AST-checkable invariant, so it is checked by ``python -m
firebird_tpu_torch lint`` instead of in review.

Machinery (this module; the rule families live in sibling modules):

- :class:`Finding` — one violation: rule id, file, line, message.
- **Suppressions** — ``# firebird-lint: disable=<rule>[,<rule>...]`` on
  the offending line silences those rules for that line;
  ``# firebird-lint: disable-file=<rule>`` anywhere in a file silences a
  rule for the whole file.  Every suppression is counted in the summary
  so a suppression-heavy file is visible.
- **Baseline** — a committed JSON file of grandfathered finding
  fingerprints (rule|path|message, line-independent so findings survive
  unrelated edits).  The linter fails only on findings NOT in the
  baseline; ``--update-baseline`` rewrites it from the current state.
- **JSON summary** — ``--json`` writes a machine-readable report (the
  JAX package's schema).

Rules register through :func:`rule`; the runner parses each source file
once and hands every rule the same :class:`LintContext`.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import os
import re

BASELINE_SCHEMA = "firebird-lint-baseline/1"
REPORT_SCHEMA = "firebird-lint-report/1"

# Directories/files never scanned: tests seed deliberate violations as
# fixtures, __pycache__ is bytecode, __graft_entry__ is harness glue.
EXCLUDE_PARTS = ("__pycache__", "tests", ".git", "deploy")
EXCLUDE_FILES = ("__graft_entry__.py",)
# The package linted: every scanned file lies under <root>/PACKAGE/.
PACKAGE = "firebird_tpu_torch"
# The JAX package's rule family with no counterpart here, and why.
NOT_PORTED_FAMILIES = {
    "jax-hotpath": "its targets (jax.jit functions, lax control-flow "
                   "bodies, pallas_call and the AOT seam's _WIRE_STATICS) "
                   "do not exist in firebird_tpu_torch"}

_SUPPRESS_RE = re.compile(
    r"#\s*firebird-lint:\s*(disable|disable-file)=([A-Za-z0-9_,-]+)")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str        # repo-relative, '/'-separated
    line: int
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-independent identity for the baseline: unrelated edits
        move line numbers constantly, but (rule, file, message) is stable
        until the finding itself is fixed or duplicated."""
        return f"{self.rule}|{self.path}|{self.message}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


class SourceFile:
    """One parsed source file shared by every rule (parse once)."""

    def __init__(self, root: str, relpath: str):
        self.relpath = relpath
        self.abspath = os.path.join(root, relpath)
        with open(self.abspath, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self._tree: ast.Module | None = None
        # line -> set of rule ids disabled on that line; "*-file" entries
        # land in file_disabled.
        self.line_disabled: dict[int, set[str]] = {}
        self.file_disabled: set[str] = set()
        # line -> lock name from a `# guarded-by: <lock>` annotation
        # (the thread-ownership convention; parsed here so the comment
        # syntax has exactly one parser).
        self.guarded_by: dict[int, str] = {}
        for i, ln in self._comments():
            m = _SUPPRESS_RE.search(ln)
            if m:
                rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
                if m.group(1) == "disable-file":
                    self.file_disabled |= rules
                else:
                    self.line_disabled.setdefault(i, set()).update(rules)
            g = _GUARDED_RE.search(ln)
            if g:
                self.guarded_by[i] = g.group(1)

    def _comments(self):
        """(line, comment_text) for every REAL comment token — a string
        literal quoting the suppression syntax (help text, a docstring
        documenting it) must not disable rules.  Falls back to a raw
        line scan when the file does not tokenize (it will fail to parse
        and surface as a parse-error finding anyway)."""
        import io
        import tokenize

        out = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    out.append((tok.start[0], tok.string))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return [(i, ln) for i, ln in enumerate(self.lines, start=1)
                    if "#" in ln]
        return out

    @property
    def tree(self) -> ast.Module:
        if self._tree is None:
            self._tree = ast.parse(self.text, filename=self.relpath)
        return self._tree

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_disabled:
            return True
        return rule in self.line_disabled.get(line, set())


class LintContext:
    """Everything a rule needs: the parsed python sources, the repo root
    (for docs and shell scripts), and a Finding factory that applies
    suppressions at emit time."""

    def __init__(self, root: str, sources: list[SourceFile]):
        self.root = root
        self.sources = sources
        self.by_path = {s.relpath: s for s in sources}
        self.findings: list[Finding] = []
        self.suppressed_count = 0

    def source(self, relpath: str) -> SourceFile | None:
        return self.by_path.get(relpath)

    def read_text(self, relpath: str) -> str | None:
        """A non-python repo file (docs, shell scripts); None if absent."""
        p = os.path.join(self.root, relpath)
        if not os.path.exists(p):
            return None
        with open(p, encoding="utf-8") as f:
            return f.read()

    def emit(self, rule: str, src: SourceFile | str, line: int,
             message: str) -> None:
        path = src.relpath if isinstance(src, SourceFile) else src
        sf = src if isinstance(src, SourceFile) else self.by_path.get(src)
        if sf is not None and sf.suppressed(rule, line):
            self.suppressed_count += 1
            return
        self.findings.append(Finding(rule, path, line, message))


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------

# family -> [(rule_prefix_doc, fn)]; each fn(ctx) emits via ctx.emit.
_CHECKERS: dict[str, list] = {}
# rule id -> one-line description (the `--list-rules` catalog; docs'
# rule table is generated from the same declarations).
RULE_DOCS: dict[str, str] = {}


def rule(family: str, rules: dict[str, str]):
    """Register a checker function under ``family``, declaring the rule
    ids it may emit (id -> one-line description)."""

    def deco(fn):
        _CHECKERS.setdefault(family, []).append(fn)
        for rid, doc in rules.items():
            RULE_DOCS[rid] = doc
        return fn

    return deco


def families() -> list[str]:
    return sorted(_CHECKERS)


def _load_families() -> None:
    # Import side effect registers the checkers; deferred so engine.py
    # itself is importable by the rule modules without a cycle.
    from firebird_tpu_torch.analysis import (knobs,  # noqa: F401
                                             metrics_contract, ownership)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

class Baseline:
    """Grandfathered findings: fingerprint -> count.

    Counts (not a set) so two identical findings in one file — same rule,
    same message — are two baseline slots: fixing one of them is progress
    the linter can see.
    """

    def __init__(self, counts: dict[str, int] | None = None):
        self.counts = dict(counts or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("schema") != BASELINE_SCHEMA:
            raise ValueError(f"unrecognized baseline schema in {path}: "
                             f"{doc.get('schema')!r}")
        return cls(doc.get("findings", {}))

    def save(self, path: str, findings: list[Finding]) -> None:
        counts: dict[str, int] = {}
        for f in findings:
            counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
        doc = {"schema": BASELINE_SCHEMA,
               "findings": dict(sorted(counts.items()))}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        self.counts = counts

    def split(self, findings: list[Finding]) -> tuple[list[Finding],
                                                      list[Finding]]:
        """(new, known): each baseline slot absorbs at most its count."""
        budget = dict(self.counts)
        new, known = [], []
        for f in findings:
            fp = f.fingerprint
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                known.append(f)
            else:
                new.append(f)
        return new, known

    def __len__(self) -> int:
        return sum(self.counts.values())


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def discover(root: str) -> list[str]:
    """Repo-relative python files the linter scans: those of the package
    (``<root>/firebird_tpu_torch/``)."""
    out = []
    top = os.path.join(root, PACKAGE)
    for base, dirs, names in os.walk(top):
        rel = os.path.relpath(base, root)
        parts = rel.split(os.sep)
        if any(p in EXCLUDE_PARTS or p.startswith(".") for p in parts):
            dirs[:] = []
            continue
        dirs[:] = [d for d in dirs
                   if d not in EXCLUDE_PARTS and not d.startswith(".")]
        for n in sorted(names):
            if n.endswith(".py") and n not in EXCLUDE_FILES:
                out.append("/".join(parts + [n]))
    return sorted(out)


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]          # post-suppression, pre-baseline
    new: list[Finding]               # not absorbed by the baseline
    known: list[Finding]             # absorbed by the baseline
    suppressed: int
    files_scanned: int
    parse_errors: list[Finding]
    # Findings before any --rules filter: what --update-baseline must
    # record, or refreshing one family would silently drop every other
    # family's grandfathered slots.
    all_findings: list[Finding] = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.new and not self.parse_errors

    def summary(self) -> dict:
        per_rule: dict[str, int] = {}
        for f in self.findings:
            per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
        return {
            "schema": REPORT_SCHEMA,
            "clean": self.clean,
            "files_scanned": self.files_scanned,
            "findings": len(self.findings),
            "new": [str(f) for f in self.new],
            "new_count": len(self.new),
            "baselined_count": len(self.known),
            "suppressed_count": self.suppressed,
            "per_rule": dict(sorted(per_rule.items())),
            "parse_errors": [str(f) for f in self.parse_errors],
        }


def run_lint(root: str, baseline: Baseline | None = None,
             only: list[str] | None = None) -> LintResult:
    """Run every registered rule family over the repo at ``root``.

    ``only`` filters to rule families or individual rule ids (glob
    patterns accepted: ``knob-*``).
    """
    _load_families()
    sources, parse_errors = [], []
    paths = discover(root)
    for relpath in paths:
        try:
            src = SourceFile(root, relpath)
            src.tree  # parse now: a syntax error is itself a finding
        except (SyntaxError, UnicodeDecodeError) as e:
            line = getattr(e, "lineno", 0) or 0
            parse_errors.append(Finding("parse-error", relpath, line,
                                        f"cannot parse: {e}"))
            continue
        sources.append(src)
    ctx = LintContext(root, sources)
    for family in families():
        for fn in _CHECKERS[family]:
            fn(ctx)
    all_findings = sorted(ctx.findings,
                          key=lambda f: (f.path, f.line, f.rule, f.message))
    findings = all_findings
    if only:
        findings = [f for f in findings
                    if _selected(f.rule, only)
                    or _selected(_rule_family(f.rule), only)]
    base = baseline or Baseline()
    new, known = base.split(findings)
    return LintResult(findings=findings, new=new, known=known,
                      suppressed=ctx.suppressed_count,
                      files_scanned=len(sources),
                      parse_errors=parse_errors,
                      all_findings=all_findings)


_FAMILY_PREFIX = {"jax-hotpath": "hotpath-", "knob-registry": "knob-",
                  "metrics-contract": "metric-",
                  "thread-ownership": "ownership-"}


def _rule_family(rule_id: str) -> str:
    for fam, prefix in _FAMILY_PREFIX.items():
        if rule_id.startswith(prefix):
            return fam
    return rule_id


def _selected(name: str, only: list[str]) -> bool:
    return any(fnmatch.fnmatch(name, pat) for pat in only)


# ---------------------------------------------------------------------------
# CLI (argparse — stdlib-only so `python -m firebird_tpu_torch.analysis`
# needs nothing installed; `python -m firebird_tpu_torch lint` delegates
# here)
# ---------------------------------------------------------------------------

def default_root() -> str:
    """The repo root: the directory holding the firebird_tpu_torch
    package."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def default_baseline(root: str) -> str:
    """The committed baseline: ``<root>/firebird_tpu_torch/analysis/
    lint_baseline.json``."""
    return os.path.join(root, PACKAGE, "analysis", "lint_baseline.json")


def refused_rules(only: list[str]) -> list[str]:
    """The ``--rules`` patterns that name a family this package does not
    port: the family itself (``jax-hotpath``, ``jax-*``) or its rule ids
    (``hotpath-*``).  A pattern that selects every family (``*``) selects
    the ported ones."""
    _load_families()
    return [p for p in only for fam in NOT_PORTED_FAMILIES
            if p.startswith(_FAMILY_PREFIX[fam])
            or _selected(fam, [p])
            and not all(_selected(f, [p]) for f in families())]


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m firebird_tpu_torch lint",
        description="AST contract checker of firebird_tpu_torch: "
                    "FIREBIRD_* knobs, obs metrics, thread ownership "
                    "(docs/STATIC_ANALYSIS.md; jax-hotpath is not ported)")
    ap.add_argument("--root", default=default_root(),
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <root>/firebird_tpu_torch/"
                         "analysis/lint_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding as new")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "and exit 0")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the machine-readable summary here")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families or rule ids "
                         "(globs ok), e.g. 'knob-*,metrics-contract'")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the summary line")
    args = ap.parse_args(argv)

    if args.list_rules:
        _load_families()
        for rid in sorted(RULE_DOCS):
            print(f"{rid}: {RULE_DOCS[rid]}")
        return 0

    only = ([p.strip() for p in args.rules.split(",") if p.strip()]
            if args.rules else None)
    refused = refused_rules(only or [])
    if refused:
        for fam, why in NOT_PORTED_FAMILIES.items():
            print(f"firebird-lint: --rules {','.join(refused)}: {fam} is "
                  f"not ported to {PACKAGE}: {why}")
        return 2
    bpath = args.baseline or default_baseline(args.root)
    baseline = Baseline() if args.no_baseline else Baseline.load(bpath)
    result = run_lint(args.root, baseline=baseline, only=only)

    if args.update_baseline:
        if result.parse_errors:
            # An unparseable file ran zero rules: the findings snapshot
            # is incomplete, and grandfathering it would hide that until
            # the next plain run.
            for f in result.parse_errors:
                print(str(f))
            print("baseline NOT updated: fix the parse error(s) first")
            return 1
        # Always from the unfiltered findings: a --rules run still
        # rewrites the WHOLE baseline, never just the selected family.
        baseline.save(bpath, result.all_findings)
        print(f"baseline updated: {len(result.all_findings)} finding(s) "
              f"recorded in {bpath}")
        if args.json_path:
            # Re-split against the just-saved baseline so a --json
            # report written alongside the update reflects the NEW
            # state (everything absorbed).
            result.new, result.known = baseline.split(result.findings)
            _write_json(args.json_path, result)
        return 0

    if not args.quiet:
        for f in result.parse_errors:
            print(str(f))
        for f in result.new:
            print(str(f))
    status = "clean" if result.clean else "FAILED"
    print(f"firebird-lint: {status} — {result.files_scanned} files, "
          f"{len(result.new)} new, {len(result.known)} baselined, "
          f"{result.suppressed} suppressed")
    if args.json_path:
        _write_json(args.json_path, result)
    return 0 if result.clean else 1


def _write_json(path: str, result: LintResult) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(result.summary(), f, indent=1)
        f.write("\n")

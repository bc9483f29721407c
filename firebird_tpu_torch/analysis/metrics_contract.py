"""metrics-contract rules: obs instruments vs naming, help, and docs.

The obs registry (obs/metrics.py) is get-or-create by name from ~50
call sites across 15 modules — nothing ever forced a new instrument to
(a) survive Prometheus exposition (``PROM_LINE_RE``), (b) carry a
``# HELP`` body, or (c) land in the docs' metric tables.  These rules
close all three loops, both directions: every registered instrument
must be documented, and every metric a docs table declares must still
have a registration site (so a renamed counter cannot leave a stale
table row behind).

Registration sites are AST call sites of ``counter(...)`` /
``gauge(...)`` / ``histogram(...)`` — the module helpers, the
``obs_metrics.*`` aliases, and registry-method calls alike.  Dynamic
names (f-strings like ``f"stream_{k}"``) become ``stream_*`` patterns
and match docs wildcards (``stream_*``) or placeholder spellings
(``faults_injected_<scope>``, ``serve_requests_{segments,pixel}``).
"""

from __future__ import annotations

import ast
import re

from firebird_tpu_torch.analysis.engine import PACKAGE, LintContext, rule

METRICS_MODULE = f"{PACKAGE}/obs/metrics.py"

# Mirrors obs.metrics._prom_name's input expectations: what the
# sanitizer would have to rewrite is what we reject at the source.
NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Files whose metric tables / code spans document instruments.  A metric
# may be documented in any of them; table rows in any of them must
# resolve to a live registration.  The JAX package's four, and README.md,
# whose port section holds the table of the port's own metrics.
DOC_FILES = ("docs/OBSERVABILITY.md", "docs/ROBUSTNESS.md",
             "docs/SERVING.md", "docs/ROOFLINE.md", "README.md")

_KINDS = {"counter", "gauge", "histogram"}


class Site:
    def __init__(self, kind: str, name: str, dynamic: bool,
                 src, line: int, has_help: bool):
        self.kind = kind
        self.name = name          # literal name, or the '*' pattern
        self.dynamic = dynamic
        self.src = src
        self.line = line
        self.has_help = has_help


def _name_arg(node: ast.Call) -> tuple[str, bool] | None:
    """(name_or_pattern, dynamic) from the call's first argument."""
    if not node.args:
        return None
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, False
    if isinstance(a, ast.JoinedStr):
        parts = [str(v.value) if isinstance(v, ast.Constant) else "*"
                 for v in a.values]
        return "".join(parts), True
    return None


def collect_sites(ctx: LintContext) -> list[Site]:
    sites = []
    for src in ctx.sources:
        if not src.relpath.startswith(f"{PACKAGE}/"):
            continue
        if src.relpath == METRICS_MODULE:
            continue  # the registry's own plumbing, not instrumentation
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            kind = None
            if isinstance(f, ast.Name) and f.id in _KINDS:
                kind = f.id
            elif isinstance(f, ast.Attribute) and f.attr in _KINDS:
                kind = f.attr
            if kind is None:
                continue
            named = _name_arg(node)
            if named is None:
                continue
            name, dynamic = named
            has_help = any(k.arg == "help" and not (
                isinstance(k.value, ast.Constant) and k.value.value is None)
                for k in node.keywords)
            sites.append(Site(kind, name, dynamic, src, node.lineno,
                              has_help))
    return sites


# -- docs parsing -----------------------------------------------------------

_CODE_SPAN_RE = re.compile(r"`([^`]+)`")
_BRACE_RE = re.compile(r"\{([^{}]*)\}")
_TABLE_KIND_RE = re.compile(r"^(counter|gauge|histogram)s?\b")
_METRIC_TOKEN_RE = re.compile(r"^[a-z][a-z0-9_*]*$")


def _expand(token: str) -> list[str]:
    """Expand doc spellings into match patterns: ``{a,b}`` alternates
    (including the empty alternate of ``{,_x}``), ``<placeholder>`` and
    literal ``*`` wildcards."""
    token = re.sub(r"<[^<>]+>", "*", token)
    m = _BRACE_RE.search(token)
    if not m:
        return [token]
    head, tail = token[:m.start()], token[m.end():]
    out = []
    for alt in m.group(1).split(","):
        out.extend(_expand(head + alt + tail))
    return out


def doc_patterns(ctx: LintContext) -> dict[str, tuple[str, int]]:
    """Every metric-ish pattern the docs mention anywhere (code spans):
    pattern -> (file, line).  The "is it documented" direction."""
    out: dict[str, tuple[str, int]] = {}
    for rel in DOC_FILES:
        text = ctx.read_text(rel)
        if text is None:
            continue
        for i, line in enumerate(text.splitlines(), start=1):
            for span in _CODE_SPAN_RE.findall(line):
                for tok in _expand(span.strip()):
                    if _METRIC_TOKEN_RE.fullmatch(tok):
                        out.setdefault(tok, (rel, i))
    return out


def doc_table_metrics(ctx: LintContext) -> dict[str, tuple[str, int]]:
    """Metrics DECLARED by a docs table (rows whose second column is a
    counter/gauge/histogram kind): pattern -> (file, line).  The reverse
    direction — these must all resolve to a live registration site."""
    out: dict[str, tuple[str, int]] = {}
    for rel in DOC_FILES:
        text = ctx.read_text(rel)
        if text is None:
            continue
        for i, line in enumerate(text.splitlines(), start=1):
            if not line.lstrip().startswith("|"):
                continue
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) < 2 or not _TABLE_KIND_RE.match(cells[1]):
                continue
            for span in _CODE_SPAN_RE.findall(cells[0]):
                for tok in _expand(span.strip()):
                    if _METRIC_TOKEN_RE.fullmatch(tok):
                        out.setdefault(tok, (rel, i))
    return out


def help_catalog(ctx: LintContext) -> set[str]:
    """Keys of obs.metrics.METRIC_HELP (exact names and glob patterns)
    — the central # HELP fallback a site-less instrument may rely on."""
    src = ctx.source(METRICS_MODULE)
    if src is None:
        return set()
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "METRIC_HELP" \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return set()


def _pattern_match(pattern: str, name: str) -> bool:
    """Glob-ish match where '*' spans word characters; tried both ways
    so a dynamic site (stream_*) matches a docs wildcard (stream_*)."""
    if pattern == name:
        return True
    rex = re.escape(pattern).replace(r"\*", r"[a-z0-9_]+")
    if re.fullmatch(rex, name):
        return True
    rex2 = re.escape(name).replace(r"\*", r"[a-z0-9_]+")
    return re.fullmatch(rex2, pattern) is not None


@rule("metrics-contract", {
    "metric-name":
        "instrument name breaks the Prometheus naming contract",
    "metric-total-suffix":
        "non-counter instrument named *_total (masquerades as a counter)",
    "metric-help":
        "instrument never registered with help text at any call site",
    "metric-undocumented":
        "registered instrument missing from the docs' metric tables/spans",
    "metric-doc-stale":
        "docs table declares a metric with no registration site left",
})
def check_metrics(ctx: LintContext) -> None:
    sites = collect_sites(ctx)
    if not sites:
        return
    docs = doc_patterns(ctx)
    tables = doc_table_metrics(ctx)
    catalog = help_catalog(ctx)

    by_name: dict[tuple[str, str], list[Site]] = {}
    for s in sites:
        by_name.setdefault((s.kind, s.name), []).append(s)

    for (kind, name), group in sorted(by_name.items()):
        first = min(group, key=lambda s: (s.src.relpath, s.line))
        bare = name.replace("*", "x")
        if not NAME_RE.fullmatch(bare) or "__" in bare \
                or bare.endswith("_"):
            ctx.emit("metric-name", first.src, first.line,
                     f"{kind} {name!r} would not survive Prometheus "
                     "exposition (want ^[a-z][a-z0-9_]*$, no '__', no "
                     "trailing '_')")
            continue
        if kind != "counter" and name.endswith("_total"):
            ctx.emit("metric-total-suffix", first.src, first.line,
                     f"{kind} {name!r} ends in _total — that suffix is "
                     "the counter convention (obs.metrics._prom_name)")
        if not any(s.has_help for s in group) \
                and not any(_pattern_match(p, name) for p in catalog):
            ctx.emit("metric-help", first.src, first.line,
                     f"{kind} {name!r} has no help text: pass help= at "
                     "a registration site or add an "
                     "obs.metrics.METRIC_HELP entry")
        if not any(_pattern_match(p, name) for p in docs):
            ctx.emit("metric-undocumented", first.src, first.line,
                     f"{kind} {name!r} is not mentioned in any of "
                     f"{', '.join(DOC_FILES)}")

    # Reverse: every table-declared metric still has a registration.
    live = [s.name for s in sites]
    for pat, (rel, line) in sorted(tables.items()):
        if not any(_pattern_match(pat, p) or _pattern_match(p, pat)
                   for p in live):
            ctx.emit("metric-doc-stale", rel, line,
                     f"docs table declares {pat!r} but no code "
                     "registers it")


# ---------------------------------------------------------------------------
# Span names: call sites vs obs.report.SPAN_NAMES vs the docs span table
# ---------------------------------------------------------------------------

REPORT_MODULE = f"{PACKAGE}/obs/report.py"
SPAN_DOC_FILE = "docs/OBSERVABILITY.md"


def collect_span_sites(ctx: LintContext) -> list[Site]:
    """Every ``tracing.span("name", ...)`` call site (literal or
    f-string first arg) outside the tracer's own module."""
    sites = []
    for src in ctx.sources:
        if not src.relpath.startswith(f"{PACKAGE}/"):
            continue
        if src.relpath == f"{PACKAGE}/obs/tracing.py":
            continue  # the span() factory itself
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not ((isinstance(f, ast.Name) and f.id == "span")
                    or (isinstance(f, ast.Attribute) and f.attr == "span")):
                continue
            named = _name_arg(node)
            if named is None:
                continue  # Match.span() etc: no literal name argument
            name, dynamic = named
            sites.append(Site("span", name, dynamic, src, node.lineno,
                              False))
    return sites


def _report_tuple(ctx: LintContext, var: str) -> dict[str, int]:
    """A literal tuple-of-strings assignment in obs/report.py parsed
    from source (the KNOBS pattern): name -> line, empty when absent."""
    src = ctx.source(REPORT_MODULE)
    if src is None:
        return {}
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == var \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return {e.value: e.lineno for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return {}


def doc_span_table(ctx: LintContext) -> dict[str, tuple[str, int]]:
    """Rows of the OBSERVABILITY.md span table (second cell literally
    ``span``): name -> (file, line)."""
    out: dict[str, tuple[str, int]] = {}
    text = ctx.read_text(SPAN_DOC_FILE)
    if text is None:
        return out
    for i, line in enumerate(text.splitlines(), start=1):
        if not line.lstrip().startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) < 2 or cells[1] != "span":
            continue
        for tok in _CODE_SPAN_RE.findall(cells[0]):
            tok = tok.strip()
            if _METRIC_TOKEN_RE.fullmatch(tok):
                out.setdefault(tok, (SPAN_DOC_FILE, i))
    return out


@rule("metrics-contract", {
    "span-unregistered":
        "span call site uses a name missing from obs.report.SPAN_NAMES",
    "span-dead":
        "SPAN_NAMES declares a span with no call site left",
    "span-undocumented":
        "declared span missing from the OBSERVABILITY.md span table",
    "span-doc-stale":
        "docs span table row with no SPAN_NAMES entry behind it",
})
def check_spans(ctx: LintContext) -> None:
    """Span names agree three ways — call sites, the SPAN_NAMES catalog
    (which DRIVER_SPAN_NAMES must subset), and the docs span table —
    in both directions, the metric-table pattern: a new span cannot
    ship undocumented and a renamed one cannot leave a stale row."""
    declared = _report_tuple(ctx, "SPAN_NAMES")
    if not declared:
        return  # fixture repos without the catalog don't enforce spans
    sites = collect_span_sites(ctx)
    docs = doc_span_table(ctx)

    seen: set[str] = set()
    for s in sites:
        if s.name in seen:
            continue
        seen.add(s.name)
        if s.dynamic:
            if not any(_pattern_match(s.name, d) for d in declared):
                ctx.emit("span-unregistered", s.src, s.line,
                         f"dynamic span name {s.name!r} matches no "
                         "SPAN_NAMES entry (obs/report.py)")
            continue
        if s.name not in declared:
            ctx.emit("span-unregistered", s.src, s.line,
                     f"span {s.name!r} is not declared in "
                     "obs.report.SPAN_NAMES (obs/report.py)")

    live = {s.name for s in sites}
    for name, line in sorted(declared.items()):
        if not any(_pattern_match(name, n) or _pattern_match(n, name)
                   for n in live):
            ctx.emit("span-dead", REPORT_MODULE, line,
                     f"SPAN_NAMES declares {name!r} but no call site "
                     "opens that span")
        if not any(_pattern_match(p, name) for p in docs):
            ctx.emit("span-undocumented", REPORT_MODULE, line,
                     f"span {name!r} is missing from the "
                     f"{SPAN_DOC_FILE} span table")
    # DRIVER_SPAN_NAMES is the driver-stage subset of the catalog — an
    # entry outside SPAN_NAMES means the two tuples drifted apart.
    for name, line in sorted(_report_tuple(ctx,
                                           "DRIVER_SPAN_NAMES").items()):
        if name not in declared:
            ctx.emit("span-unregistered", REPORT_MODULE, line,
                     f"DRIVER_SPAN_NAMES entry {name!r} is not in "
                     "SPAN_NAMES")
    for pat, (rel, line) in sorted(docs.items()):
        if not any(_pattern_match(pat, n) or _pattern_match(n, pat)
                   for n in declared):
            ctx.emit("span-doc-stale", rel, line,
                     f"docs span table declares {pat!r} but "
                     "SPAN_NAMES has no such span")


# ---------------------------------------------------------------------------
# SLO objectives: obs/slo.py OBJECTIVES + default specs vs live metrics
# ---------------------------------------------------------------------------

SLO_MODULE = f"{PACKAGE}/obs/slo.py"

_SPEC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*")


def slo_objectives(ctx: LintContext) -> dict[str, tuple[str, list, int]]:
    """The ``OBJECTIVES`` literal parsed from obs/slo.py source:
    objective name -> (kind, [metric names], line).  A tuple metric
    field (a histogram fallback chain, or a ratio's numerator/
    denominator pair) contributes every member."""
    src = ctx.source(SLO_MODULE)
    if src is None:
        return {}
    out: dict[str, tuple[str, list, int]] = {}
    for node in src.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "OBJECTIVES"
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            if not (isinstance(v, ast.Tuple) and len(v.elts) >= 2):
                continue
            kind = v.elts[0].value \
                if isinstance(v.elts[0], ast.Constant) else ""
            met = v.elts[1]
            if isinstance(met, ast.Constant) and isinstance(met.value,
                                                            str):
                names = [met.value]
            elif isinstance(met, (ast.Tuple, ast.List)):
                names = [e.value for e in met.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)]
            else:
                names = []
            out[k.value] = (str(kind), names, k.lineno)
    return out


def _spec_literal(ctx: LintContext, var: str) -> tuple[str, int] | None:
    """A module-level string-constant assignment in obs/slo.py
    (implicit concatenation folds to one Constant): (value, line)."""
    src = ctx.source(SLO_MODULE)
    if src is None:
        return None
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == var \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            return node.value.value, node.lineno
    return None


@rule("metrics-contract", {
    "slo-metric-unknown":
        "SLO objective reads a metric no call site registers",
    "slo-spec-unknown":
        "SLO spec names an objective missing from OBJECTIVES",
})
def check_slo_objectives(ctx: LintContext) -> None:
    """The SLO layer's names agree with the metric registry: every
    OBJECTIVES metric (histogram/gauge/ratio kinds; watchdog fields are
    report-block keys, not registry instruments) must have a live
    registration site or a METRIC_HELP entry — a typo'd objective
    metric silently evaluates as no-data forever, which the no-data-is-
    zero-burn budget rule would hide indefinitely.  And every objective
    name the default specs (DEFAULT_SPEC, DEFAULT_BUDGET_SPEC) mention
    must exist in OBJECTIVES."""
    objectives = slo_objectives(ctx)
    if not objectives:
        return  # fixture repos without the SLO module don't enforce
    live = [s.name for s in collect_sites(ctx)]
    catalog = help_catalog(ctx)
    for name, (kind, metric_names, line) in sorted(objectives.items()):
        if kind == "watchdog":
            continue
        for m in metric_names:
            if not any(_pattern_match(p, m) for p in live) \
                    and not any(_pattern_match(p, m) for p in catalog):
                ctx.emit("slo-metric-unknown", SLO_MODULE, line,
                         f"objective {name!r} reads metric {m!r} but "
                         "no call site registers it and METRIC_HELP "
                         "has no entry — it would evaluate as no-data "
                         "forever")
    for var in ("DEFAULT_SPEC", "DEFAULT_BUDGET_SPEC"):
        lit = _spec_literal(ctx, var)
        if lit is None:
            continue
        spec, line = lit
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            m = _SPEC_NAME_RE.match(entry)
            if m is None or m.group(0) not in objectives:
                ctx.emit("slo-spec-unknown", SLO_MODULE, line,
                         f"{var} entry {entry!r} names no OBJECTIVES "
                         "key")

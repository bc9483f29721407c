"""knob-registry rules: FIREBIRD_* env vars vs the config.KNOBS registry.

The failure mode this family kills: a knob is added in some module as a
raw ``os.environ.get`` (quick, works), never grows a Config field or a
doc line, and six months later nobody can say whether setting it still
does anything.  At PR 7 time the repo had 52 ``FIREBIRD_*`` knobs read
from 10+ modules with 10 undocumented — exactly the drift these rules
now fail CI on.

The port's own copy of the JAX package's ``analysis/knobs.py``, over the
port's registry.  Everything is derived from source: the registry is
parsed out of ``firebird_tpu_torch/config.py`` (the ``KNOBS`` literal), reads are AST
``os.environ`` / ``os.getenv`` call sites, documentation presence is a
scan of ``README.md`` + ``docs/*.md``, and aliveness additionally counts
shell expansions in ``tools/*.sh`` and the ``Makefile`` — so the linter
works unchanged on the hermetic fixture repos the test suite builds.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from firebird_tpu_torch.analysis.engine import (PACKAGE, LintContext,
                                                SourceFile, rule)

KNOB_RE = re.compile(r"\bFIREBIRD_[A-Z0-9]+(?:_[A-Z0-9]+)*\b")

CONFIG_PATH = f"{PACKAGE}/config.py"

# Registered knobs that act on the JAX package or its tools alone.  The
# port's registry equals the JAX package's (the shared docs name every
# knob), and no port module reads these, so the dead-knob rule counts them
# as referenced: the pin of JAX's platform, the Pallas lane block, the JAX
# wire's QA width and egress tables, and the JAX tools' artifact
# directories.
JAX_ONLY = frozenset({
    "FIREBIRD_JAX_PLATFORM", "FIREBIRD_MEGA_BLOCK_P", "FIREBIRD_WIRE_QA8",
    "FIREBIRD_WIRE_EGRESS", "FIREBIRD_SOAK_DIR", "FIREBIRD_CHAOS_DIR",
    "FIREBIRD_COMPACT_DIR", "FIREBIRD_SERVE_DIR", "FIREBIRD_POSTMORTEM_DIR",
    "FIREBIRD_FLEET_DIR", "FIREBIRD_OBJECTSTORE_DIR", "FIREBIRD_ELASTIC_DIR",
    "FIREBIRD_ALERT_DIR", "FIREBIRD_FANOUT_DIR", "FIREBIRD_STREAMFLEET_DIR",
    "FIREBIRD_TELEMETRY_SMOKE_DIR", "FIREBIRD_SLO_DIR", "FIREBIRD_WIRE_DIR",
    "FIREBIRD_PYRAMID_DIR", "FIREBIRD_FUSE_DIR", "FIREBIRD_PRECISION_DIR"})


class KnobDecl:
    def __init__(self, name: str, field=None, readers=(), internal=False,
                 line: int = 0):
        self.name = name
        self.field = field
        self.readers = tuple(readers)
        self.internal = internal
        self.line = line


def registry_span(src: SourceFile) -> tuple[int, int]:
    """Line range of the ``KNOBS = (...)`` assignment, or (0, -1).

    Knob name literals inside the registry itself must not count as
    "references" — otherwise declaring a knob would satisfy the
    dead-knob and from_env-reads-it checks by construction."""
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "KNOBS":
            return node.lineno, node.end_lineno or node.lineno
    return 0, -1


def parse_registry(src: SourceFile) -> dict[str, KnobDecl]:
    """Extract the ``KNOBS = (Knob(...), ...)`` literal from config.py.

    Each ``Knob(...)`` call must carry constant (literal-evaluable)
    keywords — the registry is data, and keeping it data is what lets a
    fixture repo's registry be parsed without importing it.
    """
    out: dict[str, KnobDecl] = {}
    for node in src.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "KNOBS"):
            continue
        for call in ast.walk(node.value):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Name)
                    and call.func.id == "Knob"):
                continue
            kw = {}
            for k in call.keywords:
                try:
                    kw[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    continue  # non-literal argument: ignore that field
            if "name" in kw:
                out[kw["name"]] = KnobDecl(
                    kw["name"], field=kw.get("field"),
                    readers=kw.get("readers", ()),
                    internal=bool(kw.get("internal", False)),
                    line=call.lineno)
    return out


def _is_environ_expr(node: ast.AST) -> bool:
    """True for expressions ending in ``environ`` (os.environ, a bare
    ``environ`` import, bench.py's ``_os.environ``)."""
    return (isinstance(node, ast.Attribute) and node.attr == "environ") \
        or (isinstance(node, ast.Name) and node.id == "environ")


def env_reads(src: SourceFile):
    """Yield ``(knob_name, lineno)`` for every env READ of a FIREBIRD_*
    literal: ``environ.get/.setdefault``, ``os.getenv``, and
    ``environ[...]`` subscript loads.  Stores/deletes/pops are harness
    configuration of child code, not reads, and stay unflagged."""
    for node in ast.walk(src.tree):
        name = None
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("get",
                                                           "setdefault") \
                    and _is_environ_expr(f.value):
                name = _const_knob(node.args[0]) if node.args else None
            elif (isinstance(f, ast.Attribute) and f.attr == "getenv") \
                    or (isinstance(f, ast.Name) and f.id == "getenv"):
                name = _const_knob(node.args[0]) if node.args else None
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and _is_environ_expr(node.value):
            name = _const_knob(node.slice)
        if name:
            yield name, node.lineno


def _const_knob(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and KNOB_RE.fullmatch(node.value):
        return node.value
    return None


def env_knob_reads(src: SourceFile):
    """Yield ``(knob_name, lineno)`` for every ``env_knob("FIREBIRD_X")``
    call site.  env_knob raises KeyError on an unregistered name at
    RUNTIME — these sites must be validated at lint time too, or a knob
    rename that misses one env_knob caller ships a lint-clean repo that
    crashes on its first hot-path read."""
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        is_env_knob = (isinstance(f, ast.Name) and f.id == "env_knob") \
            or (isinstance(f, ast.Attribute) and f.attr == "env_knob")
        if is_env_knob and node.args:
            name = _const_knob(node.args[0])
            if name:
                yield name, node.lineno


def knob_literals(src: SourceFile):
    """Every FIREBIRD_* string constant in the file (aliveness scan:
    env_knob() calls, bench fold arguments, test-free references)."""
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in KNOB_RE.finditer(node.value):
                yield m.group(0), node.lineno


def doc_files(ctx: LintContext) -> list[str]:
    """Operator-facing docs: README.md + docs/*.md (repo-relative).
    Root planning files (ISSUE/ROADMAP/CHANGES/...) are meta, not docs."""
    out = []
    if os.path.exists(os.path.join(ctx.root, "README.md")):
        out.append("README.md")
    for p in sorted(glob.glob(os.path.join(ctx.root, "docs", "*.md"))):
        out.append("/".join(["docs", os.path.basename(p)]))
    return out


def _doc_mentions(ctx: LintContext) -> dict[str, tuple[str, int]]:
    """knob name -> (doc file, first line mentioning it)."""
    found: dict[str, tuple[str, int]] = {}
    for rel in doc_files(ctx):
        text = ctx.read_text(rel) or ""
        for i, line in enumerate(text.splitlines(), start=1):
            for m in KNOB_RE.finditer(line):
                found.setdefault(m.group(0), (rel, i))
    return found


def _shell_mentions(ctx: LintContext) -> set[str]:
    names: set[str] = set()
    paths = glob.glob(os.path.join(ctx.root, "tools", "*.sh"))
    mk = os.path.join(ctx.root, "Makefile")
    if os.path.exists(mk):
        paths.append(mk)
    for p in paths:
        with open(p, encoding="utf-8", errors="replace") as f:
            names.update(m.group(0) for m in KNOB_RE.finditer(f.read()))
    return names


@rule("knob-registry", {
    "knob-unregistered-read":
        "os.environ read of a FIREBIRD_* var absent from config.KNOBS",
    "knob-reader-drift":
        "registered knob read outside config.py and its declared readers",
    "knob-undocumented":
        "registered non-internal knob missing from README.md/docs/*.md",
    "knob-doc-stale":
        "FIREBIRD_* var named in the docs but absent from config.KNOBS",
    "knob-dead":
        "registered knob with no remaining read or reference anywhere",
    "knob-config-field":
        "knob declares a Config field that config.py does not implement",
    "knob-no-registry":
        f"{PACKAGE}/config.py has no parseable KNOBS registry",
})
def check_knobs(ctx: LintContext) -> None:
    cfg = ctx.source(CONFIG_PATH)
    if cfg is None:
        return  # not a firebird repo layout; nothing to check
    registry = parse_registry(cfg)
    if not registry:
        ctx.emit("knob-no-registry", cfg, 1,
                 "config.py defines no KNOBS = (Knob(...), ...) literal")
        return

    # Config class attributes + env literals in config.py (field rule).
    # Literals inside the KNOBS registry itself are declarations, not
    # references — exclude them or dead-knob detection can never fire.
    config_attrs = _config_attrs(cfg)
    lo, hi = registry_span(cfg)
    config_lits = {n for n, ln in knob_literals(cfg)
                   if not lo <= ln <= hi}

    referenced: set[str] = set(config_lits)
    for src in ctx.sources:
        is_config = src.relpath == CONFIG_PATH
        for name, line in env_reads(src):
            decl = registry.get(name)
            if decl is None:
                ctx.emit("knob-unregistered-read", src, line,
                         f"{name} read from the environment but not "
                         "registered in config.KNOBS")
                continue
            if not is_config and src.relpath not in decl.readers:
                ctx.emit("knob-reader-drift", src, line,
                         f"{name} read directly here but config.KNOBS "
                         f"declares readers {list(decl.readers) or '[]'} "
                         "— route through Config.from_env / "
                         "config.env_knob or declare this module")
        for name, line in env_knob_reads(src):
            if name not in registry:
                ctx.emit("knob-unregistered-read", src, line,
                         f"env_knob({name!r}) names a knob absent from "
                         "config.KNOBS — this raises KeyError at "
                         "runtime")
        if not is_config:     # config.py handled above (span-excluded)
            referenced.update(n for n, _ in knob_literals(src))
    referenced |= _shell_mentions(ctx) | JAX_ONLY

    docs = _doc_mentions(ctx)
    for name, (rel, line) in sorted(docs.items()):
        if name not in registry:
            ctx.emit("knob-doc-stale", rel, line,
                     f"{name} appears in the docs but is not registered "
                     "in config.KNOBS")

    for name, decl in sorted(registry.items()):
        if not decl.internal and name not in docs:
            ctx.emit("knob-undocumented", cfg, decl.line,
                     f"{name} is registered but never mentioned in "
                     "README.md or docs/*.md")
        if name not in referenced:
            ctx.emit("knob-dead", cfg, decl.line,
                     f"{name} is registered but nothing reads or "
                     "references it anymore")
        if decl.field is not None:
            if decl.field not in config_attrs:
                ctx.emit("knob-config-field", cfg, decl.line,
                         f"{name} declares Config field "
                         f"{decl.field!r} which Config does not define")
            elif name not in config_lits:
                ctx.emit("knob-config-field", cfg, decl.line,
                         f"{name} declares Config field {decl.field!r} "
                         "but from_env never reads the env var")


def _config_attrs(cfg: SourceFile) -> set[str]:
    attrs: set[str] = set()
    for node in cfg.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    attrs.add(stmt.target.id)
    return attrs

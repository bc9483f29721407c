"""thread-ownership rules: ``# guarded-by: <lock>`` annotated state.

The port's own copy of the JAX package's ``analysis/ownership.py``.

The prefetch/drain/writer/watchdog/serve threads share mutable state
(writer error slots, watchdog beat records, serve flight tables, cache
LRU maps, the warm-compile singleton) that until this PR was guarded
only by convention — the lock discipline lived in comments a refactor
could silently break.  The convention is now machine-checked:

- ``self._attr = ...  # guarded-by: _lock`` in ``__init__`` (or a
  class-body annotation) declares that every later access of
  ``self._attr`` — read or write — must happen inside a
  ``with self._lock:`` block.  Methods whose name ends in ``_locked``,
  or whose ``def`` line carries its own ``# guarded-by: <lock>``
  annotation, are caller-holds-the-lock helpers and are exempt (their
  call sites are checked instead, being ordinary accesses).
- ``_global = ...  # guarded-by: _lock`` at module level declares that
  every *mutation* of the global from function code must happen inside
  ``with _lock:``.  Reads are deliberately not checked: swapping or
  reading one reference is atomic under the GIL, and the repo's
  hot-path pattern (obs.server.current, native._load's double-checked
  fast path) reads lock-free on purpose — the lock orders writers.
- Any *unannotated* module-global mutation (``global x; x = ...``)
  from inside a function is flagged unless it happens under some
  ``with`` lock: the driver's prefetch/drain/watchdog threads can reach
  most module code, so an unsynchronized global latch is a data race
  until someone either takes a lock, annotates the global, or
  suppresses the line with a reason.
"""

from __future__ import annotations

import ast

from firebird_tpu_torch.analysis.engine import LintContext, SourceFile, rule

# A with-held lock, as (scope, name): ("self", "_lock") for
# ``with self._lock:``; ("mod", "_lock") for ``with _lock:``.
Lock = tuple


def _withitem_locks(node: ast.With) -> set[Lock]:
    locks: set[Lock] = set()
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                and e.value.id == "self":
            locks.add(("self", e.attr))
        elif isinstance(e, ast.Name):
            locks.add(("mod", e.id))
    return locks


def _def_line_annotation(src: SourceFile, fn) -> str | None:
    """A ``# guarded-by:`` annotation on the signature lines of ``fn`` —
    strictly BEFORE the first body statement's line, or an annotation on
    a method's first statement would exempt the whole method instead of
    declaring that statement's lock.  (A one-line ``def f(): stmt`` has
    no separate signature line; only the def line itself counts then.)"""
    first_body = fn.body[0].lineno if fn.body else fn.lineno + 1
    for line in range(fn.lineno, max(first_body, fn.lineno + 1)):
        if line in src.guarded_by:
            return src.guarded_by[line]
    return None


def _stmt_annotation(src: SourceFile, stmt) -> str | None:
    """A ``# guarded-by:`` annotation anywhere on ``stmt``'s physical
    lines — a black-wrapped assignment puts the comment on the
    continuation line, not ``stmt.lineno``."""
    end = getattr(stmt, "end_lineno", None) or stmt.lineno
    for line in range(stmt.lineno, end + 1):
        if line in src.guarded_by:
            return src.guarded_by[line]
    return None


def _annotated_attrs(src: SourceFile, cls: ast.ClassDef) -> dict[str, str]:
    """attr name -> lock name, from annotated ``self.x = ...`` lines in
    ``__init__`` and annotated class-body assignments."""
    out: dict[str, str] = {}
    for stmt in cls.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            lock = _stmt_annotation(src, stmt)
            if lock is not None:
                tgt = stmt.targets[0] if isinstance(stmt, ast.Assign) \
                    else stmt.target
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = lock
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and stmt.name == "__init__":
            for node in ast.walk(stmt):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                lock = _stmt_annotation(src, node)
                if lock is None:
                    continue
                tgts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in tgts:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        out[t.attr] = lock
    return out


def _annotated_globals(src: SourceFile) -> dict[str, str]:
    out: dict[str, str] = {}
    for stmt in src.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            lock = _stmt_annotation(src, stmt)
            if lock is not None:
                tgt = stmt.targets[0] if isinstance(stmt, ast.Assign) \
                    else stmt.target
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = lock
    return out


class _ScopeWalker:
    """Walk a function body tracking the set of with-held locks, calling
    ``visit(node, locks)`` on every node.  A closure launched on a
    thread holds no caller lock, so a nested def either resets the lock
    context (``nested="reset"``, the class-attr checker: methods are the
    only defs visited) or is skipped outright (``nested="skip"``, the
    global checker: every def — nested included — is visited on its own
    walk, so descending here would double-report)."""

    def __init__(self, visit, nested: str = "reset"):
        self.visit = visit
        self.nested = nested

    def walk(self, fn, locks: frozenset = frozenset()) -> None:
        for stmt in fn.body:
            self._walk(stmt, locks)

    def _walk(self, node: ast.AST, locks: frozenset) -> None:
        self.visit(node, locks)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if self.nested == "reset":
                self.walk(node, frozenset())
            return
        if isinstance(node, ast.Lambda):
            if self.nested == "reset":
                self._walk(node.body, frozenset())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = locks | _withitem_locks(node)
            for item in node.items:
                self._walk(item.context_expr, locks)
            for stmt in node.body:
                self._walk(stmt, inner)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child, locks)


def _check_class(ctx: LintContext, src: SourceFile,
                 cls: ast.ClassDef) -> None:
    attrs = _annotated_attrs(src, cls)
    if not attrs:
        return
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if method.name == "__init__":
            continue
        held = _def_line_annotation(src, method)
        if held is not None or method.name.endswith("_locked"):
            continue     # caller-holds-the-lock helper: sites are checked

        def visit(node, locks, method=method):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and node.attr in attrs \
                    and ("self", attrs[node.attr]) not in locks:
                ctx.emit(
                    "ownership-unguarded-attr", src, node.lineno,
                    f"{cls.name}.{method.name} touches self.{node.attr} "
                    f"(guarded-by {attrs[node.attr]}) outside "
                    f"`with self.{attrs[node.attr]}:`")

        _ScopeWalker(visit).walk(method)


def _check_globals(ctx: LintContext, src: SourceFile) -> None:
    annotated = _annotated_globals(src)
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # Only THIS function's own `global` statements: a nested def's
        # declaration must not leak out, or the outer function's locals
        # of the same name get flagged as unlocked global mutations.
        declared: set[str] = set()
        stack = list(fn.body)
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            if isinstance(sub, ast.Global):
                declared.update(sub.names)
            stack.extend(ast.iter_child_nodes(sub))
        if not declared:
            continue

        def visit(node, locks, fn=fn, declared=declared):
            targets: list[ast.Name] = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets
                           if isinstance(t, ast.Name)]
                # tuple-unpack targets: `a, b = ...`
                for t in node.targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        targets.extend(e for e in t.elts
                                       if isinstance(e, ast.Name))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and isinstance(node.target, ast.Name):
                targets = [node.target]
            for t in targets:
                if t.id not in declared:
                    continue
                lock = annotated.get(t.id)
                if lock is not None:
                    if ("mod", lock) not in locks:
                        ctx.emit(
                            "ownership-unguarded-global", src, node.lineno,
                            f"{fn.name} mutates module global {t.id!r} "
                            f"(guarded-by {lock}) outside "
                            f"`with {lock}:`")
                elif not locks:
                    ctx.emit(
                        "ownership-global-mutation", src, node.lineno,
                        f"{fn.name} mutates module global {t.id!r} with "
                        "no lock held — annotate it `# guarded-by: "
                        "<lock>`, take a lock, or suppress with a "
                        "reason")

        _ScopeWalker(visit, nested="skip").walk(fn)


@rule("thread-ownership", {
    "ownership-unguarded-attr":
        "guarded-by annotated attribute accessed outside its lock",
    "ownership-unguarded-global":
        "guarded-by annotated module global mutated outside its lock",
    "ownership-global-mutation":
        "unannotated module global mutated from a function with no "
        "lock held",
})
def check_ownership(ctx: LintContext) -> None:
    for src in ctx.sources:
        for node in src.tree.body:
            if isinstance(node, ast.ClassDef):
                _check_class(ctx, src, node)
        _check_globals(ctx, src)

"""Lock-discipline checker over ``# guarded_by: <lock>`` annotations (port
of ``paddle_tpu/analysis/locks.py``).

The runtime's shared mutable state — the watchdog's guard and progress
tables, the flight recorder's ring, the profiler's counters, the serving
engine's tables, the random generators — is touched from worker threads
(prefetcher, loader workers, monitor, heartbeat, the serving loop).
The convention: a shared-mutable attribute declares its lock at its
initialization site::

    _guards: Dict[int, ...] = {}   # guarded_by: _lock

and this AST pass verifies every MUTATION of an annotated name —
reassignment, augmented assignment, ``del``, subscript store, or a call to
a known mutating method (``append``/``pop``/``update``/``clear``/...) — is
lexically inside ``with <lock>:`` (any receiver spelling with the same
terminal name matches: ``_lock``, ``self._lock``, ``cls._lock``) or inside
a function decorated ``@requires_lock("<lock>")`` (whose callers then hold
the lock; the decorator asserts it at runtime under
``FLAGS_thread_checks``). Reads are not checked — the discipline targets
torn writes and lost updates, and read-mostly paths (progress tables,
last-dump pointers) are deliberately lock-free.

Exemptions: the annotated initialization statement itself, other module
top-level statements (import time is single-threaded), and ``__init__``
bodies for ``self.<attr>`` annotations (the object is not yet shared).

Findings use rule ``lock-discipline`` and share the linter's suppression
(``# lint: ok(lock-discipline)``) and baseline grammar.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .lint import Finding, _suppressed_lines, iter_py_files

__all__ = ["check_lock_discipline", "check_source", "collect_annotations"]

_GUARDED = re.compile(r"#\s*guarded_by:\s*([A-Za-z_][\w.]*)")

# method names that mutate the common containers (dict/list/set/deque)
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort", "reverse", "rotate", "move_to_end",
}


def collect_annotations(source: str) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
    """(owner, name) -> (lock, line, kind) for every ``# guarded_by:``
    annotation. The annotated name is the assignment target on the same
    line: a module global (``_guards = {}``, owner ``""``, kind
    ``"global"``) or an instance attribute (``self._x = {}`` → owner = the
    enclosing class qualname, kind ``"attr"``). Keying attributes by their
    class keeps two classes' same-named attributes (each with its own lock)
    from colliding."""
    out: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return out
    by_line: Dict[int, str] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _GUARDED.search(line)
        if m:
            by_line[i] = m.group(1)
    if not by_line:
        return out

    class _Collector(ast.NodeVisitor):
        def __init__(self):
            self.classes: List[str] = []

        def visit_ClassDef(self, node):
            self.classes.append(node.name)
            self.generic_visit(node)
            self.classes.pop()

        def _record(self, node, targets):
            lock = by_line.get(node.lineno)
            if lock is None:
                return
            owner = ".".join(self.classes)
            for t in targets:
                if isinstance(t, ast.Name):
                    out[("", t.id)] = (lock, node.lineno, "global")
                elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                        and t.value.id in ("self", "cls"):
                    out[(owner, t.attr)] = (lock, node.lineno, "attr")

        def visit_Assign(self, node):
            self._record(node, node.targets)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            self._record(node, [node.target])
            self.generic_visit(node)

    _Collector().visit(tree)
    return out


def _terminal(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _with_lock_names(node: ast.With) -> Set[str]:
    out: Set[str] = set()
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):  # with lock.acquire_timeout(...) style
            expr = expr.func
        if isinstance(expr, ast.Name):
            out.add(expr.id)
        elif isinstance(expr, ast.Attribute):
            out.add(expr.attr)
    return out


def _requires_locks(node) -> Set[str]:
    """Lock names asserted by ``@requires_lock("...")`` / ``@requires_lock(_lock)``
    decorators on a function."""
    out: Set[str] = set()
    for dec in getattr(node, "decorator_list", ()):
        call = dec if isinstance(dec, ast.Call) else None
        fn = call.func if call else dec
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        if fname != "requires_lock":
            continue
        if call and call.args:
            a = call.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.add(_terminal(a.value))
            elif isinstance(a, ast.Name):
                out.add(a.id)
            elif isinstance(a, ast.Attribute):
                out.add(a.attr)
    return out


class _LockChecker(ast.NodeVisitor):
    def __init__(self, relpath: str,
                 annotations: Dict[Tuple[str, str], Tuple[str, int, str]]):
        self.relpath = relpath
        self.ann = annotations
        self.findings: List[Finding] = []
        self._held: List[Set[str]] = [set()]   # lock names in lexical scope
        self._scope: List[str] = []
        self._classes: List[str] = []          # enclosing class chain
        self._func_depth = 0

    def scope(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    # -- scope/context tracking -------------------------------------------
    def visit_With(self, node: ast.With):
        self._held.append(self._held[-1] | _with_lock_names(node))
        self.generic_visit(node)
        self._held.pop()

    def _visit_func(self, node):
        self._scope.append(node.name)
        self._func_depth += 1
        # A function body starts with NO inherited `with` locks — a nested
        # def lexically inside `with _lock:` is a closure that may run LATER
        # on another thread (thread targets, callbacks), when the lock is
        # long released. Only @requires_lock survives into the body: that
        # assumption is re-verified at call time under FLAGS_thread_checks.
        self._held.append(_requires_locks(node))
        self.generic_visit(node)
        self._held.pop()
        self._func_depth -= 1
        self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self._classes.append(node.name)
        self.generic_visit(node)
        self._classes.pop()
        self._scope.pop()

    # -- mutation detection --------------------------------------------------
    def _annotated_name(self, node) -> Optional[Tuple[str, str]]:
        """The annotation key when ``node`` denotes an annotated target:
        a bare Name (module global), ``self.<attr>``/``cls.<attr>`` of the
        ENCLOSING class, or a subscript of either. Attribute chains through
        other objects don't match; an attribute annotated by one class never
        matches a same-named attribute of another."""
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Name) and ("", node.id) in self.ann:
            return ("", node.id)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                and node.value.id in ("self", "cls"):
            key = (".".join(self._classes), node.attr)
            if key in self.ann:
                return key
        return None

    def _check(self, key: Tuple[str, str], node, action: str):
        lock, ann_line, kind = self.ann[key]
        name = key[1]
        if node.lineno == ann_line:
            return  # the annotated initialization itself
        if self._func_depth == 0:
            return  # module top level: import is single-threaded
        if kind == "attr" and self._scope and self._scope[-1] == "__init__":
            return  # instance state being built before the object escapes
        if _terminal(lock) in self._held[-1]:
            return
        self.findings.append(Finding(
            "lock-discipline", self.relpath, node.lineno, self.scope(),
            f"{action} of {name!r} (guarded_by: {lock}) outside "
            f"`with {lock}:` and not under @requires_lock",
        ))

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            name = self._annotated_name(t)
            if name:
                self._check(name, node, "assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        name = self._annotated_name(node.target)
        if name:
            self._check(name, node, "augmented assignment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            name = self._annotated_name(t)
            if name:
                self._check(name, node, "delete")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATORS:
            name = self._annotated_name(node.func.value)
            if name:
                self._check(name, node, f".{node.func.attr}() mutation")
        self.generic_visit(node)


def check_source(source: str, relpath: str) -> List[Finding]:
    ann = collect_annotations(source)
    if not ann:
        return []
    tree = ast.parse(source, filename=relpath)
    checker = _LockChecker(relpath, ann)
    checker.visit(tree)
    suppressed = _suppressed_lines(source)
    return [
        f for f in checker.findings
        if "lock-discipline" not in suppressed.get(f.line, ())
    ]


def check_lock_discipline(
    root: str, baseline: Sequence[Tuple[str, str, str]] = ()
) -> List[Finding]:
    """Run the checker over every annotated module under ``root``."""
    findings: List[Finding] = []
    for path in iter_py_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        if "guarded_by:" not in source:
            continue
        try:
            findings.extend(check_source(source, rel))
        except SyntaxError:
            continue  # the linter reports parse errors
    allowed = set(baseline)
    findings = [f for f in findings if f.key() not in allowed]
    findings.sort(key=lambda f: (f.path, f.line))
    return findings

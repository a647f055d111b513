"""Repo-invariant linter (AST-based, zero third-party deps; port of
``paddle_tpu/analysis/lint.py``).

It runs over the port's own sources. Each rule encodes an invariant the
reference established, and scopes are the reference's package-relative
paths, which name the same files in the port. The reference's eighth rule,
``compat-shim``, polices its JAX version shim (``core/compat.py``), which
the port does not have, so it is not here.

* ``host-sync`` — hidden host synchronization in hot paths. ``.numpy()`` /
  ``.item()`` calls and ``np.asarray(x._data)`` inside ``core/``,
  ``distributed/`` and ``optimizer/`` make the host wait for the card
  outside the readback funnels (``core.tensor.host_arrays``: one sync for
  many tensors), which stalls the queue of launches the host keeps ahead.
* ``atomic-write`` — a file opened for (over)write, or ``write_bytes`` /
  ``write_text``, in a function that never calls ``os.replace``: a process
  killed mid-write leaves a torn file; every cache/checkpoint/store/
  progress write must be tmp + ``os.replace``.
* ``monotonic-deadline`` — ``time.time()`` feeding deadline/timeout/
  interval arithmetic. Wall clocks jump (NTP, VM migration); a backward
  step turns a 30 s timeout into hours. Deadlines use ``time.monotonic()``;
  wall time is for human-facing timestamps only.
* ``flag-registry`` — a ``FLAGS_*`` name referenced somewhere in the tree
  but never present in ``framework/flags.py`` nor passed to
  ``register_flag``: the typo guard in ``set_flags`` can only reject what
  the registry knows about.
* ``counter-registry`` — mirror of flag-registry for profiler counters:
  every counter bumped anywhere (``counter_inc``/``_counter`` literal
  first args — including conditional-expression branches — and
  ``step_counters()`` dict keys) must appear in
  ``profiler.KNOWN_COUNTERS``, every registered name must be bumped
  somewhere, and every registered name must be documented
  (double-backticked) in the ``profiler.counters()`` docstring. A counter
  that dashboards can't discover (or a doc entry for a counter that no
  longer exists) is silent telemetry rot.
* ``bare-except`` — a bare ``except:`` (or ``except BaseException`` that
  does not re-raise) in retry/commit paths swallows ``KeyboardInterrupt``/
  ``SystemExit`` and can convert a preemption drain into a hang.
* ``oom-handler`` — an ``except`` that can catch a
  ``torch.OutOfMemoryError`` (``torch.cuda.OutOfMemoryError``; bare,
  ``BaseException``, ``Exception``, ``RuntimeError``, or the type itself)
  in the DISPATCH-LAYER files of ``core/``/``distributed/``/``serving/`` —
  the files where the steps launch — must either re-raise or route through
  the ONE ``fault/memory.py`` classifier (``is_oom``/``classify``/
  ``note_oom``/``maybe_hbm_oom``/a ``_recover_oom``-family helper). A
  broad handler that silently eats an out-of-memory turns a recoverable
  exhaustion into data-dependent wrong behavior; the ladder makes it a
  managed condition and this rule keeps it that way.

Suppression grammar: ``# lint: ok(<rule>)`` on the offending line (or the
line directly above it). Grandfathered findings live in ``baseline.txt`` —
one ``rule<TAB>path<TAB>scope<TAB># justification`` line each, matched on
(rule, file, enclosing function) so they survive line drift.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "lint_package", "lint_source", "load_baseline",
    "iter_py_files", "RULES",
]

RULES = (
    "host-sync", "atomic-write", "monotonic-deadline",
    "flag-registry", "counter-registry", "bare-except", "oom-handler",
)

# counter-registry anchors: the registry lives in profiler/__init__.py as
# KNOWN_COUNTERS, documented in the counters() docstring; bumps route
# through these callables (literal first args only — the fault/retry.py
# `_counter(name, n)` pass-through and the distributed engine's
# `counter_inc(k, v)` loop over step_counters() are dynamic and resolved
# via their literal sources instead)
_COUNTER_REGISTRY_FILE = "profiler/__init__.py"
_COUNTER_FUNCS = ("counter_inc", "_counter")
_DOC_NAME = re.compile(r"``([A-Za-z0-9_]+)``")

# host-sync applies only to hot-path packages (metric/, hapi/ etc. read
# results by design); paths are package-relative, '/'-normalized
_HOST_SYNC_SCOPE = ("core/", "distributed/", "optimizer/")

_DEADLINE_WORD = re.compile(r"deadline|timeout|expire|interval", re.IGNORECASE)
_SUPPRESS = re.compile(r"#\s*lint:\s*ok\(([a-z0-9_,\- ]+)\)")
_WRITE_MODES = ("w", "wb", "w+", "wb+", "x", "xb")
_MUTATING_WRITES = {"write_bytes", "write_text"}
_EXCEPT_SCOPE = ("fault/", "distributed/checkpoint.py", "distributed/coord.py",
                 "distributed/watchdog.py")
# oom-handler applies to the dispatch layer inside core//distributed//
# serving/ — the files where the steps launch and a torch.OutOfMemoryError
# can actually surface (the reference's list less core/lazy.py, which the
# port does not have). A broad handler elsewhere in those packages has
# nothing launching in its try.
_OOM_SCOPE = (
    "core/dispatch.py", "distributed/engine.py", "serving/engine.py",
    "serving/supervisor.py",
)
# exception types a torch.OutOfMemoryError (a RuntimeError) can hide behind
_OOM_TYPES = {"Exception", "BaseException", "RuntimeError",
              "OutOfMemoryError"}
# fault/memory.py classifier surface (plus the per-layer ladder helpers that
# route through it) — any of these in the handler body satisfies the rule
_OOM_ROUTERS = {
    "is_oom", "classify", "note_oom", "_note_oom", "_oom_recover",
    "_recover_oom", "_on_oom", "maybe_hbm_oom",
}


class Finding:
    """One linter/lock-checker finding. ``scope`` is the enclosing function
    qualname (or ``<module>``) — the stable anchor baseline entries match."""

    __slots__ = ("rule", "path", "line", "scope", "message")

    def __init__(self, rule: str, path: str, line: int, scope: str, message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.scope = scope
        self.message = message

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.scope)

    def __repr__(self):
        return f"{self.path}:{self.line}: [{self.rule}] ({self.scope}) {self.message}"


def load_baseline(path: str) -> List[Tuple[str, str, str]]:
    """Parse the baseline file: ``rule<TAB>relpath<TAB>scope<TAB># why``
    per entry; blank lines and ``#`` comment lines ignored. A justification
    comment is REQUIRED — an unexplained entry is itself an error."""
    out: List[Tuple[str, str, str]] = []
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 4 or not parts[3].lstrip().startswith("#"):
                raise ValueError(
                    f"{path}:{ln}: baseline entry needs "
                    "rule<TAB>path<TAB>scope<TAB># justification"
                )
            if parts[0] not in RULES and not parts[0].startswith("lock-"):
                raise ValueError(f"{path}:{ln}: unknown rule {parts[0]!r}")
            out.append((parts[0], parts[1], parts[2]))
    return out


def iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _suppressed_lines(source: str) -> Dict[int, Set[str]]:
    """line -> set of rules suppressed there. A marker also covers the NEXT
    line, so it can sit above a long statement."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _SUPPRESS.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(i, set()).update(rules)
            out.setdefault(i + 1, set()).update(rules)
    return out


class _ScopeVisitor(ast.NodeVisitor):
    """Base visitor tracking the enclosing function qualname."""

    def __init__(self):
        self._scope: List[str] = []

    def scope(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    def _visit_func(self, node):
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()


def _dotted(node) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _names_in(node) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


class _Linter(_ScopeVisitor):
    def __init__(self, relpath: str, tree: ast.AST):
        super().__init__()
        self.relpath = relpath
        self.findings: List[Finding] = []
        self.flag_refs: List[Tuple[int, str, str]] = []  # (line, scope, name)
        self.flag_registered: Set[str] = set()
        self.counter_refs: List[Tuple[int, str, str]] = []  # (line, scope, name)
        self.counter_registered: Dict[str, int] = {}  # name -> line
        self.counter_documented: Set[str] = set()
        if relpath == _COUNTER_REGISTRY_FILE:
            for n in ast.walk(tree):
                if isinstance(n, ast.FunctionDef) and n.name == "counters":
                    doc = ast.get_docstring(n) or ""
                    self.counter_documented |= set(_DOC_NAME.findall(doc))
        # per-function: does it call os.replace (or equivalent rename)?
        self._atomic_funcs = self._collect_atomic_functions(tree)
        self._func_stack: List[ast.AST] = []
        # names assigned from time.time() in the current function
        self._wall_names: List[Set[str]] = [set()]

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _collect_atomic_functions(tree) -> Set[ast.AST]:
        """Function nodes whose body (own statements, not nested defs'
        bodies excluded — a helper closure doing the replace still makes the
        write pattern atomic) contains an ``os.replace``/``os.rename``."""
        atomic: Set[ast.AST] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        dn = _dotted(sub.func)
                        term = dn.rsplit(".", 1)[-1] if dn else None
                        if dn in ("os.replace", "os.rename") or term in (
                            "atomic_open", "atomic_write"
                        ):
                            atomic.add(node)
                            break
        return atomic

    def _emit(self, rule, node, message):
        self.findings.append(
            Finding(rule, self.relpath, node.lineno, self.scope(), message)
        )

    def _in_host_sync_scope(self) -> bool:
        return self.relpath.startswith(_HOST_SYNC_SCOPE)

    def _in_except_scope(self) -> bool:
        return self.relpath.startswith(_EXCEPT_SCOPE)

    # -- scope bookkeeping -------------------------------------------------
    def _visit_func(self, node):
        self._func_stack.append(node)
        self._wall_names.append(set())
        _ScopeVisitor._visit_func(self, node)
        self._wall_names.pop()
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- rules -------------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        dn = _dotted(node.func)

        # host-sync: .numpy()/.item() and np.asarray(x._data) in hot paths
        if self._in_host_sync_scope() and isinstance(node.func, ast.Attribute):
            if node.func.attr in ("numpy", "item") and not node.args and not node.keywords:
                self._emit(
                    "host-sync", node,
                    f".{node.func.attr}() forces a host sync; route readbacks "
                    "through core.tensor.host_arrays or defer them",
                )
        if (
            self._in_host_sync_scope()
            and dn in ("np.asarray", "numpy.asarray")
            and node.args
            and isinstance(node.args[0], ast.Attribute)
            and node.args[0].attr == "_data"
        ):
            self._emit(
                "host-sync", node,
                "np.asarray(x._data) blocks on the raw buffer, bypassing the "
                "readback funnel",
            )

        # atomic-write: open(..., 'w'/'wb') / write_bytes / write_text in a
        # function with no os.replace
        mode = None
        if dn in ("open", "io.open") and len(node.args) >= 2:
            a = node.args[1]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                mode = a.value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        is_write = (
            (dn in ("open", "io.open") and mode in _WRITE_MODES)
            or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATING_WRITES
            )
        )
        if is_write and not (self._func_stack and self._func_stack[-1] in self._atomic_funcs):
            what = mode and f"open(..., {mode!r})" or f".{node.func.attr}(...)"
            self._emit(
                "atomic-write", node,
                f"{what} with no os.replace in the enclosing function — a "
                "mid-write kill leaves a torn file; write tmp + os.replace",
            )

        # monotonic-deadline: time.time() directly inside deadline math
        if dn == "time.time":
            names = _names_in(self._current_stmt or node)
            if any(_DEADLINE_WORD.search(n) for n in names):
                self._emit(
                    "monotonic-deadline", node,
                    "time.time() in deadline/timeout arithmetic — wall clocks "
                    "jump; use time.monotonic()",
                )

        # flag-registry: collect FLAGS_* string references. Matched on the
        # terminal attribute so chained receivers (`_flags_mod().flag(...)`)
        # are caught too.
        fname = (
            node.func.attr if isinstance(node.func, ast.Attribute)
            else node.func.id if isinstance(node.func, ast.Name) else None
        )
        if fname in ("flag", "register_flag", "get_flags"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and a.value.startswith("FLAGS_"):
                    if fname == "register_flag":
                        self.flag_registered.add(a.value)
                    else:
                        self.flag_refs.append((node.lineno, self.scope(), a.value))

        # counter-registry: collect counter bump sites. A conditional
        # expression as the name (`counter_inc("a" if c else "b")`) bumps
        # every branch, so every branch is a reference.
        if fname in _COUNTER_FUNCS and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                self.counter_refs.append((node.lineno, self.scope(), a.value))
            elif isinstance(a, ast.IfExp):
                # walk only the VALUE positions (body/orelse, nested
                # conditionals included) — the test expression's string
                # literals are predicates, not counter names
                stack = [a.body, a.orelse]
                while stack:
                    sub = stack.pop()
                    if isinstance(sub, ast.IfExp):
                        stack += [sub.body, sub.orelse]
                    elif isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str):
                        self.counter_refs.append(
                            (node.lineno, self.scope(), sub.value))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        # taint-track `now = time.time()` so a later `now - t0 > timeout`
        # compare in the same function is still caught
        if (
            isinstance(node.value, ast.Call)
            and _dotted(node.value.func) == "time.time"
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._wall_names[-1].add(t.id)
        # counter-registry: the registry itself (profiler KNOWN_COUNTERS)
        if (
            self.relpath == _COUNTER_REGISTRY_FILE
            and any(isinstance(t, ast.Name) and t.id == "KNOWN_COUNTERS"
                    for t in node.targets)
        ):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    self.counter_registered.setdefault(sub.value, sub.lineno)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        names = _names_in(node)
        tainted = names & self._wall_names[-1]
        if tainted and any(_DEADLINE_WORD.search(n) for n in names):
            self._emit(
                "monotonic-deadline", node,
                f"wall-clock value {sorted(tainted)[0]!r} (from time.time()) "
                "compared against a deadline/timeout — use time.monotonic()",
            )
        self.generic_visit(node)

    @staticmethod
    def _oom_catchable(t) -> bool:
        """Could this except-type clause see a torch.OutOfMemoryError?"""
        if t is None:
            return True  # bare except
        if isinstance(t, ast.Tuple):
            return any(_Linter._oom_catchable(x) for x in t.elts)
        dn = _dotted(t)
        return dn is not None and dn.rsplit(".", 1)[-1] in _OOM_TYPES

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if self.relpath in _OOM_SCOPE and self._oom_catchable(node.type):

            def _callee(c):
                dn = _dotted(c.func)
                if dn:
                    return dn.rsplit(".", 1)[-1]
                return c.func.attr if isinstance(c.func, ast.Attribute) else None

            reraises = any(
                isinstance(s, ast.Raise) and s.exc is None
                for s in ast.walk(node)
            )
            routed = any(
                isinstance(s, ast.Call) and _callee(s) in _OOM_ROUTERS
                for s in ast.walk(node)
            )
            if not reraises and not routed:
                self._emit(
                    "oom-handler", node,
                    "broad except in a dispatch-layer file can swallow a "
                    "torch.OutOfMemoryError; re-raise or route through the "
                    "fault/memory.py classifier (is_oom/classify/note_oom)",
                )
        if self._in_except_scope():
            bare = node.type is None
            base = (
                isinstance(node.type, ast.Name) and node.type.id == "BaseException"
            )
            if bare or base:
                reraises = any(
                    isinstance(s, ast.Raise) and s.exc is None
                    for s in ast.walk(node)
                )
                if not reraises:
                    self._emit(
                        "bare-except", node,
                        ("bare except" if bare else "except BaseException") +
                        " without re-raise in a retry/commit path swallows "
                        "KeyboardInterrupt/SystemExit",
                    )
        self.generic_visit(node)

    # flag-registry also needs FLAGS_* dict keys (the registry itself) and
    # env-pickup string literals; collect registrations from flags.py keys
    def visit_Dict(self, node: ast.Dict):
        if self.relpath == "framework/flags.py":
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                        and k.value.startswith("FLAGS_"):
                    self.flag_registered.add(k.value)
        # counter-registry: a `step_counters()` dict is fed verbatim into
        # `counter_inc(k, v)` by the distributed engine — its string keys
        # are counter bumps
        if self._func_stack and getattr(
                self._func_stack[-1], "name", "") == "step_counters":
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    self.counter_refs.append(
                        (k.lineno, self.scope(), k.value))
        self.generic_visit(node)

    # track the current top-level statement for expression-local name scans
    _current_stmt: Optional[ast.stmt] = None

    def visit(self, node):
        if isinstance(node, ast.stmt):
            self._current_stmt = node
        return super().visit(node)


def _analyze(source: str, relpath: str) -> Tuple[List[Finding], "_Linter"]:
    """Run the per-file linter; returns the suppression-filtered findings
    plus the visitor itself (cross-file flag/counter data rides on it)."""
    tree = ast.parse(source, filename=relpath)
    linter = _Linter(relpath, tree)
    linter.visit(tree)
    suppressed = _suppressed_lines(source)
    kept = [
        f for f in linter.findings
        if f.rule not in suppressed.get(f.line, ())
    ]
    return kept, linter


def lint_source(source: str, relpath: str) -> Tuple[List[Finding], List, Set[str]]:
    """Lint one file. Returns (findings, flag_refs, flags_registered) — the
    flag data is resolved cross-file by :func:`lint_package`."""
    kept, linter = _analyze(source, relpath)
    refs = [(relpath, ln, scope, name) for ln, scope, name in linter.flag_refs]
    return kept, refs, linter.flag_registered


def _apply_baseline(findings: Sequence[Finding],
                    baseline: Sequence[Tuple[str, str, str]]) -> List[Finding]:
    allowed = set(baseline)
    return [f for f in findings if f.key() not in allowed]


def lint_package(root: str,
                 baseline: Sequence[Tuple[str, str, str]] = ()) -> List[Finding]:
    """Lint every .py file under ``root`` (a package directory); resolve the
    cross-file flag-registry rule; subtract baseline entries."""
    findings: List[Finding] = []
    all_refs: List[Tuple[str, int, str, str]] = []
    registered: Set[str] = set()
    counter_refs: List[Tuple[str, int, str, str]] = []
    counter_registered: Dict[str, int] = {}
    counter_documented: Set[str] = set()
    for path in iter_py_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            file_findings, linter = _analyze(source, rel)
        except SyntaxError as e:
            findings.append(Finding(
                "parse-error", rel, e.lineno or 0, "<module>",
                f"file does not parse: {e.msg}",
            ))
            continue
        findings.extend(file_findings)
        all_refs.extend(
            (rel, ln, scope, name) for ln, scope, name in linter.flag_refs)
        registered |= linter.flag_registered
        counter_refs.extend(
            (rel, ln, scope, name) for ln, scope, name in linter.counter_refs)
        counter_registered.update(linter.counter_registered)
        counter_documented |= linter.counter_documented
    for rel, ln, scope, name in all_refs:
        if name not in registered:
            findings.append(Finding(
                "flag-registry", rel, ln, scope,
                f"{name} referenced but never registered in framework/flags.py "
                "(set_flags typo-guard cannot protect it)",
            ))
    # counter-registry, three directions: bumped-but-unregistered at the
    # bump site; registered-but-never-bumped and registered-but-undocumented
    # at the registry entry. (The checks only engage when the package under
    # lint actually carries the registry — a synthetic test package without
    # profiler/__init__.py shouldn't fail on its own counter bumps.)
    if counter_registered:
        bumped = {name for _, _, _, name in counter_refs}
        for rel, ln, scope, name in counter_refs:
            if name not in counter_registered:
                findings.append(Finding(
                    "counter-registry", rel, ln, scope,
                    f"counter {name!r} bumped here but missing from "
                    "profiler.KNOWN_COUNTERS (dashboards can't discover it)",
                ))
        for name, ln in sorted(counter_registered.items()):
            if name not in bumped:
                findings.append(Finding(
                    "counter-registry", _COUNTER_REGISTRY_FILE, ln, "<module>",
                    f"counter {name!r} registered in KNOWN_COUNTERS but never "
                    "bumped anywhere (stale registry entry)",
                ))
            if name not in counter_documented:
                findings.append(Finding(
                    "counter-registry", _COUNTER_REGISTRY_FILE, ln, "counters",
                    f"counter {name!r} registered but not documented "
                    "(``double-backticked``) in the counters() docstring",
                ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return _apply_baseline(findings, baseline)

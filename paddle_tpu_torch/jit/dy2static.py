"""dygraph→static control-flow conversion, an AST transform (port of
``paddle_tpu/jit/dy2static.py``).

Parity: reference ``python/paddle/fluid/dygraph/dygraph_to_static/`` —
``program_translator.py:775`` (ProgramTranslator), ``ifelse_transformer.py``,
``loop_transformer.py``, ``logical_transformer.py``. Those rewrite
tensor-dependent Python ``if``/``while``/``for`` into ``cond``/``while`` ops
over sub-blocks; here the same source rewrite targets ``torch.cond`` /
``torch.while_loop`` through ``ops/control_flow.py``, so a ``@to_static``
function with data-dependent branches exports with real control flow.

Pipeline: ``transform_function(fn)`` grabs the source, rewrites

    if <t-pred>: A else: B        →  _jst.convert_ifelse(pred, tf, ff, vars)
    while <t-pred>: BODY          →  _jst.convert_while(cond_fn, body_fn, vars)
    for i in range(<t-bound>):    →  while-style fori loop
    a and b / a or b / not a      →  _jst.convert_logical_*

and compiles the new AST in the original function's globals (closure
variables are materialized into that namespace, where they override a
global of the same name). The convert_* helpers pick the path at runtime: a
concrete predicate (a real tensor, or a Python value) takes plain Python; a
traced one (a fake or symbolic tensor under ``torch.export`` or
``make_fx``) takes ``torch.cond``/``torch.while_loop``. Functions whose
source can't be transformed, that are marked ``@not_to_static``, or that
carry a decorator other than ``to_static`` keep the original function.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable

import torch

from ..ops import control_flow as _cf

__all__ = ["transform_function", "convert_ifelse", "convert_while", "convert_logical_and",
           "convert_logical_or", "convert_logical_not", "UNDEF"]


class _Undef:
    __slots__ = ()

    def __repr__(self):
        return "<UNDEF>"


UNDEF = _Undef()


def _pred_value(pred):
    """→ (is_traced, concrete_bool_or_None)."""
    if _cf.is_traced(pred):
        return True, None
    if isinstance(pred, torch.Tensor):
        return False, bool(pred.reshape(()))
    return False, bool(pred)


# -- runtime converters ------------------------------------------------------
def convert_ifelse(pred, true_fn: Callable, false_fn: Callable, vars_tuple: tuple):
    traced, val = _pred_value(pred)
    if not traced:
        return true_fn(*vars_tuple) if val else false_fn(*vars_tuple)

    # vars pass through the branch CLOSURES (not operator operands), so an
    # UNDEF placeholder is fine as long as both branches assign it before
    # use — torch.cond only requires the RETURNED structures to match
    try:
        return _cf.cond(pred, lambda: true_fn(*vars_tuple), lambda: false_fn(*vars_tuple))
    except Exception as e:
        raise ValueError(
            "to_static: both branches of a tensor-dependent `if` must produce "
            "the same variables with matching shapes/dtypes (torch.cond: "
            f"{type(e).__name__}: {e})"
        ) from e


def convert_while(cond_fn: Callable, body_fn: Callable, vars_tuple: tuple):
    # probe the predicate on the current values
    probe = cond_fn(*vars_tuple)
    traced, _ = _pred_value(probe)
    if not traced and not any(_cf.is_traced(v) for v in vars_tuple):
        while bool(cond_fn(*vars_tuple)):
            out = body_fn(*vars_tuple)
            vars_tuple = out if isinstance(out, tuple) else (out,)
        return vars_tuple

    if any(v is UNDEF for v in vars_tuple):
        raise ValueError(
            "to_static: every loop variable of a tensor-dependent `while` "
            "must be defined before the loop (a shape-stable carry)"
        )
    out = _cf.while_loop(lambda *vs: cond_fn(*vs), lambda *vs: body_fn(*vs), list(vars_tuple))
    return tuple(out)


def convert_logical_and(a_fn, b_fn):
    a = a_fn()
    if isinstance(a, torch.Tensor):
        return torch.logical_and(a, torch.as_tensor(b_fn(), device=a.device))
    return a and b_fn()


def convert_logical_or(a_fn, b_fn):
    a = a_fn()
    if isinstance(a, torch.Tensor):
        return torch.logical_or(a, torch.as_tensor(b_fn(), device=a.device))
    return a or b_fn()


def convert_logical_not(a):
    if isinstance(a, torch.Tensor):
        return torch.logical_not(a)
    return not a


# -- AST analysis ------------------------------------------------------------
class _AssignedNames(ast.NodeVisitor):
    """Names bound by statements (stores, augassign, for targets, with-as).
    Nested function defs and transformer-generated ``__jst_*`` temporaries
    are NOT user variables and never join a loop's carry."""

    def __init__(self):
        self.names = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)) and not node.id.startswith("__jst_"):
            self.names.add(node.id)

    def visit_FunctionDef(self, node):
        pass  # helper defs are branch-local; don't descend

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _assigned(stmts) -> set:
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


class _LoadedNames(ast.NodeVisitor):
    def __init__(self):
        self.names = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.names.add(node.id)


def _loaded(node_or_stmts) -> set:
    v = _LoadedNames()
    if isinstance(node_or_stmts, list):
        for s in node_or_stmts:
            v.visit(s)
    else:
        v.visit(node_or_stmts)
    return v.names


def _contains_return(stmts) -> bool:
    """Return/break/continue/yield at THIS function's level (nested function
    definitions — including ones this transformer generated — don't count)."""

    def scan(node) -> bool:
        if isinstance(node, (ast.Return, ast.Break, ast.Continue, ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
        return any(scan(c) for c in ast.iter_child_nodes(node))

    return any(scan(s) for s in stmts)


# -- AST transformer ---------------------------------------------------------
class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites if/while/for/boolop inside ONE function body."""

    def __init__(self):
        self.counter = 0
        self.changed = False

    def _fresh(self, base):
        self.counter += 1
        return f"__jst_{base}_{self.counter}"

    def visit_If(self, node: ast.If):
        node = self.generic_visit(node)
        if not _tensor_likely(node.test):
            return node
        if _contains_return(node.body) or _contains_return(node.orelse):
            # return/break inside a tensor branch can't become torch.cond;
            # leave as-is (concrete predicates still work at runtime)
            return node
        carried = sorted(_assigned(node.body) | _assigned(node.orelse))
        self.changed = True
        tf, ff, out = self._fresh("true"), self._fresh("false"), self._fresh("ifout")
        args = ", ".join(carried)
        ret = ("return (" + ", ".join(carried) + ("," if len(carried) == 1 else "") + ")") if carried else "return ()"

        def mk_branch(name, stmts):
            f = ast.parse(f"def {name}({args}):\n    pass").body[0]
            f.body = (list(stmts) if stmts else []) + ast.parse(ret).body
            return f

        true_def = mk_branch(tf, node.body)
        false_def = mk_branch(ff, node.orelse)
        call_src = (
            f"{out} = _jst.convert_ifelse(__jst_pred, {tf}, {ff}, ({args}{',' if len(carried)==1 else ''}))"
            if carried
            else f"{out} = _jst.convert_ifelse(__jst_pred, {tf}, {ff}, ())"
        )
        pred_assign = ast.parse("__jst_pred = 0").body[0]
        pred_assign.value = node.test
        unpack = []
        if carried:
            unpack = ast.parse(f"{', '.join(carried)}{',' if len(carried)==1 else ''} = {out}").body
        prelude = []
        for n in carried:
            prelude.extend(ast.parse(
                f"try:\n    {n} = {n}\nexcept (NameError, UnboundLocalError):\n    {n} = _jst.UNDEF"
            ).body)
        new = prelude + [pred_assign, true_def, false_def] + ast.parse(call_src).body + unpack
        for s in new:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
        return new

    def visit_While(self, node: ast.While):
        node = self.generic_visit(node)
        if node.orelse or _contains_return(node.body):
            return node
        if not _tensor_likely(node.test):
            return node
        carried = sorted(_assigned(node.body))  # every assigned name is carried
        # names read by cond/body but never assigned are closed over naturally
        cf, bf, out = self._fresh("cond"), self._fresh("body"), self._fresh("whout")
        args = ", ".join(carried)
        if not carried:
            return node  # a while that binds nothing can't make progress traced
        self.changed = True
        ret = "return (" + ", ".join(carried) + ("," if len(carried) == 1 else "") + ")"
        cond_def = ast.parse(f"def {cf}({args}):\n    pass").body[0]
        cond_ret = ast.parse("return 0").body[0]
        cond_ret.value = node.test
        cond_def.body = [cond_ret]
        body_def = ast.parse(f"def {bf}({args}):\n    pass").body[0]
        body_def.body = list(node.body) + ast.parse(ret).body
        call = ast.parse(
            f"{out} = _jst.convert_while({cf}, {bf}, ({args}{',' if len(carried)==1 else ''}))"
        ).body
        unpack = ast.parse(f"{', '.join(carried)}{',' if len(carried)==1 else ''} = {out}").body
        prelude = []
        for n in carried:
            prelude.extend(ast.parse(
                f"try:\n    {n} = {n}\nexcept (NameError, UnboundLocalError):\n    {n} = _jst.UNDEF"
            ).body)
        new = prelude + [cond_def, body_def] + call + unpack
        for s in new:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
        return new

    def visit_For(self, node: ast.For):
        node = self.generic_visit(node)
        # `for <name> in range(...)` with a possibly-tensor bound → counter
        # while-loop (then visit_While's machinery applies at runtime via
        # convert_while). Other iterables keep Python iteration.
        def _const_step(a):
            if isinstance(a, ast.Constant) and isinstance(a.value, int):
                return a.value
            if (
                isinstance(a, ast.UnaryOp)
                and isinstance(a.op, ast.USub)
                and isinstance(a.operand, ast.Constant)
                and isinstance(a.operand.value, int)
            ):
                return -a.operand.value
            return None

        args = node.iter.args
        if (
            node.orelse
            or _contains_return(node.body)
            or not isinstance(node.iter, ast.Call)
            or not isinstance(node.iter.func, ast.Name)
            or node.iter.func.id != "range"
            or not isinstance(node.target, ast.Name)
            or node.iter.keywords
            or not 1 <= len(args) <= 3
            or not any(_tensor_likely(a) for a in args)
            # step must be a POSITIVE literal (or absent): `i < stop` is only
            # correct then; negative/dynamic steps keep Python iteration
            or (len(args) == 3 and (_const_step(args[2]) is None or _const_step(args[2]) <= 0))
        ):
            return node
        i = node.target.id
        stop = self._fresh("stop")
        # loop counter is a SEPARATE carried variable so the user target
        # keeps Python for-semantics (last executed value, not one-past-end)
        cnt = self._fresh("cnt").replace("__jst_", "__for_")
        step_lit = _const_step(args[2]) if len(args) == 3 else 1

        pre = []
        init = ast.parse(f"{cnt} = 0").body[0]
        if len(args) >= 2:
            init.value = args[0]
        stop_assign = ast.parse(f"{stop} = 0").body[0]
        stop_assign.value = args[0] if len(args) == 1 else args[1]
        pre += [init, stop_assign]
        # the user target needs a defined init for the traced carry; zero-trip
        # loops leave it at start (Python would leave it unbound — accepted
        # deviation, same as the reference's loop transformer)
        pre += ast.parse(f"{i} = {cnt}").body
        wh = ast.parse(f"while {cnt} < {stop}:\n    pass").body[0]
        wh.body = (
            ast.parse(f"{i} = {cnt}").body
            + list(node.body)
            + ast.parse(f"{cnt} = {cnt} + {step_lit}").body
        )
        converted = self.visit_While(wh)
        out = pre + _as_list(converted)
        for s in out:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
        return out

    def visit_BoolOp(self, node: ast.BoolOp):
        node = self.generic_visit(node)
        if not any(_tensor_likely(v) for v in node.values):
            return node
        self.changed = True
        fn = "convert_logical_and" if isinstance(node.op, ast.And) else "convert_logical_or"
        expr = node.values[-1]
        for prev in reversed(node.values[:-1]):
            lam_a = ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=prev,
            )
            lam_b = ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=expr,
            )
            expr = ast.Call(
                func=ast.Attribute(value=ast.Name(id="_jst", ctx=ast.Load()), attr=fn, ctx=ast.Load()),
                args=[lam_a, lam_b],
                keywords=[],
            )
        ast.copy_location(expr, node)
        ast.fix_missing_locations(expr)
        return expr

    def visit_UnaryOp(self, node: ast.UnaryOp):
        node = self.generic_visit(node)
        if isinstance(node.op, ast.Not) and _tensor_likely(node.operand):
            self.changed = True
            call = ast.Call(
                func=ast.Attribute(value=ast.Name(id="_jst", ctx=ast.Load()), attr="convert_logical_not", ctx=ast.Load()),
                args=[node.operand],
                keywords=[],
            )
            ast.copy_location(call, node)
            ast.fix_missing_locations(call)
            return call
        return node


def _tensor_likely(expr) -> bool:
    """Static heuristic: could this predicate be a Tensor? Comparisons over
    names/calls/attributes → yes; pure literal/constant arithmetic → no.
    False negatives only skip conversion (python path still correct for
    concrete values); false positives cost one runtime type check."""
    for n in ast.walk(expr):
        if isinstance(n, (ast.Name, ast.Call, ast.Attribute, ast.Subscript)):
            return True
    return False


def transform_function(fn):
    """Return fn with tensor control flow converted, or None if the source
    can't be transformed (lambda, builtins, C extensions, exotic closures)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None

    if getattr(fn, "_not_to_static", False):
        return None  # explicitly opted out of AST conversion

    def _is_jit_decorator(d):
        # strip only our own entry points (@to_static / @paddle.jit.to_static,
        # possibly called with options); anything else (functools.wraps, user
        # wrappers, @not_to_static) would be silently dropped — and
        # @not_to_static in particular means the OPPOSITE of convert-me
        target = d.func if isinstance(d, ast.Call) else d
        name = target.attr if isinstance(target, ast.Attribute) else (
            target.id if isinstance(target, ast.Name) else None
        )
        return name in ("to_static", "declarative")

    kept = [d for d in fdef.decorator_list if not _is_jit_decorator(d)]
    if kept:
        return None  # unknown decorators: fall back to trace-only capture
    fdef.decorator_list = []  # run undecorated
    tr = _ControlFlowTransformer()
    fdef.body = [s2 for s in fdef.body for s2 in _as_list(tr.visit(s))]
    ast.fix_missing_locations(tree)
    if not tr.changed:
        # nothing converted: keep the ORIGINAL function (live globals, no
        # snapshot semantics for plain trace-only capture)
        return None

    glb = dict(fn.__globals__)
    from . import dy2static as _jst_mod

    glb["_jst"] = _jst_mod
    # materialize closure variables into the exec namespace
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb[name] = cell.cell_contents  # closure OVERRIDES a same-named global
            except ValueError:
                pass
    try:
        code = compile(tree, filename=f"<to_static {fn.__name__}>", mode="exec")
        ns: dict = {}
        exec(code, glb, ns)
        new_fn = ns[fdef.name]
    except Exception:
        return None
    new_fn.__wrapped_original__ = fn
    return new_fn


def _as_list(x):
    return x if isinstance(x, list) else [x]

"""The port is complete: every module file of ``paddle_tpu`` has its
counterpart at the same path in ``paddle_tpu_torch``, apart from the named
files that have none by design, and the port's top level exports every
public name the reference's does. One level down: every public name of
each reference module is in the port's module, every public method and
property of each reference class is on the port's class of that name, every
attribute of the reference Tensor is on torch's tensor, and the flag
registries hold the same names; each with its named exceptions and their
reasons. AST and file walks of the reference and imports of the port only:
nothing here imports JAX or the reference."""
import ast
import dataclasses
import importlib
from pathlib import Path

import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "paddle_tpu"
PORT = ROOT / "paddle_tpu_torch"

# reference files with no counterpart, each with its reason
NO_COUNTERPART = {
    "core/compat.py": "a shim over JAX versions",
    "ops/pallas/__init__.py": "the Pallas kernels: ported as ops/kernels/",
    "ops/pallas/flash_attention.py": "ported as ops/kernels/flash_attention"
                                     ".py over csrc/flash_attention.cu",
}
# ``from __future__ import annotations`` binds a name that is not the API
NOT_API = {"annotations"}


def _py(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


REF_FILES = _py(REF)


@pytest.mark.parametrize("rel", REF_FILES)
def test_every_reference_file_has_its_counterpart(rel):
    if rel in NO_COUNTERPART:
        assert not (PORT / rel).exists(), rel
        return
    assert (PORT / rel).is_file(), f"{rel} has no counterpart in the port"


def test_the_exceptions_are_exactly_the_named_ones():
    missing = {r for r in REF_FILES if not (PORT / r).is_file()}
    assert missing == set(NO_COUNTERPART)
    assert (PORT / "ops" / "kernels" / "flash_attention.py").is_file()
    assert (PORT / "ops" / "kernels" / "csrc" / "flash_attention.cu") \
        .is_file()


def _bound_names(path):
    """The public names a module binds at its top level (imports,
    assignments, definitions)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names
                    if a.name != "*"}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
    return {n for n in out if not n.startswith("_")}


REF_TOP = sorted(_bound_names(REF / "__init__.py") - NOT_API)


def test_the_reference_top_level_is_read():
    assert len(REF_TOP) > 300
    assert {"text", "dataset", "reader", "device", "hub", "onnx",
            "cost_model", "batch", "dtype"} <= set(REF_TOP)


@pytest.mark.parametrize("name", REF_TOP)
def test_every_top_level_name_is_exported(name):
    import paddle_tpu_torch as tp

    assert hasattr(tp, name), name
    assert name in tp.__all__ or name in ("bool",), name


def test_the_port_imports_no_jax_here():
    import sys

    import paddle_tpu_torch  # noqa: F401

    assert "paddle_tpu_torch" in sys.modules
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] not in ("jax", "paddle_tpu")
                           for a in node.names), path
            elif isinstance(node, ast.ImportFrom) and not node.level:
                assert (node.module or "").split(".")[0] not in (
                    "jax", "paddle_tpu"), path


# -- one level down: module names, class attributes, Tensor attributes, flags
def _top(body):
    """A module's top-level statements, inside ``if``/``try`` blocks too."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top(node.body)
            for h in getattr(node, "handlers", ()):
                yield from _top(h.body)
            yield from _top(node.orelse)
            yield from _top(getattr(node, "finalbody", ()))
        else:
            yield node


def _module_names(path):
    """A reference module's public names: what it defines or assigns, its
    ``__all__``, and in a package's ``__init__.py`` what it re-exports from
    the package (an import marked ``noqa: F401``, the reference's marker)."""
    text = path.read_text()
    lines = text.splitlines()
    out = set()
    for node in _top(ast.parse(text).body):
        if isinstance(node, ast.ImportFrom):
            if path.name == "__init__.py" and "noqa: F401" in \
                    lines[node.end_lineno - 1] and (
                    node.level or node.module.split(".")[0] == "paddle_tpu"):
                out |= {a.asname or a.name for a in node.names
                        if a.name != "*"}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    out |= _literal_names(node.value)
                elif isinstance(t, ast.Name):
                    out.add(t.id)
                elif isinstance(t, ast.Tuple):
                    out |= {e.id for e in t.elts if isinstance(e, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out.add(node.name)
    return {n for n in out if not n.startswith("_")} - NOT_API


def _literal_names(node):
    """The strings of a literal ``__all__`` (lists joined by ``+`` too); a
    computed one (``sorted(GENERATED)``, the table ops) gives none here."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _literal_names(node.left) | _literal_names(node.right)
    try:
        return set(ast.literal_eval(node))
    except ValueError:
        return set()


def _port_module(rel):
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(["paddle_tpu_torch", *parts]))


PORTED_FILES = [r for r in REF_FILES if r not in NO_COUNTERPART]

# reference module names with no counterpart in the port, each with its
# reason ("file:name")
NO_COUNTERPART_NAMES = {
    "autograd/__init__.py:run_backward":
        "the reference's tape engine entry; the port's backward is torch's "
        "autograd (autograd.backward)",
    "core/engine.py:run_backward": "the reference's tape engine: torch's "
                                   "autograd here",
    "core/engine.py:GradNode": "a node of the reference's tape: torch's "
                               "autograd graph here (Tensor.grad_fn)",
    "core/dispatch.py:eager_call": "the reference's op dispatch over jnp "
                                   "builders; the port's ops call torch",
    "core/dispatch.py:as_tensor": "wraps a jax array in the reference's "
                                  "Tensor; torch.as_tensor here",
    "core/dispatch.py:unary": "an eager_call helper",
    "core/dispatch.py:binary": "an eager_call helper",
    "core/random.py:next_key": "a JAX PRNG key; the port's generators are "
                               "torch.Generator objects",
    "core/random.py:traced_keys": "installs JAX PRNG keys into a trace",
    "distributed/mesh.py:shard_map_compat": "returns jax's shard_map",
    "distributed/mesh.py:named_sharding": "returns a jax NamedSharding; "
                                          "sharding_api.NamedSharding here",
    "distributed/fleet/meta_parallel/pipeline_parallel.py:spmd_pipeline_fn":
        "a shard_map body; the port's pipeline is PipelineTrainStep",
    "models/gpt.py:P": "jax's PartitionSpec, imported for the reference's "
                       "activation constraints; sharding_api.PartitionSpec "
                       "here",
    "models/generation.py:tp_pool_sharding": "a jax sharding of the KV pool",
    "models/generation.py:tp_param_shardings": "jax shardings of the "
                                               "parameters",
}

_WALKED = {f"{rel}:{n}" for rel in PORTED_FILES
           for n in _module_names(REF / rel)}
# names a reference module imports from another and exports, which the
# walk above does not count (a plain import)
IMPORTED_NAMES = {"core/tensor.py:LazyArray",
                  "core/tensor.py:lazy_timed_block"}
MODULE_NAMES = sorted(_WALKED | set(NO_COUNTERPART_NAMES) | IMPORTED_NAMES)


def test_the_module_names_are_read():
    assert len(MODULE_NAMES) > 1500
    assert {"autograd/__init__.py:hessian", "framework/flags.py:"
            "register_flag", "framework/__init__.py:Parameter",
            "distributed/__init__.py:TCPStore"} <= set(MODULE_NAMES)
    assert set(NO_COUNTERPART_NAMES) - _WALKED == set()
    assert not IMPORTED_NAMES & _WALKED


@pytest.mark.parametrize("key", MODULE_NAMES)
def test_every_reference_module_name_is_in_the_port(key):
    rel, name = key.split(":")
    present = hasattr(_port_module(rel), name)
    if key in NO_COUNTERPART_NAMES:
        assert not present, f"{key} is ported: take it off the exceptions"
    else:
        assert present, f"{key} has no counterpart in the port"


def _classes():
    """{(file, class): (own public attributes, base names)} of every public
    class the reference defines at a module's top level."""
    out = {}
    for rel in PORTED_FILES:
        for node in _top(ast.parse((REF / rel).read_text()).body):
            if not isinstance(node, ast.ClassDef) or \
                    node.name.startswith("_"):
                continue
            attrs = set()
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    attrs.add(b.name)
                elif isinstance(b, ast.Assign):
                    attrs |= {t.id for t in b.targets
                              if isinstance(t, ast.Name)}
                elif isinstance(b, ast.AnnAssign) and isinstance(
                        b.target, ast.Name):
                    attrs.add(b.target.id)
            bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr",
                                                                   None)
                     for b in node.bases]
            out[(rel, node.name)] = ({a for a in attrs
                                      if not a.startswith("_")}, bases)
    return out


CLASSES = _classes()
_BY_NAME = {}
for _key in CLASSES:
    _BY_NAME.setdefault(_key[1], []).append(_key)


def _class_attrs(key, chain=()):
    """{attribute: the classes from ``key`` up to the one defining it}
    over the reference bases (a base name the reference defines once)."""
    own, bases = CLASSES[key]
    chain = chain + (key,)
    out = {a: chain for a in own}
    for b in bases:
        found = _BY_NAME.get(b, [])
        if len(found) == 1 and found[0] not in chain:
            for a, c in _class_attrs(found[0], chain).items():
                out.setdefault(a, c)
    return out


_SPARSE_DENSE = "the port's sparse tensors wrap a torch sparse tensor " \
                "instead of subclassing the dense Tensor: its dense methods " \
                "are the wrapped tensor's (to_dense())"
# reference class attributes with no counterpart ("file:Class.attr", which
# covers the subclasses too), each with its reason
NO_COUNTERPART_ATTRS = {
    "core/place.py:Place.jax_device": "returns a jax device; "
                                      "Place.torch_device() here",
    "distributed/engine.py:HybridParallelEngine.lower_text":
        "StableHLO text of the reference's compiled step; the port's step "
        "runs eagerly",
    **{f"sparse/__init__.py:SparseTensor.{a}": _SPARSE_DENSE for a in (
        "backward", "clear_grad", "clear_gradient", "copy_", "cpu",
        "detach", "detach_", "grad_fn", "is_leaf", "item", "pin_memory",
        "register_hook", "set_value", "to", "tolist")},
}
CLASS_KEYS = sorted(f"{rel}:{name}" for rel, name in CLASSES
                    if f"{rel}:{name}" not in NO_COUNTERPART_NAMES)


def test_the_classes_are_read():
    assert len(CLASS_KEYS) > 400
    attrs = _class_attrs(("sparse/__init__.py", "SparseCooTensor"))
    assert attrs["backward"][-1] == ("core/tensor.py", "Tensor")


@pytest.mark.parametrize("key", CLASS_KEYS)
def test_every_reference_class_attribute_is_on_the_port_class(key):
    rel, name = key.split(":")
    cls = getattr(_port_module(rel), name)
    fields = {f.name for f in dataclasses.fields(cls)} \
        if dataclasses.is_dataclass(cls) else set()
    missing, stale = [], []
    for attr, chain in sorted(_class_attrs((rel, name)).items()):
        excused = any(f"{r}:{c}.{attr}" in NO_COUNTERPART_ATTRS
                      for r, c in chain)
        present = hasattr(cls, attr) or attr in fields
        if present and excused:
            stale.append(attr)
        elif not present and not excused:
            missing.append(attr)
    assert not missing, f"{key} lacks {missing}"
    assert not stale, f"{key} has {stale}: take them off the exceptions"


def _string_args(tree, fn_name):
    """The string first arguments of every call of ``fn_name``."""
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and fn_name in (
                getattr(n.func, "id", None), getattr(n.func, "attr", None))
            and n.args and isinstance(n.args[0], ast.Constant)}


def reference_tensor_attrs():
    """The reference Tensor's public attributes, read from its source: the
    class (its methods, properties, aliases and slots), the methods
    ``ops/__init__.py`` attaches, the table ops of ``ops.yaml`` that are
    methods and the in-place ops of ``ops/inplace.py``."""
    out = set()
    tree = ast.parse((REF / "core" / "tensor.py").read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Tensor")
    for b in cls.body:
        if isinstance(b, ast.FunctionDef):
            out.add(b.name)
        elif isinstance(b, ast.Assign):
            for t in b.targets:
                if isinstance(t, ast.Name) and t.id == "__slots__":
                    out |= set(ast.literal_eval(b.value))
                elif isinstance(t, ast.Name):
                    out.add(t.id)
    tree = ast.parse((REF / "ops" / "__init__.py").read_text())
    out |= _string_args(tree, "_attach")
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            out |= {e.value for e in node.iter.elts
                    if isinstance(e, ast.Constant)}
    specs = yaml.safe_load((REF / "ops" / "ops.yaml").read_text())
    out |= {s["name"] for group in specs.values() for s in group
            if s.get("method", True)}
    tree = ast.parse((REF / "ops" / "inplace.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == \
                "_INPLACE_BASES":
            out |= {b + "_" for b in ast.literal_eval(node.value)}
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "attach")
    out |= {e.elts[0].value for n in ast.walk(fn) if isinstance(n, ast.Tuple)
            for e in n.elts if isinstance(e, ast.Tuple)
            and isinstance(e.elts[0], ast.Constant)}
    return {n for n in out if not n.startswith("_")}


REF_TENSOR_ATTRS = sorted(reference_tensor_attrs())


def test_the_tensor_attributes_are_read():
    assert len(REF_TENSOR_ATTRS) == 346
    assert {"stop_gradient", "set_value", "place", "transpose", "sinc",
            "abs_", "fill_"} <= set(REF_TENSOR_ATTRS)


@pytest.mark.parametrize("name", REF_TENSOR_ATTRS)
def test_every_reference_tensor_attribute_is_on_torch_tensor(name):
    """Present on torch's tensor (the port attaches what torch lacks); a
    name torch has with another meaning is in ``TORCH_METHOD_CONFLICTS``
    (tests/test_torch_api_parity.py classifies each)."""
    import paddle_tpu_torch  # noqa: F401  (attaches the port's names)
    from paddle_tpu_torch.ops import TORCH_METHOD_CONFLICTS

    assert hasattr(torch.Tensor, name) or name in TORCH_METHOD_CONFLICTS, \
        name


def _reference_flags():
    """The reference registry's names: the ``_FLAGS`` literal and every
    ``register_flag`` call in the package."""
    tree = ast.parse((REF / "framework" / "flags.py").read_text())
    lit = next(n.value for n in tree.body if isinstance(n, ast.AnnAssign)
               and n.target.id == "_FLAGS")
    names = {k.value for k in lit.keys}
    for path in REF.rglob("*.py"):
        if "__pycache__" not in path.parts:
            names |= {n for n in _string_args(ast.parse(path.read_text()),
                                              "register_flag")
                      if isinstance(n, str) and n.startswith("FLAGS_")}
    return names


REF_FLAGS = sorted(_reference_flags())


def test_the_flag_registries_hold_the_same_names():
    from paddle_tpu_torch.framework import flags

    assert len(REF_FLAGS) == 73
    assert set(flags._FLAGS) == set(REF_FLAGS)


@pytest.mark.parametrize("name", REF_FLAGS)
def test_set_flags_accepts_every_reference_flag(name):
    from paddle_tpu_torch.framework import flags

    value = flags.get_flags(name)[name]
    flags.set_flags({name: value})
    assert flags.get_flags([name]) == {name: value}

"""The port is complete: every module file of ``paddle_tpu`` has its
counterpart at the same path in ``paddle_tpu_torch``, apart from the named
files that have none by design, and the port's top level exports every
public name the reference's does. AST and file walks only: nothing here
imports JAX or the reference."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "paddle_tpu"
PORT = ROOT / "paddle_tpu_torch"

# reference files with no counterpart, each with its reason
NO_COUNTERPART = {
    "core/lazy.py": "the lazy pending graph: the port runs eagerly",
    "core/compat.py": "a shim over JAX versions",
    "ops/pallas/__init__.py": "the Pallas kernels: ported as ops/kernels/",
    "ops/pallas/flash_attention.py": "ported as ops/kernels/flash_attention"
                                     ".py over csrc/flash_attention.cu",
    "analysis/verify_graph.py": "verifies core/lazy.py's pending graph, "
                                "which the port does not have",
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

"""The op surface's coverage and isolation.

- Every public name of each of the slice's 17 reference modules (the
  ``ops`` modules ``math``, ``manipulation``, ``creation``, ``generated``,
  ``registry``, ``inplace``, ``control_flow``, ``linalg``, ``misc``,
  ``extra``, ``sequence`` and ``metrics_ops``, and ``tensor``, ``fft``,
  ``signal``, ``sparse`` and ``distribution``, with ``linalg/``) has its
  counterpart in the port, and the names the reference's top level exports
  from them are exported by the port's.
- The port's ``all_ops()`` is the reference's less exactly the names of the
  modules not ported (``MISSING_MODULES``: none is left).
- Importing the port replaces no attribute of ``torch.Tensor`` (checked in
  a fresh interpreter that records every attribute first) and adds only
  names torch's tensor lacks.
- No port module reads ``yaml``; the spec table is ``ops/ops.json``.
- ``cost_model.get_static_op_time`` measures and caches by (op, forward,
  dtype, shape).
"""
import ast
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

import paddle_tpu
import paddle_tpu_torch as tp
from paddle_tpu.ops import registry as RR
from paddle_tpu_torch.ops import registry as PR
from torch_port_util import cpu_device, public_names

ROOT = Path(__file__).resolve().parents[1]

MODULES = {
    "ops/math.py": "paddle_tpu_torch.ops.math",
    "ops/manipulation.py": "paddle_tpu_torch.ops.manipulation",
    "ops/creation.py": "paddle_tpu_torch.ops.creation",
    "ops/generated.py": "paddle_tpu_torch.ops.generated",
    "ops/registry.py": "paddle_tpu_torch.ops.registry",
    "ops/inplace.py": "paddle_tpu_torch.ops.inplace",
    "ops/control_flow.py": "paddle_tpu_torch.ops.control_flow",
    "ops/linalg.py": "paddle_tpu_torch.ops.linalg",
    "ops/misc.py": "paddle_tpu_torch.ops.misc",
    "ops/extra.py": "paddle_tpu_torch.ops.extra",
    "ops/sequence.py": "paddle_tpu_torch.ops.sequence",
    "ops/metrics_ops.py": "paddle_tpu_torch.ops.metrics_ops",
    "fft.py": "paddle_tpu_torch.fft",
    "signal.py": "paddle_tpu_torch.signal",
    "sparse/__init__.py": "paddle_tpu_torch.sparse",
    "distribution/__init__.py": "paddle_tpu_torch.distribution",
}


def _ref(path):
    return ROOT / "paddle_tpu" / path


@pytest.mark.parametrize("path", sorted(MODULES))
def test_every_public_name_has_its_counterpart(path):
    names = public_names(_ref(path))
    if path == "ops/generated.py":
        from paddle_tpu.ops.generated import GENERATED

        names |= set(GENERATED)
    port = importlib.import_module(MODULES[path])
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


def _imported_names(path):
    """The names a reference file imports from its own package."""
    out = set()
    for node in ast.parse(_ref(path).read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level:
            out |= {a.asname or a.name for a in node.names}
    return out


def test_the_tensor_and_linalg_namespaces():
    ops = ["creation", "math", "manipulation", "linalg"]
    want = set().union(*[public_names(_ref(f"ops/{m}.py")) for m in ops])
    want |= public_names(_ref("tensor/__init__.py"))
    want |= {n for n in _imported_names("tensor/__init__.py") if n != "*"}
    assert not sorted(n for n in want if not hasattr(tp.tensor, n))
    assert callable(tp.tensor.math.add) and callable(tp.tensor.search.sort)
    want = _imported_names("linalg/__init__.py")
    assert not sorted(n for n in want if not hasattr(tp.linalg, n))


def _top_level_exports():
    """The names ``paddle_tpu/__init__.py`` imports from the slice's
    modules, the table ops it adds and its v1 in-place names."""
    mods = {"ops.creation", "ops.math", "ops.manipulation", "ops.extra",
            "ops.misc", "linalg"}
    out = set()
    for node in ast.parse(_ref("__init__.py").read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            if node.module in mods:
                out |= {a.asname or a.name for a in node.names}
            elif node.module is None:
                out |= {a.name for a in node.names if a.name in (
                    "fft", "signal", "linalg", "sparse", "tensor",
                    "distribution")}
    from paddle_tpu.ops.generated import GENERATED

    out |= set(GENERATED)
    out |= {n for n in ("scatter_", "squeeze_", "tanh_", "unsqueeze_",
                        "relu_", "clip_", "exp_", "sqrt_", "subtract_",
                        "add_") if hasattr(paddle_tpu, n)}
    return out


def test_the_top_level_exports_what_the_reference_exports():
    want = _top_level_exports()
    missing = sorted(n for n in want if not hasattr(tp, n))
    assert not missing, missing
    for n in want:
        assert n in tp.__all__, n


def _module_fns(mod):
    return set(RR._module_fns(mod))


def _missing():
    """The reference registry's names from the modules not ported: none
    (``text``'s ``viterbi_decode``, the last, is in the port)."""
    return {k for k in RR.all_ops()
            if k.split(".")[0] in PR.MISSING_MODULES}


def test_all_ops_is_the_references_less_the_modules_not_ported():
    ref, port = set(RR.all_ops()), set(PR.all_ops())
    missing = _missing()
    assert port - ref == set(), sorted(port - ref)
    assert ref - port == missing, (sorted(ref - port - missing),
                                   sorted(missing - (ref - port)))
    assert len(missing) == 0, len(missing)
    assert PR.op_count() == len(ref) - len(missing)
    assert all(callable(f) for f in PR.all_ops().values())


def test_importing_the_port_replaces_no_tensor_attribute():
    code = (
        "import inspect, torch\n"
        "get = lambda n: inspect.getattr_static(torch.Tensor, n)\n"
        "before = {n: get(n) for n in dir(torch.Tensor)}\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch.ops import registry\n"
        "registry.all_ops()\n"
        "changed = [n for n, v in before.items() if get(n) is not v]\n"
        "added = sorted(set(dir(torch.Tensor)) - set(before))\n"
        "assert not changed, changed\n"
        "assert 'astype' in added and 'cast_' in added, added\n"
        "print(len(added))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) > 0


def test_no_port_module_reads_yaml():
    for p in (ROOT / "paddle_tpu_torch").rglob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "yaml"
                           for a in node.names), p
            elif isinstance(node, ast.ImportFrom):
                assert (node.module or "").split(".")[0] != "yaml", p
    from paddle_tpu_torch.ops import generated

    assert generated._SPEC_PATH.endswith("ops.json")


def test_static_op_time_measures_and_caches():
    from paddle_tpu_torch import cost_model

    cm = cost_model.CostModel("cpu")
    with cpu_device():
        a = cm.get_static_op_time("exp", shape=(8, 16))
        b = cm.get_static_op_time("exp", shape=(8, 16))
        c = cm.get_static_op_time("gelu", forward=False, shape=(8, 16))
    assert a is b and a["op_time"] > 0 and c["op_time"] > 0
    assert a["bytes_in"] == a["bytes_out"] == 8 * 16 * 4
    assert set(cm.static_cost_data()) == {"exp/True/float32/(8, 16)",
                                          "gelu/False/float32/(8, 16)"}
    with pytest.raises(KeyError):
        cm.get_static_op_time("no_such_op")


def test_missing_modules_are_named():
    assert PR.MISSING_MODULES == ()
    assert inspect.isfunction(PR.all_ops)


# the reference's nn modules and the port's counterparts
NN_MODULES = {
    f"nn/functional/{m}.py": f"paddle_tpu_torch.nn.functional.{m}"
    for m in ("activation", "common", "conv", "loss", "norm", "pooling",
              "vision", "sparse_attention", "attention")}
NN_MODULES.update({
    f"nn/layer/{m}.py": f"paddle_tpu_torch.nn.layer.{m}"
    for m in ("activation", "common", "conv", "layers", "loss", "norm",
              "pooling", "rnn", "transformer")})
NN_MODULES["nn/utils/__init__.py"] = "paddle_tpu_torch.nn.utils"


@pytest.mark.parametrize("path", sorted(NN_MODULES))
def test_every_public_nn_name_has_its_counterpart(path):
    names = public_names(_ref(path))
    port = importlib.import_module(NN_MODULES[path])
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


@pytest.mark.parametrize("pkg", ["nn", "nn/functional"])
def test_the_nn_namespaces_export_what_the_references_do(pkg):
    want = {n for n in _imported_names(f"{pkg}/__init__.py") if n != "*"}
    port = importlib.import_module("paddle_tpu_torch." + pkg.replace(
        "/", "."))
    assert not sorted(n for n in want if not hasattr(port, n))

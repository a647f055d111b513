"""The port stands alone: ``paddle_tpu_torch``, ``chip_smoke.py`` and
``flash_ab.py`` import neither ``jax`` nor ``paddle_tpu``, and its entry
points never fall back to the CPU quietly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "flash_ab.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_walk_covers_the_fault_package_and_the_supervisor():
    for path in ("paddle_tpu_torch/fault/__init__.py",
                 "paddle_tpu_torch/fault/inject.py",
                 "paddle_tpu_torch/fault/memory.py",
                 "paddle_tpu_torch/serving/supervisor.py"):
        assert path in PORT_FILES


def test_walk_covers_the_profiler_and_serving_observability():
    for path in ("paddle_tpu_torch/profiler/__init__.py",
                 "paddle_tpu_torch/profiler/spans.py",
                 "paddle_tpu_torch/profiler/flight.py",
                 "paddle_tpu_torch/profiler/export.py",
                 "paddle_tpu_torch/serving/observe.py",
                 "paddle_tpu_torch/framework/io.py"):
        assert path in PORT_FILES


def test_walk_covers_the_kernel_registry_and_the_cost_model():
    for path in ("paddle_tpu_torch/ops/kernels/registry.py",
                 "paddle_tpu_torch/ops/kernels/autotune.py",
                 "paddle_tpu_torch/ops/kernels/db.py",
                 "paddle_tpu_torch/ops/kernels/builtin.py",
                 "paddle_tpu_torch/cost_model/__init__.py"):
        assert path in PORT_FILES


def test_walk_covers_the_paddle_api_surface():
    for path in ("paddle_tpu_torch/core/dtype.py",
                 "paddle_tpu_torch/core/tensor.py",
                 "paddle_tpu_torch/core/engine.py",
                 "paddle_tpu_torch/autograd/__init__.py",
                 "paddle_tpu_torch/ops/creation.py",
                 "paddle_tpu_torch/ops/math.py",
                 "paddle_tpu_torch/ops/manipulation.py",
                 "paddle_tpu_torch/nn/layer/layers.py",
                 "paddle_tpu_torch/nn/layer/activation.py",
                 "paddle_tpu_torch/nn/initializer.py",
                 "paddle_tpu_torch/nn/param_attr.py",
                 "paddle_tpu_torch/nn/clip.py",
                 "paddle_tpu_torch/nn/functional/activation.py",
                 "paddle_tpu_torch/nn/functional/norm.py",
                 "paddle_tpu_torch/optimizer/lr.py",
                 "paddle_tpu_torch/utils/unique_name.py"):
        assert path in PORT_FILES


def test_walk_covers_the_training_runtime():
    for path in ("paddle_tpu_torch/amp/__init__.py",
                 "paddle_tpu_torch/io/__init__.py",
                 "paddle_tpu_torch/io/ragged.py",
                 "paddle_tpu_torch/framework/io.py",
                 "paddle_tpu_torch/fault/retry.py",
                 "paddle_tpu_torch/fault/preemption.py",
                 "paddle_tpu_torch/fault/sentinel.py"):
        assert path in PORT_FILES


def test_walk_covers_the_admission_and_distributed_training():
    for path in ("paddle_tpu_torch/distributed/__init__.py",
                 "paddle_tpu_torch/distributed/mesh.py",
                 "paddle_tpu_torch/distributed/parallel_env.py",
                 "paddle_tpu_torch/distributed/collective.py",
                 "paddle_tpu_torch/distributed/parallel.py",
                 "paddle_tpu_torch/distributed/engine.py",
                 "paddle_tpu_torch/distributed/fleet/grad_buckets.py",
                 "paddle_tpu_torch/cost_model/__init__.py",
                 "paddle_tpu_torch/fault/memory.py"):
        assert path in PORT_FILES


def test_dist_worker_imports_neither_jax_nor_the_reference():
    tree = ast.parse((ROOT / "tests/torch_dist_worker.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if _forbidden(m)]


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.serving.supervisor, paddle_tpu_torch.fault, "
            "paddle_tpu_torch.fault.inject, paddle_tpu_torch.fault.memory, "
            "paddle_tpu_torch.models, paddle_tpu_torch.ops.kernels, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.nn.functional, paddle_tpu_torch.ops.fused_ce, "
            "paddle_tpu_torch.profiler.export, "
            "paddle_tpu_torch.serving.observe, paddle_tpu_torch.framework.io, "
            "paddle_tpu_torch.ops.kernels.autotune, "
            "paddle_tpu_torch.ops.kernels.db, paddle_tpu_torch.cost_model, "
            "paddle_tpu_torch.autograd, paddle_tpu_torch.nn.clip, "
            "paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.ops.math, "
            "paddle_tpu_torch.ops.manipulation, paddle_tpu_torch.utils, "
            "paddle_tpu_torch.amp, paddle_tpu_torch.io, "
            "paddle_tpu_torch.io.ragged, paddle_tpu_torch.fault.retry, "
            "paddle_tpu_torch.fault.preemption, "
            "paddle_tpu_torch.fault.sentinel, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.distributed.mesh, "
            "paddle_tpu_torch.distributed.parallel_env, "
            "paddle_tpu_torch.distributed.collective, "
            "paddle_tpu_torch.distributed.parallel, "
            "paddle_tpu_torch.distributed.engine, "
            "paddle_tpu_torch.distributed.fleet.grad_buckets, "
            "paddle_tpu_torch.static, paddle_tpu_torch.static.program, "
            "paddle_tpu_torch.jit.dy2static, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.inference.capi\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_engine_without_device_raises_when_cuda_missing(monkeypatch):
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import Engine

    model = GPTForPretraining(GPTConfig(
        vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
        max_position_embeddings=32), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, block_size=8, num_blocks=8, max_batch=2)


def test_llama_engine_without_device_raises_when_cuda_missing(monkeypatch):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine

    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
        num_kv_heads=1, max_position_embeddings=32), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, block_size=8, num_blocks=8, max_batch=2)


def test_supervisor_without_device_raises_when_cuda_missing(monkeypatch):
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import ServingSupervisor

    model = GPTForPretraining(GPTConfig(
        vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
        max_position_embeddings=32), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingSupervisor(model, watchdog_s=1.0, block_size=8, num_blocks=8,
                          max_batch=2)


# -- the port's own sources: no path into the reference's tree ---------------
# a path component runtime_cpp, the reference runtime's library, or a path
# through a paddle_tpu directory (the bare module name is not a path)
_REF_PATH = __import__("re").compile(
    r"(^|[/\\])runtime_cpp([/\\]|$)|libpaddle_tpu_runtime"
    r"|(^|[/\\])paddle_tpu[/\\]|[/\\]paddle_tpu$")
PORT_SOURCES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "paddle_tpu_torch").rglob("*")
    if p.suffix in (".py", ".cc", ".cu", ".h"))


def _code_strings(path):
    """The string constants a file's code computes with: a Python file's
    constants other than docstrings (f-strings' literal parts included), a
    C++ file's string literals. Docstrings and comments may name the
    reference's files; code may not."""
    text = (ROOT / path).read_text()
    if not path.endswith(".py"):
        import re

        return re.findall(r'"((?:[^"\\\n]|\\.)*)"', "\n".join(
            line.split("//")[0] for line in text.splitlines()))
    tree = ast.parse(text, filename=path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_no_path_into_the_reference_tree(path):
    bad = [s for s in _code_strings(path) if _REF_PATH.search(s)]
    assert not bad, f"{path} names the reference's tree: {bad}"


def test_reference_path_check_catches_a_cdll_of_runtime_cpp(tmp_path):
    """The check itself: a library path into runtime_cpp/ or paddle_tpu/ in
    code is caught, a docstring that names the file is not."""
    assert _REF_PATH.search("runtime_cpp/libpaddle_tpu_runtime.so")
    assert _REF_PATH.search(os.path.join("x", "runtime_cpp"))
    assert _REF_PATH.search("../paddle_tpu/core/native.py")
    assert not _REF_PATH.search("paddle_tpu_torch/_build/libx.so")
    assert not _REF_PATH.search("paddle_tpu_torch")
    assert not _REF_PATH.search("paddle_tpu")  # a module name, not a path
    src = ('"""Port of runtime_cpp/trace.cc."""\n'
           'import ctypes\n'
           'L = ctypes.CDLL("runtime_cpp/libpaddle_tpu_runtime.so")\n')
    f = tmp_path / "probe.py"  # an absolute path: ROOT / f is f
    f.write_text(src)
    assert _code_strings(str(f)) == ["runtime_cpp/libpaddle_tpu_runtime.so"]


def test_walk_covers_the_native_runtime():
    for path in ("paddle_tpu_torch/core/native.py",
                 "paddle_tpu_torch/core/csrc/trace.cc",
                 "paddle_tpu_torch/core/csrc/queue.cc",
                 "paddle_tpu_torch/core/csrc/arena.cc"):
        assert path in PORT_SOURCES
    assert "paddle_tpu_torch/core/native.py" in PORT_FILES


def test_walk_covers_the_high_level_api_and_vision():
    models = ("alexnet", "densenet", "googlenet", "inceptionv3", "lenet",
              "mobilenetv1", "mobilenetv2", "resnet", "resnext",
              "shufflenetv2", "squeezenet", "vgg", "vit", "yolov3")
    for path in ("paddle_tpu_torch/hapi/model.py",
                 "paddle_tpu_torch/hapi/callbacks.py",
                 "paddle_tpu_torch/hapi/flops.py",
                 "paddle_tpu_torch/callbacks.py",
                 "paddle_tpu_torch/metric/__init__.py",
                 "paddle_tpu_torch/vision/ops.py",
                 "paddle_tpu_torch/vision/transforms/__init__.py",
                 "paddle_tpu_torch/vision/datasets/__init__.py",
                 "paddle_tpu_torch/vision/models/__init__.py",
                 *[f"paddle_tpu_torch/vision/models/{m}.py" for m in models]):
        assert path in PORT_FILES, path


def test_native_runtime_loads_nothing_of_runtime_cpp():
    """A process that records a profiler session and moves bytes through
    the native queue has the port's library mapped, and nothing from
    runtime_cpp/."""
    code = ("import paddle_tpu_torch.profiler as p\n"
            "from paddle_tpu_torch.core import native\n"
            "with p.Profiler(targets=[p.ProfilerTarget.CPU]):\n"
            "    with p.span('s'):\n"
            "        pass\n"
            "q = native.NativeQueue(2); q.push(b'x'); assert q.pop() == b'x'\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert str(native.library_path()) in maps\n"
            "assert 'runtime_cpp' not in maps, 'runtime_cpp mapped'\n"
            "assert 'libpaddle_tpu_runtime' not in maps\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_walk_covers_export_and_deployment():
    for path in ("paddle_tpu_torch/jit/__init__.py",
                 "paddle_tpu_torch/jit/dy2static.py",
                 "paddle_tpu_torch/static/__init__.py",
                 "paddle_tpu_torch/static/input.py",
                 "paddle_tpu_torch/static/program.py",
                 "paddle_tpu_torch/inference/__init__.py",
                 "paddle_tpu_torch/inference/capi.py"):
        assert path in PORT_FILES, path
    for path in ("paddle_tpu_torch/inference/csrc/paddle_tpu_c.h",
                 "paddle_tpu_torch/inference/csrc/paddle_tpu_c.cc",
                 "paddle_tpu_torch/inference/csrc/capi_demo.cc"):
        assert path in PORT_SOURCES, path


def test_c_api_loads_nothing_of_runtime_cpp():
    """A process that drives the port's C inference API has the port's
    library mapped, and nothing from runtime_cpp/ (whose
    libpaddle_tpu_c.so is the reference's)."""
    code = ("import paddle_tpu_torch as tp\n"
            "from paddle_tpu_torch.inference import capi\n"
            "L = capi.lib()\n"
            "assert not L.PD_PredictorCreateOnDevice(b'/nonexistent', b'cpu')"
            "\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert str(capi.build()) in maps\n"
            "assert 'runtime_cpp' not in maps, 'runtime_cpp mapped'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_walk_covers_quantization_and_incubate():
    for path in ("paddle_tpu_torch/quantization/__init__.py",
                 "paddle_tpu_torch/incubate/__init__.py",
                 "paddle_tpu_torch/incubate/operators.py",
                 "paddle_tpu_torch/incubate/nn/__init__.py",
                 "paddle_tpu_torch/incubate/asp.py",
                 "paddle_tpu_torch/incubate/custom_op.py",
                 "paddle_tpu_torch/incubate/distributed_fused_lamb.py",
                 "paddle_tpu_torch/incubate/optimizer_extras.py",
                 "paddle_tpu_torch/incubate/host_embedding.py"):
        assert path in PORT_FILES, path
    assert "paddle_tpu_torch/core/csrc/embed.cc" in PORT_SOURCES


def test_host_embedding_loads_nothing_of_runtime_cpp():
    """A process that trains the host embedding on the native kernels and
    imports quantization and incubate has the port's library mapped (its
    own embed.cc), nothing from runtime_cpp/, and no JAX."""
    code = ("import sys, numpy as np, torch\n"
            "import paddle_tpu_torch as tp\n"
            "from paddle_tpu_torch import incubate, quantization\n"
            "from paddle_tpu_torch.core import native\n"
            "from paddle_tpu_torch.framework.flags import set_flags\n"
            "tp.set_device('cpu')\n"
            "set_flags({'FLAGS_host_emb_native': True})\n"
            "emb = incubate.HostEmbedding(64, 8)\n"
            "out = emb(torch.tensor([[1, 2, 2, 5]]))\n"
            "(out * out).sum().backward()\n"
            "emb.apply_gradients(0.1)\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert str(native.library_path()) in maps\n"
            "assert 'runtime_cpp' not in maps, 'runtime_cpp mapped'\n"
            "assert 'libpaddle_tpu_runtime' not in maps\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

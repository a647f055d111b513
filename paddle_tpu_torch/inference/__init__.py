"""paddle.inference, the deployment path (port of
``paddle_tpu/inference/__init__.py``).

Parity: reference ``paddle/fluid/inference/api/analysis_predictor.h:87``
(AnalysisPredictor), ``paddle_inference_api.h`` (Config/Predictor/Tensor
handles). The artifact is ``jit.save``'s: a ``torch.export`` program and
its weights. ``Config`` names the artifact and the device: the card
(``cuda:0``) by default, ``enable_use_gpu(device_id=)`` for ``cuda:<id>``,
``disable_gpu()`` for the CPU. A ``Predictor`` loads the program and the
weights once onto that device (a program traced on another device is moved
there: an artifact saved on the card runs on the CPU through the plain
versions of its kernels, the flash operator's CPU implementation) and runs
under ``torch.inference_mode()``. Its named handles take numpy arrays
(``copy_from_cpu``) or a tensor already on the device without a copy
(``share_external_data``). ``clone()`` shares the loaded module and
weights with new input/output slots (the reference's
AnalysisPredictor::Clone). The reference's IR-pass toggles are recorded and
change nothing, as in the reference.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import dtype as dtypes


class Config:
    """AnalysisConfig equivalent (reference paddle_analysis_config.h)."""

    def __init__(self, model_dir_or_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if model_dir_or_file is not None and \
                model_dir_or_file.endswith(".pdmodel"):
            self._prefix = model_dir_or_file[: -len(".pdmodel")]
        else:
            self._prefix = model_dir_or_file
        self._params_file = params_file
        self._device = "cuda"
        self._device_id = 0
        self._memory_optim = True
        self._ir_optim = True
        self._glog_info = False
        self._cpu_math_threads = 1

    # -- model location ---------------------------------------------------
    def set_model(self, model_dir_or_file, params_file=None):
        if model_dir_or_file.endswith(".pdmodel"):
            model_dir_or_file = model_dir_or_file[: -len(".pdmodel")]
        self._prefix = model_dir_or_file
        self._params_file = params_file

    def model_dir(self):
        return self._prefix

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or ((self._prefix or "") + ".pdiparams")

    # -- device -----------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = "cuda"
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def enable_tpu(self, device_id=0):
        """The port has no TPU: this selects the card ``cuda:<device_id>``,
        as ``enable_use_gpu`` does (the reference maps its GPU request onto
        the TPU the same way)."""
        self.enable_use_gpu(device_id=device_id)

    def use_gpu(self):
        return self._device == "cuda"

    def device(self) -> torch.device:
        """The device a Predictor of this config runs on."""
        if self._device == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self._device_id)

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = int(n)

    # -- optimization toggles (recorded for parity) ------------------------
    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def enable_memory_optim(self, flag=True):
        self._memory_optim = bool(flag)

    def switch_use_feed_fetch_ops(self, flag=False):
        pass

    def switch_specify_input_names(self, flag=True):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        pass  # no TensorRT in the port: the program runs as exported

    def enable_mkldnn(self):
        pass

    def disable_glog_info(self):
        self._glog_info = False

    def summary(self):
        return (f"Config(model={self.prog_file()}, "
                f"params={self.params_file()}, device={self.device()})")


class PredictorTensor:
    """Named I/O handle (reference paddle_tensor.h ZeroCopyTensor)."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool,
                 index: int):
        self.name = name
        self._owner = owner
        self._is_input = is_input
        self._index = index

    def reshape(self, shape):
        # the shape comes from the data (copy_from_cpu); accepted for parity
        self._shape_hint = tuple(shape)

    def _set(self, t):
        if not self._is_input:
            raise RuntimeError(f"'{self.name}' is an output handle")
        with self._owner._lock:
            self._owner._inputs[self._index] = t

    def copy_from_cpu(self, data: np.ndarray):
        if not self._is_input:
            raise RuntimeError(f"'{self.name}' is an output handle")
        self._set(_from_host(data, self._owner.device))

    def share_external_data(self, data):
        """A tensor on the predictor's device is used as it is (no copy,
        reference ZeroCopyTensor::ShareExternalData); anything else is
        copied there."""
        if isinstance(data, torch.Tensor) and data.device == \
                self._owner.device:
            self._set(data)
        elif isinstance(data, torch.Tensor):
            self._set(data.to(self._owner.device))
        else:
            self.copy_from_cpu(np.asarray(data))

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise RuntimeError(f"'{self.name}' is an input handle")
        outs = self._owner._outputs
        if outs is None:
            raise RuntimeError("run() has not been called")
        return _host(outs[self._index])

    def shape(self):
        if self._is_input:
            a = self._owner._inputs[self._index]
            return list(a.shape) if a is not None else \
                list(self._owner._input_specs[self._index][0])
        outs = self._owner._outputs
        return list(outs[self._index].shape) if outs is not None else []

    def type(self):
        if self._is_input:
            return str(self._owner._input_specs[self._index][1])
        outs = self._owner._outputs
        return dtypes.dtype_name(outs[self._index].dtype) \
            if outs is not None else "float32"


def _from_host(data, device) -> torch.Tensor:
    """An array as a tensor on ``device`` (on the CPU it shares the array's
    memory, as the reference's ``np.ascontiguousarray`` slot does)."""
    arr = np.ascontiguousarray(data)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Predictor:
    """AnalysisPredictor equivalent: the loaded program, named handles,
    ``clone``.

    The loaded module and weights are shared by reference across clones;
    each clone has its own input/output slots, so per-thread use is
    race-free, the contract of AnalysisPredictor::Clone
    (analysis_predictor.cc). A SINGLE predictor shared by concurrent
    callers is also safe for the list API (``run(inputs)`` stages, executes
    and returns under one ``_lock`` hold); the named-handle protocol
    (``copy_from_cpu`` → ``run()`` → ``copy_to_cpu``) spans several calls,
    so interleaved threads can overwrite each other's slots: use
    ``clone()`` per thread (or the list API) for concurrency.
    """

    def __init__(self, config: Config, _shared=None):
        self._config = config
        if _shared is not None:
            (self._call, self._weights, self.device, self._input_specs,
             self._input_names, self._output_names) = _shared
        else:
            self._load(config)
        self._lock = threading.Lock()
        self._inputs: List[Optional[torch.Tensor]] = \
            [None] * len(self._input_names)  # guarded_by: _lock
        self._outputs = None  # guarded_by: _lock

    def _load(self, config: Config):
        from ..jit import load_artifact

        prefix = config._prefix
        if prefix is None or not os.path.exists(prefix + ".pdmodel"):
            raise ValueError(f"model file not found: {prefix}.pdmodel")
        ep, weights, _, specs, device = load_artifact(prefix,
                                                      config.device())
        self.device = device
        self._call = ep.module()
        self._weights = weights
        self._input_specs = [(tuple(s[0]), s[1]) for s in specs]
        self._input_names = [
            (s[2] if len(s) > 2 and s[2] else f"input_{i}")
            for i, s in enumerate(specs)]
        self._output_names = [f"output_{i}" for i in range(
            len(ep.graph_signature.user_outputs))]

    # -- handle API --------------------------------------------------------
    def get_input_names(self):
        return list(self._input_names)

    def get_output_names(self):
        return list(self._output_names)

    def get_input_handle(self, name):
        return PredictorTensor(name, self, True,
                               self._input_names.index(name))

    def get_input_tensor(self, name):
        return self.get_input_handle(name)

    def get_output_handle(self, name):
        return PredictorTensor(name, self, False,
                               self._output_names.index(name))

    def get_output_tensor(self, name):
        return self.get_output_handle(name)

    # -- execution ---------------------------------------------------------
    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Run the program. With ``inputs`` (numpy arrays or tensors),
        returns the outputs as numpy arrays (the list API, reference
        predictor.run(inputs)); otherwise uses the handles' slots and
        returns True."""
        with self._lock:
            if inputs is not None:
                if len(inputs) != len(self._input_names):
                    raise ValueError(
                        f"predictor expects {len(self._input_names)} inputs "
                        f"{self._input_names}, got {len(inputs)}")
                for i, a in enumerate(inputs):
                    self._inputs[i] = a.to(self.device) \
                        if isinstance(a, torch.Tensor) else \
                        _from_host(a, self.device)
            missing = [n for n, a in zip(self._input_names, self._inputs)
                       if a is None]
            if missing:
                raise RuntimeError(f"inputs not set: {missing}")
            with torch.inference_mode():
                outs = self._call(self._weights, list(self._inputs))
            # kept on the device; copy_to_cpu does the device-to-host copy
            self._outputs = pytree.tree_leaves(outs)
            if inputs is not None:
                return [_host(o) for o in self._outputs]
        return True

    def output_tensors(self):
        """The last run's outputs as tensors on the device (no copy)."""
        with self._lock:
            return list(self._outputs or [])

    def clone(self):
        shared = (self._call, self._weights, self.device, self._input_specs,
                  self._input_names, self._output_names)
        return Predictor(self._config, _shared=shared)

    def clear_intermediate_tensor(self):
        with self._lock:
            self._outputs = None

    def try_shrink_memory(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def create_serving_engine(model, **kw):
    """Autoregressive serving front door (continuous batching, paged KV
    cache): :class:`paddle_tpu_torch.serving.Engine`, imported lazily so the
    deployment namespace stays cheap for Predictor-only use."""
    from ..serving import Engine

    return Engine(model, **kw)


# Legacy aliases (reference paddle.inference exports)
AnalysisConfig = Config
create_paddle_predictor = create_predictor


def get_version():
    from .. import __version__

    return __version__


__all__ = ["Config", "PredictorTensor", "Predictor", "create_predictor",
           "create_serving_engine", "AnalysisConfig",
           "create_paddle_predictor", "get_version"]

"""paddle.static (port of ``paddle_tpu/static/__init__.py``).

Parity: reference ``python/paddle/static/__init__.py``, the curated
static-graph API. As in the reference, a "program" is a traced callable:
``save_inference_model`` is ``jit.save`` of the model over the feeds'
``InputSpec``s, ``Executor.run`` calls the program on the feed, and
``Program`` (``program.py``) is the traced graph with the reference's
transforms. ``static.nn`` is ``ops/control_flow.py`` (``cond``,
``while_loop``, ``case``, ``switch_case``).
"""
from __future__ import annotations

import sys as _sys

import numpy as np
import torch

from .input import InputSpec  # noqa: F401
from .. import jit as _jit
from ..core.place import resolve_device


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Serialize an inference program and its parameters (reference
    static/io.py ``save_inference_model``; ``load_inference_model`` and
    ``inference.Predictor`` load it). ``feed_vars`` are InputSpecs
    (``static.data`` returns these) or example tensors; ``fetch_vars`` is
    the model, a layer or callable mapping the feeds to outputs."""
    fn = program if callable(program) else fetch_vars
    if not callable(fn):
        raise TypeError(
            "save_inference_model: pass the model (Layer or callable) as "
            "fetch_vars (or program=); static Programs are traced here")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in (feed_vars if isinstance(feed_vars, (list, tuple))
                       else [feed_vars])]
    _jit.save(fn, path_prefix, input_spec=specs, **kwargs)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """The saved program as a ``jit.TranslatedLayer`` (``device=`` as
    ``jit.load``)."""
    return _jit.load(path_prefix, **kwargs)


class Executor:
    """Runs a program on a feed (reference Executor.run executor.py:1093)
    on ``place`` (default the card)."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        if not callable(program) and not isinstance(program, Program):
            raise NotImplementedError("pass a traced callable or a "
                                      "static.Program as `program`")
        device = resolve_device(self.place)
        args = [torch.as_tensor(np.asarray(v), device=device)
                for v in (feed or {}).values()]
        out = program.run(*args) if isinstance(program, Program) \
            else program(*args)
        return [o.detach().cpu().numpy()
                for o in (out if isinstance(out, (list, tuple)) else [out])]


def default_main_program():
    return None


def default_startup_program():
    return None


class program_guard:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def data(name, shape, dtype="float32", lod_level=0):
    return InputSpec(shape, dtype, name)


# gradient clip re-exports for parity
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: E402,F401
                       ClipGradByValue)
from .program import (Block, OpDesc, Program, TrainableProgram,  # noqa: E402
                      VarDesc)


def load_program(path_prefix, device=None):
    """A saved artifact as a ``TrainableProgram`` on ``device`` (default the
    card): the reference's load_inference_model → append_backward
    workflow."""
    return TrainableProgram.load(path_prefix, device)


def append_backward(loss=None, program=None, loss_index=0, **kwargs):
    """Reference ``paddle.static.append_backward`` (backward.py:1413) over a
    capture-level Program: a new Program computing (loss, *grads)."""
    prog = program if program is not None else loss
    if not isinstance(prog, Program):
        raise TypeError("append_backward needs a static.Program")
    return prog.append_backward(loss_index)


def gradients(targets=None, inputs=None, program=None, target_index=0,
              **kwargs):
    """Reference ``paddle.static.gradients`` (backward.py:2010): gradients
    of an output with respect to feeds, as a re-traced Program."""
    prog = program if program is not None else targets
    if not isinstance(prog, Program):
        raise TypeError("gradients needs a static.Program")
    return prog.gradients(target_index, inputs)


# control-flow ops under static.nn (reference paddle.static.nn.cond/while_loop)
from ..ops import control_flow as nn  # noqa: E402

# so `import paddle_tpu_torch.static.nn` works (the reference's idiom)
_sys.modules[__name__ + ".nn"] = nn

__all__ = ["InputSpec", "save_inference_model", "load_inference_model",
           "Executor", "default_main_program", "default_startup_program",
           "program_guard", "data", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Program", "Block", "OpDesc", "VarDesc",
           "TrainableProgram", "load_program", "append_backward",
           "gradients", "nn"]

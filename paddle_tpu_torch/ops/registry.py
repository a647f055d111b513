"""Op registry (port of ``paddle_tpu/ops/registry.py``): ``all_ops()``
names every forward op endpoint of the port.

The reference tries its ``nn.functional`` submodules, ``vision.ops``,
``text`` and ``incubate`` under ``except ImportError``. The port names
exactly the modules it has, so a broken import raises; ``MISSING_MODULES``
lists the reference's registry modules the port has not ported yet, whose
names ``all_ops()`` therefore lacks.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict

# the reference registry's modules not in the port yet (its queue A)
MISSING_MODULES = ("text",)


def _module_fns(mod, prefix=""):
    out = {}
    for n in dir(mod):
        if n.startswith("_"):
            continue
        fn = getattr(mod, n)
        if callable(fn) and not inspect.isclass(fn) \
                and inspect.getmodule(fn) in (mod, None):
            out[prefix + n] = fn
    return out


def all_ops() -> Dict[str, Callable]:
    """name -> callable for every registered op endpoint."""
    from . import (control_flow, creation, extra, generated, inplace, linalg,
                   manipulation, math, metrics_ops, misc, sequence)
    from .. import fft as fft_mod
    from .. import signal as signal_mod
    from .. import sparse as sparse_mod
    from ..nn import functional as F
    from ..nn.functional import (activation, attention, common, conv, loss,
                                 norm, pooling, vision)
    from ..vision import ops as vops

    ops: Dict[str, Callable] = {}
    for mod in (math, manipulation, creation, linalg):
        ops.update(_module_fns(mod))
    ops.update(generated.GENERATED)
    for mod in (extra, control_flow, misc):
        ops.update({n: getattr(mod, n) for n in mod.__all__})
    ops.update({f"fft.{n}": getattr(fft_mod, n) for n in fft_mod.__all__})
    ops.update({f"signal.{n}": getattr(signal_mod, n)
                for n in signal_mod.__all__})
    for mod in (F, activation, common, conv, loss, norm, pooling, attention,
                vision):
        ops.update(_module_fns(mod, "functional."))
    ops.update({f"vision.{n}": f for n, f in _module_fns(vops).items()})
    ops.update({f"sparse.{n}": getattr(sparse_mod, n)
                for n in sparse_mod.__all__
                if callable(getattr(sparse_mod, n))})
    ops.update({f"sequence.{n}": getattr(sequence, n)
                for n in sequence.__all__})
    ops.update({f"metric.{n}": getattr(metrics_ops, n)
                for n in metrics_ops.__all__})
    from .. import quantization as quant_mod
    from ..incubate import operators as incubate_ops

    ops.update({f"quant.{n}": getattr(quant_mod, n)
                for n in ("fake_quantize_dequantize_abs_max",
                          "quantize_to_int8")})
    ops.update({f"incubate.{n}": getattr(incubate_ops, n)
                for n in ("softmax_mask_fuse",
                          "softmax_mask_fuse_upper_triangle",
                          "graph_send_recv", "graph_khop_sampler")})
    ops.update(inplace.INPLACE_OPS)
    return ops


def op_count() -> int:
    return len(all_ops())


__all__ = ["all_ops", "op_count", "MISSING_MODULES"]

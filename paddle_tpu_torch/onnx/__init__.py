"""paddle.onnx — portable-interchange export (port of
``paddle_tpu/onnx/__init__.py``).

Parity target: reference ``python/paddle/onnx/export.py``, which delegates
to the external paddle2onnx converter; the capability is "one artifact,
loadable by other runtimes and hosts". This build's portable artifact is
the one ``paddle.jit.save`` writes: a ``torch.export`` program in
``{path}.pdmodel`` with the named weights in ``{path}.pdiparams``, which
``paddle.jit.load`` and ``inference.Predictor`` run on the card or on a
CPU-only host. The reference's default format name, ``"stablehlo"``, is
kept as this build's name for that artifact.

Writing an ``.onnx`` protobuf needs the onnx/onnxscript packages, which
this environment does not have; ``format="onnx"`` raises instead of
writing a file that is not ONNX.
"""
from __future__ import annotations

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, format="stablehlo",
           **configs):
    """Write a portable inference artifact for ``layer``.

    ``format="stablehlo"`` (default): the ``torch.export`` program and the
    weights at ``{path}`` (an ``.onnx`` suffix is dropped), as
    ``jit.save`` writes them; returns the artifact's prefix.
    ``format="onnx"``: not available in this build; raises.
    """
    if format == "onnx":
        raise NotImplementedError(
            "ONNX protobuf emission is not available in this build (no onnx "
            "or onnxscript package in the environment). The default "
            "format='stablehlo' writes the portable artifact this framework "
            "deploys with: a torch.export program that jit.load and the "
            "inference Predictor run on the card or the CPU.")
    if format != "stablehlo":
        raise ValueError(f"unknown export format: {format!r}")
    from .. import jit as _jit

    prefix = path[:-5] if path.endswith(".onnx") else path
    _jit.save(layer, prefix, input_spec=input_spec)
    return prefix

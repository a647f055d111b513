"""paddle.nn.utils (port of ``paddle_tpu/nn/utils/__init__.py``): weight
and spectral normalisation by forward pre-hooks, and the flat-vector views
of a parameter list.

``weight_norm`` replaces the parameter ``weight`` by ``weight_g`` (its norm
over every axis but ``dim``) and ``weight_v`` (its copy); a forward
pre-hook sets ``layer.weight = g * v / max(||v||, 1e-12)`` before each
call. ``spectral_norm`` renames it ``weight_orig``; its hook sets
``layer.weight`` to ``F.spectral_norm(weight_orig)`` (power iteration from
ones: the reference keeps no ``u``/``v`` state). ``remove_weight_norm``
writes the weight back as a plain parameter and drops the hook (the
reference leaves its hook in place, so its next call raises).
"""
from __future__ import annotations

import torch

from ...core.tensor import Parameter


def parameters_to_vector(parameters, name=None):
    """One flat tensor of every parameter, in order."""
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters`` in place."""
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset: offset + n].reshape(p.shape))
        offset += n


def _norm_except(w, dim):
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(w), dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as ``g * v / ||v||``."""
    w = getattr(layer, name)
    with torch.no_grad():
        g = Parameter(_norm_except(w, dim).clone())
        v = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)

    def hook(l, inputs):
        gv, vv = l._parameters[name + "_g"], l._parameters[name + "_v"]
        setattr(l, name, gv * vv / torch.clamp(_norm_except(vv, dim),
                                               min=1e-12))

    hooks = layer.__dict__.setdefault("_weight_norm_hooks", {})
    hooks[name] = layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Back to one parameter ``layer.<name>`` (g * v / ||v|| over every
    axis but 0, as the reference computes it)."""
    g = layer._parameters.pop(name + "_g", None)
    v = layer._parameters.pop(name + "_v", None)
    if g is not None and v is not None:
        helper = layer.__dict__.get("_weight_norm_hooks", {}).pop(name, None)
        if helper is not None:
            helper.remove()
        with torch.no_grad():
            w = Parameter(g * v / _norm_except(v, 0))
        layer.__dict__.pop(name, None)
        layer.add_parameter(name, w)
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its spectral norm before each call."""
    from .. import functional as F

    dim = 0 if dim is None else dim

    def hook(l, inputs):
        w = l._parameters.get(name + "_orig", l._parameters.get(name))
        setattr(l, name, F.spectral_norm(w, dim, n_power_iterations, eps))

    if name in layer._parameters:
        layer.add_parameter(name + "_orig", layer._parameters.pop(name))
    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]

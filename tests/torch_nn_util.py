"""Helpers of the ``nn`` parity tests (tests/test_torch_nn_*.py): one call
of a reference function and of its port on the same numpy inputs, outputs
held to each other and the gradients of a weighted sum of the floating
outputs held to the reference's tape; layers built in both packages with
the reference's state (parameters and buffers) carried across."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.models import load_reference_state_dict
from torch_port_util import as_numpy, assert_same


class A:
    """A numpy argument each package turns into its own tensor; a floating
    one is a gradient leaf unless ``grad=False``."""

    def __init__(self, a, grad=None):
        self.a = np.asarray(a)
        self.grad = self.a.dtype.kind == "f" if grad is None else grad


def _convert(v, leaves, ref):
    if isinstance(v, A):
        if ref:
            t = paddle.to_tensor(v.a, stop_gradient=not v.grad)
        else:
            t = torch.tensor(v.a, requires_grad=v.grad)
        if v.grad:
            leaves.append(t)
        return t
    if isinstance(v, (list, tuple)):
        return type(v)(_convert(x, leaves, ref) for x in v)
    if isinstance(v, dict):
        return {k: _convert(x, leaves, ref) for k, x in v.items()}
    return v


def flat(out):
    """An output's tensors (and Nones) in order, nested tuples and lists
    flattened."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat(o)]
    return [out]


def _weights(outs, seed=5):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*as_numpy(o)[0].shape), np.float32)
            if o is not None and as_numpy(o)[0].dtype.kind == "f" else None
            for o in outs]


def _weighted(outs, ws, ref):
    total = None
    for o, w in zip(outs, ws):
        if w is None:
            continue
        if ref:
            term = (o.astype("float32") * paddle.to_tensor(w)).sum()
        else:
            term = (o.float() * torch.from_numpy(w)).sum()
        total = term if total is None else total + term
    return total


def check(jfn, tfn, args=(), kwargs=None, rtol=1e-5, atol=1e-6, grad=True,
          grad_rtol=None, what=""):
    """``tfn`` against ``jfn`` on the same inputs: outputs (dtype by name,
    shape, values), then, with ``grad``, every leaf's gradient of
    ``sum(w_i * out_i)`` over the floating outputs (``w_i`` fixed random)."""
    kwargs = kwargs or {}
    jl, tl = [], []
    jout = jfn(*_convert(args, jl, True), **_convert(kwargs, jl, True))
    tout = tfn(*_convert(args, tl, False), **_convert(kwargs, tl, False))
    jo, to = flat(jout), flat(tout)
    assert len(jo) == len(to), (what, len(jo), len(to))
    for i, (j, t) in enumerate(zip(jo, to)):
        if j is None:
            assert t is None, (what, i)
            continue
        assert_same(t, j, rtol, atol, f"{what} output {i}")
    if not (grad and tl):
        return tout
    ws = _weights(jo)
    jy, ty = _weighted(jo, ws, True), _weighted(to, ws, False)
    if jy is None:
        return tout
    jy.backward()
    ty.backward()
    for i, (j, t) in enumerate(zip(jl, tl)):
        jg = j.grad
        tg = t.grad
        want = np.zeros(j.shape, np.float32) if jg is None else as_numpy(jg)[0]
        got = np.zeros(tuple(t.shape), np.float32) if tg is None \
            else tg.numpy()
        np.testing.assert_allclose(got, want, rtol=grad_rtol or rtol,
                                   atol=atol * 10,
                                   err_msg=f"{what} gradient {i}")
    return tout


def function_of(case, module):
    """The public function of ``module`` a case runs: the longest name that
    is the case or that the case starts with, then ``_`` (``prelu_nhwc``
    runs ``prelu``)."""
    for name in sorted((n for n in dir(module) if not n.startswith("_")),
                       key=len, reverse=True):
        if case == name or case.startswith(name + "_"):
            return name
    raise KeyError(case)


def reference_state(jlayer):
    """The reference layer's ``state_dict()`` (parameters and persistable
    buffers) as numpy."""
    return {k: np.array(v.numpy()) for k, v in jlayer.state_dict().items()}


def carry(jlayer, tlayer):
    """``tlayer`` with ``jlayer``'s state loaded by name."""
    load_reference_state_dict(tlayer, reference_state(jlayer))
    return tlayer


def layer_grads(jlayer, tlayer, rtol=1e-5, atol=1e-5, what=""):
    """Each parameter's gradient, by name, port against reference."""
    jp = dict(jlayer.named_parameters())
    for name, p in tlayer.named_parameters():
        jg = jp[name].grad
        want = np.zeros(tuple(p.shape), np.float32) if jg is None \
            else as_numpy(jg)[0]
        got = np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def check_layer(jlayer, tlayer, args, rtol=1e-5, atol=1e-6, grad=True,
                what=""):
    """Two layers with the reference's weights: outputs and the input and
    parameter gradients of a weighted sum of the outputs."""
    carry(jlayer, tlayer)
    out = check(jlayer, tlayer, args, rtol=rtol, atol=atol, grad=grad,
                what=what)
    if grad:
        layer_grads(jlayer, tlayer, rtol=rtol, atol=max(atol, 1e-5),
                    what=what)
    return out


def grad_rel(jlayer, tlayer):
    """``{name: |g - g_ref| / |g_ref|}`` over the parameters, by name (a
    deep network's gradients are held by relative norm: elementwise, its
    small entries carry the summation order's noise)."""
    jp = dict(jlayer.named_parameters())
    out = {}
    for name, p in tlayer.named_parameters():
        want = as_numpy(jp[name].grad)[0].astype(np.float64)
        got = p.grad.detach().cpu().numpy().astype(np.float64)
        out[name] = float(np.linalg.norm(got - want)
                          / max(np.linalg.norm(want), 1e-30))
    return out

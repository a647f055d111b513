"""Quantization (port of ``paddle_tpu/quantization/__init__.py``): QAT with
fake quantization and the straight-through estimator, post-training
quantization, and the int8 serving layers with their conversion.

- the STE is a ``torch.autograd.Function``: the forward quantizes to the
  int8 grid and back, ``clip(round(x / scale * 127), -127, 127) * scale /
  127`` in the input's dtype (``torch.round`` rounds half to even, as
  ``jnp.round``), the backward passes ``g * (|x| <= scale)`` and nothing to
  the scale. The reference's compiled ``/ 127`` is XLA's multiply by the
  constant's reciprocal, and so is the port's; its other divisions are
  true divisions by a tensor on the input's device (a CUDA division by a
  Python scalar multiplies by its reciprocal, which can land one ulp
  away);
- ``QuantedLayer`` calls its inner layer through
  ``torch.func.functional_call`` with the fake-quantized weight, so the
  backward takes the input gradient against the weight the forward used and
  the weight's gradient reaches the parameter through the STE (the
  reference swaps the parameter's data for the call, which PyTorch's
  autograd would not see);
- ``FakeQuantMovingAverageAbsMax`` keeps its moving average in a float64
  buffer, as the reference's (its package enables x64), so ``state_dict``s
  carry across, and casts it to the activation's dtype at use. Inside a
  ``jit.compile_train_step`` call (the reference's traced step) it
  quantizes with the batch's abs-max and leaves the average alone, as the
  reference's traced branch does;
- ``Int8Linear``/``Int8Conv2D`` quantize the input with its calibrated
  scale, take an exact int32 product with the int8 weight
  (``torch._int_mm``, cuBLASLt's int8 GEMM on the card; the convolution as
  an im2col of the int8 input, one product a group) and rescale once in
  float32. The reference computes this product in XLA, outside any Pallas
  kernel. The card's ``_int_mm`` takes inner and outer sizes that are
  multiples of 8 and row counts that are multiples of 32 (cuBLASLt refuses
  others at some shapes): the operands are padded with zeros, which is
  exact, on every device, so an artifact saved on the CPU runs on the
  card. Nothing falls back to a float product.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.place import resolve_device
from ..nn.layer.layers import Layer

__all__ = [
    "fake_quantize_dequantize_abs_max", "quantize_to_int8",
    "FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax", "QuantedLayer",
    "ImperativeQuantAware", "PostTrainingQuantization",
    "Int8Linear", "Int8Conv2D", "convert_to_int8_inference",
]


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device (a fill,
    no host copy)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# -- fake quant primitives ---------------------------------------------------

class _FakeQuantSTE(torch.autograd.Function):
    """Quantize-dequantize to the int8 grid; the gradient passes straight
    through inside the clip range and is 0 outside (the reference's
    fake_quantize op gradient)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return _fq(x, scale)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return g * (x.abs() <= scale).to(g.dtype), None


def _fq(x, scale):
    q = torch.clamp(torch.round(x / scale * 127.0), -127.0, 127.0)
    # the reference's compiled ``/ 127.0`` is XLA's multiply by the
    # constant's reciprocal, rounded to the dtype
    return q * scale * _const(q, 1.0 / 127.0)


def _absmax(x) -> torch.Tensor:
    return x.detach().abs().amax().clamp_min(1e-8)


def fake_quantize_dequantize_abs_max(x, bit_length=8, name=None):
    """One-shot abs-max fake quant (reference fake_quantize_dequantize
    ops)."""
    return _FakeQuantSTE.apply(x, _absmax(x))


def quantize_to_int8(x):
    """Real int8 quantization: returns (int8 values, the scale as a float)."""
    arr = x.detach()
    scale = float(_absmax(arr))
    q = torch.clamp(torch.round(arr / _const(arr, scale) * 127.0), -127, 127)
    return q.to(torch.int8), scale


# -- QAT layer wrappers ------------------------------------------------------

class FakeQuantAbsMax(Layer):
    """Weight quantizer: per-tensor abs-max, recomputed each step."""

    def forward(self, x):
        return _FakeQuantSTE.apply(x, _absmax(x))


class FakeQuantMovingAverageAbsMax(Layer):
    """Activation quantizer with a moving-average scale (reference
    MovingAverageAbsMaxScale op; rate 0.9 by default)."""

    def __init__(self, rate=0.9, device=None):
        super().__init__()
        self._rate = rate
        self.register_buffer("scale", torch.ones(
            (), dtype=torch.float64, device=resolve_device(device)))
        self._initialized = False

    def forward(self, x):
        from ..jit import in_compiled_step

        if self.training and in_compiled_step():
            # the reference's traced step cannot update the buffer from the
            # host: it quantizes with the batch's abs-max instead, and the
            # average advances on eager steps only
            return _FakeQuantSTE.apply(x, _absmax(x).to(x.dtype))
        if self.training:
            cur = float(x.detach().abs().amax())
            prev = float(self.scale)
            new = cur if not self._initialized \
                else self._rate * prev + (1 - self._rate) * cur
            self._initialized = True
            self.scale.fill_(new)
        return _FakeQuantSTE.apply(
            x, self.scale.clamp_min(1e-8).to(x.dtype))


class QuantedLayer(Layer):
    """Wraps a Linear/Conv2D: fake-quant weight and input, then the inner
    layer's own forward with the quantized weight (reference
    imperative/qat.py QuantizedLinear/QuantizedConv2D)."""

    def __init__(self, inner, weight_quantizer=None, act_quantizer=None):
        super().__init__()
        self.inner = inner
        self.weight_quantizer = weight_quantizer or FakeQuantAbsMax()
        self.act_quantizer = act_quantizer or FakeQuantMovingAverageAbsMax(
            device=inner.weight.device)

    def forward(self, x):
        xq = self.act_quantizer(x)
        wq = self.weight_quantizer(self.inner.weight)
        return torch.func.functional_call(self.inner, {"weight": wq}, (xq,))


class ImperativeQuantAware:
    """The QAT entry point (reference imperative/qat.py:41)."""

    QUANTIZABLE = ("Linear", "Conv2D", "Conv1D")

    def __init__(self, quantizable_layer_type=None,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 weight_bits=8, activation_bits=8, moving_rate=0.9, **kw):
        self.types = tuple(quantizable_layer_type or self.QUANTIZABLE)
        self.moving_rate = moving_rate

    def quantize(self, model: Layer):
        """Swap quantizable sublayers for ``QuantedLayer`` wrappers, in
        place, by ``setattr`` on the parent."""
        for name, child in list(model._modules.items()):
            if child is None:
                continue
            if type(child).__name__ in self.types and hasattr(child, "weight"):
                setattr(model, name, QuantedLayer(
                    child, FakeQuantAbsMax(),
                    FakeQuantMovingAverageAbsMax(
                        self.moving_rate, device=child.weight.device)))
            else:
                self.quantize(child)
        return model


class PostTrainingQuantization:
    """PTQ (reference post_training_quantization.py:125): calibrate the
    activation scales over sample batches, quantize the weights to int8 and
    a scale."""

    def __init__(self, model: Layer, data_loader=None, algo="abs_max",
                 quantizable_layer_type=None, batch_nums=10, **kw):
        self.model = model
        self.data_loader = data_loader
        self.algo = algo
        self.types = tuple(quantizable_layer_type
                           or ImperativeQuantAware.QUANTIZABLE)
        self.batch_nums = batch_nums
        self.act_scales = {}
        self.in_scales = {}
        self.weight_scales = {}

    def _collect(self, layer_name):
        def hook(layer, inputs, output):
            cur = float(output.detach().abs().amax())
            if self.algo == "avg":
                prev = self.act_scales.get(layer_name)
                self.act_scales[layer_name] = cur if prev is None \
                    else 0.5 * (prev + cur)
            else:  # abs_max
                self.act_scales[layer_name] = max(
                    self.act_scales.get(layer_name, 0.0), cur)
            # the input's scale too: the int8 serving layers quantize the
            # activation entering the layer
            x0 = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
            cin = float(x0.detach().abs().amax())
            self.in_scales[layer_name] = max(
                self.in_scales.get(layer_name, 0.0), cin)
        return hook

    def _quantizable(self):
        return [(name, sub) for name, sub in self.model.named_sublayers()
                if type(sub).__name__ in self.types and hasattr(sub, "weight")]

    def quantize(self):
        """Calibrate, then put the weights on their int8 grid in place;
        returns the model, with the scales in ``act_scales``,
        ``in_scales`` and ``weight_scales``."""
        handles = [sub.register_forward_post_hook(self._collect(name))
                   for name, sub in self._quantizable()]
        try:
            if self.data_loader is not None:
                self.model.eval()
                with torch.no_grad():
                    for i, batch in enumerate(self.data_loader):
                        if i >= self.batch_nums:
                            break
                        x = batch[0] if isinstance(batch, (list, tuple)) \
                            else batch
                        self.model(x)
        finally:
            for h in handles:
                h.remove()
        with torch.no_grad():
            for name, sub in self._quantizable():
                q, scale = quantize_to_int8(sub.weight)
                self.weight_scales[name] = scale
                deq = q.to(torch.float32) * scale
                deq = deq / _const(deq, 127.0)
                sub.weight.copy_(deq.to(sub.weight.dtype))
        return self.model


# -- int8 serving path -------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``a`` (M, K) and ``w`` (K, N). On the
    card ``_int_mm`` takes K and N multiples of 8 and M > 16, and
    cuBLASLt refuses some shapes whose M is no multiple of 32 (an H100,
    CUDA 12.8: (K, N) = (64, 64) at every such M from 17 on): the operands
    are padded with zero rows and columns (exact) to K, N multiples of 8
    and M a multiple of 32, and the result cut back. The padding is taken
    on every device, so a program exported on the CPU runs on the card.
    Under ``torch.export`` M is symbolic and the padding with it."""
    M, K = a.shape
    N = w.shape[1]
    kp, np_ = max(_round_up(K, 8), 16), max(_round_up(N, 8), 8)
    mp = (-M) % 32  # a SymInt under export
    pad_m = isinstance(mp, torch.SymInt) or mp > 0
    if kp != K or pad_m:
        a = TF.pad(a, (0, kp - K, 0, mp))
    if kp != K or np_ != N:
        w = TF.pad(w, (0, np_ - N, 0, kp - K))
    out = torch._int_mm(a.contiguous(), w.contiguous())
    if pad_m or np_ != N:
        out = out[:M, :N]
    return out


def _quantize_input(a, sx: float) -> torch.Tensor:
    """int8(clip(round(a / sx))): the reference's compiled division by the
    constant ``sx`` is XLA's multiply by its float32 reciprocal."""
    inv = float(np.float32(1.0) / np.float32(sx))
    q = torch.clamp(torch.round(a * _const(a, inv)), -127, 127)
    return q.to(torch.int8)


class Int8Linear(Layer):
    """Serving-time int8 linear: x and W quantize to int8, the product
    accumulates in int32, one float32 rescale at the end (the role of the
    reference's int8 pass pipeline feeding AnalysisPredictor). ``jit.save``
    keeps the weight int8 in the artifact."""

    def __init__(self, weight_q, bias, in_scale: float, w_scale: float):
        super().__init__()
        self.register_buffer("weight_q", torch.as_tensor(weight_q))
        self.bias = bias
        self._sx = float(in_scale) / 127.0
        self._sw = float(w_scale) / 127.0

    def forward(self, x):
        aq = _quantize_input(x.detach(), self._sx)
        lead = aq.shape[:-1]
        acc = _int8_mm(aq.reshape(-1, aq.shape[-1]), self.weight_q)
        y = acc.to(torch.float32) * (self._sx * self._sw)
        if self.bias is not None:
            y = y + self.bias.detach()
        return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def _pair(v):
    return tuple(int(u) for u in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


def _conv_pads(padding, hw, k, stride, dilation):
    """((top, bottom), (left, right)) from the layer's padding: XLA's
    ``SAME`` (the odd pixel at the end) and ``VALID``, an int, a pair, or
    four values."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        if padding.upper() != "SAME":
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        out = []
        for n, kk, s, d in zip(hw, k, stride, dilation):
            total = max((-(-n // s) - 1) * s + (kk - 1) * d + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if isinstance(padding, (list, tuple)):
        p = [int(v) for v in np.asarray(padding).ravel()]
        if len(p) == 2:
            return ((p[0], p[0]), (p[1], p[1]))
        if len(p) == 4:
            return ((p[0], p[1]), (p[2], p[3]))
        raise ValueError(f"padding {padding!r}: 1, 2 or 4 values")
    return ((int(padding),) * 2,) * 2


class Int8Conv2D(Layer):
    """Serving-time int8 conv2d (NCHW or NHWC): int8 input and filter, an
    exact int32 product over the im2col of the int8 input (one product a
    group), one float32 rescale."""

    def __init__(self, weight_q, bias, in_scale: float, w_scale: float,
                 stride, padding, dilation, groups, data_format="NCHW"):
        super().__init__()
        self.register_buffer("weight_q", torch.as_tensor(weight_q))
        self.bias = bias
        self._sx = float(in_scale) / 127.0
        self._sw = float(w_scale) / 127.0
        self._cfg = (_pair(stride), padding, _pair(dilation), int(groups),
                     str(data_format))

    def forward(self, x):
        stride, padding, dilation, groups, data_format = self._cfg
        aq = _quantize_input(x.detach(), self._sx)
        if data_format == "NHWC":
            aq = aq.permute(0, 3, 1, 2)
        O, Cg, kh, kw = self.weight_q.shape
        (pt, pb), (pl, pr) = _conv_pads(padding, aq.shape[2:], (kh, kw),
                                        stride, dilation)
        if pt or pb or pl or pr:
            aq = TF.pad(aq, (pl, pr, pt, pb))
        (sh, sw), (dh, dw) = stride, dilation
        cols = aq.unfold(2, (kh - 1) * dh + 1, sh).unfold(
            3, (kw - 1) * dw + 1, sw)[..., ::dh, ::dw]
        N, C, OH, OW = cols.shape[:4]
        # (N, OH, OW, C, kh, kw): one row a output pixel
        cols = cols.permute(0, 2, 3, 1, 4, 5)
        og = O // groups
        accs = []
        for g in range(groups):
            a = cols[:, :, :, g * Cg:(g + 1) * Cg].reshape(
                N * OH * OW, Cg * kh * kw)
            w = self.weight_q[g * og:(g + 1) * og].reshape(og, -1).t()
            accs.append(_int8_mm(a, w))
        acc = accs[0] if groups == 1 else torch.cat(accs, 1)
        y = acc.to(torch.float32) * (self._sx * self._sw)
        if self.bias is not None:
            y = y + self.bias.detach()
        y = y.reshape(N, OH, OW, O)
        if data_format != "NHWC":
            y = y.permute(0, 3, 1, 2).contiguous()
        return y.to(x.dtype)


def _int8_weight(w):
    """The reference's host quantization of a float weight, in numpy:
    (int8 array, scale)."""
    w = w.detach().float().cpu().numpy()
    s_w = float(np.maximum(np.abs(w).max(), 1e-8))
    return np.clip(np.round(w / s_w * 127.0), -127, 127).astype(np.int8), s_w


def convert_to_int8_inference(model: Layer, ptq: "PostTrainingQuantization"):
    """Swap calibrated Linear/Conv2D sublayers for the int8 serving layers,
    in place. ``jit.save`` of the result writes an artifact whose weights
    are int8, which ``inference.create_predictor`` runs as it is."""

    def swap(parent, prefix=""):
        for name, child in list(parent._modules.items()):
            if child is None:
                continue
            full = f"{prefix}.{name}" if prefix else name
            tname = type(child).__name__
            scale_key = _match_scale(ptq, full)
            if tname == "Linear" and scale_key is not None:
                wq, s_w = _int8_weight(child.weight)
                setattr(parent, name, Int8Linear(
                    torch.from_numpy(wq).to(child.weight.device), child.bias,
                    ptq.in_scales[scale_key], s_w))
            elif tname == "Conv2D" and scale_key is not None:
                wq, s_w = _int8_weight(child.weight)
                pad = child._padding
                if isinstance(pad, str):
                    pad_t = pad
                elif isinstance(pad, (list, tuple)):
                    pad_t = tuple(pad)
                else:
                    pad_t = (int(pad),) * 2
                setattr(parent, name, Int8Conv2D(
                    torch.from_numpy(wq).to(child.weight.device), child.bias,
                    ptq.in_scales[scale_key], s_w, child._stride, pad_t,
                    child._dilation, child._groups,
                    getattr(child, "_data_format", "NCHW")))
            else:
                swap(child, full)
    swap(model)
    return model


def _match_scale(ptq, full_name):
    if full_name in ptq.in_scales:
        return full_name
    # named_sublayers prefixes may differ by a leading module name; only a
    # dot-boundary suffix is unambiguous ('fc1' must never bind 'myfc1')
    hits = [k for k in ptq.in_scales
            if k.endswith("." + full_name) or full_name.endswith("." + k)]
    if len(hits) == 1:
        return hits[0]
    if len(hits) > 1:
        warnings.warn(
            f"ambiguous calibration scales {sorted(hits)} for layer "
            f"'{full_name}'; leaving it unquantized")
    return None

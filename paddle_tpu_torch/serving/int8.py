"""Weight-only int8 serving path (port of ``paddle_tpu/serving/int8.py``).

Every float matrix of the decode weight tree (rank >= 2: projections,
embeddings, the tied head) is stored as int8 plus one f32 per-tensor scale,
with the reference's rounding (``quantization.quantize_to_int8``, copied
here): ``round(w / scale * 127)`` evaluated in the weight's own dtype, with
``scale = max(|w|.max(), 1e-8)``. 1-D params (biases, norm gains) stay float.

``dequantize_tree`` returns a read-only VIEW that dequantizes a leaf each
time the step reads it (``(q.float() * (scale / 127)).to(dtype)``), as the
reference's traced dequant does inside its compiled programs. A cached
dense copy would give back the int8 path's memory saving.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch

__all__ = ["quantize_params", "dequantize_tree", "attach_int8_head",
           "quantize_to_int8"]

_TAG = "__int8__"


def quantize_to_int8(w):
    """(int8 values, python float scale) — symmetric per-tensor abs-max.
    The divisor is a tensor of w's dtype on w's device, so the division is
    a true one in w's dtype on every device."""
    scale = float(torch.clamp(w.abs().max(), min=1e-8))
    div = torch.tensor(scale, dtype=w.dtype, device=w.device)
    q = torch.clamp(torch.round(w / div * 127.0), -127, 127).to(torch.int8)
    return q, scale


def quantize_params(tree):
    """Quantize every float tensor of rank >= 2 in a nested dict/list/tuple
    weight tree to ``{_TAG: int8, "scale": f32[]}``."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, torch.Tensor) and node.dim() >= 2 \
                and node.is_floating_point():
            q, scale = quantize_to_int8(node)
            return {_TAG: q, "scale": torch.tensor(scale, dtype=torch.float32,
                                                   device=node.device)}
        return node

    return walk(tree)


def _dequant(q, scale, dtype):
    """``(q.float() * (scale / 127)).to(dtype)`` in one pass: the product is
    taken in f32 (the inputs' common type) and rounded once into the
    ``dtype`` output, so no f32 copy of the weight is written."""
    s127 = scale / scale.new_tensor(127.0)  # true f32 division on any device
    return torch.mul(q, s127, out=torch.empty(q.shape, dtype=dtype,
                                              device=q.device))


def _view(node, dtype):
    if isinstance(node, dict):
        if _TAG in node:
            return _dequant(node[_TAG], node["scale"], dtype)
        return _Dequantized(node, dtype)
    if isinstance(node, (list, tuple)):
        return _DequantizedSeq(node, dtype)
    return node


class _Dequantized(Mapping):
    """Read-only mapping over a quantized tree: tagged leaves are
    dequantized to ``dtype`` on every read; nested dicts/lists stay views."""

    def __init__(self, tree: dict, dtype: torch.dtype):
        self._tree = tree
        self._dtype = dtype

    def __getitem__(self, key):
        return _view(self._tree[key], self._dtype)

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)

    def take(self, key, idx):
        """``self[key][idx]`` dequantizing only the gathered rows (the
        dequant is elementwise, so the values are the same)."""
        leaf = self._tree[key]
        if isinstance(leaf, dict) and _TAG in leaf:
            return _dequant(leaf[_TAG][idx], leaf["scale"], self._dtype)
        return self[key][idx]


class _DequantizedSeq(Sequence):
    def __init__(self, seq, dtype: torch.dtype):
        self._seq = seq
        self._dtype = dtype

    def __getitem__(self, i):
        return _view(self._seq[i], self._dtype)

    def __len__(self):
        return len(self._seq)


def dequantize_tree(tree, dtype):
    """Inverse of :func:`quantize_params` as a lazy view (see module doc)."""
    return _view(tree, dtype)


def attach_int8_head(dense, tagged):
    """Graft the still-quantized LM-head weight onto a dequantized tree as
    ``head_q = {"q": int8, "scale": f32[]}`` so the head runs the
    weight-only ``int8_matmul`` kernel on the int8 bytes. The dense entry
    stays (GPT's ``wte`` is also the embedding table). A tree whose head was
    never quantized passes through unchanged."""
    key = "head_w" if "head_w" in tagged else "wte"
    leaf = tagged.get(key)
    if not (isinstance(leaf, dict) and _TAG in leaf):
        return dense
    head_q = {"q": leaf[_TAG], "scale": leaf["scale"]}
    if isinstance(dense, _Dequantized):
        return _Dequantized({**dense._tree, "head_q": head_q}, dense._dtype)
    return {**dense, "head_q": head_q}

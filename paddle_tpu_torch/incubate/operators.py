"""``paddle.incubate.operators`` (port of
``paddle_tpu/incubate/operators.py``).

- ``softmax_mask_fuse`` / ``softmax_mask_fuse_upper_triangle``: the fused
  CUDA kernels' role is the op table's (``ops/ops.json``) generated ops;
- ``graph_send_recv``: message passing as a gather and a segment
  reduction (sum, mean, max, min), untouched destinations 0;
- ``graph_khop_sampler``: neighbourhood sampling on the host (dynamic
  shapes), like the reference's CPU kernel. Its numpy generator is seeded
  from the port's CPU generator (``paddle_tpu_torch.seed``); the
  reference seeds it from a JAX key, so the two sample other edges;
- ``ResNetUnit``: the fused conv+BN(+add)+ReLU block as a layer, with the
  reference's parameter names.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..core.place import resolve_device
from ..ops.generated import GENERATED

__all__ = ["softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
           "graph_send_recv", "graph_khop_sampler", "ResNetUnit"]


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) (fused_softmax_mask_op.cu's role)."""
    return GENERATED["fused_softmax_mask"](x, mask)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal-masked softmax (fused_softmax_mask_upper_triangle_op.cu's
    role)."""
    return GENERATED["fused_softmax_mask_upper_triangle"](x)


def _as_index(t, device):
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
    return t.to(device=device, dtype=torch.int64)


def graph_send_recv(x, src_index, dst_index, pool_type="sum", out_size=None,
                    name=None):
    """Gather rows at ``src_index`` and reduce them onto ``dst_index``
    (graph_send_recv_op.cc). pool_type: sum | mean | max | min; a
    destination that receives nothing is 0."""
    pt = pool_type.lower()
    if pt not in ("sum", "mean", "max", "min"):
        raise ValueError(f"pool_type must be sum|mean|max|min, got {pool_type}")
    si, di = _as_index(src_index, x.device), _as_index(dst_index, x.device)
    n_out = int(out_size) if out_size is not None else int(x.shape[0])
    msgs = x.index_select(0, si)
    shape = (n_out,) + tuple(x.shape[1:])
    bshape = (-1,) + (1,) * (x.dim() - 1)
    if pt in ("sum", "mean"):
        out = x.new_zeros(shape).index_add(0, di, msgs)
        if pt == "mean":
            cnt = x.new_zeros(n_out).index_add(0, di, torch.ones_like(
                di, dtype=x.dtype))
            out = out / torch.clamp(cnt, min=1).reshape(bshape)
        return out
    idx = di.reshape(bshape).expand_as(msgs)
    out = x.new_zeros(shape).scatter_reduce(
        0, idx, msgs, "amax" if pt == "max" else "amin", include_self=False)
    touched = torch.zeros(n_out, dtype=torch.bool, device=x.device)
    touched[di] = True
    return torch.where(touched.reshape(bshape), out, torch.zeros_like(out))


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       return_eids=False, name=None):
    """K-hop neighbour sampling over a CSC graph (graph_khop_sampler_op.cc),
    on the host. Returns (edge_src, edge_dst, sample_index, reindex_nodes)
    on the CPU: every sampled edge is an edge of the graph, at most
    ``sample_sizes[k]`` are taken a node at hop k, and the edges and seeds
    are reindexed into ``sample_index``."""
    if return_eids:
        raise NotImplementedError(
            "return_eids=True is not supported by this build's sampler")

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    row_v, colptr_v = host(row), host(colptr)
    seeds = host(input_nodes).reshape(-1)
    # fresh randomness a call (stochastic neighbourhoods, like the
    # reference op), seeded from the port's CPU generator
    rng = np.random.RandomState(int(torch.randint(0, 2 ** 31 - 1, (1,))))
    cur = seeds
    all_src, all_dst = [], []
    for k in sample_sizes:
        nxt_src, nxt_dst = [], []
        for v in cur:
            beg, end = int(colptr_v[v]), int(colptr_v[v + 1])
            neigh = row_v[beg:end]
            if len(neigh) > k:
                neigh = rng.choice(neigh, size=k, replace=False)
            nxt_src.extend(int(u) for u in neigh)
            nxt_dst.extend(int(v) for _ in range(len(neigh)))
        all_src.extend(nxt_src)
        all_dst.extend(nxt_dst)
        cur = np.unique(np.asarray(nxt_src, np.int64)) if nxt_src \
            else np.empty(0, np.int64)
    src = np.asarray(all_src, np.int64)
    dst = np.asarray(all_dst, np.int64)
    uniq = np.unique(np.concatenate([seeds, src, dst])) if src.size \
        else seeds
    remap = {int(g): i for i, g in enumerate(uniq)}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64))

    return (t([remap[int(u)] for u in src]), t([remap[int(u)] for u in dst]),
            t(uniq), t([remap[int(s)] for s in seeds]))


class ResNetUnit(nn.Layer):
    """Fused conv+BN(+residual add)+ReLU block (resnet_unit.py / the
    cuDNN-fused resnet_unit op), optionally with a conv+BN branch on the
    shortcut (the reference's has_shortcut mode)."""

    def __init__(self, num_channels_x, num_filters, filter_size, stride=1,
                 momentum=0.9, eps=1e-5, data_format="NCHW", act="relu",
                 has_shortcut=False, num_channels_z=None, *, device=None,
                 dtype=None, generator=None, **kw):
        super().__init__()
        if data_format != "NCHW":
            raise NotImplementedError("ResNetUnit supports NCHW here")
        if act not in ("relu", None, ""):
            raise ValueError(f"unsupported act {act!r}; this unit fuses 'relu'")
        dk = {"device": resolve_device(device), "dtype": dtype}
        pad = (filter_size - 1) // 2
        self.conv = nn.Conv2D(num_channels_x, num_filters, filter_size,
                              stride=stride, padding=pad, bias_attr=False,
                              generator=generator, **dk)
        self.bn = nn.BatchNorm2D(num_filters, momentum=momentum, epsilon=eps,
                                 **dk)
        self.has_shortcut = bool(has_shortcut)
        if self.has_shortcut:
            self.conv_z = nn.Conv2D(num_channels_z or num_channels_x,
                                    num_filters, 1, stride=stride,
                                    bias_attr=False, generator=generator,
                                    **dk)
            self.bn_z = nn.BatchNorm2D(num_filters, momentum=momentum,
                                       epsilon=eps, **dk)
        self.act = act

    def forward(self, x, z=None):
        out = self.bn(self.conv(x))
        if z is not None:
            out = out + (self.bn_z(self.conv_z(z)) if self.has_shortcut else z)
        if self.act == "relu":
            out = nn.functional.relu(out)
        return out

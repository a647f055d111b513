"""Vision and misc functionals (port of
``paddle_tpu/nn/functional/vision.py``): ``affine_grid`` and
``grid_sample`` (the reference's own sampler: its reflection about the
pixel-edge extent when ``align_corners=False`` and its clamped border),
``sequence_mask``, ``temporal_shift``, ``zeropad2d``, the distance and
pair losses, ``gather_tree`` and the max unpools. The integer outputs are
int64, as the reference's under x64.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import dtype as dtypes
from ...core.dispatch import amp_cast


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """(N, 2, 3) affine maps -> the (N, H, W, 2) sampling grid in [-1, 1]."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, H, W = [int(v) for v in out_shape]
    theta, = amp_cast("affine_grid", (theta,))
    dev, dt = theta.device, theta.dtype
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, W, dtype=torch.float64, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float64, device=dev)
    else:
        xs = (torch.arange(W, dtype=torch.float64, device=dev) * 2 + 1) / W - 1
        ys = (torch.arange(H, dtype=torch.float64, device=dev) * 2 + 1) / H - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(dt)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample (N, C, H, W) ``x`` at the (N, Hg, Wg, 2) ``grid`` of (x, y) in
    [-1, 1]; ``nearest`` rounds half to even; out-of-range taps read 0
    (``zeros``) or the clamped edge (``border``, ``reflection``)."""
    x, grid = amp_cast("grid_sample", (x, grid))
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (W - 1) / 2, (gy + 1) * (H - 1) / 2
    else:
        fx, fy = ((gx + 1) * W - 1) / 2, ((gy + 1) * H - 1) / 2
    if padding_mode == "reflection":
        def refl(c, n):
            lo = 0.0 if align_corners else -0.5
            hi = (n - 1.0) if align_corners else (n - 0.5)
            span = max(hi - lo, 1e-3)
            c = torch.remainder((c - lo).abs(), 2 * span)
            return lo + torch.where(c > span, 2 * span - c, c)

        fx, fy = refl(fx, W), refl(fy, H)
    flat = x.reshape(N, C, H * W)
    hw = gx.shape[1:]

    def tap(yy, xx):
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(N, 1, -1)
        v = flat.gather(2, idx.expand(N, C, idx.shape[-1])).reshape(
            N, C, *hw)
        if padding_mode == "zeros":
            v = torch.where(inb.unsqueeze(1), v, torch.zeros_like(v))
        return v

    if mode == "nearest":
        return tap(torch.round(fy).long(), torch.round(fx).long())
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0).unsqueeze(1), (fy - y0).unsqueeze(1)
    x0i, y0i = x0.long(), y0.long()
    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < lengths[...]``; ``maxlen`` defaults to the
    longest."""
    if maxlen is None:
        maxlen = int(lengths.max())
    ar = torch.arange(int(maxlen), device=lengths.device)
    return (ar < lengths.unsqueeze(-1)).to(dtypes.convert_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM: of each segment group, the first ``C * ratio`` channels move
    one step back in time, the next as many one step forward (zeros fill);
    ``data_format`` is not used, as in the reference."""
    x, = amp_cast("temporal_shift", (x,))
    NT, C, H, W = x.shape
    v = x.reshape(NT // seg_num, seg_num, C, H, W)
    c1, c2 = int(C * shift_ratio), int(C * 2 * shift_ratio)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], 1)
    return torch.cat([back, fwd, v[:, :, c2:]], 2).reshape(NT, C, H, W)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """(left, right, top, bottom) zeros on the last two axes."""
    if isinstance(padding, int):
        padding = [padding] * 4
    l, r, top, bot = [int(p) for p in padding]
    x, = amp_cast("zeropad2d", (x,))
    return TF.pad(x, (l, r, top, bot))


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``sum(|x - y + epsilon| ** p, -1) ** (1 / p)``."""
    x, y = amp_cast("pairwise_distance", (x, y))
    d = x - y + epsilon
    return (d.abs() ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    anchor, positive = amp_cast("npair_loss", (anchor, positive))
    B = anchor.shape[0]
    lb = labels.reshape(-1)
    same = (lb[:, None] == lb[None, :]).to(anchor.dtype)
    tgt = same / torch.clamp(same.sum(-1, keepdim=True), min=1.0)
    logp = torch.log_softmax(anchor @ positive.T, -1)
    xent = -(tgt * logp).sum(-1).mean()
    reg = ((anchor * anchor).sum() + (positive * positive).sum()) / B * \
        l2_reg * 0.25
    return xent + reg


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - (2 |p * t| + eps) / (|p| + |t| + eps))`` with ``t`` the
    one-hot of ``label`` (its trailing axis of 1 squeezed)."""
    input, = amp_cast("dice_loss", (input,))
    classes = torch.arange(input.shape[-1], device=input.device)
    t1 = (label.squeeze(-1).long().unsqueeze(-1) == classes).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * t1).sum(dims)
    union = input.sum(dims) + t1.sum(dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def gather_tree(ids, parents):
    """Beam-search backtrace over (T, B, W) ids and parents."""
    T, B, W = ids.shape
    beams = torch.arange(W, device=ids.device).expand(B, W)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        outs[t] = ids[t].gather(1, beams)
        beams = parents[t].long().gather(1, beams)
    return torch.stack(outs)


def _unpool(x, indices, out_spatial):
    N, C = x.shape[:2]
    size = 1
    for s in out_spatial:
        size *= s
    out = torch.zeros(N, C, size, dtype=x.dtype, device=x.device)
    out = out.scatter(2, indices.reshape(N, C, -1).long(), x.reshape(N, C, -1))
    return out.reshape(N, C, *out_spatial)


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Each value to its flat index in a zero (N, C, OH, OW), OH =
    (H - 1) * stride + kernel - 2 * padding unless ``output_size``."""
    k = _ntuple(kernel_size, 2)
    s = _ntuple(stride or k, 2)
    p = _ntuple(padding, 2)
    x, = amp_cast("max_unpool2d", (x,))
    H, W = x.shape[2:]
    oh = int(output_size[-2]) if output_size is not None else 0
    ow = int(output_size[-1]) if output_size is not None else 0
    OH = oh or (H - 1) * s[0] + k[0] - 2 * p[0]
    OW = ow or (W - 1) * s[1] + k[1] - 2 * p[1]
    return _unpool(x, indices, (OH, OW))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    ks = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    st = stride if stride is not None else ks
    st = st if isinstance(st, int) else st[0]
    pd = padding if isinstance(padding, int) else padding[0]
    osz = None if output_size is None else [1, int(output_size[-1])]
    out = max_unpool2d(x.unsqueeze(-2), indices.unsqueeze(-2), (1, ks),
                       (1, st), padding=(0, pd), output_size=osz)
    return out.squeeze(-2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    k = _ntuple(kernel_size, 3)
    s = _ntuple(stride or k, 3)
    p = _ntuple(padding, 3)
    x, = amp_cast("max_unpool3d", (x,))
    D, H, W = x.shape[2:]
    o = [int(v) for v in output_size[-3:]] if output_size is not None \
        else [0, 0, 0]
    out = [o[i] or (n - 1) * s[i] + k[i] - 2 * p[i]
           for i, n in enumerate((D, H, W))]
    return _unpool(x, indices, tuple(out))


__all__ = [
    "affine_grid", "grid_sample", "sequence_mask", "temporal_shift",
    "zeropad2d", "pairwise_distance", "npair_loss", "dice_loss",
    "gather_tree", "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

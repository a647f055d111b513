"""Vision and detection ops (port of ``paddle_tpu/vision/ops.py``).

Plain PyTorch on the input's device. None of them is a kernel: the
reference writes them in ``jax.numpy`` (and ``deform_conv2d``'s
contraction stays an ``einsum``). Where the reference works on the host
because an output's length depends on the data (``nms``,
``distribute_fpn_proposals``, the image index of each RoI from
``boxes_num``), the port reads the inputs back once and does the same
numpy work. ``matrix_nms`` and ``multiclass_nms`` are the reference's
static-shape forms (score decay, and hard suppression as a fixed point
over the score-sorted boxes): results padded to ``keep_top_k`` rows, on
the device, with no read-back. Rankings use a stable descending sort, so
equal scores keep their index order.

Facts of the reference the port keeps: ``roi_align`` samples image 0 for
every RoI, one bilinear point a bin at its centre (``boxes_num`` and
``sampling_ratio`` are not used); ``roi_pool`` and ``psroi_pool`` take
the max (mean) over a 4 x 4 grid of nearest pixels a bin; ``box_coder``'s
``axis`` is not used.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..core.tensor import host_arrays as _read


def _dev(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _stable_topk(x, k):
    """(values, indices) of the ``k`` largest along the last axis, ties in
    index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy hard NMS on the host (the kept count depends on the data):
    the kept indices, best score first, int64 on ``boxes``' device."""
    if scores is not None:
        b, s = _read(boxes, scores)
    else:
        (b,) = _read(boxes)
        s = np.arange(len(b))[::-1]
    b = b.astype(np.float64)
    order = np.argsort(-s)
    keep = []
    suppressed = np.zeros(len(b), bool)
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(b[i, 0], b[:, 0])
        yy1 = np.maximum(b[i, 1], b[:, 1])
        xx2 = np.minimum(b[i, 2], b[:, 2])
        yy2 = np.minimum(b[i, 3], b[:, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-10)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    keep = np.asarray(keep, np.int64)
    if top_k is not None:
        keep = keep[:top_k]
    return torch.from_numpy(keep).to(_dev(boxes))


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    pb, tb = prior_box, target_box
    pw = pb[:, 2] - pb[:, 0]
    ph = pb[:, 3] - pb[:, 1]
    px = pb[:, 0] + pw / 2
    py = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0]
        th = tb[:, 3] - tb[:, 1]
        tx = tb[:, 0] + tw / 2
        ty = tb[:, 1] + th / 2
        out = torch.stack([(tx - px) / pw, (ty - py) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], -1)
        if prior_box_var is not None:
            out = out / prior_box_var
        return out
    dx, dy, dw, dh = tb[..., 0], tb[..., 1], tb[..., 2], tb[..., 3]
    cx = dx * pw + px
    cy = dy * ph + py
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _bilinear_zero(feat, ys, xs):
    """``feat`` (C, H, W) sampled bilinearly at ``ys`` x ``xs`` (broadcast
    against each other), a corner outside the map counting 0 (the
    reference's ``map_coordinates(order=1, mode="constant")``): (C,
    *shape)."""
    _, H, W = feat.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0.long(), x0.long()
    out = 0
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = feat[:, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            out = out + (wy * wx) * torch.where(ok, v, torch.zeros_like(v))
    return out


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """(R, C, oh, ow): each RoI of ``boxes`` (x1, y1, x2, y2) sampled at
    its bins' centres on image 0 of ``x`` (the reference's)."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    offset = 0.5 if aligned else 0.0
    r = boxes * spatial_scale - offset
    x1, y1, x2, y2 = r[:, 0:1], r[:, 1:2], r[:, 2:3], r[:, 3:4]
    gy = torch.arange(oh, device=x.device, dtype=x.dtype) + 0.5
    gx = torch.arange(ow, device=x.device, dtype=x.dtype) + 0.5
    ys = y1 + gy * (y2 - y1) / oh  # (R, oh)
    xs = x1 + gx * (x2 - x1) / ow  # (R, ow)
    v = _bilinear_zero(x[0], ys[:, :, None], xs[:, None, :])
    return v.permute(1, 0, 2, 3)


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode one YOLOv3 head: boxes (N, A*H*W, 4) in image pixels and
    scores (N, A*H*W, class_num), zero where the objectness is at most
    ``conf_thresh``."""
    with torch.no_grad():
        n, _, h, w = x.shape
        an = torch.tensor(list(anchors), dtype=torch.float32,
                          device=x.device).reshape(-1, 2)
        na = an.shape[0]
        x = x.reshape(n, na, 5 + class_num, h, w)
        gy, gx = torch.meshgrid(torch.arange(h, device=x.device),
                                torch.arange(w, device=x.device),
                                indexing="ij")
        bias = (scale_x_y - 1) / 2
        bx = (torch.sigmoid(x[:, :, 0]) * scale_x_y - bias + gx) / w
        by = (torch.sigmoid(x[:, :, 1]) * scale_x_y - bias + gy) / h
        bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / (
            downsample_ratio * w)
        bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / (
            downsample_ratio * h)
        conf = torch.sigmoid(x[:, :, 4])
        probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
        img_h = img_size[:, 0].reshape(n, 1, 1, 1).to(torch.float32)
        img_w = img_size[:, 1].reshape(n, 1, 1, 1).to(torch.float32)
        x1 = (bx - bw / 2) * img_w
        y1 = (by - bh / 2) * img_h
        x2 = (bx + bw / 2) * img_w
        y2 = (by + bh / 2) * img_h
        if clip_bbox:
            zero = torch.zeros((), device=x.device)
            x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
            y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
            x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
            y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
        boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
        scores = probs.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
        mask = conf.reshape(n, -1, 1) > conf_thresh
        scores = torch.where(mask, scores, torch.zeros_like(scores))
    return boxes, scores


def _roi_batch_ids(boxes_num, n_rois, device):
    """The image index of each RoI from the ``boxes_num`` split (read on
    the host once)."""
    if boxes_num is None:
        return torch.zeros(n_rois, dtype=torch.long, device=device)
    (counts,) = _read(boxes_num)
    counts = counts.reshape(-1).astype(np.int64)
    ids = np.repeat(np.arange(len(counts)), counts)[:n_rois]
    return torch.from_numpy(ids).to(device)


_S = 4  # samples a bin edge: roi_pool's max (psroi_pool's mean) over S x S


def _bin_samples(x, boxes, boxes_num, oh, ow, spatial_scale):
    """(R, oh*S, ow*S, C): each RoI's nearest pixels on an S x S grid a
    bin, from its own image."""
    _, _, H, W = x.shape
    bids = _roi_batch_ids(boxes_num, boxes.shape[0], x.device)
    r = boxes * spatial_scale
    x1, y1, x2, y2 = r[:, 0:1], r[:, 1:2], r[:, 2:3], r[:, 3:4]
    gy = torch.arange(oh * _S, device=x.device, dtype=r.dtype) + 0.5
    gx = torch.arange(ow * _S, device=x.device, dtype=r.dtype) + 0.5
    ys = y1 + (y2 - y1) * gy / (oh * _S)
    xs = x1 + (x2 - x1) * gx / (ow * _S)
    yi = torch.round(ys).long().clamp(0, H - 1)
    xi = torch.round(xs).long().clamp(0, W - 1)
    return x[bids[:, None, None], :, yi[:, :, None], xi[:, None, :]]


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """(R, C, oh, ow): the max of each RoI bin over its S x S samples."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else (int(output_size[0]), int(output_size[1]))
    v = _bin_samples(x, boxes, boxes_num, oh, ow, spatial_scale)
    R, C = v.shape[0], v.shape[-1]
    v = v.permute(0, 3, 1, 2).reshape(R, C, oh, _S, ow, _S)
    return v.amax(dim=(3, 5))


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """(R, C / (oh*ow), oh, ow): position-sensitive average, channel block
    (i, j) averaged over bin (i, j)."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else (int(output_size[0]), int(output_size[1]))
    v = _bin_samples(x, boxes, boxes_num, oh, ow, spatial_scale)
    R, C = v.shape[0], v.shape[-1]
    oc = C // (oh * ow)
    v = v.permute(0, 3, 1, 2).reshape(R, oc, oh, ow, oh, _S, ow, _S)
    ii = torch.arange(oh, device=x.device)[:, None]
    jj = torch.arange(ow, device=x.device)[None, :]
    cells = v[:, :, ii, jj, ii, :, jj, :]  # (oh, ow, R, oc, S, S)
    return cells.mean(dim=(-1, -2)).permute(2, 3, 0, 1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes (H, W, P, 4) and their variances, from the shapes
    alone (the reference computes them in numpy too)."""
    ratios = list(aspect_ratios)
    if flip:
        ratios = ratios + [1.0 / r for r in ratios if r != 1.0]
    H, W = int(input.shape[-2]), int(input.shape[-1])
    IH, IW = int(image.shape[-2]), int(image.shape[-1])
    step_h = steps[1] or IH / H
    step_w = steps[0] or IW / W
    sizes = []
    for k, ms in enumerate(min_sizes):
        for r in ratios:
            sizes.append((ms * (r ** 0.5), ms / (r ** 0.5)))
        if max_sizes:
            mx = max_sizes[k]
            sizes.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
    sizes = np.asarray(sizes, np.float32)  # (P, 2) as (w, h)
    cy = (np.arange(H) + offset) * step_h
    cx = (np.arange(W) + offset) * step_w
    gx, gy = np.meshgrid(cx, cy)
    centers = np.stack([gx, gy], -1)[..., None, :]  # (H, W, 1, 2)
    wh = sizes[None, None]
    mins = (centers - wh / 2) / np.asarray([IW, IH], np.float32)
    maxs = (centers + wh / 2) / np.asarray([IW, IH], np.float32)
    boxes = np.concatenate([mins, maxs], -1).astype(np.float32)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          boxes.shape).copy()
    dev = _dev(input)
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(var).to(dev)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Each RoI to its FPN level, on the host (the counts depend on the
    data): (RoIs a level, the order that restores the input, counts a
    level)."""
    dev = _dev(fpn_rois)
    dt = fpn_rois.dtype if isinstance(fpn_rois, torch.Tensor) else None
    (rois,) = _read(fpn_rois)
    w = rois[:, 2] - rois[:, 0] + (1 if pixel_offset else 0)
    h = rois[:, 3] - rois[:, 1] + (1 if pixel_offset else 0)
    scale = np.sqrt(np.maximum(w * h, 1e-6))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, nums, order = [], [], []
    for L in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == L)[0]
        outs.append(torch.from_numpy(rois[idx]).to(dev, dt))
        nums.append(torch.tensor([len(idx)], dtype=torch.int32, device=dev))
        order.append(idx)
    restore = np.argsort(np.concatenate(order)) if order \
        else np.zeros(0, np.int64)
    return outs, torch.from_numpy(restore.astype(np.int32)).to(dev), nums


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (v2 with ``mask``): each tap sampled
    bilinearly at its offset position on the zero-padded input (offsets
    (N, dg*kh*kw*2, OH, OW), (dy, dx) interleaved a tap), then contracted
    with ``weight`` by ``einsum``."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    N, C, H, W = x.shape
    kh, kw = int(weight.shape[-2]), int(weight.shape[-1])
    OH = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    OW = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    feat = torch.nn.functional.pad(x, (pw, pw, ph, ph))
    Hp, Wp = H + 2 * ph, W + 2 * pw
    dg = offset.shape[1] // (2 * kh * kw)
    cpg = C // dg
    off = offset.reshape(N, dg, kh, kw, 2, OH, OW)
    dev, dt = x.device, x.dtype
    base_y = (torch.arange(OH, device=dev, dtype=dt) * sh)[:, None] \
        + 0 * torch.arange(OW, device=dev, dtype=dt)[None, :]
    base_x = (torch.arange(OW, device=dev, dtype=dt) * sw)[None, :] \
        + 0 * torch.arange(OH, device=dev, dtype=dt)[:, None]
    tap_y = (torch.arange(kh, device=dev, dtype=dt) * dh)[:, None, None, None]
    tap_x = (torch.arange(kw, device=dev, dtype=dt) * dw)[None, :, None, None]
    yy = base_y + tap_y + off[:, :, :, :, 0]  # (N, dg, kh, kw, OH, OW)
    xx = base_x + tap_x + off[:, :, :, :, 1]
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy, wx = yy - y0, xx - x0
    y0, x0 = y0.long(), x0.long()
    flat = feat.reshape(N, dg, cpg, Hp * Wp)
    L = kh * kw * OH * OW

    def gat(yi, xi):
        ok = (yi >= 0) & (yi < Hp) & (xi >= 0) & (xi < Wp)
        idx = (yi.clamp(0, Hp - 1) * Wp + xi.clamp(0, Wp - 1)).reshape(
            N, dg, 1, L).expand(N, dg, cpg, L)
        v = flat.gather(3, idx).reshape(N, dg, cpg, kh, kw, OH, OW)
        return torch.where(ok[:, :, None], v, torch.zeros_like(v))

    wy_, wx_ = wy[:, :, None], wx[:, :, None]
    cols = (gat(y0, x0) * (1 - wy_) * (1 - wx_)
            + gat(y0, x0 + 1) * (1 - wy_) * wx_
            + gat(y0 + 1, x0) * wy_ * (1 - wx_)
            + gat(y0 + 1, x0 + 1) * wy_ * wx_)
    if mask is not None:
        cols = cols * mask.reshape(N, dg, 1, kh, kw, OH, OW)
    cols = cols.reshape(N, C, kh, kw, OH, OW)
    if groups == 1:
        out = torch.einsum("nckhij,ockh->noij", cols, weight)
    else:
        G = groups
        cols_g = cols.reshape(N, G, C // G, kh, kw, OH, OW)
        w_g = weight.reshape(G, weight.shape[0] // G, C // G, kh, kw)
        out = torch.einsum("ngckhij,gockh->ngoij", cols_g, w_g).reshape(
            N, weight.shape[0], OH, OW)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


class DeformConv2D(nn.Layer):
    """A layer over ``deform_conv2d``; ``forward(x, offset, mask=None)``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        k = kernel_size if isinstance(kernel_size, (tuple, list)) \
            else (kernel_size, kernel_size)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, k[0], k[1]],
            attr=weight_attr, device=device, generator=generator)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True, device=device,
            generator=generator)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups, self.groups = deformable_groups, groups

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)


def _pairwise_iou(a, b, off=0.0):
    """(N, 4) x (M, 4) xyxy boxes -> (N, M) IoU; ``off`` 1.0 for pixel
    boxes."""
    area_a = (a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off)
    area_b = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (x2 - x1 + off).clamp(min=0) * (y2 - y1 + off).clamp(min=0)
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter,
                               min=1e-10)


def iou_similarity(x, y, box_normalized=True, name=None):
    """The (N, M) IoU matrix of xyxy boxes."""
    return _pairwise_iou(x, y, 0.0 if box_normalized else 1.0)


def box_clip(boxes, img_shape, name=None):
    """xyxy ``boxes`` (..., 4) clipped to an image of ``img_shape`` (h,
    w)."""
    im = img_shape.to(boxes.dtype)
    h, w = im[0], im[1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)

    return torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                        clip(boxes[..., 2], w), clip(boxes[..., 3], h)], -1)


def anchor_generator(input, anchor_sizes, aspect_ratios, stride,
                     variances=(0.1, 0.1, 0.2, 0.2), offset=0.5, name=None):
    """Dense anchors over an (N, C, H, W) map: (H, W, A, 4) and their
    variances."""
    stride = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    dev = input.device
    h, w = input.shape[2], input.shape[3]
    f32 = torch.float32
    cx = (torch.arange(w, dtype=f32, device=dev) + float(offset)) \
        * float(stride[0])
    cy = (torch.arange(h, dtype=f32, device=dev) + float(offset)) \
        * float(stride[1])
    shapes = [(float(s) * np.sqrt(float(r)), float(s) / np.sqrt(float(r)))
              for s in anchor_sizes for r in aspect_ratios]
    ws = torch.tensor([s[0] for s in shapes], dtype=f32, device=dev)
    hs = torch.tensor([s[1] for s in shapes], dtype=f32, device=dev)
    gx, gy = cx[None, :, None], cy[:, None, None]
    A = len(shapes)
    anchors = torch.stack([
        (gx - ws / 2).expand(h, w, A), (gy - hs / 2).expand(h, w, A),
        (gx + ws / 2).expand(h, w, A), (gy + hs / 2).expand(h, w, A),
    ], -1)
    var = torch.tensor([float(v) for v in variances], dtype=f32,
                       device=dev).expand(anchors.shape).clone()
    return anchors, var


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variances=(0.1, 0.1, 0.2, 0.2), clip=False, step=0.0,
                      offset=0.5, name=None):
    """Density prior boxes: density d splits each cell into d x d shifted
    centres for every fixed size and ratio; (H, W, A, 4) and variances."""
    dev = input.device
    h, w = input.shape[2], input.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_x = float(step) or img_w / w
    step_y = float(step) or img_h / h
    f32 = torch.float32
    ar_w = torch.arange(w, dtype=f32, device=dev)[None, :]
    ar_h = torch.arange(h, dtype=f32, device=dev)[:, None]
    boxes = []
    for d, fs in zip(densities, fixed_sizes):
        d, fs = int(d), float(fs)
        for r in fixed_ratios:
            bw = fs * np.sqrt(float(r)) / img_w
            bh = fs / np.sqrt(float(r)) / img_h
            shift = 1.0 / d
            for di in range(d):
                for dj in range(d):
                    ox = (dj + 0.5) * shift - 0.5 + float(offset)
                    oy = (di + 0.5) * shift - 0.5 + float(offset)
                    cx = (ar_w + ox) * step_x / img_w
                    cy = (ar_h + oy) * step_y / img_h
                    boxes.append(torch.stack([
                        (cx - bw / 2).expand(h, w), (cy - bh / 2).expand(h, w),
                        (cx + bw / 2).expand(h, w), (cy + bh / 2).expand(h, w),
                    ], -1))
    out = torch.stack(boxes, 2)
    if clip:
        out = out.clamp(0.0, 1.0)
    var = torch.tensor([float(v) for v in variances], dtype=f32,
                       device=dev).expand(out.shape).clone()
    return out, var


def bipartite_match(dist_mat, name=None):
    """Greedy bipartite matching of an (N, M) similarity, best pair first,
    on the device: (row matched to each column or -1 (M,), its
    similarity (M,))."""
    with torch.no_grad():
        d = dist_mat.clone()
        n, m = d.shape
        cols = torch.arange(m, device=d.device)
        rows = torch.arange(n, device=d.device)
        idx = torch.full((m,), -1, dtype=torch.int64, device=d.device)
        val = torch.zeros((m,), dtype=d.dtype, device=d.device)
        ninf = torch.tensor(-float("inf"), dtype=d.dtype, device=d.device)
        for _ in range(min(n, m)):
            flat = torch.argmax(d)
            i, j = flat // m, flat % m
            best = d.reshape(-1)[flat]
            take = best > ninf
            hit = take & (cols == j)
            idx = torch.where(hit, i, idx)
            val = torch.where(hit, best, val)
            cut = take & ((rows == i)[:, None] | (cols == j)[None, :])
            d = torch.where(cut, ninf, d)
    return idx, val


def _nms_select(dec_s, dec_i, boxes, keep_top_k, threshold):
    """The best ``keep_top_k`` of the per-class (C, k) scores: rows
    [class, score, x1, y1, x2, y2] (-1 where the score is at most
    ``threshold``), their box indices (-1 likewise) and the count kept."""
    c, k = dec_s.shape
    flat_s = dec_s.reshape(-1)
    flat_i = dec_i.reshape(-1)
    flat_c = torch.arange(c, device=boxes.device).repeat_interleave(k)
    kk = min(keep_top_k, flat_s.shape[0])
    sel_s, sel = _stable_topk(flat_s, kk)
    ok = sel_s > threshold
    out = torch.cat([flat_c[sel].to(boxes.dtype)[:, None], sel_s[:, None],
                     boxes[flat_i[sel]]], 1)
    out = torch.where(ok[:, None], out, torch.full_like(out, -1.0))
    index = torch.where(ok, flat_i[sel].to(torch.int32),
                        torch.full_like(sel, -1, dtype=torch.int32))
    return out, index, ok.sum()


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=100, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=-1, normalized=True,
               name=None):
    """Matrix NMS (SOLOv2): each class's top ``nms_top_k`` scores decayed
    by their overlap with the better boxes, in parallel. ``bboxes`` (N, 4),
    ``scores`` (C, N); returns (out (keep_top_k, 6), index (keep_top_k,),
    count)."""
    with torch.no_grad():
        c, n = scores.shape
        k = min(nms_top_k, n)
        off = 0.0 if normalized else 1.0
        top_s, top_i = _stable_topk(scores, k)  # (C, k)
        b = bboxes[top_i]  # (C, k, 4)
        upper = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                      device=bboxes.device), 1)
        iou = torch.stack([_pairwise_iou(bc, bc, off) for bc in b])
        iou = torch.where(upper, iou, torch.zeros_like(iou))
        comp = iou.amax(dim=1)  # (C, k): how suppressed box i itself is
        if use_gaussian:
            dec = torch.exp((comp[:, :, None] ** 2 - iou ** 2)
                            / gaussian_sigma)
        else:
            dec = (1.0 - iou) / torch.clamp(1.0 - comp[:, :, None],
                                            min=1e-10)
        inf = torch.full_like(dec, float("inf"))
        decay = torch.where(upper, dec, inf).amin(dim=1)
        decay = torch.where(torch.isfinite(decay), decay,
                            torch.ones_like(decay))
        s = top_s * decay
        s = torch.where(top_s > score_threshold, s, torch.zeros_like(s))
        if background_label >= 0:
            s[background_label] = 0.0
        return _nms_select(s, top_i, bboxes, keep_top_k, post_threshold)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=100,
                   keep_top_k=100, nms_threshold=0.5, normalized=True,
                   background_label=-1, name=None):
    """Per-class hard NMS in static shape: a box is kept when no kept box
    of a better score overlaps it above ``nms_threshold``, decided in score
    order on the device; returns as ``matrix_nms``."""
    with torch.no_grad():
        c, n = scores.shape
        k = min(nms_top_k, n)
        off = 0.0 if normalized else 1.0
        top_s, top_i = _stable_topk(scores, k)
        b = bboxes[top_i]
        iou = torch.stack([torch.triu(_pairwise_iou(bc, bc, off), 1)
                           for bc in b])
        over = iou > nms_threshold  # (C, k, k)
        live = top_s > score_threshold
        keep = torch.zeros((c, k), dtype=torch.bool, device=bboxes.device)
        for i in range(k):
            sup = (over[:, :, i] & keep).any(dim=1)
            keep[:, i] = ~sup & live[:, i]
        s = torch.where(keep, top_s, torch.zeros_like(top_s))
        if background_label >= 0:
            s[background_label] = 0.0
        return _nms_select(s, top_i, bboxes, keep_top_k, 0.0)


def target_assign(x, match_indices, mismatch_value=0, name=None):
    """Rows of ``x`` (N, D) by ``match_indices`` (M,) (-1: unmatched, set to
    ``mismatch_value``): (out (M, D), weight (M, 1))."""
    with torch.no_grad():
        ok = match_indices >= 0
        out = x[match_indices.clamp(0, x.shape[0] - 1)]
        out = torch.where(ok[:, None], out,
                          torch.full_like(out, float(mismatch_value)))
        return out, ok.to(x.dtype)[:, None]


def _scatter_add(n, lin, vals):
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(
        0, lin.reshape(-1), vals.reshape(-1))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh=0.7, downsample_ratio=32, use_label_smooth=False,
                name=None):
    """The YOLOv3 loss of one scale, (N,). ``x`` (N, A*(5+C), H, W);
    ``gt_box`` (N, G, 4) centre-size boxes in [0, 1]; ``gt_label`` (N, G)
    (-1 pads). A gt trains the cell and anchor of its best-shaped anchor
    (over all anchors; several gts there average their targets), and a
    prediction overlapping any gt above ``ignore_thresh`` is left out of
    the no-object term."""
    n, _, h, w = x.shape
    a = len(anchor_mask)
    dev, dt = x.device, x.dtype
    xv = x.reshape(n, a, 5 + class_num, h, w)
    tx, ty = torch.sigmoid(xv[:, :, 0]), torch.sigmoid(xv[:, :, 1])
    tw, th = xv[:, :, 2], xv[:, :, 3]
    obj_logit = xv[:, :, 4]
    cls_logit = xv[:, :, 5:]
    all_anchors = torch.tensor(np.asarray(anchors, np.float32).reshape(-1, 2),
                               device=dev)
    sel = all_anchors[torch.tensor(list(anchor_mask), device=dev)]
    img_w, img_h = float(downsample_ratio * w), float(downsample_ratio * h)
    gb = gt_box.detach().to(dt)
    gl = gt_label

    with torch.no_grad():
        gx = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
        gy = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
        px = (tx + gx) / w
        py = (ty + gy) / h
        pw = torch.exp(tw.clamp(-10, 10)) * sel[None, :, 0, None, None] / img_w
        ph = torch.exp(th.clamp(-10, 10)) * sel[None, :, 1, None, None] / img_h

        valid = gl >= 0
        gw = gb[..., 2] * img_w
        gh = gb[..., 3] * img_h
        inter = (torch.minimum(gw[..., None], all_anchors[None, None, :, 0])
                 * torch.minimum(gh[..., None],
                                 all_anchors[None, None, :, 1]))
        union = (gw * gh)[..., None] + (all_anchors[:, 0]
                                        * all_anchors[:, 1])[None, None, :] \
            - inter
        best = torch.argmax(inter / torch.clamp(union, min=1e-10), -1)
        ci = (gb[..., 0] * w).to(torch.int32).clamp(0, w - 1).long()
        cj = (gb[..., 1] * h).to(torch.int32).clamp(0, h - 1).long()
        local = torch.full_like(best, -1)
        for li, am in enumerate(anchor_mask):
            local = torch.where(best == am, li, local)
        ok = valid & (local >= 0)
        la = local.clamp(0, a - 1)
        bidx = torch.arange(n, device=dev)[:, None].expand_as(la)
        lin = ((bidx * a + la) * h + cj) * w + ci  # (N, G)
        size = n * a * h * w
        okf = ok.to(dt)
        zero = torch.zeros_like(okf)
        tobj = torch.zeros(size, dtype=dt, device=dev).scatter_reduce(
            0, lin.reshape(-1), okf.reshape(-1), "amax").reshape(n, a, h, w)
        cnt = _scatter_add(size, lin, okf).clamp(min=1.0).reshape(n, a, h, w)

        def put(v):
            return _scatter_add(size, lin, torch.where(ok, v, zero)).reshape(
                n, a, h, w) / cnt

        t_x = put(gb[..., 0] * w - ci)
        t_y = put(gb[..., 1] * h - cj)
        sel_la = sel[la]
        t_w = put(torch.log(torch.clamp(
            gw / torch.clamp(sel_la[..., 0], min=1e-6), min=1e-6)))
        t_h = put(torch.log(torch.clamp(
            gh / torch.clamp(sel_la[..., 1], min=1e-6), min=1e-6)))
        bscale = put(2.0 - gb[..., 2] * gb[..., 3])
        smooth = 1.0 / max(class_num, 1) if use_label_smooth else 0.0
        onehot = torch.nn.functional.one_hot(
            gl.long().clamp(0, class_num - 1), class_num).to(dt)
        onehot = onehot * (1 - smooth) + smooth / class_num
        cls_lin = (((bidx * a + la)[..., None] * class_num
                    + torch.arange(class_num, device=dev)) * h
                   + cj[..., None]) * w + ci[..., None]
        t_cls = _scatter_add(
            size * class_num, cls_lin,
            torch.where(ok[..., None], onehot, torch.zeros_like(onehot))
        ).reshape(n, a, class_num, h, w) / cnt[:, :, None]

        # the ignore mask: a predicted box overlapping any gt above thresh
        pb = torch.stack([px - pw / 2, py - ph / 2, px + pw / 2,
                          py + ph / 2], -1).reshape(n, -1, 4)
        gbx = torch.stack([gb[..., 0] - gb[..., 2] / 2,
                           gb[..., 1] - gb[..., 3] / 2,
                           gb[..., 0] + gb[..., 2] / 2,
                           gb[..., 1] + gb[..., 3] / 2], -1)
        iou = torch.stack([_pairwise_iou(pb[i], gbx[i]) for i in range(n)])
        iou = torch.where(valid[:, None, :], iou, torch.zeros_like(iou))
        ignore = (iou.amax(-1) > ignore_thresh).reshape(n, a, h, w)

    def bce(lg, t):
        return torch.clamp(lg, min=0) - lg * t + torch.log1p(
            torch.exp(-lg.abs()))

    loss_xy = (bscale * ((tx - t_x) ** 2 + (ty - t_y) ** 2) * tobj).sum(
        (1, 2, 3))
    loss_wh = (bscale * ((tw - t_w) ** 2 + (th - t_h) ** 2) * tobj).sum(
        (1, 2, 3))
    noobj = (1.0 - tobj) * (1.0 - ignore.to(dt))
    loss_obj = (bce(obj_logit, tobj) * (tobj + noobj)).sum((1, 2, 3))
    loss_cls = (bce(cls_logit, t_cls) * tobj[:, :, None]).sum((1, 2, 3, 4))
    return loss_xy + loss_wh + loss_obj + loss_cls


__all__ = [
    "nms", "box_coder", "roi_align", "yolo_box", "roi_pool", "psroi_pool",
    "prior_box", "distribute_fpn_proposals", "deform_conv2d", "DeformConv2D",
    "iou_similarity", "box_clip", "anchor_generator", "density_prior_box",
    "bipartite_match", "matrix_nms", "multiclass_nms", "target_assign",
    "yolov3_loss",
]

"""YOLOv3 on DarkNet-53 (port of ``paddle_tpu/vision/models/yolov3.py``):
the backbone, the three-scale FPN heads, the per-scale ``yolov3_loss``,
and ``YOLOv3Postprocess``, which decodes with ``yolo_box`` and keeps
``keep_top_k`` detections an image by ``matrix_nms``, padded, on the
device."""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F
from .. import ops as vops

__all__ = ["YOLOv3", "yolov3_darknet53", "YOLOv3Postprocess"]

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
           116, 90, 156, 198, 373, 326]
ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


class ConvBNLeaky(nn.Layer):
    def __init__(self, cin, cout, k=3, stride=1, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.conv = nn.Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                              bias_attr=False, **kw)
        self.bn = nn.BatchNorm2D(cout, **kw)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), negative_slope=0.1)


class DarkBlock(nn.Layer):
    def __init__(self, ch, **kw):
        super().__init__()
        self.c1 = ConvBNLeaky(ch, ch // 2, k=1, **kw)
        self.c2 = ConvBNLeaky(ch // 2, ch, k=3, **kw)

    def forward(self, x):
        return x + self.c2(self.c1(x))


class DarkNet53(nn.Layer):
    """The backbone; returns C3 (/8), C4 (/16) and C5 (/32)."""

    def __init__(self, depths=(1, 2, 8, 8, 4), **kw):
        super().__init__()
        self.stem = ConvBNLeaky(3, 32, 3, **kw)
        chans = [64, 128, 256, 512, 1024]
        stages = []
        cin = 32
        for ch, n in zip(chans, depths):
            stage = [ConvBNLeaky(cin, ch, 3, stride=2, **kw)]
            stage += [DarkBlock(ch, **kw) for _ in range(n)]
            stages.append(nn.Sequential(*stage))
            cin = ch
        self.stages = nn.LayerList(stages)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[2], feats[3], feats[4]


class YoloDetBlock(nn.Layer):
    def __init__(self, cin, ch, **kw):
        super().__init__()
        self.body = nn.Sequential(
            ConvBNLeaky(cin, ch, 1, **kw), ConvBNLeaky(ch, ch * 2, 3, **kw),
            ConvBNLeaky(ch * 2, ch, 1, **kw),
            ConvBNLeaky(ch, ch * 2, 3, **kw),
            ConvBNLeaky(ch * 2, ch, 1, **kw),
        )
        self.tip = ConvBNLeaky(ch, ch * 2, 3, **kw)

    def forward(self, x):
        route = self.body(x)
        return route, self.tip(route)


def _upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv3(nn.Layer):
    """YOLOv3: a DarkNet-53 backbone and three FPN heads."""

    def __init__(self, num_classes=80, anchors=None, anchor_masks=None,
                 depths=(1, 2, 8, 8, 4), *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.num_classes = int(num_classes)
        self.anchors = list(anchors or ANCHORS)
        self.anchor_masks = [list(m) for m in (anchor_masks or ANCHOR_MASKS)]
        self.backbone = DarkNet53(depths=depths, **kw)
        out_ch = [512, 256, 128]
        in_ch = [1024, 512 + 256, 256 + 128]
        self.blocks = nn.LayerList([
            YoloDetBlock(cin, ch, **kw) for cin, ch in zip(in_ch, out_ch)])
        self.routes = nn.LayerList([
            ConvBNLeaky(512, 256, 1, **kw), ConvBNLeaky(256, 128, 1, **kw)])
        na = len(self.anchor_masks[0])
        self.heads = nn.LayerList([
            nn.Conv2D(ch * 2, na * (5 + self.num_classes), 1, **kw)
            for ch in out_ch])

    def forward(self, x):
        """The raw head maps, [(B, A*(5+C), H/32, W/32), /16, /8]."""
        c3, c4, c5 = self.backbone(x)
        outs = []
        feat = c5
        for i, (block, head) in enumerate(zip(self.blocks, self.heads)):
            route, tip = block(feat)
            outs.append(head(tip))
            if i < 2:
                lateral = _upsample2x(self.routes[i](route))
                feat = torch.cat([lateral, (c4, c3)[i]], 1)
        return outs

    def loss(self, x, gt_box, gt_label, ignore_thresh=0.7):
        """The sum over the scales of the batch mean of ``yolov3_loss``."""
        outs = self(x)
        total = None
        for out, mask, down in zip(outs, self.anchor_masks, (32, 16, 8)):
            part = vops.yolov3_loss(
                out, gt_box, gt_label, anchors=self.anchors,
                anchor_mask=mask, class_num=self.num_classes,
                ignore_thresh=ignore_thresh, downsample_ratio=down,
            ).mean()
            total = part if total is None else total + part
        return total

    def decode(self, outs, img_size, conf_thresh=0.005):
        """``yolo_box`` on each scale: boxes (B, total, 4) and scores (B,
        total, C)."""
        boxes, scores = [], []
        for out, mask, down in zip(outs, self.anchor_masks, (32, 16, 8)):
            sel = []
            for m in mask:
                sel += self.anchors[2 * m: 2 * m + 2]
            b, s = vops.yolo_box(
                out, img_size, anchors=sel, class_num=self.num_classes,
                conf_thresh=conf_thresh, downsample_ratio=down)
            boxes.append(b)
            scores.append(s)
        return torch.cat(boxes, 1), torch.cat(scores, 1)


class YOLOv3Postprocess(nn.Layer):
    """Images to padded (B, keep_top_k, 6) detections [class, score, x1,
    y1, x2, y2] (-1 rows past the kept ones), through matrix NMS."""

    def __init__(self, model, img_hw=(416, 416), score_threshold=0.05,
                 nms_top_k=100, keep_top_k=100):
        super().__init__()
        self.model = model
        self.img_hw = tuple(img_hw)
        self.score_threshold = float(score_threshold)
        self.nms_top_k = int(nms_top_k)
        self.keep_top_k = int(keep_top_k)

    def forward(self, x):
        b = x.shape[0]
        img_size = torch.tensor([self.img_hw], dtype=torch.int32,
                                device=x.device).repeat(b, 1)
        outs = self.model(x)
        boxes, scores = self.model.decode(outs, img_size)
        dets = []
        for i in range(b):  # one NMS an image
            out, _, _ = vops.matrix_nms(
                boxes[i], scores[i].transpose(0, 1),
                score_threshold=self.score_threshold,
                nms_top_k=self.nms_top_k, keep_top_k=self.keep_top_k)
            dets.append(out)
        return torch.stack(dets, 0)


def yolov3_darknet53(num_classes=80, **kw):
    return YOLOv3(num_classes=num_classes, **kw)

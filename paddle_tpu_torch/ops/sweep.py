"""Inputs for the op sweep: every op of ``registry.all_ops()`` that the spec
table or the case list here can feed, run on one device and held against
the same function on another (``chip_smoke.py`` phase 18a runs it on the
card against the CPU), and the one-input ops the per-op cost table times
(phase 18b).

- The table ops take the reference sweep's own sampler
  (``tests/test_op_sweep.py``: domains ``any``, ``pos``, ``unit``,
  ``smallint``, ``index``; shapes ``sq`` 4 x 4, ``vec`` 6, default 2 x 3;
  its bespoke inputs for ``bucketize``, ``isin``, ``argwhere``,
  ``matrix_exp``, ``matrix_norm`` and ``lu_unpack``; seed 7).
- Every other op has a case in ``CASES``: ``(args, kwargs)`` built by a
  function of ``t``, which puts a numpy array on the device under test.
- ``RANDOM`` ops draw from a generator and are held by their moments in
  the CPU tests, not here; ``NONUNIQUE`` ops' results are unique only up to
  signs, phases or order, and are held by their identities (phase 18c).
"""
from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from . import generated

_SHAPES = {"sq": (4, 4), "vec": (6,), None: (2, 3)}


def _shape_of(val):
    if val is None:
        return _SHAPES[None]
    if isinstance(val, str):
        return _SHAPES.get(val, _SHAPES[None])
    return tuple(val)


def sample(domain, shape, rng):
    if domain == "pos":
        return (rng.rand(*shape) + 0.5).astype(np.float32)
    if domain == "unit":
        return (rng.rand(*shape) * 0.8 + 0.1).astype(np.float32)
    if domain == "smallint":
        return rng.randint(0, 3, shape).astype(np.int32)
    if domain == "index":
        return rng.randint(0, 2, shape).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


def _custom_inputs(name, rng):
    if name == "bucketize":
        return [rng.randn(2, 3).astype(np.float32),
                np.sort(rng.randn(5).astype(np.float32))]
    if name == "isin":
        return [rng.randint(0, 4, (2, 3)).astype(np.int32),
                rng.randint(0, 4, (4,)).astype(np.int32)]
    if name == "argwhere":
        return [(rng.rand(2, 3) > 0.5).astype(np.float32)]
    if name == "matrix_exp":
        return [(rng.randn(3, 3) * 0.1).astype(np.float32)]
    if name in ("matrix_norm", "lu_unpack"):
        return [rng.randn(3, 3).astype(np.float32)]
    return None


def spec_inputs(spec, rng):
    """The reference sweep's inputs for one table entry (numpy arrays)."""
    custom = _custom_inputs(spec["name"], rng)
    if custom is not None:
        return custom
    args = spec.get("args", ["x"])
    if spec.get("variadic"):
        sh = _shape_of(spec.get("shape"))
        return [sample(spec.get("domain"), sh, rng) for _ in range(2)]
    inputs = []
    for i in range(len(args)):
        sh = _shape_of(spec.get("shape" if i == 0 else f"shape{i + 1}",
                                spec.get("shape")))
        dom = spec.get("domain" if i == 0 else f"domain{i + 1}",
                       spec.get("domain"))
        inputs.append(sample(dom, sh, rng))
    return inputs


def spec_cases():
    """{name: build(t) -> (args, kwargs)} for every runnable table entry."""
    out = {}
    for name, spec in sorted(generated.SPECS.items()):
        if spec.get("skip_test") or spec.get("alias_of"):
            continue
        inputs = spec_inputs(spec, np.random.RandomState(7))
        if spec.get("variadic"):
            out[name] = (lambda t, a=inputs: ([[t(v) for v in a]], {}))
        else:
            out[name] = (lambda t, a=inputs: ([t(v) for v in a], {}))
    return out


_R = np.random.RandomState(11)
X = _R.randn(4, 4).astype(np.float32)
Y = _R.randn(4, 4).astype(np.float32)
P = (_R.rand(4, 4) + 0.5).astype(np.float32)
U = (_R.rand(4, 4) * 0.8 + 0.1).astype(np.float32)
B3 = _R.randn(2, 3, 4).astype(np.float32)
I32 = _R.randint(1, 9, (4, 4)).astype(np.int32)
MASK = X > 0
IDX = np.array([3, 0, 2], np.int64)
SPD = (X @ X.T / 4 + np.eye(4)).astype(np.float32)
LOW = np.tril(X) + 3 * np.eye(4, dtype=np.float32)
VEC = _R.randn(6).astype(np.float32)
SEQ = _R.randn(3, 5, 4).astype(np.float32)
LEN = np.array([5, 0, 3], np.int64)
IDS = _R.randint(0, 6, (3, 5)).astype(np.int64)
SIG = _R.randn(2, 256).astype(np.float32)
WIN = np.hanning(64).astype(np.float32)
SPARSE = (X * (np.abs(X) > 0.6)).astype(np.float32)


def _pair(a, b):
    return lambda t: ([t(a), t(b)], {})


def _one(a, **kw):
    return lambda t: ([t(a)], kw)


def _sparse(fn_of_sparse):
    def build(t):
        from .. import sparse

        return fn_of_sparse(t, sparse)
    return build


# nn.functional inputs: an image, a sequence, a volume, logits and labels
IMG = _R.randn(2, 4, 6, 6).astype(np.float32)
SEQ1 = _R.randn(2, 4, 9).astype(np.float32)
VOL = _R.randn(1, 2, 4, 4, 4).astype(np.float32)
LOGITS = _R.randn(6, 5).astype(np.float32)
LAB = np.array([0, 3, 1, 4, 2, 1], np.int64)
SOFT = (np.exp(LOGITS) / np.exp(LOGITS).sum(1, keepdims=True)).astype(
    np.float32)
PROB = (_R.rand(6, 3) * 0.8 + 0.1).astype(np.float32)
Y01 = (_R.rand(6, 3) > 0.5).astype(np.float32)
PM1 = np.where(_R.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
W2 = (_R.randn(6, 4, 3, 3) * 0.3).astype(np.float32)
W1 = (_R.randn(6, 4, 3) * 0.3).astype(np.float32)
W3 = (_R.randn(4, 2, 2, 2, 2) * 0.3).astype(np.float32)
WT = (_R.randn(4, 3, 3, 3) * 0.3).astype(np.float32)
CH = (_R.rand(4) + 0.5).astype(np.float32)
THETA = np.array([[[0.9, 0.2, 0.1], [-0.1, 1.1, 0.0]]] * 2, np.float32)
GRID = (_R.rand(2, 3, 5, 2) * 2.4 - 1.2).astype(np.float32)
COLS = _R.randn(2, 8, 9).astype(np.float32)
CTC_IN = _R.randn(7, 2, 5).astype(np.float32)
POOL_IDX = np.array([[[[0, 3, 14], [19, 26, 30], [31, 33, 47]]] * 4] * 2,
                    np.int64)


def _img(*extra, **kw):
    return lambda t: ([t(IMG)] + list(extra), kw)


def _nn_cases():
    c = {
        "prelu": lambda t: ([t(IMG), t(CH)], {}),
        "maxout": _img(2),
        "bilinear": lambda t: ([t(X[:, :3]), t(Y[:, :2]), t(
            np.stack([X[:3, :2]] * 5)), t(VEC[:5])], {}),
        "channel_shuffle": _img(2),
        "cosine_similarity": _pair(X, Y),
        "fold": lambda t: ([t(COLS), [4, 4], 2], {"strides": 1}),
        "unfold": _img([3, 2], strides=2, paddings=1),
        "interpolate": _img(size=[4, 9], mode="bicubic"),
        "upsample": _img(scale_factor=0.5, mode="bilinear"),
        "label_smooth": _one(SOFT, epsilon=0.1),
        "one_hot": lambda t: ([t(LAB), 5], {}),
        "pad": _img([1, 2, 0, 1], mode="reflect"),
        "pixel_shuffle": _img(2),
        "pixel_unshuffle": _img(2),
        "conv1d": lambda t: ([t(SEQ1), t(W1), t(VEC)], {"padding": 1,
                                                        "stride": 2}),
        "conv2d": lambda t: ([t(IMG), t(W2), t(VEC)], {"padding": "SAME"}),
        "conv3d": lambda t: ([t(VOL), t(W3)], {"padding": [1, 0, 1]}),
        "conv1d_transpose": lambda t: ([t(SEQ1), t(W1[:4].transpose(
            0, 1, 2).copy())], {"stride": 2, "output_padding": 1}),
        "conv2d_transpose": lambda t: ([t(IMG), t(WT), t(VEC[:3])],
                                       {"stride": 2, "padding": 1}),
        "conv3d_transpose": lambda t: ([t(VOL), t(W3[:2])], {"stride": 2}),
        "max_pool1d": lambda t: ([t(SEQ1), 3], {"stride": 2,
                                                "ceil_mode": True}),
        "max_pool2d": _img(3, 2, 1),
        "max_pool3d": lambda t: ([t(VOL), 2], {}),
        "avg_pool1d": lambda t: ([t(SEQ1), 4], {"stride": 2, "padding": 1}),
        "avg_pool2d": _img(3, 2, ceil_mode=True),
        "avg_pool3d": lambda t: ([t(VOL), 2], {"padding": 1,
                                               "exclusive": False}),
        "adaptive_avg_pool1d": lambda t: ([t(SEQ1), 4], {}),
        "adaptive_avg_pool2d": _img([4, 5]),
        "adaptive_avg_pool3d": lambda t: ([t(VOL), 3], {}),
        "adaptive_max_pool1d": lambda t: ([t(SEQ1), 4], {}),
        "adaptive_max_pool2d": _img([4, 5]),
        "adaptive_max_pool3d": lambda t: ([t(VOL), 3], {}),
        "batch_norm": lambda t: ([t(IMG), t(np.zeros(4, np.float32)),
                                  t(np.ones(4, np.float32)), t(CH),
                                  t(VEC[:4])], {"training": True}),
        "group_norm": _img(2),
        "local_response_norm": _img(3),
        "spectral_norm": lambda t: ([t(W2)], {"power_iters": 2}),
        "cross_entropy": lambda t: ([t(LOGITS), t(LAB)],
                                    {"label_smoothing": 0.1}),
        "softmax_with_cross_entropy": lambda t: ([t(LOGITS), t(SOFT)],
                                                 {"soft_label": True}),
        "nll_loss": lambda t: ([t(np.log(SOFT)), t(LAB)], {}),
        "binary_cross_entropy": _pair(PROB, Y01),
        "binary_cross_entropy_with_logits": lambda t: (
            [t(X[:, :3]), t(Y01[:4])], {"pos_weight": t(CH[:3])}),
        "kl_div": _pair(np.log(SOFT), SOFT[::-1].copy()),
        "margin_ranking_loss": lambda t: ([t(VEC), t(VEC[::-1].copy()),
                                           t(PM1)], {}),
        "hinge_embedding_loss": _pair(VEC, PM1),
        "cosine_embedding_loss": lambda t: ([t(PROB), t(Y01), t(PM1)], {}),
        "triplet_margin_loss": lambda t: ([t(X), t(Y), t(P)], {}),
        "log_loss": _pair(PROB, Y01),
        "ctc_loss": lambda t: ([t(CTC_IN),
                                t(np.array([[1, 1, 3], [2, 4, 0]])),
                                t(np.array([7, 5])), t(np.array([3, 2]))],
                               {}),
        "sigmoid_focal_loss": _pair(X[:, :3], Y01[:4]),
        "hsigmoid_loss": lambda t: ([t(X), t(LAB[:4]), 5, t(np.concatenate(
            [X, Y])[:4])], {}),
        "margin_cross_entropy": lambda t: ([t(np.tanh(LOGITS)), t(LAB)],
                                           {"scale": 8.0}),
        **{n: _pair(X, Y) for n in ("mse_loss", "l1_loss",
                                    "smooth_l1_loss", "square_error_cost")},
        "affine_grid": lambda t: ([t(THETA), [2, 4, 5, 3]], {}),
        "grid_sample": lambda t: ([t(IMG), t(GRID)],
                                  {"padding_mode": "reflection",
                                   "align_corners": False}),
        "sequence_mask": lambda t: ([t(np.array([3, 0, 5]))], {}),
        "temporal_shift": _img(2),
        "zeropad2d": _img([1, 0, 2, 1]),
        "pairwise_distance": _pair(X, Y),
        "npair_loss": lambda t: ([t(X), t(Y), t(np.array([0, 1, 0, 2]))],
                                 {}),
        "dice_loss": lambda t: ([t(SOFT), t(LAB[:, None])], {}),
        "gather_tree": lambda t: ([t(IDS.T.reshape(5, 3, 1).repeat(2, 2)),
                                   t(np.zeros((5, 3, 2), np.int64))], {}),
        "max_unpool1d": lambda t: ([t(SEQ1[..., :3]), t(POOL_IDX[0, :, 0]
                                                        [None].repeat(2, 0)),
                                    2], {"output_size": [48]}),
        "max_unpool2d": lambda t: ([t(IMG[..., :3, :3]), t(POOL_IDX), 2],
                                   {"output_size": [6, 8]}),
        "max_unpool3d": lambda t: ([t(VOL[..., :2, :2, :2]), t(
            np.arange(8).reshape(1, 1, 2, 2, 2).repeat(2, 1) * 7), 2], {}),
    }
    return {f"functional.{k}": v for k, v in c.items()}


_NN_CASES = _nn_cases()


def _boxes(rng, n, scale=1.0):
    """``n`` valid xyxy boxes in [0, scale)."""
    lo = rng.rand(n, 2) * 0.6
    hi = lo + 0.1 + rng.rand(n, 2) * 0.3
    return (np.concatenate([lo, hi], 1) * scale).astype(np.float32)


def _vision_cases():
    """``vision.ops`` at small detection shapes (every array drawn once,
    so each device gets the same inputs)."""
    r = np.random.RandomState(21)
    feat = r.randn(2, 8, 8, 8).astype(np.float32)
    rois, num = _boxes(r, 3, 8.0), np.array([2, 1], np.int32)
    head = r.randn(1, 2 * 7, 4, 4).astype(np.float32)
    yolo_x = r.randn(2, 3 * 7, 4, 4).astype(np.float32)
    gt = np.concatenate([r.rand(2, 3, 2) * 0.8 + 0.1,
                         r.rand(2, 3, 2) * 0.3 + 0.05], -1).astype(np.float32)
    gl = np.array([[0, 1, -1], [1, -1, -1]], np.int32)
    boxes8, scores = _boxes(r, 8), r.rand(3, 8).astype(np.float32)
    b6, s6 = _boxes(r, 6), r.rand(6).astype(np.float32)
    b4, t4 = _boxes(r, 4), _boxes(r, 4)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    fpn, b3, clip = _boxes(r, 6, 600.0), _boxes(r, 3), _boxes(r, 3, 40.0)
    off = r.randn(1, 18, 6, 6).astype(np.float32) * 0.7
    wd = r.randn(3, 4, 3, 3).astype(np.float32) * 0.3
    dist = r.rand(3, 5).astype(np.float32)
    tgt = r.randn(4, 3).astype(np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
               156, 198, 373, 326]
    c = {
        "nms": lambda t: ([t(b6)], {"iou_threshold": 0.5, "scores": t(s6)}),
        "box_coder": lambda t: ([t(b4), t(var), t(t4)], {}),
        "roi_align": lambda t: ([t(feat[:1]), t(rois), t(num[:1] + 2), 2],
                                {"spatial_scale": 0.9}),
        "yolo_box": lambda t: ([t(head), t(np.array([[64, 60]], np.int32)),
                                [10, 13, 16, 30], 2, 0.01, 16], {}),
        "roi_pool": lambda t: ([t(feat), t(rois), t(num), 2], {}),
        "psroi_pool": lambda t: ([t(feat), t(rois), t(num), 2], {}),
        "prior_box": lambda t: ([t(feat[:1, :2, :4, :4]), t(np.zeros(
            (1, 3, 32, 32), np.float32)), [8.0]], {
                "max_sizes": [16.0], "aspect_ratios": [2.0], "flip": True}),
        "distribute_fpn_proposals": lambda t: ([t(fpn), 2, 5, 4, 224], {}),
        "deform_conv2d": lambda t: ([t(feat[:1, :4, :6, :6]), t(off),
                                     t(wd)], {"padding": 1}),
        "iou_similarity": lambda t: ([t(b3), t(b4)], {}),
        "box_clip": lambda t: ([t(clip), t(np.array([20.0, 30.0],
                                                    np.float32))], {}),
        "anchor_generator": lambda t: ([t(feat[:1, :2, :3, :4]), [16, 32],
                                        [0.5, 1.0], [8, 8]], {}),
        "density_prior_box": lambda t: ([t(feat[:1, :2, :3, :3]), t(
            np.zeros((1, 3, 24, 24), np.float32)), [2], [8.0], [1.0]], {}),
        "bipartite_match": lambda t: ([t(dist)], {}),
        "matrix_nms": lambda t: ([t(boxes8), t(scores), 0.1], {
            "nms_top_k": 5, "keep_top_k": 6}),
        "multiclass_nms": lambda t: ([t(boxes8), t(scores)], {
            "score_threshold": 0.1, "nms_top_k": 5, "keep_top_k": 6,
            "nms_threshold": 0.3}),
        "target_assign": lambda t: ([t(tgt), t(np.array([2, -1, 0, 3, -1]))],
                                    {}),
        "yolov3_loss": lambda t: ([t(yolo_x), t(gt), t(gl), anchors,
                                   [0, 1, 2], 2], {"downsample_ratio": 8}),
    }
    return {f"vision.{k}": v for k, v in c.items()}


_VISION_CASES = _vision_cases()


CASES = {
    **_VISION_CASES,
    # binary elementwise and comparisons
    **{n: _pair(X, Y) for n in (
        "add", "subtract", "multiply", "maximum", "minimum", "fmax", "fmin",
        "atan2", "hypot", "copysign", "nextafter", "heaviside", "equal",
        "not_equal", "greater_than", "greater_equal", "less_than",
        "less_equal", "allclose", "isclose", "equal_all", "dist", "dot",
        "inner", "outer", "kron", "matmul", "matmul_v2", "mm",
        "elementwise_add", "elementwise_sub", "elementwise_mul", "minus",
        "expand_as", "expand_as_v2")},
    **{n: _pair(X, P) for n in (
        "divide", "true_divide", "elementwise_div", "floor_divide",
        "elementwise_floordiv", "remainder", "mod", "floor_mod", "pow")},
    **{n: _pair(I32, I32 % 5 + 1) for n in (
        "gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor")},
    **{n: _pair(MASK, X < 0.5) for n in (
        "logical_and", "logical_or", "logical_xor")},
    "ldexp": _pair(X, I32 % 4),
    "lerp": lambda t: ([t(X), t(Y), 0.3], {}),
    "bmm": _pair(B3, np.swapaxes(B3, 1, 2).copy()),
    "addmm": lambda t: ([t(P), t(X), t(Y)], {"beta": 0.5, "alpha": 2.0}),
    "mv": _pair(X, VEC[:4]),
    "einsum": lambda t: (["bij,bjk->bik", t(B3),
                          t(np.swapaxes(B3, 1, 2).copy())], {}),
    # incubate
    "incubate.softmax_mask_fuse": _pair(
        B3, (np.arange(24).reshape(2, 3, 4) % 3 == 0).astype(np.float32)
        * -1e4),
    "incubate.graph_send_recv": lambda t: (
        [t(X), t(np.array([0, 1, 2, 3, 1])), t(np.array([1, 1, 0, 3, 2]))],
        {"pool_type": "mean"}),
    # shapes and indices
    **{n: (lambda t: ([t(B3), [4, -1]], {})) for n in ("reshape", "view")},
    **{n: (lambda t: ([t(X[:1]), [3, 4, 4]], {})) for n in (
        "expand", "expand_v2", "broadcast_to")},
    **{n: (lambda t: ([t(X), [2, 1, 3]], {})) for n in ("tile", "repeat")},
    "repeat_interleave": lambda t: ([t(X), 2], {"axis": 1}),
    "flip": lambda t: ([t(B3), [0, 2]], {}),
    "reverse": lambda t: ([t(B3), [1]], {}),
    "roll": lambda t: ([t(X), 1], {"axis": 0}),
    "transpose": lambda t: ([t(B3), [2, 0, 1]], {}),
    **{n: (lambda t: ([t(B3), 0, 2], {})) for n in ("swapaxes",
                                                     "transpose_")},
    "moveaxis": lambda t: ([t(B3), 0, -1], {}),
    "unsqueeze": lambda t: ([t(X), [0, 2]], {}),
    "split": lambda t: ([t(B3), [1, -1]], {"axis": 1}),
    "chunk": lambda t: ([t(X), 2], {"axis": 1}),
    "slice": lambda t: ([t(B3), [1, 2], [0, -3], [2, -1]], {}),
    "strided_slice": lambda t: ([t(B3), [1, 2], [2, 0], [0, 4], [-1, 2]],
                                {}),
    "pad": lambda t: ([t(B3[None]), [1, 2, 0, 1]], {"mode": "reflect"}),
    "cast": lambda t: ([t(X), "float64"], {}),
    "gather": lambda t: ([t(X), t(IDX)], {"axis": 1}),
    "gather_nd": lambda t: ([t(B3), t(np.array([[0, 2], [1, 1]]))], {}),
    "index_select": lambda t: ([t(X), t(IDX)], {"axis": 0}),
    "index_sample": lambda t: ([t(X), t(np.array([[0, 3], [1, 1], [2, 0],
                                                  [3, 2]]))], {}),
    "take_along_axis": lambda t: ([t(X), t(np.argsort(X, 1)[:, :2]), 1],
                                  {}),
    "put_along_axis": lambda t: ([t(X), t(np.array([[0], [2], [1], [3]])),
                                  t(Y[:, :1]), 1], {"reduce": "add"}),
    "scatter": lambda t: ([t(X), t(np.array([2, 0])), t(Y[:2])], {}),
    "scatter_nd_add": lambda t: ([t(X), t(np.array([[0, 1], [2, 3]])),
                                  t(VEC[:2])], {}),
    "scatter_nd": lambda t: ([t(np.array([[1], [3]])), t(Y[:2]), [5, 4]],
                             {}),
    "index_add": lambda t: ([t(X), t(np.array([0, 2])), 0, t(Y[:2])], {}),
    "masked_fill": lambda t: ([t(X), t(MASK), 2.0], {}),
    "masked_select": lambda t: ([t(X), t(MASK)], {}),
    "where": lambda t: ([t(MASK), t(X), t(Y)], {}),
    "getitem": lambda t: ([t(B3), (1, slice(None), [0, 2])], {}),
    "setitem": lambda t: ([t(X), (slice(0, 2), 1), 7.0], {}),
    "searchsorted": lambda t: ([t(np.sort(X, 1)), t(Y)], {}),
    **{n: (lambda t: ([t(X), 2], {})) for n in ("topk", "top_k")},
    "quantile": lambda t: ([t(X), [0.25, 0.75]], {"axis": 1}),
    "matrix_power": lambda t: ([t(X), 3], {}),
    **{n: (lambda t: ([t(X), 1.5], {})) for n in ("full_like",
                                                   "fill_any_like")},
    "shard_index": lambda t: ([t(np.array([[1], [6], [12], [19]])), 20, 2,
                               1], {}),
    "multiplex": lambda t: ([[t(X), t(Y)], t(np.array([[1], [0], [1],
                                                       [0]]))], {}),
    **{f"segment_{r}": (lambda t: ([t(SEQ[0]), t(np.array(
        [0, 0, 2, 2, 3]))], {})) for r in ("sum", "mean", "max", "min")},
    "accuracy_tensor": lambda t: ([t(X), t(np.array([3, 0, 1, 1]))], {}),
    "atleast_1d": lambda t: ([t(np.float32(2.0)), t(VEC)], {}),
    "atleast_2d": _one(VEC),
    "atleast_3d": _one(X),
    "meshgrid": lambda t: ([t(VEC[:3]), t(VEC[3:])], {}),
    "row_stack": lambda t: ([t(X), t(Y)], {}),
    "where_index": _one(MASK.astype(np.float32)),
    "broadcast_tensors": lambda t: ([[t(X[:1]), t(B3[:, :1])]], {}),
    # linear algebra
    "solve": _pair(SPD, X[:, :2]),
    "cholesky_solve": _pair(X[:, :2], np.linalg.cholesky(SPD).astype(
        np.float32)),
    "triangular_solve": lambda t: ([t(LOW), t(X[:, :2])], {"upper": False}),
    "lstsq": _pair(np.concatenate([X, Y]), np.concatenate([P, U])[:, :2]),
    "householder_product": _pair(np.concatenate([X, Y])[:, :3], U[0, :3]),
    "multi_dot": lambda t: ([[t(X), t(Y), t(P)]], {}),
    # creation from scalars
    "arange": lambda t: ([0.0, 3.0, 0.5], {}),
    "range": lambda t: ([7], {}),
    "linspace": lambda t: ([-1.0, 2.0, 7], {}),
    "logspace": lambda t: ([0.0, 2.0, 5], {}),
    "eye": lambda t: ([3, 4], {}),
    "full": lambda t: ([[2, 3], 1.5], {}),
    **{n: (lambda t: ([[2, 3]], {})) for n in ("zeros", "ones", "empty")},
    "fft.fftfreq": lambda t: ([7, 0.5], {}),
    "fft.rfftfreq": lambda t: ([8], {}),
    # control flow
    "cond": lambda t: ([t(np.array(True)), (lambda: t(X) * 2),
                        (lambda: t(Y))], {}),
    "case": lambda t: ([[(t(np.array(False)), lambda: t(X)),
                         (t(np.array(True)), lambda: t(Y))]], {}),
    "switch_case": lambda t: ([t(np.array(1)), [lambda: t(X),
                                                lambda: t(Y)]], {}),
    "while_loop": lambda t: ([lambda i, s: i < 3,
                              lambda i, s: [i + 1, s * 1.5],
                              [t(np.array(0)), t(X)]], {}),
    # sequences, metrics, signal
    **{f"sequence.sequence_{n}": (lambda t: ([t(SEQ), t(LEN)], {}))
       for n in ("softmax", "pool", "reverse", "first_step", "last_step",
                 "unpad")},
    "sequence.sequence_pad": lambda t: ([t(SEQ[0]), t(np.array([2, 3])), 4],
                                        {}),
    "sequence.sequence_expand": lambda t: ([t(X[:3]), t(LEN), 5], {}),
    "sequence.sequence_expand_as": lambda t: ([t(X[:3]), t(SEQ), t(LEN)],
                                              {}),
    "sequence.sequence_concat": lambda t: ([t(SEQ), t(LEN), t(SEQ),
                                            t(LEN[::-1].copy())], {}),
    "sequence.sequence_slice": lambda t: ([t(SEQ), t(LEN),
                                           t(np.array([1, 0, 1])),
                                           t(np.array([2, 1, 5]))], {}),
    "sequence.sequence_erase": lambda t: ([t(IDS), t(LEN), [1, 3]], {}),
    "sequence.sequence_enumerate": lambda t: ([t(IDS), t(LEN), 3], {}),
    "sequence.sequence_reshape": lambda t: ([t(SEQ), t(LEN), 2], {}),
    "sequence.sequence_scatter": lambda t: ([t(SEQ[:, :, 0]),
                                             t(np.array([[0, 4], [1, 1],
                                                         [2, 0]])),
                                             t(X[:3, :2]),
                                             t(np.array([2, 1, 0]))], {}),
    "sequence.sequence_topk_avg_pooling": lambda t: ([t(SEQ[:, :, 0]),
                                                      t(LEN), [1, 3]], {}),
    "sequence.sequence_conv": lambda t: ([t(SEQ), t(LEN), t(
        np.concatenate([X, Y, P])[:, :2])], {}),
    "metric.auc": lambda t: ([t(np.round(U.ravel(), 1)), t(
        (X.ravel() > 0).astype(np.int64))], {}),
    "metric.edit_distance": lambda t: ([t(IDS), t(LEN), t(IDS[::-1].copy()),
                                        t(LEN[::-1].copy())], {}),
    "metric.mean_iou": lambda t: ([t(I32 % 4), t(I32 % 3), 4], {}),
    "metric.precision_recall": lambda t: ([t(I32 % 4), t(I32 % 3), 4], {}),
    "metric.positive_negative_pair": lambda t: ([t(np.round(U.ravel(), 1)),
                                                 t(I32.ravel() % 3),
                                                 t(np.arange(16) // 4)], {}),
    "signal.frame": lambda t: ([t(SIG), 64, 16], {}),
    "signal.overlap_add": lambda t: ([t(SEQ), 2], {}),
    "signal.stft": lambda t: ([t(SIG), 64], {"hop_length": 16,
                                             "window": t(WIN)}),
    "signal.istft": lambda t: ([torch.complex(t(SEQ[:, :, :3]),
                                              t(SEQ[:, :, 1:])), 8],
                               {"hop_length": 2}),
    # functional
    "functional.linear": lambda t: ([t(X), t(Y), t(VEC[:4])], {}),
    "functional.embedding": lambda t: ([t(IDS), t(np.concatenate([X, Y]))],
                                       {}),
    "functional.layer_norm": lambda t: ([t(B3), [4], t(VEC[:4]),
                                         t(VEC[2:])], {}),
    "functional.cross_entropy": lambda t: ([t(X), t(np.array([3, 0, 1,
                                                              2]))], {}),
    "functional.fused_linear_cross_entropy": lambda t: (
        [t(X), t(np.concatenate([X, Y])), t(np.array([3, 0, 1, 2]))], {}),
    **{f"functional.{n}": (lambda t: (
        [t(SEQ[None]), t(SEQ[None][:, ::-1].copy()), t(SEQ[None])],
        {"is_causal": True})) for n in ("scaled_dot_product_attention",
                                        "flash_attention")},
    # nn.functional: activations, common, convolutions, pools, norms,
    # losses and vision ops at small shapes
    **_NN_CASES,
    # sparse (on dense inputs turned sparse by the op under test's module)
    "sparse.add": _sparse(lambda t, sp: ([sp.to_sparse_coo(t(SPARSE)),
                                          sp.to_sparse_coo(t(SPARSE.T))],
                                         {})),
    "sparse.multiply": _sparse(lambda t, sp: ([sp.to_sparse_csr(t(SPARSE)),
                                               t(Y)], {})),
    "sparse.matmul": _sparse(lambda t, sp: ([sp.to_sparse_coo(t(SPARSE)),
                                             t(Y)], {})),
    "sparse.masked_matmul": _sparse(lambda t, sp: (
        [t(X), t(Y), sp.to_sparse_coo(t(SPARSE))], {})),
    "sparse.pow": _sparse(lambda t, sp: ([sp.to_sparse_coo(t(SPARSE)), 2.0],
                                         {})),
    "sparse.sparse_coo_tensor": lambda t: ([t(np.array([[0, 1, 3], [2, 0,
                                                                    1]])),
                                            t(VEC[:3]), [4, 4]], {}),
    "sparse.sparse_csr_tensor": lambda t: ([t(np.array([0, 1, 1, 3, 3])),
                                            t(np.array([2, 0, 3])),
                                            t(VEC[:3]), [4, 4]], {}),
    "sparse.SelectedRows": lambda t: ([t(np.array([3, 1, 3])), t(Y[:3]),
                                       5], {}),
    **{f"sparse.{n}": _sparse(lambda t, sp: ([sp.to_sparse_coo(t(SPARSE))],
                                             {}))
       for n in ("relu", "sin", "tanh", "abs", "neg", "cast", "softmax")},
    "sparse.sqrt": _sparse(lambda t, sp: ([sp.to_sparse_coo(t(np.abs(
        SPARSE)))], {})),
    # one-input ops whose input is not a float matrix
    "as_real": lambda t: ([torch.complex(t(X), t(Y))], {}),
    "bincount": _one(I32.ravel()),
    **{n: _one(I32) for n in ("bitwise_not", "bitwise_invert")},
    "cholesky": _one(SPD),
    "clip": lambda t: ([t(X), -0.5, 0.5], {}),
    # the table entries the reference sweep's sampler skips
    "im2sequence": _one(_R.randn(2, 3, 4, 4).astype(np.float32)),
    "index_put": lambda t: ([t(X), t(np.array([2, 0])), t(Y[:2])], {}),
    "masked_scatter": lambda t: ([t(X), t(MASK.astype(np.float32)), t(Y)],
                                 {}),
    "fill_diagonal_tensor": _pair(X, VEC[:4]),
    "dpsgd": _pair(X, Y),
}

# the in-place variants: the extra arguments after the tensor
INPLACE_ARGS = {
    "add_": [Y], "subtract_": [Y], "multiply_": [Y], "divide_": [P],
    "remainder_": [P], "pow_": [2.0], "clip_": [-0.5, 0.5], "scale_": [2.0],
    "lerp_": [Y, 0.25], "cast_": ["float64"], "reshape_": [[2, 8]],
    "unsqueeze_": [0], "triu_": [1], "masked_fill_": [MASK, 2.0],
    "index_add_": [np.array([0, 2]), 0, Y[:2]],
    "put_along_axis_": [np.array([[0], [1], [2], [3]]), 5.0, 1],
    "scatter_": [np.array([1]), Y[:1]], "fill_": [1.5],
}


def _inplace_case(name):
    src = P if name.rstrip("_") in _POSITIVE else X
    extra = INPLACE_ARGS.get(name, [])
    return lambda t: ([t(src)] + [t(a) if isinstance(a, np.ndarray) else a
                                  for a in extra], {})

# hand-written CUDA kernels: each is held against its plain version by
# chip_smoke.py's phase 2
KERNELS = {"functional.flash_attention",
           "functional.scaled_dot_product_attention"}
RANDOM = {
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "gaussian", "standard_normal", "bernoulli", "multinomial",
    "poisson", "uniform_random", "gaussian_random", "uniform_", "normal_",
    "exponential_", "functional.dropout", "functional.dropout2d",
    "functional.dropout3d", "functional.alpha_dropout",
    "functional.gumbel_softmax", "functional.class_center_sample",
    "incubate.graph_khop_sampler",
}
# results unique only up to signs, phases or order (held in phase 18c);
# lstsq's solvers differ (gelsd here, gels on the card)
NONUNIQUE = {"svd", "qr", "eig", "eigh", "eigvals", "lstsq"}
# not ops over tensors: host queries and state
HOST = {"is_tensor", "is_floating_point", "is_integer", "is_complex",
        "tolist", "set_printoptions", "disable_signal_handler",
        "is_compiled_with_cinn", "is_compiled_with_rocm",
        "is_compiled_with_xpu", "is_compiled_with_npu",
        "is_compiled_with_mlu", "is_compiled_with_ipu", "get_cuda_rng_state",
        "set_cuda_rng_state", "create_parameter", "broadcast_shape",
        "builtins_sum", "sparse.SparseCooTensor", "sparse.SparseCsrTensor"}
# one-input ops whose input wants a domain other than the normal one
_POSITIVE = {"log", "log2", "log10", "sqrt", "rsqrt", "lgamma", "digamma",
             "reciprocal", "acosh", "cond", "logit", "renorm",
             "fill_diagonal"}


def one_input(name, fn):
    """Whether ``fn`` takes one tensor: one required positional parameter
    named like a tensor, or a table entry with one tensor argument."""
    spec = generated.SPECS.get(name)
    if spec is not None and fn is generated.GENERATED.get(name) \
            and not spec.get("alias_of"):
        return spec.get("args", ["x"]) == ["x"] and not spec.get("variadic")
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    req = [p for p in sig.parameters.values()
           if p.default is p.empty and p.kind in (p.POSITIONAL_ONLY,
                                                  p.POSITIONAL_OR_KEYWORD)]
    var = any(p.kind == p.VAR_POSITIONAL for p in sig.parameters.values())
    return len(req) == 1 and req[0].name in ("x", "input", "self") \
        and not var


def cases(ops):
    """(cases, skipped): ``cases`` maps each op name of ``ops`` this module
    can feed to ``build(t) -> (args, kwargs)``; ``skipped`` maps the rest to
    the reason, by name."""
    from . import inplace

    table = spec_cases()
    out, skipped = {}, {}
    for name, fn in sorted(ops.items()):
        spec = generated.SPECS.get(name)
        if spec is not None and spec.get("alias_of") \
                and name not in CASES:
            # an alias runs its target's case
            target = spec["alias_of"]
            if target in table or target in CASES:
                out[name] = table.get(target) or CASES[target]
                continue
        if name in RANDOM:
            skipped[name] = "random: held by moments in the CPU tests"
        elif name in KERNELS:
            skipped[name] = "CUDA kernel: held in phase 2"
        elif name in HOST:
            skipped[name] = "host query or state, no tensor op"
        elif name in table:
            out[name] = table[name]
        elif name in CASES:
            out[name] = CASES[name]
        elif name in inplace.INPLACE_OPS:
            out[name] = _inplace_case(name)
        elif one_input(name, fn):
            out[name] = _one(P if name.rstrip("_") in _POSITIVE
                             or name.split(".")[-1] in _POSITIVE else X)
        else:
            skipped[name] = "no case"
    return out, skipped


# the special functions, held at rtol and atol 1e-3
SPECIAL = {"digamma", "lgamma", "polygamma", "gammainc", "gammaincc",
           "gammaln", "i0e", "i1e", "ndtri", "log_ndtr", "erfinv", "i0",
           "i1", "matrix_exp", "digamma_", "lgamma_", "erfinv_"}


class _Device:
    """``set_device(dev)`` for the block (creation ops land there)."""

    def __init__(self, dev):
        self.dev = torch.device(dev)

    def __enter__(self):
        from ..core import place

        self.had = getattr(place._state, "place", None)
        place.set_device("cpu" if self.dev.type == "cpu"
                         else f"gpu:{self.dev.index or 0}")

    def __exit__(self, *exc):
        from ..core import place

        if self.had is None:
            place._state.__dict__.pop("place", None)
        else:
            place._state.place = self.had


def _feeder(dev, dtype=None, grad=None):
    """``t``: a numpy array as a tensor on ``dev`` (floating ones in
    ``dtype`` when given; leaves that record gradients into ``grad``)."""
    def t(a):
        x = torch.tensor(np.asarray(a), device=dev)  # a copy: ops write
        if x.is_floating_point():
            if dtype is not None:
                x = x.to(dtype)
            if grad is not None:
                x.requires_grad_(True)
                grad.append(x)
        return x
    return t


def _leaves(out):
    """The tensors of an op's output; sparse results dense."""
    from .. import sparse

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (sparse.SparseTensor, sparse.SelectedRows)):
        return [out.to_dense()]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    if isinstance(out, (bool, int, float)):
        return [torch.tensor(out)]
    raise TypeError(f"unexpected output {type(out).__name__}")


def _same(name, a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_complex():
        return bool((a - b).abs().max() <= 1e-5 + 1e-4 * b.abs().max()) \
            if a.numel() else True
    if a.is_floating_point():
        tol = 1e-3 if name in SPECIAL else None
        return torch.allclose(a.double(), b.double(), rtol=tol or 1e-4,
                              atol=tol or 1e-5, equal_nan=True)
    return torch.equal(a, b)


def _call(fn, build, dev, dtype=None, grad=None):
    t = _feeder(dev, dtype, grad)
    with _Device(dev):
        args, kwargs = build(t)
        return _leaves(fn(*args, **kwargs))


def run(ops, dev, ref="cpu", bf16=True, grads=True):
    """Every op of ``ops`` this module can feed, run on ``dev`` in float32
    and held against the same function on ``ref``; its backward (the first
    floating output's sum) on both, gradients held the same way; and, with
    ``bf16``, a run on ``dev`` with bfloat16 inputs whose outputs must be
    finite where the float32 ones are. Returns the counts and, by name, the
    mismatches, what was skipped and each op's seconds."""
    fed, skipped = cases(ops)
    rep = {"ops": 0, "grads": 0, "bf16": 0, "mismatches": {},
           "bf16_nonfinite": [], "bf16_unsupported": [],
           "grad_unsupported": [], "nonunique": [], "skipped": skipped,
           "seconds": {}}
    for name, build in fed.items():
        t0 = time.perf_counter()
        _check(name, ops[name], build, dev, ref, bf16, grads, rep)
        rep["seconds"][name] = time.perf_counter() - t0
    return rep


def _check(name, fn, build, dev, ref, bf16, grads, rep):
    """One op of :func:`run`: its runs, comparisons and counts."""
    from . import inplace

    try:
        want = _call(fn, build, ref)
    except Exception as e:  # the case cannot run anywhere: a fault
        rep["mismatches"][name] = f"{ref}: {type(e).__name__}: {e}"
        return
    try:
        got = _call(fn, build, dev)
    except Exception as e:
        rep["mismatches"][name] = f"{dev}: {type(e).__name__}: {e}"
        return
    rep["ops"] += 1
    if len(got) != len(want):
        rep["mismatches"][name] = "output count"
        return
    if name in NONUNIQUE:
        rep["nonunique"].append(name)
        if not all(g.shape == w.shape and bool(torch.isfinite(
                g.detach().cpu()).all() or not g.is_floating_point())
                for g, w in zip(got, want)):
            rep["mismatches"][name] = "shape or non-finite"
        return
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not _same(name, g, w)]
    if bad:
        rep["mismatches"][name] = f"outputs {bad}"
        return
    if grads and name not in inplace.INPLACE_OPS \
            and name != "setitem" and not name.startswith("sparse."):
        _grad_check(name, fn, build, dev, ref, rep)
    if bf16 and any(w.is_floating_point() for w in want):
        _bf16_check(name, fn, build, dev, want, rep)


def _backward(fn, build, dev):
    leaves = []
    out = _call(fn, build, dev, grad=leaves)
    y = next((o for o in out if o.requires_grad), None)
    if y is None:
        return None
    y.float().sum().backward()
    return [x.grad for x in leaves]


def _grad_check(name, fn, build, dev, ref, rep):
    try:
        want = _backward(fn, build, ref)
    except RuntimeError:
        rep["grad_unsupported"].append(name)
        return
    if want is None:
        return
    got = _backward(fn, build, dev)
    for g, w in zip(got, want):
        if (g is None) != (w is None) or (
                g is not None and not _same(name, g, w)):
            rep["mismatches"][name] = "gradient"
            return
    rep["grads"] += 1


def _bf16_check(name, fn, build, dev, want, rep):
    try:
        got = _call(fn, build, dev, dtype=torch.bfloat16)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        rep["bf16_unsupported"].append(f"{name}: {type(e).__name__}")
        return
    rep["bf16"] += 1
    for g, w in zip(got, want):
        if not g.is_floating_point() or g.shape != w.shape:
            continue
        ok = torch.isfinite(g.detach().float().cpu()) | \
            ~torch.isfinite(w.detach().float().cpu())
        if not bool(ok.all()):
            rep["bf16_nonfinite"].append(name)
            return


__all__ = ["sample", "spec_inputs", "spec_cases", "CASES", "RANDOM",
           "NONUNIQUE", "HOST", "KERNELS", "SPECIAL", "one_input", "cases",
           "run"]

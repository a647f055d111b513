"""The port's ``vision.ops`` and YOLOv3 held against the reference's
(``paddle_tpu/vision/ops.py``, ``vision/models/yolov3.py``) on the same
numpy inputs, on the CPU, in float32.

- Each of the 18 registry ops runs on the inputs ``ops.sweep`` feeds it
  (the card's sweep, phase 18a, uses the same); outputs within rtol 1e-5,
  atol 1e-6, and for the differentiable ops the gradients of a weighted sum
  of the outputs within the same tolerance (atol 1e-5).
- ``density_prior_box`` and ``yolov3_loss`` come out float64 in the
  reference (a numpy float64 scalar and ``jnp.zeros`` under JAX's x64); the
  port keeps float32, so those two are held by value.
- The reference's own detection tests (``tests/test_detection_model.py``)
  mirrored on the port, and a tiny YOLOv3 (the reference's ``_tiny``:
  DarkNet depths 1 a stage, 4 classes, 64²) with the reference's weights:
  head maps, the loss, every parameter's gradient (by relative norm,
  1e-4: the reference's loss sums in float64) and the postprocessed
  detections.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.ops as RV
import paddle_tpu_torch as tp
from paddle_tpu.vision.models import YOLOv3 as RYOLOv3
from paddle_tpu.vision.models import YOLOv3Postprocess as RPost
from paddle_tpu_torch.ops import registry, sweep
from paddle_tpu_torch.vision import ops as PV
from paddle_tpu_torch.vision.models import YOLOv3, YOLOv3Postprocess
from torch_nn_util import A, carry, check, grad_rel
from torch_port_util import as_numpy, assert_same, cpu_device

# the reference marks these differentiable=False (or builds them in numpy)
NO_GRAD = {"nms", "yolo_box", "prior_box", "distribute_fpn_proposals",
           "anchor_generator", "density_prior_box", "bipartite_match",
           "matrix_nms", "multiclass_nms", "target_assign"}
# float64 in the reference, float32 in the port
BY_VALUE = {"density_prior_box", "yolov3_loss"}
NAMES = sorted(k.split(".", 1)[1] for k in sweep._VISION_CASES)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _case(name):
    args, kw = sweep._VISION_CASES[f"vision.{name}"](A)
    if name == "yolov3_loss":  # the ground truth is data, not a leaf
        args[1] = A(args[1].a, grad=False)
    return args, kw


def test_the_cases_are_the_registry_names():
    assert len(NAMES) == 18
    assert {f"vision.{n}" for n in NAMES} == {
        k for k in registry.all_ops() if k.startswith("vision.")}


@pytest.mark.parametrize("name", [n for n in NAMES if n not in BY_VALUE])
def test_op_matches_the_reference(name):
    args, kw = _case(name)
    check(getattr(RV, name), getattr(PV, name), args, kw,
          grad=name not in NO_GRAD, what=name)


def _values(out):
    out = out if isinstance(out, (list, tuple)) else [out]
    return [as_numpy(o)[0].astype(np.float32) for o in out]


@pytest.mark.parametrize("name", sorted(BY_VALUE))
def test_float64_reference_ops_match_by_value(name):
    args, kw = _case(name)
    jl, tl = [], []
    from torch_nn_util import _convert

    want = getattr(RV, name)(*_convert(args, jl, True), **kw)
    got = getattr(PV, name)(*_convert(args, tl, False), **kw)
    for g, w in zip(_values(got), _values(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    for o in (got if isinstance(got, tuple) else [got]):
        assert o.dtype == torch.float32
    if name == "yolov3_loss":  # the gradient of the summed loss, by value
        want.astype("float32").sum().backward()
        got.sum().backward()
        np.testing.assert_allclose(tl[0].grad.numpy(),
                                   as_numpy(jl[0].grad)[0], rtol=1e-4,
                                   atol=1e-5)


# -- the reference's detection tests on the port -------------------------------
def T(a):
    return torch.from_numpy(np.asarray(a))


def test_iou_box_clip_anchor_and_matching_values():
    a = np.array([[0, 0, 10, 10], [5, 5, 15, 15]], np.float32)
    b = np.array([[0, 0, 10, 10]], np.float32)
    iou = PV.iou_similarity(T(a), T(b)).numpy()
    assert abs(iou[0, 0] - 1.0) < 1e-6 and abs(iou[1, 0] - 25 / 175) < 1e-5
    out = PV.box_clip(T(np.array([[-5, -5, 20, 20]], np.float32)),
                      T(np.array([10.0, 12.0], np.float32)))
    np.testing.assert_allclose(out.numpy()[0], [0, 0, 11, 9])
    anc, _ = PV.anchor_generator(T(np.zeros((1, 8, 4, 6), np.float32)),
                                 [32.0], [1.0], [16, 16])
    assert tuple(anc.shape) == (4, 6, 1, 4)
    np.testing.assert_allclose(anc[0, 0, 0].numpy(), [-8, -8, 24, 24],
                               atol=1e-5)
    idx, val = PV.bipartite_match(T(np.array([[0.9, 0.1], [0.8, 0.7]],
                                             np.float32)))
    assert idx.tolist() == [0, 1]
    np.testing.assert_allclose(val.numpy(), [0.9, 0.7], atol=1e-6)


def test_matrix_nms_decays_duplicates_and_multiclass_equals_host_nms():
    boxes = np.array([[0, 0, 10, 10], [0.5, 0.5, 10.5, 10.5],
                      [50, 50, 60, 60]], np.float32)
    out, _, num = PV.matrix_nms(T(boxes), T(np.array([[0.9, 0.85, 0.8]],
                                                     np.float32)),
                                score_threshold=0.05)
    kept = {round(float(s), 4) for s in out[:3, 1] if s > 0}
    dup = sorted(kept - {0.9, 0.8})
    assert 0.9 in kept and 0.8 in kept and dup and dup[0] < 0.3
    rng = np.random.RandomState(0)
    base = rng.rand(8, 2) * 40
    boxes = np.concatenate([base, base + 20 + rng.rand(8, 2) * 10],
                           1).astype(np.float32)
    scores = rng.rand(1, 8).astype(np.float32)
    out, idx, num = PV.multiclass_nms(T(boxes), T(scores),
                                      score_threshold=0.0, nms_threshold=0.5)
    keep = PV.nms(T(boxes), 0.5, scores=T(scores[0]))
    assert sorted(i for i in idx.tolist() if i >= 0) == sorted(keep.tolist())
    assert int(num) == len(keep.tolist())


def test_deform_conv2d_layer_with_a_mask_and_groups():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 7, 7).astype(np.float32)
    off = (rng.randn(2, 2 * 2 * 9, 4, 4) * 0.8).astype(np.float32)
    mask = rng.rand(2, 2 * 9, 4, 4).astype(np.float32)
    w = (rng.randn(6, 2, 3, 3) * 0.3).astype(np.float32)
    kw = {"stride": 2, "padding": 1, "deformable_groups": 2, "groups": 2}
    check(lambda *a: RV.deform_conv2d(*a[:3], **kw, mask=a[3]),
          lambda *a: PV.deform_conv2d(*a[:3], **kw, mask=a[3]),
          [A(x), A(off), A(w), A(mask)], what="deform v2")
    layer = PV.DeformConv2D(4, 6, 3, stride=2, padding=1, groups=2,
                            device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    assert tuple(layer(T(x), T(off[:, :18])).shape) == (2, 6, 4, 4)


# -- YOLOv3 ---------------------------------------------------------------------
def _tiny_pair():
    paddle.seed(0)
    ref = RYOLOv3(num_classes=4, depths=(1, 1, 1, 1, 1))
    port = YOLOv3(num_classes=4, depths=(1, 1, 1, 1, 1), device="cpu")
    return ref, carry(ref, port)


def _yolo_data():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 64, 64) * 0.5).astype(np.float32)
    gt = np.zeros((2, 3, 4), np.float32)
    gt[:, 0] = [0.5, 0.5, 0.25, 0.4]
    gt[0, 1] = [0.2, 0.7, 0.1, 0.15]
    gl = np.full((2, 3), -1, np.int64)
    gl[:, 0] = 1
    gl[0, 1] = 3
    return x, gt, gl


def test_tiny_yolov3_forward_loss_backward_and_postprocess():
    ref, port = _tiny_pair()
    x, gt, gl = _yolo_data()
    ref.train()
    port.train()
    jl = ref.loss(paddle.to_tensor(x), paddle.to_tensor(gt),
                  paddle.to_tensor(gl))
    tl = port.loss(T(x), T(gt), T(gl))
    np.testing.assert_allclose(float(tl), float(jl.item()), rtol=1e-5)
    jl.backward()
    tl.backward()
    rel = grad_rel(ref, port)
    assert max(rel.values()) <= 1e-4, max(rel.items(), key=lambda kv: kv[1])
    ref.eval()
    port.eval()
    with torch.no_grad():
        outs = port(T(x))
    jouts = ref(paddle.to_tensor(x))
    assert [tuple(o.shape) for o in outs] == [
        (2, 27, 2, 2), (2, 27, 4, 4), (2, 27, 8, 8)]
    for o, j in zip(outs, jouts):
        assert_same(o, j, rtol=1e-4, atol=1e-5, what="head")
    with torch.no_grad():
        dets = YOLOv3Postprocess(port, img_hw=(64, 64), keep_top_k=20)(T(x))
    jdets = RPost(ref, img_hw=(64, 64), keep_top_k=20)(paddle.to_tensor(x))
    assert tuple(dets.shape) == (2, 20, 6)
    # the decayed scores carry the heads' 1e-5 differences, amplified
    assert_same(dets, jdets, rtol=1e-3, atol=1e-3, what="detections")


def test_tiny_yolov3_trains():
    """The reference's ``test_loss_trains`` (its data, five Adam steps) on
    the port's own weights."""
    port = YOLOv3(num_classes=4, depths=(1, 1, 1, 1, 1), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    x = T((rng.randn(2, 3, 64, 64) * 0.1).astype(np.float32))
    gt = np.zeros((2, 3, 4), np.float32)
    gt[:, 0] = [0.5, 0.5, 0.25, 0.4]
    gl = np.full((2, 3), -1, np.int64)
    gl[:, 0] = 1
    opt = tp.optimizer.Adam(learning_rate=1e-3,
                            parameters=port.parameters())
    losses = []
    for _ in range(5):
        loss = port.loss(x, T(gt), T(gl))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_yolov3_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from paddle_tpu_torch.core import place

    place._state.__dict__.pop("place", None)
    with pytest.raises(RuntimeError):
        YOLOv3(num_classes=4, depths=(1, 1, 1, 1, 1))

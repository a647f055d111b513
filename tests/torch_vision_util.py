"""The families of ``vision.models`` and the check that holds one against
the reference (``tests/test_torch_vision_models*.py``): its smallest
builder at the reference tests' sizes (``tests/test_models.py``: a few
classes, batch 1–2, 28²–128²), built in both packages with the reference's
weights carried by name (BatchNorm buffers too), dropout 0, float32 on the
CPU.

- Eval mode on the carried state, forward and backward of a fixed weighted
  sum of the logits: the logits by relative norm within 1e-5 and every
  parameter's gradient within 1e-4 of its norm, floored at 1e-3 of the
  whole gradient's norm (a key bias's gradient is noise around 0; measured
  at most 1.0e-6 by relative norm over all gradients).
- Then train mode, forward: the logits by relative norm within 1e-3
  (train-mode BatchNorm over a few values a channel amplifies the
  summation order's noise; measured up to 3.2e-4, ResNeXt), and every
  BatchNorm buffer by norm within 1e-3 of its norm plus 1e-6 an entry
  (measured up to 1.9e-4; means of zero-mean channels are ~1e-8).
- Train-mode gradients are not held here: a ReLU whose input is within
  float32 rounding of 0 can take the other branch in the other package,
  and in a train-mode BatchNorm network that moves every earlier gradient
  by far more than the rounding (the flipped channel's bias gradient
  moves, its weight gradient does not). The card holds them against a
  float64 arbiter, on its branches (``chip_smoke.py`` phases 19b and
  20a, ``_arbitrated_parity``).
"""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.models as RM
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.models as PM
from torch_nn_util import carry

FAMILIES = {
    "lenet": ("LeNet", {}, (2, 1, 28, 28)),
    "resnet": ("resnet18", {"num_classes": 10}, (2, 3, 64, 64)),
    "vgg": ("vgg11", {"num_classes": 0}, (1, 3, 32, 32)),
    "alexnet": ("alexnet", {"num_classes": 0}, (1, 3, 64, 64)),
    "mobilenetv1": ("mobilenet_v1", {"num_classes": 7, "scale": 0.25},
                    (2, 3, 64, 64)),
    "mobilenetv2": ("mobilenet_v2", {"num_classes": 5, "scale": 0.25},
                    (2, 3, 64, 64)),
    "squeezenet": ("squeezenet1_1", {"num_classes": 7}, (1, 3, 64, 64)),
    "shufflenetv2": ("shufflenet_v2_x0_25", {"num_classes": 7},
                     (2, 3, 64, 64)),
    "densenet": ("densenet121", {"num_classes": 7}, (1, 3, 64, 64)),
    "googlenet": ("googlenet", {"num_classes": 7}, (1, 3, 64, 64)),
    "inceptionv3": ("inception_v3", {"num_classes": 7}, (1, 3, 128, 128)),
    "resnext": ("resnext50_32x4d", {"num_classes": 7}, (1, 3, 64, 64)),
    "vit": ("VisionTransformer", {"img_size": 32, "patch_size": 8,
                                  "embed_dim": 64, "depth": 2,
                                  "num_heads": 4, "num_classes": 7},
            (2, 3, 32, 32)),
}


def _no_dropout(layers):
    for m in layers:
        if type(m).__name__.startswith("Dropout"):
            m.p = 0.0


def _pair(family):
    name, kw, _ = FAMILIES[family]
    paddle.seed(0)
    ref = getattr(RM, name)(**kw)
    port = getattr(PM, name)(device="cpu", **kw)
    _no_dropout(ref.sublayers())
    _no_dropout(port.modules())
    return ref, carry(ref, port)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def check_family(family, train=True):
    """One family against the reference: eval mode (logits and every
    gradient) on the carried state, then, with ``train``, a train-mode
    forward (logits and the BatchNorm buffers it moves)."""
    ref, port = _pair(family)
    shape = FAMILIES[family][2]
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    _eval_check(family, ref, port, x)
    if not train:
        return
    ref.train()
    port.train()
    jo = np.asarray(ref(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        to = port(torch.from_numpy(x)).numpy()
    assert to.shape == jo.shape
    assert _rel(to, jo) <= 1e-3, (family, _rel(to, jo))
    got = port.state_dict()
    held = 0
    for k, v in ref.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            a, b = got[k].numpy(), np.asarray(v.numpy())
            err = np.linalg.norm(a - b)
            assert err <= 1e-3 * np.linalg.norm(b) + 1e-6 * np.sqrt(b.size), \
                (family, k, err)
            held += 1
    assert held == sum(isinstance(m, tp.nn.BatchNorm2D)
                       for m in port.modules()) * 2


def _eval_check(family, ref, port, x):
    ref.eval()
    port.eval()
    jout = ref(paddle.to_tensor(x))
    w = np.random.RandomState(2).randn(*jout.shape).astype(np.float32)
    (jout * paddle.to_tensor(w)).sum().backward()
    tout = port(torch.from_numpy(x))
    (tout * torch.from_numpy(w)).sum().backward()
    assert _rel(tout.detach().numpy(), jout.numpy()) <= 1e-5
    jp = dict(ref.named_parameters())
    grads = {n: (p.grad.numpy(), np.asarray(jp[n].grad.numpy()))
             for n, p in port.named_parameters()}
    assert set(grads) == set(jp)
    total = np.sqrt(sum(float((w_ ** 2).sum()) for _, w_ in grads.values()))
    for n, (g, want) in grads.items():
        err = np.linalg.norm(g - want)
        assert err <= 1e-4 * max(np.linalg.norm(want), 1e-3 * total), \
            (family, n, err, np.linalg.norm(want))

"""``vision.models`` against the reference, the families without
BatchNorm (and DenseNet); ``torch_vision_util.check_family`` says what is
held and within what. The BatchNorm families are in
``test_torch_vision_models_bn.py``."""
import pytest
import torch

import paddle_tpu.vision.models as RM
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.models as PM
from paddle_tpu_torch.vision.models import resnet as presnet
from torch_port_util import cpu_device
from torch_vision_util import check_family

FAMILIES = ["alexnet", "densenet", "googlenet", "lenet", "squeezenet",
            "vgg", "vit"]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_the_reference(family):
    # DenseNet's reference train-mode run is the suite's slowest (~100 s
    # under -n 6); the train-mode BatchNorm path is held by the families
    # of test_torch_vision_models_bn.py
    check_family(family, train=family != "densenet")


def test_export_order_and_builders():
    # resnext.py's builders replace resnet.py's, as in the reference
    assert PM.resnext50_32x4d.__module__.endswith("resnext")
    assert PM.resnext50_32x4d is not presnet.resnext50_32x4d
    names = {n for n in dir(RM) if not n.startswith("_")}
    assert names - {n for n in dir(PM) if not n.startswith("_")} == set()
    assert tp.vision.LeNet is PM.LeNet
    assert tp.vision.get_image_backend() == "numpy"


def test_resnet50_names_and_sizes_match_the_reference():
    """resnet50's state by name and shape (parameters and BatchNorm
    buffers), and the count ``summary`` reports, without running it."""
    want = {k: tuple(v.shape) for k, v in
            RM.resnet50(num_classes=10).state_dict().items()}
    m = PM.resnet50(num_classes=10, device="cpu")
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == want
    s = tp.summary(m)
    assert s["total_params"] == sum(p.numel() for p in m.parameters())
    assert s["total_params"] == 23528522


def test_builders_take_a_generator_and_a_dtype():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = PM.mobilenet_v1(scale=0.25, num_classes=3, device="cpu", generator=g1)
    b = PM.mobilenet_v1(scale=0.25, num_classes=3, device="cpu", generator=g2)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    h = PM.LeNet(device="cpu", dtype="float64")
    assert all(p.dtype == torch.float64 for p in h.parameters())

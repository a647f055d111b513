"""``vision.models`` against the reference, the BatchNorm families (their
train-mode forwards dominate the reference's time);
``torch_vision_util.check_family`` says what is held and within what."""
import pytest

from torch_port_util import cpu_device
from torch_vision_util import check_family

FAMILIES = ["inceptionv3", "mobilenetv1", "mobilenetv2", "resnet",
            "resnext", "shufflenetv2"]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_the_reference(family):
    check_family(family)

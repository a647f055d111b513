"""paddle.vision (port of ``paddle_tpu/vision/``): ``transforms``,
``datasets``, ``models`` and the detection ``ops``."""
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from .models import LeNet  # noqa: F401


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"

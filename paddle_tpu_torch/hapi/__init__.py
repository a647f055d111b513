"""The high-level API (port of ``paddle_tpu/hapi/``): ``Model``,
``summary``, ``flops`` and the callbacks."""
from .model import Model, summary  # noqa: F401

"""paddle.callbacks: the hapi training callbacks at the top-level path
(port of ``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import *  # noqa: F401,F403
from .hapi import callbacks as _cb

__all__ = list(_cb.__all__)

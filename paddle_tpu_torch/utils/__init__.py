"""``paddle.utils`` (port of ``paddle_tpu/utils/``): DLPack interop and
``unique_name``."""
from . import dlpack, unique_name

__all__ = ["dlpack", "unique_name"]

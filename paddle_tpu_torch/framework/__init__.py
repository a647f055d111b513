"""Framework internals (port of ``paddle_tpu/framework/__init__.py``):
persistence, flags and the dygraph-mode probe."""
from . import flags
from ..core.tensor import Parameter
from .flags import get_flags, set_flags
from .io import load, save


def in_dygraph_mode() -> bool:
    """Always True: the port runs eagerly."""
    return True


__all__ = ["flags", "save", "load", "set_flags", "get_flags", "Parameter",
           "in_dygraph_mode"]

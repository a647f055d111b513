"""``fleet`` (port of ``paddle_tpu/distributed/fleet``): the model-parallel
layers of ``meta_parallel`` in their single-device form."""
from . import meta_parallel

__all__ = ["meta_parallel"]

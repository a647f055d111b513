"""``fleet`` (port of ``paddle_tpu/distributed/fleet``): the gradient
buckets of data parallelism (``grad_buckets``) and the model-parallel layers
of ``meta_parallel`` in their single-device form. ``fleet.init``, the
hybrid topology and the meta-optimizers come with ROADMAP A11b."""
from . import grad_buckets, meta_parallel

__all__ = ["grad_buckets", "meta_parallel"]

"""``paddle.incubate`` (port of ``paddle_tpu/incubate/__init__.py``): the
fused layers (``incubate.nn``), ASP, custom ops, the ``sparse`` namespace
and ``segment_*``, DistributedFusedLamb, LookAhead and ModelAverage, the
incubate operators and the host-embedding parameter server."""
from . import asp, nn  # noqa: F401
from .custom_op import (get_custom_op, register_custom_op,  # noqa: F401
                        registered_custom_ops)
from .. import sparse  # noqa: F401 (paddle.incubate.sparse)
from ..ops.extra import (segment_max, segment_mean, segment_min,  # noqa: F401
                         segment_sum)
from .distributed_fused_lamb import DistributedFusedLamb  # noqa: F401
from .optimizer_extras import LookAhead, ModelAverage  # noqa: F401
from .operators import (ResNetUnit, graph_khop_sampler,  # noqa: F401
                        graph_send_recv, softmax_mask_fuse,
                        softmax_mask_fuse_upper_triangle)
from .host_embedding import (HostEmbedding, HostEmbeddingTable,  # noqa: F401
                             HotRowCache, ShardedHostEmbeddingTable,
                             sharded_host_embedding)

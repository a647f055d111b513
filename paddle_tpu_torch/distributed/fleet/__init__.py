"""``fleet`` (port of ``paddle_tpu/distributed/fleet``): ``fleet.init`` and
the hybrid topology (``base``), ``distributed_model`` and
``distributed_optimizer``, the gradient buckets (``grad_buckets``), the
tensor-, sharding- and sequence-parallel layers and wrappers of
``meta_parallel`` with ZeRO-3, pipeline parallelism (``PipelineLayer``,
``PipelineTrainStep``) and the MoE layer, ``HybridParallelOptimizer``
with the ZeRO-1 sharded weight update and the DGC and LocalSGD
meta-optimizers (``meta_optimizers``) and ``recompute`` (``utils``)."""
from . import grad_buckets, meta_optimizers, meta_parallel, utils
from .base.distributed_strategy import DistributedStrategy
from .base.fleet_base import (_get_strategy, distributed_model,  # noqa: F401
                              distributed_optimizer,
                              get_hybrid_communicate_group, init,
                              is_first_worker, is_worker, worker_index,
                              worker_num)
from .base.role_maker import PaddleCloudRoleMaker, UserDefinedRoleMaker
from .base.topology import CommunicateTopology, HybridCommunicateGroup
from .utils import recompute, recompute_sequential

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "init", "is_first_worker",
           "worker_index", "worker_num", "is_worker", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "grad_buckets",
           "meta_optimizers", "meta_parallel", "utils", "recompute",
           "recompute_sequential"]

"""Fleet's entry points (port of
``paddle_tpu/distributed/fleet/base/fleet_base.py``): ``init`` builds the
``HybridCommunicateGroup`` from ``strategy.hybrid_configs`` over the axes
``["pipe", "data", "sharding", "sequence", "model"]``,
``distributed_model`` wraps the model for the active parallelism and
``distributed_optimizer`` wraps the optimizer in
``HybridParallelOptimizer``. A world of more than one rank joins its
process group first (``init_parallel_env``) when it has not yet.

``pp_degree`` builds the pipe axis, and ``distributed_model`` returns a
``PipelineParallelModel`` at pp > 1. ``ep_degree`` is accepted and has no
effect, as in the reference, whose topology has no expert axis: an expert
group is one that ``new_group`` makes and ``MoELayer(ep_group=...)``
takes. ``distributed_optimizer`` composes the meta-optimizers as the
reference does: ``strategy.dgc`` wraps a Momentum or SGD optimizer in
``DGCMomentumOptimizer`` first, ``strategy.localsgd`` wraps the result in
``LocalSGDOptimizer``, and ``HybridParallelOptimizer`` wraps them last.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ...parallel_env import get_rank, get_world_size
from .distributed_strategy import DistributedStrategy
from .role_maker import PaddleCloudRoleMaker
from .topology import CommunicateTopology, HybridCommunicateGroup

_strategy: Optional[DistributedStrategy] = None
_hcg: Optional[HybridCommunicateGroup] = None
_role_maker = None

def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    global _strategy, _hcg, _role_maker
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    dims = [int(hc.get(k, 1)) for k in ("pp_degree", "dp_degree",
                                        "sharding_degree", "sp_degree",
                                        "mp_degree")]
    from ...parallel_env import _initialized, init_parallel_env

    if int(np.prod(dims)) > 1 and not _initialized():
        init_parallel_env()
    topo = CommunicateTopology(
        hybrid_group_names=["pipe", "data", "sharding", "sequence", "model"],
        dims=dims)
    _hcg = HybridCommunicateGroup(topo)
    _strategy = strategy
    _role_maker = role_maker or PaddleCloudRoleMaker(
        is_collective=is_collective)
    return None


def _reset() -> None:
    """Forget the topology (its groups died with their process group)."""
    global _strategy, _hcg, _role_maker
    from ...mesh import set_global_mesh

    if _hcg is not None:
        set_global_mesh(None)
    _strategy = _hcg = _role_maker = None


def _get_strategy() -> DistributedStrategy:
    return _strategy or DistributedStrategy()


# reference-style ``fleet.fleet`` access: the ``distributed.fleet`` package,
# whose functions are these (it is in sys.modules while it imports this)
fleet = sys.modules[__name__.rsplit(".", 2)[0]]


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg


def is_first_worker():
    return _role_maker.is_first_worker() if _role_maker else get_rank() == 0


def worker_index():
    return _role_maker.worker_index() if _role_maker else get_rank()


def worker_num():
    return _role_maker.worker_num() if _role_maker else get_world_size()


def is_worker():
    return True


def distributed_model(model):
    """The model wrapped for the active parallelism (reference
    fleet_base.py:70): ``PipelineParallelModel`` at pp > 1, else
    ``ShardingParallel`` at sharding > 1, else ``TensorParallel`` at
    mp > 1, else ``DataParallel`` over the data x sequence group at
    dp > 1, else the model itself."""
    hcg = _hcg
    if hcg is None:
        return model
    from ...parallel import DataParallel
    from ..meta_parallel.parallel_wrappers import (ShardingParallel,
                                                   TensorParallel)

    strategy = _get_strategy()
    if hcg.get_pipe_parallel_world_size() > 1:
        from ..meta_parallel.pipeline_parallel import PipelineParallelModel

        return PipelineParallelModel(model, hcg, strategy)
    if hcg.get_sharding_parallel_world_size() > 1:
        return ShardingParallel(model, hcg, strategy)
    if hcg.get_model_parallel_world_size() > 1:
        return TensorParallel(model, hcg, strategy)
    if hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model, group=hcg.get_dp_sp_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """``optimizer`` wrapped in ``HybridParallelOptimizer`` (reference
    fleet_base.py:94), after ``strategy.dgc`` (a Momentum or SGD optimizer
    only) and ``strategy.localsgd`` have wrapped it in that order."""
    from ..meta_optimizers.hybrid_parallel_optimizer import \
        HybridParallelOptimizer

    strategy = strategy or _get_strategy()
    if getattr(strategy, "dgc", False):
        from ..meta_optimizers.dgc_optimizer import DGCMomentumOptimizer

        tname = type(optimizer).__name__
        if tname not in ("Momentum", "SGD", "DGCMomentumOptimizer"):
            raise ValueError(
                f"strategy.dgc requires a Momentum/SGD inner optimizer "
                f"(got {tname}); DGC replaces the update rule with "
                "compressed momentum SGD")
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        if tname != "DGCMomentumOptimizer":
            optimizer = DGCMomentumOptimizer(
                learning_rate=optimizer.get_lr(),
                lr_fn=optimizer.get_lr,  # live: a scheduler keeps working
                momentum=getattr(optimizer, "_momentum", 0.9),
                parameters=optimizer._parameter_list,
                rampup_begin_step=cfg.get("rampup_begin_step", 0),
                rampup_step=cfg.get("rampup_step", 1),
                sparsity=cfg.get("sparsity", (0.999,)))
    if getattr(strategy, "localsgd", False):
        from ..meta_optimizers.localsgd_optimizer import LocalSGDOptimizer

        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        optimizer = LocalSGDOptimizer(optimizer, k_steps=cfg.get("k_steps", 4))
    return HybridParallelOptimizer(optimizer, _hcg, strategy)

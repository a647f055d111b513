"""Distributed training (port of ``paddle_tpu/distributed``): the process
group and its collectives on ``torch.distributed`` (``parallel_env``,
``collective``), the job's mesh of axes (``mesh``), gradient buckets and
``DataParallel``, the ``HybridParallelEngine`` with its OOM recovery
ladder, the expert all-to-all (``utils``: ``global_scatter``,
``global_gather``), and ``fleet``: the hybrid topology (``fleet.init``),
the tensor-parallel layers over their rank's shards, ZeRO-1/2/3,
ring/Ulysses sequence parallelism, pipeline parallelism, the MoE layer and
the DGC and LocalSGD meta-optimizers and ``fleet.elastic``'s heartbeats
and relaunch. ``sharding_api`` places a tensor over a mesh as this rank's
shard (``shard_tensor``, ``reshard``) and ``auto_parallel`` searches and
realises a parameter placement; ``checkpoint`` is the sharded, async and
coordinated checkpoint with crash-safe resume, ``coord`` the stores
(``FileStore``, ``TCPStore``) and the two-phase commit barrier,
``watchdog`` the progress table and collective deadlines, and ``spawn``
and ``launch`` start and supervise the workers."""
from . import (auto_parallel, checkpoint, collective, coord, fleet,  # noqa: F401
               launch_mod, sharding_api, utils, watchdog)
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_gather_into_tensor, all_reduce, all_to_all,
                         alltoall, alltoall_single, barrier, broadcast,
                         get_group, irecv, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send, wait)
from .collective import split as _dist_split  # noqa: F401
from .engine import HybridParallelEngine  # noqa: F401
from .mesh import (build_mesh, global_mesh, mesh_axis_size,  # noqa: F401
                   set_global_mesh)
from .parallel import DataParallel  # noqa: F401
from .parallel_env import (ParallelEnv, destroy_process_group,  # noqa: F401
                           get_rank, get_world_size, init_parallel_env)
from .coord import TCPStore  # noqa: F401
from .launch_mod import launch  # noqa: F401
from .sharding_api import reshard, shard_op, shard_tensor  # noqa: F401
from .spawn import spawn  # noqa: F401


def get_backend():
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else "gloo"


def is_initialized():
    from .parallel_env import _initialized

    return _initialized()


__all__ = ["collective", "fleet", "utils", "get_rank", "get_world_size",
           "init_parallel_env", "ParallelEnv", "destroy_process_group",
           "DataParallel", "HybridParallelEngine", "build_mesh",
           "global_mesh", "set_global_mesh", "mesh_axis_size", "Group",
           "ReduceOp", "new_group", "get_group", "all_reduce", "all_gather",
           "all_gather_into_tensor", "reduce", "reduce_scatter", "broadcast",
           "scatter", "all_to_all", "alltoall", "alltoall_single", "send",
           "recv", "isend", "irecv", "barrier", "wait", "get_backend",
           "is_initialized", "auto_parallel", "checkpoint", "coord",
           "launch_mod", "sharding_api", "watchdog", "spawn", "launch",
           "TCPStore", "save_state_dict", "load_state_dict", "shard_tensor",
           "shard_op", "reshard"]

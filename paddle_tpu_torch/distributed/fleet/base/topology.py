"""The hybrid communicate topology (port of
``paddle_tpu/distributed/fleet/base/topology.py``).

``CommunicateTopology`` is the reference's N-D rank space: ranks laid out
row-major over the axes in their order, the last axis fastest, so with
``fleet.init``'s order ``["pipe", "data", "sharding", "sequence",
"model"]`` an ``mp`` group is consecutive ranks. ``get_rank``,
``get_coord``, ``get_axis_list`` and ``get_comm_list`` are the
reference's.

``HybridCommunicateGroup`` turns each axis into a ``collective.Group``
that holds a real ``torch.distributed`` process group (the reference's
axis is a named dimension of one ``jax.sharding.Mesh``).
``torch.distributed.new_group`` must be called by every rank for every
group, in the same order, members or not, so every rank builds every
axis's comm lists and keeps the group it belongs to. Besides the five
axes there is the combined ``data`` x ``sequence`` group
(``get_dp_sp_parallel_group``): the gradients of parameters replicated
over dp and sp are averaged over it. The rank mesh (``distributed/
mesh.py``) with the five axis names and sizes is set global, so
``HybridParallelEngine(mesh=hcg.mesh)`` reads the axis sizes as the
reference's does. Without a process group every degree must be 1 and
each group is the single-participant identity.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("pipe", "data", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = dict(zip(self._parallel_names, self._dims))
        ranges = [range(d) for d in self._dims]
        self._coord2rank = {c: i for i, c in
                            enumerate(itertools.product(*ranges))}
        self._rank2coord = {v: k for k, v in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self.coordinate[axis_name]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs):
        return self._coord2rank[tuple(kwargs[n] for n in self._parallel_names)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        return self.get_fused_comm_list([axis_name])

    def get_fused_comm_list(self, axis_names):
        """The rank lists of the groups spanning ``axis_names`` together:
        one list a coordinate of the other axes, ranks in row-major order
        over the named axes (one name: ``get_comm_list``)."""
        idx = [self._parallel_names.index(a) for a in axis_names]
        others = [i for i in range(len(self._dims)) if i not in idx]
        out = []
        for oc in itertools.product(*(range(self._dims[i]) for i in others)):
            group = []
            for ac in itertools.product(*(range(self._dims[i]) for i in idx)):
                coord = [0] * len(self._dims)
                for i, v in zip(others, oc):
                    coord[i] = v
                for i, v in zip(idx, ac):
                    coord[i] = v
                group.append(self._coord2rank[tuple(coord)])
            out.append(group)
        return out


class HybridCommunicateGroup:
    """Per-axis groups over this process's world (reference topology.py:71).
    The degrees must multiply to the world's size."""

    AXIS_MAP = {"pipe": "pp", "data": "dp", "sharding": "sharding",
                "model": "mp", "sequence": "sp", "expert": "ep"}

    def __init__(self, topology: CommunicateTopology):
        import torch.distributed as dist

        from ... import collective as C
        from ...mesh import Mesh, set_global_mesh
        from ...parallel_env import get_rank, get_world_size

        self._topo = topology
        self.nranks = topology.world_size()
        world = get_world_size()
        if self.nranks != world:
            raise ValueError(
                f"HybridCommunicateGroup: the degrees "
                f"{dict(zip(topology.get_hybrid_group_names(), topology._dims))}"
                f" need a world of {self.nranks} ranks, have {world} "
                "(init_parallel_env)")
        self.global_rank = get_rank()
        self._coord = dict(zip(topology.get_hybrid_group_names(),
                               topology.get_coord(self.global_rank)))
        names = topology.get_hybrid_group_names()
        self._axis_names = [self.AXIS_MAP.get(n, n) for n in names]
        self._mesh = Mesh(np.arange(self.nranks).reshape(topology._dims),
                          self._axis_names)
        live = dist.is_initialized()

        def make(lists, axis):
            """Every list's group, created on every rank in the same order;
            the one holding this rank is kept."""
            mine = None
            for ranks in lists:
                g = C.new_group(ranks, axis_name=axis) if live else \
                    C.Group(axis_name=axis, ranks=ranks)
                if self.global_rank in ranks:
                    mine = g
            return mine

        self._groups: Dict[str, object] = {}
        for name, axis in zip(names, self._axis_names):
            self._groups[axis] = make(topology.get_comm_list(name), axis)
        fused = [n for n in ("data", "sequence") if n in names]
        self._groups["dp_sp"] = make(topology.get_fused_comm_list(fused),
                                     "dp_sp")
        set_global_mesh(self._mesh)

    def _degree(self, axis):
        return int(self._mesh.shape.get(axis, 1))

    def _rank_on(self, name):
        return int(self._coord.get(name, 0))

    @property
    def mesh(self):
        return self._mesh

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._rank_on("data")

    def get_data_parallel_world_size(self):
        return self._degree("dp")

    def get_data_parallel_group(self):
        return self._groups.get("dp")

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group().ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._rank_on("model")

    def get_model_parallel_world_size(self):
        return self._degree("mp")

    def get_model_parallel_group(self):
        return self._groups.get("mp")

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group().ranks[0]

    # pipeline
    def get_stage_id(self):
        return self._rank_on("pipe")

    def get_pipe_parallel_world_size(self):
        return self._degree("pp")

    def get_pipe_parallel_group(self):
        return self._groups.get("pp")

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._degree("pp") - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._rank_on("sharding")

    def get_sharding_parallel_world_size(self):
        return self._degree("sharding")

    def get_sharding_parallel_group(self):
        return self._groups.get("sharding")

    def get_sharding_parallel_group_src_rank(self):
        return self.get_sharding_parallel_group().ranks[0]

    # sequence parallel
    def get_sequence_parallel_rank(self):
        return self._rank_on("sequence")

    def get_sequence_parallel_world_size(self):
        return self._degree("sp")

    def get_sequence_parallel_group(self):
        return self._groups.get("sp")

    def get_dp_sp_parallel_group(self):
        """The data x sequence group: parameters are replicated over it, so
        their gradients are averaged over it."""
        return self._groups.get("dp_sp")

    # expert parallel
    def get_expert_parallel_world_size(self):
        return self._degree("ep")

    def get_expert_parallel_group(self):
        return self._groups.get("ep")

    def get_check_parallel_group(self):
        return self._groups.get("dp")

    def get_rank_from_stage(self, stage_id, **kwargs):
        coord = dict(self._coord, pipe=stage_id, **kwargs)
        return self._topo.get_rank(**coord)


__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]

"""Pipeline layer descriptions and their segmentation (port of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``).

``LayerDesc`` and ``SharedLayerDesc`` describe the layers, ``SegmentLayers``
cuts them into stages (``"uniform"`` or ``"layer:<ClassName>"``) and
``PipelineLayer`` builds them, each sublayer named ``stage{s}_{i}`` as in
the reference, so ``models/convert.py`` carries weights across by name.

The reference is one process over logical arrays and builds every stage.
The port runs one process a rank: built after ``fleet.init`` with a pp
group of ``num_stages`` ranks, a ``PipelineLayer`` builds **only its own
stage's layers**, as Paddle's own does, which is why pipelining saves
memory. Without a pp group, or with one of one rank, it builds every stage
and ``forward`` runs the segments in sequence; over a larger group
``forward`` runs this rank's segment.

A ``SharedLayerDesc`` key (tied weights: the embedding and the LM head) is
built once a stage that holds it. Across stages the copies are kept equal:
the constructor creates, on every rank and in the same order, one group a
shared key over the stages that hold it (for each coordinate of the other
axes), broadcasts the first stage's parameters over it, and
``PipelineTrainStep`` sums the copies' gradients over it before the update
(the reference's ``psum`` over ``pp`` of the one logical parameter's
gradient). A desc's ``forward_func(layer, x)`` applies at that desc's
position; the reference sets it on the shared layer object, so there it
applies at every position of the key.
"""
from __future__ import annotations

from typing import List

from ....nn.layer.layers import Layer
from ... import collective as C


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_cls, Layer):
            raise TypeError("LayerDesc expects a Layer subclass")

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Weights tied across stages under ``key`` (reference pp_layers.py:49:
    the embedding and the LM head)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Partition N layers into M stages (reference pp_layers.py:63)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self._layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method
        if len(layers_desc) < num_parts:
            raise ValueError(
                "layer number should be greater than number of segments")

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(len(self._layers_desc), self.num_parts)
        if self.method.startswith("layer:"):
            # cut on the boundaries of the named layer class
            name = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self._layers_desc)
                     if (d.layer_cls.__name__ if isinstance(d, LayerDesc)
                         else type(d).__name__) == name]
            if len(marks) >= self.num_parts:
                per = len(marks) // self.num_parts
                return [0] + [marks[per * i]
                              for i in range(1, self.num_parts)] \
                    + [len(self._layers_desc)]
        return self.uniform(len(self._layers_desc), self.num_parts)

    @staticmethod
    def uniform(num_items, num_parts):
        base, extra = num_items // num_parts, num_items % num_parts
        bounds = [0]
        for i in range(num_parts):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
        return bounds


def _pp_topology(num_stages):
    """(pp group, this rank's stage, the hybrid group) when ``fleet.init``
    built a pipe axis of more than one rank, else (None, 0, None)."""
    from ..base.fleet_base import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
        return None, 0, None
    n = hcg.get_pipe_parallel_world_size()
    if n != num_stages:
        raise ValueError(f"PipelineLayer has {num_stages} stages but the pp "
                         f"group has {n} ranks; they must match")
    return hcg.get_pipe_parallel_group(), hcg.get_stage_id(), hcg


def _drop_repeats(layer, state, prefix, local_metadata):
    for name in layer._repeats:
        for k in [k for k in state if k.startswith(f"{prefix}{name}.")]:
            del state[k]
    return state


class PipelineLayer(Layer):
    """Reference pp_layers.py:132 (see the module docstring for what a
    rank builds)."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, **kwargs):
        super().__init__()
        self._layers_desc = list(layers)
        self._loss_fn = loss_fn
        self._topo = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._recompute_interval = recompute_interval
        self.segment_parts = SegmentLayers(
            self._layers_desc, self._num_stages, seg_method).do_segment()
        self._pp_group, self._stage_id, hcg = _pp_topology(self._num_stages)
        mine = [self._stage_id] if self._pp_group is not None \
            else range(self._num_stages)

        # per stage: (layer, forward_func or None) a position; empty for the
        # stages another rank builds
        self._entries: List[list] = [[] for _ in range(self._num_stages)]
        self.shared_layers = {}
        for stage in mine:
            start, end = self.segment_parts[stage], \
                self.segment_parts[stage + 1]
            for i in range(start, end):
                desc, fwd = self._layers_desc[i], None
                if isinstance(desc, SharedLayerDesc):
                    if desc.layer_name not in self.shared_layers:
                        self.shared_layers[desc.layer_name] = \
                            desc.build_layer()
                    layer = self.shared_layers[desc.layer_name]
                    fwd = desc.forward_func
                elif isinstance(desc, LayerDesc):
                    layer = desc.build_layer()
                else:
                    layer = desc  # a plain Layer or a callable
                if isinstance(layer, Layer):
                    self.add_sublayer(f"stage{stage}_{i}", layer)
                self._entries[stage].append((layer, fwd))
        self.run_function = [e for st in self._entries for e in st]
        self._shared_groups = self._tie_shared(hcg)
        # a shared key registered twice in this rank is saved once, under
        # its first position, as in the reference's state
        built = [p for st in mine for p in (f"stage{st}_{i}" for i in range(
            self.segment_parts[st], self.segment_parts[st + 1]))]
        first, self._repeats = {}, []
        for name in built:
            m = self._modules.get(name)
            if m is not None and first.setdefault(id(m), name) != name:
                self._repeats.append(name)
        self._register_state_dict_hook(_drop_repeats)

    def _shared_stages(self):
        """{key: the stages that hold it}, in the order of the descs."""
        out = {}
        for i, d in enumerate(self._layers_desc):
            if isinstance(d, SharedLayerDesc):
                stage = next(s for s in range(self._num_stages)
                             if self.segment_parts[s] <= i
                             < self.segment_parts[s + 1])
                st = out.setdefault(d.layer_name, [])
                if stage not in st:
                    st.append(stage)
        return out

    def _tie_shared(self, hcg):
        """{key: group} over the stages that hold a shared key, for the
        keys held by more than one stage; the first stage's parameters are
        broadcast over it. Every rank creates every group in one order."""
        if hcg is None:
            return {}
        groups = {}
        pipes = hcg.topology().get_comm_list("pipe")
        for key, stages in self._shared_stages().items():
            if len(stages) < 2:
                continue
            for ranks in pipes:
                members = [ranks[s] for s in stages]
                g = C.new_group(members, axis_name=f"pp_shared_{key}")
                if hcg.get_global_rank() in members:
                    groups[key] = g
            if key in groups:
                g = groups[key]
                for p in self.shared_layers[key].parameters():
                    C.broadcast(p.data, src=g.ranks[0], group=g)
        return groups

    @property
    def num_stages(self):
        return self._num_stages

    def get_stage_layers(self, stage_id):
        return [layer for layer, _ in self._entries[stage_id]]

    def stage_parameters(self, stage_id):
        seen, out = set(), []
        for layer in self.get_stage_layers(stage_id):
            if isinstance(layer, Layer):
                for p in layer.parameters():
                    if id(p) not in seen:
                        seen.add(id(p))
                        out.append(p)
        return out

    def run_stage(self, stage_id, x):
        """Stage ``stage_id``'s layers on ``x``."""
        for layer, fwd in self._entries[stage_id]:
            x = fwd(layer, x) if fwd is not None else layer(x)
        return x

    def forward(self, x):
        """Every segment in sequence (the segment this rank built over a pp
        group of more than one rank)."""
        for layer, fwd in self.run_function:
            x = fwd(layer, x) if fwd is not None else layer(x)
        return x


__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]

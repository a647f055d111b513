"""Model wrappers for the active parallelism (port of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py``):
``TensorParallel`` and ``ShardingParallel`` hold the model, run its forward
and pass its state through; an attribute they lack is read from the model
(``wrapped.loss(...)``). The sharding itself lives in the layers (mp
shards) and the optimizer (ZeRO). ``PipelineParallel`` is the reference's
plain wrapper; ``fleet.distributed_model`` returns a
``PipelineParallelModel`` at pp > 1, which runs the schedule."""
from __future__ import annotations

from ....nn.layer.layers import Layer


class _MetaParallelBase(Layer):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._hcg = hcg
        self._strategy = strategy
        self.add_sublayer("_layers", layers)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("_layers"), name)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


class ShardingParallel(_MetaParallelBase):
    pass


class TensorParallel(_MetaParallelBase):
    pass


class PipelineParallel(_MetaParallelBase):
    pass


__all__ = ["TensorParallel", "ShardingParallel", "PipelineParallel"]

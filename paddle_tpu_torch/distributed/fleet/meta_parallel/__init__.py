from .moe_layer import MoELayer, moe_dispatch_combine
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .parallel_wrappers import (PipelineParallel, ShardingParallel,
                                TensorParallel)
from .pipeline_parallel import PipelineParallelModel, PipelineTrainStep
from .pp_layers import (LayerDesc, PipelineLayer, SegmentLayers,
                        SharedLayerDesc)
from .sequence_parallel import (RingAttention, gather_sequence,
                                ring_attention, split_sequence,
                                ulysses_attention)
from .sharding import (DygraphShardingOptimizer, ShardingOptimizerStage1,
                       ShardingStage2, ShardingStage3,
                       group_sharded_parallel, shard_spec_for)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "TensorParallel",
           "ShardingParallel", "PipelineParallel", "RingAttention",
           "ring_attention", "ulysses_attention", "split_sequence",
           "gather_sequence", "ShardingOptimizerStage1",
           "DygraphShardingOptimizer", "ShardingStage2", "ShardingStage3",
           "group_sharded_parallel", "shard_spec_for", "LayerDesc",
           "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineTrainStep", "PipelineParallelModel", "MoELayer",
           "moe_dispatch_combine"]

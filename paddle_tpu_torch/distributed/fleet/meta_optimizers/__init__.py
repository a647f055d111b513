from .dgc_optimizer import DGCMomentumOptimizer
from .hybrid_parallel_optimizer import (HybridParallelOptimizer,
                                        ShardedWeightUpdate)
from .localsgd_optimizer import LocalSGDOptimizer

__all__ = ["HybridParallelOptimizer", "ShardedWeightUpdate",
           "DGCMomentumOptimizer", "LocalSGDOptimizer"]

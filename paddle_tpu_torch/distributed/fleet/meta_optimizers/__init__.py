from .hybrid_parallel_optimizer import (HybridParallelOptimizer,
                                        ShardedWeightUpdate)

__all__ = ["HybridParallelOptimizer", "ShardedWeightUpdate"]

"""``DistributedStrategy`` (port of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): the
attribute bag ``fleet.init`` and ``distributed_optimizer`` read. The
hybrid degrees are ``hybrid_configs``; the meta-optimizer switches and
their configs keep the reference's names and defaults."""
from __future__ import annotations


class DistributedStrategy:
    def __init__(self):
        # hybrid parallel degrees; sp is the sequence-parallel axis and ep
        # the expert-parallel one
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sp_degree": 1,
            "ep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "use_dynamic_loss_scaling": True,
            "incr_every_n_steps": 1000,
            "decr_every_n_nan_or_inf": 2,
            "incr_ratio": 2.0,
            "decr_ratio": 0.5,
            "use_pure_fp16": False,
            "use_bf16": True,
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {
            "sharding_degree": 1,
            "stage": 1,
            "offload": False,
            "segment_broadcast_MB": 32.0,
        }
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {}
        self.lars = False
        self.lars_configs = {}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": (0.999,)}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4}
        self.fp16_allreduce = False
        self.a_sync = False
        self.a_sync_configs = {}
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.without_graph_optimization = False

    def to_dict(self):
        return dict(self.__dict__)

    def __repr__(self):
        lines = ["DistributedStrategy("]
        for k, v in sorted(self.__dict__.items()):
            lines.append(f"  {k}={v},")
        return "\n".join(lines) + "\n)"

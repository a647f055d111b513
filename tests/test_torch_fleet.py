"""``paddle_tpu_torch.distributed.fleet`` at one rank, against the
reference (``paddle_tpu.distributed.fleet``).

* ``DistributedStrategy``'s defaults equal the reference's;
* ``CommunicateTopology``'s ``get_rank``, ``get_coord``, ``get_axis_list``
  and ``get_comm_list`` equal the reference's for the degrees (pp, dp,
  sharding, sp, mp) = (1,2,1,1,2), (1,1,2,1,2) and (1,2,1,2,1) over
  ``fleet.init``'s axis order;
* ``fleet.init`` at world 1, without and with a gloo group of one rank:
  the hybrid group's degrees, ranks and groups, the global mesh, the role
  maker, ``distributed_model``/``distributed_optimizer``'s wrapper types,
  and ``HybridParallelEngine(mesh=hcg.mesh)`` bit-equal to the engine
  without fleet over 3 AdamW steps of tiny GPT;
* ``recompute`` (and ``recompute_sequential``) gradients bit-equal to no
  recompute, dropout included (the port's generator is replayed);
* what A11b, part 2 ported builds at one rank: ``ep_degree`` is accepted
  with no axis (as the reference's topology has none), ``pp_degree`` needs
  its world, ``strategy.dgc``/``localsgd`` wrap the optimizer as the
  reference composes them, and ``PipelineParallel`` is a plain wrapper.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import fleet as jfleet
import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.base import fleet_base
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny

NAMES = ["pipe", "data", "sharding", "sequence", "model"]


@pytest.fixture(autouse=True)
def _fresh_fleet():
    fleet_base._reset()
    yield
    if tdist.is_initialized():
        tdist.destroy_process_group()
    fleet_base._reset()


def test_strategy_defaults_equal_the_reference():
    t, j = fleet.DistributedStrategy(), jfleet.DistributedStrategy()
    assert t.to_dict() == j.to_dict()
    assert t.hybrid_configs == {"dp_degree": 1, "mp_degree": 1,
                                "pp_degree": 1, "sharding_degree": 1,
                                "sp_degree": 1, "ep_degree": 1}
    assert "hybrid_configs=" in repr(t)


@pytest.mark.parametrize("dims", [(1, 2, 1, 1, 2), (1, 1, 2, 1, 2),
                                  (1, 2, 1, 2, 1)])
def test_topology_equals_the_reference(dims):
    t = fleet.CommunicateTopology(NAMES, dims)
    j = jfleet.CommunicateTopology(NAMES, dims)
    assert t.world_size() == j.world_size() == int(np.prod(dims))
    for r in range(t.world_size()):
        coord = t.get_coord(r)
        assert coord == j.get_coord(r)
        assert t.get_rank(**dict(zip(NAMES, coord))) == r
    for name in NAMES:
        assert t.get_comm_list(name) == j.get_comm_list(name), name
        for i in range(t.get_dim(name)):
            assert t.get_axis_list(name, i) == j.get_axis_list(name, i)
    # model is the fastest axis: an mp group is consecutive ranks
    mp = t.get_dim("model")
    assert t.get_comm_list("model")[0] == list(range(mp))
    fused = t.get_fused_comm_list(["data", "sequence"])
    assert sorted(r for g in fused for r in g) == list(range(t.world_size()))


def _check_world_one(hcg):
    assert hcg.get_data_parallel_world_size() == 1
    assert hcg.get_model_parallel_world_size() == 1
    assert hcg.get_sharding_parallel_world_size() == 1
    assert hcg.get_sequence_parallel_world_size() == 1
    assert hcg.get_pipe_parallel_world_size() == 1
    assert (hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank(),
            hcg.get_stage_id()) == (0, 0, 0)
    for g in (hcg.get_data_parallel_group(), hcg.get_model_parallel_group(),
              hcg.get_sharding_parallel_group(),
              hcg.get_sequence_parallel_group(),
              hcg.get_dp_sp_parallel_group()):
        assert g.ranks == [0] and g.nranks == 1 and g.rank == 0
    assert hcg.is_first_stage() and hcg.is_last_stage()
    assert hcg.mesh.shape == {"pp": 1, "dp": 1, "sharding": 1, "sp": 1,
                              "mp": 1}
    assert tdist.global_mesh() is hcg.mesh


def _engine_run(use_fleet):
    m = GPTForPretraining(gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0),
                          device="cpu", seed=3).train()
    opt = pt.optimizer.AdamW(1e-3, parameters=m.parameters())
    if use_fleet:
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(opt)
        mesh = fleet.get_hybrid_communicate_group().mesh
    else:
        model, mesh = m, None
    eng = tdist.HybridParallelEngine(model, opt,
                                     lambda mm, i, l: mm.loss(i, l),
                                     mesh=mesh)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (2, 16)).astype(np.int64))
    losses = [eng.train_step(ids, ids).item() for _ in range(3)]
    return losses, [p.detach().clone() for p in m.parameters()], model, opt


@pytest.mark.parametrize("group", ["none", "gloo"])
def test_fleet_init_at_world_one(group, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
    want, want_p, _, _ = _engine_run(False)
    if group == "gloo":
        tdist.init_parallel_env(device="cpu")
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    hcg = fleet.get_hybrid_communicate_group()
    _check_world_one(hcg)
    live = hcg.get_model_parallel_group().process_group() is not None
    assert live == (group == "gloo")
    assert fleet.worker_index() == 0 and fleet.worker_num() == 1
    assert fleet.is_first_worker() and fleet.is_worker()
    losses, params, model, opt = _engine_run(True)
    assert isinstance(model, GPTForPretraining)  # every degree 1
    assert type(opt).__name__ == "HybridParallelOptimizer"
    assert losses == want
    assert all(torch.equal(a, b) for a, b in zip(params, want_p))
    assert opt.state_dict()["@step"] == 3


def test_distributed_model_picks_the_wrapper(monkeypatch):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ShardingParallel, TensorParallel)

    m = pt.nn.Linear(4, 4, device="cpu")
    assert fleet.distributed_model(m) is m  # no fleet.init
    fleet.init(is_collective=True)
    hcg = fleet.get_hybrid_communicate_group()
    for cls, key in ((TensorParallel, "mp"), (ShardingParallel,
                                              "sharding")):
        monkeypatch.setitem(hcg.mesh.shape, key, 2)
        w = fleet.distributed_model(m)
        assert type(w) is cls and w._layers is m
        assert w.weight is m.weight  # attributes pass through
        assert torch.equal(w(torch.ones(1, 4)), m(torch.ones(1, 4)))
        assert w.state_dict().keys() == m.state_dict().keys()
        monkeypatch.setitem(hcg.mesh.shape, key, 1)


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_recompute_gradients_equal_no_recompute(p):
    from paddle_tpu_torch.distributed.fleet.utils import (recompute,
                                                          recompute_sequential)

    torch.manual_seed(0)
    layers = [pt.nn.Linear(8, 8, device="cpu") for _ in range(2)]
    drop = pt.nn.Dropout(p)

    def block(x):
        return drop(torch.tanh(layers[0](x)))

    x0 = torch.randn(4, 8)
    grads = []
    for mode in ("plain", "recompute", "sequential"):
        for q in (q for layer in layers for q in layer.parameters()):
            q.grad = None
        x = x0.clone().requires_grad_()
        pt.seed(5)
        if mode == "plain":
            y = layers[1](block(x))
        elif mode == "recompute":
            y = layers[1](recompute(block, x))
        else:
            y = recompute_sequential([block, layers[1]])(x)
        (y ** 2).sum().backward()
        grads.append([x.grad] + [q.grad.clone() for layer in layers
                                 for q in layer.parameters()])
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))


def test_unported_parts_raise_naming_part_2():
    """What used to raise naming A11b, part 2 now runs at one rank (the
    multi-rank parity: tests/test_torch_pipeline.py, test_torch_moe.py,
    test_torch_zero3.py, test_torch_comm_compression.py)."""
    m = pt.nn.Linear(4, 4, device="cpu")
    opt = pt.optimizer.Momentum(0.1, parameters=m.parameters())
    s = fleet.DistributedStrategy()
    s.hybrid_configs["ep_degree"] = 2
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    assert "ep" not in hcg.mesh.shape and hcg.nranks == 1
    assert hcg.get_expert_parallel_world_size() == 1
    fleet_base._reset()
    tdist.init_parallel_env(device="cpu")  # a gloo world of one
    s = fleet.DistributedStrategy()
    s.hybrid_configs["pp_degree"] = 2
    with pytest.raises(ValueError, match="world of 2"):
        fleet.init(is_collective=True, strategy=s)
    assert fleet.get_hybrid_communicate_group() is None
    for meta, kind in (("dgc", "DGCMomentumOptimizer"),
                       ("localsgd", "LocalSGDOptimizer")):
        s = fleet.DistributedStrategy()
        setattr(s, meta, True)
        wrapped = fleet.distributed_optimizer(opt, s)
        assert type(wrapped).__name__ == "HybridParallelOptimizer"
        assert type(wrapped._inner_opt).__name__ == kind
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel

    x = torch.ones(2, 4)
    assert torch.equal(PipelineParallel(m, None, None)(x), m(x))

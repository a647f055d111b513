"""The sharding API (``paddle_tpu_torch.distributed.sharding_api``:
``shard_tensor``, ``reshard``, ``shard_op``) against the reference's
``shard_tensor`` and ``auto_parallel.reshard`` on its virtual CPU meshes.

A placed tensor in the port is this rank's shard. At world 2 (mesh
``("x",)``) and world 4 (mesh ``("dp", "mp")`` of 2 x 2), as gloo ranks
(``tests/torch_a11_worker.py shard``), for each case of
``SHARD_CASES``: the shard ``shard_tensor`` gives rank r, the shard after
``reshard``, the round trip back and the gradient through ``reshard``
(its backward reshards back) equal, bit for bit, the reference's
``addressable_shards`` for the device at rank r's mesh coordinates (the
gradient: the cotangent's shard under the source placement). One rank:
the identity, a ``Parameter``'s annotation, ``shard_op`` and the gradient
through ``shard_tensor``.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

from paddle_tpu_torch.distributed import sharding_api as tsh
from paddle_tpu_torch.distributed.mesh import Mesh
from torch_a11_worker import SHARD_CASES, SHARD_SHAPE
from torch_port_util import spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_a11_worker.py"
RANK_TIMEOUT_S = 240


def _inputs():
    rng = np.random.RandomState(11)
    return (rng.randn(*SHARD_SHAPE).astype(np.float32),
            rng.randn(*SHARD_SHAPE).astype(np.float32))


def _ref_shards(a, mesh, spec):
    """device index -> the reference's addressable shard of ``a``."""
    arr = jax.device_put(a, JNamed(mesh, JP(*spec)))
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


def _run(tmp_path_factory, world):
    d = tmp_path_factory.mktemp(f"shard{world}")
    x, g = _inputs()
    np.savez(d / "inputs.npz", x=x, g=g)
    return spawn_ranks(WORKER, ["shard", d], world, d, RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _run(tmp_path_factory, 4)


def _cases(world):
    for n, axes, shape, cases in SHARD_CASES:
        if n == world:
            mesh = JMesh(np.array(jax.devices()[:n]).reshape(shape), axes)
            return mesh, cases
    raise KeyError(world)


@pytest.mark.parametrize("world", [2, 4])
def test_shards_equal_the_reference_addressable_shards(world, request):
    got = request.getfixturevalue(f"world{world}")
    mesh, cases = _cases(world)
    x, g = _inputs()
    ids = [d.id for d in jax.devices()[:world]]
    for i, (src, dst) in enumerate(cases):
        want_src = _ref_shards(x, mesh, src)
        want_dst = _ref_shards(x, mesh, dst)
        want_grad = _ref_shards(g, mesh, src)
        for r in range(world):
            res = got[r]["cases"][i]
            dev = ids[r]  # rank r sits at the mesh coordinates of device r
            case = f"case {i} {src}->{dst} rank {r}"
            np.testing.assert_array_equal(res["src"].numpy(), want_src[dev],
                                          err_msg=case)
            np.testing.assert_array_equal(res["dst"].numpy(), want_dst[dev],
                                          err_msg=case)
            np.testing.assert_array_equal(res["back"].numpy(),
                                          want_src[dev], err_msg=case)
            np.testing.assert_array_equal(res["grad"].numpy(),
                                          want_grad[dev], err_msg=case)
            assert res["placement"] == tuple(dst)
            assert res["logical"] == SHARD_SHAPE


def test_reference_reshard_gives_the_same_shards():
    """The table's reference shards are those of the reference's own
    ``reshard`` (``auto_parallel.reshard``) of a placed tensor."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import auto_parallel as jap
    from paddle_tpu.distributed import sharding_api as jsh

    x, _ = _inputs()
    mesh, cases = _cases(4)
    for src, dst in cases:
        t = jsh.shard_tensor(paddle.to_tensor(x), mesh, list(src))
        out = jap.reshard(t, JP(*dst), mesh=mesh)
        got = {s.device.id: np.asarray(s.data)
               for s in out._data.addressable_shards}
        want = _ref_shards(x, mesh, dst)
        for dev, a in want.items():
            np.testing.assert_array_equal(got[dev], a)


def test_one_rank_is_the_identity_and_keeps_the_graph():
    x = torch.randn(4, 6, requires_grad=True)
    mesh = Mesh(np.arange(1), ("x",))
    s = tsh.shard_tensor(x, mesh, ["x", None])
    assert torch.equal(s, x) and s.placement == ("x", None)
    assert s.logical_shape == (4, 6)
    y = tsh.reshard(s, [None, "x"])
    (y * 2).sum().backward()
    assert torch.equal(x.grad, torch.full((4, 6), 2.0))


def test_parameter_takes_the_placement_as_its_annotation():
    p = torch.nn.Parameter(torch.ones(4, 4))
    mesh = Mesh(np.arange(1), ("mp",))
    out = tsh.shard_tensor(p, mesh, [None, "mp"])
    assert out is p and p.pspec == (None, "mp")
    assert torch.equal(p.data, torch.ones(4, 4))


def test_shard_op_places_inputs_and_outputs():
    mesh = Mesh(np.arange(1), ("x",))
    op = tsh.shard_op(lambda a, b: a @ b, mesh, in_specs=[["x", None], None],
                      out_specs=[None, "x"])
    a, b = torch.randn(2, 3), torch.randn(3, 4)
    out = op(a, b)
    assert torch.equal(out, a @ b)
    assert out.placement == (None, "x")


def test_named_sharding_cuts_and_tags():
    mesh = Mesh(np.arange(1), ("dp",))
    lay = tsh.NamedSharding(mesh, tsh.PartitionSpec("dp"))
    t = lay.shard(torch.arange(6).reshape(3, 2))
    assert t.placement == ("dp", None) and t.logical_shape == (3, 2)
    with pytest.raises(ValueError):
        tsh.local_shard(torch.ones(3, 2), ("dp",),
                        Mesh(np.arange(2), ("dp",)), rank=0)

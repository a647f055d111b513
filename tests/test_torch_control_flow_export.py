"""The traced path of ``ops/control_flow.py``: under ``torch.export``
``cond``, ``case``, ``switch_case`` and ``while_loop`` become
``torch.cond``/``torch.while_loop`` nodes (the reference lowers to
``lax.cond``/``lax.switch``/``lax.while_loop``), and the exported program
gives the eager results at inputs that take every branch, which equal the
reference's eager results (1e-6). The eager path is the one the op-surface
tests already hold (no node is traced there).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu_torch.ops import control_flow as cf
from torch_port_util import cpu_device

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _cond(m, x):
    return m.static.nn.cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0)


def _case(m, x):
    s = x.sum()
    return m.static.nn.case([(s > 4.0, lambda: x * 3.0),
                             (s > 0.0, lambda: x * 2.0)],
                            default=lambda: -x)


def _switch(m, x, i):
    return m.static.nn.switch_case(i, {1: lambda: x + 1.0,
                                       3: lambda: x * 3.0},
                                   default=lambda: x * 0.0)


def _while(m, x):
    i = x.sum() * 0.0
    _, s = m.static.nn.while_loop(lambda i, s: i < 4.0,
                                  lambda i, s: [i + 1.0, s * 1.5 + 1.0],
                                  [i, x])
    return s


FNS = {"cond": (_cond, "cond"), "case": (_case, "cond"),
       "switch_case": (_switch, "cond"), "while_loop": (_while, "while_loop")}
XS = ([1.0, 2.0, 3.0], [0.5, 0.25, 0.0], [-1.0, -2.0, 0.5])


class _M(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(tp, *args)


@pytest.mark.parametrize("name", list(FNS))
def test_export_matches_eager_and_reference(name):
    fn, node = FNS[name]
    x0 = torch.tensor(XS[0])
    args = (x0, torch.tensor(1)) if name == "switch_case" else (x0,)
    ep = torch.export.export(_M(fn), args)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert node in targets, targets
    run = ep.module()
    picks = (0, 1, 2, 3, 7, -1) if name == "switch_case" else (None,)
    for a in XS:
        for i in picks:
            x = torch.tensor(a)
            extra = () if i is None else (torch.tensor(i),)
            want = fn(tp, x, *extra)
            got = run(x, *extra)
            assert torch.equal(got, want), (a, i)
            jextra = () if i is None else (paddle.to_tensor(np.int64(i)),)
            ref = fn(paddle, paddle.to_tensor(np.asarray(a, np.float32)),
                     *jextra)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()),
                                       **TOL)


def test_eager_path_traces_nothing():
    x = torch.tensor(XS[0])
    assert not cf.is_traced(x) and not cf.is_traced(1.0)
    assert torch.equal(_cond(tp, x), x * 2.0)
    assert torch.equal(_switch(tp, x, torch.tensor(3)), x * 3.0)
    assert torch.equal(_switch(tp, x, 3), x * 3.0)
    assert torch.equal(_while(tp, x), ((((x * 1.5 + 1) * 1.5 + 1) * 1.5 + 1)
                                       * 1.5 + 1))

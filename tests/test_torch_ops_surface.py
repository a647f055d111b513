"""Port parity of the rest of the op surface against the JAX package, on
the same numpy inputs from a seed: control flow (``cond``, ``case``,
``switch_case``, ``while_loop``, run eagerly with the reference's output
structure), the in-place variants (``INPLACE_OPS``, their refusal while
grad is on, the random refills by moments), ``misc``, ``extra``
(``einsum``, the segment reductions, ``histogramdd``), the
``paddle.tensor`` namespace, the AMP casts by name, and the slice as a
whole: a tiny GPT's logits and hidden states, with the reference's weights
carried by ``load_reference_state_dict``, through the chain chip_smoke.py
phase 18e runs at full width.

float32 outputs rtol 1e-5, atol 1e-6 (the model's logits atol 1e-4, as the
GPT parity test holds them, and what is computed from them rtol 1e-4,
atol 1e-4); integer and bool outputs exactly; dtypes by name; random
refills and samples by range and moments.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.ops import control_flow as RC
from paddle_tpu.ops import extra as RE
from paddle_tpu.ops import inplace as RI
from paddle_tpu.ops import misc as RMISC
from paddle_tpu_torch.ops import control_flow as PC
from paddle_tpu_torch.ops import extra as PE
from paddle_tpu_torch.ops import inplace as PI
from paddle_tpu_torch.ops import misc as PMISC
from torch_port_util import (assert_same, cpu_device, flat_outputs,
                             port_of)


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
X = _R.randn(3, 4).astype(np.float32)
Y = _R.randn(3, 4).astype(np.float32)
P = (np.abs(_R.randn(3, 4)) + 0.5).astype(np.float32)
B3 = _R.randn(2, 3, 4).astype(np.float32)


# -- control flow -------------------------------------------------------------
def _flow(pkg, cf, which):
    t = pkg.to_tensor
    x, y = t(X), t(Y)
    if which == "cond_true":
        return cf.cond(t(np.array(True)), lambda: (x + y, x), lambda: (x, y))
    if which == "cond_false":
        return cf.cond(t(np.array([0])), lambda: x * 2, lambda: x - y)
    if which == "case_second":
        return cf.case([(t(np.array(False)), lambda: x),
                        (t(np.array(True)), lambda: y * 3)], lambda: x + 1)
    if which == "case_default":
        return cf.case([(t(np.array(False)), lambda: x)], lambda: y)
    if which == "case_no_default":
        return cf.case([(t(np.array(False)), lambda: x),
                        (t(np.array(False)), lambda: y)])
    if which == "switch_list":
        return cf.switch_case(t(np.array(1)), [lambda: x, lambda: y + 1])
    if which == "switch_out_of_range":
        return cf.switch_case(t(np.array(5)), [lambda: x, lambda: y],
                              default=lambda: x * y)
    if which == "switch_dict":
        return cf.switch_case(t(np.array(7)), {3: lambda: x, 7: lambda: y})
    if which == "switch_dict_default":
        return cf.switch_case(t(np.array(4)), {3: lambda: x, 7: lambda: y})
    if which == "while_loop":
        return cf.while_loop(lambda i, s: i < 5,
                             lambda i, s: [i + 1, s * 1.5 + i],
                             [t(np.array(0)), x])
    raise KeyError(which)


FLOWS = ["cond_true", "cond_false", "case_second", "case_default",
         "case_no_default", "switch_list", "switch_out_of_range",
         "switch_dict", "switch_dict_default", "while_loop"]


@pytest.mark.parametrize("which", FLOWS)
def test_control_flow_matches_reference(which):
    want, got = _flow(paddle, RC, which), _flow(tp, PC, which)
    seq = (list, tuple)
    assert isinstance(got, seq) == isinstance(want, seq)
    assert len(flat_outputs(got)) == len(flat_outputs(want))
    for g, w in zip(flat_outputs(got), flat_outputs(want)):
        assert_same(g, w, what=which)


# -- in-place ----------------------------------------------------------------
INPLACE = {
    "add_": [Y], "subtract_": [Y], "multiply_": [Y], "divide_": [P],
    "remainder_": [P], "pow_": [2.0], "clip_": [-0.5, 0.5], "scale_": [2.0],
    "exp_": [], "sqrt_": [], "rsqrt_": [], "reciprocal_": [], "round_": [],
    "floor_": [], "ceil_": [], "trunc_": [], "abs_": [], "tanh_": [],
    "sigmoid_": [], "erfinv_": [], "sin_": [], "cos_": [], "neg_": [],
    "sign_": [], "lerp_": [Y, 0.25], "cast_": ["float64"],
    "flatten_": [], "reshape_": [[4, 3]], "squeeze_": [],
    "unsqueeze_": [0], "clone_": [], "tril_": [], "triu_": [1],
    "digamma_": [], "lgamma_": [], "nan_to_num_": [], "logit_": [],
    "masked_fill_": [X > 0, 2.0], "index_add_": [np.array([0, 2]), 0,
                                                 Y[:2]],
    "put_along_axis_": [np.array([[0], [1], [2]]), 5.0, 1],
    "scatter_": [np.array([1]), Y[:1]], "renorm_": [],
    "fill_diagonal_": [],
}
UNIT = {"sqrt_", "rsqrt_", "reciprocal_", "lgamma_", "digamma_", "logit_",
        "erfinv_"}


def _arg(pkg, a):
    return pkg.to_tensor(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_inplace_variant_matches_reference(name):
    src = (P / 4 if name in UNIT else X).astype(np.float32)
    src = src[:3, :3].copy() if name == "fill_diagonal_" else src
    jx, tx = paddle.to_tensor(src), tp.to_tensor(src)
    jr = RI.INPLACE_OPS[name](jx, *[_arg(paddle, a) for a in INPLACE[name]])
    tr = PI.INPLACE_OPS[name](tx, *[_arg(tp, a) for a in INPLACE[name]])
    assert tr is tx and jr is jx
    assert_same(tx, jx, rtol=1e-5, atol=1e-5, what=name)


def test_inplace_table_and_tensor_methods():
    assert set(PI.INPLACE_OPS) == set(RI.INPLACE_OPS)
    for name, fn in PI.INPLACE_OPS.items():
        if name in ("scale_", "cast_", "flatten_", "clone_",
                    "put_along_axis_"):  # names torch's tensor lacks
            assert getattr(torch.Tensor, name) is fn
    assert torch.Tensor.reshape_ is tp.ops.manipulation.reshape_
    x = tp.to_tensor(X)
    assert x.scale_(2.0) is x and np.allclose(x.numpy(), 2 * X)
    assert tp.tanh_ is PI.INPLACE_OPS["tanh_"]
    assert tp.floor_mod is tp.remainder


def test_inplace_refuses_a_tensor_that_requires_grad():
    x = tp.to_tensor(X, stop_gradient=False)
    for name in ("exp_", "fill_", "uniform_", "reshape_"):
        args = {"fill_": [1.0], "reshape_": [[12]]}.get(name, [])
        with pytest.raises(RuntimeError, match="requires grad"):
            PI.INPLACE_OPS[name](x, *args)
    with tp.no_grad():
        PI.INPLACE_OPS["exp_"](x)
    np.testing.assert_allclose(x.detach().numpy(), np.exp(X), rtol=1e-6)


def test_random_refills_by_moments():
    tp.seed(2)
    x = tp.zeros([20000])
    PI.INPLACE_OPS["uniform_"](x, -2.0, 2.0)
    assert x.min() >= -2 and x.max() < 2 and abs(float(x.mean())) < 0.05
    a = PI.INPLACE_OPS["uniform_"](tp.zeros([50]), 0.0, 1.0, seed=9).clone()
    b = PI.INPLACE_OPS["uniform_"](tp.zeros([50]), 0.0, 1.0, seed=9)
    assert torch.equal(a, b)
    PI.INPLACE_OPS["normal_"](x, 1.0, 0.5)
    assert abs(float(x.mean()) - 1.0) < 0.02 and abs(float(x.std()) - 0.5) \
        < 0.02
    PI.INPLACE_OPS["exponential_"](x, 4.0)
    assert x.min() >= 0 and abs(float(x.mean()) - 0.25) < 0.01
    assert float(PI.INPLACE_OPS["fill_"](x, 3.0).max()) == 3.0
    assert float(PI.INPLACE_OPS["zero_"](x).abs().max()) == 0.0
    # torch's own uniform_(from, to) is untouched
    assert torch.Tensor.uniform_ is not PI.uniform_


def test_reshape_setitem_increment_in_place():
    for pkg in (paddle, tp):
        x = pkg.to_tensor(B3)
        assert pkg.reshape_(x, [6, 4]) is x and tuple(x.shape) == (6, 4)
    jx, tx = paddle.to_tensor(X), tp.to_tensor(X)
    for pkg, x in ((paddle, jx), (tp, tx)):
        assert pkg.ops.manipulation.setitem(x, (slice(0, 2), 1), 7.0) is x
        pkg.ops.manipulation.setitem(x, 2, pkg.to_tensor(Y[0]))
    assert_same(tx, jx)
    # the reference's increment rebinds a float64 buffer; the port keeps
    # the tensor's dtype (Paddle's) and the values
    for pkg, x in ((paddle, jx), (tp, tx)):
        assert pkg.increment(x, 0.5) is x
    assert tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), jx.numpy(), rtol=1e-6)


# -- misc, extra ---------------------------------------------------------------
MODE_X = np.array([[1, 2, 2, 3, 3, 0], [5, 5, 4, 4, 4, 1]], np.float32)
MISC = {
    "is_empty": ("is_empty", [X[:0]], {}),
    "rank": ("rank", [B3], {}),
    "shape": ("shape", [B3], {}),
    "reverse": ("reverse", [B3, [0, 2]], {}),
    "multiplex": ("multiplex", [[X, Y, P], np.array([[2], [0], [1]])], {}),
    "mode": ("mode", [MODE_X], {}),
    "mode_axis0_keep": ("mode", [MODE_X.T.copy()], {"axis": 0,
                                                    "keepdim": True}),
}


def _args(pkg, args):
    out = []
    for a in args:
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            out.append([pkg.to_tensor(v) for v in a])
        else:
            out.append(pkg.to_tensor(a) if isinstance(a, np.ndarray) else a)
    return out


@pytest.mark.parametrize("case", sorted(MISC))
def test_misc_matches_reference(case):
    name, args, kw = MISC[case]
    want = flat_outputs(getattr(RMISC, name)(*_args(paddle, args), **kw))
    got = flat_outputs(getattr(PMISC, name)(*_args(tp, args), **kw))
    for g, w in zip(got, want):
        assert_same(g, w, what=case)


def test_misc_queries_and_rng_state():
    x = tp.to_tensor(X)
    assert PMISC.is_tensor(x) and PMISC.is_floating_point(x)
    assert PMISC.is_integer(tp.to_tensor(np.arange(3)))
    assert PMISC.is_complex(tp.to_tensor(X + 1j * Y))
    assert PMISC.tolist(x) == X.tolist()
    p = PMISC.create_parameter([3, 2], "float32", is_bias=True)
    assert isinstance(p, tp.Parameter) and float(p.abs().sum()) == 0.0
    tp.seed(4)
    tp.rand([3])  # makes the CPU generator
    state = PMISC.get_cuda_rng_state()
    a = tp.rand([5])
    PMISC.set_cuda_rng_state(state)
    assert torch.equal(tp.rand([5]), a)
    lam = tp.to_tensor(np.full(20000, 3.0, np.float32))
    draws = PMISC.poisson(lam)
    assert draws.dtype == torch.float32 and draws.min() >= 0
    assert abs(float(draws.mean()) - 3.0) < 0.1
    assert abs(float(draws.var()) - 3.0) < 0.3


SEG = np.array([0, 0, 2, 2, 2, 4], np.int64)
DATA = _R.randn(6, 3).astype(np.float32)
HD = _R.randn(50, 2).astype(np.float32)
EXTRA = {
    "einsum": ("einsum", ["bij,bjk->bik", B3, np.swapaxes(B3, 1, 2)], {}),
    "einsum_list": ("einsum", ["ij,ij->i", [X, Y]], {}),
    "segment_sum": ("segment_sum", [DATA, SEG], {}),
    "segment_mean": ("segment_mean", [DATA, SEG], {}),
    "segment_max": ("segment_max", [DATA, SEG], {}),
    "segment_min": ("segment_min", [DATA, SEG], {}),
    "histogramdd": ("histogramdd", [HD], {"bins": [4, 3]}),
    "histogramdd_range_density": ("histogramdd", [HD], {
        "bins": 3, "ranges": [(-1.0, 1.0), (-2.0, 0.5)], "density": True}),
    "histogramdd_weights": ("histogramdd", [HD], {
        "bins": 2, "weights": np.abs(HD[:, 0])}),
}


@pytest.mark.parametrize("case", sorted(EXTRA))
def test_extra_matches_reference(case):
    name, args, kw = EXTRA[case]
    kw_r = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    kw_p = {k: tp.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    want = getattr(RE, name)(*_args(paddle, args), **kw_r)
    got = getattr(PE, name)(*_args(tp, args), **kw_p)
    want = flat_outputs(want[0]) + list(want[1]) if name == "histogramdd" \
        else flat_outputs(want)
    got = flat_outputs(got[0]) + list(got[1]) if name == "histogramdd" \
        else flat_outputs(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w, what=case)


def test_the_sweep_feeds_and_holds_every_op_it_can():
    """``ops.sweep.run``, which chip_smoke.py phase 18a runs on the card
    against the CPU, here on the CPU against itself: every fed op runs,
    none mismatches, and every op of the registry is fed or skipped with a
    reason."""
    from paddle_tpu_torch.ops import sweep
    from paddle_tpu_torch.ops.registry import all_ops

    ops = all_ops()
    rep = sweep.run(ops, "cpu", "cpu")
    assert rep["mismatches"] == {} and rep["bf16_nonfinite"] == []
    assert rep["ops"] + len(rep["skipped"]) == len(ops)
    assert rep["ops"] >= 530 and rep["grads"] >= 350
    assert set(rep["skipped"].values()) <= {
        "random: held by moments in the CPU tests",
        "host query or state, no tensor op", "CUDA kernel: held in phase 2"}
    assert sorted(rep["nonunique"]) == sorted(sweep.NONUNIQUE)


# -- namespaces and AMP ---------------------------------------------------------
def test_tensor_namespace_and_methods():
    x = tp.to_tensor(X)
    assert tp.tensor.math.add is tp.add and tp.tensor.random is \
        tp.ops.creation
    assert tp.tensor.search.argmax is tp.argmax
    assert x.astype("float64").dtype == torch.float64
    np.testing.assert_array_equal(x.gather_nd(tp.to_tensor(
        np.array([[1, 2]]))).numpy(), X[1:2, 2])


AMP_WHITE = {"mm": (X, X.T.copy()), "bmm": (B3, np.swapaxes(B3, 1, 2)),
             "addmm": (X[:, :3].copy(), X, X.T.copy()),
             "einsum": ("ij,jk->ik", X, X.T.copy())}
AMP_BLACK = {"logsumexp": (X,), "erf": (X,), "erfinv": (X / 4,),
             "norm": (X,)}


@pytest.mark.parametrize("name", sorted(AMP_WHITE) + sorted(AMP_BLACK))
def test_o1_bf16_casts_by_name_as_the_reference(name):
    args = {**AMP_WHITE, **AMP_BLACK}[name]
    outs = []
    for pkg in (paddle, tp):
        conv = [a if isinstance(a, str) else pkg.to_tensor(a).astype(
            "float32" if name in AMP_WHITE else "bfloat16") for a in args]
        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            outs.append(getattr(pkg, name)(*conv))
    want, got = outs
    assert_same(got, want, rtol=2e-2, atol=2e-2, what=name)
    assert got.dtype == (torch.bfloat16 if name in AMP_WHITE
                         else torch.float32)


# -- the slice as a whole ------------------------------------------------------
def _chain(pkg, mod, model, ids, lens, labels, steps):
    """Phase 18e's chain: the distribution, the ragged reductions, the
    metrics and a greedy while_loop, on one model's outputs."""
    t = pkg.to_tensor
    seq = mod("ops.sequence")
    met = mod("ops.metrics_ops")
    logits = model(t(ids))
    hidden = model.gpt(t(ids))
    cat = mod("distribution").Categorical(logits)
    pred = pkg.argmax(logits, axis=-1)
    out = {"logits": logits, "entropy": cat.entropy(),
           "log_prob": cat.log_prob(pred),
           "logsumexp": pkg.logsumexp(hidden, axis=-1),
           "softmax": seq.sequence_softmax(hidden[..., 0], t(lens)),
           "pool": seq.sequence_pool(hidden, t(lens), "AVERAGE"),
           "pool_max": seq.sequence_pool(hidden, t(lens), "MAX")}
    out["precision_recall"] = met.precision_recall(
        pred[:, :-1], t(labels[:, 1:]), logits.shape[-1])
    out["mean_iou"] = met.mean_iou(pred[:, :-1], t(labels[:, 1:]),
                                   logits.shape[-1])
    hit = (pred[:, :-1] == t(labels[:, 1:])).astype("float32")
    out["auc"] = met.auc(pkg.max(logits[:, :-1], axis=-1).reshape([-1]),
                         hit.reshape([-1]))
    cf = mod("ops.control_flow")

    def body(i, toks):
        nxt = pkg.argmax(model(toks)[:, -1], axis=-1).reshape([-1, 1])
        return [i + 1, pkg.concat([toks, nxt.astype(toks.dtype)], axis=1)]

    _, toks = cf.while_loop(lambda i, toks: i < steps, body,
                            [t(np.array(0)), t(ids)])
    cont = toks[:, ids.shape[1]:]
    out["tokens"] = cont
    n = t(np.full(cont.shape[0] // 2, steps, np.int64))
    out["edit_distance"] = met.edit_distance(
        cont[0::2], n, cont[1::2], n, normalized=False)
    return out


def test_the_slice_on_a_tiny_gpt_matches_reference():
    import importlib

    from paddle_tpu.models.gpt import GPTForPretraining as JGPT
    from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny

    paddle.seed(1)
    jm = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    tm = port_of(jm)
    V = jm.config.vocab_size
    rng = np.random.RandomState(4)
    ids = rng.randint(0, V, (4, 12)).astype(np.int64)
    labels = rng.randint(0, V, (4, 12)).astype(np.int64)
    lens = np.array([12, 5, 0, 9], np.int64)
    want = _chain(paddle, lambda m: importlib.import_module(
        f"paddle_tpu.{m}"), jm, ids, lens, labels, steps=6)
    with torch.no_grad():
        got = _chain(tp, lambda m: importlib.import_module(
            f"paddle_tpu_torch.{m}"), tm, ids, lens, labels, steps=6)
    assert got.keys() == want.keys()
    for k in got:
        for g, w in zip(flat_outputs(got[k]), flat_outputs(want[k])):
            assert_same(g, w, rtol=1e-4, atol=1e-4, what=k)
    # the samples, by their frequencies against softmax(logits)
    cat = tp.distribution.Categorical(got["logits"][0, :2])
    draws = cat.sample([4000], generator=torch.Generator().manual_seed(0))
    p = torch.softmax(got["logits"][0, :2].double(), -1)
    freq = torch.stack([torch.bincount(draws[:, r], minlength=V) / 4000.0
                        for r in range(2)])
    assert float((freq - p).abs().max()) < 5 * (0.25 / 4000) ** 0.5

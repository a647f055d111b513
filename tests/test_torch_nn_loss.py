"""``paddle_tpu_torch.nn``'s loss functions and loss layers against the JAX
package's, on the same numpy inputs from a seed: the losses and the
gradients of their weighted sum on the reference's tape.

Also: ``cross_entropy``'s reference signature (repaired: the port took
``(input, label, ignore_index, reduction)``, so ``F.cross_entropy(logits,
y, w)`` passed a tensor as ``ignore_index`` and a soft label could not be
written) with ``weight``, ``soft_label``, ``axis``, ``use_softmax`` and
``label_smoothing``; CTC's edge cases (repeated labels, a label length of
0, an input as long as its label, an infeasible alignment); ``hsigmoid``'s
custom tree refused; ``margin_cross_entropy`` at world 1 and at mp 2 over
two gloo ranks against the logical logits; ``class_center_sample`` lives
in ``test_torch_nn_common.py``.

Tolerances: f32 rtol 1e-5, atol 1e-6 (gradients atol 1e-5); CTC's
recursion over 12 steps rtol 1e-4.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from torch_nn_util import A, check, check_layer, function_of
from torch_port_util import cpu_device, spawn_ranks

WORKER = Path(__file__).resolve().parent / "torch_nn_worker.py"


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(4)
N, C = 8, 5
LOGITS = (_R.randn(N, C) * 2).astype(np.float32)
LAB = _R.randint(0, C, N).astype(np.int64)
LAB_IGN = LAB.copy()
LAB_IGN[[1, 5]] = -100
SOFT = _R.dirichlet(np.ones(C), N).astype(np.float32)
WCLS = (_R.rand(C) + 0.5).astype(np.float32)
SEG = _R.randn(2, C, 3, 4).astype(np.float32)
SEG_LAB = _R.randint(0, C, (2, 3, 4)).astype(np.int64)
P = _R.rand(N, 3).astype(np.float32) * 0.98 + 0.01
Y01 = (_R.rand(N, 3) > 0.5).astype(np.float32)
X = _R.randn(N, 3).astype(np.float32)
Y = _R.randn(N, 3).astype(np.float32)
PM1 = np.where(_R.rand(N) > 0.5, 1.0, -1.0).astype(np.float32)

FUNCTIONS = {
    "cross_entropy": ((A(LOGITS), A(LAB)), {}),
    "cross_entropy_ignore_sum": ((A(LOGITS), A(LAB_IGN)),
                                 {"reduction": "sum"}),
    "cross_entropy_none_col": ((A(LOGITS), A(LAB[:, None])),
                               {"reduction": "none"}),
    "cross_entropy_weight": ((A(LOGITS), A(LAB_IGN), A(WCLS)), {}),
    "cross_entropy_weight_sum": ((A(LOGITS), A(LAB), A(WCLS)),
                                 {"reduction": "sum"}),
    "cross_entropy_soft": ((A(LOGITS), A(SOFT)), {"soft_label": True}),
    "cross_entropy_soft_smooth": ((A(LOGITS), A(SOFT)),
                                  {"soft_label": True,
                                   "label_smoothing": 0.1}),
    "cross_entropy_smooth": ((A(LOGITS), A(LAB_IGN)),
                             {"label_smoothing": 0.2}),
    "cross_entropy_axis": ((A(SEG), A(SEG_LAB)), {"axis": 1}),
    "cross_entropy_probs": ((A(SOFT), A(LAB)), {"use_softmax": False}),
    "softmax_with_cross_entropy": ((A(LOGITS), A(LAB[:, None])),
                                   {"return_softmax": True}),
    "softmax_with_cross_entropy_soft": ((A(LOGITS), A(SOFT)),
                                        {"soft_label": True}),
    "nll_loss": ((A(np.log(SOFT)), A(LAB_IGN)), {}),
    "nll_loss_weight": ((A(np.log(SOFT)), A(LAB), A(WCLS)), {}),
    "nll_loss_4d": ((A(SEG), A(SEG_LAB)), {"reduction": "none"}),
    "mse_loss": ((A(X), A(Y)), {}),
    "l1_loss": ((A(X), A(Y)), {"reduction": "sum"}),
    "smooth_l1_loss": ((A(X), A(Y)), {"delta": 0.5}),
    "binary_cross_entropy": ((A(P), A(Y01)), {}),
    "binary_cross_entropy_weight": ((A(P), A(Y01), A(P[0])),
                                    {"reduction": "none"}),
    "binary_cross_entropy_with_logits": ((A(X), A(Y01)), {}),
    "binary_cross_entropy_with_logits_pos": (
        (A(X * 3), A(Y01), A(P[1])), {"pos_weight": A(P[2] * 3),
                                      "reduction": "sum"}),
    "kl_div": ((A(np.log(SOFT)), A(SOFT[::-1].copy())), {}),
    "kl_div_batchmean": ((A(np.log(SOFT)), A(SOFT[::-1].copy())),
                         {"reduction": "batchmean"}),
    "margin_ranking_loss": ((A(X[:, 0]), A(Y[:, 0]), A(PM1)),
                            {"margin": 0.3}),
    "hinge_embedding_loss": ((A(X), A(np.tile(PM1[:, None], (1, 3)))),
                             {"margin": 0.5}),
    "cosine_embedding_loss": ((A(X), A(Y), A(PM1)), {"margin": 0.2}),
    "triplet_margin_loss": ((A(X), A(Y), A(X[::-1].copy())), {}),
    "triplet_margin_loss_p1_swap": ((A(X), A(Y), A(X[::-1].copy())),
                                    {"p": 1.0, "swap": True,
                                     "reduction": "none"}),
    "log_loss": ((A(P), A(Y01)), {}),
    "square_error_cost": ((A(X), A(Y)), {}),
    "sigmoid_focal_loss": ((A(X), A(Y01)), {}),
    "sigmoid_focal_loss_norm": ((A(X), A(Y01)),
                                {"normalizer": A(np.array([3.0], np.float32)),
                                 "gamma": 1.5, "reduction": "mean"}),
    "hsigmoid_loss": ((A(_R.randn(N, 6).astype(np.float32)), A(LAB), 7,
                       A(_R.randn(6, 6).astype(np.float32))),
                      {"bias": A(_R.randn(6, 1).astype(np.float32))}),
    "margin_cross_entropy": ((A(np.tanh(LOGITS)), A(LAB)),
                             {"margin2": 0.3, "margin3": 0.1, "scale": 8.0,
                              "return_softmax": True}),
    "margin_cross_entropy_none": ((A(np.tanh(LOGITS)), A(LAB)),
                                  {"reduction": None, "scale": 4.0}),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_function(case):
    args, kw = FUNCTIONS[case]
    name = function_of(case, JF)
    check(getattr(JF, name), getattr(TF, name), args, kw, atol=1e-6,
          what=case)


def test_cross_entropy_takes_the_references_positional_order():
    """``cross_entropy(input, label, weight, ignore_index, reduction,
    soft_label, axis, use_softmax, label_smoothing)``."""
    args = (LOGITS, LAB_IGN, WCLS, -100, "sum", False, -1, True, 0.1)
    want = JF.cross_entropy(*[paddle.to_tensor(a) if isinstance(a, np.ndarray)
                              else a for a in args])
    got = TF.cross_entropy(*[torch.tensor(a) if isinstance(a, np.ndarray)
                             else a for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-5)
    got = TF.cross_entropy(torch.tensor(LOGITS), torch.tensor(LAB),
                           torch.tensor(WCLS))
    want = JF.cross_entropy(paddle.to_tensor(LOGITS), paddle.to_tensor(LAB),
                            paddle.to_tensor(WCLS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-5)


def _ctc_case(T=12, S=4, lens=(12, 9, 4, 12), lab_lens=(4, 3, 4, 0),
              repeat=True, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, len(lens), 6).astype(np.float32)
    labels = rng.randint(1, 6, (len(lens), S)).astype(np.int64)
    if repeat:
        labels[0, 1] = labels[0, 0]  # a repeated label needs a blank
    return (A(logits), A(labels), A(np.array(lens, np.int64)),
            A(np.array(lab_lens, np.int64)))


CTC = {
    "mean": (_ctc_case(), {}),
    "sum": (_ctc_case(seed=1), {"reduction": "sum"}),
    "none_blank": (_ctc_case(seed=2), {"reduction": "none", "blank": 5}),
    "input_equals_label": (_ctc_case(T=4, lens=(4, 4), lab_lens=(4, 3),
                                      repeat=False, seed=3), {
        "reduction": "none"}),
}


@pytest.mark.parametrize("case", sorted(CTC))
def test_ctc_loss(case):
    args, kw = CTC[case]
    check(JF.ctc_loss, TF.ctc_loss, args, kw, rtol=1e-4, atol=1e-5,
          what=case)


def test_ctc_infeasible_alignment_costs_about_1e30():
    """A repeated label in as many steps as labels cannot be aligned: the
    reference's -1e30 fill gives about 1e30, not inf."""
    args = _ctc_case(T=4, lens=(4,), lab_lens=(4,), seed=5)
    loss = check(JF.ctc_loss, TF.ctc_loss, args, {"reduction": "none"},
                 grad=False)
    assert 9e29 < float(loss[0].detach()) < 1.1e30


def test_hsigmoid_custom_tree_is_refused():
    x, w = torch.randn(2, 3), torch.randn(3, 3)
    with pytest.raises(NotImplementedError):
        TF.hsigmoid_loss(x, torch.tensor([0, 1]), 4, w,
                         path_table=torch.zeros(2, 2, dtype=torch.long))


@pytest.fixture(scope="module")
def margin_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("margin")
    rng = np.random.RandomState(9)
    inp = {"logits": np.tanh(rng.randn(6, 10)).astype(np.float32),
           "label": np.array([0, 9, 4, 5, 7, 2], np.int64)}
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["margin", d], 2, d, 240), inp


def test_margin_cross_entropy_mp2_equals_the_logical_logits(margin_ranks):
    ranks, inp = margin_ranks
    x = paddle.to_tensor(inp["logits"], stop_gradient=False)
    loss, soft = JF.margin_cross_entropy(
        x, paddle.to_tensor(inp["label"]), margin1=1.0, margin2=0.3,
        margin3=0.1, scale=8.0, return_softmax=True)
    loss.backward()
    for r in ranks:
        np.testing.assert_allclose(r["loss"].numpy(),
                                   np.asarray(loss.numpy()), rtol=1e-5)
    for key, want in (("softmax", soft), ("grad", x.grad)):
        got = torch.cat([r[key] for r in ranks], 1).numpy()
        np.testing.assert_allclose(got, np.asarray(want.numpy()), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


LAYERS = {
    "CrossEntropyLoss": (lambda m, t: m.CrossEntropyLoss(
        weight=t(WCLS), label_smoothing=0.1), (LOGITS, LAB_IGN)),
    "CrossEntropyLoss_soft": (lambda m, t: m.CrossEntropyLoss(
        soft_label=True), (LOGITS, SOFT)),
    "MSELoss": (lambda m, t: m.MSELoss("sum"), (X, Y)),
    "L1Loss": (lambda m, t: m.L1Loss(), (X, Y)),
    "NLLLoss": (lambda m, t: m.NLLLoss(weight=t(WCLS)), (np.log(SOFT), LAB)),
    "BCELoss": (lambda m, t: m.BCELoss(), (P, Y01)),
    "BCEWithLogitsLoss": (lambda m, t: m.BCEWithLogitsLoss(
        pos_weight=t(P[0] + 1)), (X, Y01)),
    "SmoothL1Loss": (lambda m, t: m.SmoothL1Loss(delta=2.0), (X * 3, Y)),
    "KLDivLoss": (lambda m, t: m.KLDivLoss("batchmean"),
                  (np.log(SOFT), SOFT[::-1].copy())),
    "MarginRankingLoss": (lambda m, t: m.MarginRankingLoss(0.1),
                          (X[:, 0], Y[:, 0], PM1)),
    "HingeEmbeddingLoss": (lambda m, t: m.HingeEmbeddingLoss(),
                           (X[:, 0], PM1)),
    "CosineEmbeddingLoss": (lambda m, t: m.CosineEmbeddingLoss(0.1),
                            (X, Y, PM1)),
    "TripletMarginLoss": (lambda m, t: m.TripletMarginLoss(swap=True),
                          (X, Y, X[::-1].copy())),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    build, args = LAYERS[name]
    jl = build(jnn, paddle.to_tensor)
    tl = build(tnn, torch.tensor)
    check_layer(jl, tl, tuple(A(a) for a in args), what=name)


def test_ctc_loss_layer():
    args = _ctc_case(seed=6)
    check_layer(jnn.CTCLoss(blank=0), tnn.CTCLoss(blank=0), args, rtol=1e-4,
                atol=1e-5)

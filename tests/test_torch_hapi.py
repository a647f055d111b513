"""``hapi`` (``Model``, the callbacks, ``summary``, ``flops``) against the
reference's (``paddle_tpu/hapi/``), on the CPU, float32:

- ``fit`` step by step on a small classifier with the reference's weights,
  ``shuffle=False``: each step's loss within rtol 1e-5 and its accuracy
  log exactly; then ``evaluate``'s logs (rtol 1e-5), ``predict``'s outputs
  (rtol 1e-5, atol 1e-6), ``summary``'s counts and ``save``/``load`` (the
  ``.pdparams``/``.pdopt`` pair either package reads) bit for bit.
- The callbacks as the reference's tests drive them
  (``tests/test_components.py`` ``TestCallbacks``,
  ``tests/test_amp_jit_io.py`` ``test_hapi_model_fit``), and the learning
  rate an ``LRScheduler`` callback gives each step, equal to the
  reference's.
- ``flops``: the port counts products only (``FlopCounterMode``), XLA's
  ``cost_analysis`` counts elementwise work too and leaves out the
  multiply-adds on a convolution's padding; the ratio port / reference is
  stated for LeNet and ResNet-18, within 0.5% of the measured one.
- The stability sentinel through ``fit`` (the reference's
  ``tests/test_stability_sentinel.py`` ``TestFitIntegration``): a spike
  skipped, and one rolled back with dropout on (the rollback restores the
  generators through ``core.random.program_rng``), give parameters
  bit-identical to a run that never saw the batch; the flags build and
  close the sentinel.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu_torch import profiler
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.distributed.checkpoint import AutoCheckpoint
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.fault.sentinel import StabilitySentinel
from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                             LRScheduler, ModelCheckpoint,
                                             ProgBarLogger, ReduceLROnPlateau,
                                             VisualDL, config_callbacks)
from torch_nn_util import carry
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _data(n=48, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64) + (x[:, 2] > 1)
    return x, y.astype(np.int64)


def _dataset(pkg, x, y=None):
    """Samples (x, y), or (x,) without labels (``predict``'s input)."""
    class DS(pkg.io.Dataset):
        def __getitem__(self, i):
            return (x[i],) if y is None else (x[i], y[i])

        def __len__(self):
            return len(x)

    return DS()


class _Record:
    """A callback of either package that keeps each train step's logs."""

    def __init__(self, base):
        self.cb = type("Rec", (base,), {
            "on_train_batch_end": lambda s, step, logs=None: self.logs.append(
                dict(logs))})()
        self.logs = []


def _pair(lr=0.05, metrics=True, sched=False):
    paddle.seed(0)
    jn = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.Tanh(),
                              paddle.nn.Linear(8, 3))
    tn = carry(jn, tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.Tanh(),
                                    tp.nn.Linear(8, 3)))
    out = []
    for pkg, net in ((paddle, jn), (tp, tn)):
        rate = pkg.optimizer.lr.StepDecay(lr, step_size=3, gamma=0.5) \
            if sched else lr
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.Adam(learning_rate=rate,
                                     parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss(),
                  pkg.metric.Accuracy(topk=(1, 2)) if metrics else None)
        out.append(m)
    return out


def test_fit_step_by_step_then_evaluate_predict_summary():
    jm, tm = _pair()
    x, y = _data()
    from paddle_tpu.hapi.callbacks import Callback as RCallback

    jr, tr = _Record(RCallback), _Record(Callback)
    jm.fit(_dataset(paddle, x, y), batch_size=8, epochs=2, shuffle=False,
           verbose=0, callbacks=[jr.cb])
    tm.fit(_dataset(tp, x, y), batch_size=8, epochs=2, shuffle=False,
           verbose=0, callbacks=[tr.cb])
    assert len(tr.logs) == len(jr.logs) == 12
    for j, t in zip(jr.logs, tr.logs):
        assert set(t) == set(j) == {"loss", "acc_top1", "acc_top2", "step",
                                    "batch_size"}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        assert (t["acc_top1"], t["acc_top2"], t["step"]) == \
            (j["acc_top1"], j["acc_top2"], j["step"])
    je = jm.evaluate(_dataset(paddle, x, y), batch_size=16)
    te = tm.evaluate(_dataset(tp, x, y), batch_size=16)
    assert set(te) == set(je)
    for k in je:
        np.testing.assert_allclose(te[k], je[k], rtol=1e-5)
    jp = jm.predict(_dataset(paddle, x), batch_size=16, stack_outputs=True)
    tpred = tm.predict(_dataset(tp, x), batch_size=16, stack_outputs=True)
    np.testing.assert_allclose(tpred[0], np.asarray(jp[0]), rtol=1e-5,
                               atol=1e-6)
    assert tm.summary() == jm.summary() == {"total_params": 67,
                                            "trainable_params": 67}


def test_train_eval_predict_batch_take_numpy():
    jm, tm = _pair(metrics=False)
    x, y = _data(8)
    j = jm.train_batch([x], [y])
    t = tm.train_batch([x], [y])
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    np.testing.assert_allclose(tm.eval_batch([x], [y])[0],
                               jm.eval_batch([x], [y])[0], rtol=1e-5)
    np.testing.assert_allclose(tm.predict_batch([x])[0],
                               np.asarray(jm.predict_batch([x])[0]),
                               rtol=1e-5, atol=1e-6)
    assert len(tm.parameters()) == 4


def test_save_and_load_round_trip_and_read_the_references(tmp_path):
    jm, tm = _pair()
    x, y = _data(16)
    for m, pkg in ((jm, paddle), (tm, tp)):
        m.fit(_dataset(pkg, x, y), batch_size=8, epochs=1, shuffle=False,
              verbose=0)
    tm.save(str(tmp_path / "port" / "ckpt"))
    jm.save(str(tmp_path / "ref" / "ckpt"))
    assert os.path.exists(tmp_path / "port" / "ckpt.pdopt")
    for src in ("port", "ref"):
        _, fresh = _pair()
        fresh.load(str(tmp_path / src / "ckpt"))
        want = tm if src == "port" else jm
        for (n, p), (_, q) in zip(fresh.network.state_dict().items(),
                                  want.network.state_dict().items()):
            q = q.numpy() if src == "port" else np.asarray(q.numpy())
            if src == "port":
                np.testing.assert_array_equal(p.numpy(), q, err_msg=n)
            else:
                np.testing.assert_allclose(p.numpy(), q, rtol=1e-5,
                                           atol=1e-6, err_msg=n)
        assert fresh._optimizer._step_count == 2
    # the reference reads the port's checkpoint
    jfresh, _ = _pair()
    jfresh.load(str(tmp_path / "port" / "ckpt"))
    for (n, p), q in zip(jfresh.network.state_dict().items(),
                         tm.network.state_dict().values()):
        np.testing.assert_array_equal(np.asarray(p.numpy()), q.numpy(), n)


def test_model_checkpoint_and_fit_save_dir(tmp_path):
    _, tm = _pair()
    x, y = _data(16)
    tm.fit(_dataset(tp, x, y), batch_size=8, epochs=2, shuffle=False,
           verbose=0, save_dir=str(tmp_path / "fit"),
           callbacks=[ModelCheckpoint(save_freq=1,
                                      save_dir=str(tmp_path / "cb"))])
    names = set(os.listdir(tmp_path / "fit"))
    assert {"0.pdparams", "1.pdparams", "final.pdparams",
            "final.pdopt"} <= names
    assert {"0.pdparams", "1.pdparams"} <= set(os.listdir(tmp_path / "cb"))


def test_reduce_lr_on_plateau_and_visualdl(tmp_path):
    """The reference's ``TestCallbacks`` on the port."""
    tp.seed(0)
    net = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.Tanh(),
                           tp.nn.Linear(8, 2))
    model = tp.Model(net)
    opt = tp.optimizer.Adam(learning_rate=0.05, parameters=net.parameters())
    model.prepare(opt, tp.nn.MSELoss())
    rng = np.random.RandomState(0)
    X, Y = rng.rand(32, 4).astype(np.float32), rng.rand(32, 2).astype(
        np.float32)
    rl = ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                           min_delta=10.0, verbose=0)  # a forced plateau
    model.fit(_dataset(tp, X, Y), epochs=3, batch_size=16, verbose=0,
              callbacks=[rl, VisualDL(str(tmp_path))])
    assert float(opt.get_lr()) == 0.05 * 0.5 ** 2
    recs = [json.loads(l) for l in open(tmp_path / "scalars.jsonl")]
    assert [r["tag"] for r in recs] == ["train_epoch"] * 3
    assert all(set(r) >= {"global_step", "ts", "loss"} for r in recs)
    sched = tp.optimizer.lr.StepDecay(0.05, step_size=2)
    model.prepare(tp.optimizer.Adam(sched, parameters=net.parameters()),
                  tp.nn.MSELoss())
    with pytest.raises(TypeError, match="ReduceOnPlateau"):
        model.fit(_dataset(tp, X, Y), epochs=3, batch_size=16, verbose=0,
                  callbacks=[rl])


def test_lr_scheduler_callback_steps_as_the_reference():
    jm, tm = _pair(sched=True, metrics=False)
    x, y = _data(48)
    lrs = {}
    from paddle_tpu.hapi.callbacks import Callback as RCallback

    for m, pkg, base in ((jm, paddle, RCallback), (tm, tp, Callback)):
        seen = []
        rec = type("R", (base,), {"on_train_batch_begin": (
            lambda s, step, logs=None, m=m, seen=seen: seen.append(
                float(m._optimizer.get_lr())))})()
        m.fit(_dataset(pkg, x, y), batch_size=8, epochs=2, shuffle=False,
              verbose=0, callbacks=[rec])
        lrs[pkg.__name__] = seen
    assert lrs["paddle_tpu_torch"] == lrs["paddle_tpu"]
    assert lrs["paddle_tpu_torch"][:7] == [0.05] * 3 + [0.025] * 3 + [0.0125]


def test_early_stopping_progbar_and_config_callbacks(capsys):
    _, tm = _pair(metrics=False)
    x, y = _data(16)
    es = EarlyStopping(monitor="loss", mode="max", patience=1)
    tm.fit(_dataset(tp, x, y), batch_size=8, epochs=10, shuffle=False,
           verbose=1, callbacks=[es], log_freq=1)
    out = capsys.readouterr().out
    # the loss falls, so "max" sees no improvement after epoch 0
    assert tm.stop_training and es.wait == 1
    assert out.count("done in") == 2 and "Epoch 0 step 1: loss:" in out
    cl = config_callbacks(None, model=tm, epochs=2, steps=3, verbose=2)
    kinds = [type(c) for c in cl]
    assert kinds == [ProgBarLogger, LRScheduler]
    assert all(c.model is tm and c.params["steps"] == 3 for c in cl)
    assert tp.callbacks.EarlyStopping is EarlyStopping
    assert set(tp.callbacks.__all__) == set(
        paddle.callbacks.__all__)


def test_hapi_model_fit_learns():
    """The reference's ``test_hapi_model_fit`` on the port."""
    tp.seed(0)
    rng = np.random.RandomState(0)
    x = rng.rand(32, 4).astype(np.float32)
    y = x @ rng.rand(4, 1).astype(np.float32)
    ds = tp.io.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    net = tp.nn.Linear(4, 1)
    model = tp.Model(net)
    initial = float(tp.nn.MSELoss()(net(torch.from_numpy(x)),
                                    torch.from_numpy(y)))
    sched = tp.optimizer.lr.StepDecay(0.05, step_size=60, gamma=0.2)
    model.prepare(optimizer=tp.optimizer.Adam(sched,
                                              parameters=net.parameters()),
                  loss=tp.nn.MSELoss())
    model.fit(ds, batch_size=8, epochs=30, verbose=0)
    final = model.evaluate(ds, batch_size=32)
    assert final["loss"] < initial / 10, (initial, final)


def test_fit_num_iters_and_device_prefetch():
    _, tm = _pair(metrics=False)
    x, y = _data(48)
    rec = _Record(Callback)
    tm.fit(_dataset(tp, x, y), batch_size=8, epochs=3, shuffle=False,
           verbose=0, num_iters=4, device_prefetch=2, callbacks=[rec.cb])
    assert [r["step"] for r in rec.logs] == [0, 1, 2, 3]
    loader = tp.io.DataLoader(_dataset(tp, x, y), batch_size=8,
                              places="cpu")
    rec2 = _Record(Callback)
    tm.fit(loader, epochs=1, verbose=0, device_prefetch=2,
           callbacks=[rec2.cb])
    assert len(rec2.logs) == 6


@pytest.mark.parametrize("case", [("LeNet", {}, [1, 1, 28, 28], 0.98051),
                                  ("resnet18", {"num_classes": 10},
                                   [1, 3, 64, 64], 1.29798)])
def test_flops_against_xla_cost_analysis(case):
    import paddle_tpu.vision.models as RM

    name, kw, shape, ratio = case
    want = paddle.flops(getattr(RM, name)(**kw), shape)
    net = getattr(tp.vision.models, name)(**kw)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    got = tp.flops(net, shape)
    assert abs(got / want - ratio) <= 0.005 * ratio, got / want
    # the counting forward leaves the BatchNorm statistics as they were
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    # products only: LeNet's two convolutions and three linears exactly
    if name == "LeNet":
        assert got == 2 * (6 * 28 * 28 * 9 + 16 * 10 * 10 * 6 * 25
                           + 400 * 120 + 120 * 84 + 84 * 10)


# -- the stability sentinel through fit ---------------------------------------
class _XY(tp.io.Dataset):
    def __init__(self, n=32):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 8).astype(np.float32)
        self.y = self.x.sum(axis=1, keepdims=True).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _sentinel_fit(tmp_path, tag, spike=None, pre_q=(), dropout=0.0,
                  max_skips=2):
    inject.disarm()
    if spike:
        inject.arm(spike)
    tp.seed(7)
    g = torch.Generator().manual_seed(7)
    net = tp.nn.Sequential(tp.nn.Linear(8, 16, generator=g),
                           tp.nn.Dropout(dropout),
                           tp.nn.Linear(16, 1, generator=g))
    model = tp.Model(net)
    model.prepare(optimizer=tp.optimizer.Adam(learning_rate=0.05,
                                              parameters=net.parameters()),
                  loss=lambda pred, y: tp.nn.functional.mse_loss(pred, y))
    loader = tp.io.DataLoader(_XY(), batch_size=4, shuffle=True, seed=99,
                              places="cpu")
    anchor = AutoCheckpoint(str(tmp_path / tag), interval_steps=1,
                            keep_last=2)
    sent = StabilitySentinel(anchor=anchor, window=32, warmup=3, zmax=60,
                             max_skips=max_skips, max_rollbacks=2,
                             cooldown=4)
    for pos in pre_q:
        sent.quarantine.add(-1, pos=pos, action="skip")
    try:
        model.fit(loader, epochs=2, verbose=0, stability=sent)
    finally:
        sent.close()
        inject.disarm()
    return sent, [p.detach().clone() for p in net.parameters()]


@pytest.mark.parametrize("spike,dropout,max_skips,action", [
    ("grad.spike:step=5,scale=1000000", 0.0, 2, "skip"),
    ("loss.spike:step=5,scale=1000000", 0.3, 0, "rollback")])
def test_sentinel_skip_and_rollback_are_bit_identical_to_the_clean_run(
        tmp_path, spike, dropout, max_skips, action):
    """The port judges a step before its update (no lazy engine), so the
    first rung is a skip; with no skips allowed it is a rollback, which
    also rewinds the generators (dropout draws the same masks again)."""
    skips0 = profiler.counters().get("io_quarantine_skips", 0)
    s1, p1 = _sentinel_fit(tmp_path, "a", spike=spike, dropout=dropout,
                           max_skips=max_skips)
    s2, p2 = _sentinel_fit(tmp_path, "b", pre_q=[(0, 5)], dropout=dropout,
                           max_skips=max_skips)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    (entry,) = s1.quarantine.entries()
    assert entry["pos"] == [0, 5] and entry["action"] == action
    assert len(entry["sample_indices"]) == 4
    assert profiler.counters()["io_quarantine_skips"] > skips0


def test_rollback_without_the_generators_is_not_the_clean_run(tmp_path,
                                                              monkeypatch):
    """With dropout on, the bit-identity above needs the generators in the
    anchor: a rollback that does not restore them replays other masks."""
    monkeypatch.setattr(prandom.ProgramRNG, "set_state_dict",
                        lambda self, sd: None)
    _, p1 = _sentinel_fit(tmp_path, "a", spike="loss.spike:step=5,"
                          "scale=1000000", dropout=0.3, max_skips=0)
    _, p2 = _sentinel_fit(tmp_path, "b", pre_q=[(0, 5)], dropout=0.3,
                          max_skips=0)
    assert not all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_program_rng_round_trips_the_generators():
    tp.seed(3)
    g = prandom.default_generator("cpu")
    sd = prandom.program_rng.state_dict()
    a = torch.rand(4, generator=g)
    prandom.program_rng.set_state_dict(sd)
    assert torch.equal(torch.rand(4, generator=g), a)
    assert int(sd["seed"]) == 3


def test_flags_build_and_close_the_sentinel(tmp_path):
    tp.set_flags({"FLAGS_stability_enable": True,
                  "FLAGS_stability_ckpt_dir": str(tmp_path / "fl"),
                  "FLAGS_stability_anchor_interval": 4})
    try:
        tp.seed(7)
        net = tp.nn.Linear(8, 1)
        model = tp.Model(net)
        model.prepare(optimizer=tp.optimizer.SGD(
            learning_rate=0.05, parameters=net.parameters()),
            loss=lambda pred, y: tp.nn.functional.mse_loss(pred, y))
        before = profiler.counters().get("stability_observed", 0)
        model.fit(_XY(), batch_size=4, epochs=1, shuffle=False, verbose=0)
        assert profiler.counters()["stability_observed"] - before == 8
        assert os.path.isdir(str(tmp_path / "fl"))
    finally:
        tp.set_flags({"FLAGS_stability_enable": False,
                      "FLAGS_stability_ckpt_dir": "",
                      "FLAGS_stability_anchor_interval": 25})
    before = profiler.counters().get("stability_observed", 0)
    model.fit(_XY(), batch_size=4, epochs=1, shuffle=False, verbose=0)
    assert profiler.counters().get("stability_observed", 0) == before


def test_model_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from paddle_tpu_torch.core import place

    place._state.__dict__.pop("place", None)
    with pytest.raises(RuntimeError):
        tp.Model(tp.nn.Linear(2, 2))
